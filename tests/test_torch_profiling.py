"""The port's profiler hook (`utils/profiling.py`): with LDW_PROFILE set,
`maybe_trace` writes a torch.profiler Chrome trace of the region under
$LDW_PROFILE/<region>, in which the ranges of `annotate` appear; without
the variable nothing is written.  Driven through the fast backend's BLK5
sweep, which the pipeline wraps in maybe_trace("blk5_sweep")."""

import json
import os

from tests.test_sr_reduce import _synth_case
from tests.test_torch_fast_sweep import one_torch_thread, port_cds, port_data, run_pmc  # noqa: F401


def sweep(tmp_path, tag):
    sd, w, cv = _synth_case(nsnp=600, seed=5)
    return run_pmc(tmp_path, tag, port_data(sd), w, port_cds(cv, sd), "fast",
                   max_blk_sz=256)


def test_trace_written_with_ldw_profile(tmp_path, monkeypatch):
    base = tmp_path / "traces"
    monkeypatch.setenv("LDW_PROFILE", str(base))
    sweep(tmp_path, "run")
    trace = base / "blk5_sweep" / "trace.json"
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"fast_dispatch", "fast_finish"} <= names


def test_nothing_written_without_ldw_profile(tmp_path, monkeypatch):
    monkeypatch.delenv("LDW_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    sweep(tmp_path, "run")
    assert sorted(os.listdir(tmp_path)) == ["run"]
    assert sorted(os.listdir(tmp_path / "run")) == ["Temp"]
