"""The port's profiler hook (`utils/profiling.py`): with LDW_PROFILE set,
`maybe_trace` writes a torch.profiler Chrome trace of the region under
$LDW_PROFILE/<region>, in which the program's `span` ranges appear; without
the variable nothing is written.  Driven through the fast backend's BLK5
sweep, which the pipeline wraps in maybe_trace("blk5_sweep")."""

import json
import os

import pytest

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
    assert {"ldw.blk5.dispatch", "ldw.blk5.finish"} <= names


def test_nothing_written_without_ldw_profile(tmp_path, monkeypatch):
    monkeypatch.delenv("LDW_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    sweep(tmp_path, "run")
    assert sorted(os.listdir(tmp_path)) == ["run"]
    assert sorted(os.listdir(tmp_path / "run")) == ["Temp"]


def test_kernel_split_counts_busy_as_the_union():
    """chip_smoke's device-time split: busy is the union of the card's
    event intervals (overlaps on two streams count once, gaps not at
    all), summed adds their lengths, and the groups take the port's three
    kernels by name, copies and fills, and every other kernel."""
    import chip_smoke

    events = [
        ("void (anonymous namespace)::rank_mi_kernel<2, 3, true>(...)", 0.0, 100.0),
        ("Memcpy DtoH (Device -> Pinned)", 50.0, 150.0),
        ("void at::native::vectorized_elementwise_kernel<4>(...)", 200.0, 300.0),
        ("(anonymous namespace)::fused_tile_kernel(...)", 250.0, 260.0),
        ("Memset (Device)", 400.0, 401.0),
        ("void (anonymous namespace)::compat_mi_kernel<4, 4>(...)", 500.0, 502.0),
    ]
    busy, summed, groups = chip_smoke.kernel_split(events[::-1])
    assert busy == pytest.approx((150 + 100 + 1 + 2) / 1e6, rel=1e-12)
    assert summed == pytest.approx((100 + 100 + 100 + 10 + 1 + 2) / 1e6, rel=1e-12)
    assert groups == {"rank_mi": (0.1, 1), "copies": (pytest.approx(0.101), 2),
                      "torch ops": (0.1, 1), "fused_tile": (0.01, 1),
                      "compat_mi": (0.002, 1)}
