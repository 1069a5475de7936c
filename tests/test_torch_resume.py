"""BLK5 resume in the port (`core/sweep.perform_mi_computation` with
`checkpoint_dir`, device="cpu"): a sweep that dies after its first
checkpoint resumes from the checkpoints and writes byte-identical TSVs,
on every backend: "spmd" in host and device SR mode (tile checkpoints
under spmd_tiles/; the cases of the JAX package's
tests/test_spmd_resume.py), "fast" (the same tile sweep) with tiles
queued ahead (the crash lands mid-queue;
tests/test_pipelined_sweep.py's resume case), and the
compat "jax" and "numpy" (block-pair checkpoints,
tests/test_fast_sweep.py's resume case).  A change of the data or of an
output-relevant knob invalidates the checkpoints.  The crash is injected
by making the checkpoint save raise after its first success."""

import os

import numpy as np
import pytest

import ldweaver_tpu_torch.core.sweep as tsweep
from tests.test_sr_reduce import _synth_case
from tests.test_torch_fast_sweep import one_torch_thread, port_cds, port_data, run_pmc  # noqa: F401


@pytest.fixture(scope="module")
def case():
    sd, w, cv = _synth_case(seed=41)
    return port_data(sd), w, port_cds(cv, sd)


def crash_after_first_save(monkeypatch):
    orig = tsweep._BlockCheckpoint.save
    saved = {"n": 0}

    def dying_save(self, key, payload):
        if saved["n"] >= 1:
            raise RuntimeError("simulated crash")
        orig(self, key, payload)
        saved["n"] += 1

    monkeypatch.setattr(tsweep._BlockCheckpoint, "save", dying_save)
    return orig


BACKENDS = [("spmd", dict(sr_reduce="host")), ("spmd", dict(sr_reduce="device")),
            ("fast", dict(pipeline_depth=5)), ("jax", {}), ("numpy", {})]


@pytest.mark.parametrize("backend,kw", BACKENDS,
                         ids=["spmd_host", "spmd_device", "fast", "jax", "numpy"])
def test_interrupt_then_resume_byte_identical(case, tmp_path, monkeypatch, backend, kw):
    sd, w, cv = case
    kw = dict(kw, max_blk_sz=1000 if backend in ("jax", "numpy") else 512)
    _, sr_ref, lr_ref, _ = run_pmc(tmp_path, "ref", sd, w, cv, backend, **kw)
    assert sr_ref and len(lr_ref) > 10_000
    ck = str(tmp_path / "ck")
    orig = crash_after_first_save(monkeypatch)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run_pmc(tmp_path, "die", sd, w, cv, backend, checkpoint_dir=ck, **kw)
    monkeypatch.setattr(tsweep._BlockCheckpoint, "save", orig)
    sub = os.path.join(ck, "spmd_tiles") if backend in ("spmd", "fast") else ck
    assert len([f for f in os.listdir(sub) if f.endswith(".npz")]) == 1

    _, sr_res, lr_res, pt = run_pmc(tmp_path, "res", sd, w, cv, backend,
                                    checkpoint_dir=ck, **kw)
    assert sr_res == sr_ref and lr_res == lr_ref
    n_ckpt = len([f for f in os.listdir(sub) if f.endswith(".npz")])
    if backend in ("spmd", "fast"):
        stats = pt[backend]
        assert stats["ckpt_hits"] == 1 and n_ckpt == stats["tiles"] == 15
    else:
        assert n_ckpt == 6  # 2,500 SNPs at 1,000: 3 blocks, 6 block pairs
    # a second resume replays every tile
    _, sr2, lr2, pt2 = run_pmc(tmp_path, "res2", sd, w, cv, backend,
                               checkpoint_dir=ck, **kw)
    assert sr2 == sr_ref and lr2 == lr_ref
    if backend in ("spmd", "fast"):
        assert pt2[backend]["ckpt_hits"] == 15


@pytest.mark.parametrize("backend", ["spmd", "fast", "jax"])
def test_data_and_knob_changes_invalidate(case, tmp_path, backend):
    sd, w, cv = case
    kw = dict(max_blk_sz=1000 if backend == "jax" else 512)
    ck = str(tmp_path / "ck")
    run_pmc(tmp_path, "a", sd, w, cv, backend, checkpoint_dir=ck, **kw)
    sub = os.path.join(ck, "spmd_tiles") if backend in ("spmd", "fast") else ck

    def mtimes():
        return {f: os.stat(os.path.join(sub, f)).st_mtime_ns
                for f in os.listdir(sub) if f.endswith(".npz")}

    # one corrected genotype call: same shapes, same knobs
    codes = sd.codes.copy()
    codes[0, 0] = (int(codes[0, 0]) + 1) % 2
    sd_b = port_data(sd)
    sd_b.codes = codes
    before = mtimes()
    _, sr_b, lr_b, pt = run_pmc(tmp_path, "b", sd_b, w, cv, backend,
                                checkpoint_dir=ck, **kw)
    _, sr_c, lr_c, _ = run_pmc(tmp_path, "c", sd_b, w, cv, backend, **kw)
    assert sr_b == sr_c and lr_b == lr_c
    # a different sr_dist changes the extraction
    _, sr_d, lr_d, pt_d = run_pmc(tmp_path, "d", sd_b, w, cv, backend,
                                  checkpoint_dir=ck, sr_dist=1500, **kw)
    _, sr_e, lr_e, _ = run_pmc(tmp_path, "e", sd_b, w, cv, backend, sr_dist=1500,
                               **kw)
    assert sr_d == sr_e and lr_d == lr_e
    if backend in ("spmd", "fast"):
        assert pt[backend]["ckpt_hits"] == 0 and pt_d[backend]["ckpt_hits"] == 0
    else:  # every block pair was written again
        after = mtimes()
        assert set(after) == set(before)
        assert all(after[f] != before[f] for f in before)


def test_run_block_survives_an_unreadable_checkpoint(case, tmp_path):
    """A truncated npz (a crash during the write cannot leave one: writes
    go to a temporary name first) is recomputed, not replayed."""
    sd, w, cv = case
    ck = tmp_path / "ck"
    _, sr_a, lr_a, _ = run_pmc(tmp_path, "a", sd, w, cv, "fast", checkpoint_dir=str(ck),
                               max_blk_sz=512)
    victim = sorted(ck.glob("spmd_tiles/blk_spmd_*.npz"))[3]
    victim.write_bytes(victim.read_bytes()[:100])
    _, sr_b, lr_b, pt = run_pmc(tmp_path, "b", sd, w, cv, "fast", checkpoint_dir=str(ck),
                                max_blk_sz=512)
    assert pt["fast"]["ckpt_hits"] == 14
    assert sr_b == sr_a and lr_b == lr_a
    assert np.load(victim)["n_lr"] >= 0  # rewritten whole


@pytest.mark.parametrize("backend", ["spmd", "jax"])
def test_checkpoints_key_on_the_device_type(case, tmp_path, backend):
    """Tiles checkpointed on one device type are not replayed on another
    (the card's kernels and the plain versions round differently): the
    manifest holds the device type, and a manifest written for "cuda"
    makes a CPU run recompute every tile."""
    import json

    sd, w, cv = case
    kw = dict(max_blk_sz=1000 if backend == "jax" else 512)
    ck = tmp_path / "ck"
    _, sr_a, lr_a, _ = run_pmc(tmp_path, "a", sd, w, cv, backend,
                               checkpoint_dir=str(ck), **kw)
    sub = ck / "spmd_tiles" if backend == "spmd" else ck
    manifest = sub / "manifest.json"
    key = json.loads(manifest.read_text())
    assert key.count("cpu") == 1
    key[key.index("cpu")] = "cuda"
    manifest.write_text(json.dumps(key))
    before = {f.name: f.stat().st_mtime_ns for f in sub.glob("*.npz")}
    _, sr_b, lr_b, pt = run_pmc(tmp_path, "b", sd, w, cv, backend,
                                checkpoint_dir=str(ck), **kw)
    assert sr_b == sr_a and lr_b == lr_a
    assert json.loads(manifest.read_text()).count("cpu") == 1
    after = {f.name: f.stat().st_mtime_ns for f in sub.glob("*.npz")}
    assert set(after) == set(before) and all(after[f] != before[f] for f in before)
    if backend == "spmd":
        assert pt["spmd"]["ckpt_hits"] == 0
