"""Signature parity: every parameter of the JAX package's host-facing
functions exists in the port's counterpart with the same default, and the
port's `LDWeaverConfig` has the JAX package's fields and defaults.

The port may add `device` everywhere.  Every other difference is in
EXCEPTIONS below, with its reason; nothing else is skipped."""

import dataclasses
import importlib
import inspect

import pytest

import ldweaver_tpu
import ldweaver_tpu_torch

# the JAX package's public names (ldweaver_tpu._API) and the sweep and
# tile entry points beside them: (JAX module, port module, function)
EXTRA = [
    ("ldweaver_tpu.parallel.fast_sweep", "ldweaver_tpu_torch.parallel.fast_sweep",
     "fast_lr_topk"),
    ("ldweaver_tpu.parallel.fast_sweep", "ldweaver_tpu_torch.parallel.fast_sweep",
     "mi_tile_rank"),
    ("ldweaver_tpu.ops.pallas_rank_mi", "ldweaver_tpu_torch.ops.rank_mi",
     "mi_tile_rank_pallas"),
    ("ldweaver_tpu.ops.pallas_mi", "ldweaver_tpu_torch.ops.compat_mi",
     "mi_tile_pallas"),
    ("ldweaver_tpu.core.mi", "ldweaver_tpu_torch.core.mi", "mi_tile_jax"),
    ("ldweaver_tpu.parallel.sweep", "ldweaver_tpu_torch.parallel.sweep",
     "sharded_lr_topk"),
    ("ldweaver_tpu.core.sweep", "ldweaver_tpu_torch.core.sweep",
     "perform_mi_computation"),
    ("ldweaver_tpu.core.sweep", "ldweaver_tpu_torch.core.sweep", "sweep_block_pair"),
    ("ldweaver_tpu.core.sweep", "ldweaver_tpu_torch.core.sweep",
     "sweep_block_pair_fast"),
    ("ldweaver_tpu.core.sweep", "ldweaver_tpu_torch.core.sweep",
     "FastTileRunner.__init__"),
    ("ldweaver_tpu.core.hamming", "ldweaver_tpu_torch.core.hamming",
     "estimate_hamming_distance_weights"),
    ("ldweaver_tpu.parallel.fast_sweep", "ldweaver_tpu_torch.parallel.fast_sweep",
     "prepare_fast_sweep"),
]
# Left out: `ops/fused_tile.fused_tile_stage1` takes the LR sweep's launch
# layout (codes, fs, ts, nf, nt) and reads the term count from `wparts`;
# it is the sweep's internal launch of K2, not a host-facing entry point.

# TPU tile shapes and Pallas's interpret switch: the port's kernels choose
# their own launch shapes (ROADMAP.md: "Tile sizes and launch shapes are
# the port's own choice"), so these JAX parameters have no counterpart
TPU_TILING = {"tile_f", "tile_t", "chunk_s", "chunk_c", "section", "interpret"}
# {function: {parameter: reason}} for parameters only the port has, besides
# `device`
PORT_ONLY = {
    "sharded_lr_topk": {
        # the JAX package fixes them in build_sharded_sweep's defaults
        # (parallel/sweep.py:167-176); the port's sweep takes them here
        "hist_bins": "the SR histogram's bins, build_sharded_sweep's default",
        "hist_max": "the SR histogram's range, build_sharded_sweep's default",
    },
    "FastTileRunner.__init__": {
        # the JAX package's spmd_blk5_sweep does these jobs outside the
        # runner (parallel/spmd_sweep.py:996-1042 there); the port's one
        # tile loop for "spmd" and "fast" hands them to the runner
        "keep_sr": "SR pairs kept on the device for the on-device reduction",
        "topk_cap": "spmd_blk5_sweep's topk_cap, the extraction's LR top-K cap",
        "sr_counts": "the host-known SR pair counts a tile, computed once",
    },
}


def pairs():
    out = [(name, *ldweaver_tpu._API[name], *ldweaver_tpu_torch._API[name])
           for name in sorted(ldweaver_tpu._API)]
    out += [(fn, jm, fn, tm, fn) for jm, tm, fn in EXTRA]
    return out


def test_the_port_exports_the_same_names():
    assert set(ldweaver_tpu_torch._API) == set(ldweaver_tpu._API)
    assert len(ldweaver_tpu._API) == 27


def resolve(module, attr):
    """`module`'s attribute `attr`, which may be dotted (a method)."""
    obj = importlib.import_module(module)
    for name in attr.split("."):
        obj = getattr(obj, name)
    return obj


@pytest.mark.parametrize("name,jmod,jattr,tmod,tattr", pairs(),
                         ids=[p[0] for p in pairs()])
def test_parameters_and_defaults_match(name, jmod, jattr, tmod, tattr):
    jax_fn = resolve(jmod, jattr)
    port_fn = resolve(tmod, tattr)
    jp = inspect.signature(jax_fn).parameters
    tp = inspect.signature(port_fn).parameters
    for p in jp.values():
        if p.name in TPU_TILING:
            continue
        assert p.name in tp, f"{name}: the port lacks {p.name!r}"
        q = tp[p.name]
        assert q.kind == p.kind, f"{name}({p.name}): {q.kind} != {p.kind}"
        assert q.default == p.default, (
            f"{name}({p.name}): default {q.default!r} != {p.default!r}")
    extra = set(tp) - set(jp) - {"device"}
    assert extra == set(PORT_ONLY.get(name, {})), f"{name}: port-only {extra}"


def test_config_fields_and_defaults_match():
    from ldweaver_tpu.config import LDWeaverConfig as JaxConfig
    from ldweaver_tpu_torch.config import LDWeaverConfig

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(LDWeaverConfig) == fields(JaxConfig)
    assert LDWeaverConfig() == LDWeaverConfig(**dataclasses.asdict(JaxConfig()))


def test_ldweaver_takes_the_jax_config_fields(monkeypatch, tmp_path):
    """`ldweaver(..., use_pallas=False, precision="f32")` builds its config
    (the call then stops, before any work)."""
    from ldweaver_tpu_torch import pipeline
    from ldweaver_tpu_torch.config import LDWeaverConfig

    built = []

    class Built(Exception):
        pass

    class Recorded(LDWeaverConfig):
        def __post_init__(self):
            super().__post_init__()
            built.append(self)
            raise Built

    monkeypatch.setattr(pipeline, "LDWeaverConfig", Recorded)
    with pytest.raises(Built):
        ldweaver_tpu_torch.ldweaver(str(tmp_path / "dset"), str(tmp_path / "a.fa"),
                                    use_pallas=False, precision="f32", device="cpu")
    assert built[0].use_pallas is False and built[0].precision == "f32"
