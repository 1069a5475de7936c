"""The port stands alone: `ldweaver_tpu_torch` and chip_smoke.py import
neither JAX nor anything of the JAX package `ldweaver_tpu`."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ldweaver_tpu_torch")


def test_import_every_submodule_with_jax_blocked():
    code = """
import importlib, importlib.util, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import ldweaver_tpu_torch as pkg
# Python modules only (the native helper's built .so sits in the tree too)
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if importlib.util.find_spec(m.name).origin.endswith(".py")]
for name in names:
    importlib.import_module(name)
loaded = sorted(k for k, v in sys.modules.items() if v is not None)
print(json.dumps({"names": names, "loaded": loaded}))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("ldweaver_tpu_torch.pipeline", "ldweaver_tpu_torch.ops.rank_mi",
                "ldweaver_tpu_torch.parallel.spmd_sweep"):
        assert mod in out["names"]
    leaked = [m for m in out["loaded"]
              if m == "ldweaver_tpu" or m.startswith("ldweaver_tpu.")
              or m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")]
    assert not leaked, leaked


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "ldweaver_tpu"):
                bad.append(n)
    assert not bad, bad
