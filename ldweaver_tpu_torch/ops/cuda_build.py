"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` compiles with nvcc for sm_90a into its own
shared library with a plain C interface, `_build/lib<name>.so` inside the
package (git ignores `_build/`), loaded with ctypes.  A library is rebuilt
when it is missing or older than its source or a header in `csrc/`.
`build` starts one nvcc per source, all at once, and waits for them;
`load` builds on first use; its spans "ldw.kernel.build" and
"ldw.kernel.load" count and time each library it builds and loads.
Nothing is compiled or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

from ldweaver_tpu_torch.utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# every kernel source of the package (one library each)
KERNELS = ("rank_mi", "fused_tile", "compat_mi")
# -split-compile=0: the optimizer's work on a source's kernel instances
# spread over every core (rank_mi's 82 instances take ~35 s, not ~94 s,
# on an H100 host; the same code)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or than
    any header in csrc/ (a source may include any of them)."""
    so = library_path(name)
    if not os.path.exists(so):
        return True
    inputs = [source_path(name), *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return os.path.getmtime(so) < max(os.path.getmtime(p) for p in inputs)


def build(names: Iterable[str] = KERNELS, force: bool = False) -> Dict[str, dict]:
    """Compile the named kernels in parallel (one nvcc process each).

    Returns {name: {"seconds": wall time of that nvcc, "log": its output
    (ptxas register / shared-memory report)}} for the ones compiled.
    Raises RuntimeError with the compiler output if any build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            time.time(),
        )
    report: Dict[str, dict] = {}
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.time() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first when needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                with span("ldw.kernel.build"):
                    build([name])
            with span("ldw.kernel.load"):
                lib = ctypes.CDLL(library_path(name))
            lib.ldw_cuda_error_string.restype = ctypes.c_char_p
            lib.ldw_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a nonzero CUDA error code."""
    if rc == -1:
        raise ValueError(f"{what}: unsupported arguments")
    if rc != 0:
        msg = lib.ldw_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
