"""When the port's kernel libraries count as stale (`cuda_build._stale`):
on temporary source and build directories, without nvcc."""

import os

import pytest

from ldweaver_tpu_torch.ops import cuda_build

NAMES = ("one", "two")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """csrc/{one,two}.cu and a header, _build/lib{one,two}.so, every
    library newer than every source."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    for name in NAMES:
        (csrc / f"{name}.cu").write_text('#include "planes.cuh"\n')
    (csrc / "planes.cuh").write_text("#pragma once\n")
    for name in NAMES:
        (build / f"lib{name}.so").write_bytes(b"")
    t = 1_700_000_000
    for path in csrc.iterdir():
        os.utime(path, (t, t))
    for path in build.iterdir():
        os.utime(path, (t + 10, t + 10))
    return csrc, build, t


def touch(path, t):
    os.utime(path, (t, t))


def test_fresh_libraries_are_not_stale(tree):
    assert [cuda_build._stale(n) for n in NAMES] == [False, False]


def test_touching_a_header_marks_every_library_stale(tree):
    csrc, _, t = tree
    touch(csrc / "planes.cuh", t + 20)
    assert [cuda_build._stale(n) for n in NAMES] == [True, True]


def test_touching_a_source_marks_its_library_stale(tree):
    csrc, _, t = tree
    touch(csrc / "two.cu", t + 20)
    assert [cuda_build._stale(n) for n in NAMES] == [False, True]


def test_a_missing_library_is_stale(tree):
    _, build, _ = tree
    os.remove(build / "libone.so")
    assert [cuda_build._stale(n) for n in NAMES] == [True, False]
