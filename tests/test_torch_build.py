"""The kernel build's cache key: a library is named by a hash of its source
and of the ``csrc/`` headers it includes, so that an edited header rebuilds
every library that includes it.  Needs no ``nvcc``: only file names are
computed."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def _tree(tmp_path):
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "shared.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint s;\n')
    (tmp_path / "inner.cuh").write_text("int i;\n")
    (tmp_path / "unused.cuh").write_text("int u;\n")
    return tmp_path / "a.cu", tmp_path / "b.cu"


def test_a_source_lists_the_headers_it_includes_through_headers(tmp_path):
    a, b = _tree(tmp_path)
    assert [p.name for p in _build._sources(a)] == ["a.cu", "shared.cuh", "inner.cuh"]
    assert [p.name for p in _build._sources(b)] == ["b.cu"]


@pytest.mark.parametrize("edited,rebuilds_a", [("a.cu", True), ("shared.cuh", True), ("inner.cuh", True),
                                              ("unused.cuh", False), ("b.cu", False)])
def test_an_edited_source_or_included_header_changes_the_library_name(tmp_path, edited, rebuilds_a):
    a, b = _tree(tmp_path)
    before = _build._target(a), _build._target(b)
    with open(tmp_path / edited, "a") as f:
        f.write("// edited\n")
    after = _build._target(a), _build._target(b)
    assert (before[0] != after[0]) == rebuilds_a
    assert (before[1] != after[1]) == (edited == "b.cu")
    assert after[0].parent == _build.BUILD_DIR and after[0].name.startswith("a-")


def test_both_tensor_core_kernels_include_the_shared_header():
    for name in ("flash_attention", "ssd_scan"):
        names = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
        assert names == [f"{name}.cu", "mma_bf16.cuh"]
