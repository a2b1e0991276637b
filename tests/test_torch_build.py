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
    """K3 and K4 take Hopper's blocks (TMA, mbarriers, wgmma) from
    ``wgmma_bf16.cuh`` and no mma.sync; K1/K2 take their cp.async copies
    from ``mma_bf16.cuh``."""
    for name, header in (("flash_attention", "wgmma_bf16.cuh"), ("ssd_scan", "wgmma_bf16.cuh"),
                         ("dequant_normalize", "mma_bf16.cuh")):
        names = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
        assert names == [f"{name}.cu", header]


@pytest.mark.parametrize("mangled,name", [
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c8d923ad2wg13fa_wgmma_bf16ILi128ELi128ELb0EEEv14CUtensorMap_stS3_S3_S3_PKiS5_iiiifi",  # noqa: E501
     "fa_wgmma_bf16<128,128,false>"),
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c8d923ad3f3211fa_cuda_f32ILi8ELb1EEEvPKfS3_S3_PfPKiS6_iiiiiifi",
     "fa_cuda_f32<8,true>"),
    ("_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_7e9368b42wg14ssd_wgmma_bf16ILi2ELb1EEEv14CUtensorMap_stS2_S2_PKfS4_"
     "P13__nv_bfloat16PfS7_Pdiiiiiii", "ssd_wgmma_bf16<2,true>"),
    ("_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_7e9368b42wg14ssd_wgmma_bf16ILi1ELb0EEEv14CUtensorMap_stS2_S2_PKfS4_"
     "P13__nv_bfloat16PfS7_Pdiiiiiii", "ssd_wgmma_bf16<1,false>"),
    ("_ZN53_GLOBAL__N__e4682500_20_dequant_normalize_cu_3f0f19877dn_rowsIffEEvPKT_PKfS5_PKiPT0_iiiiiiiiilf", "dn_rows"),
])
def test_ptxas_names_each_instance_by_its_template_arguments(mangled, name):
    """Names as ``ptxas -v`` prints them for the kernels here: a bool
    argument (the position route's flag) is named, so no two instances
    share an entry of ``ptxas()``."""
    assert _build._kernel_name(mangled) == name
