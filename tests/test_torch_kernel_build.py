"""The port's kernel build (``repro_torch.kernels.build``) on the CPU: the
library path names the bytes it was built from, so that an edited source or
a header it includes is rebuilt at first use. Nothing is compiled here."""

import re

from repro_torch.kernels import build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nextern "C" int f() { return 0; }\n')
    (csrc / "h.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return csrc


def test_lib_path_follows_the_source_and_its_headers(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    first = build.lib_path("k")
    assert first == build.lib_path("k") and first.parent == tmp_path / "out"
    assert first.name.startswith("k-") and first.suffix == ".so"
    (csrc / "h.cuh").write_text("#pragma once\n// edited\n")
    after_header = build.lib_path("k")
    assert after_header != first
    (csrc / "k.cu").write_text('#include "h.cuh"\nextern "C" int f() { return 1; }\n')
    assert build.lib_path("k") not in (first, after_header)


def test_lib_path_counts_a_new_header(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    first = build.lib_path("k")
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert build.lib_path("k") != first


# a definition (not a call) of the 3xTF32 helpers: the split, the tf32
# wgmma wrappers and the bulk copy
_TF32_DEFS = re.compile(r"__device__ __forceinline__ (?:uint32_t|void)\s+"
                        r"(tf32|split|wgmma_tf32(?:_ss)?|bulk_copy)\b")


def test_the_port_sources_share_one_hopper_header():
    """Both flash sources include csrc/hopper.cuh, which the hash covers;
    the 3xTF32 helpers that both routes use (tf32, split, the wgmma tf32
    wrappers, bulk_copy) are defined there, and in neither source."""
    header = (build.CSRC / "hopper.cuh").read_text()
    assert set(_TF32_DEFS.findall(header)) == {"tf32", "split", "wgmma_tf32", "wgmma_tf32_ss",
                                               "bulk_copy"}
    for name in ("flash_attention", "flash_attention_bwd"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text
        assert _TF32_DEFS.findall(text) == [], name
        assert "wgmma_tf32" in text and "split(" in text, name
