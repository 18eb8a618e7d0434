"""The kernel build's cache key: ``library._library_path`` hashes a source
together with every header it includes, so an edit of ``csrc/hopper.cuh``
rebuilds each source that includes it. Runs on the CPU: nothing is
compiled."""

import pytest

from orion_tpu_torch.ops.kernels import library


def _sources(tmp_path, header_text):
    (tmp_path / "hopper.cuh").write_text(header_text)
    (tmp_path / "inner.cuh").write_text("// no includes\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "hopper.cuh"\nint f() { return 1; }\n')
    return src


def test_a_header_edit_changes_the_library_path(tmp_path):
    src = _sources(tmp_path, "// v1\n")
    first = library._library_path(src)
    assert library._library_path(src) == first  # stable
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = library._library_path(src)
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    assert library._library_path(src) == first


def test_nested_headers_are_hashed_and_found_beside_the_includer(tmp_path):
    src = _sources(tmp_path, '#include "inner.cuh"\n')
    assert library._headers(src) == [tmp_path / "hopper.cuh", tmp_path / "inner.cuh"]
    first = library._library_path(src)
    (tmp_path / "inner.cuh").write_text("// edited\n")
    assert library._library_path(src) != first


def test_the_package_sources_hash_the_shared_header():
    """The five wgmma sources and q4_matmul.cu (its mma variant's TMA ring)
    include csrc/hopper.cuh; angle-bracket includes (the toolkit's) are not
    followed, and adafactor.cu includes none."""
    for name in ("gmm.cu", "flash_attention.cu", "flash_attention_bwd.cu", "causal_dot_norm.cu",
                 "causal_dot_bwd.cu", "q4_matmul.cu"):
        assert library._headers(library.CSRC / name) == [library.CSRC / "hopper.cuh"], name
    assert library._headers(library.CSRC / "adafactor.cu") == []


def test_a_missing_header_raises(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "nowhere.cuh"\n')
    with pytest.raises(FileNotFoundError, match="nowhere.cuh"):
        library._library_path(src)


def test_the_build_passes_the_header_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(library, "_nvcc", lambda: "nvcc")
    cmd = library._build_command(tmp_path / "k.cu", tmp_path / "k.so")
    assert cmd[cmd.index("-I") + 1] == str(library.CSRC)
