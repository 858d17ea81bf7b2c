"""The kernel builder's cache key (``ops/build.py``): a library's digest
covers its source and every local header the source includes, directly or
through another header, so an edited header rebuilds the kernels that use
it and only those. Needs no ``nvcc``."""
import pytest

from pytorch_distributed_template_tpu_torch.ops import build


@pytest.fixture()
def csrc(tmp_path):
    (tmp_path / "kern.cu").write_text(
        '#include <cuda_runtime.h>\n#include "hopper.cuh"\nint x;\n')
    (tmp_path / "hopper.cuh").write_text(
        '#pragma once\n  #  include "inner.cuh"\nint y;\n')
    (tmp_path / "inner.cuh").write_text("int z;\n")
    (tmp_path / "unused.cuh").write_text("int w;\n")
    (tmp_path / "plain.cu").write_text("int v;\n")
    return tmp_path


def test_local_includes_follow_nested_quoted_includes(csrc):
    assert [p.name for p in build.local_includes(csrc / "kern.cu")] == [
        "hopper.cuh", "inner.cuh"]
    assert build.local_includes(csrc / "plain.cu") == []


@pytest.mark.parametrize("header", ["hopper.cuh", "inner.cuh"])
def test_digest_changes_with_an_included_header(csrc, header):
    before = build.source_digest(csrc / "kern.cu")
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    assert build.source_digest(csrc / "kern.cu") != before


@pytest.mark.parametrize("source", ["kern.cu", "plain.cu"])
def test_digest_ignores_a_header_not_included(csrc, source):
    before = build.source_digest(csrc / source)
    (csrc / "unused.cuh").write_text("int w2;\n")
    assert build.source_digest(csrc / source) == before


def test_digest_changes_with_the_source(csrc):
    before = build.source_digest(csrc / "kern.cu")
    (csrc / "kern.cu").write_text('#include "hopper.cuh"\nint x2;\n')
    assert build.source_digest(csrc / "kern.cu") != before


def test_the_library_path_carries_the_digest_of_its_headers():
    """The port's Hopper kernels include csrc/hopper.cuh: their library
    names carry the digest of source and header together."""
    from pytorch_distributed_template_tpu_torch.ops import expert_ffn, flash

    for lib in (flash.FLASH_FWD, expert_ffn.EXPERT_FFN):
        assert [p.name for p in build.local_includes(lib.source)] == [
            "hopper.cuh"]
        assert lib.path.name == (
            f"lib{lib.name}-{build.source_digest(lib.source)}.so")
    assert build.LINK_FLAGS == ["-lcuda"]
