"""The port's kernel builds: a library is named by the content of its
source and of the csrc headers the source includes, so an edit to either
is rebuilt and never loads a stale library."""

import shutil

import pytest

from aqualora_torch.ops import _build

SOURCES = ("flash_fwd", "flash_bwd", "secret_inject")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc that the build module reads instead of the repo's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _names():
    return {n: _build.library_path(n).name for n in SOURCES}


def test_attention_sources_include_the_shared_header(csrc):
    for name in ("flash_fwd", "flash_bwd"):
        assert [p.name for p in _build.source_files(name)] == [
            f"{name}.cu", "tensor_core.cuh"]
    assert [p.name for p in _build.source_files("secret_inject")] == [
        "secret_inject.cu"]


@pytest.mark.parametrize("edited,renamed", [
    ("tensor_core.cuh", {"flash_fwd", "flash_bwd"}),
    ("flash_fwd.cu", {"flash_fwd"}),
    ("flash_bwd.cu", {"flash_bwd"}),
    ("secret_inject.cu", {"secret_inject"}),
])
def test_edit_renames_exactly_the_libraries_built_from_it(csrc, edited,
                                                          renamed):
    before = _names()
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = _names()
    assert {n for n in SOURCES if after[n] != before[n]} == renamed
    for name in SOURCES:
        assert after[name].startswith(f"lib{name}_")


def test_header_included_through_another_header_is_hashed(csrc):
    (csrc / "inner.cuh").write_text("// inner\n")
    with open(csrc / "tensor_core.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    assert [p.name for p in _build.source_files("flash_fwd")] == [
        "flash_fwd.cu", "tensor_core.cuh", "inner.cuh"]
    before = _names()
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    after = _names()
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["secret_inject"] == before["secret_inject"]
