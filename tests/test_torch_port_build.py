"""The port's kernel builds: a library is named by the content of its
source and of the csrc headers the source includes, so an edit to either
is rebuilt and never loads a stale library.  Host code (`csrc/*.cpp`, the
JPEG decoder and PNG's row filters) takes the same route with g++, which
this host has, so its build runs here."""

import shutil
import subprocess

import pytest

from aqualora_torch.ops import _build

SOURCES = ("flash_fwd", "flash_bwd", "secret_inject", "int8_quant",
           "int8_conv", "jpeg_decode", "png_unfilter")


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
    for name in ("flash_fwd", "flash_bwd", "int8_conv"):
        assert [p.name for p in _build.source_files(name)] == [
            f"{name}.cu", "tensor_core.cuh"]
    for name in ("secret_inject", "int8_quant"):
        assert [p.name for p in _build.source_files(name)] == [f"{name}.cu"]


@pytest.mark.parametrize("edited,renamed", [
    ("tensor_core.cuh", {"flash_fwd", "flash_bwd", "int8_conv"}),
    ("flash_fwd.cu", {"flash_fwd"}),
    ("flash_bwd.cu", {"flash_bwd"}),
    ("secret_inject.cu", {"secret_inject"}),
    ("int8_quant.cu", {"int8_quant"}),
    ("int8_conv.cu", {"int8_conv"}),
    ("jpeg_decode.cpp", {"jpeg_decode"}),
    ("png_unfilter.cpp", {"png_unfilter"}),
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


def test_host_source_is_built_with_gpp_and_no_float_licence(csrc):
    """A .cpp source is built with g++, with FMA contraction off and no
    flag that lets the compiler change float results, so its resize gives
    the same bits on every host."""
    assert [p.name for p in _build.source_files("jpeg_decode")] == [
        "jpeg_decode.cpp"]
    cmd = _build.compile_command("jpeg_decode", "out.so")
    assert cmd[0] == "g++" and "-ffp-contract=off" in cmd
    assert not [f for f in cmd if "fast-math" in f or "march" in f
                or f in ("-Ofast", "-ljpeg", "-lpng", "-lz")]


@pytest.fixture
def host_build(tmp_path, monkeypatch):
    """The build module on a copy of jpeg_decode.cpp and an empty build
    directory, nothing loaded."""
    copy = tmp_path / "csrc"
    copy.mkdir()
    shutil.copy(_build.CSRC / "jpeg_decode.cpp", copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    return copy


def test_host_build_loads_unchanged_and_rebuilds_on_change(host_build,
                                                           monkeypatch):
    """The first use compiles into _build/; an unchanged source loads from
    there without a compiler; a changed one compiles a new library."""
    first = _build.library_path("jpeg_decode")
    assert _build.build_all(["jpeg_decode"])["jpeg_decode"] > 0
    assert first.exists() and _build._loaded["jpeg_decode"]
    monkeypatch.setattr(_build, "_loaded", {})

    def no_compiler(*a, **k):
        raise AssertionError("compiled an unchanged source")

    with monkeypatch.context() as m:
        m.setattr(subprocess, "Popen", no_compiler)
        assert _build.build_all(["jpeg_decode"]) == {"jpeg_decode": 0.0}
    assert _build._loaded["jpeg_decode"].decode_batch
    monkeypatch.setattr(_build, "_loaded", {})
    with open(host_build / "jpeg_decode.cpp", "a") as f:
        f.write("\n// edited\n")
    second = _build.library_path("jpeg_decode")
    assert second != first and not second.exists()
    _build.build("jpeg_decode")
    assert second.exists()


def test_a_failed_host_build_raises(host_build):
    """A source that does not compile raises with g++'s report; nothing
    is left in _build/ under its name."""
    (host_build / "broken.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        _build.build("broken")
    assert not _build.library_path("broken").exists()
