"""What the entry points set up around the solver: the persistent compile
cache, the benchmark's peak table, and the native libraries built from the
committed sources."""

import importlib.util
import os
import shutil

import jax
import pytest

from eddy_currents_3d_tpu.utils import compile_cache, native_build

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(_ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compile_cache_honours_the_environment(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == compile_cache.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == got
        # the same path on every call, inside the checkout, ignored by git
        assert compile_cache.enable_compile_cache() == got
        assert os.path.dirname(got) == _ROOT
        with open(os.path.join(_ROOT, ".gitignore")) as f:
            assert os.path.basename(got) + "/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_resolves_the_h100():
    bench = _bench()
    p = bench.peak("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_refuses_an_unknown_device(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        _bench().peak(kind)


_SRC = 'extern "C" int answer() { return %d; }\n'


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_native_library_follows_its_source(tmp_path, monkeypatch):
    """An edited source gets a new library name and is rebuilt, so a
    library built from an older source is never loaded."""
    src_dir, out_dir = tmp_path / "native", tmp_path / "out"
    src_dir.mkdir()
    out_dir.mkdir()
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(src_dir))
    (src_dir / "t.cpp").write_text(_SRC % 41)
    lib = native_build.load("t.cpp", str(out_dir), "t")
    assert lib.answer() == 41
    first = native_build.lib_path(str(src_dir / "t.cpp"), str(out_dir), "t")
    (src_dir / "t.cpp").write_text(_SRC % 42)
    second = native_build.lib_path(str(src_dir / "t.cpp"), str(out_dir), "t")
    assert first != second and not os.path.exists(second)
    assert native_build.load("t.cpp", str(out_dir), "t").answer() == 42
    assert sorted(os.listdir(out_dir)) == sorted(
        os.path.basename(p) for p in (first, second))


def test_native_library_missing_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path))
    assert native_build.load("absent.cpp", str(tmp_path), "absent") is None
