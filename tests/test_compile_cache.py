"""The entry points' persistent compile cache: a fixed directory inside
the checkout, or whatever JAX_COMPILATION_CACHE_DIR already names."""

import os

import jax
import pytest

from cubicsdr.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_unset_env_uses_fixed_dir_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    # Fixed: the same path on every call (the path is part of the key).
    assert compile_cache.enable_compile_cache() == d


def test_env_dir_is_left_to_jax(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".jax_cache/" in ignored


def test_cli_main_enables_cache(monkeypatch, cache_config):
    from cubicsdr.app import cli
    seen = []
    monkeypatch.setattr(cli, "enable_compile_cache",
                        lambda: seen.append(True))
    assert cli.main(["modems"]) == 0
    assert seen == [True]
