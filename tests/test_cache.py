"""Persistent compile-cache helper: opt-out sentinels and idempotence."""

import os

import jax
import pytest

from ldpcdecoders_tpu import cache as cache_mod


@pytest.fixture
def fresh_cache_state(monkeypatch):
    """Reset the module's one-shot guard and jax's cache dir around a test."""
    old_dir = getattr(jax.config, "jax_compilation_cache_dir", None)
    monkeypatch.setattr(cache_mod, "_configured", False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)


@pytest.mark.parametrize("sentinel", ["off", "0", "none", "OFF"])
def test_optout_disables_both_entry_points(
    fresh_cache_state, monkeypatch, tmp_path, sentinel
):
    """LDPC_JAX_CACHE=off must disable caching in enable_compilation_cache
    too (the CLI/bench path), not create a directory named 'off'."""
    monkeypatch.setenv("LDPC_JAX_CACHE", sentinel)
    monkeypatch.chdir(tmp_path)
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache_mod.enable_compilation_cache() is None
    cache_mod.ensure_default_cache()
    assert not getattr(jax.config, "jax_compilation_cache_dir", None)
    assert not (tmp_path / sentinel).exists()


def test_env_var_sets_custom_directory(fresh_cache_state, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins over the default and over an
    explicit argument, and no other directory is created."""
    target = tmp_path / "xla_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache_mod.enable_compilation_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    other = tmp_path / "other"
    assert cache_mod.enable_compilation_cache(str(other)) == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert not other.exists()


def test_ensure_respects_application_config(fresh_cache_state, monkeypatch, tmp_path):
    """An application-level jax_compilation_cache_dir must win."""
    monkeypatch.delenv("LDPC_JAX_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    cache_mod.ensure_default_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_dir_is_machine_guarded(fresh_cache_state, monkeypatch, tmp_path):
    """Without JAX_COMPILATION_CACHE_DIR the default is the fixed
    ``<checkout>/.jax_cache`` (a path that does not move, so the cache
    key stays stable; .gitignore lists it), whatever HOME says."""
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(cache_mod.__file__)))
    assert os.path.isfile(os.path.join(checkout, "chip_smoke.py"))
    assert cache_mod.DEFAULT_DIR == os.path.join(checkout, ".jax_cache")
    # the default is used as-is (redirected here so the test writes
    # nothing into the checkout)
    monkeypatch.delenv("LDPC_JAX_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(cache_mod, "DEFAULT_DIR", str(tmp_path / ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache_mod.enable_compilation_cache() == str(tmp_path / ".jax_cache")


def test_explicit_dir_is_used_verbatim(fresh_cache_state, monkeypatch, tmp_path):
    """An explicit cache_dir argument is NOT re-keyed (caller's choice)."""
    jax.config.update("jax_compilation_cache_dir", None)
    target = tmp_path / "mine"
    assert cache_mod.enable_compilation_cache(str(target)) == str(target)
