"""Persistent XLA compilation cache plumbing (utils/xla_cache.py).

The cache must (a) default on at a fixed directory inside the checkout,
(b) leave the directory to JAX when JAX_COMPILATION_CACHE_DIR is set,
(c) honor the IPDE_XLA_CACHE =0 / <dir> contract, (d) refuse unsafe
directories.
"""

import os
import stat

import jax
import pytest

from ipde_tpu.utils import xla_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    before = xla_cache._DONE
    prev_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("IPDE_XLA_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    xla_cache._DONE = False
    yield
    xla_cache._DONE = before
    jax.config.update("jax_compilation_cache_dir", prev_dir)


def test_disabled_by_env(monkeypatch):
    monkeypatch.setenv("IPDE_XLA_CACHE", "0")
    assert xla_cache.enable_persistent_cache() is False
    assert xla_cache._DONE is False


def test_enabled_at_explicit_dir(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("IPDE_XLA_CACHE", str(d))
    assert xla_cache.enable_persistent_cache() is True
    assert jax.config.jax_compilation_cache_dir == str(d)
    mode = stat.S_IMODE(os.stat(d).st_mode)
    assert not (mode & (stat.S_IWGRP | stat.S_IWOTH))
    # idempotent (second call is a no-op returning True)
    assert xla_cache.enable_persistent_cache() is True


def test_default_dir_is_per_user():
    # the default is one fixed path inside the checkout, the same for every
    # process and user (the path is part of what a later run must find)
    d = xla_cache.default_dir()
    assert d == os.path.join(REPO, ".jax_cache")
    assert xla_cache.default_dir() == d
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_env_dir_is_left_to_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    monkeypatch.setenv("IPDE_XLA_CACHE", str(tmp_path / "other"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert xla_cache.enable_persistent_cache() is True
    # nothing set in code, nothing created
    assert jax.config.jax_compilation_cache_dir is None
    assert not (tmp_path / "other").exists()


def test_default_used_when_unset(monkeypatch, tmp_path):
    target = tmp_path / "repo_cache"
    monkeypatch.setattr(xla_cache, "default_dir", lambda: str(target))
    assert xla_cache.enable_persistent_cache() is True
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_unsafe_dir_refused(tmp_path, monkeypatch):
    d = tmp_path / "open"
    d.mkdir()
    os.chmod(d, 0o777)
    monkeypatch.setenv("IPDE_XLA_CACHE", str(d))
    assert xla_cache.enable_persistent_cache() is False
