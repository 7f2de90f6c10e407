"""The compile-cache helper, and chip_smoke.py's refusal to run without a
GPU (the driver runs it on a machine without one, where it must fail)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from flashattn_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, "/somewhere/else")
    assert compile_cache.enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: no temp name, pid or time in it
    assert compile_cache.enable_compile_cache() == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(r):
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith('{"ok"'), r.stdout


def test_chip_smoke_fails_without_a_gpu():
    r = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    _assert_refused(r)
    assert "GPU" in r.stdout + r.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_refused(_smoke(tmp_path, str(tmp_path / "chip_smoke.py")))
