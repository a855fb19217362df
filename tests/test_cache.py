"""Where the persistent compile cache goes (``utils/cache.py``)."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from mrs_optic_flow_tpu.utils import cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def config_updates(monkeypatch):
    """Record ``jax.config.update`` calls instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_set_leaves_the_directory_to_jax(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "deploy"))
    assert cache.enable_persistent_cache() == str(tmp_path / "deploy")
    assert "jax_compilation_cache_dir" not in config_updates
    assert not (tmp_path / "deploy").exists()  # nothing created in code


def test_env_var_unset_uses_the_in_checkout_directory(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_persistent_cache()
    assert path == cache.DEFAULT_CACHE_DIR == cache.cache_dir()
    assert config_updates["jax_compilation_cache_dir"] == path
    assert os.path.isdir(path)


def test_default_directory_is_fixed_and_ignored():
    """One path inside the checkout, the same in every process (never a
    temporary name, a pid or the time), and listed in .gitignore."""
    path = pathlib.Path(cache.DEFAULT_CACHE_DIR)
    assert path == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()
    code = "from mrs_optic_flow_tpu.utils import cache; print(cache.DEFAULT_CACHE_DIR)"
    other = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)), check=True,
    ).stdout.strip()
    assert other == str(path)
