"""Offline visualization + compile-cache helpers — coverage for the two utility
modules nothing else exercises (`utils/viz.py` is the rviz stand-in,
`rviz/rviz.config:80-281` in the reference; `utils/jit_cache.py` configures the
persistent cache of the accelerator entry points)."""

import os

import jax
import numpy as np
import pytest

from lidar_graph_slam_tpu.utils import jit_cache, viz
from lidar_graph_slam_tpu.utils.jit_cache import enable_compilation_cache


def _poses_on_line(n):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = np.arange(n, dtype=np.float32)
    return poses


def test_render_run_writes_png(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "run.png")
    viz.render_run(
        path,
        map_points=rng.normal(size=(500, 3)).astype(np.float32),
        odometry_poses=_poses_on_line(20),
        keyframe_poses=_poses_on_line(5),
        loop_pairs=[(0, 4)],
        rejected_pairs=[(1, 3)],
        gt_poses=_poses_on_line(20),
    )
    assert os.path.getsize(path) > 1000  # a real PNG, not an empty file


def test_render_run_handles_empty_inputs(tmp_path):
    path = str(tmp_path / "empty.png")
    viz.render_run(path, map_points=np.zeros((0, 3), np.float32),
                   odometry_poses=np.zeros((0, 4, 4), np.float32))
    assert os.path.exists(path)


def test_compilation_cache_refuses_cpu():
    # Tests always run on the CPU backend (conftest); the cache stays off there — CPU
    # executables are specific to the compiling host's instruction set, and the
    # in-checkout cache directory travels with copies of the checkout
    # (jit_cache.py module docstring).
    assert enable_compilation_cache() is False


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda name, value: calls.append((name, value)))
    return calls


def test_compilation_cache_defers_to_env_dir(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache(platform="gpu") is True
    assert not [c for c in config_updates if c[0] == "jax_compilation_cache_dir"]


def test_compilation_cache_uses_one_fixed_in_checkout_dir(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compilation_cache(platform="gpu") is True
    assert enable_compilation_cache(platform="gpu") is True
    dirs = [v for n, v in config_updates if n == "jax_compilation_cache_dir"]
    assert dirs == [jit_cache.CACHE_DIR, jit_cache.CACHE_DIR]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(jit_cache.CACHE_DIR) == repo
    # .gitignore lists it: the cache never ends up in a commit.
    rel = os.path.relpath(jit_cache.CACHE_DIR, repo)
    with open(os.path.join(repo, ".gitignore")) as f:
        patterns = {line.strip().strip("/") for line in f}
    assert rel in patterns, f"{rel} is not in .gitignore"
