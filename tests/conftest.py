"""Test harness: run everything on a virtual 8-device CPU mesh.

The reference has no tests at all (every package's BUILD_TESTING block is lint-only —
SURVEY.md §4); this suite is the framework's from scratch. Multi-chip collective paths are
exercised without a pod by forcing 8 virtual CPU devices, the "fake backend" strategy from
SURVEY.md §4.

The platform is pinned through jax.config (before any backend is initialized) rather than
only through JAX_PLATFORMS, so the suite runs on the CPU whatever the environment sets.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def course90():
    """The shared 90-frame loop course (seed 3, radius 30, 1.1 laps) used by the
    pipeline and mesh-pipeline integration tests."""
    from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=90, seed=3, max_points=8192, radius=30.0, laps=1.1)
    scans, gts = [], []
    for scan, gt in seq:
        scans.append(scan)
        gts.append(gt)
    return scans, np.stack(gts)


@pytest.fixture(scope="session")
def course90_single_result(course90):
    """ONE single-chip SlamPipeline run over the shared course, reused by
    test_pipeline AND test_pipeline_mesh (the duplicated
    90-frame runs were the suite's biggest cost)."""
    from lidar_graph_slam_tpu.core.config import (
        CapacityConfig, GraphSlamConfig, PipelineConfig, PrefilterConfig,
        ScanMatcherConfig,
    )
    from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline

    cfg = PipelineConfig(
        prefilter=PrefilterConfig(leaf_size=0.3, mean_k=10),
        scan_matcher=ScanMatcherConfig(),
        graph_slam=GraphSlamConfig(loop_search_period_frames=5),
        capacity=CapacityConfig(
            raw_points=8192, filtered_points=4096, keyframe_points=4096,
            loop_submap_points=65536, max_keyframes=256, voxel_capacity=32768,
            max_loop_factors=16,
        ),
    )
    scans, _ = course90
    pipe = SlamPipeline(cfg)
    for s in scans:
        pipe.process_scan(s)
    return pipe.run([])  # finalize via result() path
