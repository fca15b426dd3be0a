"""Full pipeline integration: prefilter -> odometry -> graph back end -> loop closure.

The synthetic trajectory closes a lap, so the reference's loop gates (accum-dist >= 100 m,
euclid < 15 m, fitness < 0.3) must fire and the optimized trajectory must beat raw odometry.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.xdist_group("course90")

from lidar_graph_slam_tpu.core.config import (
    CapacityConfig,
    GraphSlamConfig,
    PipelineConfig,
    PrefilterConfig,
    ScanMatcherConfig,
)
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline
from lidar_graph_slam_tpu.utils.evaluation import ate_rmse


def small_config():
    return PipelineConfig(
        prefilter=PrefilterConfig(leaf_size=0.3, mean_k=10),
        scan_matcher=ScanMatcherConfig(),
        graph_slam=GraphSlamConfig(loop_search_period_frames=5),
        capacity=CapacityConfig(
            raw_points=8192,
            filtered_points=4096,
            keyframe_points=4096,
            loop_submap_points=65536,
            max_keyframes=256,
            voxel_capacity=32768,
            max_loop_factors=16,
        ),
    )


@pytest.mark.slow
def test_full_slam_with_loop_closure(course90, course90_single_result):
    # The pipeline run is the shared session fixture (one 90-frame run serves this
    # test and the mesh-comparison test).
    n_frames = 90
    result = course90_single_result
    _, gt_all = course90
    T0_inv = np.linalg.inv(gt_all[0])
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in gt_all])

    assert result.odometry_poses.shape == (n_frames, 4, 4)
    assert result.keyframe_poses.shape[0] >= 5

    # The lap must close: the loop gates fire and at least one factor is accepted.
    assert result.num_loop_closures >= 1, f"loop log: {result.loop_log}"

    # Optimized keyframe trajectory must be at least as good as raw odometry at those frames.
    kf_gt = gt[result.keyframe_frame_indices]
    kf_odom = result.odometry_poses[result.keyframe_frame_indices]
    ate_opt = ate_rmse(result.keyframe_poses, kf_gt, align=False)
    ate_odom = ate_rmse(kf_odom, kf_gt, align=False)
    assert ate_opt <= ate_odom * 1.2 + 0.05
    assert ate_opt < 1.0, f"optimized ATE {ate_opt:.3f}"

    # Per-stage metrics exist (the observability layer).
    assert set(result.metrics) == {"prefilter", "register", "backend"}
    assert result.metrics["register"]["mean_ms"] > 0


@pytest.mark.slow
def test_map_save_and_load(tmp_path):
    seq = SyntheticSequence(n_frames=12, seed=4, max_points=4096, laps=0.15)
    pipe = SlamPipeline(small_config())
    pipe.run(seq)
    path = str(tmp_path / "map.pcd")
    assert pipe.save_map(path, resolution=0.5)

    from lidar_graph_slam_tpu.io.pcd import read_pcd

    pts = read_pcd(path)
    assert pts.shape[0] > 100
    assert np.isfinite(pts).all()
    # Map extent should be on the order of the world, not the padded sentinel.
    assert np.abs(pts).max() < 200.0


def test_raw_scan_truncation_surfaced():
    """Scans above capacity.raw_points are truncated WITH telemetry (no silent caps —
    counter increments and a metrics event fires."""
    cfg = small_config()
    pipe = SlamPipeline(cfg)
    big = np.random.default_rng(0).normal(scale=10.0, size=(cfg.capacity.raw_points + 500, 3)).astype(np.float32)
    padded = pipe._pad_bucket(big)
    assert padded.shape[0] == cfg.capacity.raw_points
    assert pipe.raw_truncation_count == 1
    small = big[:100]
    pipe._pad_bucket(small)
    assert pipe.raw_truncation_count == 1  # within capacity: no new event
