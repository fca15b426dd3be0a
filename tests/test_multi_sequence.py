"""Batched multi-sequence odometry on the CPU mesh (BASELINE configs[3] shrunk to CI)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_graph_slam_tpu.core.config import NdtConfig, ScanMatcherConfig
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.parallel import distributed, multi_sequence
from lidar_graph_slam_tpu.utils.evaluation import ate_rmse


@pytest.mark.slow
def test_batch_odometry_tracks_all_sequences():
    B, F, N = 4, 12, 2048
    cfg = ScanMatcherConfig(
        max_scan_accumulate_num=10,
        ndt=NdtConfig(resolution=2.0, max_iterations=32),
    )
    scans = np.full((B, F, N, 3), 1.0e6, dtype=np.float32)
    masks = np.zeros((B, F, N), dtype=bool)
    gts = []
    for b in range(B):
        seq = SyntheticSequence(n_frames=F, seed=10 + b, max_points=N, laps=0.1,
                                radius=30.0 + 2 * b)
        gt_b = []
        for f, (scan, gt_pose) in enumerate(seq):
            k = scan.shape[0]
            scans[b, f, :k] = scan
            masks[b, f, :k] = True
            gt_b.append(gt_pose)
        T0_inv = np.linalg.inv(gt_b[0])
        gts.append(np.stack([(T0_inv @ p).astype(np.float32) for p in gt_b]))

    mesh = distributed.make_mesh(4, axis="seq")
    final, outs = multi_sequence.batch_odometry(scans, masks, cfg, map_capacity=16384,
                                                mesh=mesh)
    poses = np.asarray(outs["pose"])
    assert poses.shape == (B, F, 4, 4)
    for b in range(B):
        ate = ate_rmse(poses[b], gts[b], align=False)
        traveled = np.sum(np.linalg.norm(np.diff(gts[b][:, :3, 3], axis=0), axis=1))
        assert ate < max(0.05 * traveled, 0.35), f"seq {b}: ATE {ate:.3f} over {traveled:.1f} m"
    # Keyframe counters advanced and the first frame bootstrapped everywhere.
    assert (np.asarray(final.kf_count) >= 2).all()
    assert np.asarray(outs["is_keyframe"])[:, 0].all()


@pytest.mark.slow
def test_batch_slam_four_sequences_with_loops():
    """configs[3] end-to-end: 4 sequences through batched odometry + per-sequence graph
    back ends in ONE call — 4 optimized trajectories, loop closures firing, optimized
    ATE no worse than raw odometry."""
    from lidar_graph_slam_tpu.core.config import CapacityConfig, GraphSlamConfig

    B, F, N = 4, 90, 4096
    cfg = ScanMatcherConfig(
        max_scan_accumulate_num=10,
        ndt=NdtConfig(resolution=2.0),
    )
    scans = np.full((B, F, N, 3), 1.0e6, dtype=np.float32)
    masks = np.zeros((B, F, N), dtype=bool)
    gts = []
    for b in range(B):
        # Course/scan regime proven by tests/test_pipeline.py (radius 30, ~2.3 m and
        # ~4.6 deg per frame, 4096+ points): tighter/sparser variants diverge the
        # odometry itself and no loop can fire.
        seq = SyntheticSequence(n_frames=F, seed=20 + b, max_points=N, laps=1.1,
                                radius=30.0 + b)
        gt_b = []
        for f, (scan, gt_pose) in enumerate(seq):
            k = scan.shape[0]
            scans[b, f, :k] = scan
            masks[b, f, :k] = True
            gt_b.append(gt_pose)
        T0_inv = np.linalg.inv(gt_b[0])
        gts.append(np.stack([(T0_inv @ p).astype(np.float32) for p in gt_b]))

    mesh = distributed.make_mesh(4, axis="seq")
    results = multi_sequence.batch_slam(
        scans, masks, cfg,
        graph_cfg=GraphSlamConfig(),
        capacity=CapacityConfig(
            raw_points=N, filtered_points=N, keyframe_points=N,
            loop_submap_points=32768, max_keyframes=128, voxel_capacity=16384,
            max_loop_factors=8),
        map_capacity=16384, mesh=mesh, loop_every_keyframes=4,
    )
    assert len(results) == 4
    total_loops = 0
    for b, res in enumerate(results):
        kf_idx = res["keyframe_frame_indices"]
        assert res["keyframe_poses"].shape[0] == kf_idx.shape[0] >= 5
        kf_gt = gts[b][kf_idx]
        ate_opt = ate_rmse(res["keyframe_poses"], kf_gt, align=False)
        ate_odom = ate_rmse(res["odometry_poses"][kf_idx], kf_gt, align=False)
        assert ate_opt <= ate_odom * 1.2 + 0.05, f"seq {b}: {ate_opt} vs {ate_odom}"
        total_loops += res["num_loop_closures"]
    assert total_loops >= 1, "no loop closures across 4 looping sequences"
