"""IMU-assisted initial guess (the reference's dormant hooks, made functional)."""

import numpy as np
import pytest

from lidar_graph_slam_tpu.core.config import ScanMatcherConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.odometry.scan_matcher import ScanMatcher
from lidar_graph_slam_tpu.utils.evaluation import ate_rmse


def test_imu_rotation_integration():
    sm = ScanMatcher(ScanMatcherConfig(), scan_capacity=512)
    sm.last_scan_stamp = 0.0
    # 0.5 s of 0.2 rad/s yaw.
    for i in range(1, 6):
        sm.add_imu(i * 0.1, [0.0, 0.0, 0.2])
    delta = sm._imu_rotation_delta(0.5)
    assert delta is not None
    yaw = np.arctan2(delta[1, 0], delta[0, 0])
    np.testing.assert_allclose(yaw, 0.1, atol=1e-5)


def test_imu_empty_queue_is_noop():
    sm = ScanMatcher(ScanMatcherConfig(), scan_capacity=512)
    sm.last_scan_stamp = 0.0
    assert sm._imu_rotation_delta(0.5) is None


@pytest.mark.slow
def test_odometry_with_imu_stamps():
    # Feeding stamps + consistent gyro must not hurt tracking.
    n, cap = 12, 4096
    seq = SyntheticSequence(n_frames=n, seed=2, max_points=cap, laps=0.1)
    sm = ScanMatcher(ScanMatcherConfig(), scan_capacity=cap, map_voxel_capacity=32768)
    T0_inv = np.linalg.inv(seq.poses[0])
    # Ground-truth yaw rate of the circular path.
    import jax.numpy as jnp
    from lidar_graph_slam_tpu.core import se3

    est, gt = [], []
    dt = 0.1
    prev_gt = None
    for i, (scan, gt_pose) in enumerate(seq):
        rel = (T0_inv @ gt_pose).astype(np.float32)
        if prev_gt is not None:
            dR = np.asarray(se3.so3_log(jnp.asarray(
                (np.linalg.inv(prev_gt) @ rel)[:3, :3]))) / dt
            sm.add_imu(i * dt - 0.05, dR)
            sm.add_imu(i * dt, dR)
        out = sm.process(PointCloud.from_array(scan, capacity=cap), stamp=i * dt)
        est.append(out["pose"])
        gt.append(rel)
        prev_gt = rel
    ate = ate_rmse(np.stack(est), np.stack(gt), align=False)
    assert ate < 0.35, f"IMU-assisted odometry ATE {ate}"


@pytest.mark.slow
def test_fused_driver_imu_matches_classic():
    """IMU must be reachable in the DEFAULT (fused) driver.
    Feeding the same gyro stream to both drivers must produce matching trajectories."""
    from dataclasses import replace

    import jax.numpy as jnp
    from lidar_graph_slam_tpu.core import se3
    from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline
    from tests.test_pipeline import small_config

    n, cap = 12, 4096
    seq = SyntheticSequence(n_frames=n, seed=2, max_points=cap, laps=0.1)
    scans = [np.asarray(s) for s, _ in seq]
    T0_inv = np.linalg.inv(seq.poses[0])
    dt = 0.1

    results = {}
    for fused in (False, True):
        cfg = replace(small_config(), fused_frontend=fused, enable_loop_closure=False)
        pipe = SlamPipeline(cfg)
        prev_gt = None
        for i, scan in enumerate(scans):
            rel = (T0_inv @ seq.poses[i]).astype(np.float32)
            if prev_gt is not None:
                dR = np.asarray(se3.so3_log(jnp.asarray(
                    (np.linalg.inv(prev_gt) @ rel)[:3, :3]))) / dt
                pipe.add_imu(i * dt - 0.05, dR)
                pipe.add_imu(i * dt, dR)
            pipe.process_scan(scan, stamp=i * dt)
            prev_gt = rel
        results[fused] = pipe.result()

    a = results[False].odometry_poses
    b = results[True].odometry_poses
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])
    for fused, r in results.items():
        err = np.linalg.norm(r.odometry_poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        assert err.max() < 0.6, f"fused={fused} IMU run lost tracking: {err.max():.3f}"
    d = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    assert d.max() < 0.3, f"fused+IMU diverged from classic+IMU: {d.max():.3f}"
