"""KITTI-format data path, end-to-end through the public CLI.

No real KITTI data exists in this environment (BASELINE.md), so a tiny synthetic
sequence is written to disk in the exact KITTI odometry layout (velodyne
`NNNNNN.bin` float32 x,y,z,intensity records + `poses/<seq>.txt` 3x4 rows +
`calib.txt` Tr) and the CLI runs `--dataset kitti` over it — driving
`io/kitti.py`, the native `.bin` reader + read-ahead prefetcher
(`native/lgs_io.cpp`), the full pipeline, and the trajectory/map/metrics
exporters. Proves the real-data path before real data ever shows up.
"""

import json

import numpy as np
import pytest

from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence


def _write_kitti_layout(root, n_frames=20):
    seq_dir = root / "sequences" / "00"
    velo = seq_dir / "velodyne"
    velo.mkdir(parents=True)
    poses_dir = root / "poses"
    poses_dir.mkdir()
    seq = SyntheticSequence(n_frames=n_frames, seed=0, laps=0.2, max_points=8192)
    rows = []
    for i, (scan, gt) in enumerate(seq):
        rec = np.zeros((scan.shape[0], 4), np.float32)
        rec[:, :3] = scan
        rec.tofile(velo / f"{i:06d}.bin")
        rows.append(np.asarray(gt, np.float64)[:3].reshape(-1))
    np.savetxt(poses_dir / "00.txt", np.stack(rows))
    # Identity velodyne->cam calib: poses are already in the sensor frame.
    (seq_dir / "calib.txt").write_text("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    return root


@pytest.mark.slow
def test_kitti_cli_end_to_end(tmp_path):
    _write_kitti_layout(tmp_path, n_frames=20)
    from lidar_graph_slam_tpu.pipeline import cli

    out = tmp_path / "out"
    rc = cli.main([
        "--dataset", "kitti", "--kitti-root", str(tmp_path), "--frames", "20",
        "--output", str(out), "--no-loop-closure", "--progress-every", "0",
        "--set", "capacity.raw_points=8192",
        "--set", "capacity.filtered_points=4096",
        "--set", "capacity.keyframe_points=4096",
        "--set", "capacity.max_keyframes=256",
        "--set", "capacity.voxel_capacity=32768",
        "--set", "capacity.loop_submap_points=65536",
        "--set", "capacity.max_loop_factors=16",
    ])
    assert rc == 0
    m = json.loads((out / "metrics.json").read_text())
    assert m["frames"] == 20
    assert m["keyframes"] >= 2
    # Ground truth flowed through poses/00.txt + calib Tr -> ATE is computed and sane.
    assert m["ate_odometry_m"] < 1.0, m
    for f in ("odometry_tum.txt", "odometry_kitti.txt", "keyframes_tum.txt",
              "map.pcd", "map.png"):
        assert (out / f).exists(), f
    # The KITTI-format trajectory export is re-parseable as KITTI poses.
    traj = np.loadtxt(out / "odometry_kitti.txt")
    assert traj.shape == (20, 12)


def test_kitti_sequence_prefetcher_order(tmp_path):
    """The prefetcher path must yield scans in file order with correct counts."""
    _write_kitti_layout(tmp_path, n_frames=6)
    from lidar_graph_slam_tpu.io.kitti import KittiSequence, read_velodyne_bin

    seq = KittiSequence(str(tmp_path), "00", max_points=8192)
    direct = [read_velodyne_bin(f) for f in seq.files]
    for i, (scan, gt) in enumerate(seq):
        np.testing.assert_array_equal(scan, direct[i][: scan.shape[0]])
        assert scan.shape[0] == direct[i].shape[0]
        assert gt is not None
