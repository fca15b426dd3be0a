"""The CLI's main path needs no plotting library: outputs are written without matplotlib."""

import json
import sys

import numpy as np


def test_cli_writes_outputs_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # `import matplotlib` now fails
    from lidar_graph_slam_tpu.pipeline import cli

    out = tmp_path / "out"
    rc = cli.main([
        "--dataset", "synthetic", "--frames", "6", "--output", str(out),
        "--no-loop-closure", "--progress-every", "0",
        "--set", "capacity.raw_points=8192",
        "--set", "capacity.filtered_points=2048",
        "--set", "capacity.keyframe_points=2048",
        "--set", "capacity.max_keyframes=256",
        "--set", "capacity.voxel_capacity=16384",
        "--set", "capacity.loop_submap_points=32768",
        "--set", "capacity.max_loop_factors=16",
    ])
    assert rc == 0
    for f in ("odometry_tum.txt", "odometry_kitti.txt", "keyframes_tum.txt", "map.pcd",
              "metrics.json"):
        assert (out / f).stat().st_size > 0, f
    assert not (out / "map.png").exists()
    assert "map.png skipped" in capsys.readouterr().err
    m = json.loads((out / "metrics.json").read_text())
    assert m["frames"] == 6
    tum = np.loadtxt(out / "odometry_tum.txt", ndmin=2)
    assert tum.shape[0] == 6 and np.isfinite(tum).all()
