"""At-scale run: the 3-lap, 400-frame drift course through the default pipeline.

Writes `docs/at_scale_3laps_400frames.{json,png}`: a sparse world where the NDT odometry
genuinely drifts over ~730 m, so loop closure has real work to do — the regime
`graph_based_slam` exists for. It runs the concurrent back end (async verification +
threaded f64 solve) and records throughput next to accuracy: `steady_fps` (median frame
wall) and `full_run_fps` (whole run incl. back-end work), with the device they ran on.
The PNG needs matplotlib and is skipped without it.

Usage: `python scripts/at_scale.py` from the repo root, on a machine with a GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from lidar_graph_slam_tpu.core.config import PipelineConfig
    from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
    from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu.utils.jit_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    n_frames = 400
    seq = SyntheticSequence(
        n_frames=n_frames, seed=1, extent=60.0, radius=35.0, max_points=131072,
        noise=0.02, laps=3.05, n_azimuth=2048, n_elevation=64,
    )
    scans, gts = [], []
    for scan, gt in seq:
        scans.append(scan)
        gts.append(gt)
    gt_poses = np.stack(gts)

    pipe = SlamPipeline(PipelineConfig())
    pipe.process_scan(scans[0])
    walls = []
    t0 = time.perf_counter()
    for s in scans[1:]:
        a = time.perf_counter()
        pipe.process_scan(s)
        walls.append(time.perf_counter() - a)
    pipe.flush()
    wall = time.perf_counter() - t0
    res = pipe.result()

    import bench

    acc = bench._accuracy(res, gt_poses)  # the same metric block bench.py reports
    # Real attempts only: the loop_log also records the capacity-overflow sentinel
    # (candidate=-1), which is not an attempt.
    attempts = sum(1 for l in pipe.back.loop_log if l.get("candidate", -1) >= 0)
    out = {
        "frames": n_frames,
        "laps": 3.05,
        "keyframes": int(res.keyframe_poses.shape[0]),
        "loops_accepted": int(res.num_loop_closures),
        "loop_attempts": attempts,
        "ate_odometry_m": acc["ate_odometry_m"],
        "ate_keyframes_m": acc["ate_keyframes_m"],
        "rpe_trans_m": acc["rpe_trans_m"],
        "wall_s": round(wall, 1),
        "steady_fps": round(1.0 / max(float(np.median(walls)), 1e-9), 2),
        "full_run_fps": round((n_frames - 1) / wall, 2),
        "backend": "concurrent (async verify + threaded f64 solve)",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }
    print(json.dumps(out))
    doc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "docs", "at_scale_3laps_400frames")
    os.makedirs(os.path.dirname(doc), exist_ok=True)
    with open(doc + ".json", "w") as fh:
        json.dump(out, fh)

    from lidar_graph_slam_tpu.utils.viz import matplotlib_available, render_run

    if not matplotlib_available():
        print(f"{doc}.png skipped: matplotlib is not installed", file=sys.stderr)
        return

    T0_inv = np.linalg.inv(gt_poses[0])
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in gt_poses])
    log = [l for l in pipe.back.loop_log if l.get("candidate", -1) >= 0]
    accepted = [(l["latest"], l["candidate"]) for l in log if l["accepted"]]
    rejected = [(l["latest"], l["candidate"]) for l in log if not l["accepted"]]
    render_run(
        doc + ".png",
        map_points=pipe.back.assemble_map(resolution=0.3),
        odometry_poses=res.odometry_poses,
        keyframe_poses=res.keyframe_poses,
        loop_pairs=accepted,
        rejected_pairs=rejected,
        gt_poses=gt,
    )


if __name__ == "__main__":
    main()
