"""Command-line entry point: `python -m lidar_graph_slam_tpu.pipeline.cli`.

Replaces `ros2 launch lidar_graph_slam lidar_graph_slam.launch.xml` + the `/save_map`
service call (`README.md:22-28` of the reference) with one command producing trajectory
files (TUM + KITTI), the map PCD, and a metrics JSON. The bird's-eye `map.png` is drawn
when matplotlib is installed and skipped (one line on stderr) when it is not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lidar-slam", description="LiDAR graph SLAM in JAX")
    ap.add_argument("--dataset", choices=["synthetic", "kitti"], default="synthetic")
    ap.add_argument("--kitti-root", default=os.environ.get("KITTI_ROOT", "/data/kitti"))
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--set", action="append", default=[], metavar="a.b.c=v",
                    help="config overrides, e.g. --set scan_matcher.registration_method=GICP")
    ap.add_argument("--output", default="out", help="output directory")
    ap.add_argument("--map-resolution", type=float, default=0.5)
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--progress-every", type=int, default=20)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write per-frame structured metrics to this JSONL file")
    ap.add_argument("--live-render", type=int, default=0, metavar="N",
                    help="re-render <output>/live.png every N frames during the run — "
                         "the during-run view standing in for the reference's rviz "
                         "profile (map, trajectories, accepted AND rejected loop "
                         "candidates); 0 disables")
    ap.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed from LGS_COORDINATOR / "
                         "LGS_NUM_PROCESSES / LGS_PROCESS_ID and run the pipeline "
                         "SPMD across processes with the keyframe-cloud store sharded "
                         "per host (city-scale memory partitioning). Every process "
                         "must receive the same scan stream; process 0 writes outputs.")
    args = ap.parse_args(argv)

    is_primary = True
    if args.multihost:
        from lidar_graph_slam_tpu.parallel.multihost import initialize_from_env

        if not initialize_from_env():
            print("[lidar-slam] --multihost: no LGS_* coordinator env, "
                  "running single-process")
        else:
            import jax as _jax

            is_primary = _jax.process_index() == 0
            print(f"[lidar-slam] multihost: process {_jax.process_index()}/"
                  f"{_jax.process_count()}")
            if not is_primary:
                # Every process executes the full SPMD run (map assembly is a
                # collective — all hosts must participate); secondaries write their
                # (identical) outputs to a per-process dir instead of racing on files.
                args.output = f"{args.output}-p{_jax.process_index()}"

    from lidar_graph_slam_tpu.core.config import apply_cli_overrides, load_config
    from lidar_graph_slam_tpu.utils.jit_cache import enable_compilation_cache

    enable_compilation_cache()
    from lidar_graph_slam_tpu.io.pcd import write_kitti_trajectory, write_tum_trajectory
    from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu.utils.evaluation import ate_rmse, rpe

    cfg = load_config(args.config)
    if args.no_loop_closure:
        cfg = apply_cli_overrides(cfg, ["enable_loop_closure=False"])
    if args.set:
        cfg = apply_cli_overrides(cfg, args.set)

    gt_list = []
    if args.dataset == "synthetic":
        from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence

        # Keep per-frame motion (~2.4 m) constant regardless of --frames so short runs
        # stay within the matchers' convergence basin; a full lap needs ~100 frames.
        seq = SyntheticSequence(n_frames=args.frames, seed=0,
                                laps=min(1.08, 1.08 * args.frames / 100.0))
        gt_all = seq.poses
    else:
        from lidar_graph_slam_tpu.io.kitti import KittiSequence

        seq = KittiSequence(args.kitti_root, args.sequence, max_frames=args.frames,
                            max_points=cfg.capacity.raw_points)
        gt_all = seq.gt_poses

    pipe = SlamPipeline(cfg, metrics_path=args.metrics_jsonl)
    os.makedirs(args.output, exist_ok=True)
    if args.live_render > 0:
        from lidar_graph_slam_tpu.utils.viz import render_run

        live_path = os.path.join(args.output, "live.png")
        for i, item in enumerate(seq):
            scan = item[0] if isinstance(item, tuple) else item
            pipe.process_scan(np.asarray(scan))
            if (i + 1) % args.live_render == 0:
                log = pipe.back.loop_log
                render_run(
                    live_path,
                    pipe.back.assemble_map(max(args.map_resolution, 0.3)),
                    np.stack(pipe.odometry_poses),
                    pipe.back.optimized_poses(),
                    loop_pairs=[(l["latest"], l["candidate"]) for l in log if l["accepted"]],
                    rejected_pairs=[
                        (l["latest"], l["candidate"]) for l in log
                        if not l["accepted"] and not l.get("overflow") and l["candidate"] >= 0
                    ],
                )
            if args.progress_every and (i + 1) % args.progress_every == 0:
                print(f"[lidar-slam] frame {i + 1}, keyframes={pipe.back.n_keyframes}, "
                      f"loops={sum(1 for l in pipe.back.loop_log if l['accepted'])}")
        result = pipe.result()
    else:
        result = pipe.run(seq, progress_every=args.progress_every)
    write_tum_trajectory(os.path.join(args.output, "odometry_tum.txt"), result.odometry_poses)
    write_kitti_trajectory(os.path.join(args.output, "odometry_kitti.txt"), result.odometry_poses)
    write_tum_trajectory(os.path.join(args.output, "keyframes_tum.txt"), result.keyframe_poses)
    pipe.save_map(os.path.join(args.output, "map.pcd"), args.map_resolution)

    # Bird's-eye render (the rviz stand-in), an optional host output.
    from lidar_graph_slam_tpu.utils.viz import matplotlib_available, render_run

    if not matplotlib_available():
        print("[lidar-slam] map.png skipped: matplotlib is not installed", file=sys.stderr)
    else:
        gt_for_plot = None
        if gt_all is not None:
            T0_inv_p = np.linalg.inv(gt_all[0])
            gt_for_plot = np.stack([
                (T0_inv_p @ p).astype(np.float32)
                for p in gt_all[: result.odometry_poses.shape[0]]
            ])
        render_run(
            os.path.join(args.output, "map.png"),
            pipe.back.assemble_map(max(args.map_resolution, 0.3)),
            result.odometry_poses,
            result.keyframe_poses,
            loop_pairs=[(l["latest"], l["candidate"]) for l in result.loop_log if l["accepted"]],
            rejected_pairs=[
                (l["latest"], l["candidate"])
                for l in result.loop_log
                if not l["accepted"] and not l.get("overflow") and l["candidate"] >= 0
            ],
            gt_poses=gt_for_plot,
        )

    summary = {
        "frames": int(result.odometry_poses.shape[0]),
        "keyframes": int(result.keyframe_poses.shape[0]),
        "loop_closures": result.num_loop_closures,
        "stage_timings": result.metrics,
    }
    if gt_all is not None:
        n = result.odometry_poses.shape[0]
        T0_inv = np.linalg.inv(gt_all[0])
        gt = np.stack([(T0_inv @ p).astype(np.float32) for p in gt_all[:n]])
        summary["ate_odometry_m"] = ate_rmse(result.odometry_poses, gt, align=False)
        kf_gt = gt[result.keyframe_frame_indices]
        summary["ate_keyframes_m"] = ate_rmse(result.keyframe_poses, kf_gt, align=False)
        t_rpe, r_rpe = rpe(result.odometry_poses, gt)
        summary["rpe_trans_m"] = t_rpe
        summary["rpe_rot_rad"] = r_rpe
    with open(os.path.join(args.output, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
