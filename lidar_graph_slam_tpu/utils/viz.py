"""Offline visualization — the engine's stand-in for the reference's rviz profile.

The reference ships an rviz config displaying `/local_map`, `/filtered_points`,
`/modified_map`, `/scan_matcher_path`, `/modified_path`, `/candidate_key_frame`
(`lidar_graph_slam/rviz/rviz.config:80-281`). Headless hosts get the same signal as
rendered PNGs: bird's-eye map + odometry vs optimized trajectories + loop-closure links.
Rendering needs matplotlib, an optional dependency: callers check
`matplotlib_available()` and skip the PNG without it.
"""

from __future__ import annotations

import numpy as np


def matplotlib_available() -> bool:
    """Whether `render_run` can draw (matplotlib importable)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def render_run(
    path: str,
    map_points: np.ndarray,
    odometry_poses: np.ndarray,
    keyframe_poses: np.ndarray | None = None,
    loop_pairs: list | None = None,
    rejected_pairs: list | None = None,
    gt_poses: np.ndarray | None = None,
    max_map_points: int = 200000,
) -> None:
    """Write a bird's-eye PNG of the map and trajectories.

    `rejected_pairs` renders rejected loop candidates (orange dotted) — the reference's
    `/candidate_key_frame` marker (`graph_based_slam.cpp:284-295`, rviz.config:201), the
    debugging signal for loops that failed the fitness gate."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))
    if map_points is not None and len(map_points):
        pts = np.asarray(map_points)
        if pts.shape[0] > max_map_points:
            idx = np.random.default_rng(0).choice(pts.shape[0], max_map_points, replace=False)
            pts = pts[idx]
        ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c=pts[:, 2], cmap="viridis", alpha=0.4,
                   linewidths=0, rasterized=True)

    if gt_poses is not None and len(gt_poses):
        g = np.asarray(gt_poses)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 1], "-", color="black", lw=1.2, label="ground truth")
    if odometry_poses is not None and len(odometry_poses):
        o = np.asarray(odometry_poses)[:, :3, 3]
        ax.plot(o[:, 0], o[:, 1], "-", color="tab:red", lw=1.0, label="odometry")
    if keyframe_poses is not None and len(keyframe_poses):
        k = np.asarray(keyframe_poses)[:, :3, 3]
        ax.plot(k[:, 0], k[:, 1], "--", color="tab:blue", lw=1.2, label="optimized keyframes")
        if rejected_pairs:
            for a, b in rejected_pairs:
                if 0 <= a < len(k) and 0 <= b < len(k):
                    ax.plot([k[a, 0], k[b, 0]], [k[a, 1], k[b, 1]], ":",
                            color="tab:orange", lw=1.2, alpha=0.9)
            ax.plot([], [], ":", color="tab:orange", label="rejected candidates")
        if loop_pairs:
            for a, b in loop_pairs:
                if a < len(k) and b < len(k):
                    ax.plot([k[a, 0], k[b, 0]], [k[a, 1], k[b, 1]], "-",
                            color="tab:green", lw=1.5, alpha=0.9)
            ax.plot([], [], "-", color="tab:green", label="loop closures")

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="upper right", fontsize=9)
    ax.set_title("lidar_graph_slam_tpu — map and trajectories")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
