"""Scan prefiltering pipeline — the points_prefiltering node as one device program.

Reproduces the capability set of `points_prefiltering/src/points_prefiltering.cpp:65-87`:
  min-distance filter (`:102-112`) -> [optional crop box, dormant in reference `:73-74`]
  -> voxel-grid downsample (`:114-121`) -> statistical outlier removal (`:132-140`),
plus the dormant random-sampling stage (`:123-130`) as an optional mode.

Everything runs as one jitted program per scan with static shapes: filters mark rows invalid
in the mask; a single sort-based compaction hands the next stage a fixed-capacity cloud. The
reference's max_distance parameter is declared but never used (`points_prefiltering.cpp:51`
vs `:102-112`); here it is wired up but disabled by default to match baseline behavior.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core.config import PrefilterConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud, compact_evenly, pad_points
from lidar_graph_slam_tpu.ops import neighbors, voxel


def distance_filter(points: jax.Array, mask: jax.Array, min_distance, max_distance=0.0) -> jax.Array:
    """Drop points with range <= min_distance (and >= max_distance when enabled)."""
    r = jnp.linalg.norm(points, axis=-1)
    keep = mask & (r > min_distance)
    keep = jnp.where(jnp.asarray(max_distance) > 0.0, keep & (r < max_distance), keep)
    return keep


def crop_filter(points: jax.Array, mask: jax.Array, min_xyz, max_xyz) -> jax.Array:
    """Axis-aligned crop box (the reference's dormant `crop`, `points_prefiltering.cpp:89-100`)."""
    lo = jnp.asarray(min_xyz, dtype=points.dtype)
    hi = jnp.asarray(max_xyz, dtype=points.dtype)
    inside = jnp.all((points >= lo) & (points <= hi), axis=-1)
    return mask & inside


@partial(jax.jit, static_argnames=("mean_k", "window"))
def statistical_outlier_mask(
    points: jax.Array,
    mask: jax.Array,
    mean_k: int,
    stddev_mult,
    cell_size=1.0,
    window: int = 24,
) -> jax.Array:
    """pcl::StatisticalOutlierRemoval semantics: mean distance to k nearest neighbors,
    global mean/std over the cloud, drop points above mean + stddev_mult * std.

    Neighborhoods come from the sorted-grid sliding window (`window_mean_knn_distance`) —
    same-cell neighbors are consecutive after the cell-key sort, so the whole filter runs
    with zero gathers (a 27-cell gather search would issue 27 x bucket gather indices
    per point). Points with < 2 window neighbors are outliers outright,
    matching SOR's intent for isolated LiDAR stray returns.
    """
    grid = neighbors.build_hash_grid(points, mask, cell_size)
    mean_d_sorted, n_found_sorted = neighbors.window_mean_knn_distance(
        grid, k=mean_k, window=window
    )
    # Map per-sorted-row stats back to the original row order.
    n = points.shape[0]
    mean_d = jnp.zeros((n,), points.dtype).at[grid.order].set(mean_d_sorted)
    n_found = jnp.zeros((n,), n_found_sorted.dtype).at[grid.order].set(n_found_sorted)
    has_neighbors = n_found >= 2

    contributes = mask & has_neighbors
    n_total = jnp.maximum(jnp.sum(contributes), 1)
    mu = jnp.sum(jnp.where(contributes, mean_d, 0.0)) / n_total
    var = jnp.sum(jnp.where(contributes, (mean_d - mu) ** 2, 0.0)) / n_total
    thresh = mu + stddev_mult * jnp.sqrt(var)
    return mask & has_neighbors & (mean_d <= thresh)


def random_sample_mask(points: jax.Array, mask: jax.Array, num: int, key: jax.Array) -> jax.Array:
    """Uniform random subsample to `num` points (the reference's dormant
    `random_sampling`, `points_prefiltering.cpp:123-130`), via threefry ranking."""
    scores = jax.random.uniform(key, (points.shape[0],))
    scores = jnp.where(mask, scores, 2.0)  # invalid rows rank last
    order = jnp.argsort(scores)
    rank = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    return mask & (rank < num)


def make_prefilter(cfg: PrefilterConfig, capacity_out: int, voxel_capacity: int):
    """Build a jitted scan -> filtered-scan function for a fixed config.

    Returns fn(points [N,3], mask [N]) -> PointCloud with capacity_out rows.
    """

    @jax.jit
    def prefilter(points: jax.Array, mask: jax.Array) -> PointCloud:
        mask = distance_filter(points, mask, cfg.min_distance, cfg.max_distance)
        if cfg.use_crop:
            mask = crop_filter(points, mask, cfg.min_xyz, cfg.max_xyz)
        points = pad_points(points, mask)

        grid = voxel.voxel_downsample(points, mask, jnp.float32(cfg.leaf_size), capacity=voxel_capacity)
        pts, msk = grid.points, grid.mask

        if cfg.use_outlier_filter:
            # SOR neighborhood cell: ~10 voxel leaves covers pcl's k=30 neighborhood at
            # typical post-voxel densities while keeping buckets small.
            cell = max(cfg.leaf_size * 10.0, 0.5)
            msk = statistical_outlier_mask(pts, msk, cfg.mean_k, jnp.float32(cfg.stddev),
                                           cell_size=cell)
            pts = pad_points(pts, msk)

        if cfg.use_random_sampling:
            msk = random_sample_mask(pts, msk, cfg.random_sample_num, jax.random.PRNGKey(0))
            pts = pad_points(pts, msk)

        out_pts, out_mask = compact_evenly(pts, msk, capacity_out)
        return PointCloud(points=out_pts, mask=out_mask)

    return prefilter
