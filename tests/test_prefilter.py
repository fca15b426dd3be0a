"""Prefilter pipeline vs. reference semantics (`points_prefiltering.cpp:65-140`)."""

import numpy as np
import jax.numpy as jnp

from lidar_graph_slam_tpu.core.config import PrefilterConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.filters import prefilter


def make_scan(rng, n=2000):
    """Ring-like LiDAR-ish scan with some near-sensor and stray points."""
    theta = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(2.0, 30.0, n)
    z = rng.uniform(-1.5, 1.5, n)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1).astype(np.float32)


def test_distance_filter(rng):
    pts = np.array([[0.5, 0, 0], [2.0, 0, 0], [0, 0.9, 0], [10, 0, 0]], dtype=np.float32)
    cloud = PointCloud.from_array(pts, capacity=8)
    keep = prefilter.distance_filter(cloud.points, cloud.mask, 1.0)
    np.testing.assert_array_equal(np.asarray(keep)[:4], [False, True, False, True])
    # max_distance enabled drops the far point too.
    keep2 = prefilter.distance_filter(cloud.points, cloud.mask, 1.0, 5.0)
    np.testing.assert_array_equal(np.asarray(keep2)[:4], [False, True, False, False])


def test_crop_filter(rng):
    pts = np.array([[0, 0, 0], [6, 0, 0], [-6, 0, 0], [0, 0, 3]], dtype=np.float32)
    cloud = PointCloud.from_array(pts, capacity=8)
    keep = prefilter.crop_filter(cloud.points, cloud.mask, (-5, -5, -5), (5, 5, 5))
    np.testing.assert_array_equal(np.asarray(keep)[:4], [True, False, False, True])


def test_statistical_outlier_removal(rng):
    # Dense cluster + one stray point far away: SOR must kill the stray.
    cluster = rng.normal(size=(500, 3)).astype(np.float32) * 0.5
    stray = np.array([[4.5, 4.5, 0.0]], dtype=np.float32)
    pts = np.concatenate([cluster, stray])
    cloud = PointCloud.from_array(pts, capacity=512)
    keep = prefilter.statistical_outlier_mask(
        cloud.points, cloud.mask, mean_k=20, stddev_mult=jnp.float32(1.0), cell_size=5.0,
        window=64,
    )
    keep_np = np.asarray(keep)
    assert not keep_np[500]           # stray dropped
    assert keep_np[:500].mean() > 0.8  # bulk of cluster survives


def test_random_sample_mask(rng):
    pts = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    cloud = PointCloud.from_array(pts, capacity=512)
    import jax

    keep = prefilter.random_sample_mask(cloud.points, cloud.mask, 100, jax.random.PRNGKey(1))
    assert int(np.asarray(keep).sum()) == 100
    assert not np.asarray(keep)[300:].any()


def test_full_prefilter_pipeline(rng):
    scan = make_scan(rng, 4000)
    near = rng.normal(size=(50, 3)).astype(np.float32) * 0.2  # inside min_distance
    pts = np.concatenate([scan, near])
    cloud = PointCloud.from_array(pts, capacity=8192)

    cfg = PrefilterConfig(leaf_size=0.5, mean_k=10)
    fn = prefilter.make_prefilter(cfg, capacity_out=4096, voxel_capacity=8192)
    out = fn(cloud.points, cloud.mask)

    got = out.to_array()
    assert got.shape[0] > 100
    ranges = np.linalg.norm(got, axis=1)
    assert ranges.min() > cfg.min_distance * 0.9  # near-sensor points gone
    # Output must be compacted: valid rows contiguous at the front.
    mask = np.asarray(out.mask)
    first_invalid = mask.argmin() if not mask.all() else len(mask)
    assert not mask[first_invalid:].any()


def test_prefilter_deterministic(rng):
    scan = make_scan(rng, 1000)
    cloud = PointCloud.from_array(scan, capacity=2048)
    cfg = PrefilterConfig(leaf_size=0.4, mean_k=10)
    fn = prefilter.make_prefilter(cfg, capacity_out=2048, voxel_capacity=4096)
    a = fn(cloud.points, cloud.mask)
    b = fn(cloud.points, cloud.mask)
    np.testing.assert_array_equal(np.asarray(a.points), np.asarray(b.points))


def test_compact_evenly_matches_compact_under_capacity(rng):
    from lidar_graph_slam_tpu.core.pointcloud import compact, compact_evenly

    pts = jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))
    mask = jnp.asarray(rng.uniform(size=64) < 0.3)
    for got, want in zip(compact_evenly(pts, mask, 32), compact(pts, mask, 32)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_compact_evenly_spans_all_valid_rows_over_capacity(rng):
    from lidar_graph_slam_tpu.core.pointcloud import compact_evenly

    # 100,003 valid rows into 32,768: j * n overflows int32, so the picks must not.
    n_rows, n_valid, cap = 131072, 100003, 32768
    mask = np.zeros(n_rows, bool)
    mask[np.sort(rng.choice(n_rows, n_valid, replace=False))] = True
    x = np.arange(n_rows, dtype=np.float32)
    pts = np.stack([x, np.zeros_like(x), np.zeros_like(x)], axis=1)
    out_pts, out_mask = compact_evenly(jnp.asarray(pts), jnp.asarray(mask), cap)
    out_mask = np.asarray(out_mask)
    assert out_mask.all()
    kept = np.asarray(out_pts)[:, 0].astype(np.int64)
    rank = np.cumsum(mask) - 1  # each kept row's position among the valid rows
    r = rank[kept]
    assert mask[kept].all() and np.all(np.diff(r) > 0)  # distinct, in order
    assert r[0] == 0 and r[-1] >= n_valid - 4            # head to tail of the valid rows
    assert np.diff(r).max() <= -(-n_valid // cap)        # no gap beyond the even stride


def test_prefilter_over_capacity_keeps_the_whole_scan(rng):
    scan = make_scan(rng, 6000)
    cloud = PointCloud.from_array(scan, capacity=8192)
    cfg = PrefilterConfig(leaf_size=0.05, use_outlier_filter=False)
    fn = prefilter.make_prefilter(cfg, capacity_out=1024, voxel_capacity=8192)
    got = fn(cloud.points, cloud.mask).to_array()
    assert got.shape[0] == 1024
    # Voxel-key order runs along x: a head cut would keep only the x < 0 side.
    assert (got[:, 0] > 10.0).sum() > 100 and (got[:, 0] < -10.0).sum() > 100
