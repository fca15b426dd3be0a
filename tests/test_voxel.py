"""Voxel-grid kernels vs. numpy oracles (pcl::VoxelGrid centroid semantics)."""

import numpy as np
import jax.numpy as jnp

from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.ops import voxel


def numpy_voxel_centroids(pts, leaf, origin):
    coords = np.floor((pts - origin) / leaf).astype(np.int64)
    out = {}
    for c, p in zip(map(tuple, coords), pts):
        out.setdefault(c, []).append(p)
    return {c: np.mean(np.stack(v), axis=0) for c, v in out.items()}


def test_voxel_downsample_matches_numpy(rng):
    pts = rng.uniform(-20, 20, size=(3000, 3)).astype(np.float32)
    cloud = PointCloud.from_array(pts, capacity=4096)
    leaf = 1.0
    grid = voxel.voxel_downsample(cloud.points, cloud.mask, jnp.float32(leaf), capacity=8192)

    origin = pts.min(axis=0) - leaf
    oracle = numpy_voxel_centroids(pts, leaf, origin)
    got = np.asarray(grid.points)[np.asarray(grid.mask)]
    assert int(grid.num_voxels) == len(oracle)
    assert not bool(grid.overflow)
    # Match centroids as sets (order differs).
    oracle_sorted = np.array(sorted(map(tuple, np.round(np.stack(list(oracle.values())), 4))))
    got_sorted = np.array(sorted(map(tuple, np.round(got, 4))))
    np.testing.assert_allclose(oracle_sorted, got_sorted, atol=1e-3)


def test_voxel_downsample_permutation_invariant(rng):
    pts = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    perm = rng.permutation(500)
    a = PointCloud.from_array(pts, capacity=512)
    b = PointCloud.from_array(pts[perm], capacity=512)
    ga = voxel.voxel_downsample(a.points, a.mask, jnp.float32(0.7), capacity=1024)
    gb = voxel.voxel_downsample(b.points, b.mask, jnp.float32(0.7), capacity=1024)
    pa = np.asarray(ga.points)[np.asarray(ga.mask)]
    pb = np.asarray(gb.points)[np.asarray(gb.mask)]
    np.testing.assert_allclose(
        np.array(sorted(map(tuple, np.round(pa, 4)))),
        np.array(sorted(map(tuple, np.round(pb, 4)))),
        atol=1e-3,
    )


def test_voxel_downsample_respects_mask(rng):
    pts = rng.uniform(-5, 5, size=(100, 3)).astype(np.float32)
    cloud = PointCloud.from_array(pts, capacity=256)  # 156 padded rows
    grid = voxel.voxel_downsample(cloud.points, cloud.mask, jnp.float32(0.5), capacity=512)
    got = np.asarray(grid.points)[np.asarray(grid.mask)]
    # All centroids must lie inside the data bounding box (no PAD_VALUE leakage).
    assert np.all(np.abs(got) < 6.0)


def test_ndt_map_gaussians(rng):
    # Oracle: group points by the same voxel assignment and check per-voxel mean/cov.
    centers = np.array([[1.0, 1.0, 1.0], [7.0, 1.0, 1.0]], dtype=np.float32)
    chunks = []
    for c in centers:
        chunks.append(c + rng.normal(size=(400, 3)).astype(np.float32) * [0.3, 0.1, 0.05])
    pts = np.concatenate(chunks)
    cloud = PointCloud.from_array(pts, capacity=1024)
    res = 4.0
    vm = voxel.build_ndt_map(cloud.points, cloud.mask, jnp.float32(res), capacity=64)

    origin = np.asarray(vm.origin)
    coords = np.floor((pts - origin) / res).astype(np.int64)
    groups = {}
    for c, p in zip(map(tuple, coords), pts):
        groups.setdefault(c, []).append(p)
    oracle = {
        c: (np.mean(np.stack(v), axis=0), np.cov(np.stack(v).T))
        for c, v in groups.items()
        if len(v) >= 6
    }

    valid = np.asarray(vm.valid)
    means = np.asarray(vm.means)[valid]
    icovs = np.asarray(vm.inv_covs)[valid]
    assert means.shape[0] == len(oracle)
    oracle_means = np.stack([m for m, _ in oracle.values()])
    # Match each engine voxel to its nearest oracle voxel mean.
    for m, icov in zip(means, icovs):
        j = np.argmin(np.linalg.norm(oracle_means - m, axis=1))
        om, ocov = list(oracle.values())[j]
        np.testing.assert_allclose(m, om, atol=1e-3)
        # Inverse covariance should invert the (regularized) sample covariance; the
        # clusters here are well-conditioned enough that regularization barely bites.
        np.testing.assert_allclose(icov @ ocov, np.eye(3), atol=0.35)


def test_ndt_min_points_gate(rng):
    # A voxel with < min_points points must be invalid.
    pts = np.array([[0.5, 0.5, 0.5], [0.6, 0.5, 0.5], [10.0, 10.0, 5.0]], dtype=np.float32)
    cloud = PointCloud.from_array(pts, capacity=16)
    vm = voxel.build_ndt_map(cloud.points, cloud.mask, jnp.float32(2.0), capacity=16, min_points=3)
    assert int(np.sum(np.asarray(vm.valid))) == 0


def test_lookup_direct7(rng):
    pts = rng.uniform(0, 10, size=(4000, 3)).astype(np.float32)
    cloud = PointCloud.from_array(pts, capacity=4096)
    res = 2.0
    vm = voxel.build_ndt_map(cloud.points, cloud.mask, jnp.float32(res), capacity=512)

    queries = jnp.asarray(rng.uniform(1, 9, size=(50, 3)).astype(np.float32))
    means, icovs, hit = voxel.lookup_direct7(vm, queries)
    assert means.shape == (50, 7, 3)
    hit_np = np.asarray(hit)
    # Interior queries must at least hit their own voxel (dense uniform cloud).
    assert hit_np[:, 0].all()
    # Every hit voxel's mean must be within the DIRECT7 reach (~2 cells).
    d = np.linalg.norm(np.asarray(means) - np.asarray(queries)[:, None, :], axis=-1)
    assert np.all(d[hit_np] < 2 * res * np.sqrt(3))


def test_ndt_pyramid_matches_direct_builds(rng):
    """build_ndt_pyramid: fine map identical to build_ndt_map; coarse map's Gaussians
    exactly match a numpy oracle over the SAME partition (fine origin, coarse leaf) —
    the moment-shift merge is algebraically exact, not an approximation."""
    pts = rng.uniform(0, 24, size=(20000, 3)).astype(np.float32)
    cloud = PointCloud.from_array(pts, capacity=32768)
    res, factor = 2.0, 2
    coarse, fine = voxel.build_ndt_pyramid(
        cloud.points, cloud.mask, jnp.float32(res), factor,
        capacity=4096, coarse_capacity=2048,
    )
    direct_fine = voxel.build_ndt_map(cloud.points, cloud.mask, jnp.float32(res), capacity=4096)
    np.testing.assert_allclose(np.asarray(fine.means), np.asarray(direct_fine.means), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(fine.keys), np.asarray(direct_fine.keys))

    # Oracle: group raw points by (fine-origin, coarse-leaf) voxel.
    origin = np.asarray(fine.origin)
    leaf_c = res * factor
    coords = np.floor((pts - origin) / leaf_c).astype(np.int64)
    keys = (coords[:, 0] << 19) | (coords[:, 1] << 8) | coords[:, 2]
    c_means = np.asarray(coarse.means)
    c_valid = np.asarray(coarse.valid)
    c_covs_inv = np.asarray(coarse.inv_covs)
    checked = 0
    for k in np.unique(keys):
        sel = pts[keys == k]
        if sel.shape[0] < 6:
            continue
        mu = sel.mean(axis=0)
        # find the pyramid voxel whose mean is nearest
        j = int(np.argmin(np.linalg.norm(c_means - mu, axis=1)))
        assert c_valid[j], f"coarse voxel missing for oracle cell {k}"
        np.testing.assert_allclose(c_means[j], mu, atol=1e-3)
        cov = np.cov(sel.T, bias=False)
        # inv_covs inverts the regularized covariance; well-conditioned cells barely move.
        np.testing.assert_allclose(c_covs_inv[j] @ cov, np.eye(3), atol=0.35)
        checked += 1
    assert checked >= 20


def test_eigh3x3_equal_diagonal():
    """tau = 0 (equal diagonal entries with nonzero coupling) must
    produce the exact 45-degree Jacobi rotation — jnp.sign(0) = 0 silently discarded
    the off-diagonal mass and returned wrong eigenvalues for symmetric/axis-diagonal
    point arrangements."""
    import numpy as np

    from lidar_graph_slam_tpu.ops.voxel import _eigh3x3

    As = np.stack([
        np.array([[1.0, 0.5, 0.0], [0.5, 1.0, 0.0], [0.0, 0.0, 2.0]]),
        np.array([[2.0, 0.0, -0.3], [0.0, 5.0, 0.0], [-0.3, 0.0, 2.0]]),
        np.array([[3.0, 1.0, 1.0], [1.0, 3.0, 1.0], [1.0, 1.0, 3.0]]),
    ]).astype(np.float32)
    w, V = _eigh3x3(jnp.asarray(As))
    w, V = np.asarray(w), np.asarray(V)
    for i in range(As.shape[0]):
        w_ref = np.linalg.eigvalsh(As[i].astype(np.float64))
        np.testing.assert_allclose(np.sort(w[i]), w_ref, atol=1e-5)
        recon = (V[i] * w[i][None, :]) @ V[i].T
        np.testing.assert_allclose(recon, As[i], atol=1e-5)


def test_eigh3x3_matches_linalg_eigh(rng):
    """`_eigh3x3` against `jnp.linalg.eigh` on a batch of random symmetric PSD matrices
    (including equal-diagonal and diagonal ones): same ascending eigenvalues, and the
    eigenvector columns reconstruct the input and are orthonormal."""
    from lidar_graph_slam_tpu.ops.voxel import _eigh3x3

    A = rng.normal(size=(256, 3, 3)).astype(np.float32)
    As = np.einsum("kij,klj->kil", A, A)
    As[0] = [[1.0, 0.5, 0.0], [0.5, 1.0, 0.0], [0.0, 0.0, 2.0]]   # tau = 0 case
    As[1] = np.diag([3.0, 1.0, 2.0])                             # already diagonal
    w, V = _eigh3x3(jnp.asarray(As))
    w_ref, _ = jnp.linalg.eigh(jnp.asarray(As))
    w, V, w_ref = np.asarray(w), np.asarray(V), np.asarray(w_ref)
    scale = np.abs(w_ref).max(axis=1, keepdims=True)
    np.testing.assert_allclose(w / scale, w_ref / scale, atol=2e-6)
    assert np.all(np.diff(w, axis=1) >= 0)
    recon = np.einsum("kij,kj,klj->kil", V, w, V)
    np.testing.assert_allclose(recon, As, atol=2e-5 * scale.max())
    np.testing.assert_allclose(np.einsum("kji,kjl->kil", V, V),
                               np.broadcast_to(np.eye(3), V.shape), atol=1e-5)
