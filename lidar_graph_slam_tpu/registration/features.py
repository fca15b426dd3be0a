"""FPFH features + vectorized-RANSAC global registration.

The reference's own roadmap lists "Scan Matching with FPFH" as a TODO (`README.md:33-39`);
its loop verifier instead relies on a 30 m ICP correspondence distance to survive large
drift (`graph_based_slam/src/graph_based_slam.cpp:142-151`). This module supplies the
missing capability, data-parallel throughout:

  * Normals and FPFH neighborhoods come from the engine's sorted-grid kNN
    (`ops/neighbors.py`) — no kd-trees.
  * The 33-bin FPFH histograms are built with one-hot scatter-free binning (elementwise
    selects) and neighbor gathers over fixed [Q, k] index arrays.
  * Feature matching is one [Q, M] squared-distance matrix via matmul.
  * RANSAC is not a sequential loop: H hypotheses are drawn, solved (batched 3-point
    Kabsch via SVD), edge-length-checked, and inlier-scored *simultaneously* with vmapped
    dense math, then the winner is refined by masked inlier Kabsch. Deterministic
    (threefry key in, no host randomness), fixed shapes throughout.

Used by the back end as an optional initial-guess stage for loop verification
(`GraphSlamConfig.use_global_init`): where the reference's identity-guess ICP fails past
~15 m of drift, FPFH+RANSAC recovers arbitrary-rotation loop candidates.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.ops.neighbors import HashGrid, build_hash_grid, knn
from lidar_graph_slam_tpu.ops.voxel import voxel_downsample


def estimate_normals(
    grid: HashGrid,
    queries: jax.Array,
    qmask: jax.Array,
    k: int = 16,
    viewpoint: jax.Array | None = None,
    bucket_cap: int = 16,
):
    """Per-query surface normals from the k-NN covariance's smallest eigenvector.

    Orientation follows PCL: flipped toward `viewpoint` (default origin — the sensor
    position for a sensor-frame cloud). Returns (normals [Q, 3], valid [Q]).
    """
    idx, _, nvalid = knn(grid, queries, k=k, bucket_cap=bucket_cap)
    nbrs = grid.points[idx]                                   # [Q, k, 3]
    w = nvalid.astype(queries.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)                # [Q, 1]
    mu = jnp.sum(nbrs * w, axis=1) / cnt
    d = (nbrs - mu[:, None, :]) * w
    cov = jnp.einsum("qki,qkj->qij", d, d) / cnt[..., None]
    # Guard degenerate rows so eigh stays well-posed.
    ok = qmask & (jnp.sum(nvalid, axis=1) >= 3)
    eye = jnp.eye(3, dtype=cov.dtype)
    cov = jnp.where(ok[:, None, None], cov, eye)
    from lidar_graph_slam_tpu.ops.voxel import _eigh3x3  # batched-3x3-fast Jacobi

    _, vecs = _eigh3x3(cov)
    n = vecs[..., 0]                                          # smallest-eigenvalue column
    vp = jnp.zeros((3,), queries.dtype) if viewpoint is None else viewpoint
    flip = jnp.sum(n * (vp[None, :] - queries), axis=-1) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    return n, ok


def _bin_index(x: jax.Array, lo: float, hi: float, bins: int) -> jax.Array:
    f = (x - lo) / (hi - lo)
    return jnp.clip((f * bins).astype(jnp.int32), 0, bins - 1)


def _histogram(bin_idx: jax.Array, weight: jax.Array, bins: int) -> jax.Array:
    """Weighted histogram over the last axis: bin_idx/weight [Q, k] -> [Q, bins].

    One-hot + matmul-free accumulation (comparisons and masked sums)."""
    edges = jnp.arange(bins, dtype=jnp.int32)
    onehot = (bin_idx[..., None] == edges).astype(weight.dtype)  # [Q, k, bins]
    return jnp.sum(onehot * weight[..., None], axis=-2)


def _pair_features(p, n_p, q, n_q, eps=1e-12):
    """Darboux-frame angular features (alpha, phi, theta) for point pairs.

    p, n_p: [..., 3] source point/normal; q, n_q: [..., 3] neighbor point/normal.
    PCL convention (pcl::computePairFeatures): the frame anchors at the point whose
    normal makes the smaller angle with the connecting line; we keep the fixed (p, q)
    ordering — consistent across both clouds, which is all matching needs.
    """
    d = q - p
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), eps))
    dn = d / dist[..., None]
    u = n_p
    v = jnp.cross(dn, u)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)
    w = jnp.cross(u, v)
    alpha = jnp.sum(v * n_q, axis=-1)                  # [-1, 1]
    phi = jnp.sum(u * dn, axis=-1)                     # [-1, 1]
    theta = jnp.arctan2(jnp.sum(w * n_q, axis=-1), jnp.sum(u * n_q, axis=-1))
    return alpha, phi, theta, dist


@partial(jax.jit, static_argnames=("k", "bins", "bucket_cap"))
def compute_fpfh(
    grid: HashGrid,
    points: jax.Array,
    mask: jax.Array,
    normals: jax.Array,
    k: int = 16,
    bins: int = 11,
    bucket_cap: int = 16,
):
    """Fast Point Feature Histograms [Rusu 2009] for a keypoint cloud.

    `grid` must be built over `points` (self-neighborhoods). Returns ([Q, 3*bins]
    L1-normalized histograms, valid [Q]). SPFH is computed per point over its k
    neighbors, then FPFH(p) = SPFH(p) + mean_j( SPFH(q_j) / dist_j ).
    """
    q = points.shape[0]
    idx, d2, nvalid = knn(grid, points, k=k, bucket_cap=bucket_cap)
    # Drop self-matches (distance ~ 0).
    nvalid = nvalid & (d2 > 1e-12) & mask[:, None]
    nbr_pts = grid.points[idx]                               # [Q, k, 3]
    # Neighbor normals: grid rows are sorted copies of `points`; map back via grid.order.
    normals_sorted_rows = normals[grid.order]                # normal of grid.points[r]
    nbr_nrm = normals_sorted_rows[idx]                       # [Q, k, 3]

    alpha, phi, theta, dist = _pair_features(
        points[:, None, :], normals[:, None, :], nbr_pts, nbr_nrm
    )
    wgt = nvalid.astype(points.dtype)
    h_a = _histogram(_bin_index(alpha, -1.0, 1.0, bins), wgt, bins)
    h_p = _histogram(_bin_index(phi, -1.0, 1.0, bins), wgt, bins)
    h_t = _histogram(_bin_index(theta, -jnp.pi, jnp.pi, bins), wgt, bins)
    spfh = jnp.concatenate([h_a, h_p, h_t], axis=-1)         # [Q, 3*bins]
    cnt = jnp.maximum(jnp.sum(wgt, axis=-1, keepdims=True), 1.0)
    spfh = spfh / cnt                                        # per-point normalized SPFH

    # FPFH aggregation: gather neighbors' SPFH (sorted-row indexing again).
    spfh_sorted_rows = spfh[grid.order]
    nbr_spfh = spfh_sorted_rows[idx]                         # [Q, k, 3*bins]
    inv_d = jnp.where(nvalid, 1.0 / jnp.sqrt(jnp.maximum(d2, 1e-12)), 0.0)
    agg = jnp.sum(nbr_spfh * inv_d[..., None], axis=1) / jnp.maximum(
        jnp.sum(inv_d, axis=1, keepdims=True), 1e-12
    )
    fpfh = spfh + agg
    # L1-normalize each sub-histogram block (scale invariance across densities).
    blocks = fpfh.reshape(q, 3, bins)
    blocks = blocks / jnp.maximum(jnp.sum(blocks, axis=-1, keepdims=True), 1e-12)
    valid = mask & (jnp.sum(nvalid, axis=-1) >= 3)
    return jnp.where(valid[:, None], blocks.reshape(q, 3 * bins), 0.0), valid


@partial(jax.jit, static_argnames=())
def match_features(f_src, src_valid, f_tgt, tgt_valid, ratio: float = 0.85):
    """Mutual-nearest correspondence in feature space with a Lowe ratio test.

    Returns (match_idx [Q] into target rows, match_ok [Q]). The [Q, M] distance matrix is
    one matmul. The ratio test (best / second-best feature
    distance < `ratio`) rejects ambiguous matches from repeated structure (ground planes,
    parallel walls) — without it the inlier fraction collapses on planar-heavy scenes.
    """
    d2 = (
        jnp.sum(f_src * f_src, axis=-1)[:, None]
        - 2.0 * f_src @ f_tgt.T
        + jnp.sum(f_tgt * f_tgt, axis=-1)[None, :]
    )
    d2 = jnp.where(tgt_valid[None, :], d2, jnp.inf)
    d2 = jnp.where(src_valid[:, None], d2, jnp.inf)
    fwd = jnp.argmin(d2, axis=1)                              # [Q]
    best = jnp.min(d2, axis=1)
    # Second-best: mask the winning column per row, take the min again.
    cols = jnp.arange(d2.shape[1])
    second = jnp.min(jnp.where(cols[None, :] == fwd[:, None], jnp.inf, d2), axis=1)
    distinct = best < (ratio * ratio) * second                # squared distances
    bwd = jnp.argmin(d2, axis=0)                              # [M]
    mutual = bwd[fwd] == jnp.arange(f_src.shape[0])
    ok = src_valid & mutual & distinct & jnp.isfinite(best)
    return fwd, ok


def _kabsch(src, tgt, w):
    """Weighted rigid alignment src -> tgt. src/tgt [..., P, 3], w [..., P] >= 0."""
    wn = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mu_s = jnp.einsum("...p,...pi->...i", wn, src)
    mu_t = jnp.einsum("...p,...pi->...i", wn, tgt)
    S = jnp.einsum("...p,...pi,...pj->...ij", wn, src - mu_s[..., None, :], tgt - mu_t[..., None, :])
    U, _, Vt = jnp.linalg.svd(S)
    det = jnp.linalg.det(jnp.swapaxes(Vt, -1, -2) @ jnp.swapaxes(U, -1, -2))
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]],
        axis=-1,
    )
    R = jnp.einsum("...ji,...j,...kj->...ik", Vt, D, U)  # V diag(D) U^T
    t = mu_t - jnp.einsum("...ij,...j->...i", R, mu_s)
    T = jnp.zeros(src.shape[:-2] + (4, 4), src.dtype)
    T = T.at[..., :3, :3].set(R).at[..., :3, 3].set(t).at[..., 3, 3].set(1.0)
    return T


@partial(jax.jit, static_argnames=("hypotheses",))
def ransac_align(
    src_kp,
    src_valid,
    tgt_kp,
    tgt_valid,
    match_idx,
    match_ok,
    key,
    src_normals=None,
    tgt_normals=None,
    hypotheses: int = 1024,
    inlier_threshold: float = 1.0,
    occupancy_leaf: float = 2.0,
    edge_similarity: float = 0.9,
    min_occupancy: float = 0.3,
):
    """Global alignment: feature matches generate hypotheses, voxel occupancy scores them.

    src_kp [Q, 3], tgt_kp [M, 3], match_idx/match_ok from `match_features`.
    Returns (T [4,4], occupancy_hits i32, ok bool).

    Scoring is deliberately correspondence-FREE: a hypothesis is judged by how many valid
    source keypoints land in target-occupied voxels (DIRECT1 lookup at `occupancy_leaf`),
    not by feature-match agreement. Feature matching on sparse or repetitive scenes yields
    few trustworthy pairs — enough to *propose* a pose, far too few to *rank* poses.
    Occupancy ranking uses all the geometry: H x Q cell gathers on a dense table.

    Two proposal families run half-and-half (when normals are given):
      * 3-point Kabsch triples — full SE(3), needs THREE correct matches (rate^3);
      * 1-point yaw — one correct match + the normal-azimuth difference fixes a
        gravity-aligned pose (rate^1). Linear instead of cubic in match precision; on
        non-gravity-aligned worlds these simply score low and lose the argmax — the
        scorer arbitrates, no prior is imposed on the result.
    """
    from lidar_graph_slam_tpu.ops.voxel import (
        TABLE_DIMS, _flat_table_index, build_dense_table, min_corner, pack_key, voxel_coords,
    )

    tgt_of_src = tgt_kp[match_idx]                            # [Q, 3]

    # Occupancy table over target keypoints.
    leaf = jnp.asarray(occupancy_leaf, src_kp.dtype)
    origin = min_corner(tgt_kp, tgt_valid) - leaf
    tkeys = pack_key(voxel_coords(tgt_kp, origin, 1.0 / leaf))
    table = build_dense_table(jnp.where(tgt_valid, tkeys, jnp.iinfo(jnp.int32).max),
                              tgt_valid, TABLE_DIMS)
    occupied = jnp.concatenate([table >= 0, jnp.zeros((1,), bool)])

    def occupancy_score(T_batch):
        """Hits for [..., 4, 4] transforms: count of valid src keypoints in occupied cells."""
        p = jnp.einsum("...ij,qj->...qi", T_batch[..., :3, :3], src_kp) + T_batch[..., None, :3, 3]
        flat, in_range = _flat_table_index(voxel_coords(p, origin, 1.0 / leaf), TABLE_DIMS)
        hit = occupied[flat] & in_range & src_valid
        return jnp.sum(hit, axis=-1)

    # Sample 3 VALID correspondence rows per hypothesis: compact valid rows to the front
    # (stable argsort of ~ok), then draw positions in [0, n_valid) — every draw is a real
    # correspondence, so hypothesis yield doesn't collapse when valid matches are sparse.
    order = jnp.argsort(jnp.logical_not(match_ok), stable=True)
    n_valid = jnp.sum(match_ok.astype(jnp.int32))
    pos = jax.random.randint(key, (hypotheses, 3), 0, jnp.maximum(n_valid, 1))
    samp = order[pos]                                         # [H, 3]
    s3 = src_kp[samp]                                         # [H, 3, 3]
    t3 = tgt_of_src[samp]
    s_ok = jnp.all(match_ok[samp], axis=-1) & (n_valid >= 3)

    # Edge-length similarity prefilter (Open3D's edge-length checker): each triangle side
    # must match across clouds within `edge_similarity`.
    def edges(x):
        return jnp.stack(
            [
                jnp.linalg.norm(x[:, 0] - x[:, 1], axis=-1),
                jnp.linalg.norm(x[:, 1] - x[:, 2], axis=-1),
                jnp.linalg.norm(x[:, 2] - x[:, 0], axis=-1),
            ],
            axis=-1,
        )
    es, et = edges(s3), edges(t3)
    lo = jnp.minimum(es, et)
    hi = jnp.maximum(es, et)
    shape_ok = jnp.all(lo > edge_similarity * hi, axis=-1) & jnp.all(hi > 1e-3, axis=-1)

    T_h = _kabsch(s3, t3, jnp.ones((hypotheses, 3), src_kp.dtype))  # [H, 4, 4]
    h_ok = s_ok & shape_ok
    h_ok_3pt = h_ok  # pre-merge view for the family-yield diagnostics below
    yaw_ok = jnp.zeros((hypotheses,), bool)
    second_half = jnp.zeros((hypotheses,), bool)

    if src_normals is not None and tgt_normals is not None:
        # 1-point yaw family: replace the second half of the hypothesis buffer.
        key_yaw = jax.random.fold_in(key, 1)
        pos1 = jax.random.randint(key_yaw, (hypotheses,), 0, jnp.maximum(n_valid, 1))
        r1 = order[pos1]                                       # [H]
        p_h = src_kp[r1]
        q_h = tgt_of_src[r1]
        np_h = src_normals[r1]
        nq_h = tgt_normals[match_idx[r1]]
        # Azimuth difference of the normals' horizontal components fixes the yaw;
        # near-vertical normals (ground) leave it undefined -> hypothesis voided.
        horiz_ok = (jnp.linalg.norm(np_h[:, :2], axis=-1) > 0.2) & (
            jnp.linalg.norm(nq_h[:, :2], axis=-1) > 0.2
        )
        theta = jnp.arctan2(nq_h[:, 1], nq_h[:, 0]) - jnp.arctan2(np_h[:, 1], np_h[:, 0])
        c, s = jnp.cos(theta), jnp.sin(theta)
        zero = jnp.zeros_like(c)
        one = jnp.ones_like(c)
        Rz = jnp.stack(
            [c, -s, zero, s, c, zero, zero, zero, one], axis=-1
        ).reshape(hypotheses, 3, 3)
        t_yaw = q_h - jnp.einsum("hij,hj->hi", Rz, p_h)
        T_yaw = jnp.zeros((hypotheses, 4, 4), src_kp.dtype)
        T_yaw = T_yaw.at[:, :3, :3].set(Rz).at[:, :3, 3].set(t_yaw).at[:, 3, 3].set(1.0)
        yaw_ok = match_ok[r1] & horiz_ok & (n_valid >= 1)
        second_half = jnp.arange(hypotheses) >= hypotheses // 2
        T_h = jnp.where(second_half[:, None, None], T_yaw, T_h)
        h_ok = jnp.where(second_half, yaw_ok, h_ok)

    score = occupancy_score(T_h) * h_ok
    best = jnp.argmax(score)
    T_best = T_h[best]

    # Refine: two rounds of inlier-masked Kabsch over the feature correspondences (they
    # polish the pose once it is roughly right), kept only if occupancy agrees.
    def refine(T, _):
        src_t = src_kp @ T[:3, :3].T + T[:3, 3]
        r2 = jnp.sum((src_t - tgt_of_src) ** 2, axis=-1)
        w = ((r2 < inlier_threshold * inlier_threshold) & match_ok).astype(src_kp.dtype)
        T_new = _kabsch(src_kp, tgt_of_src, w)
        good = jnp.sum(w) >= 3
        return jnp.where(good, T_new, T), None

    T_ref, _ = jax.lax.scan(refine, T_best, jnp.arange(2))
    keep_refined = occupancy_score(T_ref) >= score[best]
    T_out = jnp.where(keep_refined, T_ref, T_best)
    hits = occupancy_score(T_out)
    n_src = jnp.maximum(jnp.sum(src_valid.astype(jnp.int32)), 1)
    ok = (score[best] > 0) & (hits >= (min_occupancy * n_src).astype(jnp.int32))
    # Family-yield diagnostics ("no silent caps"): with normals, the 3-point family is
    # silently halved to hypotheses/2 in favor of 1-point-yaw — report each family's
    # valid-hypothesis count and which family won so a starved budget is visible.
    diag = {
        "n_3pt_valid": jnp.sum((h_ok_3pt & ~second_half).astype(jnp.int32)),
        "n_yaw_valid": jnp.sum((yaw_ok & second_half).astype(jnp.int32)),
        "best_is_yaw": second_half[best],
    }
    return T_out, hits, ok, diag


def global_register(
    src_points,
    src_mask,
    tgt_points,
    tgt_mask,
    keypoint_leaf: float = 1.0,
    normal_k: int = 16,
    fpfh_k: int = 32,
    hypotheses: int = 2048,
    inlier_threshold: float = 1.0,
    min_occupancy: float = 0.5,
    max_keypoints: int = 8192,
    src_viewpoint=None,
    tgt_viewpoint=None,
    seed: int = 0,
    return_diag: bool = False,
):
    """FPFH + RANSAC coarse registration of two masked clouds: (T src->tgt, hits, ok).

    The convergence-basin-free stage the reference lacks: output feeds the ICP/GICP/NDT
    verifier as its initial guess, replacing the identity guess of
    `graph_based_slam.cpp:318` when drift exceeds the verifier's basin. `ok` requires a
    `min_occupancy` fraction of valid source keypoints to land in target-occupied voxels.
    Pass `return_diag=True` for a 4th element: the RANSAC family-yield diagnostics
    (3-point vs 1-point-yaw valid counts and the winning family).
    """
    def prep(points, mask, viewpoint):
        g = voxel_downsample(points, mask, jnp.float32(keypoint_leaf), capacity=max_keypoints)
        grid = build_hash_grid(g.points, g.mask, 2.0 * keypoint_leaf)
        nrm, n_ok = estimate_normals(
            grid, g.points, g.mask, k=normal_k,
            viewpoint=None if viewpoint is None else jnp.asarray(viewpoint, jnp.float32),
        )
        feats, f_ok = compute_fpfh(grid, g.points, g.mask, nrm, k=fpfh_k)
        return g.points, g.mask, n_ok & f_ok, feats, nrm

    s_kp, s_m, s_ok, s_f, s_n = prep(src_points, src_mask, src_viewpoint)
    t_kp, t_m, t_ok, t_f, t_n = prep(tgt_points, tgt_mask, tgt_viewpoint)
    m_idx, m_ok = match_features(s_f, s_ok, t_f, t_ok)
    T, hits, ok, diag = ransac_align(
        s_kp, s_m, t_kp, t_m, m_idx, m_ok, jax.random.PRNGKey(seed),
        src_normals=s_n, tgt_normals=t_n,
        hypotheses=hypotheses, inlier_threshold=inlier_threshold,
        occupancy_leaf=2.0 * keypoint_leaf, min_occupancy=min_occupancy,
    )
    if return_diag:
        return T, hits, ok, diag
    return T, hits, ok
