"""Voxel-grid kernels: centroid downsampling and NDT voxel-Gaussian construction.

Data-parallel replacement for `pcl::VoxelGrid` (used by the prefilter at
`points_prefiltering/src/points_prefiltering.cpp:114-121`, the loop-closure submap at
`graph_based_slam/src/graph_based_slam.cpp:311-313`, and map export at `:487-494`) and for
ndt_omp's target-voxel Gaussian build (per-voxel mean + covariance with eigenvalue
regularization).

Design: no pointer-chasing hash tables. Points are keyed by integer voxel coordinates packed
into a single monotone int32, sorted on the device with XLA's sort, and reduced with
`segment_sum` over sorted segment ids. Voxel lookup for NDT's DIRECT7 neighborhood is a
vectorized binary search (`searchsorted`) over the sorted key array — O(log V) per query with
zero divergence, instead of a kd-tree walk.

Key packing uses (11, 11, 8) bits for (x, y, z) relative to the batch min corner: 2048 x 2048
x 256 cells. At the prefilter leaf (0.1 m) that spans 204 m x 204 m x 25 m per scan; at NDT
resolution (2.0 m) it spans 4 km x 4 km x 512 m. Out-of-range points clamp to border cells.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core.pointcloud import PAD_VALUE, pad_points
from lidar_graph_slam_tpu.core.struct import pytree_dataclass

_BITS_X, _BITS_Y, _BITS_Z = 11, 11, 8
_NX, _NY, _NZ = 1 << _BITS_X, 1 << _BITS_Y, 1 << _BITS_Z
INVALID_KEY = jnp.iinfo(jnp.int32).max

# Dense lookup-table dims (cells): direct 3-D indexing replaces binary search on the hot
# path. (256, 256, 64) cells cover 512 m x 512 m x 128 m at NDT resolution 2.0 and cost
# 16 MB of int32 device memory, in exchange for one gather per query instead of a
# log(V)-step binary-search chain.
TABLE_DIMS = (256, 256, 64)


def unpack_key(key: jax.Array):
    """Inverse of pack_key: int32 key -> (cx, cy, cz)."""
    cx = key >> (_BITS_Y + _BITS_Z)
    cy = (key >> _BITS_Z) & (_NY - 1)
    cz = key & (_NZ - 1)
    return cx, cy, cz


def _flat_table_index(coords: jax.Array, dims) -> tuple[jax.Array, jax.Array]:
    """Coords [..., 3] -> (flat index into the dense table, in-range mask)."""
    dx, dy, dz = dims
    in_range = (
        (coords[..., 0] >= 0) & (coords[..., 0] < dx)
        & (coords[..., 1] >= 0) & (coords[..., 1] < dy)
        & (coords[..., 2] >= 0) & (coords[..., 2] < dz)
    )
    flat = (coords[..., 0] * dy + coords[..., 1]) * dz + coords[..., 2]
    return jnp.where(in_range, flat, dx * dy * dz), in_range


def build_dense_table(keys: jax.Array, row_valid: jax.Array, dims) -> jax.Array:
    """Scatter sorted-row indices into a dense [prod(dims)] int32 table (-1 = empty).

    `keys` are packed voxel keys per row; rows with row_valid=False (or out of table
    range) are dropped. When several rows share a key (hash-grid cells), the FIRST row
    wins via min-scatter — callers pass only first-of-cell rows or per-voxel rows.
    """
    dx, dy, dz = dims
    size = dx * dy * dz
    coords = jnp.stack(unpack_key(keys), axis=-1)
    flat, in_range = _flat_table_index(coords, dims)
    flat = jnp.where(row_valid & in_range, flat, size)  # park dropped rows in overflow slot
    n = keys.shape[0]
    table = jnp.full((size + 1,), jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    table = table.at[flat].min(jnp.arange(n, dtype=jnp.int32))
    table = jnp.where(table == jnp.iinfo(jnp.int32).max, -1, table)
    return table[:size]


def voxel_coords(points: jax.Array, origin: jax.Array, inv_leaf) -> jax.Array:
    """Integer voxel coords [N, 3] relative to `origin`, clamped into the packable range."""
    c = jnp.floor((points - origin) * inv_leaf).astype(jnp.int32)
    return jnp.clip(c, 0, jnp.array([_NX - 1, _NY - 1, _NZ - 1], dtype=jnp.int32))


def pack_key(coords: jax.Array) -> jax.Array:
    """Pack clamped coords [..., 3] into a single monotone non-negative int32 key."""
    return (
        (coords[..., 0] << (_BITS_Y + _BITS_Z))
        | (coords[..., 1] << _BITS_Z)
        | coords[..., 2]
    )


def min_corner(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Min corner over valid points (padded rows sit at +PAD_VALUE so plain min works),
    pulled back by one leaf so floor() never goes negative from fp rounding."""
    return jnp.min(jnp.where(mask[:, None], points, PAD_VALUE), axis=0)


@pytree_dataclass
class VoxelGrid:
    """Centroid-downsample result (pcl::VoxelGrid semantics: one centroid per occupied voxel)."""

    points: jax.Array      # [capacity, 3] centroids (padded with PAD_VALUE)
    mask: jax.Array        # [capacity] bool
    num_voxels: jax.Array  # scalar int32
    overflow: jax.Array    # scalar bool — True if > capacity voxels were occupied


@partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(points: jax.Array, mask: jax.Array, leaf: jax.Array, capacity: int) -> VoxelGrid:
    """Centroid-per-voxel downsample of a masked cloud into `capacity` output slots."""
    n = points.shape[0]
    origin = min_corner(points, mask) - leaf
    keys = pack_key(voxel_coords(points, origin, 1.0 / leaf))
    keys = jnp.where(mask, keys, INVALID_KEY)

    keys_sorted, px, py, pz = jax.lax.sort(
        (keys, points[:, 0], points[:, 1], points[:, 2]), num_keys=1
    )
    pts_sorted = jnp.stack([px, py, pz], axis=-1)
    valid_sorted = keys_sorted != INVALID_KEY

    first = jnp.concatenate(
        [valid_sorted[:1], (keys_sorted[1:] != keys_sorted[:-1]) & valid_sorted[1:]]
    )
    seg_id = jnp.cumsum(first.astype(jnp.int32)) - 1  # -1 for rows before the first segment
    seg_id = jnp.where(valid_sorted, seg_id, capacity)  # invalid rows dropped by segment_sum

    # Voxel-local accumulation (see build_ndt_map): centroid sums of raw world coordinates
    # lose precision once |x| >> leaf and become reassociation-sensitive; local offsets are
    # bounded by the leaf.
    row_coords = jnp.stack(unpack_key(jnp.where(valid_sorted, keys_sorted, 0)), axis=-1)
    row_corner = origin + row_coords.astype(points.dtype) * leaf
    sums = jax.ops.segment_sum(
        jnp.where(valid_sorted[:, None], pts_sorted - row_corner, 0.0), seg_id,
        num_segments=capacity + 1, indices_are_sorted=True,
    )[:capacity]
    counts = jax.ops.segment_sum(
        valid_sorted.astype(jnp.float32), seg_id, num_segments=capacity + 1,
        indices_are_sorted=True,
    )[:capacity]
    seg_keys = jax.ops.segment_max(
        jnp.where(valid_sorted, keys_sorted, jnp.int32(0)), seg_id, num_segments=capacity + 1,
        indices_are_sorted=True,
    )[:capacity]

    num_voxels = jnp.sum(first.astype(jnp.int32))
    out_mask = jnp.arange(capacity) < jnp.minimum(num_voxels, capacity)
    seg_corner = origin + jnp.stack(unpack_key(seg_keys), axis=-1).astype(points.dtype) * leaf
    centroids = seg_corner + sums / jnp.maximum(counts, 1.0)[:, None]
    return VoxelGrid(
        points=pad_points(centroids, out_mask),
        mask=out_mask,
        num_voxels=num_voxels,
        overflow=num_voxels > capacity,
    )


@pytree_dataclass
class NdtVoxelMap:
    """Sorted voxel-Gaussian map for NDT registration (ndt_omp's TargetGrid equivalent).

    `keys` is sorted ascending with INVALID_KEY padding, enabling `lookup()` via binary
    search. Covariance inverses are pre-regularized (ndt_omp inflates small eigenvalues to
    1e-2 of the largest so planar voxels stay well-conditioned) and pre-inverted.
    """

    keys: jax.Array        # [capacity] int32 sorted
    means: jax.Array       # [capacity, 3]
    inv_covs: jax.Array    # [capacity, 3, 3]
    valid: jax.Array       # [capacity] bool (occupied AND >= min_points)
    origin: jax.Array      # [3] min corner used for packing
    leaf: jax.Array        # scalar voxel resolution
    num_voxels: jax.Array  # scalar int32
    table: jax.Array       # [prod(TABLE_DIMS)] int32 dense cell -> voxel row (-1 empty)
    packed: jax.Array      # [capacity, 16] f32: mean(3) | inv_cov row-major(9) | valid | pad
                           # one contiguous row-gather feeds the whole align iteration
                           # (one index per neighbor instead of three)


def _eigh3x3(A: jax.Array):
    """Batched symmetric 3x3 eigendecomposition by fixed-sweep cyclic Jacobi,
    fully unrolled to ELEMENTWISE arithmetic on the 6 unique entries.

    Each Jacobi rotation is ~20 elementwise ops over the batch axis, which XLA fuses
    into one pass. Measured on an H100 at 700 W against `jnp.linalg.eigh` (cuSOLVER's
    batched solver): 0.11 vs 0.97 ms on 65,536 matrices, and 1.6-1.8 vs 1.9-2.1 ms for
    the whole keyframe `insert_and_rebuild` on a full 20 x 32,768 ring. 6 sweeps (18
    rotations) drive the off-diagonal mass to f32 roundoff (Jacobi converges
    quadratically; 3x3 needs 3-4 sweeps). Returns (w [..., 3] ascending, V [..., 3, 3]) with eigenvector
    COLUMNS, matching `jnp.linalg.eigh`'s convention.
    """
    dtype = A.dtype
    a = {
        (0, 0): A[..., 0, 0], (1, 1): A[..., 1, 1], (2, 2): A[..., 2, 2],
        (0, 1): A[..., 0, 1], (0, 2): A[..., 0, 2], (1, 2): A[..., 1, 2],
    }
    one = jnp.ones_like(a[(0, 0)])
    zero = jnp.zeros_like(one)
    # V stored column-major: v[j][i] = V[i, j] (column j = j-th eigenvector).
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def key(i, j):
        return (i, j) if i <= j else (j, i)

    for _ in range(6):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            app, aqq, apq = a[(p, p)], a[(q, q)], a[key(p, q)]
            nz = jnp.abs(apq) > 0
            tau = (aqq - app) / (2.0 * jnp.where(nz, apq, one))
            # Never-zero sign: tau == 0 (equal diagonal entries with nonzero coupling)
            # must produce the exact 45-degree rotation t = 1, not t = 0 — jnp.sign
            # would silently discard the off-diagonal mass there (symmetric/axis-
            # diagonal point arrangements hit this case routinely).
            sgn = jnp.where(tau >= 0, one, -one)
            t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
            t = jnp.where(nz, t, zero)
            c = 1.0 / jnp.sqrt(1.0 + t * t)
            s = t * c
            apr, aqr = a[key(p, r)], a[key(q, r)]
            a[(p, p)] = app - t * apq
            a[(q, q)] = aqq + t * apq
            a[key(p, q)] = zero
            a[key(p, r)] = c * apr - s * aqr
            a[key(q, r)] = s * apr + c * aqr
            vp, vq = v[p], v[q]
            v[p] = [c * vp[i] - s * vq[i] for i in range(3)]
            v[q] = [s * vp[i] + c * vq[i] for i in range(3)]

    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]
    # Ascending 3-sort network with paired column swaps — elementwise selects, no gathers.
    for (i, j) in ((0, 1), (1, 2), (0, 1)):
        swap = w[i] > w[j]
        w[i], w[j] = jnp.where(swap, w[j], w[i]), jnp.where(swap, w[i], w[j])
        vi, vj = v[i], v[j]
        v[i] = [jnp.where(swap, vj[k], vi[k]) for k in range(3)]
        v[j] = [jnp.where(swap, vi[k], vj[k]) for k in range(3)]
    W = jnp.stack(w, axis=-1)
    V = jnp.stack([jnp.stack(col, axis=-1) for col in v], axis=-1)  # [..., i, j]
    return W, V


def regularize_covariance(cov: jax.Array, min_eig_ratio: float = 1e-2):
    """Inflate small eigenvalues to `min_eig_ratio * lambda_max` (ndt_omp-style) and return
    (cov_reg, inv_cov_reg)."""
    w, V = _eigh3x3(cov)
    w_max = jnp.maximum(w[..., 2:3], 1e-9)
    w_reg = jnp.maximum(w, min_eig_ratio * w_max)
    cov_reg = (V * w_reg[..., None, :]) @ jnp.swapaxes(V, -1, -2)
    inv = (V * (1.0 / w_reg)[..., None, :]) @ jnp.swapaxes(V, -1, -2)
    return cov_reg, inv


def _sorted_voxel_stats(points, mask, resolution, capacity: int):
    """Per-voxel raw moments via one on-chip sort: (seg_keys, counts, sums, outer_sums,
    origin, num_voxels, occupied). Moments are accumulated in VOXEL-LOCAL coordinates
    (point minus its voxel's corner): in world coordinates E[x x^T] - mu mu^T cancels
    catastrophically in float32 once |x| >> leaf (KITTI scale |x| ~ 1e2-1e3 m vs
    covariances ~ 1e-2 m^2) and becomes sensitive to XLA's fusion/reassociation. Local
    coordinates bound every accumulated term by O(leaf^2)."""
    origin = min_corner(points, mask) - resolution
    keys = pack_key(voxel_coords(points, origin, 1.0 / resolution))
    keys = jnp.where(mask, keys, INVALID_KEY)

    keys_sorted, px, py, pz = jax.lax.sort(
        (keys, points[:, 0], points[:, 1], points[:, 2]), num_keys=1
    )
    pts_sorted = jnp.stack([px, py, pz], axis=-1)
    valid_sorted = keys_sorted != INVALID_KEY

    first = jnp.concatenate(
        [valid_sorted[:1], (keys_sorted[1:] != keys_sorted[:-1]) & valid_sorted[1:]]
    )
    seg_id = jnp.cumsum(first.astype(jnp.int32)) - 1
    seg_id = jnp.where(valid_sorted, seg_id, capacity)

    row_coords = jnp.stack(unpack_key(jnp.where(valid_sorted, keys_sorted, 0)), axis=-1)
    row_corner = origin + row_coords.astype(points.dtype) * resolution
    local_sorted = pts_sorted - row_corner
    loc_masked = jnp.where(valid_sorted[:, None], local_sorted, 0.0)
    sums = jax.ops.segment_sum(loc_masked, seg_id, num_segments=capacity + 1, indices_are_sorted=True)[:capacity]
    counts = jax.ops.segment_sum(valid_sorted.astype(jnp.float32), seg_id, num_segments=capacity + 1, indices_are_sorted=True)[:capacity]
    outer = loc_masked[:, :, None] * loc_masked[:, None, :]
    outer_sums = jax.ops.segment_sum(
        outer.reshape(-1, 9), seg_id, num_segments=capacity + 1, indices_are_sorted=True
    )[:capacity].reshape(capacity, 3, 3)
    seg_keys = jax.ops.segment_max(
        jnp.where(valid_sorted, keys_sorted, jnp.int32(0)), seg_id, num_segments=capacity + 1,
        indices_are_sorted=True,
    )[:capacity]

    num_voxels = jnp.sum(first.astype(jnp.int32))
    occupied = jnp.arange(capacity) < jnp.minimum(num_voxels, capacity)
    return seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied


def _finalize_ndt(
    seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied,
    resolution, capacity: int, min_points: int, dtype,
) -> NdtVoxelMap:
    """Raw per-voxel moments -> NdtVoxelMap (means, regularized inverse covariances,
    dense lookup table). ndt_omp requires >= `min_points` per voxel before trusting a
    Gaussian; sparser voxels are marked invalid and contribute nothing to the score."""
    cnt = jnp.maximum(counts, 1.0)[:, None]
    means_local = sums / cnt
    seg_corner = origin + jnp.stack(unpack_key(seg_keys), axis=-1).astype(dtype) * resolution
    means = seg_corner + means_local
    # Unbiased-ish sample covariance (ndt_omp divides by n-1); translation-invariant, so
    # local moments give it exactly.
    cov = (
        outer_sums - cnt[..., None] * means_local[:, :, None] * means_local[:, None, :]
    ) / jnp.maximum(counts - 1.0, 1.0)[:, None, None]
    valid = occupied & (counts >= min_points)
    # Only regularize valid voxels; others get identity to keep eigh well-posed.
    eye = jnp.broadcast_to(jnp.eye(3, dtype=cov.dtype), cov.shape)
    cov_safe = jnp.where(valid[:, None, None], cov, eye)
    _, inv_covs = regularize_covariance(cov_safe)

    keys_out = jnp.where(occupied, seg_keys, INVALID_KEY)
    means_out = pad_points(means, occupied)
    packed = jnp.zeros((capacity, 16), dtype=dtype)
    packed = packed.at[:, 0:3].set(means_out)
    packed = packed.at[:, 3:12].set(inv_covs.reshape(capacity, 9))
    packed = packed.at[:, 12].set(valid.astype(dtype))
    return NdtVoxelMap(
        keys=keys_out,
        means=means_out,
        inv_covs=inv_covs,
        valid=valid,
        origin=origin,
        leaf=jnp.asarray(resolution, dtype=dtype),
        num_voxels=num_voxels,
        table=build_dense_table(keys_out, valid, TABLE_DIMS),
        packed=packed,
    )


@partial(jax.jit, static_argnames=("capacity", "min_points"))
def build_ndt_map(
    points: jax.Array,
    mask: jax.Array,
    resolution: jax.Array,
    capacity: int,
    min_points: int = 6,
) -> NdtVoxelMap:
    """Build per-voxel Gaussians (mean + regularized inverse covariance) from a masked
    cloud (see `_sorted_voxel_stats` / `_finalize_ndt` for the numerics)."""
    seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied = _sorted_voxel_stats(
        points, mask, resolution, capacity
    )
    return _finalize_ndt(
        seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied,
        resolution, capacity, min_points, points.dtype,
    )


@partial(jax.jit, static_argnames=("capacity", "coarse_capacity", "factor", "min_points"))
def build_ndt_pyramid(
    points: jax.Array,
    mask: jax.Array,
    resolution: jax.Array,
    factor: int,
    capacity: int,
    coarse_capacity: int,
    min_points: int = 6,
):
    """Build (coarse, fine) NDT maps with ONE pass over the points.

    The fine map is exactly `build_ndt_map(points, mask, resolution, capacity)`. The
    coarse map (leaf = factor * resolution, same origin) is derived by MERGING the fine
    map's raw voxel moments — shifting each fine voxel's local moments by its corner
    offset inside the parent coarse voxel is exact, so no second 655k-point sort+reduce
    is paid (the merge sorts `capacity` stat rows instead; ~10x fewer). The coarse
    partition differs from an independent coarse build only by the origin convention
    (fine origin vs min-corner-minus-coarse-leaf) — a pure voxel-boundary shift."""
    dtype = points.dtype
    seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied = _sorted_voxel_stats(
        points, mask, resolution, capacity
    )
    fine = _finalize_ndt(
        seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied,
        resolution, capacity, min_points, dtype,
    )

    # Shift fine-local moments to coarse-local: x_c = x_f + o with o = (child corner -
    # parent corner); sum(x_c) = sum + n*o; sum(x_c x_c^T) = outer + o sum^T + sum o^T
    # + n o o^T. Exact in every entry.
    coords = jnp.stack(unpack_key(jnp.where(occupied, seg_keys, 0)), axis=-1)
    ccoords = coords // factor
    off = (coords - ccoords * factor).astype(dtype) * resolution          # [C, 3]
    live = occupied & (counts > 0)
    ckeys = jnp.where(live, pack_key(ccoords), INVALID_KEY)
    sums_c = sums + counts[:, None] * off
    outer_c = (
        outer_sums
        + off[:, :, None] * sums[:, None, :]
        + sums[:, :, None] * off[:, None, :]
        + counts[:, None, None] * off[:, :, None] * off[:, None, :]
    )

    # Merge stat rows by coarse key: sort 14 columns, then sorted segment reduce.
    cols = (ckeys, counts) + tuple(sums_c[:, i] for i in range(3)) + tuple(
        outer_c.reshape(capacity, 9)[:, i] for i in range(9)
    )
    sorted_cols = jax.lax.sort(cols, num_keys=1)
    ck_s = sorted_cols[0]
    cnt_s = sorted_cols[1]
    sum_s = jnp.stack(sorted_cols[2:5], axis=-1)
    out_s = jnp.stack(sorted_cols[5:14], axis=-1).reshape(capacity, 3, 3)
    valid_s = ck_s != INVALID_KEY
    first_c = jnp.concatenate([valid_s[:1], (ck_s[1:] != ck_s[:-1]) & valid_s[1:]])
    seg_c = jnp.cumsum(first_c.astype(jnp.int32)) - 1
    seg_c = jnp.where(valid_s, seg_c, coarse_capacity)
    csums = jax.ops.segment_sum(
        jnp.where(valid_s[:, None], sum_s, 0.0), seg_c,
        num_segments=coarse_capacity + 1, indices_are_sorted=True)[:coarse_capacity]
    ccounts = jax.ops.segment_sum(
        jnp.where(valid_s, cnt_s, 0.0), seg_c,
        num_segments=coarse_capacity + 1, indices_are_sorted=True)[:coarse_capacity]
    couters = jax.ops.segment_sum(
        jnp.where(valid_s[:, None], out_s.reshape(capacity, 9), 0.0), seg_c,
        num_segments=coarse_capacity + 1, indices_are_sorted=True,
    )[:coarse_capacity].reshape(coarse_capacity, 3, 3)
    cseg_keys = jax.ops.segment_max(
        jnp.where(valid_s, ck_s, jnp.int32(0)), seg_c,
        num_segments=coarse_capacity + 1, indices_are_sorted=True)[:coarse_capacity]
    cnum = jnp.sum(first_c.astype(jnp.int32))
    coccupied = jnp.arange(coarse_capacity) < jnp.minimum(cnum, coarse_capacity)
    coarse = _finalize_ndt(
        cseg_keys, ccounts, csums, couters, origin, cnum, coccupied,
        resolution * factor, coarse_capacity, min_points, dtype,
    )
    return coarse, fine


# DIRECT7 neighborhood: the voxel containing the point plus its 6 face-adjacent voxels
# (ndt_omp NeighborSearchMethod::DIRECT7, selected at `lidar_scan_matcher.cpp:69`).
DIRECT7_OFFSETS = jnp.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=jnp.int32,
)


def lookup_direct7(vmap: NdtVoxelMap, query_points: jax.Array):
    """For each query point, gather the DIRECT7 neighbor voxels' Gaussians.

    Returns (means [Q, 7, 3], inv_covs [Q, 7, 3, 3], found [Q, 7]). One dense-table gather
    per (query, neighbor) — no binary search on the registration hot loop.
    """
    q = query_points.shape[0]
    coords = voxel_coords(query_points, vmap.origin, 1.0 / vmap.leaf)  # [Q, 3]
    ncoords = coords[:, None, :] + DIRECT7_OFFSETS[None, :, :]         # [Q, 7, 3]
    flat, in_range = _flat_table_index(ncoords, TABLE_DIMS)
    idx = jnp.concatenate([vmap.table, jnp.full((1,), -1, jnp.int32)])[flat.reshape(-1)]
    hit = (idx >= 0) & in_range.reshape(-1)
    idx = jnp.maximum(idx, 0)
    # One contiguous row-gather for mean+inv_cov+valid.
    rows = vmap.packed[idx]                                            # [Q*7, 16]
    means = rows[:, 0:3].reshape(q, 7, 3)
    icovs = rows[:, 3:12].reshape(q, 7, 3, 3)
    hit = (hit & (rows[:, 12] > 0.5)).reshape(q, 7)
    return means, icovs, hit
