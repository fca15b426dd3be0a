"""Grid-hash nearest-neighbor search — the engine's replacement for kd-trees.

The reference leans on pointer-chasing trees everywhere: FLANN kd-trees inside PCL ICP/GICP
correspondence search, fast_gicp's kd-tree k=20 covariance neighborhoods
(`lidar_scan_matcher/src/lidar_scan_matcher.cpp:43,48`), `pcl::KdTreeFLANN::radiusSearch` in
the dormant loop detector (`graph_based_slam/src/graph_based_slam.cpp:198-206`), and a
hand-rolled recursive KDTree (`lidar_graph_slam_utils/lib/kd_tree.hpp:48-139`). Trees are
hostile to wide data-parallel hardware (irregular control flow, scalar pointer chasing), so
this module uses a
sorted uniform grid instead:

  build:  key each point by its cell, sort once (on-chip XLA sort).
  query:  for each query, binary-search the 27 (or 7) neighbor-cell keys and gather a
          bounded bucket of consecutive points per cell — pure vectorized gathers —
          then reduce with `top_k`.

Queries only see neighbors within one cell ring, i.e. a radius of `cell_size` is guaranteed
and up to 2*cell_size diagonal; callers pick `cell_size` >= their correspondence radius.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core.pointcloud import PAD_VALUE, pad_points
from lidar_graph_slam_tpu.core.struct import pytree_dataclass
from lidar_graph_slam_tpu.ops.voxel import (
    INVALID_KEY,
    TABLE_DIMS,
    _NX,
    _NY,
    _NZ,
    _flat_table_index,
    build_dense_table,
    min_corner,
    pack_key,
    voxel_coords,
)

_27_OFFSETS = jnp.stack(
    jnp.meshgrid(
        jnp.arange(-1, 2, dtype=jnp.int32),
        jnp.arange(-1, 2, dtype=jnp.int32),
        jnp.arange(-1, 2, dtype=jnp.int32),
        indexing="ij",
    ),
    axis=-1,
).reshape(27, 3)


@pytree_dataclass
class HashGrid:
    """Points sorted by packed cell key; cells resolved by dense-table lookup at query time."""

    keys: jax.Array       # [N] int32, ascending, INVALID_KEY padding
    points: jax.Array     # [N, 3] sorted to match keys
    packed: jax.Array     # [N, 4] f32: x, y, z, key bitcast to f32 — one-row candidate gather
    order: jax.Array      # [N] int32 original row index of each sorted row
    starts: jax.Array     # [N] int32: for each row, index of the first row of its cell
    origin: jax.Array     # [3]
    cell_size: jax.Array  # scalar
    num: jax.Array        # scalar int32 valid count
    table: jax.Array      # [prod(TABLE_DIMS)] int32 dense cell -> first sorted row (-1)


@jax.jit
def build_hash_grid(points: jax.Array, mask: jax.Array, cell_size) -> HashGrid:
    cell_size = jnp.asarray(cell_size, dtype=points.dtype)
    origin = min_corner(points, mask) - cell_size
    keys = pack_key(voxel_coords(points, origin, 1.0 / cell_size))
    keys = jnp.where(mask, keys, INVALID_KEY)
    n = keys.shape[0]
    keys_sorted, px, py, pz, order = jax.lax.sort(
        (keys, points[:, 0], points[:, 1], points[:, 2], jnp.arange(n, dtype=jnp.int32)),
        num_keys=1,
    )
    pts_sorted = jnp.stack([px, py, pz], axis=-1)
    valid = keys_sorted != INVALID_KEY
    pts_sorted = pad_points(pts_sorted, valid)
    first = jnp.concatenate([jnp.ones((1,), bool), keys_sorted[1:] != keys_sorted[:-1]])
    idx = jnp.arange(n, dtype=jnp.int32)
    # starts[i] = index of first row sharing keys_sorted[i]'s cell (running max of firsts).
    starts = jax.lax.associative_scan(jnp.maximum, jnp.where(first, idx, 0))
    packed = jnp.concatenate(
        [pts_sorted, jax.lax.bitcast_convert_type(keys_sorted, jnp.float32)[:, None]],
        axis=1,
    )
    return HashGrid(
        keys=keys_sorted,
        points=pts_sorted,
        packed=packed,
        order=order,
        starts=starts,
        origin=origin,
        cell_size=cell_size,
        num=jnp.sum(mask.astype(jnp.int32)),
        table=build_dense_table(keys_sorted, first & valid, TABLE_DIMS),
    )


def _candidate_scan(grid: HashGrid, queries: jax.Array, offsets: jax.Array, bucket_cap: int):
    """Candidate squared-distances and flat indices for every (query, cell, slot).

    Returns (d2 [Q, C*B] with +inf for invalid, cand_idx [Q, C*B] row indices).

    Everything a candidate needs (x, y, z, cell key) is packed into one 4-float row and
    fetched with a single flat gather: one index per candidate instead of four.
    """
    n = grid.keys.shape[0]
    q = queries.shape[0]
    C = offsets.shape[0]
    coords = voxel_coords(queries, grid.origin, 1.0 / grid.cell_size)       # [Q, 3]
    ncoords = coords[:, None, :] + offsets[None, :, :]                       # [Q, C, 3]
    cell_keys = pack_key(
        jnp.clip(ncoords, 0, jnp.array([_NX - 1, _NY - 1, _NZ - 1], dtype=jnp.int32))
    )                                                                        # [Q, C]
    flat, in_range = _flat_table_index(ncoords, TABLE_DIMS)
    start = jnp.concatenate([grid.table, jnp.full((1,), -1, jnp.int32)])[flat.reshape(-1)]
    cell_hit = (start >= 0) & in_range.reshape(-1)
    start = jnp.clip(start, 0, n - bucket_cap)                               # [Q*C]

    cand_idx = (start[:, None] + jnp.arange(bucket_cap, dtype=jnp.int32)).reshape(-1)
    rows = grid.packed[cand_idx]                                             # [Q*C*B, 4]
    keys_run = jax.lax.bitcast_convert_type(rows[:, 3], jnp.int32).reshape(q, C, bucket_cap)
    same_cell = (keys_run == cell_keys[..., None]) & cell_hit.reshape(q, C)[..., None]
    qc = queries[:, None, None, :]                                           # [Q,1,1,3]
    diff = rows[:, :3].reshape(q, C, bucket_cap, 3) - qc
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(same_cell, d2, jnp.inf)
    return d2.reshape(q, -1), cand_idx.reshape(q, -1)


_7_OFFSETS = jnp.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=jnp.int32,
)


def _offsets_for(neighborhood: int) -> jax.Array:
    if neighborhood == 27:
        return _27_OFFSETS
    if neighborhood == 7:
        return _7_OFFSETS
    raise ValueError(f"neighborhood must be 7 or 27, got {neighborhood}")


@partial(jax.jit, static_argnames=("k", "bucket_cap", "neighborhood"))
def knn(grid: HashGrid, queries: jax.Array, k: int, bucket_cap: int = 32,
        neighborhood: int = 27):
    """k nearest neighbors within the neighborhood cells of each query.

    Returns (idx [Q, k] into grid.points, dist2 [Q, k], valid [Q, k]). Padded query rows
    (at PAD_VALUE) return all-invalid results naturally. Selection is a two-operand lane
    sort over the candidate axis.
    """
    d2, cand_idx = _candidate_scan(grid, queries, _offsets_for(neighborhood), bucket_cap)
    d2_sorted, idx_sorted = jax.lax.sort((d2, cand_idx), num_keys=1, dimension=1)
    top_d2 = d2_sorted[:, :k]
    idx = idx_sorted[:, :k]
    return idx, top_d2, jnp.isfinite(top_d2)


@partial(jax.jit, static_argnames=("bucket_cap", "neighborhood"))
def nearest(grid: HashGrid, queries: jax.Array, bucket_cap: int = 32, neighborhood: int = 27):
    """Single nearest neighbor within one cell ring: (idx [Q], dist2 [Q], found [Q])."""
    d2, cand_idx = _candidate_scan(grid, queries, _offsets_for(neighborhood), bucket_cap)
    j = jnp.argmin(d2, axis=1)
    best = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
    idx = jnp.take_along_axis(cand_idx, j[:, None], axis=1)[:, 0]
    return idx, best, jnp.isfinite(best)


# --- same-cloud neighborhoods without gathers -------------------------------------------


def window_neighbor_d2(grid: HashGrid, window: int):
    """Squared distances from every sorted row to its +-window sorted neighbors, masked to
    same-cell pairs: [N, 2*window], +inf where invalid. Pure shifts — zero gathers.

    Points of one cell are consecutive after the sort, so a sliding window over the sorted
    order covers the intra-cell neighborhood exactly (up to window truncation in very dense
    cells); this is the engine's O(N) replacement for same-cloud kNN queries (SOR, GICP
    covariances) where the 27-cell gather path would pay ~Q*27*B gather indices.
    """
    comps = [grid.points[:, c] for c in range(3)]
    keys = grid.keys
    cols = []
    for s in range(1, window + 1):
        for shift in (s, -s):
            kb = jnp.roll(keys, shift)
            same = (kb == keys) & (keys != INVALID_KEY)
            d2 = sum((jnp.roll(comp, shift) - comp) ** 2 for comp in comps)
            cols.append(jnp.where(same, d2, jnp.inf))
    return jnp.stack(cols, axis=1)


def window_mean_knn_distance(grid: HashGrid, k: int, window: int = 24):
    """Per sorted row: mean distance to its k nearest window neighbors and the neighbor
    count: (mean_d [N], n_found [N])."""
    d2 = window_neighbor_d2(grid, window)
    d2_sorted = jax.lax.sort(d2, dimension=1)
    dk = jnp.sqrt(jnp.where(jnp.isfinite(d2_sorted[:, :k]), d2_sorted[:, :k], 0.0))
    found = jnp.isfinite(d2_sorted[:, :k])
    n_found = jnp.sum(found, axis=1)
    mean_d = jnp.sum(dk, axis=1) / jnp.maximum(n_found, 1)
    return mean_d, n_found


def window_covariances(grid: HashGrid, window: int = 16):
    """Per sorted row: mean/covariance over its same-cell window neighborhood (self
    included): (mu [N, 3], cov [N, 3, 3], count [N]). Zero gathers."""
    comps = [grid.points[:, c] for c in range(3)]
    n = grid.keys.shape[0]
    keys = grid.keys
    valid_self = keys != INVALID_KEY
    cnt = valid_self.astype(grid.points.dtype)
    s1 = [jnp.where(valid_self, c, 0.0) for c in comps]
    s2 = [[jnp.where(valid_self, comps[i] * comps[j], 0.0) for j in range(3)] for i in range(3)]
    for s in range(1, window + 1):
        for shift in (s, -s):
            kb = jnp.roll(keys, shift)
            w = ((kb == keys) & valid_self).astype(grid.points.dtype)
            shifted = [jnp.roll(c, shift) for c in comps]
            cnt = cnt + w
            for i in range(3):
                s1[i] = s1[i] + w * shifted[i]
                for j in range(i, 3):
                    s2[i][j] = s2[i][j] + w * shifted[i] * shifted[j]
    denom = jnp.maximum(cnt, 1.0)
    mu = jnp.stack([s1[i] / denom for i in range(3)], axis=-1)
    cov = jnp.zeros((n, 3, 3), grid.points.dtype)
    for i in range(3):
        for j in range(i, 3):
            cij = s2[i][j] / denom - mu[:, i] * mu[:, j]
            cov = cov.at[:, i, j].set(cij)
            if i != j:
                cov = cov.at[:, j, i].set(cij)
    return mu, cov, cnt


def radius_mask(positions: jax.Array, mask: jax.Array, query: jax.Array, radius) -> jax.Array:
    """Dense radius search over a small point set (keyframe positions, <= O(10^4)): the
    data-parallel stand-in for `pcl::KdTreeFLANN::radiusSearch` on keyframe centers
    (`graph_based_slam.cpp:198-206`). Plain vectorized distances beat any tree here."""
    d2 = jnp.sum((positions - query[None, :]) ** 2, axis=-1)
    return mask & (d2 < radius * radius)
