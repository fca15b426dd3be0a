"""Fixed-capacity masked point cloud — the engine's wire format.

The reference moves `sensor_msgs/PointCloud2` blobs between processes over DDS and into
`pcl::PointCloud<pcl::PointXYZ>` (e.g. `points_prefiltering/src/points_prefiltering.cpp:65-87`).
On the device every per-frame array has a static shape so XLA compiles each pipeline stage
exactly once; a scan is therefore a `[capacity, 3]` float32 array plus a `[capacity]` validity
mask. Invalid rows are parked far away (PAD_VALUE) so distance-based kernels (NN search, NDT
voxel lookup) naturally ignore them even before masking.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lidar_graph_slam_tpu.core.struct import pytree_dataclass

# Padding sentinel: far outside any realistic LiDAR range so padded rows never win a
# nearest-neighbor query nor land in a real voxel.
PAD_VALUE = 1.0e6


@pytree_dataclass
class PointCloud:
    """SoA masked cloud. `points[i]` valid iff `mask[i]`."""

    points: jax.Array  # [capacity, 3] float32
    mask: jax.Array    # [capacity] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jax.Array:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    @classmethod
    def from_array(cls, xyz, capacity: Optional[int] = None) -> "PointCloud":
        """Build from a host-side [n, 3] array, padding/truncating to `capacity`."""
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            xyz = xyz[:cap]
            n = cap
        pts = np.full((cap, 3), PAD_VALUE, dtype=np.float32)
        pts[:n] = xyz
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        return cls(points=jnp.asarray(pts), mask=jnp.asarray(mask))

    def to_array(self) -> np.ndarray:
        """Host-side [n_valid, 3] array (drops padding)."""
        pts = np.asarray(self.points)
        mask = np.asarray(self.mask)
        return pts[mask]


def pad_points(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Park invalid rows at PAD_VALUE (keeps NN/voxel kernels mask-oblivious)."""
    return jnp.where(mask[:, None], points, jnp.full_like(points, PAD_VALUE))


def compact(points: jax.Array, mask: jax.Array, capacity: int) -> tuple[jax.Array, jax.Array]:
    """Stable-compact valid rows to the front, emitting fixed `capacity` rows.

    Replaces dynamic-size `pcl` filter outputs: a filter marks rows invalid, then compaction
    produces the next stage's fixed-shape input. Implemented as a stable argsort on the
    inverted mask (valid-first), which XLA lowers to an efficient on-chip sort.
    """
    order = jnp.argsort(jnp.logical_not(mask), stable=True)
    order = order[:capacity]
    new_mask = mask[order]
    new_points = pad_points(points[order], new_mask)
    return new_points, new_mask


def compact_evenly(points: jax.Array, mask: jax.Array,
                   capacity: int) -> tuple[jax.Array, jax.Array]:
    """`compact`, except that when more than `capacity` rows are valid it keeps
    `capacity` of them evenly spaced over the valid rows' order, not the first
    `capacity`. Filter outputs come in voxel-key order, whose head is one spatial slab of
    the scan; thinning across the whole order keeps the scan's full extent."""
    if capacity >= points.shape[0]:
        return compact(points, mask, capacity)
    order = jnp.argsort(jnp.logical_not(mask), stable=True)
    n = jnp.sum(mask.astype(jnp.int32))
    j = jnp.arange(capacity, dtype=jnp.int32)
    # pick_j = floor(j * n / capacity) without the int32 overflow of j * n: the whole
    # part q * j is exact, and float32 rounding of the monotone fractional part can
    # never make two picks equal, since each step adds at least q >= 1.
    q, rem = n // capacity, n % capacity
    frac = jnp.floor(j.astype(jnp.float32) * (rem.astype(jnp.float32) / capacity))
    pick = jnp.where(n > capacity, j * q + frac.astype(jnp.int32), j)
    rows = order[pick]
    new_mask = mask[rows]
    return pad_points(points[rows], new_mask), new_mask
