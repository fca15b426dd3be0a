"""Multi-host scaffolding: process initialization, host-spanning meshes, and a
host-sharded keyframe store.

This is the engine's replacement for the reference's multi-process DDS middleware
(SURVEY.md §5.8): where ROS 2 wires three OS processes with QoS'd pub/sub topics
(`lidar_scan_matcher/src/lidar_scan_matcher.cpp:102-106`, transient-local map topics,
`graph_based_slam/src/graph_based_slam.cpp:45-46`), a multi-host deployment of this
engine is N identical SPMD processes:

  * `initialize_from_env()` — `jax.distributed.initialize` from `LGS_*` environment
    variables; after it, `jax.devices()` spans every host and collectives ride the
    device interconnect within a host and the network across hosts.
  * `make_global_mesh()` — one mesh over all global devices; every mesh-parallel
    component in this package (`parallel/schur.py`, `parallel/distributed.py`,
    `GraphBasedSLAM(mesh=...)`) runs on it unchanged — the BASELINE.json configs[4]
    ("city-scale merged map, N>=2 hosts, submap-partitioned graph, Schur reduction")
    code path.
  * `HostShardedKeyframeStore` — keyframe CLOUDS partitioned round-robin across hosts
    (the big payload stays host-local, like the reference's per-node
    `key_frame_array_` copies, `graph_based_slam.hpp:122-123`); poses/metadata are
    tiny and replicate. Cross-host submap assembly is one padded `process_allgather`
    at the cross-host boundary — the only bulk cross-host transfer in the design.

Exercised without hardware by tests/test_multihost.py: two local processes, two virtual
CPU devices each, Gloo collectives — the same code path a multi-host deployment takes.
Not yet run across hosts with accelerators (ROADMAP).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize `jax.distributed` from args or `LGS_COORDINATOR` / `LGS_NUM_PROCESSES`
    / `LGS_PROCESS_ID` env vars. Returns True when multi-process mode was initialized,
    False for single-process operation (no/one process configured). Call before any
    JAX computation, once per process."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("LGS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LGS_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("LGS_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if not coordinator_address or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("LGS_PROCESS_ID required when LGS_NUM_PROCESSES > 1")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_global_mesh(axis: str = "scan"):
    """A 1-D mesh over ALL global devices (every process's chips). With
    `initialize_from_env` done, collectives on this mesh cross host boundaries."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def replicate_to_mesh(tree, mesh):
    """Turn identical process-local values into fully-replicated GLOBAL arrays on the
    mesh — the hand-off that lets single-host state (e.g. a `PoseGraph`) enter a
    host-spanning computation. Every process must pass the same values (SPMD)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P())

    def conv(x):
        xnp = np.asarray(x)
        return jax.make_array_from_callback(xnp.shape, sh, lambda idx: xnp[idx])

    return jax.tree.map(conv, tree)


def fetch_replicated(x, mesh) -> np.ndarray:
    """Read a global array back to host numpy on every process (all-gather if it was
    sharded). The host-side mirror refresh of `GraphBasedSLAM` at the cross-host boundary."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep.addressable_data(0))


class HostShardedKeyframeStore:
    """Keyframe clouds partitioned by host; poses replicated.

    Ownership is round-robin over process ids (balances a live keyframe stream without
    coordination). Every process calls `add` for every keyframe — non-owners record
    only the metadata. `assemble_submap` returns the map-frame concat of a keyframe
    range, fetching remote clouds via one padded `process_allgather` (cross-host boundary);
    in single-process mode it degrades to a plain local concat.
    """

    def __init__(self, pad_points: int = 16384,
                 process_id: Optional[int] = None, num_processes: Optional[int] = None):
        import jax

        self.pad_points = pad_points
        self.pid = jax.process_index() if process_id is None else process_id
        self.n_proc = jax.process_count() if num_processes is None else num_processes
        self._clouds: dict[int, np.ndarray] = {}  # only the keyframes this host owns
        self.n_keyframes = 0

    def owner(self, k: int) -> int:
        return k % self.n_proc

    def owns(self, k: int) -> bool:
        return self.owner(k) == self.pid

    def add(self, k: int, cloud: Optional[np.ndarray]) -> None:
        """Register keyframe k; stores the cloud only on the owning host. Non-owners may
        pass None (the cloud need not even cross the wire to them)."""
        if self.owns(k):
            if cloud is None:
                raise ValueError(f"process {self.pid} owns keyframe {k}: cloud required")
            self._clouds[k] = np.asarray(cloud, dtype=np.float32)
        self.n_keyframes = max(self.n_keyframes, k + 1)

    def local_ids(self) -> list:
        return sorted(self._clouds)

    def get_cloud(self, k: int) -> np.ndarray:
        """Fetch keyframe k's raw (sensor/base-frame) cloud on EVERY host — one padded
        allgather (SPMD: all hosts must call together). The back end uses this for the
        latest-keyframe cloud in loop verification (`graph_based_slam.cpp:246-252`)."""
        poses = np.tile(np.eye(4, dtype=np.float32)[None], (k + 1, 1, 1))
        return self.assemble_submap(k, k + 1, poses)

    def assemble_submap(self, lo: int, hi: int, poses: np.ndarray) -> np.ndarray:
        """Map-frame concat of keyframes [lo, hi) under `poses` [K, 4, 4] (replicated).

        Each host transforms the clouds it owns; one tiny count allgather sizes the
        padded block to the window's LARGEST cloud (capped at `pad_points`), then one
        block allgather merges — every host receives the identical full submap (SPMD:
        all hosts must call this together; reference's candidate-submap build
        `graph_based_slam.cpp:297-309`)."""
        ids = list(range(lo, hi))
        transformed = {}
        local_count = np.zeros((len(ids),), np.int32)
        for row, k in enumerate(ids):
            if self.owns(k) and k in self._clouds:
                T = poses[k]
                pts = self._clouds[k] @ T[:3, :3].T + T[:3, 3]
                transformed[row] = pts[: self.pad_points]
                local_count[row] = transformed[row].shape[0]
        if self.n_proc <= 1:
            counts = local_count[None]
            pad_to = int(local_count.max()) if len(ids) else 0
        else:
            from jax.experimental import multihost_utils

            # Two-phase gather (a fixed [n, pad_points, 3] block per
            # host shipped ~8 MB x n_hosts per loop attempt regardless of occupancy):
            # first the tiny count vector, then blocks padded only to the WINDOW MAX —
            # cross-host bytes now track the actual clouds.
            counts = np.asarray(multihost_utils.process_allgather(local_count))
            pad_to = int(counts.max()) if counts.size else 0
        local_block = np.zeros((len(ids), max(pad_to, 1), 3), np.float32)
        for row, pts in transformed.items():
            local_block[row, : pts.shape[0]] = pts
        if self.n_proc <= 1:
            blocks = local_block[None]
        else:
            from jax.experimental import multihost_utils

            blocks = np.asarray(multihost_utils.process_allgather(local_block))
        chunks = []
        for row, k in enumerate(ids):
            p = self.owner(k)
            n = int(counts[p, row])
            if n:
                chunks.append(blocks[p, row, :n])
        if not chunks:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(chunks).astype(np.float32)
