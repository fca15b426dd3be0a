"""Worker process for tests/test_multihost.py — runs the multi-host code path for real:
2 processes x 2 virtual CPU devices, Gloo collectives, one global 4-device mesh.

Run: python multihost_worker.py <port> <process_id>
Prints MULTIHOST_OK as the last line on success (asserted by the parent test).
"""

import os
import sys

port, pid = sys.argv[1], int(sys.argv[2])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["LGS_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["LGS_NUM_PROCESSES"] = "2"
os.environ["LGS_PROCESS_ID"] = str(pid)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lidar_graph_slam_tpu.parallel import multihost  # noqa: E402

# 1) Process initialization from env (the jax.distributed entry the DDS layer maps to).
assert multihost.initialize_from_env(), "expected multi-process initialization"
assert jax.process_count() == 2
assert len(jax.local_devices()) == 2

# 2) Host-spanning mesh.
mesh = multihost.make_global_mesh()
assert mesh.devices.size == 4, mesh

import jax.numpy as jnp  # noqa: E402

from lidar_graph_slam_tpu.core import se3  # noqa: E402
from lidar_graph_slam_tpu.graph import solver  # noqa: E402
from lidar_graph_slam_tpu.parallel.distributed import distributed_graph_step  # noqa: E402
from lidar_graph_slam_tpu.parallel.schur import schur_graph_step  # noqa: E402

# 3) Host-sharded keyframe store: clouds partitioned round-robin, submap assembly via
#    one padded process_allgather — both processes must reconstruct the SAME submap.
store = multihost.HostShardedKeyframeStore(pad_points=64)
rng = np.random.default_rng(0)  # same seed everywhere: deterministic fixture
clouds = [rng.normal(size=(32, 3)).astype(np.float32) for _ in range(6)]
poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
for k in range(6):
    poses[k, 0, 3] = float(k)
    store.add(k, clouds[k] if store.owns(k) else None)
assert sorted(store.local_ids()) == [k for k in range(6) if k % 2 == pid]
submap = store.assemble_submap(0, 6, poses)
expected = np.concatenate([clouds[k] + np.array([k, 0.0, 0.0], np.float32) for k in range(6)])
assert submap.shape == expected.shape, (submap.shape, expected.shape)
assert np.allclose(submap, expected, atol=1e-6), "cross-host submap mismatch"

# 4) Distributed pose-graph solve ACROSS PROCESS BOUNDARIES: psum-chain step and the
#    Schur domain-decomposed step on the global mesh, vs the local single-chip step.
K = 16
g = solver.init_graph(K, 2, (1e-4,) * 6)
T = np.eye(4, dtype=np.float32)
g = solver.graph_add_keyframe(g, jnp.asarray(T), jnp.eye(4))
for i in range(K - 1):
    xi = np.concatenate([rng.normal(size=3) * 0.01, [1.0, 0, 0]]).astype(np.float32)
    meas = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    T = T @ meas
    g = solver.graph_add_keyframe(g, jnp.asarray(T), jnp.asarray(meas))
g = solver.graph_add_loop(
    g, jnp.asarray(0), jnp.asarray(K - 1), jnp.eye(4), jnp.full((6,), 1e4, jnp.float32)
)

damping = jnp.asarray(1e-4, jnp.float32)
delta = solver._solve_step(g, g.poses, damping)
local_step = np.asarray(g.poses @ se3.se3_exp(delta))

g_rep = multihost.replicate_to_mesh(g, mesh)
chain_poses = multihost.fetch_replicated(distributed_graph_step(mesh, g_rep, 1e-4), mesh)
err_chain = np.abs(chain_poses - local_step).max()
assert err_chain < 1e-4, f"chain step diverged across hosts: {err_chain}"

schur_poses = multihost.fetch_replicated(schur_graph_step(mesh, g_rep, 1e-4), mesh)
err_schur = np.abs(schur_poses - local_step).max()
assert err_schur < 1e-2, f"schur step diverged across hosts: {err_schur}"

print(f"proc {pid}: chain_err={err_chain:.2e} schur_err={err_schur:.2e}", flush=True)
print("MULTIHOST_OK", flush=True)

# 5) FULL SlamPipeline SPMD with the sharded keyframe store:
#    every process feeds the same scan stream; keyframe clouds shard round-robin per
#    host; loop closure + map assembly cross the process boundary via the store's
#    allgather. The trajectory must match a local-store (single-host) run exactly.
from lidar_graph_slam_tpu.core.config import (  # noqa: E402
    CapacityConfig, GraphSlamConfig, PipelineConfig, PrefilterConfig,
)
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline  # noqa: E402

cfg = PipelineConfig(
    prefilter=PrefilterConfig(leaf_size=0.3, mean_k=10),
    graph_slam=GraphSlamConfig(loop_search_period_frames=5),
    capacity=CapacityConfig(
        raw_points=8192, filtered_points=4096, keyframe_points=4096,
        loop_submap_points=65536, max_keyframes=256, voxel_capacity=32768,
        max_loop_factors=16,
    ),
)
# ~2.3 m / ~4.7 deg per frame: inside the tracker basin (radius 12 at
# 11 deg/frame diverged the odometry and no loop ever fired).
seq = SyntheticSequence(n_frames=75, seed=3, max_points=4096, radius=25.0, laps=1.12)
scans = [s for s, _ in seq]

pipe_sh = SlamPipeline(cfg)
assert pipe_sh.back.cloud_store is not None, "multi-process run must auto-shard clouds"
for s in scans:
    pipe_sh.process_scan(s)
res_sh = pipe_sh.result()
own = len(pipe_sh.back.cloud_store.local_ids())
total = pipe_sh.back.n_keyframes
assert 0 < own < total, f"clouds not actually sharded: {own}/{total}"
map_sh = pipe_sh.back.assemble_map(0.5)  # collective: all processes participate
print(f"proc {pid}: sharded pipeline kf={total} own={own} "
      f"loops={res_sh.num_loop_closures} map={map_sh.shape}", flush=True)

if pid == 0:
    # Local-store reference run (no collectives — safe to run on one process only).
    pipe_lo = SlamPipeline(cfg)
    pipe_lo.back.cloud_store = None
    for s in scans:
        pipe_lo.process_scan(s)
    res_lo = pipe_lo.result()
    assert res_sh.keyframe_poses.shape == res_lo.keyframe_poses.shape
    traj_err = np.abs(res_sh.keyframe_poses - res_lo.keyframe_poses).max()
    assert traj_err < 1e-4, f"sharded-store trajectory diverged: {traj_err}"
    assert res_sh.num_loop_closures == res_lo.num_loop_closures >= 1
    map_lo = pipe_lo.back.assemble_map(0.5)
    assert map_sh.shape == map_lo.shape
    print(f"proc 0: sharded == local (traj_err={traj_err:.2e}, "
          f"loops={res_sh.num_loop_closures})", flush=True)

print("MULTIHOST_PIPELINE_OK", flush=True)
