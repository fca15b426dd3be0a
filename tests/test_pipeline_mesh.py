"""Mesh-integrated pipeline: the distributed layer driving the LIVE SlamPipeline.

Round 2 shipped the Schur solve and batched registration as standalone verified
capabilities the pipeline never called. These tests prove the
integration: a `ParallelConfig(use_mesh=True)` pipeline routes the pose-graph solve
through the mesh-distributed LM and fans loop verification over the candidate batch —
and produces the same trajectory as the single-chip path on the 8-virtual-device CPU mesh.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.xdist_group("course90")

from lidar_graph_slam_tpu.core.config import (
    CapacityConfig,
    GraphSlamConfig,
    ParallelConfig,
    PipelineConfig,
    PrefilterConfig,
    ScanMatcherConfig,
)
from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence, make_loop_trajectory, make_world, simulate_scan
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline


def _pipe_config(use_mesh: bool, backend_solver: str = "schur") -> PipelineConfig:
    return PipelineConfig(
        prefilter=PrefilterConfig(leaf_size=0.3, mean_k=10),
        scan_matcher=ScanMatcherConfig(),
        graph_slam=GraphSlamConfig(loop_search_period_frames=5),
        capacity=CapacityConfig(
            raw_points=8192,
            filtered_points=4096,
            keyframe_points=4096,
            loop_submap_points=65536,
            max_keyframes=256,
            voxel_capacity=32768,
            max_loop_factors=16,
        ),
        parallel=ParallelConfig(use_mesh=use_mesh, backend_solver=backend_solver),
    )


@pytest.mark.slow
def test_mesh_pipeline_matches_single_chip(course90, course90_single_result):
    """The integrated mesh path (Schur-distributed solve + batched verification) must
    reproduce the single-chip trajectory on the same input stream. The single-chip run
    is the shared session fixture (same config as `_pipe_config(use_mesh=False)`)."""
    scans, _ = course90
    r_single = course90_single_result
    r_mesh = SlamPipeline(_pipe_config(use_mesh=True, backend_solver="schur")).run(scans)

    assert r_single.num_loop_closures >= 1
    assert r_mesh.num_loop_closures == r_single.num_loop_closures
    # Identical verification decisions. Fitness tolerance: attempts AFTER the first
    # accepted loop verify against submaps assembled under poses that differ by the
    # solvers' ~3 mm f32 floor, so their scores wobble at the 1e-4 level.
    for a, b in zip(r_single.loop_log, r_mesh.loop_log):
        assert a["candidate"] == b["candidate"]
        assert a["accepted"] == b["accepted"]
        assert abs(a["fitness"] - b["fitness"]) < 1e-3

    # Same optimized trajectory: both solvers run the same LM schedule to the f32 floor
    # of the same normal equations (Schur domain decomposition is algebraically exact).
    dt = np.linalg.norm(
        r_single.keyframe_poses[:, :3, 3] - r_mesh.keyframe_poses[:, :3, 3], axis=1
    )
    assert dt.max() < 0.02, f"mesh-vs-single translation divergence {dt.max():.4f} m"


def _multi_lap_backend(loop_topk: int, mesh=None):
    """Backend fed ground-truth keyframes along a 2.15-lap circle: the latest keyframe
    has TWO gated candidates (same spot on lap 1 and lap 2), a full lap apart."""
    cfg = GraphSlamConfig(
        accumulate_distance_threshold=80.0,
        search_for_candidate_threshold=15.0,
        search_key_frame_num=10,
        loop_topk=loop_topk,
    )
    cap = CapacityConfig(
        max_keyframes=128, max_loop_factors=8, keyframe_points=4096,
        loop_submap_points=65536, voxel_capacity=32768,
    )
    back = GraphBasedSLAM(cfg, cap, mesh=mesh)

    rng = np.random.default_rng(11)
    world = make_world(rng, extent=40.0, density=2.0)
    n_kf = 80
    traj = make_loop_trajectory(n_kf, radius=16.0, laps=2.15)  # ~100 m per lap
    accum = 0.0
    prev = traj[0]
    for k in range(n_kf):
        pose = traj[k]
        if k:
            accum += float(np.linalg.norm(pose[:3, 3] - prev[:3, 3]))
        prev = pose
        scan = simulate_scan(world, pose, rng, max_points=4096, noise=0.01)
        back.add_keyframe({
            "pose": pose.astype(np.float32),
            "cloud": scan,
            "cloud_mask": np.ones(scan.shape[0], bool),
            "accum_distance": accum,
        })
    return back


@pytest.mark.slow
def test_topk_verifies_and_accepts_multiple_candidates():
    """loop_topk=2 on a 2-lap course: one batched dispatch verifies both same-spot
    candidates and adds TWO loop factors — recall the reference's nearest-only detector
    (`graph_based_slam.cpp:264-280`) structurally cannot reach."""
    back = _multi_lap_backend(loop_topk=2)
    cands = back.detect_loop_topk(2)
    assert len(cands) == 2, f"expected two gated candidates, got {cands}"
    assert abs(cands[0] - cands[1]) >= back.cfg.search_key_frame_num

    assert back.try_close_loop()
    records = back.loop_log[-2:]
    assert {r["candidate"] for r in records} == set(cands)
    assert all(r["accepted"] for r in records), records
    assert back.n_loops == 2

    # Baseline: topk=1 verifies only the nearest — one factor from the same state.
    back1 = _multi_lap_backend(loop_topk=1)
    assert back1.try_close_loop()
    assert back1.n_loops == 1


@pytest.mark.slow
def test_topk_on_mesh_matches_unmeshed():
    """The same top-k attempt routed over the mesh (sharded batch when divisible,
    mesh-distributed re-solve always) reproduces the unmeshed decisions and poses."""
    from lidar_graph_slam_tpu.parallel.distributed import make_mesh

    back_plain = _multi_lap_backend(loop_topk=2)
    back_mesh = _multi_lap_backend(loop_topk=2, mesh=make_mesh(8))
    assert back_plain.try_close_loop()
    assert back_mesh.try_close_loop()
    assert back_mesh.n_loops == back_plain.n_loops == 2
    for a, b in zip(back_plain.loop_log, back_mesh.loop_log):
        assert a["candidate"] == b["candidate"] and a["accepted"] == b["accepted"]
        assert abs(a["fitness"] - b["fitness"]) < 1e-4
    dt = np.linalg.norm(
        back_plain.optimized_poses()[:, :3, 3] - back_mesh.optimized_poses()[:, :3, 3],
        axis=1,
    )
    assert dt.max() < 0.02


def test_shard_batch_lays_out_batch_over_mesh():
    """shard_batch: a mesh-divisible candidate batch lands sharded along the mesh axis,
    shared arrays replicated; non-divisible batches stay on the default device."""
    import jax
    import jax.numpy as jnp

    from lidar_graph_slam_tpu.parallel.distributed import make_mesh, shard_batch

    mesh = make_mesh(8)
    batched = (jnp.zeros((8, 16, 3)), jnp.zeros((8,)))
    shared = (jnp.zeros((16, 3)),)
    b, s = shard_batch(mesh, batched, shared)
    assert len(b[0].sharding.device_set) == 8
    assert len(s[0].sharding.device_set) == 8  # replicated over all devices
    # Replicated = whole array on each device.
    assert s[0].sharding.shard_shape(s[0].shape) == s[0].shape
    # Sharded = batch split.
    assert b[0].sharding.shard_shape(b[0].shape)[0] == 1

    b2, _ = shard_batch(mesh, (jnp.zeros((3, 4)),), shared)
    assert len(b2[0].sharding.device_set) == 1  # 3 % 8 != 0 -> left alone
