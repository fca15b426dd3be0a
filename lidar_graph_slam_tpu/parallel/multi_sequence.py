"""Batched multi-sequence odometry: whole scan streams as one device program.

BASELINE.json configs[3] ("multi-sequence batch: sharded keyframes, distributed BA on
1 host") needs odometry over several sequences at once. The host-driven `ScanMatcher`
pays a host round trip per frame; here the *entire* front end — align, keyframe trigger,
submap-ring update, NDT map rebuild — runs as `lax.scan` over frames with a leading batch
axis vmapped over sequences and sharded across the device mesh. Zero host syncs per frame:
the data-parallel answer to "run the front end on 4 KITTI sequences at once".

Data-dependent keyframing becomes masked state updates (SURVEY.md §7 "hard parts"): every
frame computes the would-be ring insert and applies it behind the displacement trigger.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.core.config import ScanMatcherConfig
from lidar_graph_slam_tpu.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu.core.struct import pytree_dataclass
from lidar_graph_slam_tpu.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu.registration.ndt import ndt_align


@pytree_dataclass
class BatchFrontState:
    pose: jax.Array          # [4, 4]
    last_motion: jax.Array   # [4, 4]
    last_kf_pos: jax.Array   # [3]
    accum_dist: jax.Array    # []
    kf_count: jax.Array      # [] int32
    ring_clouds: jax.Array   # [W, N, 3] sensor-frame keyframe clouds
    ring_masks: jax.Array    # [W, N]
    ring_poses: jax.Array    # [W, 4, 4]
    ring_used: jax.Array     # [W]


def _init_state(window: int, n: int) -> BatchFrontState:
    return BatchFrontState(
        pose=jnp.eye(4, dtype=jnp.float32),
        last_motion=jnp.eye(4, dtype=jnp.float32),
        last_kf_pos=jnp.zeros(3, jnp.float32),
        accum_dist=jnp.zeros((), jnp.float32),
        kf_count=jnp.zeros((), jnp.int32),
        ring_clouds=jnp.full((window, n, 3), PAD_VALUE, jnp.float32),
        ring_masks=jnp.zeros((window, n), bool),
        ring_poses=jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (window, 1, 1)),
        ring_used=jnp.zeros((window,), bool),
    )


def _step(state: BatchFrontState, scan, scan_mask, cfg: ScanMatcherConfig, map_capacity: int):
    """One front-end frame for one sequence (vmapped over the batch axis by the caller)."""
    window, n = state.ring_clouds.shape[:2]

    # Target submap from the current ring (identical content to a rebuild-on-keyframe
    # cache: the ring only changes on inserts).
    world = se3.transform_points(state.ring_poses, state.ring_clouds)
    m = state.ring_masks & state.ring_used[:, None]
    world = jnp.where(m[..., None], world, PAD_VALUE)
    vm = build_ndt_map(world.reshape(-1, 3), m.reshape(-1), jnp.float32(cfg.ndt.resolution),
                       capacity=map_capacity)

    # Initial-guess model follows the config like the live front end: the default is
    # the reference's constant-pose (`lidar_scan_matcher.cpp:165`) — the STABLE model;
    # constant-velocity extrapolation has closed-loop gain ~2/frame on pose error
    # (core/config.py discussion) and measurably diverged this driver (err doubling
    # per frame from f~15 on the 90-frame circle).
    if cfg.initial_guess == "constant_velocity":
        guess = jnp.where(state.kf_count > 0, state.pose @ state.last_motion, jnp.eye(4))
    else:
        guess = state.pose
    if cfg.ndt.coarse_resolution > 0.0:
        vm_coarse = build_ndt_map(
            world.reshape(-1, 3), m.reshape(-1), jnp.float32(cfg.ndt.coarse_resolution),
            capacity=map_capacity // 2,
        )
        pre = ndt_align(
            vm_coarse, scan, scan_mask, guess,
            step_size=cfg.ndt.step_size * 4.0,
            transform_epsilon=cfg.ndt.transform_epsilon,
            outlier_ratio=cfg.ndt.outlier_ratio,
            max_iterations=cfg.ndt.coarse_iterations,
        )
        guess = pre.transform
    res = ndt_align(
        vm, scan, scan_mask, guess,
        step_size=cfg.ndt.step_size,
        transform_epsilon=cfg.ndt.transform_epsilon,
        outlier_ratio=cfg.ndt.outlier_ratio,
        max_iterations=cfg.ndt.max_iterations,
    )
    healthy = res.converged & (res.num_inliers > 0)
    is_first = state.kf_count == 0
    new_pose = jnp.where(is_first, jnp.eye(4), jnp.where(healthy, res.transform, state.pose))
    last_motion = jnp.where(
        healthy & ~is_first, se3.inverse(state.pose) @ new_pose, state.last_motion
    )

    delta = jnp.linalg.norm(new_pose[:3, 3] - state.last_kf_pos)
    trigger = is_first | (healthy & (delta >= cfg.displacement))

    slot = state.kf_count % window
    ring_clouds = jnp.where(trigger, state.ring_clouds.at[slot].set(scan), state.ring_clouds)
    ring_masks = jnp.where(trigger, state.ring_masks.at[slot].set(scan_mask), state.ring_masks)
    ring_poses = jnp.where(trigger, state.ring_poses.at[slot].set(new_pose), state.ring_poses)
    ring_used = jnp.where(trigger, state.ring_used.at[slot].set(True), state.ring_used)

    new_state = BatchFrontState(
        pose=new_pose,
        last_motion=last_motion,
        last_kf_pos=jnp.where(trigger, new_pose[:3, 3], state.last_kf_pos),
        accum_dist=state.accum_dist + jnp.where(trigger & ~is_first, delta, 0.0),
        kf_count=state.kf_count + trigger.astype(jnp.int32),
        ring_clouds=ring_clouds,
        ring_masks=ring_masks,
        ring_poses=ring_poses,
        ring_used=ring_used,
    )
    out = {
        "pose": new_pose,
        "is_keyframe": trigger,
        "converged": healthy,
        "fitness": res.fitness,
        "accum_dist": new_state.accum_dist,
    }
    return new_state, out


@partial(jax.jit, static_argnames=("cfg", "map_capacity"))
def _run_batch(scans, masks, cfg: ScanMatcherConfig, map_capacity: int):
    B, F, N = scans.shape[:3]
    window = cfg.max_scan_accumulate_num
    init = jax.vmap(lambda _: _init_state(window, N))(jnp.arange(B))

    def frame(state, inputs):
        scan, mask = inputs
        return jax.vmap(lambda s, sc, mk: _step(s, sc, mk, cfg, map_capacity))(state, scan, mask)

    # scan over frames: inputs time-major [F, B, ...].
    final, outs = jax.lax.scan(frame, init, (scans.swapaxes(0, 1), masks.swapaxes(0, 1)))
    # outs pytree leaves are [F, B, ...] -> [B, F, ...].
    outs = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)
    return final, outs


def batch_odometry(scans, masks, cfg: ScanMatcherConfig, map_capacity: int = 32768, mesh=None):
    """Run NDT front-end odometry on [B, F, N, 3] scan batches.

    With `mesh`, the batch axis is sharded over the mesh's first axis (data parallel over
    sequences). Returns (final_state, outs) where outs["pose"] is [B, F, 4, 4].
    """
    scans = jnp.asarray(scans)
    masks = jnp.asarray(masks)
    if mesh is not None:
        axis = list(mesh.shape.keys())[0]
        sh = NamedSharding(mesh, P(axis))
        scans = jax.device_put(scans, sh)
        masks = jax.device_put(masks, sh)
    return _run_batch(scans, masks, cfg, map_capacity)


def _tree_concat(trees):
    """Concatenate a list of pytrees (leading batch axes) along axis 0."""
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *trees)


def _batched_loop_attempts(backs, due, mesh, verify_cache):
    """One cross-SEQUENCE loop-verification round + block-diagonal solve.

    Each due sequence's detection + host input builds run through the same
    `GraphBasedSLAM._build_verify_inputs` the live pipeline uses; the iterative
    verifications then run as ONE device program with the batch axis spanning
    sequences x candidates, sharded over the mesh (previously each sequence dispatched and solved alone).
    Sequences are independent, so batching changes nothing semantically. Every
    sequence that accepts a factor is then solved in `_solve_block_diagonal` — B
    independent graphs as one block-diagonal f64 system."""
    from lidar_graph_slam_tpu.graph.slam import make_verify_one
    from lidar_graph_slam_tpu.parallel.distributed import shard_batch

    inputs = []
    for b in due:
        inp = backs[b]._build_verify_inputs()
        if inp is not None:
            inputs.append((b, inp))
    if not inputs:
        return
    # Concatenate candidates across sequences; each sequence's shared source arrays
    # are repeated per candidate (the cross-sequence program batches EVERY argument).
    batched = _tree_concat([inp["batched"] for _, inp in inputs])
    shared = _tree_concat([
        jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (len(inp["cands"]),) + x.shape),
            inp["shared"])
        for _, inp in inputs
    ])
    n_real = sum(len(inp["cands"]) for _, inp in inputs)
    # Pad to a mesh multiple (repeat the last entry) so the batch shards evenly, and
    # so jit sees few distinct batch sizes.
    n_dev = mesh.devices.size if mesh is not None else 1
    n_pad = (-n_real) % n_dev
    if n_pad:
        rep = jax.tree.map(
            lambda x: jnp.concatenate([x] + [x[-1:]] * n_pad, axis=0),
            (batched, shared))
        batched, shared = rep
    args = batched + shared
    if mesh is not None:
        args, _ = shard_batch(mesh, args, ())
    key = (n_real + n_pad, backs[0].method)
    if key not in verify_cache:
        verify_cache[key] = jax.jit(jax.vmap(
            make_verify_one(backs[0].cfg, backs[0].method), in_axes=0))
    Ts, scores, convs = jax.device_get(verify_cache[key](*args))

    accepted = []
    off = 0
    for b, inp in inputs:
        k_b = len(inp["cands"])
        pend = {
            "cands": inp["cands"], "latest": inp["latest"],
            "T_latest": inp["T_latest"], "global_diags": inp["global_diags"],
            "results": (Ts[off:off + k_b], scores[off:off + k_b],
                        convs[off:off + k_b]),
        }
        off += k_b
        if backs[b]._consume_verify(pend):
            accepted.append(b)
    if accepted:
        _solve_block_diagonal(backs, accepted)


def _solve_block_diagonal(backs, seqs):
    """Solve the accepted sequences' pose graphs as ONE block-diagonal f64 system:
    per-sub-graph priors + a masked chain coupling at sequence boundaries
    (`refine64.GraphView(prior_rows=..., chain_mask=...)`). Exactly equal to separate
    per-sequence solves (tested) while the separator-direct elimination batches all
    interior chains in one sweep."""
    from lidar_graph_slam_tpu.graph import refine64, solver

    views = [backs[b]._host_view() for b in seqs]
    Ks = [v.poses.shape[0] for v in views]
    offs = np.concatenate([[0], np.cumsum(Ks)]).astype(np.int64)
    chain_mask = np.ones(int(offs[-1]), bool)
    chain_mask[offs[1:-1]] = False
    combined = refine64.GraphView(
        np.concatenate([v.poses for v in views]),
        np.concatenate([v.odom_meas for v in views]),
        views[0].prior_pose, views[0].odom_info,
        np.concatenate([v.loop_i + offs[i] for i, v in enumerate(views)]),
        np.concatenate([v.loop_j + offs[i] for i, v in enumerate(views)]),
        np.concatenate([v.loop_meas for v in views]),
        np.concatenate([v.loop_info for v in views]),
        robust_delta=views[0].robust_delta,
        prior_rows=offs[:-1],
        prior_poses=np.stack([v.prior_pose for v in views]),
        chain_mask=chain_mask,
    )
    poses64, _info = solver.escalate_f64(combined, device_lm=lambda p: p)
    import jax.numpy as _jnp

    for i, b in enumerate(seqs):
        back = backs[b]
        p32 = poses64[offs[i]:offs[i + 1]].astype(np.float32)
        back._poses_host = [p32[k] for k in range(p32.shape[0])]
        g = back.graph
        back.graph = g.replace(
            poses=g.poses.at[: p32.shape[0]].set(_jnp.asarray(p32)))
        back._solve_epoch += 1
        back.is_loop_closed = True


def batch_slam(scans, masks, cfg: ScanMatcherConfig, graph_cfg=None, capacity=None,
               map_capacity: int = 32768, mesh=None, loop_every_keyframes: int = 5):
    """Multi-sequence SLAM: mesh-sharded batched odometry + a DISTRIBUTED graph back
    end — BASELINE.json configs[3] ("multi-sequence batch: sharded keyframes,
    distributed BA on 1 host") as one call.

    The front end runs all B sequences as ONE device program (`batch_odometry`, batch
    axis over the mesh). Keyframes then stream into per-sequence `GraphBasedSLAM`
    back ends in LOCKSTEP (keyframe ordinal t across sequences): every
    `loop_every_keyframes` inserts each sequence attempts a loop closure, and all
    due sequences' verifications run as ONE mesh-sharded device program
    (sequences x candidates batch axis) followed by ONE block-diagonal f64 solve of
    every accepted graph (`_solve_block_diagonal`). Sequences are independent, so
    per-sequence trajectories are identical to the sequential per-sequence path —
    the same detector/verifier/solver stack as the live pipeline. Cadence is the
    reference's 1 Hz timer (`graph_based_slam.cpp:71-74`) in keyframe units.

    Returns a list of B dicts: {"odometry_poses" [F,4,4], "keyframe_poses" [K,4,4],
    "keyframe_frame_indices" [K], "num_loop_closures", "loop_log"}.
    """
    from lidar_graph_slam_tpu.core.config import CapacityConfig, GraphSlamConfig
    from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM

    graph_cfg = graph_cfg or GraphSlamConfig()
    capacity = capacity or CapacityConfig()
    scans_np = np.asarray(scans)
    masks_np = np.asarray(masks)
    _, outs = batch_odometry(scans_np, masks_np, cfg, map_capacity, mesh)
    outs = jax.device_get(outs)
    B = scans_np.shape[0]

    backs = [GraphBasedSLAM(graph_cfg, capacity) for _ in range(B)]
    kf_frames_all = [
        np.nonzero(np.asarray(outs["is_keyframe"][b]))[0] for b in range(B)]
    since = [0] * B
    verify_cache: dict = {}
    max_kf = max((len(k) for k in kf_frames_all), default=0)
    for t in range(max_kf):
        due = []
        for b in range(B):
            if t >= len(kf_frames_all[b]):
                continue
            f = kf_frames_all[b][t]
            backs[b].add_keyframe({
                "pose": np.asarray(outs["pose"][b, f], np.float32),
                "cloud": scans_np[b, f],
                "cloud_mask": masks_np[b, f],
                "accum_distance": float(outs["accum_dist"][b, f]),
            })
            since[b] += 1
            if since[b] >= loop_every_keyframes:
                since[b] = 0
                due.append(b)
        if due:
            _batched_loop_attempts(backs, due, mesh, verify_cache)
    # Final attempt for sequences whose tail keyframes came in after their last
    # cadence tick (since == 0 means the last insert already attempted this exact
    # pair; rerunning would double-insert the factor).
    tail_due = [b for b in range(B) if since[b] and len(kf_frames_all[b])]
    if tail_due:
        _batched_loop_attempts(backs, tail_due, mesh, verify_cache)

    return [{
        "odometry_poses": np.asarray(outs["pose"][b]),
        "keyframe_poses": backs[b].optimized_poses(),
        "keyframe_frame_indices": kf_frames_all[b],
        "num_loop_closures": sum(1 for l in backs[b].loop_log if l["accepted"]),
        "loop_log": backs[b].loop_log,
    } for b in range(B)]
