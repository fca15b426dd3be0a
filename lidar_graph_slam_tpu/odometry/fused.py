"""Fused front end: prefilter + align + keyframe decision as ONE device program.

Motivation. The reference runs prefiltering and scan matching as separate ROS processes and
pays DDS hops between them (`points_prefiltering` -> `/filtered_points` ->
`lidar_scan_matcher`, SURVEY.md §3.1-3.2). A stage-by-stage port of that structure — a host
loop calling prefilter, then align, then reading scalars to decide keyframing — pays a full
host<->device round trip per stage, and leaves the device idle while the host waits on each.

Here the per-frame tick (`lidar_scan_matcher.cpp:122-250` + the prefilter node) is a single
jitted step over a small device-resident state:

    raw scan -> prefilter -> align(target) -> health gate -> masked pose update
             -> keyframe decision (displacement trigger, accum distance)

so the host drives frames without ANY synchronous read: it dispatches step t+1 and reads
step t's compact outputs afterwards (one batched transfer, overlapped with device compute).

The submap ring and registration-target rebuild deliberately stay OUTSIDE this program, as
the same independently-jitted programs the classic `ScanMatcher` driver uses
(`ring_insert`, build-target-from-ring). Two reasons:

  * Stability: the voxel-Gaussian target build is sensitive at voxel granularity — any
    re-fusion of that program perturbs borderline voxels, and perturbing the target inside
    the odometry feedback loop was measured to destabilize an otherwise noise-damping
    closed loop (the classic driver damps 1e-4-level pose/ring noise; a re-fused in-step
    rebuild diverged at ~2.7x/frame from FP-level seeds). Sharing the classic build program
    keeps the map path bit-identical to the proven driver.
  * Latency: the rebuild only runs on keyframe frames, driven by the (lagged) host read.
    The submap therefore lags the newest keyframe by one frame — verified to leave the
    trajectory unchanged (the newest keyframe is nearly redundant with the current scan,
    and the lag decouples the highest-gain feedback path, the newest keyframe's pose
    error, by one step).

The data-dependent branches of the reference (first-scan bootstrap `:133-160`, convergence
drop `:167-170`, displacement keyframe trigger `:180-183`) become masked selects — XLA-
static control flow per SURVEY.md §7.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.core.config import CapacityConfig, PrefilterConfig, ScanMatcherConfig
from lidar_graph_slam_tpu.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu.core.struct import pytree_dataclass
from lidar_graph_slam_tpu.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu.odometry.scan_matcher import assemble_submap, init_ring
from lidar_graph_slam_tpu.registration import gicp, icp, ndt


@pytree_dataclass
class FrontEndState:
    """Compact device-resident front-end state (the pose-track part of
    `LidarScanMatcher`'s members, `lidar_scan_matcher.hpp:57-127`). The submap ring and
    target are owned by the host driver — see module docstring."""

    pose: jax.Array           # [4,4] current odometry estimate (map frame)
    last_motion: jax.Array    # [4,4] T_{t-1}^{-1} T_t, for the constant-velocity guess
    last_kf_pose: jax.Array   # [4,4] pose at the last keyframe
    accum_distance: jax.Array  # f32 — total keyframe path length (KeyFrame.accum_distance)
    n_keyframes: jax.Array    # i32


@pytree_dataclass
class FrameOut:
    """Per-frame outputs — everything the reference publishes per frame (`:226-249`) plus
    the keyframe record the back end and the ring need (the `/key_frame` topic, `:220`)."""

    pose: jax.Array           # [4,4]
    converged: jax.Array      # bool (after the inlier health gate)
    is_keyframe: jax.Array    # bool
    fitness: jax.Array        # f32
    iterations: jax.Array     # i32
    num_inliers: jax.Array    # i32
    keyframe_id: jax.Array    # i32 — id assigned IF this frame is a keyframe
    accum_distance: jax.Array  # f32 — after this frame's (potential) keyframe update
    kf_cloud: jax.Array       # [N,3] the filtered base-frame cloud (keyframe payload)
    kf_mask: jax.Array        # [N]


def make_fused_frontend(
    cfg: ScanMatcherConfig,
    prefilter_cfg: PrefilterConfig,
    capacity: CapacityConfig,
) -> Tuple[Callable[[], FrontEndState], Callable, dict]:
    """Build (init_state, step, aux) for the fused front end.

    step(state, raw_points [R,3], target, imu_R [3,3], use_imu bool,
         T_ext [4,4], use_ext bool) -> (state', FrameOut)

    aux = {"init_ring": () -> SubmapRing, "rebuild": ring -> target, "window": int}
    exposes the classic driver's ring/target programs for the host to drive.
    """
    method = cfg.registration_method.upper()
    if method not in ("NDT", "GICP", "ICP"):
        raise ValueError(f"unknown registration_method {cfg.registration_method!r}")

    prefilter = make_prefilter(
        prefilter_cfg,
        capacity_out=capacity.filtered_points,
        voxel_capacity=min(capacity.raw_points, 2 * capacity.filtered_points),
    )
    if method == "NDT":
        build_target, align = ndt.make_ndt_matcher(cfg.ndt, capacity.voxel_capacity)
    elif method == "GICP":
        build_target, align = gicp.make_gicp_matcher(cfg.gicp)
    else:
        build_target, align = icp.make_icp_matcher(
            cfg.gicp, cell_size=cfg.gicp.max_correspondence_distance
        )

    window = cfg.max_scan_accumulate_num
    n_filtered = capacity.filtered_points

    def _register(target, points, mask, guess):
        if method == "GICP":
            covs, _ = gicp.estimate_covariances(
                points, mask, cfg.gicp.max_correspondence_distance,
                k=cfg.gicp.correspondence_randomness,
            )
            return align(target, points, mask, guess, covs)
        return align(target, points, mask, guess)

    def init_state() -> FrontEndState:
        # Distinct buffers per field — donation forbids aliased arguments.
        def eye():
            return jnp.eye(4, dtype=jnp.float32) + 0.0

        return FrontEndState(
            pose=eye(), last_motion=eye(), last_kf_pose=eye(),
            accum_distance=jnp.float32(0.0),
            n_keyframes=jnp.int32(0),
        )

    @partial(jax.jit, donate_argnames=("state",))
    def step(state: FrontEndState, raw_points, target, imu_R, use_imu, T_ext, use_ext):
        # Validity is derived from the PAD_VALUE sentinel ON DEVICE: the host uploads one
        # [R, 3] array per frame instead of points + mask — one transfer per frame
        # instead of two.
        raw_mask = raw_points[:, 0] < (0.5 * PAD_VALUE)
        # Per-frame sensor->base extrinsic (the reference's per-callback TF lookup with
        # identity fallback, `lidar_scan_matcher.cpp:129-131,252-273`): T_ext is a traced
        # input, so a time-varying provider costs nothing when unused (use_ext False).
        raw_points = jnp.where(
            use_ext & raw_mask[:, None],
            se3.transform_points(T_ext, raw_points),
            raw_points,
        )
        filtered = prefilter(raw_points, raw_mask)
        bootstrap = state.n_keyframes == 0

        # Initial guess: constant velocity (ours) or the reference's constant pose
        # (`lidar_scan_matcher.cpp:165`); IMU gyro rotation overrides when provided.
        if cfg.initial_guess == "constant_velocity":
            guess = state.pose @ state.last_motion
        else:
            guess = state.pose
        guess_R = jnp.where(use_imu, state.pose[:3, :3] @ imu_R, guess[:3, :3])
        guess = guess.at[:3, :3].set(guess_R)

        res = _register(target, filtered.points, filtered.mask, guess)

        # Health gate (see ScanMatcher.process): converged with almost no matched points
        # is a silent failure; NDT counts 7 correspondences per point (DIRECT7).
        n_valid = jnp.maximum(jnp.sum(filtered.mask.astype(jnp.int32)), 1)
        denom = n_valid * 7 if method == "NDT" else n_valid
        healthy = res.converged & (
            res.num_inliers.astype(jnp.float32) >= cfg.min_inlier_fraction * denom.astype(jnp.float32)
        )
        ok = healthy & jnp.logical_not(bootstrap)

        new_pose = jnp.where(ok, res.transform, state.pose)
        new_motion = jnp.where(ok, se3.inverse(state.pose) @ new_pose, state.last_motion)
        delta = jnp.linalg.norm(new_pose[:3, 3] - state.last_kf_pose[:3, 3])
        is_kf = bootstrap | (ok & (delta >= cfg.displacement))
        accum_delta = jnp.where(bootstrap, jnp.float32(0.0), delta.astype(jnp.float32))
        kf_id = state.n_keyframes

        new_state = FrontEndState(
            pose=new_pose,
            last_motion=new_motion,
            last_kf_pose=jnp.where(is_kf, new_pose, state.last_kf_pose),
            accum_distance=state.accum_distance + jnp.where(is_kf, accum_delta, 0.0),
            n_keyframes=state.n_keyframes + is_kf.astype(jnp.int32),
        )
        out = FrameOut(
            pose=new_pose,
            converged=ok | bootstrap,
            is_keyframe=is_kf,
            fitness=jnp.where(bootstrap, jnp.float32(0.0), res.fitness.astype(jnp.float32)),
            iterations=jnp.where(bootstrap, jnp.int32(0), res.iterations.astype(jnp.int32)),
            num_inliers=res.num_inliers.astype(jnp.int32),
            keyframe_id=kf_id,
            accum_distance=new_state.accum_distance,
            kf_cloud=filtered.points,
            kf_mask=filtered.mask,
        )
        return new_state, out

    # The classic driver's ring/target programs, exposed for the host loop. `rebuild` has
    # the same jaxpr as ScanMatcher._assemble_and_build — bit-identical target math.
    # `insert_and_rebuild` fuses the keyframe ring insert with the target rebuild into
    # ONE dispatch (host overhead is per-dispatch); it stays OUTSIDE the step program
    # (the instability post-mortem in the module docstring concerns in-STEP fusion — the
    # lagged host-driven rebuild keeps the feedback decoupling).
    from lidar_graph_slam_tpu.odometry.scan_matcher import ring_insert as _ring_insert

    def _insert_and_rebuild(ring, slot, points, mask, pose):
        new_ring = _ring_insert(ring, slot, points, mask, pose)
        return new_ring, build_target(*assemble_submap(new_ring, stride=cfg.map_build_stride))

    aux = {
        "init_ring": lambda: init_ring(window, n_filtered),
        "rebuild": jax.jit(lambda ring: build_target(
            *assemble_submap(ring, stride=cfg.map_build_stride))),
        "insert_and_rebuild": jax.jit(_insert_and_rebuild, donate_argnames=("ring",)),
        "window": window,
    }
    return init_state, step, aux
