"""Scan-to-submap LiDAR odometry front end.

Re-design of the `lidar_scan_matcher` node (`lidar_scan_matcher/src/
lidar_scan_matcher.cpp:122-250`): pluggable NDT/GICP/ICP registration, constant-pose initial
guess (`:165` — previous pose, no velocity extrapolation), displacement-triggered keyframing
(`:180-183`, 1.0 m default), submap target = last `max_scan_accumulate_num` (20) keyframe
clouds transformed by their stored poses (`:199-212`), and non-convergence frame dropping
(`:167-170`).

Architecture notes (not a port):
  * The ROS callback + DDS executor becomes a host-side `ScanMatcher.process()` loop driving
    two jitted programs: `align` (per frame) and `rebuild submap` (per keyframe). All device
    arrays are fixed-shape; the only host round trips are the scan upload and the scalar
    convergence/displacement reads that steer keyframing.
  * The last-K keyframe window lives in a device-side ring buffer [K, N, 3]; the submap
    rebuild transforms all K clouds with one einsum and re-sorts — the reference's
    `setInputTarget` O(submap) rebuild, but on-chip.
  * The mutex-free functional state replaces the reference's shared-mutable members
    (`lidar_scan_matcher.hpp:57-127`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.core.config import ScanMatcherConfig
from lidar_graph_slam_tpu.core.msgs import KeyFrame
from lidar_graph_slam_tpu.core.pointcloud import PAD_VALUE, PointCloud
from lidar_graph_slam_tpu.core.struct import pytree_dataclass
from lidar_graph_slam_tpu.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu.ops.neighbors import build_hash_grid
from lidar_graph_slam_tpu.registration import gicp, icp, ndt


def integrate_gyro(queue, t0: Optional[float], t1: Optional[float]) -> Optional[np.ndarray]:
    """Integrate queued (stamp, angular_velocity) gyro samples over (t0, t1] into a 3x3
    rotation, or None when unstamped / no samples. Shared by the classic and fused
    drivers (the reference's dormant `callback_imu` slot, `lidar_scan_matcher.hpp:64-68`,
    made functional)."""
    if t0 is None or t1 is None or not queue:
        return None
    samples = [(t, w) for t, w in queue if t0 < t <= t1]
    if not samples:
        return None
    omega = np.zeros(3)
    prev_t = t0
    for t, w in samples:
        omega += w * (t - prev_t)
        prev_t = t
    return np.asarray(se3.so3_exp(jnp.asarray(omega, dtype=jnp.float32)))


@pytree_dataclass
class SubmapRing:
    """Ring buffer of the last-K keyframe clouds (sensor frame) + their poses."""

    clouds: jax.Array   # [K, N, 3]
    masks: jax.Array    # [K, N]
    poses: jax.Array    # [K, 4, 4]
    used: jax.Array     # [K] bool — slot holds a real keyframe


def init_ring(window: int, n_points: int) -> SubmapRing:
    return SubmapRing(
        clouds=jnp.full((window, n_points, 3), PAD_VALUE, dtype=jnp.float32),
        masks=jnp.zeros((window, n_points), dtype=bool),
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (window, 4, 4)),
        used=jnp.zeros((window,), dtype=bool),
    )


@partial(jax.jit, donate_argnames=("ring",))
def ring_insert(ring: SubmapRing, slot: jax.Array, points, mask, pose) -> SubmapRing:
    return SubmapRing(
        clouds=ring.clouds.at[slot].set(points),
        masks=ring.masks.at[slot].set(mask),
        poses=ring.poses.at[slot].set(pose),
        used=ring.used.at[slot].set(True),
    )


def assemble_submap(ring: SubmapRing, stride: int = 1):
    """Transform every ring cloud into the map frame and flatten: [K*N, 3], [K*N].

    `stride` > 1 subsamples each slot's points for the NDT MAP BUILD only (the
    registration source always sees every point): a 2 m voxel Gaussian estimated from
    every 2nd point of a 33k-point scan still averages hundreds of samples per
    occupied voxel, while the build's dominant cost — the on-chip sort + segment
    reductions over window*N rows — scales 1/stride (bench frame_budget: the rebuild
    was ~35 ms of the ~59 ms keyframe-frame device budget at HDL-64 load)."""
    if stride < 1:
        # A clear config error beats jit tracing dying on `[::0]` (stride 0) or a
        # negative stride silently reversing the point order.
        raise ValueError(f"map_build_stride must be >= 1, got {stride}")
    world = se3.transform_points(ring.poses, ring.clouds)  # [K, N, 3]
    mask = ring.masks & ring.used[:, None]
    world = jnp.where(mask[..., None], world, PAD_VALUE)
    if stride > 1:
        world = world[:, ::stride]
        mask = mask[:, ::stride]
    return world.reshape(-1, 3), mask.reshape(-1)


class ScanMatcher:
    """Host-side front-end driver with jitted compute stages.

    process(scan_points, scan_mask) -> dict with pose [4,4] np, is_keyframe, converged,
    fitness, iterations — the information the reference publishes per frame
    (`lidar_scan_matcher.cpp:226-249`).
    """

    def __init__(self, cfg: ScanMatcherConfig, scan_capacity: int, map_voxel_capacity: int = 65536):
        self.cfg = cfg
        self.scan_capacity = scan_capacity
        self.map_voxel_capacity = map_voxel_capacity
        self.method = cfg.registration_method.upper()
        if self.method not in ("NDT", "GICP", "ICP"):
            raise ValueError(f"unknown registration_method {cfg.registration_method!r}")

        self.ring = init_ring(cfg.max_scan_accumulate_num, scan_capacity)
        self.pose = np.eye(4, dtype=np.float32)
        self.last_motion = np.eye(4, dtype=np.float32)  # T_{t-1}^{-1} T_t for velocity model
        self.last_kf_pose = np.eye(4, dtype=np.float32)
        # IMU queue. The reference declares these hooks but never implements them
        # (`lidar_scan_matcher.hpp:64-68`, empty `correct_imu` `lidar_scan_matcher.cpp:
        # 117-120`, `imu_queue_` hpp:113); here the gyro actually improves the initial
        # guess: integrated angular velocity replaces the constant-velocity rotation.
        self.imu_queue: list[tuple[float, np.ndarray]] = []  # (stamp, angular_velocity)
        # Time-varying sensor->base extrinsic hook (`resolve_extrinsic`): a callable
        # stamp -> [4,4] | None, standing in for the reference's per-frame TF lookup.
        self.extrinsic_provider = None
        self.last_scan_stamp: Optional[float] = None
        self.accum_distance = 0.0
        self.n_keyframes = 0
        self.n_frames = 0
        self.target = None
        self.keyframe_log: list[KeyFrame] = []  # host-side keyframe records for the back end

        self._assemble_and_build = None
        if self.method == "NDT":
            self._build_target, self._align = ndt.make_ndt_matcher(cfg.ndt, map_voxel_capacity)
        elif self.method == "GICP":
            self._build_target, self._align = gicp.make_gicp_matcher(cfg.gicp)
        else:
            self._build_target, self._align = icp.make_icp_matcher(
                cfg.gicp, cell_size=cfg.gicp.max_correspondence_distance
            )

    # -- internal jit-side helpers ------------------------------------------------------

    def _rebuild_target(self):
        # One jitted program per keyframe: ring -> map-frame submap -> registration target.
        # Keeping assembly and target build fused avoids a string of small dispatches and
        # their per-call host overhead.
        if self._assemble_and_build is None:
            self._assemble_and_build = jax.jit(
                lambda ring: self._build_target(
                    *assemble_submap(ring, stride=self.cfg.map_build_stride))
            )
        self.target = self._assemble_and_build(self.ring)

    def _register(self, cloud: PointCloud, init_T):
        if self.method == "GICP":
            covs, _ = gicp.estimate_covariances(
                cloud.points, cloud.mask, self.cfg.gicp.max_correspondence_distance,
                k=self.cfg.gicp.correspondence_randomness,
            )
            return self._align(self.target, cloud.points, cloud.mask, init_T, covs)
        return self._align(self.target, cloud.points, cloud.mask, init_T)

    def _add_keyframe(self, cloud: PointCloud, pose: np.ndarray, delta: float):
        slot = jnp.asarray(self.n_keyframes % self.cfg.max_scan_accumulate_num, jnp.int32)
        self.ring = ring_insert(self.ring, slot, cloud.points, cloud.mask, jnp.asarray(pose))
        self.accum_distance += float(delta)
        pts_host, mask_host = jax.device_get((cloud.points, cloud.mask))
        self.keyframe_log.append(
            KeyFrame(
                id=self.n_keyframes,
                pose=pose.copy(),
                accum_distance=self.accum_distance,
                cloud=pts_host,
                cloud_mask=mask_host,
                frame_index=self.n_frames - 1,  # n_frames is incremented before keyframing
                stamp=self.last_scan_stamp,
            )
        )
        self.n_keyframes += 1
        self.last_kf_pose = pose.copy()
        self._rebuild_target()

    # -- public API ---------------------------------------------------------------------

    def add_imu(self, stamp: float, angular_velocity, linear_acceleration=None) -> None:
        """Queue an IMU sample (the reference's `callback_imu` slot). Only the gyro is
        used (rotation prediction); accel is accepted for interface parity."""
        del linear_acceleration
        self.imu_queue.append((float(stamp), np.asarray(angular_velocity, dtype=np.float64)))
        if len(self.imu_queue) > 2000:
            self.imu_queue = self.imu_queue[-1000:]

    def _imu_rotation_delta(self, stamp: Optional[float]) -> Optional[np.ndarray]:
        """Integrate queued gyro samples between the previous scan and `stamp`."""
        R = integrate_gyro(self.imu_queue, self.last_scan_stamp, stamp)
        if R is None:
            return None
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = R
        return out

    def resolve_extrinsic(self, stamp: Optional[float]) -> Optional[np.ndarray]:
        """Sensor->base transform for this frame — the reference's per-callback TF
        lookup (`lidar_scan_matcher.cpp:129-131,252-273`): a time-varying
        `extrinsic_provider(stamp) -> [4,4] | None` takes precedence; a provider miss
        (None) falls back to the static config extrinsic; both absent -> None
        (identity, the reference's lookup-failure fallback)."""
        if self.extrinsic_provider is not None:
            T = self.extrinsic_provider(stamp)
            if T is not None:
                return np.asarray(T, np.float32)
        if any(abs(v) > 1e-12 for v in self.cfg.extrinsic_xyzrpy):
            x, y, z, roll, pitch, yaw = self.cfg.extrinsic_xyzrpy
            return np.asarray(se3.make_transform(
                se3.so3_exp(jnp.asarray([roll, pitch, yaw], jnp.float32)),
                jnp.asarray([x, y, z], jnp.float32),
            ))
        return None

    def process(self, cloud: PointCloud, stamp: Optional[float] = None) -> dict:
        """Feed one prefiltered scan (sensor frame); returns per-frame odometry outputs."""
        self.n_frames += 1
        T_ext = self.resolve_extrinsic(stamp)
        if T_ext is not None:
            pts = se3.transform_points(jnp.asarray(T_ext), cloud.points)
            from lidar_graph_slam_tpu.core.pointcloud import pad_points

            cloud = PointCloud(points=pad_points(pts, cloud.mask), mask=cloud.mask)
        if self.n_keyframes == 0:
            # First-scan bootstrap (`lidar_scan_matcher.cpp:133-160`): identity pose,
            # keyframe 0, target := the scan itself.
            self.last_scan_stamp = stamp
            self._add_keyframe(cloud, self.pose, 0.0)
            return {
                "pose": self.pose.copy(),
                "is_keyframe": True,
                "converged": True,
                "fitness": 0.0,
                "iterations": 0,
            }

        if self.cfg.initial_guess == "constant_velocity":
            guess = self.pose @ self.last_motion
        else:  # "constant_pose": the reference's model (`lidar_scan_matcher.cpp:165`)
            guess = self.pose
        imu_delta = self._imu_rotation_delta(stamp)
        if imu_delta is not None:
            # Replace the extrapolated rotation with the gyro-integrated one, keeping the
            # extrapolated translation.
            imu_guess = guess.copy()
            imu_guess[:3, :3] = self.pose[:3, :3] @ imu_delta[:3, :3]
            guess = imu_guess
        self.last_scan_stamp = stamp
        res = self._register(cloud, jnp.asarray(guess))
        # ONE batched device->host read per frame: every separate scalar read is its own
        # host<->device synchronization.
        transform, res_converged, fitness_f, iters_i, inliers_i, n_valid_i = jax.device_get(
            (res.transform, res.converged, res.fitness, res.iterations, res.num_inliers,
             cloud.mask.sum())
        )
        converged = bool(res_converged)
        # Health gate: "converged" with almost no matched points is a silent failure
        # (e.g. the scan left the submap's basin); treat like non-convergence.
        n_valid = max(int(n_valid_i), 1)
        denom = n_valid * 7 if self.method == "NDT" else n_valid
        if converged and int(inliers_i) < self.cfg.min_inlier_fraction * denom:
            converged = False
        if not converged:
            # Reference drops the frame and keeps the previous pose (`:167-170`).
            return {
                "pose": self.pose.copy(),
                "is_keyframe": False,
                "converged": False,
                "fitness": float(fitness_f),
                "iterations": int(iters_i),
            }

        new_pose = np.asarray(transform)
        self.last_motion = (np.linalg.inv(self.pose) @ new_pose).astype(np.float32)
        self.pose = new_pose
        delta = float(np.linalg.norm(self.pose[:3, 3] - self.last_kf_pose[:3, 3]))
        is_keyframe = delta >= self.cfg.displacement
        if is_keyframe:
            self._add_keyframe(cloud, self.pose, delta)
        return {
            "pose": self.pose.copy(),
            "is_keyframe": is_keyframe,
            "converged": True,
            "fitness": float(fitness_f),
            "iterations": int(iters_i),
        }
