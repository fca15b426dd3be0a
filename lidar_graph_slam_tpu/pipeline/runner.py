"""End-to-end SLAM pipeline driver.

Replaces the reference's three-process ROS 2 launch graph (`lidar_graph_slam/launch/
lidar_graph_slam.launch.xml:6-14` wiring points_prefiltering -> lidar_scan_matcher ->
graph_based_slam over DDS topics) with single-process function composition per host. Two
front-end drivers:

  * fused (default): the whole per-frame tick is ONE device program
    (`odometry/fused.py`) and the host reads frame t's outputs AFTER dispatching frame
    t+1, so the host<->device round trip overlaps device compute. Keyframe payloads
    stream back via async host copies.
  * classic: stage-by-stage (prefilter / register / backend) with synchronous reads —
    finer per-stage timing attribution, same math.

The DDS topic surface becomes the returned `PipelineResult`; per-stage wall-clock metrics
are collected first-class (the observability the reference lacked, SURVEY.md §5.1).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from lidar_graph_slam_tpu.core.config import PipelineConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM


@dataclass
class PipelineResult:
    odometry_poses: np.ndarray          # [F, 4, 4] per-frame front-end poses (scan_matcher_path)
    keyframe_poses: np.ndarray          # [K, 4, 4] optimized keyframe poses (modified_path)
    keyframe_frame_indices: np.ndarray  # [K] which frame each keyframe came from
    num_loop_closures: int
    loop_log: list
    metrics: dict = field(default_factory=dict)


class SlamPipeline:
    """Host driver: feed raw scans, get trajectories, map, and metrics."""

    def __init__(self, cfg: PipelineConfig, metrics_path: Optional[str] = None,
                 extrinsic_provider=None):
        from lidar_graph_slam_tpu.utils.telemetry import MetricsWriter

        self.metrics_writer = MetricsWriter(metrics_path)
        self.cfg = cfg
        # Per-frame sensor->base extrinsic hook: callable stamp -> [4,4] | None (None
        # falls back to the static config extrinsic, then identity) — the reference's
        # per-callback TF lookup with identity fallback
        # (`lidar_scan_matcher.cpp:129-131,252-273`).
        self.extrinsic_provider = extrinsic_provider
        cap = cfg.capacity
        # Mesh parallelism (ParallelConfig): the back end's pose-graph solve runs
        # Schur-distributed and top-k loop verification shards over the mesh. The front
        # end stays single-device — its parallel axis is the point dimension, which one
        # device already spans; scaling the front end across devices is the
        # multi-sequence path (parallel/multi_sequence.py).
        self.mesh = None
        if cfg.parallel.use_mesh:
            from lidar_graph_slam_tpu.parallel.distributed import make_mesh

            self.mesh = make_mesh(cfg.parallel.mesh_devices or None)
        # Multi-host mode auto-detects (`jax.distributed.initialize` must have run —
        # the CLI's --multihost or `multihost.initialize_from_env()`): every process
        # feeds the SAME scan stream (SPMD decisions), keyframe CLOUDS shard across
        # hosts round-robin, and cross-host reads ride one padded allgather
        # (parallel/multihost.py). This is BASELINE.json configs[4] as a runnable
        # pipeline, not scaffolding.
        cloud_store = None
        import jax as _jax

        if _jax.process_count() > 1:
            from lidar_graph_slam_tpu.parallel.multihost import HostShardedKeyframeStore

            cloud_store = HostShardedKeyframeStore(pad_points=cap.keyframe_points)
        self.back = GraphBasedSLAM(
            cfg.graph_slam, cap, mesh=self.mesh,
            backend_solver=cfg.parallel.backend_solver,
            cloud_store=cloud_store,
        )
        self.timings: dict[str, list] = {"prefilter": [], "register": [], "backend": []}
        self.raw_truncation_count = 0
        self.odometry_poses: list[np.ndarray] = []
        self.kf_frame_indices: list[int] = []
        self._loop_attempts_emitted = 0
        self.fused = cfg.fused_frontend

        if self.fused:
            import jax.numpy as jnp

            from lidar_graph_slam_tpu.odometry.fused import make_fused_frontend

            init_state, self._step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter, cap)
            self._state = init_state()
            # Static extrinsic precomputed once; the provider (if any) overrides per frame.
            self._static_ext = None
            if any(abs(v) > 1e-12 for v in cfg.scan_matcher.extrinsic_xyzrpy):
                from lidar_graph_slam_tpu.core import se3 as _se3

                x, y, z, roll, pitch, yaw = cfg.scan_matcher.extrinsic_xyzrpy
                self._static_ext = np.asarray(_se3.make_transform(
                    _se3.so3_exp(jnp.asarray([roll, pitch, yaw], jnp.float32)),
                    jnp.asarray([x, y, z], jnp.float32)))
            self._eye4 = jnp.eye(4, dtype=jnp.float32)
            self._ring = aux["init_ring"]()
            self._rebuild = aux["rebuild"]
            self._insert_and_rebuild = aux["insert_and_rebuild"]
            self._window = aux["window"]
            self._target = self._rebuild(self._ring)  # empty map; frame 0 bootstraps
            self._pending: deque = deque()  # (frame_idx, wall_t0, stamp, FrameOut)
            self._eye3 = jnp.eye(3, dtype=jnp.float32)
            self._false = jnp.asarray(False)
            self._true = jnp.asarray(True)
            self._last_out: dict = {}
            # IMU route for the fused driver: gyro samples queue
            # here and integrate host-side between consecutive scan stamps; the result
            # rides into the fused step as (imu_R, use_imu).
            self._imu_queue: list = []
            self._last_dispatch_stamp = None
            self.front = None
        else:
            from lidar_graph_slam_tpu.filters.prefilter import make_prefilter
            from lidar_graph_slam_tpu.odometry.scan_matcher import ScanMatcher

            # The voxel stage's output capacity bounds the SOR kNN working set; twice the
            # final budget is enough headroom (overflow is flagged in telemetry) and keeps
            # the [Q, 27*bucket] candidate tensors far smaller than sizing by raw_points.
            self.prefilter = make_prefilter(
                cfg.prefilter, capacity_out=cap.filtered_points,
                voxel_capacity=min(cap.raw_points, 2 * cap.filtered_points),
            )
            self.front = ScanMatcher(
                cfg.scan_matcher, scan_capacity=cap.filtered_points,
                map_voxel_capacity=cap.voxel_capacity,
            )
            self.front.extrinsic_provider = extrinsic_provider
            self._kf_consumed = 0

    def _emit_loop_attempts(self, frame_idx: int) -> None:
        """Stream every loop-closure attempt (accepted AND rejected) into the metrics
        JSONL — the reference's `/candidate_key_frame` debugging signal
        (`graph_based_slam.cpp:284-295`), which round 2 only kept for accepted loops."""
        while self._loop_attempts_emitted < len(self.back.loop_log):
            rec = self.back.loop_log[self._loop_attempts_emitted]
            self._loop_attempts_emitted += 1
            self.metrics_writer.emit({
                "event": "loop_attempt",
                "frame": frame_idx,
                "latest": rec.get("latest"),
                "candidate": rec.get("candidate"),
                "fitness": float(rec.get("fitness", np.inf)),
                "converged": bool(rec.get("converged", False)),
                "accepted": bool(rec.get("accepted", False)),
                "overflow": bool(rec.get("overflow", False)),
            })

    # -- fused driver -------------------------------------------------------------------

    def _consume_fused(self, item) -> dict:
        """Read one pending frame's outputs (one batched transfer) and run the back end."""
        import jax

        frame_idx, t0, stamp, out = item
        t1 = time.perf_counter()
        # ONE batched fetch for the SCALARS only. The keyframe payload (cloud+mask,
        # ~0.4 MB) stays device-side: the ring insert consumes the device arrays
        # directly, and the back end stores a lazy reference materialized a couple of
        # frames later (`GraphBasedSLAM.drain_lazy_clouds`) when its async copy has
        # landed — the blocking per-frame fetch no longer carries the payload bytes.
        pose, converged, is_kf, fitness, iters, kf_id, accum = jax.device_get(
            (out.pose, out.converged, out.is_keyframe, out.fitness, out.iterations,
             out.keyframe_id, out.accum_distance)
        )
        t2 = time.perf_counter()
        pose = np.asarray(pose)
        info = {
            "pose": pose,
            "is_keyframe": bool(is_kf),
            "converged": bool(converged),
            "fitness": float(fitness),
            "iterations": int(iters),
        }
        if info["is_keyframe"]:
            # Insert into the device-side submap ring and rebuild the registration target
            # in ONE fused dispatch (host overhead is per-dispatch; see
            # odometry/fused.py on why this stays outside the fused step). The rebuilt
            # target takes effect at the next dispatched frame (one-frame submap lag,
            # verified benign).
            import jax.numpy as jnp

            slot = jnp.asarray(int(kf_id) % self._window, jnp.int32)
            self._ring, self._target = self._insert_and_rebuild(
                self._ring, slot, out.kf_cloud, out.kf_mask, out.pose
            )
            from lidar_graph_slam_tpu.core.msgs import KeyFrame

            self.back.add_keyframe(
                KeyFrame(
                    id=int(kf_id),
                    pose=pose,
                    accum_distance=float(accum),
                    cloud=out.kf_cloud,       # device arrays — materialized lazily
                    cloud_mask=out.kf_mask,
                    frame_index=frame_idx,
                    stamp=stamp,
                )
            )
            self.kf_frame_indices.append(frame_idx)
        if self.cfg.enable_loop_closure:
            self.back.on_frame()
        else:
            self.back.drain_lazy_clouds()
        self._emit_loop_attempts(frame_idx)
        t3 = time.perf_counter()

        self.odometry_poses.append(pose)
        self.timings["register"].append(t2 - t1)
        self.timings["backend"].append(t3 - t2)
        self.metrics_writer.emit(
            {
                "frame": frame_idx,
                "converged": info["converged"],
                "fitness": info["fitness"],
                "iterations": info["iterations"],
                "is_keyframe": info["is_keyframe"],
                "n_keyframes": self.back.n_keyframes,
                "loops_accepted": sum(1 for l in self.back.loop_log if l["accepted"]),
                "register_ms": 1000 * (t2 - t1),
                "backend_ms": 1000 * (t3 - t2),
            }
        )
        self._last_out = info
        return info

    def _pad_bucket(self, scan: np.ndarray) -> np.ndarray:
        """Pad the raw scan to the smallest power-of-two bucket (min 8192) that holds it,
        capped at `capacity.raw_points`. Buckets bound per-frame upload bytes to ~the
        actual scan size while keeping the set of compiled step shapes small (one per
        bucket, compile-cached). Scans larger than `capacity.raw_points` are truncated
        — surfaced via `raw_truncation_count` and a metrics event, matching the
        voxel/keyframe/loop overflow discipline (no silent caps)."""
        from lidar_graph_slam_tpu.core.pointcloud import PAD_VALUE

        n = min(scan.shape[0], self.cfg.capacity.raw_points)
        if scan.shape[0] > self.cfg.capacity.raw_points:
            self.raw_truncation_count += 1
            self.metrics_writer.emit({
                "event": "raw_scan_truncated",
                "frame": len(self.odometry_poses) + len(self._pending),
                "scan_points": int(scan.shape[0]),
                "capacity": int(self.cfg.capacity.raw_points),
            })
        b = 8192
        while b < n:
            b *= 2
        b = min(b, self.cfg.capacity.raw_points)
        out = np.full((b, 3), PAD_VALUE, dtype=np.float32)
        out[:n] = scan[:n]
        return out

    def _process_fused(self, scan: np.ndarray, stamp: Optional[float]) -> dict:
        import jax.numpy as jnp

        from lidar_graph_slam_tpu.odometry.scan_matcher import integrate_gyro

        t0 = time.perf_counter()
        frame_idx = len(self.odometry_poses) + len(self._pending)
        raw_pts = jnp.asarray(self._pad_bucket(np.asarray(scan, dtype=np.float32)))
        # Gyro-integrated rotation since the previously DISPATCHED frame: inside the step
        # the guess rotation becomes state.pose[:3,:3] @ imu_R, and state.pose at dispatch
        # of frame t is frame t-1's pose — exactly the classic driver's semantics.
        imu_R = integrate_gyro(self._imu_queue, self._last_dispatch_stamp, stamp)
        self._last_dispatch_stamp = stamp
        use_imu = imu_R is not None and frame_idx > 0
        # Per-frame extrinsic: provider (TF-lookup analog) -> static config -> identity.
        T_ext = None
        if self.extrinsic_provider is not None:
            T_ext = self.extrinsic_provider(stamp)
        if T_ext is None:
            T_ext = self._static_ext
        self._state, out = self._step(
            self._state, raw_pts, self._target,
            jnp.asarray(imu_R, jnp.float32) if use_imu else self._eye3,
            self._true if use_imu else self._false,
            self._eye4 if T_ext is None else jnp.asarray(T_ext, jnp.float32),
            self._false if T_ext is None else self._true,
        )
        # Start device->host copies NOW, non-blocking: by the time this frame is
        # consumed (`pipeline_depth` frames later) the payload is already host-side, so
        # the consume's device_get does not wait on a transfer.
        for leaf in (out.pose, out.converged, out.is_keyframe, out.fitness,
                     out.iterations, out.keyframe_id, out.accum_distance,
                     out.kf_cloud, out.kf_mask):
            if hasattr(leaf, "copy_to_host_async"):
                leaf.copy_to_host_async()
        t1 = time.perf_counter()
        self.timings["prefilter"].append(t1 - t0)  # host pad + upload + dispatch
        self._pending.append((frame_idx, t0, stamp, out))
        if frame_idx == 0:
            # Bootstrap frame: consume immediately so keyframe 0 lands in the ring and the
            # target is real before frame 1 dispatches (reference `:133-160` semantics).
            return self._consume_fused(self._pending.popleft())
        # Lagged readback: keep `pipeline_depth` frames in flight — deeper pipelining
        # hides more of the host<->device completion latency at the cost of the submap ring
        # lagging keyframes by `depth` frames (quality-checked by the pipeline tests).
        if len(self._pending) > max(1, self.cfg.pipeline_depth):
            return self._consume_fused(self._pending.popleft())
        return dict(self._last_out) if self._last_out else {
            "pose": np.eye(4, dtype=np.float32), "is_keyframe": False,
            "converged": True, "fitness": 0.0, "iterations": 0,
        }

    def flush(self) -> None:
        """Drain in-flight frames (fused mode) and settle the concurrent back end
        (join any solve thread, consume a pending verification)."""
        if self.fused:
            while self._pending:
                self._consume_fused(self._pending.popleft())
        if self.cfg.enable_loop_closure:
            self.back.finish_async()
            self._emit_loop_attempts(len(self.odometry_poses))

    # -- classic driver -----------------------------------------------------------------

    def _process_classic(self, scan: np.ndarray, stamp: Optional[float]) -> dict:
        t0 = time.perf_counter()
        raw = PointCloud.from_array(scan, capacity=self.cfg.capacity.raw_points)
        filtered = self.prefilter(raw.points, raw.mask)
        filtered.points.block_until_ready()
        t1 = time.perf_counter()

        out = self.front.process(filtered, stamp=stamp)
        t2 = time.perf_counter()

        # Ship any new keyframes to the back end (the /key_frame topic, now a queue).
        while self._kf_consumed < len(self.front.keyframe_log):
            kf = self.front.keyframe_log[self._kf_consumed]
            self.back.add_keyframe(kf)
            self.kf_frame_indices.append(kf["frame_index"])
            self._kf_consumed += 1
        if self.cfg.enable_loop_closure:
            self.back.on_frame()
        self._emit_loop_attempts(len(self.odometry_poses))
        t3 = time.perf_counter()

        self.timings["prefilter"].append(t1 - t0)
        self.timings["register"].append(t2 - t1)
        self.timings["backend"].append(t3 - t2)
        self.odometry_poses.append(out["pose"])
        self.metrics_writer.emit(
            {
                "frame": len(self.odometry_poses) - 1,
                "converged": out["converged"],
                "fitness": out["fitness"],
                "iterations": out["iterations"],
                "is_keyframe": out["is_keyframe"],
                "n_keyframes": self.front.n_keyframes,
                "loops_accepted": sum(1 for l in self.back.loop_log if l["accepted"]),
                "prefilter_ms": 1000 * (t1 - t0),
                "register_ms": 1000 * (t2 - t1),
                "backend_ms": 1000 * (t3 - t2),
            }
        )
        return out

    # -- public API ---------------------------------------------------------------------

    def add_imu(self, stamp: float, angular_velocity, linear_acceleration=None) -> None:
        """Queue an IMU sample (the reference's `callback_imu` slot,
        `lidar_scan_matcher.hpp:64-68`). Works in BOTH drivers: the classic path hands it
        to ScanMatcher; the fused path integrates host-side and feeds (imu_R, True) into
        the fused device step."""
        if self.fused:
            del linear_acceleration
            self._imu_queue.append(
                (float(stamp), np.asarray(angular_velocity, dtype=np.float64))
            )
            if len(self._imu_queue) > 2000:
                self._imu_queue = self._imu_queue[-1000:]
        else:
            self.front.add_imu(stamp, angular_velocity, linear_acceleration)

    def process_scan(self, scan: np.ndarray, stamp: Optional[float] = None) -> dict:
        """Feed one raw sensor-frame scan [n, 3]. In fused mode the returned dict
        describes the PREVIOUS frame (one frame of readback lag); call flush() to drain."""
        if self.fused:
            return self._process_fused(scan, stamp)
        return self._process_classic(scan, stamp)

    def run(self, scans: Iterable, progress_every: int = 0) -> PipelineResult:
        for i, item in enumerate(scans):
            scan = item[0] if isinstance(item, tuple) else item
            self.process_scan(np.asarray(scan))
            if progress_every and (i + 1) % progress_every == 0:
                print(f"[lidar-slam] frame {i + 1}, keyframes={self.back.n_keyframes}, "
                      f"loops={sum(1 for l in self.back.loop_log if l['accepted'])}")
        return self.result()

    def result(self) -> PipelineResult:
        self.flush()
        metrics = {
            name: {
                "mean_ms": 1000 * float(np.mean(ts)) if ts else 0.0,
                "p50_ms": 1000 * float(np.median(ts)) if ts else 0.0,
                "max_ms": 1000 * float(np.max(ts)) if ts else 0.0,
            }
            for name, ts in self.timings.items()
        }
        return PipelineResult(
            odometry_poses=np.stack(self.odometry_poses) if self.odometry_poses else np.zeros((0, 4, 4)),
            keyframe_poses=self.back.optimized_poses(),
            keyframe_frame_indices=np.asarray(self.kf_frame_indices, dtype=np.int64),
            num_loop_closures=sum(1 for l in self.back.loop_log if l["accepted"]),
            loop_log=self.back.loop_log,
            metrics=metrics,
        )

    def save_map(self, path: str, resolution: float = 0.0) -> bool:
        self.flush()
        return self.back.save_map(path, resolution)
