"""Graph-based SLAM back end: keyframe graph, loop closure, global correction, map export.

Re-design of the `graph_based_slam` node (`graph_based_slam/src/
graph_based_slam.cpp`). Behavior reproduced:

  * Keyframe insertion (`key_frame_callback` `:354-406`): prior factor on keyframe 0,
    odometry between-factor per subsequent keyframe (noise sigma^2 = [1e-6 x3, 1e-8, 1e-8,
    1e-6], `:67-69`), estimates tracked incrementally.
  * Loop detection (`optimization_callback` `:238-352`, cadence = `rate` param 1 Hz
    `:71-74`): candidate = nearest keyframe with accumulated-distance gap >=
    `accumulate_distance_threshold` (100 m) and Euclidean distance <
    `search_for_candidate_threshold` (15 m) (`:264-280`); candidate submap = keyframes
    [min_id-20, min_id+20] voxel-filtered at 0.5 m (`:297-313`); ICP verification with
    acceptance iff converged and fitness < `score_threshold` 0.3 (`:315-328`); loop factor
    noise = fitness * I6 (`:335-341`).
  * Global pose adjustment after loop closure (`adjust_pose` `:417-432`) and map assembly
    (`publish_map` `:448-467`) / save-map service (`:469-501`).

Deliberate fixes over the reference (SURVEY.md §7 "hard parts"): the insertion/loop-closure
race behind two different mutexes (`:242` vs `:356`) disappears — one host thread drives
pure device programs; the O(N*points) full-map republish per keyframe becomes an on-demand
assembly. The ICP verifier gets a coarse NDT pre-alignment stage so large drift at loop
time stays inside the grid-NN correspondence radius (the reference relies on a 30 m
correspondence distance instead, `:142-151`).

The dormant detectors of the reference (`detect_loop_with_accum_dist` `:157-187`,
`detect_loop_with_kd_tree` `:189-236`) map onto `detect_loop(mode=...)`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lidar_graph_slam_tpu.core.config import CapacityConfig, GraphSlamConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.graph import solver
from lidar_graph_slam_tpu.io.pcd import write_pcd
from lidar_graph_slam_tpu.ops.neighbors import build_hash_grid
from lidar_graph_slam_tpu.ops.voxel import build_ndt_map, voxel_downsample
from lidar_graph_slam_tpu.registration import icp as icp_mod
from lidar_graph_slam_tpu.registration import ndt as ndt_mod


class _LazyCloud:
    """Deferred keyframe-cloud materialization: holds the fused driver's device
    arrays until someone needs the numpy points (loop submap, map assembly,
    checkpoint). See `GraphBasedSLAM.add_keyframe`."""

    __slots__ = ("_dev", "_mask", "_np")

    def __init__(self, cloud_dev, mask_dev):
        self._dev = cloud_dev
        self._mask = mask_dev
        self._np = None

    def get(self) -> np.ndarray:
        if self._np is None:
            c, m = jax.device_get((self._dev, self._mask))
            self._np = np.asarray(c)[np.asarray(m)].astype(np.float32)
            self._dev = self._mask = None  # release the device buffers
        return self._np


def make_verify_one(cfg: GraphSlamConfig, method: str):
    """Single-candidate loop-verification program: coarse NDT pre-align -> configured
    verifier (`get_registration` factory, `graph_based_slam.cpp:77-155`; default ICP per
    `param.yaml:9`) -> uniform PCL-style fitness (`:320-328`).

    Returned as a plain traceable function so callers pick the batch axes:
    `GraphBasedSLAM` vmaps it over candidates with a shared source cloud;
    `parallel/multi_sequence.py` vmaps EVERY argument to batch across sequences on the
    mesh."""
    # NN grid cell: the configured correspondence distance, capped at 2 m — the NDT
    # pre-align already brings correspondences within ~a cell, so the reference's
    # 30 m default (`graph_based_slam.cpp:146`, which compensates for its identity
    # guess) would only blur the NN search here. Values below 2 m are honored exactly.
    corr_dist = min(cfg.icp.max_correspondence_distance, 2.0)

    def one(grid, pre_map, extra, guess, src_p, src_m, src_covs):
        # Stage 1: coarse NDT pre-align from `guess` — identity (the reference's ICP
        # guess at `:318`) unless the FPFH+RANSAC global init succeeded.
        pre = ndt_mod.ndt_align(
            pre_map, src_p, src_m, guess, step_size=0.4, max_iterations=16,
        )
        # Stage 2: refine with the configured verifier. After the coarse pre-align
        # correspondences sit within ~a cell, so the 7-cell neighborhood suffices
        # (4x fewer gather indices than the 27-cell search).
        if method == "ICP":
            res = icp_mod.icp_align(
                grid, src_p, src_m, pre.transform,
                max_correspondence_distance=corr_dist,
                max_iterations=cfg.icp.max_iterations,
                transform_epsilon=max(cfg.icp.transform_epsilon, 1e-7),
                euclidean_fitness_epsilon=cfg.icp.euclidean_fitness_epsilon,
                bucket_cap=16, neighborhood=7,
            )
        elif method == "GICP":
            from lidar_graph_slam_tpu.registration import gicp as gicp_mod

            res = gicp_mod.gicp_align(
                extra, src_p, src_m, pre.transform, src_covs,
                max_correspondence_distance=cfg.gicp.max_correspondence_distance,
                transform_epsilon=max(cfg.gicp.transform_epsilon, 1e-7),
                max_iterations=cfg.gicp.max_iterations,
            )
        else:  # NDT
            res = ndt_mod.ndt_align(
                extra, src_p, src_m, pre.transform,
                step_size=cfg.ndt.step_size,
                transform_epsilon=cfg.ndt.transform_epsilon,
                outlier_ratio=cfg.ndt.outlier_ratio,
                max_iterations=cfg.ndt.max_iterations,
            )
        # The decision quantity is always the PCL-style fitness score (`:320-328`),
        # computed uniformly so the 0.3 gate means the same thing for every method.
        # The matched-source fraction is the anti-gaming backstop for the "pcl"
        # (matched-only) fitness semantics: a handful of coincidental matches can
        # read arbitrarily low, so too-sparse evidence fails the convergence flag.
        score, frac = icp_mod.fitness_and_match_fraction(
            grid, src_p, src_m, res.transform, max_range=corr_dist,
            bucket_cap=16, neighborhood=7, mode=cfg.fitness_mode,
        )
        ok = res.converged & (frac >= cfg.min_loop_match_fraction)
        return res.transform, score, ok

    return one


class GraphBasedSLAM:
    """Host-side back end. Keyframe clouds are kept host-side (numpy) and shipped to the
    device only for loop verification and map assembly. The pose graph lives twice by
    design: on device (the f32 descent/mesh solvers) and as host f64 mirrors feeding
    the refinement tier with zero per-solve fetches (`_host_view`)."""

    def __init__(self, cfg: GraphSlamConfig, capacity: CapacityConfig,
                 mesh=None, backend_solver: str = "schur", cloud_store=None):
        self.cfg = cfg
        self.capacity = capacity
        # Multi-host keyframe-cloud sharding (`parallel/multihost.py`): with a
        # `HostShardedKeyframeStore`, each host persists only the clouds it owns
        # (round-robin) — the per-host map memory scales 1/n_hosts, the BASELINE.json
        # configs[4] "submap-partitioned graph". Every read (loop submap, latest cloud,
        # map assembly) goes through the store's padded process_allgather; poses and
        # the factor graph stay replicated. All hosts MUST run the same pipeline
        # decisions (SPMD) — guaranteed by feeding every host the same scan stream.
        self.cloud_store = cloud_store
        self.method = cfg.registration_method.upper()
        if self.method not in ("ICP", "GICP", "NDT"):
            raise ValueError(f"unknown loop registration_method {cfg.registration_method!r}")
        # Mesh routing (ParallelConfig): when set, optimize() runs the Schur-distributed
        # (or psum-chain) LM and batched loop verification shards candidates over the mesh.
        self.mesh = mesh
        self.backend_solver = backend_solver
        if mesh is not None and (
            capacity.max_keyframes % mesh.devices.size != 0
            or capacity.max_keyframes // mesh.devices.size < 2
        ):
            # Divisibility AND >= 2 poses per device: the Schur interior elimination
            # indexes U_loc[m-2], so m = 1 would wrap around to a silently wrong solve.
            raise ValueError(
                f"capacity.max_keyframes={capacity.max_keyframes} must be a multiple of "
                f"the mesh size {mesh.devices.size} with at least 2 keyframes per device "
                f"for the Schur domain decomposition"
            )
        self._verify_fn = None
        # Keyframe inserts are deferred and flushed in batches (one dispatch per ~32
        # keyframes instead of one per keyframe — the per-dispatch host overhead is the
        # cost driver, not the insert). `self.graph` (property) flushes on read, so every
        # consumer — loop closure, checkpointing, tests — sees a fully-populated graph.
        self._pending_kf: list = []
        self.graph = solver.init_graph(
            capacity.max_keyframes, capacity.max_loop_factors, cfg.odom_noise_var
        )
        self.kf_clouds: list = []  # [n_i, 3] numpy sensor-frame clouds or _LazyCloud
        self.kf_accum_dist: list[float] = []
        self.kf_stamps: list[Optional[float]] = []  # sensor stamps (None if unstamped)
        self.kf_front_poses: list[np.ndarray] = []  # front-end (odometry) poses
        # Host mirror of the optimized poses. Between optimizations the device poses only
        # change by appends this class itself computes, so every non-loop frame runs with
        # ZERO device reads; the mirror is refreshed with one batched device_get after each
        # optimize() call.
        self._poses_host: list[np.ndarray] = []
        # Host mirrors of the factor data (odometry measurements + loop factors): the
        # f64 refinement tier solves straight from these — a warm re-solve costs ZERO
        # device round trips.
        self._host_odoms: list[np.ndarray] = []
        self._host_loops: list[tuple] = []   # (i, j, Z [4,4], info [6])
        self._host_prior: np.ndarray = np.eye(4, dtype=np.float64)  # anchor for pose 0
        self.loop_log: list[dict] = []
        self.n_keyframes = 0
        self.n_loops = 0
        self._frames_since_loop_check = 0
        self.is_loop_closed = False
        # Concurrent back end: one dispatched-but-unconsumed verification and at most
        # one solve thread in flight (the reference's separate back-end process,
        # without its two-mutex race — SURVEY.md §5.2).
        self._pending_verify = None
        self._solve_thread = None
        self._solve_result = None
        self._solve_error: Optional[BaseException] = None
        # Cross-process collectives (the sharded cloud store's allgathers, any
        # process-spanning mesh program) must be issued in LOCKSTEP by every process;
        # the async back end gates dispatch on worker-thread wall-clock liveness,
        # which diverges across processes (one host's solve finishes before its
        # cadence tick, another's doesn't -> mismatched collectives deadlock). Force
        # the deterministic synchronous path whenever this is a multi-process run.
        self.async_enabled = cfg.async_backend and jax.process_count() == 1
        self._solve_epoch = 0
        # Keyframe indices whose clouds are still device-side (_LazyCloud): drained
        # one per frame once the async copies have had time to land.
        self._lazy_pending: list = []
        # Capacity-overflow flags, surfaced like `VoxelGrid.overflow`: inserts past the
        # fixed device capacities are refused (never silently overwritten) and flagged.
        self.keyframe_overflow = False
        self.loop_overflow = False

    # -- deferred device-graph population ------------------------------------------------

    _FLUSH_BATCH = 32

    @property
    def graph(self) -> solver.PoseGraph:
        """Device pose graph with all pending keyframe inserts applied."""
        self._flush_graph()
        return self._graph

    @graph.setter
    def graph(self, g: solver.PoseGraph) -> None:
        self._graph = g

    def _flush_graph(self) -> None:
        while self._pending_kf:
            chunk = self._pending_kf[: self._FLUSH_BATCH]
            self._pending_kf = self._pending_kf[self._FLUSH_BATCH:]
            B = self._FLUSH_BATCH
            poses = np.zeros((B, 4, 4), np.float32)
            odoms = np.zeros((B, 4, 4), np.float32)
            for i, (p, o) in enumerate(chunk):
                poses[i], odoms[i] = p, o
            self._graph = solver.graph_add_keyframes_batch(
                self._graph, jnp.asarray(poses), jnp.asarray(odoms),
                jnp.asarray(len(chunk), jnp.int32),
            )

    # -- keyframe insertion (§3.3) ------------------------------------------------------

    def add_keyframe(self, kf) -> None:
        """Insert a front-end keyframe record (`core.msgs.KeyFrame` or an equivalent
        mapping with pose, cloud, cloud_mask, accum_distance). At `max_keyframes`
        capacity the insert is refused and `keyframe_overflow` is flagged (the device
        graph would drop the write anyway — this surfaces it)."""
        if self.n_keyframes >= self.capacity.max_keyframes:
            self.keyframe_overflow = True
            return
        pose = np.asarray(kf["pose"], dtype=np.float32)
        if self.n_keyframes == 0:
            odom = np.eye(4, dtype=np.float32)
        else:
            prev = self.kf_front_poses[-1]
            odom = (np.linalg.inv(prev) @ pose).astype(np.float32)
            # Chain the measurement onto the *optimized* previous pose for the estimate:
            # matches iSAM2's behavior of initializing new keys from composed odometry
            # (`graph_based_slam.cpp:365-371`).
            prev_opt = self._poses_host[self.n_keyframes - 1]
            pose = (prev_opt @ odom).astype(np.float32)
        self._pending_kf.append((pose, odom))
        self._host_odoms.append(odom)
        if self.n_keyframes == 0:
            self._host_prior = np.asarray(pose, np.float64)
        if self.cloud_store is not None:
            cloud = np.asarray(kf["cloud"])[np.asarray(kf["cloud_mask"])]
            self.cloud_store.add(
                self.n_keyframes,
                cloud.astype(np.float32) if self.cloud_store.owns(self.n_keyframes)
                else None,
            )
        elif isinstance(kf["cloud"], np.ndarray):
            cloud = np.asarray(kf["cloud"])[np.asarray(kf["cloud_mask"])]
            self.kf_clouds.append(cloud.astype(np.float32))
        else:
            # DEVICE cloud handed over by the fused driver: defer the host copy off
            # the frame-critical path. The driver started copy_to_host_async at
            # dispatch, so by the time `drain_lazy_clouds` (a couple frames later) or
            # a loop attempt materializes it, the bytes are already host-side and the
            # device_get costs ~nothing — the per-frame consume fetch shrinks to
            # scalars (the 0.4 MB payload was riding the blocking fetch every frame).
            self.kf_clouds.append(_LazyCloud(kf["cloud"], kf["cloud_mask"]))
            self._lazy_pending.append(self.n_keyframes)
        self.kf_accum_dist.append(float(kf["accum_distance"]))
        stamp = kf.get("stamp") if hasattr(kf, "get") else None
        self.kf_stamps.append(None if stamp is None else float(stamp))
        self.kf_front_poses.append(np.asarray(kf["pose"], dtype=np.float32))
        self._poses_host.append(pose)
        self.n_keyframes += 1

    # -- loop detection (§3.4 gates) ----------------------------------------------------

    def detect_loop(self, mode: str = "inline") -> Optional[int]:
        """Find a loop candidate for the latest keyframe, or None.

        mode="inline": the active detector (`optimization_callback` `:264-280`) —
          accumulated-distance gap AND Euclidean gate, keep the nearest.
        mode="radius": the dormant kd-tree variant (`detect_loop_with_kd_tree` `:189-236`)
          — radius search with the same accum-dist gate, plus its 30 s temporal gate
          (`:210`, `cfg.temporal_gate_sec`) when keyframes carry stamps.
        mode="accum": the dormant accumulated-distance-only variant
          (`detect_loop_with_accum_dist` `:157-187`) — nearest keyframe past the
          accum-dist gap, no Euclidean gate.
        """
        cands = self.detect_loop_topk(1, mode=mode)
        return cands[0] if cands else None

    def detect_loop_topk(self, k: int, mode: str = "inline") -> list:
        """The k nearest gated candidates, closest first, with successive picks separated
        by at least `search_key_frame_num` keyframes (adjacent candidates share ~the whole
        ±window submap — verifying both buys nothing). k=1 is exactly the reference's
        nearest-candidate detector; k>1 is the batched-recall extension."""
        if self.n_keyframes < 2:
            return []
        latest = self.n_keyframes - 1
        positions = np.stack([T[:3, 3] for T in self._poses_host])
        cur_pos = positions[latest]
        cur_accum = self.kf_accum_dist[latest]
        accum = np.asarray(self.kf_accum_dist[: self.n_keyframes])
        d = np.linalg.norm(positions - cur_pos[None, :], axis=1)

        gate = (cur_accum - accum) >= self.cfg.accumulate_distance_threshold
        if mode == "inline":
            gate &= d < self.cfg.search_for_candidate_threshold
        elif mode == "radius":
            gate &= d < self.cfg.search_radius
            # Temporal gate (`graph_based_slam.cpp:210`): candidates must be at least
            # `temporal_gate_sec` older than the latest keyframe. Unstamped keyframes
            # (stamp None) pass, preserving behavior for stampless datasets.
            cur_stamp = self.kf_stamps[latest]
            if cur_stamp is not None and self.cfg.temporal_gate_sec > 0:
                ages = np.array([
                    np.inf if s is None else cur_stamp - s
                    for s in self.kf_stamps[: self.n_keyframes]
                ])
                gate &= ages > self.cfg.temporal_gate_sec
        elif mode != "accum":
            raise ValueError(f"unknown loop detection mode {mode!r}")
        if not gate.any():
            return []
        order = np.argsort(np.where(gate, d, np.inf))
        chosen: list[int] = []
        min_sep = max(1, self.cfg.search_key_frame_num)
        for idx in order:
            if not gate[idx]:
                break
            if all(abs(int(idx) - c) >= min_sep for c in chosen):
                chosen.append(int(idx))
            if len(chosen) >= k:
                break
        return chosen

    # -- loop verification + factor insertion (§3.4) ------------------------------------

    def _assemble_submap(self, center: int, half_window: int,
                         max_points: Optional[int] = None) -> np.ndarray:
        """Map-frame concat of keyframes [center-w, center+w] under current estimates
        (`graph_based_slam.cpp:297-309`). With a sharded cloud store this is the
        cross-host boundary: one padded allgather ships the remote keyframes.

        With `max_points`, an over-budget submap is UNIFORM-STRIDE subsampled so the
        result still spans the FULL ±window. The r05 at-scale diagnosis found the
        previous behavior (callers head-truncating via `PointCloud.from_array`) kept
        only the window's left edge — ~20 keyframes BEHIND the candidate — so mid-lap
        loop verifications matched the latest scan against a submap that did not
        contain the candidate's area at all (fitness 2.3 at a 0.12 m-accurate
        relative pose; lap-boundary attempts escaped because their windows clip at
        keyframe 0). Density loss is free here: every verify consumer voxel-filters
        the submap to `loop_submap_leaf` anyway."""
        lo = max(0, center - half_window)
        hi = min(self.n_keyframes, center + half_window + 1)
        if self.cloud_store is not None:
            out = self.cloud_store.assemble_submap(
                lo, hi, np.stack(self._poses_host))
        else:
            poses = self._poses_host[lo:hi]
            chunks = []
            for k, T in zip(range(lo, hi), poses):
                pts = self._cloud(k)
                chunks.append(pts @ T[:3, :3].T + T[:3, 3])
            out = np.concatenate(chunks).astype(np.float32)
        if max_points is not None and out.shape[0] > max_points:
            # Evenly-spaced index pick fills the budget EXACTLY (a ceil-stride would
            # under-fill by up to 2x just past the threshold — a discontinuous
            # density drop in the verify target for one extra point).
            idx = np.linspace(0, out.shape[0] - 1, max_points).astype(np.int64)
            out = np.ascontiguousarray(out[idx])
        return out

    def _cloud(self, k: int) -> np.ndarray:
        """Keyframe k's sensor/base-frame cloud (allgathered when sharded — SPMD;
        materialized from the device on first access when lazily stored)."""
        if self.cloud_store is not None:
            return self.cloud_store.get_cloud(k)
        c = self.kf_clouds[k]
        if isinstance(c, _LazyCloud):
            c = c.get()
            self.kf_clouds[k] = c
        return c

    def drain_lazy_clouds(self, max_items: int = 1, min_age: int = 2) -> None:
        """Materialize up to `max_items` pending device-side keyframe clouds that are
        at least `min_age` keyframes old — by then their async device->host copies
        (started at dispatch) have landed, so the device_get is a local read. Called
        once per frame by the pipeline; bounds device-buffer residency to a few
        keyframes without ever putting the payload on the frame-critical path."""
        drained = 0
        while (self._lazy_pending and drained < max_items
               and self._lazy_pending[0] <= self.n_keyframes - min_age):
            self._cloud(self._lazy_pending.pop(0))
            drained += 1

    def _build_verify_fn(self):
        """One jitted program for the whole verification batch: coarse NDT pre-align ->
        configured verifier (`get_registration` factory, `graph_based_slam.cpp:77-155`;
        default ICP per `param.yaml:9`) -> uniform PCL-style fitness (`:320-328`), vmapped
        over the candidate axis. Compiled once per batch size (jit shape cache); with a
        mesh, input shardings fan the candidates out over devices."""
        return jax.jit(jax.vmap(make_verify_one(self.cfg, self.method),
                                in_axes=(0, 0, 0, 0, None, None, None)))

    def try_close_loop(self) -> bool:
        """One SYNCHRONOUS loop-closure attempt for the latest keyframe: verify the
        top-k gated candidates in one batched dispatch, add a factor per accepted
        candidate, then re-optimize once. Returns True if any factor was added. k=1
        (default) is the reference's single-candidate behavior
        (`graph_based_slam.cpp:264-280`). The pipeline's default cadence path is the
        ASYNC split (`begin_loop_attempt`/`poll_async`) — same stages, overlapped with
        front-end frames."""
        pending = self.begin_loop_attempt()
        if pending is None:
            return False
        if not self._consume_verify(pending):
            return False
        self._run_optimize()  # the reference's deferred `adjust_pose`
        # (`graph_based_slam.cpp:417-432`) collapses into the solve's write-back
        self.is_loop_closed = True
        return True

    def _build_verify_inputs(self):
        """Detection + host-side verification-input builds for the latest keyframe.
        Returns None (gated/capacity) or a dict with the per-candidate `batched`
        pytrees, the per-attempt `shared` source arrays, and attempt metadata —
        consumed by `begin_loop_attempt` (dispatch here) or by
        `parallel/multi_sequence.py` (which concatenates inputs across SEQUENCES into
        one mesh-sharded dispatch)."""
        if self.n_loops >= self.capacity.max_loop_factors:
            # Refuse at capacity and surface it (the device graph drops the write;
            # silently corrupting factor L-1 was the round-2 failure mode).
            if not self.loop_overflow:
                self.loop_log.append({
                    "latest": self.n_keyframes - 1, "candidate": -1, "fitness": np.inf,
                    "converged": False, "accepted": False, "overflow": True,
                })
            self.loop_overflow = True
            return None
        cands = self.detect_loop_topk(max(1, self.cfg.loop_topk))
        if not cands:
            return None
        latest = self.n_keyframes - 1

        # Latest keyframe cloud in the map frame under the current estimate (`:246-252`).
        T_latest = self._poses_host[latest]
        src = self._cloud(latest)
        cap = self.capacity.keyframe_points
        if src.shape[0] > cap:
            # Evenly spaced, as in `_assemble_submap`: the cloud is in voxel-key order,
            # so its head is one spatial slab of the scan.
            src = src[np.linspace(0, src.shape[0] - 1, cap).astype(np.int64)]
        src = src @ T_latest[:3, :3].T + T_latest[:3, 3]
        src_cloud = PointCloud.from_array(src, capacity=self.capacity.keyframe_points)
        corr_dist = min(self.cfg.icp.max_correspondence_distance, 2.0)

        # Per-candidate target builds (host loop dispatching jitted builders); the
        # iterative verification itself runs as ONE batched device program below.
        grids, pre_maps, extras, guesses = [], [], [], []
        global_diags: list[dict] = []  # RANSAC family-yield telemetry (use_global_init)
        for cand in cands:
            submap = self._assemble_submap(
                cand, self.cfg.search_key_frame_num,
                max_points=self.capacity.loop_submap_points)
            sub_cloud = PointCloud.from_array(
                submap, capacity=self.capacity.loop_submap_points
            )
            filtered = voxel_downsample(
                sub_cloud.points, sub_cloud.mask, jnp.float32(self.cfg.loop_submap_leaf),
                capacity=self.capacity.loop_submap_points,
            )
            # Stage 0 (optional): FPFH+RANSAC global initial guess — recovers candidates
            # with drift far outside any local verifier's basin (the reference has no
            # counterpart; its identity guess at `:318` relies on a 30 m corr distance).
            guess = jnp.eye(4)
            if self.cfg.use_global_init:
                from lidar_graph_slam_tpu.registration.features import global_register

                gr = self.cfg.global_reg
                T_g, _, g_ok, g_diag = global_register(
                    src_cloud.points, src_cloud.mask, filtered.points, filtered.mask,
                    keypoint_leaf=gr.keypoint_leaf, normal_k=gr.normal_k, fpfh_k=gr.fpfh_k,
                    hypotheses=gr.hypotheses, inlier_threshold=gr.inlier_threshold,
                    min_occupancy=gr.min_occupancy, max_keypoints=gr.max_keypoints,
                    src_viewpoint=T_latest[:3, 3],
                    tgt_viewpoint=self._poses_host[cand][:3, 3],
                    return_diag=True,
                )
                guess = jnp.where(g_ok, T_g, guess)
                gd = jax.device_get(g_diag)
                global_diags.append({
                    "n_3pt_valid": int(gd["n_3pt_valid"]),
                    "n_yaw_valid": int(gd["n_yaw_valid"]),
                    "best_is_yaw": bool(gd["best_is_yaw"]),
                })
            guesses.append(guess)
            grids.append(build_hash_grid(filtered.points, filtered.mask, corr_dist))
            pre_maps.append(build_ndt_map(
                filtered.points, filtered.mask, jnp.float32(4.0),
                capacity=self.capacity.voxel_capacity // 4,
            ))
            if self.method == "GICP":
                from lidar_graph_slam_tpu.registration import gicp as gicp_mod

                extras.append(gicp_mod.build_gicp_target(
                    filtered.points, filtered.mask,
                    self.cfg.gicp.max_correspondence_distance,
                    k=self.cfg.gicp.correspondence_randomness,
                ))
            elif self.method == "NDT":
                extras.append(build_ndt_map(
                    filtered.points, filtered.mask, jnp.float32(self.cfg.ndt.resolution),
                    capacity=self.capacity.voxel_capacity // 4,
                ))
            else:
                extras.append(jnp.zeros((1,), jnp.float32))  # unused lane for ICP

        if self.method == "GICP":
            from lidar_graph_slam_tpu.registration import gicp as gicp_mod

            src_covs, _ = gicp_mod.estimate_covariances(
                src_cloud.points, src_cloud.mask,
                self.cfg.gicp.max_correspondence_distance,
                k=self.cfg.gicp.correspondence_randomness,
            )
        else:
            src_covs = jnp.zeros((1, 3, 3), jnp.float32)

        from lidar_graph_slam_tpu.parallel.distributed import stack_pytrees

        batched = (
            stack_pytrees(grids), stack_pytrees(pre_maps), stack_pytrees(extras),
            jnp.stack(guesses),
        )
        shared = (src_cloud.points, src_cloud.mask, src_covs)
        return {
            "cands": cands, "latest": latest, "T_latest": T_latest,
            "batched": batched, "shared": shared, "global_diags": global_diags,
        }

    def begin_loop_attempt(self):
        """Detect + DISPATCH verification for the latest keyframe; returns an opaque
        pending record (or None if gated/busy). Device->host copies of the verdicts
        start immediately (`copy_to_host_async`), so consuming the record a few frames
        later costs ~nothing — the async analog of the reference's separate-process
        back end (`graph_based_slam.cpp:71-74`, registration `:503-504`)."""
        from lidar_graph_slam_tpu.parallel.distributed import shard_batch

        inp = self._build_verify_inputs()
        if inp is None:
            return None
        batched, shared = inp.pop("batched"), inp.pop("shared")
        if self.mesh is not None:
            batched, shared = shard_batch(self.mesh, batched, shared)
        if self._verify_fn is None:
            self._verify_fn = self._build_verify_fn()
        Ts_d, scores_d, convs_d = self._verify_fn(*batched, *shared)
        for leaf in (Ts_d, scores_d, convs_d):
            if hasattr(leaf, "copy_to_host_async"):
                leaf.copy_to_host_async()
        inp["results"] = (Ts_d, scores_d, convs_d)
        inp["age"] = 0
        return inp

    def _consume_verify(self, pending) -> bool:
        """Read a dispatched verification's verdicts and insert a loop factor per
        accepted candidate (`graph_based_slam.cpp:320-341`). Returns True if any
        factor was added."""
        cands = pending["cands"]
        latest = pending["latest"]
        T_latest = pending["T_latest"]
        global_diags = pending["global_diags"]
        Ts, scores, convs = jax.device_get(pending["results"])

        any_accepted = False
        for b, cand in enumerate(cands):
            fitness = float(scores[b])
            converged = bool(convs[b])
            record = {
                "latest": latest,
                "candidate": cand,
                "fitness": fitness,
                "converged": converged,
                "accepted": False,
                "transform": np.asarray(Ts[b]),  # verifier's map-frame correction
            }
            if global_diags:
                record["ransac_families"] = global_diags[b]
            self.loop_log.append(record)
            if not converged or fitness >= self.cfg.score_threshold:
                continue
            if self.n_loops >= self.capacity.max_loop_factors:
                record["overflow"] = True
                self.loop_overflow = True
                continue
            # Loop factor: corrected latest pose vs candidate pose (`:330-341`).
            # The verifier transform maps current-map-frame latest cloud onto the
            # candidate submap, so the corrected latest pose is T_b @ T_latest.
            T_corrected = np.asarray(Ts[b]) @ T_latest
            T_cand = self._poses_host[cand]
            Z = jnp.asarray(np.linalg.inv(T_corrected) @ T_cand)  # between(latest, cand)
            info = jnp.full((6,), 1.0 / max(fitness, 1e-6), dtype=jnp.float32)
            self.graph = solver.graph_add_loop(
                self.graph, jnp.asarray(latest), jnp.asarray(cand), Z, info
            )
            self._host_loops.append(
                (latest, cand, np.asarray(Z, np.float64), np.asarray(info, np.float64)))
            self.n_loops += 1
            record["accepted"] = True
            any_accepted = True

        return any_accepted

    def _host_view(self):
        """f64 `GraphView` assembled from the HOST factor mirrors — no device fetch."""
        from lidar_graph_slam_tpu.graph import refine64

        n = self.n_keyframes
        if self._host_loops:
            li, lj, lz, linfo = zip(*self._host_loops)
            lz = np.stack(lz)
            linfo = np.stack(linfo)
        else:
            li, lj = (), ()
            lz = np.zeros((0, 4, 4), np.float64)
            linfo = np.zeros((0, 6), np.float64)
        return refine64.GraphView(
            np.stack(self._poses_host), np.stack(self._host_odoms[:n]),
            self._host_prior,
            1.0 / np.asarray(self.cfg.odom_noise_var, np.float64),
            li, lj, lz, linfo,
            robust_delta=self.cfg.loop_robust_delta,
        )

    def _bucket_size(self) -> int:
        """Active-size bucket for the solve: smallest power-of-two >= n_keyframes
        (min 256 so at most ~5 distinct compilations over a run). Solving the sliced
        bucket instead of the full capacity makes solve cost track the LIVE graph —
        at 40 keyframes in a 4096-capacity graph that is a 16x smaller system."""
        b = 256
        while b < self.n_keyframes:
            b *= 2
        if self.mesh is not None:
            n = int(self.mesh.devices.size)
            while b % n or b // n < 2:  # Schur needs divisibility + >=2 poses/device
                b *= 2
        return min(b, self.capacity.max_keyframes)

    def _run_optimize(self) -> None:
        """Global re-solve after factor insertion — the hybrid f64-host + f32-device
        solve (the iSAM2 stand-in, `graph_based_slam.cpp:373-374`):

          1. Host f64 Gauss-Newton refinement (`graph/refine64.py`) from the current
             estimates. A WARM graph (the per-keyframe incremental case) detects
             convergence from its first f64 step and pays one O(K) host iteration —
             no device work at all. Most cold solves (fresh loop factor) also converge
             here: pose graphs are near-linear and f64 GN is quadratic.
          2. Only if f64 GN did not converge in its budget (pathological start), the
             device f32 LM descends first — Schur/psum-distributed over the mesh when
             configured (`ParallelConfig`), single-chip otherwise — and the f64 tail
             then finishes to the true optimum.

        f64 matters here, not a luxury: GTSAM runs double precision throughout
        (`graph_based_slam.hpp:38-46`), and at automotive scale the f32 gradient at
        the optimum is pure storage-rounding noise (refine64.py module docstring).
        The solve operates on the active-size bucket (see `_bucket_size`); poses are
        written back into the full-capacity graph."""
        B = self._bucket_size()
        g = self.graph
        full = g.poses.shape[0]
        if B < full:
            gb = g.replace(
                poses=g.poses[:B], pose_mask=g.pose_mask[:B], odom_meas=g.odom_meas[:B]
            )
        else:
            gb = g
        view = self._host_view()
        poses64, info = solver.escalate_f64(
            view, self._make_device_lm(gb), tail_iterations=6)
        k_act = poses64.shape[0]
        new_poses = g.poses.at[:k_act].set(jnp.asarray(poses64, jnp.float32))
        self.graph = g.replace(poses=new_poses)
        # Host mirror refresh comes from the solve itself — zero device reads.
        p32 = poses64.astype(np.float32)
        self._poses_host = [p32[k] for k in range(k_act)]
        self._solve_epoch += 1

    def _make_device_lm(self, gb):
        """Escalation-ladder device callback: the mesh-distributed (or single-chip)
        jitted f32 LM on the bucketed graph `gb`. Shared by the synchronous
        (`_run_optimize`) and threaded (`_start_solve_async`) paths so the fallback
        cannot drift between them."""

        def device_lm(poses64):
            gd = gb.replace(poses=gb.poses.at[: poses64.shape[0]].set(
                jnp.asarray(poses64, jnp.float32)))
            if self.mesh is not None:
                from lidar_graph_slam_tpu.parallel.distributed import mesh_optimize

                gd = mesh_optimize(
                    self.mesh, gd, max_iterations=30, solver=self.backend_solver)
            else:
                gd = solver.optimize(gd, max_iterations=30)
            return np.asarray(
                jax.device_get(gd.poses), dtype=np.float64)[: poses64.shape[0]]

        return device_lm

    # -- concurrent back end (async verification + threaded solve) ----------------------

    def _start_solve_async(self) -> None:
        """Launch the escalation-ladder solve on a snapshot of the graph in a worker
        thread. The snapshot (`_host_view` builds fresh numpy arrays) is all the thread
        reads; the front end keeps appending keyframes to the mirrors meanwhile —
        `_finish_solve` re-chains those onto the solved poses (the reference's deferred
        `adjust_pose` semantics, `graph_based_slam.cpp:399-402`: corrections land at a
        later keyframe, never mid-stream). numpy BLAS releases the GIL, so the f64
        algebra genuinely overlaps the host's dispatch work."""
        import threading

        view = self._host_view()
        # Bucketed device graph for the (rare) device-LM escalation, built on the main
        # thread; jitted dispatch from the worker thread is supported by JAX.
        B = self._bucket_size()
        g = self.graph
        gb = g if B >= g.poses.shape[0] else g.replace(
            poses=g.poses[:B], pose_mask=g.pose_mask[:B], odom_meas=g.odom_meas[:B])
        device_lm = self._make_device_lm(gb)

        def work():
            # Capture, don't swallow: a bare thread exception would leave
            # `_solve_result` None and crash the harvest with an unrelated
            # TypeError; `_finish_solve` re-raises this with the real traceback.
            try:
                self._solve_result = solver.escalate_f64(
                    view, device_lm, tail_iterations=6)
            except BaseException as e:  # noqa: BLE001 — relayed, not suppressed
                self._solve_error = e

        self._solve_error = None
        self._solve_thread = threading.Thread(target=work, daemon=True)
        self._solve_thread.start()

    def _finish_solve(self) -> None:
        """Join the solve thread and apply its result: solved poses for the snapshot's
        keyframes, composed odometry re-chaining for keyframes appended while it ran."""
        self._solve_thread.join()
        self._solve_thread = None
        if self._solve_error is not None:
            err, self._solve_error = self._solve_error, None
            raise err
        poses64, _info = self._solve_result
        self._solve_result = None
        p32 = poses64.astype(np.float32)
        new_host = [p32[k] for k in range(p32.shape[0])]
        for k in range(len(new_host), self.n_keyframes):
            new_host.append((new_host[k - 1] @ self._host_odoms[k]).astype(np.float32))
        self._poses_host = new_host
        g = self.graph
        self.graph = g.replace(poses=g.poses.at[: len(new_host)].set(
            jnp.asarray(np.stack(new_host))))
        self._solve_epoch += 1
        self.is_loop_closed = True

    def poll_async(self) -> None:
        """Advance the concurrent back end by one frame: harvest a finished solve
        (non-blocking), then consume a lagged verification and kick off its solve."""
        if self._solve_thread is not None and not self._solve_thread.is_alive():
            self._finish_solve()
        if self._pending_verify is not None and self._solve_thread is None:
            self._pending_verify["age"] += 1
            if self._pending_verify["age"] > max(0, self.cfg.loop_verify_lag_frames):
                pending = self._pending_verify
                self._pending_verify = None
                if self._consume_verify(pending):
                    self._start_solve_async()

    def finish_async(self) -> None:
        """Drain the concurrent back end: join any in-flight solve, then consume a
        still-pending verification synchronously. Called by the pipeline's flush so
        results/checkpoints always see a settled graph."""
        if self._solve_thread is not None:
            self._finish_solve()
        if self._pending_verify is not None:
            pending = self._pending_verify
            self._pending_verify = None
            if self._consume_verify(pending):
                self._run_optimize()
                self.is_loop_closed = True

    def on_frame(self) -> bool:
        """Per-frame cadence hook: runs a loop check every `loop_search_period_frames`
        (our deterministic analog of the reference's `rate`-Hz wall timer `:71-74`;
        period <= 0 derives it from `rate` at the nominal 10 Hz sensor).

        With `async_backend` (default; forced off in multi-process runs, where the
        thread-state dispatch gates would desynchronize cross-host collectives — see
        `__init__`) the check only DISPATCHES verification; factors
        land `loop_verify_lag_frames` later and the solve overlaps subsequent frames —
        the reference's concurrent back-end architecture without its mutex race
        (SURVEY.md §5.2). Returns True the frame a solve's corrections were applied."""
        closed_before = self._solve_epoch
        self.drain_lazy_clouds()
        if self.async_enabled:
            self.poll_async()
        period = self.cfg.loop_search_period_frames
        if period <= 0:
            period = max(1, int(round(10.0 / max(self.cfg.rate, 1e-6))))
        self._frames_since_loop_check += 1
        if self._frames_since_loop_check >= period:
            self._frames_since_loop_check = 0
            if not self.async_enabled:
                return self.try_close_loop()
            # Skip the tick while the previous attempt is still in flight — the
            # reference's timer likewise waits on its optimize mutex (`cpp:242`).
            if self._pending_verify is None and self._solve_thread is None:
                self._pending_verify = self.begin_loop_attempt()
        return self._solve_epoch != closed_before

    # -- outputs (§3.3 publish paths + §3.5 save map) -----------------------------------

    def optimized_poses(self) -> np.ndarray:
        if self.n_keyframes == 0:
            return np.zeros((0, 4, 4), dtype=np.float32)
        return np.stack(self._poses_host).astype(np.float32)

    def assemble_map(self, resolution: float = 0.0, max_points: Optional[int] = None) -> np.ndarray:
        """All keyframe clouds under optimized poses; optional voxel filter at `resolution`
        (`save_map_service` `:473-494`).

        Cached per (n_keyframes, n_loops, resolution): poses only change through
        keyframe appends or post-loop optimizes, both of which bump those counters —
        so back-to-back exports (the CLI saves AND renders) assemble once instead of
        re-concatenating every cloud per call (the O(N*pts) pattern SURVEY.md §7
        flagged in the reference's `publish_map`, `graph_based_slam.cpp:448-467`)."""
        if self.n_keyframes == 0:
            return np.zeros((0, 3), dtype=np.float32)
        key = (self.n_keyframes, self.n_loops, self._solve_epoch,
               float(resolution), max_points)
        cached = getattr(self, "_map_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        poses = self.optimized_poses()
        if self.cloud_store is not None:
            pts = self.cloud_store.assemble_submap(0, self.n_keyframes, poses)
        else:
            chunks = [
                self._cloud(k) @ poses[k][:3, :3].T + poses[k][:3, 3]
                for k in range(self.n_keyframes)
            ]
            pts = np.concatenate(chunks).astype(np.float32)
        if resolution > 0.0:
            cap = max_points or pts.shape[0]
            cloud = PointCloud.from_array(pts, capacity=pts.shape[0])
            grid = voxel_downsample(
                cloud.points, cloud.mask, jnp.float32(resolution), capacity=cap
            )
            pts = np.asarray(grid.points)[np.asarray(grid.mask)]
        self._map_cache = (key, pts)
        return pts

    def save_map(self, path: str, resolution: float = 0.0) -> bool:
        """The `/save_map` service (`:469-501`): resolution <= 0 exports the raw map."""
        try:
            pts = self.assemble_map(resolution)
            write_pcd(path, pts)
            return True
        except OSError:
            return False
