"""Loop-closure verifier factory: ICP / GICP / NDT refine stages (`get_registration`,
`graph_based_slam.cpp:77-155`) must each verify a true loop and correct the drifted pose."""

import numpy as np
import pytest

from lidar_graph_slam_tpu.core.config import (
    CapacityConfig,
    GraphSlamConfig,
    IcpConfig,
)
from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu.io.synthetic import make_loop_trajectory, make_world, simulate_scan


def build_loop_backend(method: str, err_yaw: float = 0.03, err_xy=(0.6, -0.4),
                       use_global_init: bool = False):
    cfg = GraphSlamConfig(
        registration_method=method,
        accumulate_distance_threshold=100.0,
        search_for_candidate_threshold=15.0,
        icp=IcpConfig(max_iterations=40),
        use_global_init=use_global_init,
    )
    cap = CapacityConfig(
        max_keyframes=64, max_loop_factors=8, keyframe_points=4096,
        loop_submap_points=65536, voxel_capacity=32768,
    )
    back = GraphBasedSLAM(cfg, cap)

    rng = np.random.default_rng(7)
    world = make_world(rng, extent=40.0, density=2.0)
    n_kf = 31
    traj = make_loop_trajectory(n_kf, radius=20.0, laps=1.02)  # ~128 m circumference
    accum = 0.0
    prev = traj[0]
    # Drifted latest pose: the loop verifier must recover this offset.
    err = np.eye(4, dtype=np.float32)
    yaw = err_yaw
    err[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    err[0, 3] = err_xy[0]
    err[1, 3] = err_xy[1]
    for k in range(n_kf):
        true_pose = traj[k]
        accum += float(np.linalg.norm(true_pose[:3, 3] - prev[:3, 3])) if k else 0.0
        prev = true_pose
        scan = simulate_scan(world, true_pose, rng, max_points=4096, noise=0.01)
        reported = true_pose if k < n_kf - 1 else (true_pose @ err).astype(np.float32)
        back.add_keyframe({
            "pose": reported.astype(np.float32),
            "cloud": scan,
            "cloud_mask": np.ones(scan.shape[0], bool),
            "accum_distance": accum if k < n_kf - 1 else accum + 110.0,
        })
    return back, traj[-1]


@pytest.mark.slow
@pytest.mark.parametrize("method", ["ICP", "GICP", "NDT"])
def test_verifier_closes_and_corrects(method):
    back, true_last = build_loop_backend(method)
    drifted = back.optimized_poses()[-1]
    drift_before = np.linalg.norm(drifted[:3, 3] - true_last[:3, 3])
    assert drift_before > 0.5  # the injected error is visible pre-closure

    assert back.try_close_loop(), f"{method}: loop not accepted ({back.loop_log})"
    rec = back.loop_log[-1]
    assert rec["accepted"] and rec["fitness"] < back.cfg.score_threshold

    # The verifier's measured correction must recover the injected drift: the corrected
    # latest pose (`icp_T @ T_latest`, `graph_based_slam.cpp:330-334`) lands near truth.
    corrected = rec["transform"] @ drifted
    assert np.linalg.norm(corrected[:3, 3] - true_last[:3, 3]) < 0.2, method

    # Global adjustment moves the estimate toward truth (the amount is bounded by the
    # reference's noise model: 30 tight odometry factors vs one fitness-weighted loop).
    drift_after = np.linalg.norm(back.optimized_poses()[-1][:3, 3] - true_last[:3, 3])
    assert drift_after < drift_before - 0.1, (
        f"{method}: drift {drift_before:.3f} -> {drift_after:.3f}"
    )


def test_unknown_method_rejected():
    cfg = GraphSlamConfig(registration_method="VGICP")
    with pytest.raises(ValueError):
        GraphBasedSLAM(cfg, CapacityConfig())


@pytest.mark.slow
def test_global_init_recovers_large_drift():
    """With ~5.8 m / 23 deg of drift the coarse-NDT + ICP stages alone lose the loop; the
    FPFH+RANSAC stage (`GraphSlamConfig.use_global_init`) restores it."""
    big = dict(err_yaw=0.4, err_xy=(4.0, -4.2))
    back_plain, _ = build_loop_backend("ICP", **big)
    back_glob, true_last = build_loop_backend("ICP", use_global_init=True, **big)

    # Capture the drifted baseline BEFORE any try_close_loop: a loop acceptance
    # re-optimizes the poses and would corrupt the correction assertion below.
    drifted = np.asarray(back_plain.optimized_poses()[-1])
    closed_plain = back_plain.try_close_loop()
    closed_glob = back_glob.try_close_loop()
    assert closed_glob, f"global-init verification failed ({back_glob.loop_log})"
    rec = back_glob.loop_log[-1]
    corrected = rec["transform"] @ drifted
    assert np.linalg.norm(corrected[:3, 3] - true_last[:3, 3]) < 0.3
    # The identity-guess path is expected to miss this loop; if it ever starts passing,
    # tighten the drift so this test keeps demonstrating the capability gap.
    assert not closed_plain or rec["fitness"] <= back_plain.loop_log[-1]["fitness"]


@pytest.mark.slow
def test_async_backend_matches_sync():
    """The concurrent back end (dispatch -> lagged consume -> threaded solve) must
    accept the same loop and land on the same optimized poses as the synchronous
    `try_close_loop` (same stages, overlapped)."""
    import time

    back_s, _ = build_loop_backend("ICP")
    back_a, _ = build_loop_backend("ICP")
    assert back_s.try_close_loop()

    pending = back_a.begin_loop_attempt()
    assert pending is not None
    back_a._pending_verify = pending
    for _ in range(500):  # poll: consume after the lag, then harvest the solve thread
        back_a.poll_async()
        if (back_a._pending_verify is None and back_a._solve_thread is None
                and back_a.is_loop_closed):
            break
        time.sleep(0.01)
    back_a.finish_async()

    assert sum(1 for l in back_a.loop_log if l["accepted"]) == 1
    np.testing.assert_allclose(
        back_a.optimized_poses(), back_s.optimized_poses(), atol=1e-4)


def test_async_backend_forced_off_multiprocess(monkeypatch):
    """Multi-process runs must use the deterministic synchronous back end: the async
    path gates cross-process collective dispatch (sharded cloud-store allgathers,
    mesh programs) on worker-thread wall-clock liveness, which diverges between
    processes and would deadlock the collectives."""
    import jax

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    back = GraphBasedSLAM(GraphSlamConfig(async_backend=True), CapacityConfig())
    assert back.async_enabled is False
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    back = GraphBasedSLAM(GraphSlamConfig(async_backend=True), CapacityConfig())
    assert back.async_enabled is True


def test_solve_thread_error_surfaces(monkeypatch):
    """An exception inside the threaded solve must re-raise at harvest with its real
    traceback, not crash later as an unrelated NoneType unpack."""
    from lidar_graph_slam_tpu.graph import slam as slam_mod

    back, _ = build_loop_backend("ICP")

    def boom(view, device_lm, tail_iterations=6):
        raise RuntimeError("solver exploded")

    monkeypatch.setattr(slam_mod.solver, "escalate_f64", boom)
    back._start_solve_async()
    with pytest.raises(RuntimeError, match="solver exploded"):
        back._finish_solve()
    assert back._solve_thread is None and back._solve_error is None


def test_submap_subsamples_to_budget_keeping_full_window():
    """An over-budget loop submap must UNIFORM-STRIDE subsample, never head-truncate:
    the r05 at-scale diagnosis found head-truncation kept only the window's left edge
    (~20 keyframes BEHIND the candidate), so mid-lap verifications matched against a
    submap that did not contain the candidate's area (28 attempts -> 7 accepted)."""
    cap = CapacityConfig(max_keyframes=64, max_loop_factors=8, keyframe_points=4096)
    back = GraphBasedSLAM(GraphSlamConfig(), cap)
    rng = np.random.default_rng(0)
    # 21 keyframes of 4000 points, 2 m apart along +x: window total 84k points.
    for k in range(21):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 2.0 * k
        back.add_keyframe({
            "pose": pose,
            "cloud": rng.normal(scale=0.5, size=(4000, 3)).astype(np.float32),
            "cloud_mask": np.ones(4000, bool),
            "accum_distance": 2.0 * k,
        })
    budget = 20000
    sub = back._assemble_submap(10, 10, max_points=budget)
    assert sub.shape[0] <= budget
    # Full ±window coverage: points near both edges and the center survive.
    xs = sub[:, 0]
    assert xs.min() < 2.0 and xs.max() > 38.0
    for c in (0.0, 20.0, 40.0):
        assert np.sum(np.abs(xs - c) < 2.5) > 100, f"window region {c} m lost"
    # Under budget: untouched (no stride).
    full = back._assemble_submap(10, 10, max_points=10**9)
    assert full.shape[0] == 21 * 4000
