"""Pose-graph optimizer: exactness on small hand-checked graphs and loop-closure pullback.

Covers the behavioral contract the reference delegates to GTSAM iSAM2
(`graph_based_slam.cpp:346-349,373-374`): odometry-only graphs reproduce the chain, a loop
factor redistributes accumulated drift, and the prior anchors the gauge.
"""

import numpy as np
import jax.numpy as jnp

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.graph import solver

VAR = (1e-6, 1e-6, 1e-6, 1e-8, 1e-8, 1e-6)


def chain_graph(poses_list, K=16, L=4):
    """Build a graph whose odometry measurements exactly match `poses_list`."""
    g = solver.init_graph(K, L, VAR)
    prev = None
    for p in poses_list:
        p = jnp.asarray(p, jnp.float32)
        meas = jnp.eye(4) if prev is None else se3.between(prev, p)
        g = solver.graph_add_keyframe(g, p, meas)
        prev = p
    return g


def random_walk(rng, n, step=1.0):
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        xi = np.concatenate([rng.normal(size=3) * 0.05, rng.normal(size=3) * step]).astype(np.float32)
        poses.append(np.asarray(poses[-1] @ np.asarray(se3.se3_exp(jnp.asarray(xi)))))
    return poses


def test_consistent_chain_is_fixed_point(rng):
    # Odometry measurements exactly consistent with the poses: optimization must not move them.
    poses = random_walk(rng, 10)
    g = chain_graph(poses)
    out = solver.optimize(g, max_iterations=5)
    np.testing.assert_allclose(np.asarray(out.poses[:10]), np.stack(poses), atol=1e-4)


def test_perturbed_chain_recovers(rng):
    # Keep the measurements, perturb the estimates: solver must restore the chain.
    poses = random_walk(rng, 8)
    g = chain_graph(poses)
    noisy = np.stack(poses).copy()
    for k in range(1, 8):
        xi = np.concatenate([rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.2]).astype(np.float32)
        noisy[k] = noisy[k] @ np.asarray(se3.se3_exp(jnp.asarray(xi)))
    g = g.replace(poses=g.poses.at[:8].set(jnp.asarray(noisy)))
    out = solver.optimize(g, max_iterations=15)
    np.testing.assert_allclose(np.asarray(out.poses[:8]), np.stack(poses), atol=1e-3)


def test_loop_closure_redistributes_drift(rng):
    # Square path returning to start; odometry has a systematic yaw drift; a loop factor
    # (identity between first and last) must pull the endpoints together.
    n = 13
    true_poses = []
    T = np.eye(4, dtype=np.float32)
    for k in range(n):
        true_poses.append(T.copy())
        yaw = np.pi / 2 if (k + 1) % 3 == 0 else 0.0
        step = np.asarray(
            se3.se3_exp(jnp.asarray([0, 0, yaw, 2.0, 0, 0], dtype=jnp.float32))
        )
        T = T @ np.asarray(step)

    # Drifty odometry: each measured step has a small extra yaw. Odometry noise is looser
    # than the loop factor here so the LS optimum actually closes the loop (with the
    # reference's 1e-6/1e-8 odometry variances the optimum legitimately splits the
    # difference by rotating along the chain — tested separately below).
    drift = np.asarray(se3.se3_exp(jnp.asarray([0, 0, 0.015, 0, 0, 0], dtype=jnp.float32)))
    g = solver.init_graph(16, 4, (1e-4,) * 6)
    est = np.eye(4, dtype=np.float32)
    ests = [est.copy()]
    g = solver.graph_add_keyframe(g, jnp.asarray(est), jnp.eye(4))
    for k in range(1, n):
        meas = np.asarray(
            se3.between(jnp.asarray(true_poses[k - 1]), jnp.asarray(true_poses[k]))
        ) @ drift
        est = est @ meas
        ests.append(est.copy())
        g = solver.graph_add_keyframe(g, jnp.asarray(est), jnp.asarray(meas))

    drift_before = np.linalg.norm(ests[-1][:3, 3] - true_poses[-1][:3, 3])
    assert drift_before > 0.3  # the scenario actually drifted

    # Loop factor: measured relative pose between kf0 and kf12 = ground truth.
    Z = se3.between(jnp.asarray(true_poses[0]), jnp.asarray(true_poses[-1]))
    g = solver.graph_add_loop(
        g, jnp.asarray(0), jnp.asarray(n - 1), Z, jnp.full((6,), 1e8, jnp.float32)
    )
    out = solver.optimize(g, max_iterations=20)
    end_err = np.linalg.norm(np.asarray(out.poses[n - 1][:3, 3]) - true_poses[-1][:3, 3])
    assert end_err < 0.05, f"loop closure left {end_err:.3f} m end error ({drift_before:.3f} before)"
    # Prior keeps pose 0 anchored.
    np.testing.assert_allclose(np.asarray(out.poses[0]), np.eye(4), atol=1e-4)
    # Interior poses must also have moved toward truth (drift redistributed, not dumped
    # on the final edge).
    mid_err_before = np.linalg.norm(ests[n // 2][:3, 3] - true_poses[n // 2][:3, 3])
    mid_err_after = np.linalg.norm(
        np.asarray(out.poses[n // 2][:3, 3]) - true_poses[n // 2][:3, 3]
    )
    assert mid_err_after < mid_err_before


def test_reference_weighting_partial_correction(rng):
    # With the reference's own noise model (odometry far stiffer than a loop factor,
    # `graph_based_slam.cpp:67-69` vs `:335-339`), a single loop factor must still reduce
    # the end error — mostly through the cheap rotation dims — without fully closing it.
    n = 13
    true_poses = []
    T = np.eye(4, dtype=np.float32)
    for k in range(n):
        true_poses.append(T.copy())
        yaw = np.pi / 2 if (k + 1) % 3 == 0 else 0.0
        T = T @ np.asarray(se3.se3_exp(jnp.asarray([0, 0, yaw, 2.0, 0, 0], dtype=jnp.float32)))
    drift = np.asarray(se3.se3_exp(jnp.asarray([0, 0, 0.015, 0, 0, 0], dtype=jnp.float32)))
    g = solver.init_graph(16, 4, VAR)
    est = np.eye(4, dtype=np.float32)
    g = solver.graph_add_keyframe(g, jnp.asarray(est), jnp.eye(4))
    for k in range(1, n):
        meas = np.asarray(
            se3.between(jnp.asarray(true_poses[k - 1]), jnp.asarray(true_poses[k]))
        ) @ drift
        est = est @ meas
        g = solver.graph_add_keyframe(g, jnp.asarray(est), jnp.asarray(meas))
    before = np.linalg.norm(est[:3, 3] - true_poses[-1][:3, 3])

    Z = se3.between(jnp.asarray(true_poses[0]), jnp.asarray(true_poses[-1]))
    # fitness ~ 0.1 -> info = 1/fitness * I6 (reference noise = fitness * I6).
    g = solver.graph_add_loop(g, jnp.asarray(0), jnp.asarray(n - 1), Z,
                              jnp.full((6,), 1e4, jnp.float32))
    out = solver.optimize(g, max_iterations=20)
    after = np.linalg.norm(np.asarray(out.poses[n - 1][:3, 3]) - true_poses[-1][:3, 3])
    assert after < 0.5 * before


def test_masked_slots_untouched(rng):
    poses = random_walk(rng, 5)
    g = chain_graph(poses, K=12)
    out = solver.optimize(g, max_iterations=5)
    # Slots >= num_poses stay identity.
    np.testing.assert_allclose(
        np.asarray(out.poses[5:]), np.broadcast_to(np.eye(4), (7, 4, 4)), atol=1e-6
    )


def test_graph_cost_zero_when_consistent(rng):
    poses = random_walk(rng, 6)
    g = chain_graph(poses)
    c = float(solver.graph_cost(g, g.poses))
    assert c < 1e-3


def test_blocked_tridiag_matches_scan(rng):
    """The blocked substructuring solve must agree with the sequential-scan reference
    elimination at K = 2048."""
    K, M = 2048, 13
    D = rng.normal(size=(K, 6, 6)).astype(np.float32)
    D = np.einsum("kij,klj->kil", D, D) + 8 * np.eye(6, dtype=np.float32)
    U = (0.1 * rng.normal(size=(K - 1, 6, 6))).astype(np.float32)
    B = rng.normal(size=(K, 6, M)).astype(np.float32)
    x_blk = solver._tridiag_solve_blocked(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(B))
    x_scan = solver._tridiag_solve_scan(jnp.asarray(D), jnp.asarray(U), jnp.asarray(B))
    np.testing.assert_allclose(
        np.asarray(x_blk), np.asarray(x_scan), rtol=2e-4, atol=2e-4)


def test_tridiag_dispatch_non_multiple_of_64(rng):
    """A K that is neither a power of two nor a multiple of 64 (user-set capacity, e.g.
    3000) must pad inside the dispatched solve rather than assert at trace time."""
    K, M = 2050, 5
    D = rng.normal(size=(K, 6, 6)).astype(np.float32)
    D = np.einsum("kij,klj->kil", D, D) + 8 * np.eye(6, dtype=np.float32)
    U = (0.1 * rng.normal(size=(K - 1, 6, 6))).astype(np.float32)
    B = rng.normal(size=(K, 6, M)).astype(np.float32)
    x = solver._tridiag_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(B))
    x_scan = solver._tridiag_solve_scan(jnp.asarray(D), jnp.asarray(U), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_scan), rtol=2e-4, atol=2e-4)


def test_optimize_non_power_of_two_capacity(rng):
    """optimize() on a 2080-capacity graph (not a power of two, % 64 != 0) traces and
    solves."""
    poses = random_walk(rng, 6)
    g = chain_graph(poses, K=2080)
    out = solver.optimize(g, max_iterations=3)
    assert np.all(np.isfinite(np.asarray(out.poses)))
