"""Tests for the f64 host refinement tail (graph/refine64.py) and the hybrid solve.

The reference's GTSAM back end is all-f64 (`graph_based_slam.hpp:38-46`); these tests
pin the properties that tier exists for: exact SE(3) algebra in f64, a tridiagonal
substructuring solve that matches the sequential reference, convergence to the true
optimum from a cold start, and the warm case (re-solve from the optimum) finishing in
one iteration.
"""

import numpy as np
import pytest

from lidar_graph_slam_tpu.graph import refine64


def _rand_spd_tridiag(rng, K, M):
    D = rng.normal(size=(K, 6, 6))
    D = np.einsum("kij,klj->kil", D, D) + 8 * np.eye(6)
    U = 0.1 * rng.normal(size=(K - 1, 6, 6))
    B = rng.normal(size=(K, 6, M))
    return D, U, B


def test_se3_roundtrip():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.7, size=(64, 6))
    T = refine64.se3_exp(xi)
    xi2 = refine64.se3_log(T)
    np.testing.assert_allclose(xi2, xi, atol=1e-12)


def test_se3_inverse_adjoint():
    rng = np.random.default_rng(1)
    xi = rng.normal(scale=0.5, size=(16, 6))
    T = refine64.se3_exp(xi)
    eye = np.broadcast_to(np.eye(4), T.shape)
    np.testing.assert_allclose(T @ refine64.inverse(T), eye, atol=1e-14)
    # Ad(T) xi == log(T exp(xi) T^-1) for small xi.
    small = rng.normal(scale=1e-4, size=(16, 6))
    lhs = (refine64.adjoint(T) @ small[..., None])[..., 0]
    rhs = refine64.se3_log(T @ refine64.se3_exp(small) @ refine64.inverse(T))
    np.testing.assert_allclose(lhs, rhs, atol=1e-9)


@pytest.mark.parametrize("K,M", [(40, 3), (140, 13), (777, 7), (512, 49)])
def test_tridiag_solve_matches_thomas(K, M):
    rng = np.random.default_rng(2)
    D, U, B = _rand_spd_tridiag(rng, K, M)
    x = refine64._tridiag_solve64(D, U, B)
    xb = refine64._thomas64(D, U, B)
    np.testing.assert_allclose(x, xb, rtol=1e-10, atol=1e-10)


def _circle_view(K, L, rng, drift=True):
    """Drifted odometry circle with loop factors measured from ground truth."""
    step = 2 * np.pi / K
    xi_gt = np.tile(np.array([0, 0, step, 1.0, 0, 0], np.float64), (K, 1))
    xi = xi_gt.copy()
    if drift:
        xi[:, :3] += rng.normal(scale=1e-4, size=(K, 3))
        xi[:, 3:] += rng.normal(scale=1e-3, size=(K, 3))
    meas = refine64.se3_exp(xi)
    meas_gt = refine64.se3_exp(xi_gt)
    poses = np.empty((K, 4, 4))
    odoms = np.empty((K, 4, 4))
    gt = np.empty((K, 4, 4))
    T, Tg = np.eye(4), np.eye(4)
    poses[0], odoms[0], gt[0] = T, np.eye(4), Tg
    for k in range(1, K):
        T = T @ meas[k]
        Tg = Tg @ meas_gt[k]
        poses[k], odoms[k], gt[k] = T, meas[k], Tg
    li, lj, lm = [], [], []
    for l in range(L):
        i = (l * K // L) % K
        j = (i + K // 2) % K
        li.append(i)
        lj.append(j)
        lm.append(np.linalg.inv(gt[i]) @ gt[j])
    loop_meas = np.stack(lm).astype(np.float32) if lm else np.zeros((0, 4, 4), np.float32)
    view = refine64.GraphView(
        poses.astype(np.float32), odoms.astype(np.float32), np.eye(4),
        1.0 / np.array([1e-6] * 3 + [1e-8, 1e-8, 1e-6]),
        li, lj, loop_meas, np.full((L, 6), 1e2))
    return view, gt


def test_refine_converges_cold():
    rng = np.random.default_rng(3)
    view, gt = _circle_view(256, 4, rng)
    c0 = refine64.cost(view, view.poses)
    poses, info = refine64.refine(view, max_iterations=10)
    assert info["converged"]
    # The optimum balances drifted odometry against ground-truth loops — cost does not
    # vanish, but the solve must remove the bulk of it.
    assert info["final_cost"] < 0.05 * c0
    # Loop factors measured from ground truth pull the drifted chain back toward it.
    err0 = np.linalg.norm(view.poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    err1 = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err1.max() < 0.5 * err0.max()


def test_refine_warm_single_iteration():
    rng = np.random.default_rng(4)
    view, _ = _circle_view(256, 4, rng)
    poses_opt, _ = refine64.refine(view, max_iterations=10)
    # Warm: restart from the f32-cast optimum — the per-keyframe iSAM2 case.
    view.poses = poses_opt.astype(np.float32).astype(np.float64)
    poses2, info = refine64.refine(view, max_iterations=10)
    assert info["converged"]
    assert info["iterations"] == 1
    assert info["initial_step_norm"] < 2e-3  # f32 storage floor, not a real correction


def test_refine_no_loops():
    rng = np.random.default_rng(5)
    view, _ = _circle_view(64, 0, rng)
    poses, info = refine64.refine(view, max_iterations=10)
    assert info["converged"]
    # Chain + prior only: the optimum is the chained odometry itself.
    chain = np.empty_like(poses)
    T = view.prior_pose.copy()
    chain[0] = T
    for k in range(1, poses.shape[0]):
        T = T @ view.odom_meas[k]
        chain[k] = T
    np.testing.assert_allclose(poses[:, :3, 3], chain[:, :3, 3], atol=1e-5)


def test_solve_incremental_warm_skips_device():
    import jax.numpy as jnp

    from lidar_graph_slam_tpu.graph import solver

    rng = np.random.default_rng(6)
    view, _ = _circle_view(128, 2, rng)
    K = 128
    g = solver.init_graph(256, 8, (1e-6,) * 3 + (1e-8, 1e-8, 1e-6))
    for k in range(K):
        g = solver.graph_add_keyframe(
            g, jnp.asarray(view.poses[k], jnp.float32),
            jnp.asarray(view.odom_meas[k], jnp.float32))
    for l in range(view.loop_i.size):
        g = solver.graph_add_loop(
            g, jnp.asarray(int(view.loop_i[l])), jnp.asarray(int(view.loop_j[l])),
            jnp.asarray(view.loop_meas[l], jnp.float32),
            jnp.asarray(view.loop_info[l], jnp.float32))
    g1, info1 = solver.solve_incremental(g)
    assert info1["converged"]
    g2, info2 = solver.solve_incremental(g1)
    assert info2["converged"]
    assert not info2["device_lm"]
    assert info2["iterations"] == 1
    # Same optimum both times (f32 storage floor apart).
    np.testing.assert_allclose(
        np.asarray(g2.poses[:K, :3, 3]), np.asarray(g1.poses[:K, :3, 3]), atol=1e-3)


def test_solve_incremental_empty_graph():
    from lidar_graph_slam_tpu.graph import solver

    g = solver.init_graph(64, 4, (1e-6,) * 6)
    g2, info = solver.solve_incremental(g)
    assert info["converged"] and info["iterations"] == 0
    np.testing.assert_array_equal(np.asarray(g2.poses), np.asarray(g.poses))


def test_so3_log_matches_scipy_all_angles():
    """The numpy-only quaternion-route so3_log (no scipy dependency)
    must match scipy's rotvec at every angle regime, including near pi."""
    pytest.importorskip("scipy")
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    def unit(v):
        return v / np.linalg.norm(v)

    vecs = [unit(rng.normal(size=3)) * s for s in (1e-9, 1e-5, 0.1, 1.0, 2.0, 3.0)]
    vecs += [np.array([np.pi - 1e-7, 0, 0]), np.array([0, 0, np.pi - 1e-10])]
    for v in vecs:
        R = Rotation.from_rotvec(v).as_matrix()
        got = refine64.so3_log(R[None])[0]
        np.testing.assert_allclose(got, v, atol=1e-9)
    # Batched round-trip through our own exp (norms < pi — beyond that log wraps).
    W = rng.normal(size=(64, 3))
    W = W / np.linalg.norm(W, axis=-1, keepdims=True) * rng.uniform(0.0, 3.1, (64, 1))
    np.testing.assert_allclose(refine64.so3_log(refine64.so3_exp(W)), W, atol=1e-9)
