"""GN inner-loop accumulation (`registration.base.ndt_accumulate_xla`) vs a float64
numpy oracle of the analytic normal-equation blocks."""

import numpy as np
import jax.numpy as jnp

from lidar_graph_slam_tpu.registration.base import ndt_accumulate_xla


def make_inputs(rng, K=1024):
    e = rng.normal(size=(K, 3)).astype(np.float32)
    A = rng.normal(size=(K, 3, 3)).astype(np.float32)
    icovs = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3, dtype=np.float32)
    p = rng.normal(size=(K, 3)).astype(np.float32) * 5.0
    hit = rng.random(K) > 0.3
    return e, icovs, p, hit


def _oracle(e, icovs, p, hit, d2, w_scale):
    """Direct numpy f64 evaluation of the analytic blocks (J = [-hat(p) | I])."""
    e = e.astype(np.float64)
    icovs = icovs.astype(np.float64)
    p = p.astype(np.float64)
    md2 = np.einsum("ki,kij,kj->k", e, icovs, e)
    w = np.where(hit, w_scale * np.exp(-0.5 * d2 * md2), 0.0)
    H = np.zeros((6, 6))
    g = np.zeros(6)
    for k in range(e.shape[0]):
        if w[k] == 0.0:
            continue
        px, py, pz = p[k]
        P = np.array([[0, -pz, py], [pz, 0, -px], [-py, px, 0]])
        J = np.concatenate([-P, np.eye(3)], axis=1)        # [3, 6]
        H += w[k] * J.T @ icovs[k] @ J
        g += w[k] * J.T @ icovs[k] @ e[k]
    return H, g, w.sum(), float(hit.sum())


def test_accumulate_matches_numpy_oracle(rng):
    e, icovs, p, hit = make_inputs(rng, K=512)
    d2, w_scale = 0.25, 1.05
    H, g, sw, nh = ndt_accumulate_xla(
        jnp.asarray(e), jnp.asarray(icovs), jnp.asarray(p), jnp.asarray(hit),
        d2, w_scale)
    Ho, go, swo, nho = _oracle(e, icovs, p, hit, d2, w_scale)
    np.testing.assert_allclose(np.asarray(H), Ho, rtol=2e-4, atol=2e-3)
    # g = sum w J^T W e (solve_damped negates it when forming the step).
    np.testing.assert_allclose(np.asarray(g), go, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(float(sw), swo, rtol=1e-4)
    assert float(nh) == nho


def test_accumulate_all_miss(rng):
    e, icovs, p, hit = make_inputs(rng, K=256)
    H, g, sw, nh = ndt_accumulate_xla(
        jnp.asarray(e), jnp.asarray(icovs), jnp.asarray(p),
        jnp.zeros(256, bool), 0.25, 1.0)
    assert float(nh) == 0.0
    np.testing.assert_allclose(np.asarray(H), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-6)


def test_accumulate_symmetry_psd(rng):
    e, icovs, p, hit = make_inputs(rng)
    H, g, _, _ = ndt_accumulate_xla(
        jnp.asarray(e), jnp.asarray(icovs), jnp.asarray(p), jnp.asarray(hit),
        0.25, 1.0)
    np.testing.assert_allclose(np.asarray(H), np.asarray(H).T, rtol=1e-4, atol=1e-3)
    # H must be PSD (a weighted sum of J^T W J with PSD W).
    w = np.linalg.eigvalsh(np.asarray(H))
    assert w.min() > -1e-2
