"""Shared Gauss-Newton machinery for SE(3) registration solvers.

The reference delegates registration to native engines behind PCL's polymorphic
`pcl::Registration` interface (`setInputSource/setInputTarget/align/getFinalTransformation/
hasConverged/getFitnessScore`, used at `lidar_scan_matcher/src/lidar_scan_matcher.cpp:149,
162-172` and `graph_based_slam/src/graph_based_slam.cpp:315-322`). Here every solver is a
pure jitted function sharing this module's conventions:

  * Pose parametrization: left-multiplicative se(3) perturbation, T <- exp(delta) T, with
    twist ordering (omega, v). The residual Jacobian for a point residual e = T p - q is
    then de/domega = -hat(T p), de/dv = I — no per-iteration re-linearization bookkeeping.
  * Fixed iteration count (`lax.fori_loop`) with masked convergence: once |delta| drops
    below epsilon the state freezes, matching XLA's static-control-flow model instead of
    the reference's data-dependent early exit.
  * Results carry PCL-compatible fields (`converged`, `fitness`) because downstream logic
    gates on them (loop acceptance at `graph_based_slam.cpp:328`, factor noise at
    `:335-339`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.core.struct import pytree_dataclass


@pytree_dataclass
class RegistrationResult:
    transform: jax.Array   # [4, 4] final source->target transform
    converged: jax.Array   # bool — iteration delta dropped below epsilon
    iterations: jax.Array  # int32 — iterations actually used (until convergence)
    fitness: jax.Array     # float — PCL-style mean squared correspondence distance
    num_inliers: jax.Array  # int32 — correspondences contributing to the final step


def point_jacobian_blocks(p_transformed: jax.Array):
    """J = [ -hat(p), I ] (3x6) for residual e = (T p) - q under left perturbation.

    Returned as the [..., 3, 6] matrix, built without materializing hat() per point.
    """
    n = p_transformed.shape[:-1]
    J = jnp.zeros(n + (3, 6), dtype=p_transformed.dtype)
    x, y, z = p_transformed[..., 0], p_transformed[..., 1], p_transformed[..., 2]
    # -hat(p):
    J = J.at[..., 0, 1].set(z).at[..., 0, 2].set(-y)
    J = J.at[..., 1, 0].set(-z).at[..., 1, 2].set(x)
    J = J.at[..., 2, 0].set(y).at[..., 2, 1].set(-x)
    # identity on the translation block:
    J = J.at[..., 0, 3].set(1.0).at[..., 1, 4].set(1.0).at[..., 2, 5].set(1.0)
    return J


def accumulate_normal_equations(J: jax.Array, W: jax.Array, e: jax.Array, weight: jax.Array):
    """Accumulate H = sum w J^T W J and g = sum w J^T W e over the leading axes.

    J: [..., 3, 6], W: [..., 3, 3] (per-residual metric), e: [..., 3], weight: [...].
    Contracted with einsum so XLA fuses the reductions into one pass.
    """
    WJ = jnp.einsum("...ij,...jk->...ik", W, J)
    H = jnp.einsum("...ji,...jk,...->ik", J, WJ, weight)
    g = jnp.einsum("...ji,...jk,...k,...->i", J, W, e, weight)
    return H, g


def ndt_accumulate_xla(e, icovs, p, hit, d2, w_scale):
    """Weighted 6x6 normal-equation accumulation over correspondences — the reduction at
    the core of every NDT/GICP Gauss-Newton iteration (the reference's
    `registration_->align` hot loop, `lidar_scan_matcher.cpp:162-172`), as plain XLA.

    With the analytic blocks of J = [-hat(p) | I] and P = hat(p):

        H_ww = -P W P,  H_wv = P W,  H_vv = W,  g_w = p x (W e),  g_v = W e

    summed over correspondences with weight w = w_scale * exp(-0.5 d2 * e^T W e) * hit.

    e:     [K, 3] residuals (p - mean) per correspondence
    icovs: [K, 3, 3]
    p:     [K, 3] transformed points (Jacobian anchor)
    hit:   [K] bool
    Returns (H [6,6], g [6], sum_w scalar, n_hit scalar).
    """
    md2 = jnp.einsum("ki,kij,kj->k", e, icovs, e)
    w = jnp.where(hit, w_scale * jnp.exp(-0.5 * d2 * md2), 0.0)
    J = point_jacobian_blocks(p)
    H, g = accumulate_normal_equations(J, icovs, e, w)
    return H, g, jnp.sum(w), jnp.sum(hit.astype(jnp.float32))


def solve_damped(H: jax.Array, g: jax.Array, damping: jax.Array) -> jax.Array:
    """Solve (H + damping * diag-scaled I) delta = -g for the 6-dof step."""
    scale = jnp.maximum(jnp.trace(H) / 6.0, 1e-12)
    A = H + damping * scale * jnp.eye(6, dtype=H.dtype)
    return jnp.linalg.solve(A, -g)


def cap_step(delta: jax.Array, max_norm) -> jax.Array:
    """Scale the twist so its norm never exceeds `max_norm` (ndt_omp's line-search step
    bound, `step_size` param at `lidar_scan_matcher/config/lidar_scan_matcher.param.yaml:11`)."""
    norm = jnp.linalg.norm(delta)
    return delta * jnp.minimum(1.0, max_norm / jnp.maximum(norm, 1e-12))
