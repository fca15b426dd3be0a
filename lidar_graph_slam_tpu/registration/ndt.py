"""Voxelized Normal Distributions Transform registration (ndt_omp equivalent).

Replaces `pclomp::NormalDistributionsTransform` — the reference front end's default matcher
(`registration_method: "NDT_OMP"`, `lidar_scan_matcher/config/lidar_scan_matcher.param.yaml:4`;
instantiated with DIRECT7 neighbor search, resolution/step/epsilon/max-iteration knobs at
`lidar_scan_matcher/src/lidar_scan_matcher.cpp:55-72`).

Design (data-parallel, not a port):
  * The target voxel-Gaussian map is built once per submap by `ops.voxel.build_ndt_map`
    (on-chip sort + segment reduction) instead of ndt_omp's per-voxel STL containers.
  * Each iteration transforms all source points, gathers the DIRECT7 neighbor Gaussians
    with one dense-table gather, and accumulates 6x6 normal equations with einsums
    that XLA fuses into one reduction — OpenMP's thread pool becomes pure data
    parallelism over the point axis.
  * Optimization is iteratively-reweighted Gauss-Newton on Magnusson's exponential score:
    weight w = -d1 d2 exp(-d2/2 * e^T S^-1 e) per (point, voxel) pair. This shares fixed
    points with ndt_omp's Newton + More-Thuente search while staying positive-definite
    (no line search needed); the twist-norm cap plays the role of the max step length.
  * Convergence (|delta| < transform_epsilon, `param.yaml:12`) freezes the state inside a
    fixed `fori_loop` — XLA-friendly masked early stopping.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.core.config import NdtConfig
from lidar_graph_slam_tpu.ops.voxel import NdtVoxelMap, build_ndt_map, lookup_direct7
from lidar_graph_slam_tpu.registration.base import (
    RegistrationResult,
    cap_step,
    ndt_accumulate_xla,
    solve_damped,
)


def magnusson_constants(resolution: float, outlier_ratio: float):
    """d1/d2 of the NDT mixture score (Magnusson 2009, as parameterized by ndt_omp)."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (resolution ** 3)
    d3 = -jnp.log(c2)
    d1 = -jnp.log(c1 + c2) - d3
    d2 = -2.0 * jnp.log((-jnp.log(c1 * jnp.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


@partial(jax.jit, static_argnames=(
    "max_iterations", "polish_iterations", "line_search"))
def ndt_align(
    vmap: NdtVoxelMap,
    source_points: jax.Array,
    source_mask: jax.Array,
    init_transform: jax.Array,
    step_size: float = 0.1,
    transform_epsilon: float = 0.01,
    outlier_ratio: float = 0.55,
    max_iterations: int = 64,
    polish_iterations: int = 2,
    line_search: bool = False,
) -> RegistrationResult:
    """Align a masked source cloud to an NDT voxel map. Returns source->map transform.

    `line_search=True` adds a backtracking step-length search — the stand-in for
    ndt_omp's Newton + More-Thuente search (`lidar_scan_matcher.cpp:65-70`): each GN
    step is evaluated at alpha in {1, 1/2, 1/4} on the Magnusson score over the
    CURRENT correspondence set (the means/icovs already gathered this iteration — no
    extra DIRECT7 gather, ~2% of the iteration's cost) and the best-scoring scale is
    taken. OFF by default: the IRLS weighting plus the twist-norm cap (`cap_step`)
    already keeps the default pipeline stable (measured: identical trajectories), and
    the data-dependent scale costs a small amount of basin determinism; turn it on for
    aggressive initial guesses (large per-frame motion, loop verification with poor
    priors)."""
    d1, d2 = magnusson_constants(vmap.leaf, outlier_ratio)
    w_scale = -d1 * d2  # > 0: d1 < 0 by construction
    n = source_points.shape[0]

    def body(carry):
        T, done, iters, _fitness, _inliers = carry
        p = se3.transform_points(T, source_points)                   # [N, 3]
        means, icovs, hit = lookup_direct7(vmap, p)                  # [N,7,...]
        valid = hit & source_mask[:, None]
        e = p[:, None, :] - means                                    # [N, 7, 3]

        K = n * 7
        p_rep = jnp.broadcast_to(p[:, None, :], (n, 7, 3))
        H, g, _sum_w, n_hit = ndt_accumulate_xla(
            e.reshape(K, 3), icovs.reshape(K, 3, 3), p_rep.reshape(K, 3),
            valid.reshape(K), d2, w_scale,
        )
        n_inliers = n_hit.astype(jnp.int32)

        delta = solve_damped(H, g, jnp.asarray(1e-6, H.dtype))
        delta = cap_step(delta, step_size)
        if line_search:
            # Backtracking on the fixed-correspondence Magnusson score (higher = more
            # probability mass): evaluate T(alpha) = exp(alpha delta) T against the
            # means/icovs gathered THIS iteration — elementwise only, no re-gather.
            def score_at(alpha):
                pc = se3.transform_points(se3.se3_exp(alpha * delta) @ T, source_points)
                ec = pc[:, None, :] - means
                md2c = jnp.einsum("kni,knij,knj->kn", ec, icovs, ec)
                return jnp.sum(jnp.where(valid, jnp.exp(-0.5 * d2 * md2c), 0.0))

            alphas = jnp.asarray([1.0, 0.5, 0.25], source_points.dtype)
            scores = jax.vmap(score_at)(alphas)
            delta = alphas[jnp.argmax(scores)] * delta
        # Mean squared distance to the matched voxel means (diagnostic fitness).
        d2_center = jnp.sum(e[:, 0, :] ** 2, axis=-1)
        center_valid = valid[:, 0]
        fitness = jnp.sum(jnp.where(center_valid, d2_center, 0.0)) / jnp.maximum(
            jnp.sum(center_valid), 1
        )

        step_ok = jnp.isfinite(delta).all() & (n_inliers > 0)
        delta = jnp.where(step_ok, delta, 0.0)
        T_new = se3.se3_exp(delta) @ T
        newly_done = jnp.linalg.norm(delta) < transform_epsilon
        return T_new, done | newly_done, iters + 1, fitness, n_inliers

    def cond(carry):
        _, done, iters, _, _ = carry
        return jnp.logical_not(done) & (iters < max_iterations)

    init = (
        init_transform.astype(source_points.dtype),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, source_points.dtype),
        jnp.asarray(0, jnp.int32),
    )
    T, done, iters, fitness, inliers = jax.lax.while_loop(cond, body, init)
    # Polish: a few UNCONDITIONAL Gauss-Newton iterations after the early exit. The
    # while_loop's output is quantized by the last step's size (anything below
    # `transform_epsilon` stops it), so an FP-level input difference that flips the
    # iteration count shifts the result by O(epsilon) — enough, fed back through the
    # odometry loop's constant-velocity extrapolation, to destabilize the pipeline at
    # marginal operating points. Two extra contractions drive the output to the basin
    # optimum regardless of where the while stopped, making the result a function of
    # (target, scan) alone rather than of the initial guess's rounding history.
    carry = (T, done, iters, fitness, inliers)
    for _ in range(polish_iterations):
        carry = body(carry)
    T, _, _, fitness, inliers = carry
    # PCL parity (matching icp_align): `hasConverged()` is true whenever the convergence
    # criteria stopped the loop — epsilon OR max-iterations. pclomp NDT accepts a frame
    # that used all 64 iterations (`lidar_scan_matcher.cpp:167-170` only drops on
    # hasConverged()==false); requiring the epsilon stop here dropped such frames. The
    # quality guard is the caller's inlier health gate, not the iteration count.
    converged = (done | (iters >= max_iterations)) & (inliers > 0) & jnp.isfinite(T).all()
    return RegistrationResult(
        transform=T, converged=converged, iterations=iters, fitness=fitness, num_inliers=inliers
    )


def make_ndt_matcher(cfg: NdtConfig, map_capacity: int):
    """Bundle map-build + align closures for the front end's pluggable-matcher slot
    (the reference's registration factory, `lidar_scan_matcher.cpp:27-115`).

    When `cfg.coarse_resolution` > 0 the target is a two-level pyramid and alignment runs
    coarse-then-fine, widening the basin past a single-resolution ndt_omp."""
    use_pyramid = cfg.coarse_resolution > 0.0
    # Integer coarse/fine ratio -> derive the coarse map by merging the fine map's raw
    # voxel moments (one pass over the points instead of two; ops/voxel.py
    # build_ndt_pyramid). Non-integer ratios fall back to two independent builds.
    factor = round(cfg.coarse_resolution / cfg.resolution) if use_pyramid else 0
    fused_pyramid = use_pyramid and factor >= 2 and abs(
        factor * cfg.resolution - cfg.coarse_resolution) < 1e-6

    def build_target(points, mask):
        if fused_pyramid:
            from lidar_graph_slam_tpu.ops.voxel import build_ndt_pyramid

            return build_ndt_pyramid(
                points, mask, jnp.float32(cfg.resolution), factor,
                capacity=map_capacity, coarse_capacity=map_capacity // 2,
            )
        fine = build_ndt_map(points, mask, jnp.float32(cfg.resolution), capacity=map_capacity)
        if not use_pyramid:
            return fine
        coarse = build_ndt_map(
            points, mask, jnp.float32(cfg.coarse_resolution), capacity=map_capacity // 2
        )
        return (coarse, fine)

    def align(target_map, points, mask, init_T):
        if use_pyramid:
            coarse, fine = target_map
            # Coarse stage: larger step bound, strided source subsample, no polish —
            # it only has to land inside the fine stage's convergence basin, and a
            # 2x-coarser voxel map is insensitive to source density. This keeps the
            # pyramid's robustness while paying ~1/subsample of its per-iteration
            # gather+accumulate cost.
            stride = max(int(cfg.coarse_subsample), 1)
            pre = ndt_align(
                coarse,
                points[::stride],
                mask[::stride],
                init_T,
                step_size=cfg.step_size * 4.0,
                transform_epsilon=cfg.transform_epsilon,
                outlier_ratio=cfg.outlier_ratio,
                max_iterations=cfg.coarse_iterations,
                polish_iterations=0,
            )
            init_T = pre.transform
        else:
            fine = target_map
        return ndt_align(
            fine,
            points,
            mask,
            init_T,
            step_size=cfg.step_size,
            transform_epsilon=cfg.transform_epsilon,
            outlier_ratio=cfg.outlier_ratio,
            max_iterations=cfg.max_iterations,
        )

    return build_target, align
