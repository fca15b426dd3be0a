"""Float64 host-side pose-graph refinement — the GTSAM-precision tail of the solve.

The reference back end optimizes entirely in double precision inside GTSAM
(`graph_based_slam/include/graph_based_slam/graph_based_slam.hpp:38-46`). The jitted f32
LM (`graph/solver.py:optimize`) descends well from a cold start, but at automotive scale
f32 hits a measured convergence floor: translations of O(1e2..1e3) m stored in f32 carry
~1e-5..1e-4 m rounding, and with chain information up to 1e8
(`graph_based_slam.cpp:67-69`) the f32 gradient at the optimum is pure noise —
scripts/diag_warm.py shows the K=4096 solver proposing norm-1.1 "steps" FROM its own
optimum that would worsen the cost 76%. No amount of f32 iteration fixes that.

This module finishes the job on the host in float64: vectorized numpy linearization of
the same factors (identical twist ordering and Jacobian series as the device solver),
solved by SEPARATOR-DIRECT domain decomposition (`_solve_separator_direct`, r05): loop
endpoint rows become separators, so loop Hessian blocks land in a small dense separator
system and the interior chain segments eliminate in one batched sweep — no Woodbury
rank-6L bundle (which cost 618 of the 912 ms warm iteration at K=4096/L=64; the
separator solve runs the same iteration in ~54 ms, machine-precision exact). The
blocked-substructuring tridiagonal solve (`_tridiag_solve64`) remains for the loopless
case and small systems. A few genuinely-quadratic Gauss-Newton iterations reach the
true optimum, termination tests become meaningful, and the iSAM2-analog warm case
(`graph_based_slam.cpp:373-374`: two cheap update() calls per keyframe) falls out
naturally — at a converged graph the FIRST f64 step is at the f32-storage floor
(~1e-4), one application of it re-centers the poses, and the solve returns.

Loop factors optionally carry a REDESCENDING robust kernel (`_loop_weights`,
Geman-McClure on the physical residual, IRLS) — the defense the reference's naive
fitness*I6 loop noise lacks (`graph_based_slam.cpp:335-341`).

Why host: the solve is O(K) algebra on 6x6 blocks with a few dozen sequential steps,
which keeps a device busy for microseconds between launches, while the host f64 tier reads
its factors from the back end's host mirrors with no device round trip at all. It also
keeps f64 out of the device programs: `jax_enable_x64` is global to the process, and the
engine's device code is f32 throughout. So the host tier produces the production poses and
the jitted f32 LM is the escalation fallback (`solver.escalate_f64`). Whether one device
f64 solver should replace the two tiers is open (ROADMAP D2).

Division of labor mirrors the reference stack (PCL f32 front end + GTSAM f64 back end):
the device runs every per-point kernel and the f32 LM descent/mesh-distributed solves;
this tail is O(K) host algebra on 6x6 blocks that f32 cannot finish.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


# --- vectorized f64 SE(3) ----------------------------------------------------------------


def hat(w: np.ndarray) -> np.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    out = np.zeros(w.shape[:-1] + (3, 3), np.float64)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    out[..., 0, 1], out[..., 0, 2] = -wz, wy
    out[..., 1, 0], out[..., 1, 2] = wz, -wx
    out[..., 2, 0], out[..., 2, 1] = -wy, wx
    return out


def _sinc_coeffs(theta_sq: np.ndarray):
    theta = np.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-16
    A = np.where(small, 1.0 - theta_sq / 6.0, np.sin(theta) / theta)
    B = np.where(small, 0.5 - theta_sq / 24.0, (1.0 - np.cos(theta)) / theta_sq)
    C = np.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                 (theta - np.sin(theta)) / (theta_sq * theta))
    return A, B, C


def so3_exp(w: np.ndarray) -> np.ndarray:
    theta_sq = np.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return np.eye(3) + A[..., None, None] * W + B[..., None, None] * W2


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y, z), w >= 0.

    Vectorized Shepperd construction: build the quaternion from whichever of
    {w^2, x^2, y^2, z^2} is largest, so the divisor is always >= 1/2 — robust at every
    angle including pi (where the w-only construction loses all digits). Pure numpy:
    scipy used to provide this and was the default solve path's only runtime dependency
    — this keeps the f64 tier dependency-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    # 4q_i^2 candidates (clamped: orthonormal drift can push them epsilon-negative).
    tw = np.maximum(1.0 + m00 + m11 + m22, 0.0)
    tx = np.maximum(1.0 + m00 - m11 - m22, 0.0)
    ty = np.maximum(1.0 - m00 + m11 - m22, 0.0)
    tz = np.maximum(1.0 - m00 - m11 + m22, 0.0)
    qs = np.empty(R.shape[:-2] + (4, 4), np.float64)
    sw = np.sqrt(tw + _EPS * _EPS)
    qs[..., 0, 0] = sw
    qs[..., 0, 1] = (m21 - m12) / sw
    qs[..., 0, 2] = (m02 - m20) / sw
    qs[..., 0, 3] = (m10 - m01) / sw
    sx = np.sqrt(tx + _EPS * _EPS)
    qs[..., 1, 0] = (m21 - m12) / sx
    qs[..., 1, 1] = sx
    qs[..., 1, 2] = (m01 + m10) / sx
    qs[..., 1, 3] = (m02 + m20) / sx
    sy = np.sqrt(ty + _EPS * _EPS)
    qs[..., 2, 0] = (m02 - m20) / sy
    qs[..., 2, 1] = (m01 + m10) / sy
    qs[..., 2, 2] = sy
    qs[..., 2, 3] = (m12 + m21) / sy
    sz = np.sqrt(tz + _EPS * _EPS)
    qs[..., 3, 0] = (m10 - m01) / sz
    qs[..., 3, 1] = (m02 + m20) / sz
    qs[..., 3, 2] = (m12 + m21) / sz
    qs[..., 3, 3] = sz
    pick = np.argmax(np.stack([tw, tx, ty, tz], axis=-1), axis=-1)
    q = np.take_along_axis(qs, pick[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[..., :1] < 0.0, -q, q)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrices -> axis-angle (rotvec), robust at all angles, numpy-only."""
    q = _quat_from_matrix(R)
    w, v = q[..., 0], q[..., 1:]
    s = np.linalg.norm(v, axis=-1)
    angle = 2.0 * np.arctan2(s, w)
    # rotvec = v * angle / s; as s -> 0 the ratio -> 2/w (w -> 1). Series keeps f64
    # accuracy through the switch: angle/s = (2/w) * (1 - s^2/(3 w^2) + ...).
    small = s < 1e-8
    safe_s = np.where(small, 1.0, s)
    scale = np.where(small, 2.0 / np.maximum(w, _EPS), angle / safe_s)
    return v * scale[..., None]


def _left_jacobian(w: np.ndarray) -> np.ndarray:
    theta_sq = np.sum(w * w, axis=-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    return np.eye(3) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _left_jacobian_inv(w: np.ndarray) -> np.ndarray:
    theta_sq = np.sum(w * w, axis=-1)
    theta = np.sqrt(theta_sq + _EPS * _EPS)
    W = hat(w)
    half = 0.5 * theta
    cot_term = np.where(
        theta_sq < 1e-16, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * np.cos(half) / np.maximum(np.sin(half), _EPS))
        / np.maximum(theta_sq, _EPS * _EPS),
    )
    return np.eye(3) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist [..., 6] (omega, v) -> [..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    T = np.zeros(xi.shape[:-1] + (4, 4), np.float64)
    T[..., :3, :3] = so3_exp(w)
    T[..., :3, 3] = (_left_jacobian(w) @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    w = so3_log(T[..., :3, :3])
    v = (_left_jacobian_inv(w) @ T[..., :3, 3:4])[..., 0]
    return np.concatenate([w, v], axis=-1)


def inverse(T: np.ndarray) -> np.ndarray:
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def adjoint(T: np.ndarray) -> np.ndarray:
    """SE(3) adjoint, (omega, v) ordering: [[R, 0], [hat(t) R, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros(T.shape[:-2] + (6, 6), np.float64)
    out[..., :3, :3] = R
    out[..., 3:, 3:] = R
    out[..., 3:, :3] = hat(t) @ R
    return out


def _ad_se3(xi: np.ndarray) -> np.ndarray:
    W = hat(xi[..., :3])
    V = hat(xi[..., 3:])
    out = np.zeros(xi.shape[:-1] + (6, 6), np.float64)
    out[..., :3, :3] = W
    out[..., 3:, 3:] = W
    out[..., 3:, :3] = V
    return out


def _jr_inv(r: np.ndarray) -> np.ndarray:
    """Inverse right Jacobian, same 2nd-order series as the device solver
    (`graph/solver.py:_jr_inv`) — near the optimum r is tiny, so the series error is
    far below the step sizes that matter and the two solvers share fixed points."""
    ad = _ad_se3(r)
    return np.eye(6) + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


def between_residual(Ti, Tj, Z):
    """r = log(Z^-1 Ti^-1 Tj) with Jacobians for right perturbations (f64 mirror of
    `graph/solver.py:between_residual`)."""
    E = inverse(Z) @ inverse(Ti) @ Tj
    r = se3_log(E)
    Jr = _jr_inv(r)
    Jj = Jr
    Ji = -Jr @ adjoint(inverse(Tj) @ Ti)
    return r, Ji, Jj


# --- graph view, cost, assembly ----------------------------------------------------------


class GraphView:
    """Host f64 view of an active pose graph (no padding; arrays sized to the live
    counts). Factors and orderings match `graph/solver.py:PoseGraph`."""

    def __init__(self, poses, odom_meas, prior_pose, odom_info,
                 loop_i, loop_j, loop_meas, loop_info, robust_delta: float = 0.0,
                 prior_rows=None, prior_poses=None, chain_mask=None):
        self.poses = np.asarray(poses, np.float64)            # [K, 4, 4]
        self.odom_meas = np.asarray(odom_meas, np.float64)    # [K, 4, 4] (row 0 unused)
        self.prior_pose = np.asarray(prior_pose, np.float64)  # [4, 4]
        self.odom_info = np.asarray(odom_info, np.float64)    # [6]
        # BLOCK-DIAGONAL extension (parallel/multi_sequence.py solves B independent
        # pose graphs as ONE system): `prior_rows`/`prior_poses` anchor each
        # sub-graph's first pose (default: single prior on row 0), and
        # `chain_mask[k]` (default all True) deactivates the odometry factor
        # k-1 -> k at sub-graph boundaries so sequences stay decoupled.
        if prior_rows is None:
            prior_rows = np.zeros(1, np.int64)
            prior_poses = self.prior_pose[None]
        self.prior_rows = np.asarray(prior_rows, np.int64)      # [P]
        self.prior_poses = np.asarray(prior_poses, np.float64)  # [P, 4, 4]
        self.chain_mask = (np.ones(self.poses.shape[0], bool)
                           if chain_mask is None else np.asarray(chain_mask, bool))
        self.loop_i = np.asarray(loop_i, np.int64)            # [L]
        self.loop_j = np.asarray(loop_j, np.int64)
        self.loop_meas = np.asarray(loop_meas, np.float64)    # [L, 4, 4]
        self.loop_info = np.asarray(loop_info, np.float64)    # [L, 6]
        # Robust-kernel scale [meters] on the PHYSICAL loop residual; 0 = quadratic
        # (exact reference parity — its loop noise is naive fitness*I6,
        # `graph_based_slam.cpp:335-341`, with no robustness at all).
        self.robust_delta = float(robust_delta)

    @classmethod
    def from_device_graph(cls, g, robust_delta: float = 0.0) -> "GraphView":
        """One batched fetch of a `solver.PoseGraph`'s ACTIVE slice."""
        import jax

        (poses, mask, odom, prior, info, li, lj, lm, linfo, lmask, np_, nl) = (
            jax.device_get((g.poses, g.pose_mask, g.odom_meas, g.prior_pose,
                            g.odom_info, g.loop_i, g.loop_j, g.loop_meas,
                            g.loop_info, g.loop_mask, g.num_poses, g.num_loops)))
        K = int(np_)
        keep = np.asarray(lmask[: int(nl)])
        return cls(poses[:K], odom[:K], prior, info,
                   np.asarray(li[: int(nl)])[keep], np.asarray(lj[: int(nl)])[keep],
                   np.asarray(lm[: int(nl)])[keep], np.asarray(linfo[: int(nl)])[keep],
                   robust_delta=robust_delta)

    # Rotation residual weighting for the robust scale: 1 rad of loop disagreement is
    # treated like 5 m (automotive geometry: a 1 rad error swings a 5 m-away point by
    # ~5 m). Only the ROBUST WEIGHT uses this scale; the factor's own information
    # matrix is untouched.
    _ROBUST_ROT_SCALE_M = 5.0

    def _loop_weights(self, poses: np.ndarray) -> np.ndarray:
        """Per-loop-factor Geman-McClure IRLS weights on the PHYSICAL residual
        s = sqrt(|r_trans|^2 + (5 m/rad * |r_rot|)^2):  w = 1 / (1 + (s/delta)^2)^2.

        REDESCENDING by design: a fitness-passing-but-WRONG factor disagrees with the
        odometry chain by 10s-100s of meters, so w ~ (delta/s)^4 -> its pull vanishes
        (Huber was measured insufficient here: its linear tail keeps a constant pull
        that creeps the trajectory toward the poison over accepted LM steps). A
        genuine factor correcting meters of drift sits near delta, keeps useful
        weight, and recovers w -> 1 as IRLS closes its residual. The PHYSICAL scale
        (not the whitened one) makes the outlier decision independent of the
        fitness-derived information, which legitimately spans 1e1..1e6."""
        L = self.loop_i.size
        if not L or self.robust_delta <= 0.0:
            return np.ones((L,), np.float64)
        rl = se3_log(inverse(self.loop_meas)
                     @ inverse(poses[self.loop_i]) @ poses[self.loop_j])
        s2 = (np.sum(rl[:, 3:] ** 2, axis=-1)
              + self._ROBUST_ROT_SCALE_M ** 2 * np.sum(rl[:, :3] ** 2, axis=-1))
        x = s2 / (self.robust_delta ** 2)
        return 1.0 / (1.0 + x) ** 2


def cost(view: GraphView, poses: np.ndarray, loop_weights=None) -> float:
    """Weighted squared residual. `loop_weights` freezes the robust IRLS weights for
    one majorize-minimize round (refine passes the weights its step was built with so
    accept/reject compares the SAME surrogate); None computes them at `poses`."""
    r0 = se3_log(inverse(view.prior_poses) @ poses[view.prior_rows])
    c = float(np.sum(r0 * view.odom_info[None, :] * r0))
    if poses.shape[0] > 1:
        r = se3_log(inverse(view.odom_meas[1:]) @ inverse(poses[:-1]) @ poses[1:])
        m = view.chain_mask[1:].astype(np.float64)
        c += float(np.sum(m[:, None] * r * view.odom_info[None, :] * r))
    if view.loop_i.size:
        rl = se3_log(inverse(view.loop_meas)
                     @ inverse(poses[view.loop_i]) @ poses[view.loop_j])
        w = view._loop_weights(poses) if loop_weights is None else loop_weights
        c += float(np.sum(w * np.sum(rl * view.loop_info * rl, axis=-1)))
    return c


def _assemble_chain(view: GraphView, poses: np.ndarray, damping: float):
    """Chain-part normal system: block-tridiagonal (D [K,6,6], U [K-1,6,6]) and
    gradient b [K,6] from prior + odometry factors (f64 mirror of
    `graph/solver.py:_assemble_chain`)."""
    K = poses.shape[0]
    b = np.zeros((K, 6), np.float64)
    D = np.zeros((K, 6, 6), np.float64)

    # Prior factor(s): one per sub-graph anchor (a single row 0 in the live pipeline).
    r0 = se3_log(inverse(view.prior_poses) @ poses[view.prior_rows])
    J0 = _jr_inv(r0)
    J0W = np.swapaxes(J0, -1, -2) * view.odom_info[None, None, :]
    np.add.at(D, view.prior_rows, J0W @ J0)
    np.subtract.at(b, view.prior_rows, (J0W @ r0[..., None])[..., 0])

    U = np.zeros((max(K - 1, 0), 6, 6), np.float64)
    if K > 1:
        r, Ji, Jj = between_residual(poses[:-1], poses[1:], view.odom_meas[1:])
        m = view.chain_mask[1:].astype(np.float64)[:, None, None]
        JiW = m * np.swapaxes(Ji, -1, -2) * view.odom_info[None, None, :]
        JjW = m * np.swapaxes(Jj, -1, -2) * view.odom_info[None, None, :]
        D[:-1] += JiW @ Ji
        D[1:] += JjW @ Jj
        U = JiW @ Jj                                      # block (k-1, k)
        b[:-1] -= (JiW @ r[..., None])[..., 0]
        b[1:] -= (JjW @ r[..., None])[..., 0]

    D += damping * np.eye(6)[None]
    return D, U, b


class SparseV:
    """Block-sparse whitened Woodbury columns V [6K, 6L]: column group l is supported
    on block rows loop_i[l] and loop_j[l] only. Stored as 2L (row, block) pairs —
    dense V products were the profile's top term at L = 64 (a [6K, 6L] GEMM per
    iteration); with the block form every V product is O(L) small matmuls."""

    def __init__(self, K: int, L: int, rows: np.ndarray, lidx: np.ndarray,
                 blocks: np.ndarray):
        self.K, self.L = K, L
        self.rows = rows        # [2L] block-row ids
        self.lidx = lidx        # [2L] column-group (loop) ids
        self.blocks = blocks    # [2L, 6, 6]

    def dense_rhs(self, dtype=np.float64) -> np.ndarray:
        """Materialize as [K, 6, 6L] right-hand-side bundle for the tridiagonal solve."""
        V = np.zeros((self.K, 6, self.L, 6), dtype)
        np.add.at(V, (self.rows, slice(None), self.lidx), self.blocks)
        return V.reshape(self.K, 6, 6 * self.L)

    def t_apply(self, X: np.ndarray) -> np.ndarray:
        """V^T X for X [K, 6, M] -> [6L, M] (gather at loop rows, tiny batched GEMMs)."""
        g = np.swapaxes(self.blocks, -1, -2) @ X[self.rows]      # [2L, 6, M]
        out = np.zeros((self.L, 6, X.shape[-1]))
        np.add.at(out, self.lidx, g)
        return out.reshape(6 * self.L, X.shape[-1])


def _loop_terms(view: GraphView, poses: np.ndarray, loop_weights=None):
    """Loop-factor gradient contribution b_loop [K,6] and block-sparse whitened
    Woodbury columns (f64 mirror of `graph/solver.py:loop_gradient_and_whitened_columns`).
    `loop_weights`: frozen robust IRLS weights (see `cost`)."""
    K = poses.shape[0]
    L = view.loop_i.size
    b_loop = np.zeros((K, 6), np.float64)
    if not L:
        return b_loop, SparseV(K, 0, np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros((0, 6, 6)))
    rl, Jli, Jlj = between_residual(poses[view.loop_i], poses[view.loop_j],
                                    view.loop_meas)
    # Robust IRLS: scale each factor's information by its current robust weight.
    w = view._loop_weights(poses) if loop_weights is None else loop_weights
    info_eff = view.loop_info * w[:, None]
    JiW = np.swapaxes(Jli, -1, -2) * info_eff[:, None, :]
    JjW = np.swapaxes(Jlj, -1, -2) * info_eff[:, None, :]
    np.subtract.at(b_loop, view.loop_i, (JiW @ rl[..., None])[..., 0])
    np.subtract.at(b_loop, view.loop_j, (JjW @ rl[..., None])[..., 0])
    sqrt_info = np.sqrt(info_eff)                         # [L, 6]
    JiS = np.swapaxes(Jli, -1, -2) * sqrt_info[:, None, :]
    JjS = np.swapaxes(Jlj, -1, -2) * sqrt_info[:, None, :]
    rows = np.concatenate([view.loop_i, view.loop_j])
    lidx = np.concatenate([np.arange(L), np.arange(L)])
    blocks = np.concatenate([JiS, JjS], axis=0)
    return b_loop, SparseV(K, L, rows, lidx, blocks)


def _thomas64(D: np.ndarray, U: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Sequential block-Thomas solve (forward elimination + back substitution) for a
    symmetric block-tridiagonal system. D [K,6,6], U [K-1,6,6] (= H[k,k+1]),
    B [K,6,M] -> x [K,6,M]. Python-loop over K steps — used only for small K and the
    substructured separator system."""
    K = D.shape[0]
    M = B.shape[-1]
    dt = D.dtype
    S = np.empty_like(D)
    Y = np.empty_like(B)
    G = np.empty((max(K - 1, 0), 6, 6), dt)
    S[0], Y[0] = D[0], B[0]
    for k in range(1, K):
        Gk = np.linalg.solve(S[k - 1], U[k - 1])       # S_{k-1}^{-1} U_{k-1}
        G[k - 1] = Gk
        S[k] = D[k] - U[k - 1].T @ Gk
        Y[k] = B[k] - Gk.T @ Y[k - 1]
    x = np.empty((K, 6, M), dt)
    x[K - 1] = np.linalg.solve(S[K - 1], Y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = np.linalg.solve(S[k], Y[k]) - G[k] @ x[k + 1]
    return x


def _tridiag_solve64(D: np.ndarray, U: np.ndarray, B: np.ndarray, seg: int = 64) -> np.ndarray:
    """Blocked substructuring solve — the f64 numpy port of
    `graph/solver.py:_tridiag_solve_blocked` (same elimination identities; vmap becomes
    numpy batching). Splits the K chain into S = ceil(K/seg) segments, eliminates all
    interiors with seg batched [S,6,6]-shaped steps (turning LAPACK's per-RHS band
    sweeps into level-3 BLAS — the 385-RHS Woodbury bundle at K = 4096 drops ~8x vs
    `cho_solve_banded`), condenses onto the S-block separator system, and solves that
    with the sequential Thomas recursion."""
    K = D.shape[0]
    M = B.shape[-1]
    dt = D.dtype
    if K <= 2 * seg:
        return _thomas64(D, U, B)
    S = -(-K // seg)
    Kp = S * seg
    if Kp != K:
        pad = Kp - K
        D = np.concatenate([D, np.tile(np.eye(6, dtype=dt)[None], (pad, 1, 1))], axis=0)
        U = np.concatenate([U, np.zeros((pad + 1, 6, 6), dt)], axis=0)  # U has K-1 rows
        U[K - 1] = 0.0  # decouple the identity padding from the real system
        B = np.concatenate([B, np.zeros((pad, 6, M), dt)], axis=0)
    else:
        U = np.concatenate([U, np.zeros((1, 6, 6), dt)], axis=0)

    D_s = D.reshape(S, seg, 6, 6)
    B_s = B.reshape(S, seg, 6, M)
    U_s = U.reshape(S, seg, 6, 6)
    U_prev_last = np.concatenate([np.zeros((1, 6, 6), dt), U_s[:-1, seg - 1]], axis=0)
    U_last_int = U_s[:, seg - 2]

    # Interior elimination, batched over segments. STEP-MAJOR layout ([seg-1, S, ...]):
    # every per-step operand is one contiguous leading-index slice — strided [:, k]
    # views here made numpy's matmul fall off its BLAS fast path (measured 30x).
    Mi = M + 12
    rhs = np.zeros((seg - 1, S, 6, Mi), dt)
    rhs[..., :M] = np.swapaxes(B_s[:, : seg - 1], 0, 1)
    rhs[0, :, :, M:M + 6] = np.swapaxes(U_prev_last, -1, -2)
    rhs[seg - 2, :, :, M + 6:] = U_last_int
    Dint = np.ascontiguousarray(np.swapaxes(D_s[:, : seg - 1], 0, 1))
    Uint = np.ascontiguousarray(np.swapaxes(U_s[:, : seg - 2], 0, 1))
    Sf = np.empty((seg - 1, S, 6, 6), dt)
    Yf = np.empty((seg - 1, S, 6, Mi), dt)
    Gf = np.empty((max(seg - 2, 0), S, 6, 6), dt)
    Sf[0], Yf[0] = Dint[0], rhs[0]
    # NOTE the explicit temporaries: `X[k] = a - b @ c` (expression stored straight
    # into the slice) hits a numpy slow path ~20x the temp-then-store form (measured).
    for k in range(1, seg - 1):
        Gk = np.linalg.solve(Sf[k - 1], Uint[k - 1])
        Gf[k - 1] = Gk
        t_s = np.swapaxes(Uint[k - 1], -1, -2) @ Gk
        Sf[k] = Dint[k] - t_s
        t_y = np.matmul(np.swapaxes(Gk, -1, -2), Yf[k - 1])
        np.subtract(rhs[k], t_y, out=t_y)
        Yf[k] = t_y
    sol = np.empty((seg - 1, S, 6, Mi), dt)
    sol[seg - 2] = np.linalg.solve(Sf[seg - 2], Yf[seg - 2])
    for k in range(seg - 3, -1, -1):
        t_v = np.linalg.solve(Sf[k], Yf[k])
        t_g = np.matmul(Gf[k], sol[k + 1])
        np.subtract(t_v, t_g, out=t_v)
        sol[k] = t_v
    sol = np.swapaxes(sol, 0, 1)                                  # back to [S, seg-1, ...]
    y = sol[..., :M]
    W_C = np.ascontiguousarray(sol[..., M:M + 6])   # contiguous: they feed broadcast
    W_B = np.ascontiguousarray(sol[..., M + 6:])    # matmuls below (strided is ~20x)

    Ct = U_prev_last
    Bt = np.swapaxes(U_last_int, -1, -2)
    CtW_C = Ct @ W_C[:, 0]
    CtW_B = Ct @ W_B[:, 0]
    Cty = Ct @ y[:, 0]
    BtW_B = Bt @ W_B[:, seg - 2]
    Bty = Bt @ y[:, seg - 2]

    S_diag = D_s[:, seg - 1] - BtW_B
    S_diag[:-1] -= CtW_C[1:]
    S_off = -CtW_B[1:]
    S_rhs = B_s[:, seg - 1] - Bty
    S_rhs[:-1] -= Cty[1:]
    x_sep = _thomas64(S_diag, S_off, S_rhs)                       # [S, 6, M]

    x_prev = np.concatenate([np.zeros((1, 6, M), dt), x_sep[:-1]], axis=0)
    t_c = np.matmul(W_C, x_prev[:, None])
    t_b = np.matmul(W_B, x_sep[:, None])
    x_int = np.ascontiguousarray(y)
    np.subtract(x_int, t_c, out=x_int)
    np.subtract(x_int, t_b, out=x_int)
    out = np.concatenate([x_int, x_sep[:, None]], axis=1).reshape(Kp, 6, M)
    return out[:K]


def _solve_chain_plus_loops(D, U, b_chain, b_loop, V: SparseV):
    """delta = H^-1 b with H = T + V V^T (T block-tridiagonal chain, V the loop
    factors). Two exact direct strategies:

      * K >= 192: SEPARATOR-DIRECT domain decomposition (`_solve_separator_direct`) —
        loop endpoints become separators, so loop Hessian blocks land directly in a
        small dense separator system and the Woodbury 6L-RHS bundle disappears.
        Profiled at K=4096/L=64: the Woodbury bundle's 385-RHS tridiagonal solve was
        618 ms of the 912 ms warm iteration; the separator solve does the same work
        as a 13-RHS batched elimination + one ~1000^2 dense Cholesky-class solve.
      * small K: the Woodbury identity over the substructured tridiagonal solve
        (cheap enough; avoids separator bookkeeping on tiny systems).
    """
    b = (b_chain + b_loop)[..., None]
    if V.L == 0:
        return _tridiag_solve64(D, U, b)[..., 0]
    K = D.shape[0]
    if K >= 192:
        Bi = V.blocks[: V.L]                       # Ji^T sqrt(Lambda)
        Bj = V.blocks[V.L:]
        Hii = Bi @ np.swapaxes(Bi, -1, -2)
        Hij = Bi @ np.swapaxes(Bj, -1, -2)
        Hjj = Bj @ np.swapaxes(Bj, -1, -2)
        return _solve_separator_direct(
            D, U, b[..., 0], V.rows[: V.L], V.rows[V.L:], Hii, Hij, Hjj)
    # The whole bundle stays f64: the chain system's condition reaches ~1e8 (info 1e8
    # over a long chain), so an f32 T-solve has NO correct digits (tried: the refined
    # step exploded to 1e4). Everything here is O(K) host BLAS; f64 is the point.
    rhs = np.concatenate([b, V.dense_rhs()], axis=-1)
    sol = _tridiag_solve64(D, U, rhs)
    Tinv_b = sol[..., :1]                                   # [K, 6, 1]
    Tinv_V = sol[..., 1:]                                   # [K, 6, 6L]
    small = np.eye(6 * V.L) + V.t_apply(Tinv_V)
    z = np.linalg.solve(small, V.t_apply(Tinv_b)[:, 0])
    return Tinv_b[..., 0] - Tinv_V @ z


def _solve_separator_direct(D, U, b, loop_i, loop_j, Hii, Hij, Hjj,
                            max_run: int = 256):
    """Exact direct solve of (T + H_loops) x = b by domain decomposition with the loop
    ENDPOINT rows as separators.

    Every loop factor's Hessian blocks (Hii at (i,i), Hij at (i,j), Hjj at (j,j)) touch
    only separator rows, so they add straight into the dense separator system — no
    Woodbury rank-6L bundle. Interior runs (the chain segments between separators) are
    eliminated by ONE batched forward/backward sweep over a [n_runs, max_len] padded
    layout (13 columns: rhs + left/right separator couplings), condensing onto an
    [Ns*6]^2 dense system (Ns ~ 2L + K/max_run — ~1000^2 at production scale, trivial
    for LAPACK). Forced splits cap the padded run length at `max_run` so the
    sequential sweep depth stays bounded when L is small.

    This is the single-host f64 mirror of the mesh Schur decomposition
    (`parallel/schur.py`) with data-dependent separator placement."""
    K = D.shape[0]
    dt = D.dtype

    sep = np.unique(np.concatenate([np.asarray(loop_i), np.asarray(loop_j)]))
    # Forced splits: cap interior run length (bounds the sequential sweep depth).
    bounds = np.concatenate([[-1], sep, [K]])
    extra = []
    for a, e in zip(bounds[:-1], bounds[1:]):
        gap = int(e - a - 1)
        if gap > max_run:
            n_splits = (gap + max_run - 1) // max_run - 1
            for t in range(1, n_splits + 1):
                extra.append(int(a + t * (gap + 1) // (n_splits + 1)))
    if extra:
        sep = np.unique(np.concatenate([sep, np.asarray(extra, np.int64)]))
    Ns = sep.size

    # Runs r = 0..Ns: rows (sep[r-1]+1 .. sep[r]-1), with virtual bounds -1 and K.
    lo = np.concatenate([[0], sep + 1])
    hi = np.concatenate([sep - 1, [K - 1]])
    lens = hi - lo + 1
    live = np.nonzero(lens > 0)[0]
    R = live.size
    Lmax = int(lens[live].max()) if R else 0

    Hd = np.zeros((Ns, Ns, 6, 6), dt)
    idx = np.arange(Ns)
    Hd[idx, idx] = D[sep]
    bs = b[sep].copy()
    # Adjacent separators (empty run between): direct chain coupling U[sep[p]].
    adj = np.nonzero(sep[1:] == sep[:-1] + 1)[0]
    Hd[adj, adj + 1] += U[sep[adj]]
    Hd[adj + 1, adj] += np.swapaxes(U[sep[adj]], -1, -2)

    x_int_store = None
    if R:
        # Padded gather of the live runs (identity-D / zero-U decouples the padding).
        D_p = np.tile(np.eye(6, dtype=dt), (R, Lmax, 1, 1))
        U_p = np.zeros((R, Lmax, 6, 6), dt)     # U_p[:, k] couples local k -> k+1
        rhs = np.zeros((R, Lmax, 6, 13), dt)
        has_L = lo[live] > 0
        has_R = hi[live] < K - 1
        for ridx, r in enumerate(live):
            a, e = int(lo[r]), int(hi[r])
            n = e - a + 1
            D_p[ridx, :n] = D[a:e + 1]
            if n > 1:
                U_p[ridx, :n - 1] = U[a:e]
            rhs[ridx, :n, :, 0] = b[a:e + 1]
            if has_L[ridx]:
                rhs[ridx, 0, :, 1:7] = U[a - 1].T
            if has_R[ridx]:
                rhs[ridx, n - 1, :, 7:13] = U[e]
        # Step-major batched Thomas sweep (layout note in `_tridiag_solve64`).
        D_s = np.ascontiguousarray(D_p.swapaxes(0, 1))
        U_s = np.ascontiguousarray(U_p.swapaxes(0, 1))
        r_s = np.ascontiguousarray(rhs.swapaxes(0, 1))
        Sf = np.empty((Lmax, R, 6, 6), dt)
        Yf = np.empty((Lmax, R, 6, 13), dt)
        Gf = np.empty((max(Lmax - 1, 0), R, 6, 6), dt)
        Sf[0], Yf[0] = D_s[0], r_s[0]
        for k in range(1, Lmax):
            Gk = np.linalg.solve(Sf[k - 1], U_s[k - 1])
            Gf[k - 1] = Gk
            t_s = np.swapaxes(U_s[k - 1], -1, -2) @ Gk
            Sf[k] = D_s[k] - t_s
            t_y = np.matmul(np.swapaxes(Gk, -1, -2), Yf[k - 1])
            np.subtract(r_s[k], t_y, out=t_y)
            Yf[k] = t_y
        X = np.empty((Lmax, R, 6, 13), dt)
        X[Lmax - 1] = np.linalg.solve(Sf[Lmax - 1], Yf[Lmax - 1])
        for k in range(Lmax - 2, -1, -1):
            t_v = np.linalg.solve(Sf[k], Yf[k])
            t_g = np.matmul(Gf[k], X[k + 1])
            np.subtract(t_v, t_g, out=t_v)
            X[k] = t_v
        X = X.swapaxes(0, 1)                             # [R, Lmax, 6, 13]
        y = X[..., 0]                                    # [R, Lmax, 6]
        XL = X[..., 1:7]
        XR = X[..., 7:13]
        last = lens[live] - 1
        y_last = y[np.arange(R), last]                   # [R, 6]
        XL_last = XL[np.arange(R), last]
        XR_last = XR[np.arange(R), last]

        # Schur contributions onto the separator system.
        for ridx, r in enumerate(live):
            pL, pR = r - 1, r                             # separator indices
            if has_L[ridx]:
                UL = U[int(lo[r]) - 1]
                Hd[pL, pL] -= UL @ XL[ridx, 0]
                bs[pL] -= UL @ y[ridx, 0]
            if has_R[ridx]:
                UR_T = U[int(hi[r])].T
                Hd[pR, pR] -= UR_T @ XR_last[ridx]
                bs[pR] -= UR_T @ y_last[ridx]
            if has_L[ridx] and has_R[ridx]:
                cross = U[int(lo[r]) - 1] @ XR[ridx, 0]
                Hd[pL, pR] -= cross
                Hd[pR, pL] -= cross.T
        x_int_store = (y, XL, XR, has_L, has_R)

    # Loop Hessian blocks land directly on separator rows.
    pi = np.searchsorted(sep, np.asarray(loop_i))
    pj = np.searchsorted(sep, np.asarray(loop_j))
    np.add.at(Hd, (pi, pi), Hii)
    np.add.at(Hd, (pj, pj), Hjj)
    np.add.at(Hd, (pi, pj), Hij)
    np.add.at(Hd, (pj, pi), np.swapaxes(Hij, -1, -2))

    M = Hd.transpose(0, 2, 1, 3).reshape(6 * Ns, 6 * Ns)
    x_sep = np.linalg.solve(M, bs.reshape(-1)).reshape(Ns, 6)

    delta = np.empty((K, 6), dt)
    delta[sep] = x_sep
    if R:
        y, XL, XR, has_L, has_R = x_int_store
        xL_vec = np.zeros((R, 6), dt)
        xR_vec = np.zeros((R, 6), dt)
        xL_vec[has_L] = x_sep[live[has_L] - 1]
        xR_vec[has_R] = x_sep[live[has_R]]
        x_runs = y - (XL @ xL_vec[:, None, :, None])[..., 0] \
                   - (XR @ xR_vec[:, None, :, None])[..., 0]
        for ridx, r in enumerate(live):
            a, e = int(lo[r]), int(hi[r])
            delta[a:e + 1] = x_runs[ridx, : e - a + 1]
    return delta


def refine(view: GraphView, max_iterations: int = 8, damping: float = 1e-9,
           step_tolerance: float = 1e-8, floor_tolerance: float = 2e-3):
    """Gauss-Newton (lightly damped) in f64 from `view.poses`.

    Returns (poses [K,4,4] f64, info dict). info["initial_step_norm"] is the first
    proposed step's max twist norm — the warm-detection signal: when it is below
    `floor_tolerance` the graph was already converged up to the f32 storage floor; the
    step is applied (it is genuine — it re-centers the f32-rounded poses onto the f64
    optimum) and the solve returns after that single iteration.
    """
    poses = view.poses.copy()
    c0 = cost(view, poses)
    info = {"iterations": 0, "initial_step_norm": None, "converged": False,
            "final_cost": c0}
    lam = damping
    for it in range(max_iterations):
        # One majorize-minimize round: freeze the robust IRLS weights at the current
        # iterate — the GN step, c0, and the candidate's cost all use the SAME
        # quadratic surrogate, so accept/reject is consistent (recomputing weights
        # inside the accept test was measured to let adversarial factors creep the
        # trajectory through tiny "descents" of a shifting objective).
        w_loops = view._loop_weights(poses)
        c0 = cost(view, poses, loop_weights=w_loops)
        D, U, b_chain = _assemble_chain(view, poses, lam)
        b_loop, Vw = _loop_terms(view, poses, loop_weights=w_loops)
        try:
            delta = _solve_chain_plus_loops(D, U, b_chain, b_loop, Vw)
        except np.linalg.LinAlgError:  # not SPD — raise damping, retry next iter
            lam = max(lam * 1e3, 1e-6)
            continue
        if not np.all(np.isfinite(delta)):
            lam = max(lam * 1e3, 1e-6)
            continue
        step_norm = float(np.max(np.linalg.norm(delta, axis=-1)))
        if info["initial_step_norm"] is None:
            info["initial_step_norm"] = step_norm
        cand = poses @ se3_exp(delta)
        c1 = cost(view, cand, loop_weights=w_loops)
        info["iterations"] = it + 1
        if c1 <= c0:
            poses, c0 = cand, c1
            lam = max(lam * 0.25, 1e-12)
            warm = it == 0 and step_norm < floor_tolerance
            if step_norm < step_tolerance or warm:
                info["converged"] = True
                break
        else:
            lam = min(max(lam, 1e-8) * 10.0, 1e6)
            if step_norm < step_tolerance:
                info["converged"] = True
                break
    info["final_cost"] = c0
    return poses, info
