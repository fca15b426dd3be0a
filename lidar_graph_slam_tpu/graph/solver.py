"""SE(3) pose-graph optimizer — first-party replacement for GTSAM's iSAM2 back end.

The reference hands its graph to `gtsam::ISAM2` (prior + odometry between-factors added per
keyframe at `graph_based_slam/src/graph_based_slam.cpp:361-374`, loop between-factors at
`:330-347`, estimates read back via `calculateEstimate` at `:379,419`). We match its
*behavioral* contract — incremental insertion is cheap, loop closures trigger a global
re-linearized solve, estimates equal the nonlinear least-squares optimum — with an algorithm
chosen for batched device execution instead of the Bayes tree:

  * A pose graph from this pipeline is a **chain + L loop factors** (L small). The
    Gauss-Newton normal matrix is block-tridiagonal plus L rank-6 corrections.
  * The chain part is factorized with a **block-tridiagonal Cholesky** expressed as
    `lax.scan` over 6x6 blocks — O(K) with tiny dense ops, no sparse bookkeeping.
  * Loop factors enter via the **Woodbury identity**: 6L extra right-hand sides through the
    same tridiagonal solve plus one small (6L x 6L) dense solve. Exact, no fill-in, and the
    expensive part is batched matmuls.
  * Levenberg-Marquardt outer loop with masked accept/reject runs entirely inside one jitted
    program: fixed iteration count, no data-dependent Python control flow.

All factors use the twist ordering (omega, v), so the reference's noise vector
sigma^2 = [1e-6 x3, 1e-8, 1e-8, 1e-6] (`graph_based_slam.cpp:67-69`) maps verbatim.

PRECISION: this jitted f32 solver is the ESCALATION FALLBACK tier. At automotive
scale the f32 gradient at the optimum is storage-rounding noise (measured:
scripts/diag_warm.py), so the host float64 separator-direct tier (`graph/refine64.py`,
whose module docstring says why it runs on the host) produces the production poses and
this LM descends only when f64 GN stalls (`escalate_f64`). Mirrors the reference's own split of f32 PCL registration + f64
GTSAM optimization. Use `solve_incremental` (or `GraphBasedSLAM`, which wraps it with
host-mirrored state) as the solve entry point; `optimize` alone converges only to the
f32 floor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.core.struct import pytree_dataclass


@pytree_dataclass
class PoseGraph:
    """Fixed-capacity factor-graph state (SoA over keyframes and loop factors)."""

    poses: jax.Array          # [K, 4, 4] current estimates
    pose_mask: jax.Array      # [K] bool — active keyframes
    odom_meas: jax.Array      # [K, 4, 4] Z_k = between(T_{k-1}, T_k); row 0 unused
    prior_pose: jax.Array     # [4, 4] anchor for pose 0
    odom_info: jax.Array      # [6] diagonal information (1/sigma^2) for prior+odometry
    loop_i: jax.Array         # [L] int32 source keyframe ids
    loop_j: jax.Array         # [L] int32 target keyframe ids
    loop_meas: jax.Array      # [L, 4, 4] Z_l = between(T_i, T_j) measured by ICP
    loop_info: jax.Array      # [L, 6] diagonal information per loop factor
    loop_mask: jax.Array      # [L] bool
    num_poses: jax.Array      # scalar int32
    num_loops: jax.Array      # scalar int32


def init_graph(max_keyframes: int, max_loops: int, odom_noise_var) -> PoseGraph:
    def eyes(n):  # distinct buffers — donation forbids aliased arguments
        return jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (n, 1, 1))

    return PoseGraph(
        poses=eyes(max_keyframes),
        pose_mask=jnp.zeros((max_keyframes,), bool),
        odom_meas=eyes(max_keyframes),
        prior_pose=jnp.eye(4, dtype=jnp.float32),
        odom_info=1.0 / jnp.asarray(odom_noise_var, jnp.float32),
        loop_i=jnp.zeros((max_loops,), jnp.int32),
        loop_j=jnp.zeros((max_loops,), jnp.int32),
        loop_meas=eyes(max_loops),
        loop_info=jnp.ones((max_loops, 6), jnp.float32),
        loop_mask=jnp.zeros((max_loops,), bool),
        num_poses=jnp.asarray(0, jnp.int32),
        num_loops=jnp.asarray(0, jnp.int32),
    )


@partial(jax.jit, donate_argnames=("g",))
def graph_add_keyframe(g: PoseGraph, pose: jax.Array, odom_meas: jax.Array) -> PoseGraph:
    """Append a keyframe with its odometry between-measurement (reference semantics:
    `key_frame_callback`, `graph_based_slam.cpp:354-377`). Refuses at capacity
    (mode="drop" + clamped count), mirroring `graph_add_loop`."""
    k = g.num_poses
    K = g.pose_mask.shape[0]
    return g.replace(
        poses=g.poses.at[k].set(pose, mode="drop"),
        pose_mask=g.pose_mask.at[k].set(True, mode="drop"),
        odom_meas=g.odom_meas.at[k].set(odom_meas, mode="drop"),
        prior_pose=jnp.where(k == 0, pose, g.prior_pose),
        num_poses=jnp.minimum(k + 1, K),
    )


@partial(jax.jit, donate_argnames=("g",))
def graph_add_keyframes_batch(g: PoseGraph, poses: jax.Array, odoms: jax.Array, count: jax.Array) -> PoseGraph:
    """Append the first `count` of a [B, 4, 4] keyframe batch in ONE dispatch.

    The host-side back end defers per-keyframe inserts and flushes them in batches
    (per-dispatch host overhead dominates the tiny insert itself); semantics are
    exactly `count` sequential `graph_add_keyframe` calls."""
    K = g.pose_mask.shape[0]

    def body(i, g):
        k = g.num_poses
        take = i < count
        return g.replace(
            poses=g.poses.at[k].set(jnp.where(take, poses[i], g.poses[k]), mode="drop"),
            pose_mask=g.pose_mask.at[k].set(
                jnp.where(take, True, g.pose_mask[k]), mode="drop"),
            odom_meas=g.odom_meas.at[k].set(
                jnp.where(take, odoms[i], g.odom_meas[k]), mode="drop"),
            prior_pose=jnp.where(take & (k == 0), poses[i], g.prior_pose),
            num_poses=jnp.minimum(k + take.astype(jnp.int32), K),
        )

    return jax.lax.fori_loop(0, poses.shape[0], body, g)


@partial(jax.jit, donate_argnames=("g",))
def graph_add_loop(g: PoseGraph, i: jax.Array, j: jax.Array, meas: jax.Array, info_diag: jax.Array) -> PoseGraph:
    """Append a loop between-factor (noise = fitness * I6 in the reference,
    `graph_based_slam.cpp:335-341` — callers pass info_diag = 1/fitness * ones).

    At capacity the insert is REFUSED (scatter mode="drop" discards the out-of-range
    write and num_loops stays clamped) rather than silently overwriting the last factor;
    hosts detect the refusal by num_loops not advancing (`GraphBasedSLAM.try_close_loop`
    checks capacity first and surfaces the overflow in telemetry)."""
    l = g.num_loops
    L = g.loop_mask.shape[0]
    return g.replace(
        loop_i=g.loop_i.at[l].set(i, mode="drop"),
        loop_j=g.loop_j.at[l].set(j, mode="drop"),
        loop_meas=g.loop_meas.at[l].set(meas, mode="drop"),
        loop_info=g.loop_info.at[l].set(info_diag, mode="drop"),
        loop_mask=g.loop_mask.at[l].set(True, mode="drop"),
        num_loops=jnp.minimum(l + 1, L),
    )


# --- residuals / linearization ----------------------------------------------------------


def _ad_se3(xi: jax.Array) -> jax.Array:
    """se(3) adjoint (ad) of a twist, (omega, v) ordering: [[W,0],[V,W]]."""
    W = se3.hat(xi[..., :3])
    V = se3.hat(xi[..., 3:])
    Z = jnp.zeros_like(W)
    top = jnp.concatenate([W, Z], axis=-1)
    bot = jnp.concatenate([V, W], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _jr_inv(r: jax.Array) -> jax.Array:
    """Inverse right Jacobian of the SE(3) log, 2nd-order series: I + ad/2 + ad^2/12."""
    ad = _ad_se3(r)
    eye = jnp.broadcast_to(jnp.eye(6, dtype=r.dtype), ad.shape)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


def between_residual(Ti: jax.Array, Tj: jax.Array, Z: jax.Array):
    """Residual r = log(Z^{-1} T_i^{-1} T_j) and Jacobians (J_i, J_j) for right
    perturbations T <- T exp(xi)."""
    E = se3.inverse(Z) @ se3.inverse(Ti) @ Tj
    r = se3.se3_log(E)
    Jr = _jr_inv(r)
    Jj = Jr
    Ji = -Jr @ se3.adjoint(se3.inverse(Tj) @ Ti)
    return r, Ji, Jj


def graph_cost(g: PoseGraph, poses: jax.Array) -> jax.Array:
    """Total weighted squared residual under candidate poses."""
    K = poses.shape[0]
    # Prior on pose 0.
    r0 = se3.se3_log(se3.inverse(g.prior_pose) @ poses[0])
    cost = jnp.sum(r0 * g.odom_info * r0)
    # Odometry chain factors k-1 -> k for k in [1, K).
    Ti = poses[:-1]
    Tj = poses[1:]
    E = se3.inverse(g.odom_meas[1:]) @ se3.inverse(Ti) @ Tj
    r = se3.se3_log(E)
    m = (g.pose_mask[1:] & g.pose_mask[:-1]).astype(poses.dtype)
    cost = cost + jnp.sum(m[:, None] * r * g.odom_info[None, :] * r)
    # Loop factors.
    rl = se3.se3_log(se3.inverse(g.loop_meas) @ se3.inverse(poses[g.loop_i]) @ poses[g.loop_j])
    ml = g.loop_mask.astype(poses.dtype)
    cost = cost + jnp.sum(ml[:, None] * rl * g.loop_info * rl)
    return cost


# --- block-tridiagonal solve ------------------------------------------------------------


def _tridiag_solve_cr(D: jax.Array, U: jax.Array, B: jax.Array) -> jax.Array:
    """Block cyclic reduction solve of the symmetric block-tridiagonal system H x = B.

    D: [K, 6, 6]; U: [K, 6, 6] with U[k] = H[k, k+1] (U[K-1] ignored/zero);
    B: [K, 6, M]. Returns x [K, 6, M]. K is padded internally to a power of two with
    decoupled identity blocks.

    WHY: the sequential `lax.scan` elimination issues K tiny dependent 6x6 steps — pure
    launch latency on a GPU (measured on an H100 at 700 W: 176 ms at K=1024, 834 ms at
    K=4096, 49 right-hand sides). Cyclic reduction eliminates every odd block in
    PARALLEL and recurses on the half-size even system: log2(K) levels of fully batched
    6x6 solves/matmuls (1.8 ms and 1.9 ms on the same card). ~2x the FLOPs of the scan,
    ~K/log2(K) less serial latency. Standard identities (L_i = U_{i-1}^T):

      D'_j = D_2j − U_{2j−1}^T D_{2j−1}^{-1} U_{2j−1} − U_2j D_{2j+1}^{-1} U_2j^T
      U'_j = −U_2j D_{2j+1}^{-1} U_{2j+1}
      b'_j = b_2j − U_{2j−1}^T D_{2j−1}^{-1} b_{2j−1} − U_2j D_{2j+1}^{-1} b_{2j+1}
      back-substitution: x_{2j+1} = D_{2j+1}^{-1}(b_{2j+1} − U_2j^T x_2j − U_{2j+1} x_{2j+2})
    """
    K = D.shape[0]
    M = B.shape[-1]
    dtype = D.dtype
    Kp = 1 << max(K - 1, 1).bit_length()
    if Kp != K:
        pad = Kp - K
        eye = jnp.broadcast_to(jnp.eye(6, dtype=dtype), (pad, 6, 6))
        D = jnp.concatenate([D, eye], axis=0)
        U = jnp.concatenate([U, jnp.zeros((pad, 6, 6), dtype)], axis=0)
        # Decouple the padding from the real system.
        U = U.at[K - 1].set(jnp.zeros((6, 6), dtype))
        B = jnp.concatenate([B, jnp.zeros((pad, 6, M), dtype)], axis=0)

    def solve_level(D, U, B):
        n = D.shape[0]
        if n == 1:
            return jnp.linalg.solve(D[0], B[0])[None]
        D_e, D_o = D[0::2], D[1::2]                 # [h], h = n/2
        B_e, B_o = B[0::2], B[1::2]
        U_eo = U[0::2]                               # U_{2j}: even 2j -> odd 2j+1
        U_oe = U[1::2]                               # U_{2j+1}: odd 2j+1 -> even 2j+2
        h = n // 2
        U_oe = U_oe.at[h - 1].set(jnp.zeros((6, 6), dtype))  # no even block after the last odd

        # Per-odd-block solves, batched: D_o^{-1} [U_eo^T | U_oe | b_o].
        rhs_o = jnp.concatenate([jnp.swapaxes(U_eo, -1, -2), U_oe, B_o], axis=-1)
        sol_o = jnp.linalg.solve(D_o, rhs_o)
        Dinv_Ueo_T = sol_o[..., :6]                  # D_{2j+1}^{-1} U_{2j}^T
        Dinv_Uoe = sol_o[..., 6:12]                  # D_{2j+1}^{-1} U_{2j+1}
        Dinv_bo = sol_o[..., 12:]                    # D_{2j+1}^{-1} b_{2j+1}

        # Contributions from odd 2j+1 into even 2j (right neighbor):
        D_right = U_eo @ Dinv_Ueo_T                  # U_2j D^{-1} U_2j^T
        U_new = -(U_eo @ Dinv_Uoe)                   # couples even j -> even j+1
        b_right = U_eo @ Dinv_bo
        # Contributions from odd 2j-1 into even 2j (left neighbor), shifted:
        UT_Dinv_U = jnp.swapaxes(U_oe, -1, -2) @ Dinv_Uoe   # U_{2j+1}^T D^{-1} U_{2j+1}
        b_left_src = jnp.swapaxes(U_oe, -1, -2) @ Dinv_bo   # U_{2j+1}^T D^{-1} b_{2j+1}
        zero6 = jnp.zeros((1, 6, 6), dtype)
        D_left = jnp.concatenate([zero6, UT_Dinv_U[:-1]], axis=0)
        b_left = jnp.concatenate([jnp.zeros((1, 6, M), dtype), b_left_src[:-1]], axis=0)

        D_next = D_e - D_right - D_left
        B_next = B_e - b_right - b_left
        x_e = solve_level(D_next, U_new, B_next)     # [h, 6, M]

        # Back-substitute odds: x_{2j+1} = D^{-1}(b − U_2j^T x_2j − U_{2j+1} x_{2j+2}).
        x_e_next = jnp.concatenate([x_e[1:], jnp.zeros((1, 6, M), dtype)], axis=0)
        x_o = Dinv_bo - Dinv_Ueo_T @ x_e - Dinv_Uoe @ x_e_next
        # Interleave even/odd back to size n.
        out = jnp.stack([x_e, x_o], axis=1).reshape(n, 6, M)
        return out

    x = solve_level(D, U, B)
    return x[:K]


def _tridiag_solve(D: jax.Array, U: jax.Array, B: jax.Array) -> jax.Array:
    """Solve the block-tridiagonal system H x = B.

    D: [K, 6, 6] diagonal blocks; U: [K-1, 6, 6] super-diagonal blocks (H[k, k+1]);
    B: [K, 6, M] right-hand sides. Returns x [K, 6, M].

    Dispatch (measured on an H100 at 700 W, K in {256, 1024, 2048, 4096}, M in {49, 385}):
    batched cyclic reduction (`_tridiag_solve_cr`) takes 1.1-2.2 ms at every size, the
    blocked substructuring solve (`_tridiag_solve_blocked`) 12-18 ms and the sequential
    scan 43-834 ms, so cyclic reduction serves every K >= 8; the scan is kept below that.
    """
    K = D.shape[0]
    if K >= 8:
        U_full = jnp.concatenate([U, jnp.zeros((1, 6, 6), D.dtype)], axis=0)
        return _tridiag_solve_cr(D, U_full, B)
    return _tridiag_solve_scan(D, U, B)


def _tridiag_solve_blocked(D: jax.Array, U: jax.Array, B: jax.Array, seg: int = 64) -> jax.Array:
    """Blocked substructuring solve: the single-device analog of the distributed Schur
    decomposition (`parallel/schur.py:schur_tridiag_solve`), with vmap standing in for
    the mesh axis and plain indexing for the collectives.

    The K-block chain splits into S = K/seg segments; each segment's last block is a
    *separator*. All S interior systems (seg-1 blocks each) are eliminated by ONE
    batched scan (seg-1 steps of [S, 6, 6] ops — serial latency drops from K to
    ~seg + S ~ 2 sqrt(K) while every step stays batched), condensing onto the S-block
    separator tridiagonal system, which `_tridiag_solve` solves. Temporaries are bounded by one [S, seg, 6, M+12] bundle streamed a
    scan-step at a time — no CR-style level pyramid to spill.

    Requires K % seg == 0 and seg >= 3 (callers pad). Not on `_tridiag_solve`'s dispatch
    path since cyclic reduction measured faster at every size (see there).
    """
    K = D.shape[0]
    M = B.shape[-1]
    dtype = D.dtype
    assert K % seg == 0 and seg >= 3, (K, seg)
    S = K // seg

    D_s = D.reshape(S, seg, 6, 6)
    B_s = B.reshape(S, seg, 6, M)
    U_full = jnp.concatenate([U, jnp.zeros((1, 6, 6), dtype)], axis=0)
    U_s = U_full.reshape(S, seg, 6, 6)

    # Coupling from the previous segment's separator into our first interior block:
    # C_s = U[s*seg - 1] (zero for segment 0).
    U_prev_last = jnp.concatenate(
        [jnp.zeros((1, 6, 6), dtype), U_s[:-1, seg - 1]], axis=0)      # [S, 6, 6]
    U_last_int = U_s[:, seg - 2]                                        # [S, 6, 6]

    # Interior systems: blocks 0..seg-2 of each segment.
    D_int = D_s[:, : seg - 1]
    U_int = U_s[:, : seg - 2]
    b_int = B_s[:, : seg - 1]
    # RHS bundle [b | C | Bc]: C nonzero only in interior row 0 (= U_prev^T), Bc nonzero
    # only in interior row seg-2 (= U_last_int).
    C_cols = jnp.zeros((S, seg - 1, 6, 6), dtype).at[:, 0].set(
        jnp.swapaxes(U_prev_last, -1, -2))
    B_cols = jnp.zeros((S, seg - 1, 6, 6), dtype).at[:, seg - 2].set(U_last_int)
    rhs = jnp.concatenate([b_int, C_cols, B_cols], axis=-1)             # [S, seg-1, 6, M+12]
    sol = jax.vmap(_tridiag_solve_scan)(D_int, U_int, rhs)
    y = sol[..., :M]                    # T^-1 b_int
    W_C = sol[..., M:M + 6]             # T^-1 C
    W_B = sol[..., M + 6:]              # T^-1 Bc

    # Separator system (S blocks). Row-0 / row-(seg-2) structure keeps products cheap:
    # C^T T^-1 X = U_prev @ (T^-1 X)[0]; Bc^T T^-1 X = U_last_int^T @ (T^-1 X)[seg-2].
    Ct = U_prev_last
    Bt = jnp.swapaxes(U_last_int, -1, -2)
    CtW_C = Ct @ W_C[:, 0]
    CtW_B = Ct @ W_B[:, 0]
    Cty = Ct @ y[:, 0]
    BtW_B = Bt @ W_B[:, seg - 2]
    Bty = Bt @ y[:, seg - 2]

    # Segment s's interior elimination reduces: sep s-1 (via C), sep s (via Bc), and the
    # cross term sep s-1 <-> sep s. Shift the C-side contributions down one row.
    S_diag = D_s[:, seg - 1] - BtW_B
    S_diag = S_diag.at[:-1].add(-CtW_C[1:])
    S_off = -CtW_B[1:]                  # H_sep[s-1, s] = -C^T T^-1 Bc (from segment s)
    S_rhs = B_s[:, seg - 1] - Bty
    S_rhs = S_rhs.at[:-1].add(-Cty[1:])
    x_sep = _tridiag_solve(S_diag, S_off, S_rhs)                        # [S, 6, M]

    # Back-substitute interiors: x_int[s] = y - W_C x_sep[s-1] - W_B x_sep[s].
    x_prev = jnp.concatenate([jnp.zeros((1, 6, M), dtype), x_sep[:-1]], axis=0)
    x_int = y - W_C @ x_prev[:, None] - W_B @ x_sep[:, None]
    return jnp.concatenate([x_int, x_sep[:, None]], axis=1).reshape(K, 6, M)


def _tridiag_solve_scan(D: jax.Array, U: jax.Array, B: jax.Array) -> jax.Array:
    """Sequential-scan reference solve (forward block elimination + back substitution)."""
    # Pad U with a leading zero block so step k consumes U_{k-1}.
    K = D.shape[0]
    U_pad = jnp.concatenate([jnp.zeros((1, 6, 6), D.dtype), U], axis=0)

    def fwd_step(carry, inp):
        S_prev, y_prev = carry  # S_{k-1} (6,6), y_{k-1} tilde (6,M)
        Dk, Uk_prev, Bk = inp
        # G = S_{k-1}^{-1} U_{k-1}
        G = jnp.linalg.solve(S_prev, Uk_prev)
        S = Dk - jnp.swapaxes(Uk_prev, 0, 1) @ G
        y = Bk - jnp.swapaxes(Uk_prev, 0, 1) @ jnp.linalg.solve(S_prev, y_prev)
        return (S, y), (S, y, G)

    M = B.shape[-1]
    # Derive the init carry from the operands so its sharding/varying type matches the
    # body outputs under shard_map (a replicated literal init trips the varying-axis
    # check when this runs inside a sharded region).
    init = (jnp.eye(6, dtype=D.dtype) + 0.0 * D[0], jnp.zeros((6, M), D.dtype) + 0.0 * B[0])
    _, (S_all, y_all, G_all) = jax.lax.scan(fwd_step, init, (D, U_pad, B))

    # Back substitution: x_K-1 = S^{-1} y; x_k = S_k^{-1} y_k - G_{k+1} x_{k+1}.
    def bwd_step(x_next, inp):
        Sk, yk, G_next = inp
        xk = jnp.linalg.solve(Sk, yk) - G_next @ x_next
        return xk, xk

    # G_all[k] = S_{k-1}^{-1} U_{k-1}; for back-sub at k we need G_{k+1} = S_k^{-1} U_k.
    G_shift = jnp.concatenate([G_all[1:], jnp.zeros((1, 6, 6), D.dtype)], axis=0)
    _, xs = jax.lax.scan(bwd_step, 0.0 * B[0], (S_all, y_all, G_shift), reverse=True)
    return xs


def _assemble_chain(g: PoseGraph, poses: jax.Array, damping: jax.Array):
    """Build block-tridiagonal (D, U) and gradient rhs b from prior + odometry factors."""
    K = poses.shape[0]
    dtype = poses.dtype
    info = g.odom_info.astype(dtype)

    # Chain factors: k-1 -> k (vectorized over K-1 factors).
    r, Ji, Jj = between_residual(poses[:-1], poses[1:], g.odom_meas[1:])
    m = (g.pose_mask[1:] & g.pose_mask[:-1]).astype(dtype)[:, None, None]
    JiW = jnp.swapaxes(Ji, -1, -2) * info[None, None, :]   # J_i^T Lambda
    JjW = jnp.swapaxes(Jj, -1, -2) * info[None, None, :]
    A = m * (JiW @ Ji)        # contribution to D[k-1]
    Coff = m * (JiW @ Jj)     # contribution to U[k-1] (block (k-1, k))
    Cdiag = m * (JjW @ Jj)    # contribution to D[k]
    bi = -(m[..., 0] * (JiW @ r[..., None])[..., 0])  # gradient rows
    bj = -(m[..., 0] * (JjW @ r[..., None])[..., 0])

    D = jnp.zeros((K, 6, 6), dtype)
    D = D.at[:-1].add(A).at[1:].add(Cdiag)
    b = jnp.zeros((K, 6), dtype)
    b = b.at[:-1].add(bi).at[1:].add(bj)
    U = Coff

    # Prior factor on pose 0: r = log(prior^{-1} T_0), J = Jr_inv(r).
    r0 = se3.se3_log(se3.inverse(g.prior_pose) @ poses[0])
    J0 = _jr_inv(r0)
    J0W = jnp.swapaxes(J0, -1, -2) * info[None, :]
    D = D.at[0].add(J0W @ J0)
    b = b.at[0].add(-(J0W @ r0[:, None])[:, 0])

    # Inactive poses: identity diagonal so the solve stays well-posed, zero rhs.
    active = g.pose_mask.astype(dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    D = active[:, None, None] * D + (1.0 - active)[:, None, None] * eye6
    b = active[:, None] * b
    # LM damping on active diagonals.
    D = D + damping * active[:, None, None] * eye6
    return D, U, b


def _loop_terms(g: PoseGraph, poses: jax.Array):
    """Loop-factor residual/Jacobian bundle: (r [L,6], Ji, Jj [L,6,6], info [L,6], m [L])."""
    Ti = poses[g.loop_i]
    Tj = poses[g.loop_j]
    r, Ji, Jj = between_residual(Ti, Tj, g.loop_meas)
    return r, Ji, Jj


def loop_gradient_and_whitened_columns(g: PoseGraph, poses: jax.Array):
    """Loop-factor linearization shared by every solve path.

    Returns (b_loop [K, 6] gradient contribution, Vw [K, 6, 6L] whitened Woodbury
    columns). Whitening by sqrt(info) makes the Woodbury small system I + Vw^T T^-1 Vw —
    unit-diagonal and f32-friendly regardless of factor strength; masked loops produce
    zero columns, so no epsilon hacks are needed.
    """
    K = poses.shape[0]
    L = g.loop_i.shape[0]
    dtype = poses.dtype
    r, Ji, Jj = _loop_terms(g, poses)
    ml = g.loop_mask.astype(dtype)[:, None]
    info_l = g.loop_info.astype(dtype) * ml                      # [L, 6] masked info
    JiW = jnp.swapaxes(Ji, -1, -2) * info_l[:, None, :]
    JjW = jnp.swapaxes(Jj, -1, -2) * info_l[:, None, :]
    b_loop = jnp.zeros((K, 6), dtype)
    b_loop = b_loop.at[g.loop_i].add(-(JiW @ r[..., None])[..., 0])
    b_loop = b_loop.at[g.loop_j].add(-(JjW @ r[..., None])[..., 0])

    sqrt_info = jnp.sqrt(info_l)                                 # [L, 6]
    JiS = jnp.swapaxes(Ji, -1, -2) * sqrt_info[:, None, :]       # Ji^T sqrt(Lambda)
    JjS = jnp.swapaxes(Jj, -1, -2) * sqrt_info[:, None, :]
    Vw = jnp.zeros((K, 6, L, 6), dtype)
    lane = jnp.eye(L, dtype=dtype).T[:, None, :, None]
    Vw = Vw.at[g.loop_i].add(JiS[:, :, None, :] * lane)
    Vw = Vw.at[g.loop_j].add(JjS[:, :, None, :] * lane)
    return b_loop, Vw.reshape(K, 6, L * 6)


def woodbury_correct(Vw: jax.Array, Tinv_b: jax.Array, Tinv_V: jax.Array) -> jax.Array:
    """delta = T^-1 b - T^-1 Vw (I + Vw^T T^-1 Vw)^-1 Vw^T T^-1 b."""
    VtTinvV = jnp.einsum("kim,kin->mn", Vw, Tinv_V)
    VtTinvb = jnp.einsum("kim,ki->m", Vw, Tinv_b)
    small = jnp.eye(Vw.shape[-1], dtype=Vw.dtype) + VtTinvV
    z = jnp.linalg.solve(small, VtTinvb)
    return Tinv_b - jnp.einsum("kim,m->ki", Tinv_V, z)


def _solve_step(g: PoseGraph, poses: jax.Array, damping: jax.Array) -> jax.Array:
    """One damped GN step: returns delta twists [K, 6] (right perturbation)."""
    D, U, b_chain = _assemble_chain(g, poses, damping)
    b_loop, Vw = loop_gradient_and_whitened_columns(g, poses)
    b = b_chain + b_loop
    rhs = jnp.concatenate([b[..., None], Vw], axis=-1)           # [K, 6, 1+6L]
    sol = _tridiag_solve(D, U, rhs)
    return woodbury_correct(Vw, sol[..., 0], sol[..., 1:])


# The f32 convergence floor (measured, scripts/diag_warm.py): pose translations of
# KITTI scale (~1e2 m) stored in f32 carry ~1e-5 m rounding, which info weights up to
# 1e8 amplify into gradient noise — at the optimum LM proposes ~5e-4-norm garbage steps
# that genuinely WORSEN the nonlinear cost and get rejected forever. GTSAM avoids this
# by running in f64 (`graph_based_slam.hpp:38-46`); in f32 the honest termination
# signal is "a sub-millimeter step was REJECTED at healthy damping": the optimizer is at
# the floor, more iterations cannot help. These two knobs encode that signal.
_STUCK_STEP_TOL = 1e-3   # rejected steps below this norm are floor noise, not progress


@partial(jax.jit, static_argnames=("max_iterations",))
def optimize(
    g: PoseGraph, max_iterations: int = 10, init_damping: float = 1e-4,
    step_tolerance: float = 1e-6,
) -> PoseGraph:
    """Levenberg-Marquardt over the full graph; returns the graph with updated poses.

    Warm-started from current estimates — the incremental behavior that stands in for
    iSAM2's Bayes-tree updates (SURVEY.md §7 layer 5; `graph_based_slam.cpp:373-374`).
    Termination, in order of preference:
      * an accepted step's cost improvement is < 1e-5 relative (true plateau; rejected
        steps do NOT trigger this — a tiny rejected step after damping inflation says
        nothing about being near the optimum),
      * the proposed step norm is below `step_tolerance`,
      * a sub-`_STUCK_STEP_TOL` step was REJECTED — the f32 floor (see note above). A
        small full step at low damping only occurs near the optimum (far away, GN
        proposes large steps); at high damping, tiny gradient-descent steps get
        accepted whenever genuine progress exists — so a rejected sub-millimeter step
        at any damping means the gradient is noise. A warm re-solve (graph already at
        its optimum) pays ONE iteration, not `max_iterations`.
    """
    dtype = g.poses.dtype

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_not(done) & (it < max_iterations)

    def body(carry):
        poses, cost0, damping, it, _ = carry
        delta = _solve_step(g, poses, damping)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        cand = poses @ se3.se3_exp(delta)
        cand_cost = graph_cost(g, cand)
        accept = cand_cost < cost0
        step_norm = jnp.max(jnp.linalg.norm(delta, axis=-1))
        plateau = accept & (
            jnp.abs(cand_cost - cost0) < 1e-5 * jnp.maximum(cost0, 1e-3))
        stuck = (~accept) & (step_norm < _STUCK_STEP_TOL)
        poses = jnp.where(accept, cand, poses)
        cost0 = jnp.where(accept, cand_cost, cost0)  # carry: one cost eval per iteration
        damping = jnp.where(accept, damping * 0.3, damping * 8.0)
        damping = jnp.clip(damping, 1e-9, 1e6)
        done = (step_norm < step_tolerance) | plateau | stuck
        return poses, cost0, damping, it + 1, done

    poses, _, _, _, _ = jax.lax.while_loop(
        cond, body,
        (g.poses, graph_cost(g, g.poses), jnp.asarray(init_damping, dtype),
         jnp.asarray(0, jnp.int32), jnp.asarray(False)),
    )
    return g.replace(poses=poses)


def escalate_f64(view, device_lm, probe_iterations: int = 2,
                 refine_max_iterations: int = 12, tail_iterations: int = 6):
    """The engine's solve escalation ladder, shared by `solve_incremental` and
    `GraphBasedSLAM._run_optimize` (one copy: two hand-rolled ladders
    could silently drift).

      1. Warm probe: `probe_iterations` of host f64 GN. A WARM graph (already at its
         optimum — the per-keyframe iSAM2 case, `graph_based_slam.cpp:373-374`)
         detects convergence from its first f64 step and returns after ONE O(K) host
         iteration.
      2. Cold continuation: more f64 GN — quadratic and, at automotive conditioning,
         strictly more reliable than the f32 device LM (handing a midway state to the
         f32 LM was measured to kick K=4096/L=64 into a bad basin it never left).
      3. Device-LM fallback ONLY if f64 itself stalls: `device_lm(poses64)` must run
         the jitted f32 descent (single-chip or mesh-distributed — the caller picks)
         and return f64 poses; an f64 tail then finishes to the true optimum.

    `view` is a `refine64.GraphView`; its `.poses` is mutated to thread progress.
    Returns (poses64, info) with info["device_lm"] and cumulative info["iterations"].
    """
    from lidar_graph_slam_tpu.graph import refine64

    poses64, info = refine64.refine(view, max_iterations=probe_iterations)
    total_iters = info["iterations"]
    info["device_lm"] = False
    if not info["converged"]:
        view.poses = poses64  # keep the probe's progress
        poses64, info = refine64.refine(view, max_iterations=refine_max_iterations)
        total_iters += info["iterations"]
        info["device_lm"] = False
    if not info["converged"]:
        view.poses = device_lm(poses64)
        poses64, info = refine64.refine(view, max_iterations=tail_iterations)
        total_iters += info["iterations"]
        info["device_lm"] = True
    info["iterations"] = total_iters
    return poses64, info


def solve_incremental(g: PoseGraph, max_iterations: int = 30,
                      probe_iterations: int = 2, refine_max_iterations: int = 12):
    """Hybrid f64-host + f32-device pose-graph solve — the engine's public solve entry
    (what `GraphBasedSLAM._run_optimize` runs; bench.py measures this).

    Runs the shared `escalate_f64` ladder with the single-chip jitted LM as the device
    fallback. Returns (solved PoseGraph, info dict)."""
    import numpy as np

    from lidar_graph_slam_tpu.graph import refine64

    view = refine64.GraphView.from_device_graph(g)
    if view.poses.shape[0] == 0:
        return g, {"iterations": 0, "converged": True, "device_lm": False,
                   "initial_step_norm": 0.0, "final_cost": 0.0}

    def device_lm(poses64):
        gd = g.replace(poses=g.poses.at[: poses64.shape[0]].set(
            jnp.asarray(poses64, jnp.float32)))
        gd = optimize(gd, max_iterations=max_iterations)
        return np.asarray(
            jax.device_get(gd.poses), dtype=np.float64)[: poses64.shape[0]]

    poses64, info = escalate_f64(
        view, device_lm, probe_iterations=probe_iterations,
        refine_max_iterations=refine_max_iterations,
        tail_iterations=refine_max_iterations)
    k = poses64.shape[0]
    return (
        g.replace(poses=g.poses.at[:k].set(jnp.asarray(poses64, jnp.float32))),
        info,
    )
