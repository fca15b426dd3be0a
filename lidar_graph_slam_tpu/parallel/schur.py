"""Distributed block-tridiagonal solve via Schur-complement domain decomposition.

The city-scale target (BASELINE.json configs[4]: "submap-partitioned graph, Schur
reduction") needs the pose-graph normal system solved across devices, not just linearized
across them. The chain's block-tridiagonal structure decomposes cleanly:

  * the K poses are split into `n_devices` contiguous segments; the last pose of each
    segment is a *separator*, the rest are *interior*;
  * each device eliminates its interior block-tridiagonal system locally (a lax.scan of
    6x6 ops — perfectly parallel across devices);
  * interior elimination condenses onto the tiny separator system (one 6x6 block per
    device) which is psum-reduced over the mesh, solved replicated, and broadcast back;
  * devices back-substitute their interiors locally.

One psum of O(n_devices * 6 * 6) blocks is the only collective — the Schur reduction.
Loop factors compose on top through the same Woodbury identity as the single-chip
solver (`graph/solver.py`), with their 6L extra right-hand sides flowing through this
distributed solve unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.graph import solver as gsolver


def _local_tridiag_solve(D, U, B):
    """Per-device block-tridiagonal solve (interior elimination / separator system).

    Delegates to the batched cyclic-reduction solver (`graph/solver.py:_tridiag_solve`)
    — log2(m) levels of batched 6x6 ops instead of m sequential scan steps, and (unlike
    the previous lax.scan form) no carry whose sharding type needs massaging under
    shard_map."""
    m = D.shape[0]
    if m == 0:
        return B
    return gsolver._tridiag_solve(D, U, B)


def schur_tridiag_solve(mesh: Mesh, D_blocks, U_blocks, B):
    """Solve the block-tridiagonal system H x = B across the mesh.

    D_blocks: [K, 6, 6]; U_blocks: [K, 6, 6] with U_blocks[k] = H[k, k+1]
    (U_blocks[K-1] must be zero); B: [K, 6, M]. K must divide by the mesh size.
    Returns x [K, 6, M].
    """
    K = D_blocks.shape[0]
    n_dev = mesh.devices.size
    assert K % n_dev == 0, f"K={K} not divisible by mesh size {n_dev}"
    return _schur_tridiag_solve_jit(mesh, D_blocks, U_blocks, B)


@partial(jax.jit, static_argnames=("mesh",))
def _schur_tridiag_solve_jit(mesh: Mesh, D_blocks, U_blocks, B):
    """Cached-compile body of `schur_tridiag_solve` (the mesh is a static argument, so
    repeated LM iterations reuse one executable instead of retracing a fresh shard_map
    closure per call)."""
    axis = list(mesh.shape.keys())[0]
    n_dev = mesh.devices.size
    K = D_blocks.shape[0]
    m = K // n_dev
    M = B.shape[-1]
    dtype = D_blocks.dtype

    def spmd(D_loc, U_loc, B_loc):
        # D_loc: [m, 6, 6]; U_loc[i] couples local pose i to i+1 (global);
        # U_loc[m-1] couples this segment's separator to the NEXT segment's first pose.
        d = jax.lax.axis_index(axis)
        # Coupling from the previous separator into our first interior pose.
        U_prev_last = jax.lax.ppermute(
            U_loc[m - 1], axis, [(i, (i + 1) % n_dev) for i in range(n_dev)]
        )
        U_prev_last = jnp.where(d == 0, jnp.zeros((6, 6), dtype), U_prev_last)

        # Interior system: poses 0..m-2; separator: pose m-1.
        D_int = D_loc[: m - 1]
        U_int = U_loc[: m - 2] if m > 2 else jnp.zeros((0, 6, 6), dtype)
        b_int = B_loc[: m - 1]
        # RHS bundle: [b | C | B], C nonzero only in interior row 0 (= U_prev^T),
        # Bcpl nonzero only in interior row m-2 (= U_loc[m-2]).
        C_cols = jnp.zeros((m - 1, 6, 6), dtype).at[0].set(jnp.swapaxes(U_prev_last, 0, 1))
        B_cols = jnp.zeros((m - 1, 6, 6), dtype).at[m - 2].set(U_loc[m - 2])
        rhs = jnp.concatenate([b_int, C_cols, B_cols], axis=-1)     # [m-1, 6, M+12]
        sol = _local_tridiag_solve(D_int, U_int, rhs)
        y = sol[..., :M]                 # T^-1 b_int
        W_C = sol[..., M:M + 6]          # T^-1 C
        W_B = sol[..., M + 6:]           # T^-1 B

        # Separator contributions. Row-0 / row-(m-2) structure makes the products cheap:
        # C^T T^-1 X = U_prev @ (T^-1 X)[0]; B^T T^-1 X = U_loc[m-2]^T @ (T^-1 X)[m-2].
        Ct = U_prev_last                  # (U_prev^T)^T = U_prev
        Bt = jnp.swapaxes(U_loc[m - 2], 0, 1)
        CtW_C = Ct @ W_C[0]
        CtW_B = Ct @ W_B[0]
        Cty = Ct @ y[0]
        BtW_B = Bt @ W_B[m - 2]
        BtW_C = Bt @ W_C[m - 2]
        Bty = Bt @ y[m - 2]

        # Build full-size separator system as scatter + psum (tiny: n_dev blocks).
        S_diag = jnp.zeros((n_dev, 6, 6), dtype)
        S_off = jnp.zeros((n_dev, 6, 6), dtype)      # S_off[d] couples sep d to sep d+1
        S_rhs = jnp.zeros((n_dev, 6, M), dtype)
        # Own separator's raw diagonal + rhs.
        S_diag = S_diag.at[d].add(D_loc[m - 1])
        S_rhs = S_rhs.at[d].add(B_loc[m - 1])
        # Elimination of our interior reduces: sep d-1 (via C), sep d (via B), cross term.
        prev = jnp.maximum(d - 1, 0)
        has_prev = (d > 0).astype(dtype)
        S_diag = S_diag.at[prev].add(-has_prev * CtW_C)
        S_diag = S_diag.at[d].add(-BtW_B)
        S_off = S_off.at[prev].add(-has_prev * CtW_B)
        S_rhs = S_rhs.at[prev].add(-has_prev * Cty)
        S_rhs = S_rhs.at[d].add(-Bty)

        S_diag = jax.lax.psum(S_diag, axis)
        S_off = jax.lax.psum(S_off, axis)
        S_rhs = jax.lax.psum(S_rhs, axis)

        # Replicated tiny separator solve (n_dev blocks).
        x_sep = _local_tridiag_solve(S_diag, S_off[: n_dev - 1], S_rhs)   # [n_dev, 6, M]

        # Back-substitute interiors: x_int = y - W_C x_{sep_{d-1}} - W_B x_{sep_d}.
        x_prev = jnp.where(d == 0, jnp.zeros((6, M), dtype), x_sep[prev])
        x_own = x_sep[d]
        x_int = y - W_C @ x_prev - W_B @ x_own
        return jnp.concatenate([x_int, x_own[None]], axis=0)              # [m, 6, M]

    return jax.shard_map(
        spmd, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)), out_specs=P(axis)
    )(D_blocks, U_blocks, B)


# NOTE: assembly and the shard_map solve are deliberately SEPARATE compiled programs
# with an explicit sharded hand-off. Fusing them into one jit miscompiles on the
# virtual-device CPU backend (deterministic large errors in the shard_map output;
# assembly outputs verified bit-identical, and the same solve on materialized inputs
# is exact). Two dispatches cost one device-memory round trip of the assembled blocks — noise
# next to the solve itself.
@jax.jit
def _schur_assemble(g: gsolver.PoseGraph, damping):
    dtype = g.poses.dtype
    D, U, b = gsolver._assemble_chain(g, g.poses, jnp.asarray(damping, dtype))
    U_pad = jnp.concatenate([U, jnp.zeros((1, 6, 6), dtype)], axis=0)
    b_loop, Vw = gsolver.loop_gradient_and_whitened_columns(g, g.poses)
    rhs = jnp.concatenate([(b + b_loop)[..., None], Vw], axis=-1)
    return D, U_pad, rhs, Vw


@jax.jit
def _schur_finalize(g: gsolver.PoseGraph, Vw, sol):
    delta = gsolver.woodbury_correct(Vw, sol[..., 0], sol[..., 1:])
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
    return g.poses @ se3.se3_exp(delta)


def schur_graph_step(mesh: Mesh, g: gsolver.PoseGraph, damping=1e-4):
    """One damped-GN pose-graph step with the Schur-distributed tridiagonal solve.

    Linearization reuses the single-chip assembly; the solve (chain + Woodbury loop
    corrections) runs domain-decomposed over the mesh. `damping` is traced (an LM
    driver adapts it per iteration without recompiles). Returns updated poses.
    """
    axis = list(mesh.shape.keys())[0]
    D, U_pad, rhs, Vw = _schur_assemble(g, jnp.asarray(damping, g.poses.dtype))
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, P(axis))
    D, U_pad, rhs = (jax.device_put(x, sh) for x in (D, U_pad, rhs))
    sol = schur_tridiag_solve(mesh, D, U_pad, rhs)
    return _schur_finalize(g, Vw, sol)
