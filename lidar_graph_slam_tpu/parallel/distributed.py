"""Multi-chip parallelism: device meshes, batched registration, distributed graph solve.

The reference's only parallelism is three OS processes + OpenMP threads (SURVEY.md §2.3).
Here scaling is explicit mesh parallelism (`jax.sharding.Mesh` + `shard_map`), following the
BASELINE.json plan:

  * **Batched registration** — loop-candidate verification and multi-sequence odometry are
    embarrassingly parallel over (source, target) pairs: `vmap` inside, mesh-sharded
    batch axis outside. Replaces nothing in the reference (it verifies one candidate per
    1 Hz tick); this is capability the data-parallel design adds.
  * **Distributed pose-graph linearization** — each device linearizes its shard of the
    odometry chain factors (the O(K) SE(3) log/Jacobian work), contributes its blocks of
    the block-tridiagonal system, and the assembled system is `psum`-reduced over the mesh;
    the cheap O(K) tridiagonal solve then runs replicated. Loop factors are linearized on
    device 0's shard (L is tiny). This is the collective layout stage for the round-2
    Schur-complement submap elimination.

Everything here runs identically on a multi-GPU host and on the 8-virtual-device CPU mesh
used in CI (`tests/conftest.py`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lidar_graph_slam_tpu.core import se3
from lidar_graph_slam_tpu.graph import solver as gsolver
from lidar_graph_slam_tpu.registration.icp import icp_align
from lidar_graph_slam_tpu.registration.ndt import ndt_align


def make_mesh(n_devices: int | None = None, axis: str = "scan") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


# --- batched registration over the mesh -------------------------------------------------


def batched_icp(mesh: Mesh, target_grid, sources, masks, init_Ts, **kw):
    """Align a [B, N, 3] batch of sources against one shared target, B sharded over the
    mesh. Returns stacked RegistrationResult pytree with leading axis B."""
    spec = P("scan")
    in_shardings = (
        jax.tree.map(lambda _: NamedSharding(mesh, P()), target_grid),
        NamedSharding(mesh, spec),
        NamedSharding(mesh, spec),
        NamedSharding(mesh, spec),
    )

    @partial(jax.jit, in_shardings=in_shardings)
    def run(grid, srcs, msks, inits):
        return jax.vmap(lambda s, m, i: icp_align(grid, s, m, i, **kw))(srcs, msks, inits)

    return run(target_grid, sources, masks, init_Ts)


def batched_ndt(mesh: Mesh, vmap_target, sources, masks, init_Ts, **kw):
    """Same as `batched_icp` for NDT against a shared voxel map."""
    spec = P("scan")
    in_shardings = (
        jax.tree.map(lambda _: NamedSharding(mesh, P()), vmap_target),
        NamedSharding(mesh, spec),
        NamedSharding(mesh, spec),
        NamedSharding(mesh, spec),
    )

    @partial(jax.jit, in_shardings=in_shardings)
    def run(vm, srcs, msks, inits):
        return jax.vmap(lambda s, m, i: ndt_align(vm, s, m, i, **kw))(srcs, msks, inits)

    return run(vmap_target, sources, masks, init_Ts)


# --- distributed pose-graph step --------------------------------------------------------


def _local_chain_blocks(poses, odom_meas, pose_mask, info, lo, length, K):
    """Linearize chain factors [lo, lo+length) into full-size (D, U, b) with zeros
    elsewhere. Factor k is the between-factor (k-1 -> k), k >= 1."""
    dtype = poses.dtype
    ks = lo + jnp.arange(length)
    valid = (ks >= 1) & (ks < K)
    ki = jnp.clip(ks - 1, 0, K - 1)
    kj = jnp.clip(ks, 0, K - 1)
    Ti = poses[ki]
    Tj = poses[kj]
    Z = odom_meas[kj]
    r, Ji, Jj = gsolver.between_residual(Ti, Tj, Z)
    m = (valid & pose_mask[ki] & pose_mask[kj]).astype(dtype)[:, None, None]
    JiW = jnp.swapaxes(Ji, -1, -2) * info[None, None, :]
    JjW = jnp.swapaxes(Jj, -1, -2) * info[None, None, :]
    D = jnp.zeros((K, 6, 6), dtype)
    D = D.at[ki].add(m * (JiW @ Ji))
    D = D.at[kj].add(m * (JjW @ Jj))
    U = jnp.zeros((K - 1, 6, 6), dtype)
    U = U.at[ki].add(m * (JiW @ Jj))
    b = jnp.zeros((K, 6), dtype)
    b = b.at[ki].add(-(m[..., 0] * (JiW @ r[..., None])[..., 0]))
    b = b.at[kj].add(-(m[..., 0] * (JjW @ r[..., None])[..., 0]))
    return D, U, b


def distributed_graph_step(mesh: Mesh, g: gsolver.PoseGraph, damping=1e-4):
    """One distributed damped-GN step on the pose graph.

    Linearization of the odometry chain is sharded over the mesh axis; block systems are
    psum-reduced; the tridiagonal solve runs replicated. `damping` is traced (an LM
    driver adapts it per iteration without recompiles). Returns updated poses [K, 4, 4].
    """
    return _distributed_graph_step_jit(mesh, g, jnp.asarray(damping, g.poses.dtype))


@partial(jax.jit, static_argnames=("mesh",))
def _distributed_graph_step_jit(mesh: Mesh, g: gsolver.PoseGraph, damping):
    K = g.poses.shape[0]
    n_dev = mesh.devices.size
    shard = -(-K // n_dev)  # factors per device (ceil)

    def spmd(idx_ref):
        # idx_ref: [1] int32 — this device's index along the mesh axis.
        lo = idx_ref[0] * shard
        D, U, b = _local_chain_blocks(
            g.poses, g.odom_meas, g.pose_mask, g.odom_info, lo, shard, K
        )
        D = jax.lax.psum(D, "scan")
        U = jax.lax.psum(U, "scan")
        b = jax.lax.psum(b, "scan")
        return D, U, b

    idx = jnp.arange(n_dev, dtype=jnp.int32)
    D, U, b = jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(P("scan"),),
        out_specs=(P(), P(), P()),
    )(idx)

    dtype = g.poses.dtype
    # Prior factor + masking + damping (replicated, cheap).
    r0 = se3.se3_log(se3.inverse(g.prior_pose) @ g.poses[0])
    J0 = gsolver._jr_inv(r0)
    J0W = jnp.swapaxes(J0, -1, -2) * g.odom_info[None, :]
    D = D.at[0].add(J0W @ J0)
    b = b.at[0].add(-(J0W @ r0[:, None])[:, 0])
    active = g.pose_mask.astype(dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    D = active[:, None, None] * D + (1.0 - active)[:, None, None] * eye6
    D = D + damping * active[:, None, None] * eye6
    b = active[:, None] * b

    # Loop factors (tiny): linearize replicated, fold in via Woodbury as in the
    # single-chip solver.
    delta = _woodbury_solve(g, D, U, b)
    return g.poses @ se3.se3_exp(jnp.where(jnp.isfinite(delta), delta, 0.0))


def _woodbury_solve(g: gsolver.PoseGraph, D, U, b):
    """Shared tail of the solve: fold loop factors into the tridiagonal system."""
    b_loop, Vw = gsolver.loop_gradient_and_whitened_columns(g, g.poses)
    rhs = jnp.concatenate([(b + b_loop)[..., None], Vw], axis=-1)
    sol = gsolver._tridiag_solve(D, U, rhs)
    return gsolver.woodbury_correct(Vw, sol[..., 0], sol[..., 1:])


# --- mesh-distributed LM optimize (the live back end's solve path) -----------------------


_mesh_cost = jax.jit(gsolver.graph_cost)
# Max twist-norm of the proposed step (right perturbation poses -> cand).
_mesh_step_norm = jax.jit(lambda poses, cand: jnp.max(jnp.linalg.norm(
    jax.vmap(se3.se3_log)(se3.inverse(poses) @ cand), axis=-1)))


def mesh_optimize(
    mesh: Mesh,
    g: gsolver.PoseGraph,
    max_iterations: int = 15,
    init_damping: float = 1e-4,
    solver: str = "schur",
) -> gsolver.PoseGraph:
    """Levenberg-Marquardt over the pose graph with the solve distributed over the mesh.

    The mesh analog of `graph/solver.py:optimize` — same damping schedule, same masked
    accept/reject — but each GN step runs either domain-decomposed (`solver="schur"`,
    `parallel/schur.py`) or with sharded linearization + psum reduction
    (`solver="chain"`). Accept/reject runs host-side: loop closures are rare events and
    the per-iteration cost compare is two scalars; every device program involved is
    compile-cached (static mesh, traced damping).
    """
    from lidar_graph_slam_tpu.parallel import schur as schur_mod

    if solver == "schur":
        step = lambda gg, d: schur_mod.schur_graph_step(mesh, gg, d)  # noqa: E731
    elif solver == "chain":
        step = lambda gg, d: distributed_graph_step(mesh, gg, d)      # noqa: E731
    else:
        raise ValueError(f"unknown mesh solver {solver!r}")

    poses = g.poses
    damping = float(init_damping)
    for _ in range(max_iterations):
        cur = g.replace(poses=poses)
        cand = step(cur, damping)
        cost0, cost1, step_norm = jax.device_get(
            (_mesh_cost(g, poses), _mesh_cost(g, cand), _mesh_step_norm(poses, cand))
        )
        accept = np.isfinite(cost1) and cost1 < cost0
        # Same termination contract as `graph/solver.py:optimize`: plateau only on
        # ACCEPTED steps; a REJECTED sub-millimeter step is the f32 floor (stuck) —
        # a warm re-solve pays one iteration.
        if accept:
            poses = cand
            if abs(cost0 - cost1) < 1e-5 * max(cost0, 1e-3):
                break
            damping = max(damping * 0.3, 1e-9)
        else:
            if step_norm < gsolver._STUCK_STEP_TOL:
                break
            damping = min(damping * 8.0, 1e6)
    return g.replace(poses=poses)


# --- batched top-k loop verification -----------------------------------------------------


def stack_pytrees(trees):
    """Stack a list of identically-shaped pytrees along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def shard_batch(mesh: Mesh, batched_tree, shared_tree):
    """Lay out a batched verification problem on the mesh: batch-leading pytrees sharded
    along the mesh axis, shared (per-source) arrays replicated. A batch that does not
    divide the mesh is left on the default device (a sub-mesh batch gains nothing from
    sharding; the jitted program runs unchanged either way)."""
    axis = list(mesh.shape.keys())[0]
    n_dev = mesh.devices.size
    batch = jax.tree.leaves(batched_tree)[0].shape[0]
    if batch % n_dev != 0:
        return batched_tree, shared_tree
    b_sh = NamedSharding(mesh, P(axis))
    r_sh = NamedSharding(mesh, P())
    batched = jax.tree.map(lambda x: jax.device_put(x, b_sh), batched_tree)
    shared = jax.tree.map(lambda x: jax.device_put(x, r_sh), shared_tree)
    return batched, shared
