"""SO(3)/SE(3) Lie-group algebra on jnp arrays.

Replacement for the reference's pose-conversion utility layer
(`lidar_graph_slam_utils/include/lidar_graph_slam_utils/lidar_graph_slam_utils.hpp:42-125`,
which shuffles poses between geometry_msgs / Eigen Matrix4f / gtsam::Pose3 / tf2) and for the
Eigen + GTSAM pose algebra used throughout the reference. Here there is a single canonical
representation — batched 4x4 homogeneous matrices — plus exp/log maps on the se(3) tangent
space used by the Gauss-Newton registration solvers and the pose-graph optimizer.

Conventions:
  * Twists are ordered (omega, v): rotation first, translation second — matching
    gtsam::Pose3::Logmap so factor noise orderings from the reference
    (`graph_based_slam/src/graph_based_slam.cpp:67-69`) carry over unchanged.
  * Quaternions are (w, x, y, z).
  * All functions broadcast over leading batch dimensions and are jit/vmap-safe
    (Taylor fallbacks around theta=0 instead of data-dependent branches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(omega: jax.Array) -> jax.Array:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta_sq: jax.Array):
    """Numerically-stable A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3."""
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / theta_sq)
    C = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) / (theta_sq * theta))
    return A, B, C


def so3_exp(omega: jax.Array) -> jax.Array:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation matrix."""
    theta_sq = jnp.sum(omega * omega, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(omega)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Stable near theta=0 and theta=pi (uses the diagonal-based extraction at pi).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # Generic branch: omega = theta/(2 sin theta) * vee(R - R^T)
    sin_theta = jnp.sin(theta)
    generic_scale = jnp.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * jnp.maximum(sin_theta, _EPS)),
    )
    w_generic = generic_scale[..., None] * vee(R - jnp.swapaxes(R, -1, -2))
    # Near-pi branch: axis from the diagonal of (R + I)/2.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.maximum((diag + 1.0) * 0.5, 0.0)
    # Pick the largest-magnitude axis component as the sign anchor.
    k = jnp.argmax(axis_sq, axis=-1)
    axis = jnp.sqrt(axis_sq)
    # Fix signs relative to anchor using off-diagonal sums: axis_i*axis_j = (R_ij+R_ji)/4 near pi.
    off = jnp.stack(
        [
            (R[..., 2, 1] + R[..., 1, 2]),  # yz -> relates y and z
            (R[..., 0, 2] + R[..., 2, 0]),  # xz -> relates x and z
            (R[..., 1, 0] + R[..., 0, 1]),  # xy -> relates x and y
        ],
        axis=-1,
    ) * 0.25
    def signed_axis(axis, off, k):
        # axis components with sign chosen consistent with anchor k
        ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
        oyz, oxz, oxy = off[..., 0], off[..., 1], off[..., 2]
        # anchor x
        sx_y = jnp.sign(oxy) * ay
        sx_z = jnp.sign(oxz) * az
        cand_x = jnp.stack([ax, jnp.where(oxy == 0, ay, sx_y), jnp.where(oxz == 0, az, sx_z)], axis=-1)
        # anchor y
        sy_x = jnp.sign(oxy) * ax
        sy_z = jnp.sign(oyz) * az
        cand_y = jnp.stack([jnp.where(oxy == 0, ax, sy_x), ay, jnp.where(oyz == 0, az, sy_z)], axis=-1)
        # anchor z
        sz_x = jnp.sign(oxz) * ax
        sz_y = jnp.sign(oyz) * ay
        cand_z = jnp.stack([jnp.where(oxz == 0, ax, sz_x), jnp.where(oyz == 0, ay, sz_y), az], axis=-1)
        cands = jnp.stack([cand_x, cand_y, cand_z], axis=-2)  # [..., 3 anchors, 3]
        return jnp.take_along_axis(cands, k[..., None, None], axis=-2)[..., 0, :]
    w_pi = theta[..., None] * signed_axis(axis, off, k)
    near_pi = (jnp.pi - theta) < 1e-3
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def _left_jacobian(omega: jax.Array) -> jax.Array:
    """SO(3) left Jacobian V: integrates translation in se(3) exp."""
    theta_sq = jnp.sum(omega * omega, axis=-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(omega)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + B[..., None, None] * W + C[..., None, None] * W2


def _left_jacobian_inv(omega: jax.Array) -> jax.Array:
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)
    W = hat(omega)
    W2 = W @ W
    half_theta = 0.5 * theta
    cot_term = jnp.where(
        theta_sq < 1e-8,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), _EPS)) / jnp.maximum(theta_sq, _EPS * _EPS),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * W2


def se3_exp(xi: jax.Array) -> jax.Array:
    """se(3) exp: twist [..., 6] (omega, v) -> homogeneous matrix [..., 4, 4]."""
    omega, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ v[..., None])[..., 0]
    return make_transform(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """SE(3) log: [..., 4, 4] -> twist [..., 6] (omega, v)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    omega = so3_log(R)
    v = (_left_jacobian_inv(omega) @ t[..., None])[..., 0]
    return jnp.concatenate([omega, v], axis=-1)


def make_transform(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def identity(dtype=jnp.float32, batch: tuple = ()) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form SE(3) inverse (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return A @ B


def between(A: jax.Array, B: jax.Array) -> jax.Array:
    """Relative transform A^{-1} B — same semantics as gtsam::Pose3::between used for
    odometry factors (`graph_based_slam/src/graph_based_slam.cpp:367-369`)."""
    return inverse(A) @ B


def transform_points(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply [..., 4, 4] to points [..., N, 3] (the reference's pcl::transformPointCloud,
    `lidar_scan_matcher/src/lidar_scan_matcher.cpp:275-294`)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def adjoint(T: jax.Array) -> jax.Array:
    """SE(3) adjoint [..., 6, 6] in (omega, v) ordering."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, Z], axis=-1)
    bottom = jnp.concatenate([hat(t) @ R, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# --- Quaternion / Euler conversions (reference utils hpp:50-84) -------------------------


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z), branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate extractions; pick the best-conditioned.
    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    qw = jnp.sqrt(jnp.maximum(qw, 1e-12)) * 0.5
    c0 = jnp.stack([qw[..., 0], (m21 - m12) / (4 * qw[..., 0]), (m02 - m20) / (4 * qw[..., 0]), (m10 - m01) / (4 * qw[..., 0])], axis=-1)
    c1 = jnp.stack([(m21 - m12) / (4 * qw[..., 1]), qw[..., 1], (m01 + m10) / (4 * qw[..., 1]), (m02 + m20) / (4 * qw[..., 1])], axis=-1)
    c2 = jnp.stack([(m02 - m20) / (4 * qw[..., 2]), (m01 + m10) / (4 * qw[..., 2]), qw[..., 2], (m12 + m21) / (4 * qw[..., 2])], axis=-1)
    c3 = jnp.stack([(m10 - m01) / (4 * qw[..., 3]), (m02 + m20) / (4 * qw[..., 3]), (m12 + m21) / (4 * qw[..., 3]), qw[..., 3]], axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # [..., 4, 4]
    scores = jnp.stack([tr, m00, m11, m22], axis=-1)
    k = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, k[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonicalize sign (w >= 0).
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_euler(q: jax.Array) -> jax.Array:
    """Quaternion -> (roll, pitch, yaw), matching the reference's
    `convert_quaternion_to_euler` (`lidar_graph_slam_utils.hpp:74-84`)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = jnp.arcsin(jnp.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def euler_to_quat(rpy: jax.Array) -> jax.Array:
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def pose7_to_matrix(pose7: jax.Array) -> jax.Array:
    """Compact pose [..., 7] = (tx,ty,tz, qw,qx,qy,qz) -> [..., 4, 4]."""
    return make_transform(quat_to_matrix(pose7[..., 3:]), pose7[..., :3])


def matrix_to_pose7(T: jax.Array) -> jax.Array:
    return jnp.concatenate([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], axis=-1)


def orthonormalize(R: jax.Array) -> jax.Array:
    """Project a near-rotation back onto SO(3) via SVD (drift control in long chains)."""
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(u @ vt)
    d = jnp.ones(R.shape[:-2] + (3,), dtype=R.dtype).at[..., 2].set(det)
    return (u * d[..., None, :]) @ vt
