"""4x4 transforms, TRS composition, and projection matrices.

ref: render/transform/transform.go (translate / axis-angle / Euler rotate),
math/matrix/matrix.go ProjectionMatF:546-550, render/glr/util.go MatrixTRS.
Matrices are (..., 4, 4) row-major like the reference's flat Mat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dieselfluid_tpu.mathx import quaternion as Q

DEG2RAD = 0.01745329251994444444


def identity():
    return jnp.eye(4, dtype=jnp.float32)


def translate(t):
    """Translation matrix (row-major: translation in the last column)."""
    t = jnp.asarray(t, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(t)


def scale(s):
    s = jnp.asarray(s, jnp.float32)
    return jnp.diag(jnp.concatenate([s, jnp.ones(1, jnp.float32)]))


def rotate_axis_angle(axis, angle):
    """Axis-angle rotation as 4x4. ref: transform.go Rotate:36."""
    r3 = Q.rot_mat(Q.from_axis_angle(axis, angle))
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(r3)


def rotate_euler(phi, theta, psi):
    """Euler rotation as 4x4. ref: transform.go EulerRotate:59."""
    r3 = Q.rot_mat(Q.from_euler(phi, theta, psi))
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(r3)


def trs(t, r4, s):
    """Translate*Rotate*Scale composite. ref: render/glr/util.go MatrixTRS."""
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(translate(t), r4, precision=hi), scale(s),
                      precision=hi)


def projection(fov_deg: float, aspect: float, near: float, far: float):
    """Perspective projection. ref: matrix.go ProjectionMatF:546-550 —
    s = 1/tan(fov/2), row-major {s/aspect,0,0,0, 0,s,0,0,
    0,0,-f/(f-n),-fn/(f-n), 0,0,-1,0}."""
    s = 1.0 / jnp.tan((fov_deg / 2.0) * DEG2RAD)
    f, n = far, near
    return jnp.asarray([
        [s / aspect, 0.0, 0.0, 0.0],
        [0.0, s, 0.0, 0.0],
        [0.0, 0.0, -f / (f - n), (-f * n) / (f - n)],
        [0.0, 0.0, -1.0, 0.0],
    ], jnp.float32)


def apply(m, v):
    """Apply 4x4 to (..., 3) points (w=1), perspective-divide-free."""
    vh = jnp.concatenate([v, jnp.ones(v.shape[:-1] + (1,), v.dtype)], axis=-1)
    return jnp.einsum("ij,...j->...i", m, vh,
                      precision=jax.lax.Precision.HIGHEST)


def apply_point(m, v):
    """Apply + perspective divide -> (..., 3)."""
    out = apply(m, v)
    return out[..., :3] / out[..., 3:4]


def inverse_rigid(m):
    """Fast inverse of a rigid TRS (rotation+translation, unit scale):
    view = inverse(camera transform) — ref: render/camera/camera.go Update:76
    inverts the full matrix; rigid inverse is exact and cheaper."""
    r = m[:3, :3]
    t = m[:3, 3]
    rt = r.T
    m_out = jnp.eye(4, dtype=m.dtype)
    m_out = m_out.at[:3, :3].set(rt)
    return m_out.at[:3, 3].set(
        -jnp.matmul(rt, t, precision=jax.lax.Precision.HIGHEST))
