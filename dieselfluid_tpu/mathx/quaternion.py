"""Quaternion math as (..., 4) [w, x, y, z] arrays — batch/vmap friendly.

ref: math/quaternion/quaternion.go (float64 scalar structs there; here any
leading batch shape, float32 by default, differentiable).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat(w, x, y, z):
    return jnp.stack([jnp.asarray(w, jnp.float32), jnp.asarray(x, jnp.float32),
                      jnp.asarray(y, jnp.float32), jnp.asarray(z, jnp.float32)], axis=-1)


def pure(x, y, z):
    """Pure quaternion (no scalar part). ref: quaternion.go Pure."""
    return quat(jnp.zeros_like(jnp.asarray(x, jnp.float32)), x, y, z)


def scalar(w):
    w = jnp.asarray(w, jnp.float32)
    z = jnp.zeros_like(w)
    return quat(w, z, z, z)


def conj(q):
    """(w,x,y,z) -> (w,-x,-y,-z). ref: quaternion.go Conj."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], q.dtype)


def neg(q):
    return -q


def norm2(q):
    return jnp.sum(q * q, axis=-1)


def norm(q):
    return jnp.sqrt(norm2(q))


def add(*qs):
    """Vector sum. ref: quaternion.go Sum."""
    out = qs[0]
    for q in qs[1:]:
        out = out + q
    return out


def prod(*qs):
    """Non-commutative Hamilton product, left to right. ref: quaternion.go Prod."""
    out = qs[0]
    for q in qs[1:]:
        w1, x1, y1, z1 = jnp.moveaxis(out, -1, 0)
        w2, x2, y2, z2 = jnp.moveaxis(q, -1, 0)
        out = jnp.stack([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ], axis=-1)
    return out


def unit(q):
    return q / norm(q)[..., None]


def inverse(q):
    """Conjugate rescaled so q q^-1 = 1. ref: quaternion.go Inv."""
    return conj(q) / norm2(q)[..., None]


def to_euler(q):
    """(phi, theta, psi) aerospace XYZ convention. ref: quaternion.go Euler."""
    r = unit(q)
    w, x, y, z = jnp.moveaxis(r, -1, 0)
    phi = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    theta = jnp.arcsin(jnp.clip(2 * (w * y - z * x), -1.0, 1.0))
    psi = jnp.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))
    return phi, theta, psi


def from_euler(phi, theta, psi):
    """ref: quaternion.go FromEuler."""
    phi, theta, psi = (jnp.asarray(a, jnp.float32) for a in (phi, theta, psi))
    cp, sp = jnp.cos(phi / 2), jnp.sin(phi / 2)
    ct, st = jnp.cos(theta / 2), jnp.sin(theta / 2)
    cs, ss = jnp.cos(psi / 2), jnp.sin(psi / 2)
    return jnp.stack([
        cp * ct * cs + sp * st * ss,
        sp * ct * cs - cp * st * ss,
        cp * st * cs + sp * ct * ss,
        cp * ct * ss - sp * st * cs,
    ], axis=-1)


def rot_mat(q):
    """(..., 3, 3) rotation matrix. ref: quaternion.go RotMat."""
    r = unit(q)
    w, x, y, z = jnp.moveaxis(r, -1, 0)
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)], -1)
    row1 = jnp.stack([2 * (w * z + y * x), 1 - 2 * (z * z + x * x), 2 * (y * z - w * x)], -1)
    row2 = jnp.stack([2 * (z * x - w * y), 2 * (w * x + z * y), 1 - 2 * (x * x + y * y)], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate(q, v):
    """Rotate (..., 3) vectors by quaternion(s): q v q^-1."""
    return jnp.einsum("...ij,...j->...i", rot_mat(q), v,
                      precision=jax.lax.Precision.HIGHEST)


def from_axis_angle(axis, angle):
    """Unit-axis rotation quaternion."""
    axis = jnp.asarray(axis, jnp.float32)
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    angle = jnp.asarray(angle, jnp.float32)
    half = angle / 2
    return jnp.concatenate(
        [jnp.cos(half)[..., None], axis * jnp.sin(half)[..., None]], axis=-1
    )
