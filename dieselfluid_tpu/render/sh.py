"""Order-2 (9-coefficient) spherical harmonics for environment lighting.

The splat rasterizer shades ~N*patch^2 samples; sampling the sky cubemap
per sample costs 4 random texel gathers per lookup, which dominated the
512k composite frame. Projecting the cubemap onto SH9 once per frame turns
every lookup into ~30 FLOPs of polynomial evaluation — no gathers at all —
at the cost of band-limiting the environment (the 48^3 sky
is smooth apart from the sun disc, which diffuse lighting blurs anyway).

Standard real-SH machinery (Ramamoorthi & Hanrahan 2001 constants); both
the projection and the evaluation are differentiable, so sky-texel and
sun-direction gradients keep flowing through the fluid shading.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Real SH basis constants for l = 0, 1, 2.
_C0 = 0.2820948   # Y00
_C1 = 0.4886025   # Y1{-1,0,1}
_C2 = 1.0925484   # Y2{-2,-1,1}
_C3 = 0.3153916   # Y20
_C4 = 0.5462742   # Y22


def sh9_basis(dirs: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) unit directions -> (..., 9) real SH basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return jnp.stack([
        jnp.full_like(x, _C0),
        _C1 * y, _C1 * z, _C1 * x,
        _C2 * x * y, _C2 * y * z,
        _C3 * (3.0 * z * z - 1.0),
        _C2 * x * z, _C4 * (x * x - y * y),
    ], axis=-1)


def project_sh9(cube: jnp.ndarray) -> jnp.ndarray:
    """Project a (6, S, S, 3) cubemap onto SH9 -> (9, 3) RGB coefficients.

    Texel solid angle for cube-face parameterization (u, v) in [-1, 1]:
    dOmega = 4 / (S^2 * (1 + u^2 + v^2)^{3/2}).
    """
    from dieselfluid_tpu.render.cubemap import cubemap_directions

    size = cube.shape[1]
    dirs = cubemap_directions(size)                    # (6, S, S, 3)
    # Reconstruct (u, v) magnitude from the unnormalized grid: |dir| before
    # normalization is sqrt(1 + u^2 + v^2); cubemap_directions returns unit
    # vectors, so recover the weight from the major-axis component.
    major = jnp.max(jnp.abs(dirs), axis=-1)            # cos of axis angle
    # |unit . axis| = 1/sqrt(1+u^2+v^2)  =>  (1+u^2+v^2)^{3/2} = major^-3
    d_omega = (4.0 / (size * size)) * major ** 3
    basis = sh9_basis(dirs)                            # (6, S, S, 9)
    return jnp.einsum("fhwn,fhwc,fhw->nc", basis, cube, d_omega,
                      precision=jax.lax.Precision.HIGHEST)


def eval_sh9(coeffs: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Reconstruct radiance along (..., 3) unit dirs -> (..., 3) RGB
    (clamped at zero — band-limited reconstruction can ring negative)."""
    return jnp.maximum(jnp.matmul(sh9_basis(dirs), coeffs,
                                  precision=jax.lax.Precision.HIGHEST), 0.0)
