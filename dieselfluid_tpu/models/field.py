"""SPH discrete field operators over fixed-degree neighborhoods.

Array-program re-implementation of the reference's SPHField operator suite
(ref: model/field/sph_field.go:124-294). Each operator is a fully vectorized
gather + masked reduction over the (N, K) neighbor table — the reference's
per-particle Go loops become one fused XLA program; no Python loops anywhere.

LAYOUT RULE: no large (N, K, 3) intermediates. A trailing dimension of 3
can pad to an accelerator's wide minor tile (up to a 42x memory/bandwidth
blowup), so all
per-neighbor geometry is computed as separate x/y/z (N, K) planes and only
stacked into (..., 3) at the final per-particle reduction.

Every operator takes *query* arrays (the N particles being updated) and
optional *source* arrays (the M particles the neighbor table indexes into,
defaulting to the query arrays). Under spatial sharding the query axis is the
local shard and the source arrays are the all-gathered (or halo-exchanged)
neighbor pool — the same code path serves single-chip and SPMD execution.

Conventions matched to the reference:
  * density excludes the self term (ref: sph_field.go:163 `i != pIndex`);
    density_at (continuous DensityF) *includes* W0 (ref: sph_field.go:139);
    density_with_self is the physically-consistent variant the solvers use.
  * gradient uses the symmetric (f_i/rho_i^2 + f_j/rho_j^2) form scaled by
    rho_i * mass (ref: sph_field.go:175-200); pressure_force is the standard
    momentum-conserving -m^2 form.
  * kernel gradient direction is normalize(x_j - x_i) with magnitude -O1D
    (ref: sph_field.go:190-191 + kernel/std_kernel.go Grad).
  * viscosity laplacian-force: sum_j mass * (v_j - v_i)/rho_j * O2D(r)
    (ref: sph_field.go:251-269; the reference multiplies the accumulator by
    mass *inside* the loop — identity at its mass=1 operating point).

Masked lanes use the where-trick on denominators/sqrt so no NaN/Inf leaks
into gradients through masked-out slots.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.neighbors.types import Neighborhood
from dieselfluid_tpu.ops.smoothing import (
    KernelCoeffs,
    d2w_visc,
    dw_spiky,
    w0,
    w_poly6,
)

_EPS = 1e-12


def _src(source, query):
    return query if source is None else source


class Geometry(NamedTuple):
    """Per-slot neighbor geometry as component planes (all (N, K))."""

    dx: jnp.ndarray
    dy: jnp.ndarray
    dz: jnp.ndarray
    dist: jnp.ndarray
    inv_dist: jnp.ndarray   # 1/dist, 0 on degenerate slots


def _geometry(query_pos, source_pos, nb: Neighborhood) -> Geometry:
    """Displacement components, distance and inverse distance (query -> nbr).

    Component-wise to keep every intermediate (N, K): gathers index the
    source coordinate planes separately.
    """
    idx = nb.idx
    dx = source_pos[:, 0][idx] - query_pos[:, 0:1]
    dy = source_pos[:, 1][idx] - query_pos[:, 1:2]
    dz = source_pos[:, 2][idx] - query_pos[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    nonzero = d2 > _EPS
    safe_sqrt = jnp.sqrt(jnp.where(nonzero, d2, 1.0))
    dist = jnp.where(nonzero, safe_sqrt, 0.0)
    inv = jnp.where(nonzero, 1.0 / safe_sqrt, 0.0)
    return Geometry(dx, dy, dz, dist, inv)


def density(pos, nb: Neighborhood, params: FluidParams, source_pos=None):
    """rho_i = sum_{j != i} m W(r_ij). ref: sph_field.go:155-173 (self excluded)."""
    g = _geometry(pos, _src(source_pos, pos), nb)
    w = w_poly6(g.dist, KernelCoeffs.build(params.h))
    return params.mass * jnp.sum(w * nb.mask, axis=-1)


def density_with_self(pos, nb: Neighborhood, params: FluidParams, source_pos=None):
    """Physically-standard summation density INCLUDING the m W(0) self term."""
    k = KernelCoeffs.build(params.h)
    return density(pos, nb, params, source_pos) + params.mass * w0(k)


def density_at(query_pos, source_pos, nb: Neighborhood, params: FluidParams):
    """Continuous density at arbitrary positions, *with* the unscaled W0 term.

    ref: sph_field.go DensityF:137-153.
    """
    k = KernelCoeffs.build(params.h)
    g = _geometry(query_pos, source_pos, nb)
    w = w_poly6(g.dist, k)
    return w0(k) + params.mass * jnp.sum(w * nb.mask, axis=-1)


def interpolate(query_pos, source_pos, source_density, values, nb: Neighborhood,
                params: FluidParams):
    """Scalar interpolation sum_j (m/rho_j) W f_j. ref: sph_field.go:124-135."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(query_pos, source_pos, nb)
    rho_j = source_density[nb.idx]
    weight = params.mass / jnp.maximum(rho_j, _EPS) * w_poly6(g.dist, k)
    return jnp.sum(weight * values[nb.idx] * nb.mask, axis=-1)


def _grad_w_planes(g: Geometry, k: KernelCoeffs):
    """Kernel gradient component planes: dir * -O1D (ref Grad semantics)."""
    mag = -dw_spiky(g.dist, k) * g.inv_dist          # (N, K) scalar per slot
    return g.dx * mag, g.dy * mag, g.dz * mag


def gradient(pos, rho, values, nb: Neighborhood, params: FluidParams,
             source_pos=None, source_rho=None, source_values=None):
    """Reference symmetric gradient, scaled by rho_i * m (parity operator).

    grad_i = rho_i m sum_j (f_i/rho_i^2 + f_j/rho_j^2) gradW(r_ij, dir_ij)
    ref: sph_field.go Gradient:175-200.
    """
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_i = jnp.maximum(rho, _EPS)
    rho_j = jnp.maximum(_src(source_rho, rho)[nb.idx], _EPS)
    coeff = (values / (rho_i * rho_i))[:, None] \
        + _src(source_values, values)[nb.idx] / (rho_j * rho_j)
    gwx, gwy, gwz = _grad_w_planes(g, k)
    cm = coeff * nb.mask
    scale = rho * params.mass
    return jnp.stack([
        jnp.sum(gwx * cm, axis=-1) * scale,
        jnp.sum(gwy * cm, axis=-1) * scale,
        jnp.sum(gwz * cm, axis=-1) * scale,
    ], axis=-1)


def pressure_force(pos, rho, pressure, nb: Neighborhood, params: FluidParams,
                   source_pos=None, source_rho=None, source_pressure=None):
    """Standard symmetric SPH pressure force (momentum-conserving).

    F_i = -m^2 sum_j (p_i/rho_i^2 + p_j/rho_j^2) gradW(r_ij). The reference's
    Gradient scales by rho_i*m instead (ref: sph_field.go:199) — ~rho/m times
    the physical force; the physical solvers use this form.
    """
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_i = jnp.maximum(rho, _EPS)
    rho_j = jnp.maximum(_src(source_rho, rho)[nb.idx], _EPS)
    coeff = (pressure / (rho_i * rho_i))[:, None] \
        + _src(source_pressure, pressure)[nb.idx] / (rho_j * rho_j)
    gwx, gwy, gwz = _grad_w_planes(g, k)
    cm = coeff * nb.mask
    m2 = -(params.mass ** 2)
    return jnp.stack([
        jnp.sum(gwx * cm, axis=-1) * m2,
        jnp.sum(gwy * cm, axis=-1) * m2,
        jnp.sum(gwz * cm, axis=-1) * m2,
    ], axis=-1)


def divergence(pos, rho, vec_values, nb: Neighborhood, params: FluidParams,
               source_pos=None, source_rho=None, source_values=None):
    """div_i = sum_j (m/rho_j) v_j . gradW. ref: sph_field.go Div:203-228."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = jnp.maximum(_src(source_rho, rho)[nb.idx], _EPS)
    vv = _src(source_values, vec_values)
    sx = vv[:, 0][nb.idx]
    sy = vv[:, 1][nb.idx]
    sz = vv[:, 2][nb.idx]
    gwx, gwy, gwz = _grad_w_planes(g, k)
    dots = sx * gwx + sy * gwy + sz * gwz
    return jnp.sum(dots * (params.mass / rho_j) * nb.mask, axis=-1)


def laplacian(pos, rho, values, nb: Neighborhood, params: FluidParams,
              source_pos=None, source_rho=None, source_values=None):
    """lap_i = sum_j m (f_j - f_i)/rho_j O2D(r). ref: sph_field.go:230-249."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = jnp.maximum(_src(source_rho, rho)[nb.idx], _EPS)
    df = _src(source_values, values)[nb.idx] - values[:, None]
    contrib = params.mass * df / rho_j * d2w_visc(g.dist, k)
    return jnp.sum(contrib * nb.mask, axis=-1)


def laplacian_force(pos, vel, rho, nb: Neighborhood, params: FluidParams,
                    source_pos=None, source_vel=None, source_rho=None):
    """Viscosity force sum_j m (v_j - v_i)/rho_j O2D(r). ref: sph_field.go:251-269."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = jnp.maximum(_src(source_rho, rho)[nb.idx], _EPS)
    sv = _src(source_vel, vel)
    w = d2w_visc(g.dist, k) / rho_j * nb.mask
    out = []
    for c in range(3):
        dv = sv[:, c][nb.idx] - vel[:, c:c + 1]
        out.append(params.mass * jnp.sum(dv * w, axis=-1))
    return jnp.stack(out, axis=-1)


def curl(pos, rho, vec_values, nb: Neighborhood, params: FluidParams,
         source_pos=None, source_rho=None, source_values=None):
    """Non-symmetric curl sum_j cross(v_j m/rho_j, gradW). ref: sph_field.go:272-294."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = jnp.maximum(_src(source_rho, rho)[nb.idx], _EPS)
    vv = _src(source_values, vec_values)
    s = params.mass / rho_j * nb.mask
    ax = vv[:, 0][nb.idx] * s
    ay = vv[:, 1][nb.idx] * s
    az = vv[:, 2][nb.idx] * s
    bx, by, bz = _grad_w_planes(g, k)
    return jnp.stack([
        jnp.sum(ay * bz - az * by, axis=-1),
        jnp.sum(az * bx - ax * bz, axis=-1),
        jnp.sum(ax * by - ay * bx, axis=-1),
    ], axis=-1)
