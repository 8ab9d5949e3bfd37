"""The SPH hot loops: density + forces as stencil sweeps over dense cells.

Re-design of the reference's GPU kernels (ref: data/shaders/opencl/pcisph/
pci_density.c, pci_predict.c, data/shaders/glsl/pcisph/pcisph_kern0/1.comp):
instead of per-particle LSH table fetches (pcisph.h get_sample's fixed
150-iteration loop), every slot of the dense cell layout (ops/cellops.py)
meets the slots of its 3x3x3 cell neighbourhood directly — no sorts, no
global gathers, no top_k.

Everything here is an instantiation of ONE generic `stencil sweep`:

    out_c[i] = own_mask[i] * sum_j pair_fn(own[i], cand[j])_c

over the 27-cell neighbourhood, where `pair_fn` is a pure elementwise
function of broadcastable own (..., B, 1) / candidate (..., 1, W) channel
dicts. Density, forces, and BOTH backward passes are just different pair
functions; the backward pair function is derived from the forward one with
`jax.vjp` (the adjoint of a symmetric pairwise sum is another pairwise sum
with receiver/source roles swapped), so the public ops are `jax.custom_vjp`
functions and the dense pipeline differentiates end-to-end.

The sweep has two implementations with one contract, chosen when the
program is lowered (`jax.lax.platform_dependent`), never at run time:

  * `_sweep_triton` (CUDA): a Pallas kernel through Triton. One program per
    (x, y) cell column and 128-slot z chunk, looping over own blocks of a
    few cells; a block with no particle (or a ghost column) writes zeros
    and skips the pair math, so the sweep pays for occupied cells only.
    Each sweep kind has its own launch (`_TRITON_LAUNCH`).
  * `_sweep_xla` (every other platform): plain jnp over the whole plane —
    the reference on the DenseCellSpec layout, and what CPU tests run.

Cell edge >= h makes the d2 < h^2 test exclude the non-adjacent cells that a
candidate window may span automatically.

Self term: the (i,i) pair has r = 0 and contributes m*W0 to density —
matching field.density_with_self — and exactly zero force (masked rsqrt).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dieselfluid_tpu.ops.cellops import DenseCellSpec
from dieselfluid_tpu.ops.smoothing import KernelCoeffs

_EPS = 1e-12

# ---------------------------------------------------------------------------
# Generic stencil sweep
# ---------------------------------------------------------------------------


# Pair terms the plain sweep evaluates per step of its column loop: bounds
# its memory whether or not XLA fuses the pair math into the reduction.
_XLA_PAIRS_PER_STEP = 1 << 25


def _sweep_xla(pair_fn: Callable, in_names: Sequence[str], n_out: int,
               planes: Sequence[jnp.ndarray], spec: DenseCellSpec):
    """Plain-jnp stencil sweep: n_out plane_shape planes of per-slot sums.

    Each plane is viewed as (px, py, z cells, capacity). For one interior
    (x, y) column, every cell's own slots meet the slots of its 27
    neighbour cells, concatenated along one candidate axis, and the pair
    terms are summed over that axis (a (..., 1) term — `_bwd_pair` already
    summed it over the candidates — sums to itself). `lax.map` runs the
    column function over batches of columns sized to `_XLA_PAIRS_PER_STEP`
    pair terms.
    Ghost columns, ghost z blocks and empty slots are zero."""
    px, py, cap, zb = spec.px, spec.py, spec.capacity, spec.z_block
    nx, ny, nzi = spec.nx, spec.ny, spec.nz_padded
    cells = [p.reshape(px, py, spec.sub * zb, cap) for p in planes]

    def column(c):
        i, j = c // ny + 1, c % ny + 1
        own, cand = {}, {}
        for n, a in zip(in_names, cells):
            cols = {(dx, dy): jax.lax.dynamic_slice(
                a, (i + dx, j + dy, 0, 0), (1, 1) + a.shape[2:])[0, 0]
                for dx in (-1, 0, 1) for dy in (-1, 0, 1)}
            own[n] = cols[0, 0][zb:zb + nzi, :, None]
            cand[n] = jnp.concatenate(
                [cols[dx, dy][zb + dz:zb + nzi + dz]
                 for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dz in (-1, 0, 1)], axis=-1)[:, None, :]
        live = own["mask"][..., 0] > 0
        return tuple(jnp.where(live, jnp.sum(c, axis=-1), 0.0)
                     for c in pair_fn(own, cand))

    batch = max(1, _XLA_PAIRS_PER_STEP // (nzi * cap * 27 * cap))
    outs = jax.lax.map(column, jnp.arange(nx * ny, dtype=jnp.int32),
                       batch_size=min(batch, nx * ny))
    return [jnp.pad(o.reshape(nx, ny, nzi, cap),
                    ((1, 1), (1, 1), (zb, zb), (0, 0))).reshape(
                        spec.plane_shape) for o in outs]


# Triton launch of each sweep kind: (own block, num_warps, wide). `wide`
# keeps one (B, W) accumulator per output and reduces it once per block —
# the cheaper form for light pair functions; heavier ones (velocity
# channels, every backward pair) spill registers that way and instead sum
# each window into (B,) accumulators. Chosen by timing each sweep on an
# H100 80GB HBM3 (700 W) at the 1M dam break, capacity 32
# (tools/sweep_ab.py; PERF.md).
_TRITON_LAUNCH = {
    "density": (64, 8, True),
    "pressure": (64, 16, True),
    "force": (32, 16, False),
}


def _sweep_triton(pair_fn: Callable, in_names: Sequence[str], n_out: int,
                  planes: Sequence[jnp.ndarray], spec: DenseCellSpec,
                  block: int = 32, num_warps: int = 16, wide: bool = False,
                  interpret: bool = False):
    """`_sweep_xla`'s contract as a Pallas kernel through Triton.

    Grid: one program per (column row, 128-slot z chunk); the program loops
    over the chunk's own blocks of B = max(block, capacity) slots (whole
    cells). A live block loads its own channels as (B, 1) columns and, for
    each of the 9 (x, y) neighbour columns, a (1, W) candidate window from
    one cell below the block to one cell above it (W = B + 2 * capacity
    rounded up to a power of two for Triton; masked at the column ends),
    and accumulates the pair terms in registers: per window into (B,)
    sums, or with `wide` into (B, W) sums reduced once per block (a
    (B, 1) term — `_bwd_pair` already summed it — is never widened).
    Blocks that hold no particle, and every block of a ghost column, store
    zeros without touching the other channels."""
    cap, L, py = spec.capacity, spec.row_len, spec.py
    B = max(block, cap)
    W = 1 << (B + 2 * cap - 1).bit_length()
    n_in = len(in_names)
    m_idx = list(in_names).index("mask")
    per_chunk = 128 // B

    def kernel(*refs):
        in_refs, out_refs = refs[:n_in], refs[n_in:]
        r = pl.program_id(0)
        chunk = pl.program_id(1)
        i, j = r // py, r % py
        interior = (i >= 1) & (i <= spec.nx) & (j >= 1) & (j <= spec.ny)
        lane = jnp.arange(B, dtype=jnp.int32)
        wl = jnp.arange(W, dtype=jnp.int32)

        def own_block(b, carry):
            lo = chunk * 128 + b * B
            own_idx = r * L + lo + lane
            om = plgpu.load(in_refs[m_idx].at[own_idx])
            live = interior & (jnp.max(om) > 0.0)

            def compute():
                own = {n: plgpu.load(in_refs[p].at[own_idx])[:, None]
                       for p, n in enumerate(in_names) if p != m_idx}
                own["mask"] = om[:, None]
                zc = lo - cap + wl
                ok = (wl < B + 2 * cap) & (zc >= 0) & (zc < L)
                acc = [None] * n_out
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        nb = (r + dx * py + dy) * L + zc
                        cand = {n: plgpu.load(in_refs[p].at[nb], mask=ok,
                                              other=0.0)[None, :]
                                for p, n in enumerate(in_names)}
                        for o, c in enumerate(pair_fn(own, cand)):
                            if not (wide and c.shape[-1] == W):
                                c = jnp.sum(c, axis=1)
                            acc[o] = c if acc[o] is None else acc[o] + c
                return tuple(
                    jnp.where(om > 0.0,
                              a if a.ndim == 1 else jnp.sum(a, axis=1), 0.0)
                    for a in acc)

            def skip():
                return tuple(jnp.zeros((B,), jnp.float32)
                             for _ in range(n_out))

            res = jax.lax.cond(live, compute, skip)
            for o in range(n_out):
                plgpu.store(out_refs[o].at[own_idx], res[o])
            return carry

        jax.lax.fori_loop(0, per_chunk, own_block, 0)

    vma = frozenset().union(*(jax.typeof(p).vma for p in planes))
    size = spec.rows * L
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((size,), jnp.float32, vma=vma)]
        * n_out,
        grid=(spec.rows, spec.sub),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="dense_stencil_sweep",
    )(*[p.reshape(size) for p in planes])
    return [o.reshape(spec.plane_shape) for o in outs]


def _sweep(pair_fn: Callable, in_names: Sequence[str], n_out: int,
           planes: Sequence[jnp.ndarray], spec: DenseCellSpec,
           kind: str = "force"):
    """The production sweep: the Triton kernel (launched as
    `_TRITON_LAUNCH[kind]`; backward sweeps use the "force" launch) where
    the program is lowered for CUDA, `_sweep_xla` elsewhere (a
    lowering-time choice)."""
    block, num_warps, wide = _TRITON_LAUNCH[kind]
    outs = jax.lax.platform_dependent(
        *planes,
        cuda=lambda *p: tuple(_sweep_triton(
            pair_fn, in_names, n_out, p, spec, block=block,
            num_warps=num_warps, wide=wide)),
        default=lambda *p: tuple(_sweep_xla(pair_fn, in_names, n_out, p,
                                            spec)))
    return list(outs)


def _bwd_pair(pair_fn: Callable, n_out: int, grad_names: Sequence[str]):
    """Adjoint pair function of `pair_fn` via jax.vjp.

    For f_k = sum_j g(u_k, u_j), the cotangent w.r.t. u_k is
        sum_j [ d1 g(u_k, u_j)^T ct_k  +  d2 g(u_j, u_k)^T ct_j ]
    i.e. another pairwise sweep whose channels are the primal channels plus
    the scattered output cotangents (`ct_0..ct_{n-1}`).
    """
    ct_names = [f"ct_{o}" for o in range(n_out)]

    def pair(own, cand):
        own_p = {k: v for k, v in own.items() if not k.startswith("ct_")}
        cand_p = {k: v for k, v in cand.items() if not k.startswith("ct_")}
        shape = jnp.broadcast_shapes(own["x"].shape, cand["x"].shape)
        ct_own = tuple(jnp.broadcast_to(own[c], shape) for c in ct_names)
        ct_cand = tuple(jnp.broadcast_to(cand[c], shape) for c in ct_names)
        # own as receiver of cand's contribution
        _, vjp1 = jax.vjp(lambda p: pair_fn(p, cand_p), own_p)
        t1 = vjp1(ct_own)[0]
        # own as source of cand's received contribution (roles swapped)
        _, vjp2 = jax.vjp(lambda p: pair_fn(cand_p, p), own_p)
        t2 = vjp2(ct_cand)[0]
        return tuple(t1[g] + t2[g] for g in grad_names)

    return pair


def _mask_where(mask_plane, value_plane):
    """Zero ghost/garbage slots without NaN leakage (where, not multiply)."""
    return jnp.where(mask_plane > 0, value_plane, 0.0)


# ---------------------------------------------------------------------------
# Density
# ---------------------------------------------------------------------------

_D_IN = ("x", "y", "z", "mask")


def _density_pair(k: KernelCoeffs):
    """MASS-FREE kernel sum: the mass scale is applied OUTSIDE the sweep
    (density_planes), so `mass` can be a traced Materials scalar and its
    gradient flows through plain XLA."""
    a_w, h2 = float(k.a), float(k.h) ** 2

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        q = 1.0 - d2 / h2
        w = jnp.where(d2 < h2, a_w * q * q, 0.0) * cand["mask"]
        return (w,)

    return pair


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _density_sum(planes: Dict[str, jnp.ndarray], spec: DenseCellSpec,
                 k: KernelCoeffs) -> jnp.ndarray:
    (s,) = _sweep(_density_pair(k), _D_IN,
                  1, [planes[n] for n in _D_IN], spec, kind="density")
    return _mask_where(planes["mask"], s)


def _density_sum_fwd(planes, spec, k):
    return _density_sum(planes, spec, k), planes


def _density_sum_bwd(spec, k, planes, ct):
    ct = _mask_where(planes["mask"], ct)
    names = _D_IN + ("ct_0",)
    ins = [planes[n] for n in _D_IN] + [ct]
    grads = _sweep(_bwd_pair(_density_pair(k), 1, ("x", "y", "z")),
                   names, 3, ins, spec)
    out = {n: _mask_where(planes["mask"], g)
           for n, g in zip(("x", "y", "z"), grads)}
    return ({n: out.get(n, jnp.zeros_like(v)) for n, v in planes.items()},)


_density_sum.defvjp(_density_sum_fwd, _density_sum_bwd)


def density_planes(planes: Dict[str, jnp.ndarray], spec: DenseCellSpec,
                   k: KernelCoeffs, mass) -> jnp.ndarray:
    """rho plane (rows, sub, 128) from x/y/z/mask planes. Differentiable
    w.r.t. the position planes AND `mass` (which may be a traced scalar —
    capability of pcisph.h particle_density, plus the autodiff the reference
    never had)."""
    return mass * _density_sum(planes, spec, k)


# ---------------------------------------------------------------------------
# Forces (symmetric pressure + viscosity)
# ---------------------------------------------------------------------------

_F_IN = ("x", "y", "z", "vx", "vy", "vz", "mask", "rho", "press")
_F_IN_P = ("x", "y", "z", "mask", "rho", "press")   # pressure-only (mu == 0)


def _force_pair(k: KernelCoeffs, mass: float, mu: float):
    """mu == 0.0 compiles the pressure-only pair function — no velocity
    channels, no viscosity math (the PCISPH correction loop's case: its
    force sweeps run per iteration with viscosity hoisted out)."""
    h, b_w, c_w = float(k.h), float(k.b), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        live = (d2 > _EPS) & (d2 < h2) & (cand["mask"] > 0)
        inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
        dist = d2 * inv_d

        rho_i = jnp.maximum(own["rho"], _EPS)
        rho_j = jnp.maximum(cand["rho"], _EPS)
        pi_term = own["press"] / (rho_i * rho_i)
        q1 = 1.0 - dist / h
        o1d = b_w * q1 * q1
        coeff = pi_term + cand["press"] / (rho_j * rho_j)
        s_p = jnp.where(live, (mass * mass) * coeff * o1d * inv_d, 0.0)

        if mu == 0.0:
            return (s_p * dx, s_p * dy, s_p * dz)
        o2d = c_w * q1
        s_v = jnp.where(live, (mu * mass) * o2d / rho_j, 0.0)
        return (s_p * dx + s_v * (cand["vx"] - own["vx"]),
                s_p * dy + s_v * (cand["vy"] - own["vy"]),
                s_p * dz + s_v * (cand["vz"] - own["vz"]))

    return pair


_F_GRAD = ("x", "y", "z", "vx", "vy", "vz", "rho", "press")
_F_GRAD_P = ("x", "y", "z", "rho", "press")

# Prefolded fused-force channels: pq = press/max(rho,eps)^2 and
# iv = 1/max(rho,eps) are PER-SLOT quantities, so folding them outside the
# sweep removes all three per-pair divides
# from the hot pair function — same channel count (9), strictly less math.
# Forward-only: the custom-VJP backward below still sweeps the original
# rho/press-channel pair function (the folded forward is algebraically
# identical, same clamp).
_F_IN_FOLD = ("x", "y", "z", "vx", "vy", "vz", "mask", "pq", "iv")
_F_IN_FOLD_P = ("x", "y", "z", "mask", "pq")


def _force_fold_pair(k: KernelCoeffs, mass: float, mu: float):
    """Fused force pair on prefolded pq/iv channels (see _F_IN_FOLD)."""
    h, b_w, c_w = float(k.h), float(k.b), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        live = (d2 > _EPS) & (d2 < h2) & (cand["mask"] > 0)
        inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
        dist = d2 * inv_d
        q1 = 1.0 - dist / h
        o1d = b_w * q1 * q1
        coeff = own["pq"] + cand["pq"]
        s_p = jnp.where(live, (mass * mass) * coeff * o1d * inv_d, 0.0)
        if mu == 0.0:
            return (s_p * dx, s_p * dy, s_p * dz)
        o2d = c_w * q1
        s_v = jnp.where(live, (mu * mass) * o2d * cand["iv"], 0.0)
        return (s_p * dx + s_v * (cand["vx"] - own["vx"]),
                s_p * dy + s_v * (cand["vy"] - own["vy"]),
                s_p * dz + s_v * (cand["vz"] - own["vz"]))

    return pair


@partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def force_planes(planes: Dict[str, jnp.ndarray], rho_plane, press_plane,
                 spec: DenseCellSpec, k: KernelCoeffs, mass: float, mu: float):
    """(fx, fy, fz) planes: symmetric pressure force + viscosity
    (capability of pcisph.h pressure_force/viscosity_force), differentiable
    w.r.t. positions, velocities, densities and pressures. With mu == 0.0
    the velocity planes are neither read nor required in `planes`.

    The forward runs the PREFOLDED pair (pq/iv per-slot folds built as free
    elementwise plane math; no per-pair divides); the backward sweeps the
    original rho/press-channel pair — same math, same clamps."""
    m = planes["mask"]
    rho_c = jnp.maximum(rho_plane, _EPS)
    pq = jnp.where(m > 0, press_plane / (rho_c * rho_c), 0.0)
    ins = dict(planes)
    ins["pq"] = pq
    if mu == 0.0:
        names, kind = _F_IN_FOLD_P, "pressure"
    else:
        names, kind = _F_IN_FOLD, "force"
        ins["iv"] = jnp.where(m > 0, 1.0 / rho_c, 0.0)
    fx, fy, fz = _sweep(_force_fold_pair(k, mass, mu), names,
                        3, [ins[n] for n in names], spec, kind=kind)
    return _mask_where(m, fx), _mask_where(m, fy), _mask_where(m, fz)


def _force_fwd(planes, rho_plane, press_plane, spec, k, mass, mu):
    out = force_planes(planes, rho_plane, press_plane, spec, k, mass, mu)
    return out, (planes, rho_plane, press_plane)


def _force_bwd(spec, k, mass, mu, res, cts):
    planes, rho_plane, press_plane = res
    in_names = _F_IN_P if mu == 0.0 else _F_IN
    grad_names = _F_GRAD_P if mu == 0.0 else _F_GRAD
    m = planes["mask"]
    ins = dict(planes)
    ins["rho"], ins["press"] = rho_plane, press_plane
    names = in_names + ("ct_0", "ct_1", "ct_2")
    arrs = [ins[n] for n in in_names] + [_mask_where(m, c) for c in cts]
    grads = _sweep(_bwd_pair(_force_pair(k, mass, mu), 3, grad_names),
                   names, len(grad_names), arrs, spec)
    g = {n: _mask_where(m, gr) for n, gr in zip(grad_names, grads)}
    d_planes = {n: g.get(n, jnp.zeros_like(v)) for n, v in planes.items()}
    return (d_planes, g["rho"], g["press"])


force_planes.defvjp(_force_fwd, _force_bwd)


# ---------------------------------------------------------------------------
# Factored force sums — traced-material path
# ---------------------------------------------------------------------------
#
# The fused force kernel above bakes mass/mu as compile-time constants (fast
# path for the static-params WCSPH step). These two ops factor the scalars
# OUT of the pair functions — pressure sum lacks the mass^2, viscosity sum
# lacks the mu*mass — so the public wrappers can apply them as plain XLA
# multiplies and Materials gradients (mass, mu) flow with no extra kernel
# machinery. A dedicated viscosity sweep is also cheaper than the old trick
# of running the fused kernel against a zero pressure plane (which paid the
# full pressure math for all-zero output).

_P_IN = ("x", "y", "z", "mask", "rho", "press")
_P_GRAD = ("x", "y", "z", "rho", "press")


def _press_pair(k: KernelCoeffs):
    h, b_w = float(k.h), float(k.b)
    h2 = h * h

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        live = (d2 > _EPS) & (d2 < h2) & (cand["mask"] > 0)
        inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
        dist = d2 * inv_d
        rho_i = jnp.maximum(own["rho"], _EPS)
        rho_j = jnp.maximum(cand["rho"], _EPS)
        q1 = 1.0 - dist / h
        o1d = b_w * q1 * q1
        coeff = own["press"] / (rho_i * rho_i) + cand["press"] / (rho_j * rho_j)
        s_p = jnp.where(live, coeff * o1d * inv_d, 0.0)
        return (s_p * dx, s_p * dy, s_p * dz)

    return pair


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _press_sum(planes, rho_plane, press_plane, spec: DenseCellSpec,
               k: KernelCoeffs):
    ins = dict(planes)
    ins["rho"], ins["press"] = rho_plane, press_plane
    fx, fy, fz = _sweep(_press_pair(k), _P_IN, 3,
                        [ins[n] for n in _P_IN], spec, kind="pressure")
    m = planes["mask"]
    return _mask_where(m, fx), _mask_where(m, fy), _mask_where(m, fz)


def _press_sum_fwd(planes, rho_plane, press_plane, spec, k):
    out = _press_sum(planes, rho_plane, press_plane, spec, k)
    return out, (planes, rho_plane, press_plane)


def _press_sum_bwd(spec, k, res, cts):
    planes, rho_plane, press_plane = res
    m = planes["mask"]
    ins = dict(planes)
    ins["rho"], ins["press"] = rho_plane, press_plane
    names = _P_IN + ("ct_0", "ct_1", "ct_2")
    arrs = [ins[n] for n in _P_IN] + [_mask_where(m, c) for c in cts]
    grads = _sweep(_bwd_pair(_press_pair(k), 3, _P_GRAD),
                   names, len(_P_GRAD), arrs, spec)
    g = {n: _mask_where(m, gr) for n, gr in zip(_P_GRAD, grads)}
    d_planes = {n: g.get(n, jnp.zeros_like(v)) for n, v in planes.items()}
    return (d_planes, g["rho"], g["press"])


_press_sum.defvjp(_press_sum_fwd, _press_sum_bwd)


def pressure_force_planes(planes, rho_plane, press_plane, spec: DenseCellSpec,
                          k: KernelCoeffs, mass):
    """Symmetric pressure force (pcisph.h pressure_force capability) with the
    mass^2 scale applied outside the kernel — `mass` may be traced."""
    fx, fy, fz = _press_sum(planes, rho_plane, press_plane, spec, k)
    m2 = mass * mass
    return m2 * fx, m2 * fy, m2 * fz


_V_IN = ("x", "y", "z", "vx", "vy", "vz", "mask", "rho")
_V_GRAD = ("x", "y", "z", "vx", "vy", "vz", "rho")


def _visc_pair(k: KernelCoeffs):
    h, c_w = float(k.h), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        live = (d2 > _EPS) & (d2 < h2) & (cand["mask"] > 0)
        inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
        dist = d2 * inv_d
        rho_j = jnp.maximum(cand["rho"], _EPS)
        o2d = c_w * (1.0 - dist / h)
        s_v = jnp.where(live, o2d / rho_j, 0.0)
        return (s_v * (cand["vx"] - own["vx"]),
                s_v * (cand["vy"] - own["vy"]),
                s_v * (cand["vz"] - own["vz"]))

    return pair


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _visc_sum(planes, rho_plane, spec: DenseCellSpec, k: KernelCoeffs):
    ins = dict(planes)
    ins["rho"] = rho_plane
    fx, fy, fz = _sweep(_visc_pair(k), _V_IN, 3,
                        [ins[n] for n in _V_IN], spec)
    m = planes["mask"]
    return _mask_where(m, fx), _mask_where(m, fy), _mask_where(m, fz)


def _visc_sum_fwd(planes, rho_plane, spec, k):
    return _visc_sum(planes, rho_plane, spec, k), (planes, rho_plane)


def _visc_sum_bwd(spec, k, res, cts):
    planes, rho_plane = res
    m = planes["mask"]
    ins = dict(planes)
    ins["rho"] = rho_plane
    names = _V_IN + ("ct_0", "ct_1", "ct_2")
    arrs = [ins[n] for n in _V_IN] + [_mask_where(m, c) for c in cts]
    grads = _sweep(_bwd_pair(_visc_pair(k), 3, _V_GRAD),
                   names, len(_V_GRAD), arrs, spec)
    g = {n: _mask_where(m, gr) for n, gr in zip(_V_GRAD, grads)}
    d_planes = {n: g.get(n, jnp.zeros_like(v)) for n, v in planes.items()}
    return (d_planes, g["rho"])


_visc_sum.defvjp(_visc_sum_fwd, _visc_sum_bwd)


def viscosity_force_planes(planes, rho_plane, spec: DenseCellSpec,
                           k: KernelCoeffs, mass, mu):
    """Laplacian viscosity force (pcisph.h viscosity_force capability) with
    the mu*mass scale applied outside — both may be traced scalars."""
    fx, fy, fz = _visc_sum(planes, rho_plane, spec, k)
    s = mu * mass
    return s * fx, s * fy, s * fz


# ---------------------------------------------------------------------------
# Prefolded pressure sweep — the PCISPH correction loop's hot kernel
# ---------------------------------------------------------------------------
#
# The symmetric pressure coefficient p_i/rho_i^2 + p_j/rho_j^2 is a sum of
# PER-SLOT quantities: folding pq = p/rho_ff^2 into one plane outside the
# sweep drops the press kernel from 6 input channels to 5 and removes both
# per-pair divides — and distributed callers exchange
# ONE ghost plane per correction iteration instead of two. Forward-only
# (the correction while_loop is not differentiated; the unrolled grad path
# uses the rho/press-channel sweeps above).

_PQ_IN = ("x", "y", "z", "mask", "pq")


def _press_pq_pair(k: KernelCoeffs):
    h, b_w = float(k.h), float(k.b)
    h2, inv_h = h * h, 1.0 / h

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        live = (d2 > _EPS) & (d2 < h2) & (cand["mask"] > 0)
        inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
        q1 = 1.0 - d2 * inv_d * inv_h
        s_p = jnp.where(live, (own["pq"] + cand["pq"]) * (b_w * q1 * q1)
                        * inv_d, 0.0)
        return (s_p * dx, s_p * dy, s_p * dz)

    return pair


def pressure_force_pq_planes(planes, pq_plane, spec: DenseCellSpec,
                             k: KernelCoeffs, mass):
    """Pressure force from a prefolded pq = press/rho_ff^2 plane; the mass^2
    scale applies outside (mass may be traced). Same math as
    pressure_force_planes given pq built with the same clamped divisor."""
    ins = dict(planes)
    ins["pq"] = pq_plane
    fx, fy, fz = _sweep(_press_pq_pair(k), _PQ_IN, 3,
                        [ins[n] for n in _PQ_IN], spec, kind="pressure")
    m = planes["mask"]
    m2 = mass * mass
    return (m2 * _mask_where(m, fx), m2 * _mask_where(m, fy),
            m2 * _mask_where(m, fz))
