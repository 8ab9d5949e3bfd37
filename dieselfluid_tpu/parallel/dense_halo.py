"""Multi-chip dense pipeline: the Pallas production path under shard_map.

parallel/halo.py distributes the XLA cell-grid solver; this module
distributes the *dense-cell Pallas* solver (ops/cellops.py +
ops/pallas_sph.py) — the path the single-chip benchmarks run — so the
flagship kernels scale over the ICI torus:

  * The domain is split into x-slabs of WHOLE CELL COLUMNS (slab width =
    nxd * h exactly, so every shard's lattice is a window of one global
    lattice — cross-face pair geometry is identical to the single-chip
    binning).
  * The dense layout already carries a one-column ghost ring
    (cellops.DenseCellSpec px = nx + 2). Here the ghost ring is FILLED:
    each shard ppermutes its boundary cell-columns — (py, sub, 128) plane
    slabs per channel — to its neighbors. Halos are regular arrays, not
    packed particle lists: no argsort-packing, no fixed halo capacity, no
    ghost overflow. Edge shards keep zero ghosts (ppermute zero-fills
    destinations nobody addresses).
  * After the density sweep, one more column exchange ships owner-computed
    rho/pressure, so the symmetric force sweep is exact across faces
    (the same two-round protocol as halo.py, at plane granularity).
  * Boundary particles live in static per-slab stores (SlabState.boundary_*)
    and scatter into the local planes beside the fluid — each slab keeps
    only the boundary INSIDE its slab, because the ghost-column exchange
    ships face-column boundary cells to neighbors exactly like fluid cells
    (no replication, no double counting).
  * Migration + fixed-capacity particle stores are shared with halo.py
    (SlabState, _migrate); global diagnostics ride pmax/psum, per-slab live
    counts come back as an (n_dev,) load-balance vector.

Solvers: `make_dense_halo_wcsph_step` and `make_dense_halo_pcisph_step` —
the latter is the reference's flagship GPU solver at multi-chip scale
(ref: solver/pcisph/pcisph_gpu_darwin.go:249-286; the reference has no
multi-device story at all, SURVEY §2.11). Its correction loop re-exchanges
the predicted-position ghost columns and the pressure/divisor columns every
iteration, exits on the GLOBAL pmax density error, and optionally
warm-starts from the pressure carried in SlabState (same flag and default
as every other PCISPH path).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_plane,
    gather_planes,
)
from dieselfluid_tpu.ops.pallas_sph import (
    density_planes,
    force_planes,
    pressure_force_planes,
    pressure_force_pq_planes,
)
from dieselfluid_tpu.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu.parallel.halo import AXIS, SlabState, _migrate
from dieselfluid_tpu.solvers.integrate import box_collide, semi_implicit_euler


@dataclasses.dataclass(frozen=True)
class DenseSlabSpec:
    """Cell-aligned slab decomposition for the dense pipeline.

    The global x-extent is DERIVED: hi_x = lo + n_dev * nxd * cell, so slab
    faces coincide with cell faces on one global lattice.
    """

    n_dev: int
    capacity: int              # particle slots per device
    migrate_capacity: int      # slots per face migration buffer
    cell: float                # cell edge == kernel radius h
    nxd: int                   # x cell columns per device
    lo: float = -1.0
    hi_yz: float = 1.0
    cell_capacity: int = 16

    @staticmethod
    def build(n_dev: int, h: float, capacity: int, migrate_capacity: int,
              lo: float = -1.0, hi: float = 1.0,
              cell_capacity: int = 16) -> "DenseSlabSpec":
        nxd = max(1, int(-(-((hi - lo) / n_dev) // h)))
        return DenseSlabSpec(n_dev=n_dev, capacity=capacity,
                             migrate_capacity=migrate_capacity, cell=float(h),
                             nxd=nxd, lo=lo, hi_yz=hi,
                             cell_capacity=cell_capacity)

    @staticmethod
    def build_for_state(state, n_dev: int, h: float, migrate_capacity: int,
                        lo: float = -1.0, hi: float = 1.0,
                        cell_capacity: int = 16,
                        headroom: float = 2.0) -> "DenseSlabSpec":
        """Like `build`, but the per-shard store capacity is DERIVED from
        the initial slab-occupancy histogram (+ headroom, rounded up to a
        multiple of 64) instead of hand-tuned (round-4 verdict #7)."""
        import numpy as np

        probe = DenseSlabSpec.build(n_dev, h, capacity=1,
                                    migrate_capacity=migrate_capacity,
                                    lo=lo, hi=hi, cell_capacity=cell_capacity)
        pos = np.asarray(state.pos)
        bx = np.clip(((pos[:, 0] - lo) / probe.slab_width).astype(int),
                     0, n_dev - 1)
        counts = np.bincount(bx, minlength=n_dev)
        cap = max(64, int(-(-counts.max() * headroom // 64)) * 64)
        return dataclasses.replace(probe, capacity=cap)

    @property
    def slab_width(self) -> float:
        return self.nxd * self.cell

    @property
    def hi_x(self) -> float:
        return self.lo + self.n_dev * self.slab_width

    @property
    def local_spec(self) -> DenseCellSpec:
        """Per-shard dense layout: nxd owned columns (+ ghost ring from the
        base layout) over the full y/z extent, plus a sacrificial z band
        (2 cells of gap + 1 cell) where dead particle slots park without any
        real cell's stencil reaching them."""
        base = DenseCellSpec.for_domain(
            (0.0, self.lo, self.lo),
            (self.slab_width, self.hi_yz, self.hi_yz + 3.0 * self.cell),
            self.cell, capacity=self.cell_capacity)
        return dataclasses.replace(base, nx=self.nxd)

    @property
    def park_z(self) -> float:
        """z that bins into the last (sacrificial) cell layer."""
        return self.hi_yz + 2.5 * self.cell


# ---------------------------------------------------------------------------
# plane-column halo exchange
# ---------------------------------------------------------------------------


def _exchange_ghost_columns(plane, spec: DenseCellSpec, axis=AXIS):
    """Fill the x ghost columns of a local plane from the neighbors' owned
    boundary columns. plane: (rows, sub, 128) with rows = (nx+2) * py.

    Send right-owned column -> right neighbor's low ghost; left-owned
    column -> left neighbor's high ghost. Non-wrapping permutations leave
    edge ghosts zero (ppermute zero-fills unaddressed outputs).
    """
    py = spec.py
    n = jax.lax.axis_size(axis)
    nx = spec.nx
    to_right = [(i, i + 1) for i in range(n - 1)]
    to_left = [(i + 1, i) for i in range(n - 1)]
    from_left = jax.lax.ppermute(plane[nx * py:(nx + 1) * py], axis, to_right)
    from_right = jax.lax.ppermute(plane[py:2 * py], axis, to_left)
    return jnp.concatenate(
        [from_left, plane[py:(nx + 1) * py], from_right], axis=0)


def _exchange_all(planes: dict, spec: DenseCellSpec, names, axis=AXIS):
    return {n: (_exchange_ghost_columns(planes[n], spec, axis)
                if n in names else planes[n])
            for n in planes}


def _ghost_ct_sync(plane, spec: DenseCellSpec):
    """Identity forward; ghost-fills the COTANGENT on the backward pass.

    The backward sweeps compute gradients for OWNED rows only: the
    source-role cotangent of a cross-face pair (interior i receives from
    ghost j) reaches j's owner through the owner's OWN backward sweep —
    whose ct plane must then hold the receiver's cotangent in its ghost
    columns. This op is the transpose twin of the forward ghost exchange:
    wrap every sweep OUTPUT in the sharded step with it so each shard's
    backward sweep sees its neighbors' cotangents. Without it the
    distributed material/position gradients silently lose the cross-face
    source-role terms (~6% at 4 slabs / 1k particles — round-3 verdict,
    next-step #3, found by finite differences). The sweeps' border-zeroed
    outputs guarantee the ordinary exchange-transpose path contributes
    exactly zero for the same pairs, so nothing is double-counted."""

    @jax.custom_vjp
    def f(p):
        return p

    def fwd(p):
        return p, None

    def bwd(_, ct):
        return (_exchange_ghost_columns(ct, spec),)

    f.defvjp(fwd, bwd)
    return f(plane)


def _shift_ghost_x(planes: dict, spec: DenseCellSpec, slab_width: float):
    """x is LOCAL per shard — shift received ghost columns by +-slab_width so
    pair distances stay globally consistent. Mutates/returns planes['x']."""
    py = spec.py
    ghost_mask_lo = planes["mask"][:py]
    ghost_mask_hi = planes["mask"][(spec.nx + 1) * py:]
    planes["x"] = jnp.concatenate([
        planes["x"][:py] - jnp.where(ghost_mask_lo > 0, slab_width, 0.0),
        planes["x"][py:(spec.nx + 1) * py],
        planes["x"][(spec.nx + 1) * py:]
        + jnp.where(ghost_mask_hi > 0, slab_width, 0.0),
    ], axis=0)
    return planes


# ---------------------------------------------------------------------------
# shared per-shard plumbing
# ---------------------------------------------------------------------------


def _local_layout(pos, alive, spec: DenseSlabSpec, lspec: DenseCellSpec,
                  bpos=None, bmask=None):
    """Local coordinates + dense slot assignment for [fluid | boundary].

    Dead/foreign slots park in the sacrificial z band. Each slab bins only
    the boundary inside its own x-range (the ghost-column exchange delivers
    neighbor boundary cells — local replication would double-count).
    Returns (entries, flat, valid, live_all, overflow, x0) where entries is
    the concatenated local-coordinate position array.
    """
    me = jax.lax.axis_index(AXIS)
    x0 = spec.lo + spec.slab_width * me.astype(jnp.float32)
    park = jnp.asarray([0.5 * spec.slab_width, 0.0, spec.park_z])

    local = pos - jnp.stack([x0, 0.0, 0.0])
    live = alive > 0
    lpos = jnp.where(live[:, None], local, park)
    entries, live_all = lpos, live
    if bpos is not None:
        own_b = ((bmask > 0) & (bpos[:, 0] >= x0)
                 & (bpos[:, 0] < x0 + spec.slab_width))
        lb = jnp.where(own_b[:, None], bpos - jnp.stack([x0, 0.0, 0.0]), park)
        entries = jnp.concatenate([lpos, lb], axis=0)
        live_all = jnp.concatenate([live, own_b], axis=0)

    flat, valid, _ = dense_indices(entries, lspec)
    overflow = jnp.sum((~valid) & live_all)   # parked slots overflow freely
    valid = valid & live_all
    return entries, flat, valid, live_all, overflow, x0


def _reduce_and_migrate(pos, vel, pressure, alive, dropped, overflow,
                        state: FluidState, diag, spec: DenseSlabSpec):
    """Freeze dead slots, migrate over faces, reduce global diagnostics."""
    live = alive > 0
    new_pos = jnp.where(live[:, None], state.pos, pos)
    new_vel = jnp.where(live[:, None], state.vel, vel)
    press_keep = pressure * alive

    slab = _SlabView(spec)
    new_pos, new_vel, new_press, new_alive, new_dropped = _migrate(
        new_pos, new_vel, press_keep, alive, dropped, slab)
    max_vel = jax.lax.pmax(jax.lax.stop_gradient(diag.max_vel), AXIS)
    new_dropped = jax.lax.psum(new_dropped, AXIS)
    live_here = jnp.sum(new_alive)[None]       # (1,) -> (n_dev,) via out_spec
    n_live = jax.lax.psum(jnp.sum(new_alive), AXIS)
    overflow = jax.lax.psum(overflow, AXIS)
    return (new_pos, new_vel, new_press, new_alive,
            new_dropped / spec.n_dev, (max_vel, n_live, overflow, live_here))


def _wrap_dense_step(local_step, mesh, spec: DenseSlabSpec,
                     boundary: bool = False, materials_arg: bool = False):
    """shard_map + jit wrapper. step(slabs) ->
    (slabs, max_vel, n_live, cell_overflow, per_slab_live).

    With materials_arg the step signature becomes step(slabs, materials)
    and the Materials pytree rides REPLICATED (in_spec P()) into every
    shard: under jax.grad, shard_map's transpose inserts the psum that
    all-reduces the per-shard material cotangents — the BASELINE config-5
    'psum-all-reduced parameter gradients' on the production decomposition,
    produced by the partitioner rather than hand-written collectives."""
    in_specs = [P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS), P(AXIS)]
    if materials_arg:
        in_specs += [P()]
    if boundary:
        in_specs += [P(AXIS, None), P(AXIS)]

    sm = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS), P(AXIS),
                   (P(), P(), P(), P(AXIS))),
    )

    @jax.jit
    def step(slabs: SlabState, materials=None):
        """dropped (in slabs) = particles lost; cell_overflow = interactions
        under-resolved this step (capacity drops, nothing lost)."""
        dropped_sh = jnp.broadcast_to(slabs.dropped / spec.n_dev,
                                      (spec.n_dev,))
        press = (slabs.pressure if slabs.pressure is not None
                 else jnp.zeros_like(slabs.alive))
        args = (slabs.pos, slabs.vel, press, slabs.alive, dropped_sh)
        if materials_arg:
            args += (materials,)
        if boundary:
            args += (slabs.boundary_pos, slabs.boundary_mask)
        pos, vel, press, alive, dropped, (max_vel, n_live, ovf, per_slab) = \
            sm(*args)
        out = SlabState(pos=pos, vel=vel, alive=alive,
                        dropped=jnp.sum(dropped), pressure=press,
                        boundary_pos=slabs.boundary_pos,
                        boundary_mask=slabs.boundary_mask)
        return out, max_vel, n_live, ovf, per_slab

    return step


# ---------------------------------------------------------------------------
# sharded WCSPH
# ---------------------------------------------------------------------------


def make_dense_halo_wcsph_step(mesh, spec: DenseSlabSpec, params: FluidParams,
                               boundary: bool = False,
                               materials_arg: bool = False):
    """Jitted shard_map'ed WCSPH step over slab state, on the dense
    stencil sweeps with plane-column halo exchange.

    materials_arg=True: step(slabs, materials) with a TRACED replicated
    Materials pytree — every material scale applies outside the sweeps
    (factored kernels), so `jax.grad` differentiates the distributed step
    w.r.t. mass/mu/d0/gamma/w and the per-shard cotangents are psum'd by
    the shard_map transpose (see _wrap_dense_step)."""
    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)

    def local_step(pos, vel, press_in, alive, dropped, *rest):
        if materials_arg:
            mats, b = rest[0], rest[1:]
            mass, mu = mats.mass, mats.mu
            d0, gamma, w = mats.d0, mats.tait_gamma, mats.tait_w
        else:
            mats, b = None, rest
            mass, mu = params.mass, params.mu
            d0, gamma, w = params.d0, params.tait_gamma, params.tait_w
        bpos, bmask = b if boundary else (None, None)
        entries, flat, valid, live_all, overflow, x0 = _local_layout(
            pos, alive, spec, lspec, bpos, bmask)
        nloc = pos.shape[0]
        vel_all = (jnp.concatenate([vel, jnp.zeros_like(bpos)], axis=0)
                   if boundary else vel)

        planes = build_planes(
            {"x": entries[:, 0], "y": entries[:, 1], "z": entries[:, 2],
             "vx": vel_all[:, 0], "vy": vel_all[:, 1], "vz": vel_all[:, 2]},
            flat, valid, lspec)
        planes = _exchange_all(planes, lspec,
                               ("x", "y", "z", "vx", "vy", "vz", "mask"))
        planes = _shift_ghost_x(planes, lspec, spec.slab_width)

        rho_plane = _ghost_ct_sync(density_planes(planes, lspec, k, mass),
                                   lspec)
        press_plane = jnp.where(planes["mask"] > 0,
                                tait_eos(rho_plane, d0, params.p0, gamma, w),
                                0.0)
        # Owner-computed rho/pressure for the ghost columns (round 2).
        rho_plane = _exchange_ghost_columns(rho_plane, lspec)
        press_plane = _exchange_ghost_columns(press_plane, lspec)

        if mats is None:
            fx, fy, fz = force_planes(planes, rho_plane, press_plane, lspec,
                                      k, params.mass, float(params.mu))
        else:
            from dieselfluid_tpu.ops.pallas_sph import viscosity_force_planes

            px_, py_, pz_ = pressure_force_planes(planes, rho_plane,
                                                  press_plane, lspec, k, mass)
            vx_, vy_, vz_ = viscosity_force_planes(planes, rho_plane, lspec,
                                                   k, mass, mu)
            fx, fy, fz = px_ + vx_, py_ + vy_, pz_ + vz_
        fx, fy, fz = (_ghost_ct_sync(fx, lspec), _ghost_ct_sync(fy, lspec),
                      _ghost_ct_sync(fz, lspec))
        flat_f, valid_f = flat[:nloc], valid[:nloc]
        vals = gather_planes([rho_plane, press_plane, fx, fy, fz], flat_f)
        rho = jnp.where(valid_f, vals[:, 0], d0)
        pressure = jnp.where(valid_f, vals[:, 1], 0.0)
        f = jnp.where(valid_f[:, None], vals[:, 2:5], 0.0)
        gravity = jnp.asarray(params.gravity, jnp.float32) * mass
        force = gravity + f

        state = FluidState(pos=pos, vel=vel, force=force, density=rho,
                           pressure=pressure)
        state, diag = semi_implicit_euler(state, params, mass=mass)
        state = box_collide(state, (spec.lo,) * 3,
                            (spec.hi_x, spec.hi_yz, spec.hi_yz))
        return _reduce_and_migrate(pos, vel, pressure, alive, dropped,
                                   overflow, state, diag, spec)

    return _wrap_dense_step(local_step, mesh, spec, boundary,
                            materials_arg=materials_arg)


# ---------------------------------------------------------------------------
# sharded PCISPH — the flagship solver at scale
# ---------------------------------------------------------------------------


def make_dense_halo_pcisph_step(mesh, spec: DenseSlabSpec,
                                params: FluidParams, delta: float,
                                boundary: bool = False,
                                warm_start: bool = False):
    """Distributed dense-Pallas PCISPH (ref: pcisph_gpu_darwin.go:249-286 —
    the reference's flagship GPU solver, finally multi-chip).

    Per correction iteration: rebuild the predicted-position planes,
    ppermute their ghost COLUMNS (same plane-halo protocol as rho/press),
    density-sweep, update pressures (warm-started from SlabState.pressure),
    exchange the pressure/divisor ghost columns, and force-sweep — exiting
    on the GLOBAL pmax density-error ratio like halo.make_halo_pcisph_step.
    Cell binning (and therefore the ghost mask) is frozen for the frame,
    exactly like the single-chip dense step.
    """
    from dieselfluid_tpu.solvers.pcisph import _Carry

    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)
    d0 = params.d0

    def local_step(pos, vel, press_in, alive, dropped, *b):
        bpos, bmask = b if boundary else (None, None)
        entries, flat, valid, live_all, overflow, x0 = _local_layout(
            pos, alive, spec, lspec, bpos, bmask)
        nloc = pos.shape[0]
        flat_f, valid_f = flat[:nloc], valid[:nloc]
        vel_all = (jnp.concatenate([vel, jnp.zeros_like(bpos)], axis=0)
                   if boundary else vel)

        planes = build_planes(
            {"x": entries[:, 0], "y": entries[:, 1], "z": entries[:, 2],
             "vx": vel_all[:, 0], "vy": vel_all[:, 1], "vz": vel_all[:, 2]},
            flat, valid, lspec)
        planes = _exchange_all(planes, lspec,
                               ("x", "y", "z", "vx", "vy", "vz", "mask"))
        planes = _shift_ghost_x(planes, lspec, spec.slab_width)
        mask_x = planes["mask"]               # ghost-filled; frozen per frame

        rho_plane = density_planes(planes, lspec, k, params.mass)
        rho_plane = _exchange_ghost_columns(rho_plane, lspec)
        rho = jnp.where(valid_f, gather_plane(rho_plane, flat_f), d0)

        # Viscosity at the unpredicted state via the fused kernel with a
        # zero pressure plane is wasteful; use the factored viscosity op.
        from dieselfluid_tpu.ops.pallas_sph import viscosity_force_planes

        vx_p, vy_p, vz_p = viscosity_force_planes(planes, rho_plane, lspec,
                                                  k, params.mass, params.mu)
        visc = jnp.where(valid_f[:, None],
                         gather_planes([vx_p, vy_p, vz_p], flat_f), 0.0)
        gravity = jnp.asarray(params.gravity, jnp.float32) * params.mass
        ext_force = gravity + visc

        def scatter(values_f, boundary_value=None):
            """Fluid values -> plane (+ boundary fill), ghost columns via
            exchange afterwards."""
            out = jnp.zeros(lspec.rows * lspec.row_len, jnp.float32).at[
                jnp.where(valid_f, flat_f, 0)
            ].add(jnp.where(valid_f, values_f, 0.0))
            if boundary and boundary_value is not None:
                flat_b, valid_b = flat[nloc:], valid[nloc:]
                out = out.at[jnp.where(valid_b, flat_b, 0)].add(
                    jnp.where(valid_b, boundary_value, 0.0))
            return out.reshape(lspec.plane_shape)

        def body(c: _Carry) -> _Carry:
            accel = (ext_force + c.f_p) / params.mass
            vel_star = vel + accel * params.dt
            pos_star_l = (pos - jnp.stack([x0, 0.0, 0.0])
                          + vel_star * params.dt)
            star_entries = jnp.where(
                (alive > 0)[:, None], pos_star_l,
                jnp.asarray([0.5 * spec.slab_width, 0.0, spec.park_z]))
            if boundary:
                star_entries = jnp.concatenate(
                    [star_entries, entries[nloc:]], axis=0)
            # Frozen binning -> frozen (already-exchanged) mask: skip the
            # per-iteration mask scatter entirely.
            p_star = build_planes(
                {"x": star_entries[:, 0], "y": star_entries[:, 1],
                 "z": star_entries[:, 2]}, flat, valid, lspec, mask=mask_x)
            p_star = _exchange_all(p_star, lspec, ("x", "y", "z"))
            p_star = _shift_ghost_x(p_star, lspec, spec.slab_width)

            rho_star_plane = density_planes(p_star, lspec, k, params.mass)
            rho_star = jnp.where(
                valid_f, gather_plane(rho_star_plane, flat_f), d0)
            err = (rho_star - d0) * alive
            pressure = jnp.maximum(c.pressure + delta * err, 0.0)

            # Prefolded pq = press/rho_ff^2: ONE scatter + ONE ghost-column
            # exchange per correction iteration instead of two of each
            # (boundary slots have zero pressure, so their pq is 0).
            rho_ff = jnp.maximum(rho_star, 0.5 * d0)
            pq_plane = _exchange_ghost_columns(
                scatter(pressure / (rho_ff * rho_ff)), lspec)
            fx_p, fy_p, fz_p = pressure_force_pq_planes(
                planes, pq_plane, lspec, k, params.mass)
            f_p = jnp.where(valid_f[:, None],
                            gather_planes([fx_p, fy_p, fz_p], flat_f), 0.0)
            max_ratio = jax.lax.pmax(jnp.max(err) / d0, AXIS)
            return _Carry(c.it + 1, max_ratio, pressure, f_p)

        def vary(x):
            return jax.lax.pcast(x, AXIS, to="varying") if AXIS not in getattr(
                jax.typeof(x), "vma", (AXIS,)) else x

        # warm_start mirrors halo.make_halo_pcisph_step: True resumes from
        # the persisted SlabState pressure, False is the reference-parity
        # per-frame cold start (ref: solver/pcisph/pcisph_darwin.go resets
        # Press each frame). Round-3 advisor finding: the flag was accepted
        # but never read, silently warm-starting both settings.
        init_press = press_in * alive if warm_start else jnp.zeros_like(alive)
        init = _Carry(it=jnp.int32(0), err=jnp.float32(jnp.inf),
                      pressure=vary(init_press),
                      f_p=vary(jnp.zeros_like(pos)))
        cond = lambda c: (c.it < params.pci_max_iters) & (
            c.err > params.pci_max_density_error_ratio)
        carry = jax.lax.while_loop(cond, body, init)

        state = FluidState(pos=pos, vel=vel, force=ext_force + carry.f_p,
                           density=rho, pressure=carry.pressure)
        state, diag = semi_implicit_euler(state, params)
        state = box_collide(state, (spec.lo,) * 3,
                            (spec.hi_x, spec.hi_yz, spec.hi_yz))
        return _reduce_and_migrate(pos, vel, carry.pressure, alive, dropped,
                                   overflow, state, diag, spec)

    return _wrap_dense_step(local_step, mesh, spec, boundary)


class _SlabView:
    """Adapter giving halo._migrate the SlabSpec surface it expects."""

    def __init__(self, spec: DenseSlabSpec):
        self.lo = spec.lo
        self.slab_width = spec.slab_width
        self.migrate_capacity = spec.migrate_capacity


def distribute_dense(state: FluidState, spec: DenseSlabSpec) -> SlabState:
    """Host-side: bin a global FluidState into the dense slab layout."""
    from dieselfluid_tpu.parallel.halo import SlabSpec, distribute

    view = SlabSpec(n_dev=spec.n_dev, capacity=spec.capacity,
                    halo_capacity=1, migrate_capacity=spec.migrate_capacity,
                    lo=spec.lo, hi=spec.hi_x, h=spec.cell)
    return distribute(state, view)
