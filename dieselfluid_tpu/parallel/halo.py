"""Spatial domain decomposition: slab sharding + ppermute halo exchange.

The scalable multi-chip strategy (SURVEY.md §5): the domain
is split into x-axis slabs, one per device on the ``sp`` mesh axis. Each
device owns the particles inside its slab (fixed-capacity SoA with an alive
mask — XLA needs static shapes), and per step:

  1. packs the particles within one kernel radius of each slab face into
     fixed-size halo buffers and ppermutes them to the adjacent devices
     (ghost particles ride the ICI torus, not an all-gather); the pack
     orders are frozen per frame so follow-up channel exchanges (owner-
     computed rho/pressure, PCISPH predicted positions) address the same
     ghosts — symmetric forces are EXACT across slab faces;
  2. computes forces against local + halo sources with the shared field
     operators over the sorted cell grid (neighbors/cellgrid.py);
  3. integrates locally, then migrates particles whose x crossed a slab
     boundary to the neighbor via a second (fixed-size) ppermute, compacting
     free slots.

Both WCSPH (`make_halo_step`) and PCISPH (`make_halo_pcisph_step`) are
provided; the PCISPH iteration exit uses the pmax'd global density-error max
(the distributed twin of ref: solver/pcisph/pcisph_darwin.go:88-90).

Communication is O(surface) per step instead of the all-gather's O(N) — the
difference between DP-over-particles (parallel/spmd.py) and true spatial
parallelism. Fixed capacities make overflow measurable, not silent:
`SlabState.dropped` counts particles that didn't fit (psum'd).

CPU-EMULATION CAVEAT: on the virtual multi-device CPU backend
(xla_force_host_platform_device_count), dispatching many steps without
blocking can deadlock XLA's in-process collective rendezvous (worker threads
oversubscribed across enqueued programs; observed at ~150 queued steps).
Call jax.block_until_ready periodically when driving loops on CPU; GPU
meshes use device collectives and do not need this.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models import field as F
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.neighbors.cellgrid import CellGridSpec, cell_grid_neighborhood
from dieselfluid_tpu.ops.smoothing import tait_eos
from dieselfluid_tpu.solvers.integrate import box_collide, semi_implicit_euler

AXIS = "sp"


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Static decomposition config: n_dev x-slabs over [lo, hi]."""

    n_dev: int
    capacity: int            # live-particle slots per device
    halo_capacity: int       # slots per face halo buffer
    migrate_capacity: int    # slots per face migration buffer
    lo: float = -1.0
    hi: float = 1.0
    h: float = 0.2           # halo width = kernel radius

    @property
    def slab_width(self) -> float:
        return (self.hi - self.lo) / self.n_dev

    def slab_bounds(self, dev_idx):
        lo = self.lo + self.slab_width * dev_idx
        return lo, lo + self.slab_width


class SlabState(NamedTuple):
    """Per-device fixed-capacity particle store (leaves sharded over sp).

    `pressure` persists across frames (PCISPH warm start — the single-chip
    paths have carried it since round 2; round-2 verdict weak #6 flagged the
    distributed cold start as a parity fork). `boundary_pos/mask` are static
    per-slab stores of boundary particles, PRE-REPLICATED with one kernel
    radius of overlap into the neighbor slabs at distribute() time, so no
    runtime boundary exchange is ever needed (boundaries don't migrate;
    ref: pcisph_gpu_darwin.go:67 ships boundary positions in the GPU buffer
    set once at init).
    """

    pos: jnp.ndarray       # (C, 3)
    vel: jnp.ndarray       # (C, 3)
    alive: jnp.ndarray     # (C,) float32 {0,1}
    dropped: jnp.ndarray   # () running count of capacity overflows
    pressure: jnp.ndarray = None          # (C,) persistent (warm start)
    boundary_pos: jnp.ndarray = None      # (B, 3) static per-slab
    boundary_mask: jnp.ndarray = None     # (B,) float32 {0,1}


def _compact(mask: jnp.ndarray, *arrays):
    """Stable-partition rows with mask=1 to the front; returns packed arrays
    + packed mask. Uses argsort of (1-mask) with stable iota tiebreak."""
    order = jnp.argsort(1.0 - mask, stable=True)
    return tuple(a[order] for a in arrays) + (mask[order],)


def _pack_first(mask: jnp.ndarray, count: int, *arrays):
    """Select up to `count` rows where mask=1, packed to a fixed-size buffer."""
    packed = _compact(mask, *arrays)
    out_arrays, out_mask = packed[:-1], packed[-1]
    return tuple(a[:count] for a in out_arrays) + (out_mask[:count],)


def distribute(state: FluidState, spec: SlabSpec) -> SlabState:
    """Host-side: bin a global FluidState into the sharded slab layout.

    Returns a SlabState whose arrays have leading dim n_dev*capacity,
    ordered device-major (shard with P('sp') over axis 0). Boundary
    particles (state.boundary_pos) are replicated into every slab they are
    within one kernel radius of, padded to a uniform per-slab count.
    """
    import numpy as np

    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    press = np.asarray(state.pressure)
    slab = np.clip(((pos[:, 0] - spec.lo) / spec.slab_width).astype(int),
                   0, spec.n_dev - 1)
    c = spec.capacity
    out_pos = np.zeros((spec.n_dev * c, 3), np.float32)
    out_vel = np.zeros((spec.n_dev * c, 3), np.float32)
    out_press = np.zeros((spec.n_dev * c,), np.float32)
    alive = np.zeros((spec.n_dev * c,), np.float32)
    dropped = 0
    for d in range(spec.n_dev):
        idx = np.where(slab == d)[0]
        take = idx[:c]
        dropped += len(idx) - len(take)
        out_pos[d * c:d * c + len(take)] = pos[take]
        out_vel[d * c:d * c + len(take)] = vel[take]
        out_press[d * c:d * c + len(take)] = press[take]
        alive[d * c:d * c + len(take)] = 1.0

    b_pos = b_mask = None
    if state.boundary_pos is not None:
        bp = np.asarray(state.boundary_pos)
        per_slab = []
        for d in range(spec.n_dev):
            lo = spec.lo + spec.slab_width * d - spec.h
            hi = spec.lo + spec.slab_width * (d + 1) + spec.h
            per_slab.append(bp[(bp[:, 0] >= lo) & (bp[:, 0] < hi)])
        bcap = max(1, max(len(p) for p in per_slab))
        b_pos = np.zeros((spec.n_dev * bcap, 3), np.float32)
        b_mask = np.zeros((spec.n_dev * bcap,), np.float32)
        for d, p in enumerate(per_slab):
            b_pos[d * bcap:d * bcap + len(p)] = p
            b_mask[d * bcap:d * bcap + len(p)] = 1.0
        b_pos, b_mask = jnp.asarray(b_pos), jnp.asarray(b_mask)

    return SlabState(
        pos=jnp.asarray(out_pos), vel=jnp.asarray(out_vel),
        alive=jnp.asarray(alive),
        dropped=jnp.asarray(float(dropped)),
        pressure=jnp.asarray(out_press),
        boundary_pos=b_pos, boundary_mask=b_mask,
    )


def collect(slabs: SlabState):
    """Gather all live particles back to host order (for IO/render)."""
    import numpy as np

    alive = np.asarray(slabs.alive) > 0
    return np.asarray(slabs.pos)[alive], np.asarray(slabs.vel)[alive]


# ---------------------------------------------------------------------------
# shard_map internals
# ---------------------------------------------------------------------------


def _face_packs(pos, alive, spec: SlabSpec, axis=AXIS):
    """Select the particles within one kernel radius of each slab face.

    Returns ((lo_order, lo_mask), (hi_order, hi_mask)) — fixed-size row
    indices + live masks. The orders are FROZEN for the frame so later
    channel exchanges (rho, pressure, predicted positions) ship the same
    particles the position exchange did.
    """
    me = jax.lax.axis_index(axis)
    slab_lo = spec.lo + spec.slab_width * me
    slab_hi = slab_lo + spec.slab_width
    near_lo = ((alive > 0) & (pos[:, 0] < slab_lo + spec.h)).astype(jnp.float32)
    near_hi = ((alive > 0) & (pos[:, 0] >= slab_hi - spec.h)).astype(jnp.float32)
    hc = spec.halo_capacity
    lo_order = jnp.argsort(1.0 - near_lo, stable=True)[:hc]
    hi_order = jnp.argsort(1.0 - near_hi, stable=True)[:hc]
    return (lo_order, near_lo[lo_order]), (hi_order, near_hi[hi_order])


def _ghost_mask(packs, axis=AXIS):
    """ppermute the pack masks; zero the non-periodic wrap-around."""
    (lo_ord, lo_m), (hi_ord, hi_m) = packs
    me = jax.lax.axis_index(axis)
    n = jax.lax.axis_size(axis)
    right_perm = [(i, (i + 1) % n) for i in range(n)]
    left_perm = [(i, (i - 1) % n) for i in range(n)]
    fl = jnp.where(me == 0, 0.0, jax.lax.ppermute(hi_m, axis, right_perm))
    fr = jnp.where(me == n - 1, 0.0, jax.lax.ppermute(lo_m, axis, left_perm))
    return jnp.concatenate([fl, fr], axis=0)


def _exchange(packs, arrays, axis=AXIS):
    """ppermute per-face packed channels to both neighbors.

    Each output is (2*halo_capacity, ...): ghosts from the left neighbor
    (its high face) then from the right (its low face). Use `_ghost_mask`
    for the validity of those slots (edge devices see zeroed wrap-around).
    """
    (lo_ord, _), (hi_ord, _) = packs
    n = jax.lax.axis_size(axis)
    right_perm = [(i, (i + 1) % n) for i in range(n)]   # data flows to rank+1
    left_perm = [(i, (i - 1) % n) for i in range(n)]
    outs = []
    for a in arrays:
        from_left = jax.lax.ppermute(a[hi_ord], axis, right_perm)
        from_right = jax.lax.ppermute(a[lo_ord], axis, left_perm)
        outs.append(jnp.concatenate([from_left, from_right], axis=0))
    return outs


def _migrate(pos, vel, press, alive, dropped, spec: SlabSpec, axis=AXIS,
             dim: int = 0):
    """Move particles that left the slab to the adjacent device (pressure
    rides along so the PCISPH warm start survives migration). `axis`/`dim`
    select the mesh axis and the spatial coordinate (2-D decompositions run
    one pass per dimension)."""
    me = jax.lax.axis_index(axis)
    n = jax.lax.axis_size(axis)
    slab_lo = spec.lo + spec.slab_width * me
    slab_hi = slab_lo + spec.slab_width

    live = alive > 0
    go_left = live & (pos[:, dim] < slab_lo) & (me > 0)
    go_right = live & (pos[:, dim] >= slab_hi) & (me < n - 1)
    stay = alive * (1.0 - go_left.astype(jnp.float32)) * (1.0 - go_right.astype(jnp.float32))

    mc = spec.migrate_capacity
    l_pos, l_vel, l_press, l_mask = _pack_first(
        go_left.astype(jnp.float32), mc, pos, vel, press)
    r_pos, r_vel, r_press, r_mask = _pack_first(
        go_right.astype(jnp.float32), mc, pos, vel, press)
    # Overflow: emigrants beyond capacity are lost — count them.
    lost = (jnp.sum(go_left) - jnp.sum(l_mask)) + (jnp.sum(go_right) - jnp.sum(r_mask))

    right_perm = [(i, (i + 1) % n) for i in range(n)]
    left_perm = [(i, (i - 1) % n) for i in range(n)]
    in_from_left = [jax.lax.ppermute(x, axis, right_perm)
                    for x in (r_pos, r_vel, r_press, r_mask)]
    in_from_right = [jax.lax.ppermute(x, axis, left_perm)
                     for x in (l_pos, l_vel, l_press, l_mask)]
    ifl_mask = jnp.where(me == 0, 0.0, in_from_left[3])
    ifr_mask = jnp.where(me == n - 1, 0.0, in_from_right[3])

    # Compact stayers to the front, then fill free slots with immigrants.
    pos_c, vel_c, press_c, stay_c = _compact(stay, pos, vel, press)
    n_stay = jnp.sum(stay_c).astype(jnp.int32)

    imm_pos = jnp.concatenate([in_from_left[0], in_from_right[0]], axis=0)
    imm_vel = jnp.concatenate([in_from_left[1], in_from_right[1]], axis=0)
    imm_press = jnp.concatenate([in_from_left[2], in_from_right[2]], axis=0)
    imm_mask = jnp.concatenate([ifl_mask, ifr_mask], axis=0)
    imm_pos, imm_vel, imm_press, imm_mask = _pack_first(
        imm_mask, 2 * mc, imm_pos, imm_vel, imm_press)
    n_imm = jnp.sum(imm_mask).astype(jnp.int32)

    cap = pos.shape[0]
    slot = jnp.arange(cap, dtype=jnp.int32)
    imm_slot = slot - n_stay                     # immigrant index per free slot
    can_place = (imm_slot >= 0) & (imm_slot < jnp.minimum(n_imm, 2 * mc))
    safe_slot = jnp.clip(imm_slot, 0, 2 * mc - 1)
    new_pos = jnp.where(can_place[:, None], imm_pos[safe_slot], pos_c)
    new_vel = jnp.where(can_place[:, None], imm_vel[safe_slot], vel_c)
    new_press = jnp.where(can_place, imm_press[safe_slot], press_c)
    new_alive = jnp.where(can_place, 1.0, stay_c)
    # Immigrants that didn't fit (capacity full) are lost too.
    lost = lost + jnp.maximum(n_stay + n_imm - cap, 0)
    return new_pos, new_vel, new_press, new_alive, dropped + lost


def _make_cell_spec(spec: SlabSpec, cell_capacity: int) -> CellGridSpec:
    """Global-domain cell grid shared by every slab (SPMD-uniform), extended
    by two sacrificial cells above `hi` so parked dead source slots bin into
    cells no query stencil ever probes."""
    # Quarter-cell lo offset: lattice-aligned particle planes sit mid-cell,
    # so float rounding at boundaries cannot concentrate whole planes into
    # one cell (the same trick bench.py uses for the dense layout).
    return CellGridSpec(
        lo=(spec.lo - 0.25 * spec.h,) * 3,
        hi=(spec.hi + 2.0 * spec.h,) * 3,
        cell=spec.h,
        capacity=cell_capacity,
    )


def _local_sources(pos, vel, alive, spec: SlabSpec, packs, k: int,
                   cg: CellGridSpec, bpos=None, bmask=None):
    """Ghost exchange + cell-grid neighborhood for one slab.

    Returns (nb, qpos, parked, src_vel, halo_mask) where sources are
    [local | ghosts | boundary], dead slots parked into the sacrificial cell
    layer. Boundary sources (pre-replicated per slab, see distribute) are
    frozen: velocity zero, never exchanged.
    """
    halo_pos, halo_vel = _exchange(packs, (pos, vel))
    halo_mask = _ghost_mask(packs)
    src_live = jnp.concatenate([alive, halo_mask], axis=0)
    src_pos = jnp.concatenate([pos, halo_pos], axis=0)
    src_vel = jnp.concatenate([vel, halo_vel], axis=0)
    if bpos is not None:
        src_live = jnp.concatenate([src_live, bmask], axis=0)
        src_pos = jnp.concatenate([src_pos, bpos], axis=0)
        src_vel = jnp.concatenate([src_vel, jnp.zeros_like(bpos)], axis=0)
    park = spec.hi + 3.0 * spec.h          # clips into the sacrificial layer
    parked = jnp.where(src_live[:, None] > 0, src_pos, park)
    qpos = jnp.where(alive[:, None] > 0, pos, spec.lo - 1e3)
    nb = cell_grid_neighborhood(qpos, parked, spec.h, k, cg, self_offset=0)
    return nb, qpos, parked, src_vel, halo_mask


def _boundary_density(bpos, bmask, parked, spec: SlabSpec, params, k: int,
                      cg: CellGridSpec):
    """Density at the (static) boundary particles against the local+ghost
    sources — the single-chip paths compute boundary density the same way
    (boundary slots are full density participants in the dense planes)."""
    bq = jnp.where(bmask[:, None] > 0, bpos, spec.lo - 1e3)
    nb_b = cell_grid_neighborhood(bq, parked, spec.h, k, cg, self_offset=0)
    rho_b = F.density_with_self(bq, nb_b, params, source_pos=parked)
    return jnp.where(bmask > 0, rho_b, params.d0)


def _finish_step(pos, vel, alive, dropped, force, rho, pressure,
                 spec: SlabSpec, params: FluidParams):
    """Integrate, collide, freeze dead slots, migrate, reduce diagnostics.

    Returns (pos, vel, press, alive, dropped, (max_vel, n_live, live_here))
    where live_here is this shard's live count as shape (1,) — stacked by
    the out_spec into the per-slab load-balance vector.
    """
    state = FluidState(pos=pos, vel=vel, force=force,
                       density=rho, pressure=pressure)
    state, diag = semi_implicit_euler(state, params)
    state = box_collide(state, (spec.lo,) * 3, (spec.hi,) * 3)
    new_pos = jnp.where(alive[:, None] > 0, state.pos, pos)
    new_vel = jnp.where(alive[:, None] > 0, state.vel, vel)
    press_keep = pressure * alive          # dead slots carry no pressure

    new_pos, new_vel, new_press, new_alive, new_dropped = _migrate(
        new_pos, new_vel, press_keep, alive, dropped, spec)
    max_vel = jax.lax.pmax(jax.lax.stop_gradient(diag.max_vel), AXIS)
    new_dropped = jax.lax.psum(new_dropped, AXIS)
    live_here = jnp.sum(new_alive)[None]
    n_live = jax.lax.psum(jnp.sum(new_alive), AXIS)
    return (new_pos, new_vel, new_press, new_alive, new_dropped / spec.n_dev,
            (max_vel, n_live, live_here))


def _wrap_step(local_step, mesh, spec: SlabSpec, boundary: bool = False):
    """shard_map + jit wrapper shared by every slab solver.

    step(slabs) -> (slabs, max_vel, n_live, per_slab_live) — the last is the
    (n_dev,) live-count vector (load-balance diagnostic: 1-D x-slabs
    concentrate mass in a dam break; imbalance is now visible, not silent).
    """
    in_specs = [P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS), P(AXIS)]
    if boundary:
        in_specs += [P(AXIS, None), P(AXIS)]
    sm = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS), P(AXIS),
                   (P(), P(), P(AXIS))),
    )

    @jax.jit
    def step(slabs: SlabState):
        dropped_sh = jnp.broadcast_to(slabs.dropped / spec.n_dev, (spec.n_dev,))
        press = (slabs.pressure if slabs.pressure is not None
                 else jnp.zeros_like(slabs.alive))
        args = (slabs.pos, slabs.vel, press, slabs.alive, dropped_sh)
        if boundary:
            args += (slabs.boundary_pos, slabs.boundary_mask)
        pos, vel, press, alive, dropped, (max_vel, n_live, per_slab) = sm(*args)
        out = SlabState(pos=pos, vel=vel, alive=alive,
                        dropped=jnp.sum(dropped), pressure=press,
                        boundary_pos=slabs.boundary_pos,
                        boundary_mask=slabs.boundary_mask)
        return out, max_vel, n_live, per_slab

    return step


def make_halo_step(mesh, spec: SlabSpec, params: FluidParams, k: int = 64,
                   cell_capacity: int = 32, boundary: bool = False):
    """Jitted shard_map'ed WCSPH step over slab-decomposed state.

    Ghost particles carry their owner-computed rho and pressure (a second
    1-hop ppermute round), so the symmetric pressure force is exact across
    slab faces and momentum is conserved globally — the round-1 rest-density
    approximation is gone. Within-slab search is the sorted cell grid, not
    brute force. With `boundary=True` the per-slab static boundary stores
    join as frozen sources with locally computed density + Tait pressure
    (same semantics as the single-chip dense planes; ref:
    pcisph_gpu_darwin.go:67 boundary positions in every kernel's buffer set).
    """
    cg = _make_cell_spec(spec, cell_capacity)

    def local_step(pos, vel, press_in, alive, dropped, *b):
        bpos, bmask = b if boundary else (None, None)
        packs = _face_packs(pos, alive, spec)
        nb, qpos, parked, src_vel, halo_mask = _local_sources(
            pos, vel, alive, spec, packs, k, cg, bpos, bmask)

        rho = F.density_with_self(qpos, nb, params, source_pos=parked)
        pressure = tait_eos(rho, params.d0, params.p0,
                            params.tait_gamma, params.tait_w)
        # Ghosts' own rho/p from their owner — exact symmetric forces.
        halo_rho, halo_p = _exchange(packs, (rho, pressure))
        src_rho = [rho, jnp.where(halo_mask > 0, halo_rho, params.d0)]
        src_p = [pressure, jnp.where(halo_mask > 0, halo_p, 0.0)]
        if boundary:
            rho_b = _boundary_density(bpos, bmask, parked, spec, params, k, cg)
            src_rho.append(rho_b)
            src_p.append(tait_eos(rho_b, params.d0, params.p0,
                                  params.tait_gamma, params.tait_w))
        src_rho = jnp.concatenate(src_rho, axis=0)
        src_p = jnp.concatenate(src_p, axis=0)

        visc = params.mu * F.laplacian_force(
            qpos, vel, rho, nb, params,
            source_pos=parked, source_vel=src_vel, source_rho=src_rho)
        f_p = F.pressure_force(
            qpos, rho, pressure, nb, params,
            source_pos=parked, source_rho=src_rho, source_pressure=src_p)
        gravity = jnp.asarray(params.gravity, jnp.float32) * params.mass
        force = gravity + f_p + visc
        return _finish_step(pos, vel, alive, dropped, force, rho, pressure,
                            spec, params)

    return _wrap_step(local_step, mesh, spec, boundary)


def make_halo_pcisph_step(mesh, spec: SlabSpec, params: FluidParams,
                          delta: float, k: int = 64, cell_capacity: int = 32,
                          boundary: bool = False, warm_start: bool = False):
    """Distributed PCISPH over slab decomposition.

    The reference's flagship solver (ref: solver/pcisph/pcisph_darwin.go),
    now multi-chip: per correction iteration the predicted positions and the
    accumulated pressures of face particles ride one ppermute each, and the
    iteration-exit density-error max is the GLOBAL pmax — the distributed
    twin of the reference's sequential global max (pcisph_darwin.go:88-90).
    Neighbor candidates and face membership are frozen for the frame, exactly
    like the reference's per-frame LSH table.

    `warm_start=True` starts the correction loop from SlabState.pressure
    (persisted across frames and migration) — same option and default as the
    single-chip steps, so parity holds either way. Boundary sources
    (boundary=True) use the dense-path convention in the correction force:
    zero pressure, rest-density divisor.
    """
    from dieselfluid_tpu.solvers.pcisph import _Carry

    cg = _make_cell_spec(spec, cell_capacity)

    def local_step(pos, vel, press_in, alive, dropped, *b):
        bpos, bmask = b if boundary else (None, None)
        packs = _face_packs(pos, alive, spec)
        nb, qpos, parked, src_vel, halo_mask = _local_sources(
            pos, vel, alive, spec, packs, k, cg, bpos, bmask)
        src_live_col = jnp.concatenate([alive, halo_mask], axis=0)[:, None]
        park = spec.hi + 3.0 * spec.h

        rho = F.density_with_self(qpos, nb, params, source_pos=parked)
        (halo_rho,) = _exchange(packs, (rho,))
        src_rho = [rho, jnp.where(halo_mask > 0, halo_rho, params.d0)]
        if boundary:
            src_rho.append(_boundary_density(bpos, bmask, parked, spec,
                                             params, k, cg))
        src_rho = jnp.concatenate(src_rho, axis=0)
        visc = params.mu * F.laplacian_force(
            qpos, vel, rho, nb, params,
            source_pos=parked, source_vel=src_vel, source_rho=src_rho)
        gravity = jnp.asarray(params.gravity, jnp.float32) * params.mass
        ext_force = gravity + visc

        def vary(x):
            return jax.lax.pcast(x, AXIS, to="varying") if AXIS not in getattr(
                jax.typeof(x), "vma", (AXIS,)) else x

        def boundary_tail(val, fill):
            """Per-boundary-source channel values (static each iteration)."""
            if not boundary:
                return []
            return [jnp.where(bmask > 0, val, fill)]

        def body(c: _Carry) -> _Carry:
            accel = (ext_force + c.f_p) / params.mass
            vel_star = vel + accel * params.dt
            pos_star = pos + vel_star * params.dt
            (halo_pos_star,) = _exchange(packs, (pos_star,))
            segs = [pos_star, halo_pos_star]
            live_col = src_live_col
            if boundary:
                segs.append(bpos)            # boundaries never move
                live_col = jnp.concatenate(
                    [src_live_col, bmask[:, None]], axis=0)
            parked_star = jnp.where(live_col > 0,
                                    jnp.concatenate(segs, axis=0), park)
            qpos_star = jnp.where(alive[:, None] > 0, pos_star,
                                  spec.lo - 1e3)
            rho_star = F.density_with_self(qpos_star, nb, params,
                                           source_pos=parked_star)
            err = (rho_star - params.d0) * alive
            pressure = jnp.maximum(c.pressure + delta * err, 0.0)
            rho_ff = jnp.maximum(rho_star, 0.5 * params.d0)
            halo_p, halo_rff = _exchange(packs, (pressure, rho_ff))
            src_p = jnp.concatenate(
                [pressure, jnp.where(halo_mask > 0, halo_p, 0.0)]
                + boundary_tail(0.0, 0.0), axis=0)
            src_rff = jnp.concatenate(
                [rho_ff, jnp.where(halo_mask > 0, halo_rff, params.d0)]
                + boundary_tail(params.d0, params.d0), axis=0)
            f_p = F.pressure_force(
                qpos, rho_ff, pressure, nb, params,
                source_pos=parked, source_rho=src_rff, source_pressure=src_p)
            # GLOBAL density-error max: every slab exits together.
            max_ratio = jax.lax.pmax(jnp.max(err) / params.d0, AXIS)
            return _Carry(c.it + 1, max_ratio, pressure, f_p)

        init_press = press_in * alive if warm_start else jnp.zeros_like(alive)
        init = _Carry(it=jnp.int32(0), err=jnp.float32(jnp.inf),
                      pressure=vary(init_press),
                      f_p=vary(jnp.zeros_like(pos)))
        cond = lambda c: (c.it < params.pci_max_iters) & (
            c.err > params.pci_max_density_error_ratio)
        carry = jax.lax.while_loop(cond, body, init)

        force = ext_force + carry.f_p
        return _finish_step(pos, vel, alive, dropped, force, rho,
                            carry.pressure, spec, params)

    return _wrap_step(local_step, mesh, spec, boundary)
