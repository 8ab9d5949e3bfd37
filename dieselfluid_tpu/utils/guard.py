"""Failure detection + elastic recovery for long simulation runs.

The reference has no self-diagnosis beyond init-time log.Fatalf (SURVEY §5:
"failure detection: none") — a diverged Tait EOS or an overflowed neighbor
structure silently corrupts every later frame. This module adds the missing
subsystem, device-style: health checks are DEVICE-SIDE scalar reductions (one
tiny fetch per check interval, never a full-state download), and recovery is
functional — roll back to the last healthy snapshot and re-run with a
shortened timestep.

    runner = GuardedRunner(state, params, make_step, check_every=25)
    runner.run(1000)          # steps, checking health every 25 frames;
                              # on divergence: rollback + dt backoff + retry

`make_step(params) -> step_fn` lets recovery rebind the jitted step to the
reduced-dt params (step functions close over params as static config).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.solvers.integrate import StepDiagnostics


class HealthReport(NamedTuple):
    """Device-side health scalars; fetch is 4 scalars, not the state."""

    finite: jnp.ndarray      # bool: every pos/vel entry is finite
    max_vel: jnp.ndarray     # float: global |v| max
    max_rho_ratio: jnp.ndarray  # float: max rho / d0
    overflow: jnp.ndarray    # int: neighbor-structure drops this step


def health_check(state: FluidState, params: FluidParams,
                 diag: Optional[StepDiagnostics] = None) -> HealthReport:
    """Jittable global reductions over the state (psum-free single-chip form;
    sharded callers wrap it in shard_map and pmax/psum the fields)."""
    finite = jnp.isfinite(state.pos).all() & jnp.isfinite(state.vel).all()
    max_vel = jnp.max(jnp.linalg.norm(state.vel, axis=-1))
    max_rho = jnp.max(state.density) / params.d0
    overflow = jnp.asarray(
        0 if diag is None else diag.overflow, jnp.int32)
    return HealthReport(finite, max_vel, max_rho, overflow)


class SimulationDiverged(RuntimeError):
    """Raised when recovery retries are exhausted."""

    def __init__(self, msg: str, report: HealthReport, step: int):
        super().__init__(f"step {step}: {msg} "
                         f"(max_vel={float(report.max_vel):.3g}, "
                         f"max_rho/d0={float(report.max_rho_ratio):.3g}, "
                         f"overflow={int(report.overflow)})")
        self.report = report
        self.step = step


class GuardedSlabRunner:
    """Failure detection + rollback for the multi-chip slab paths.

    Slab steps return device-reduced diagnostics (pmax'd max_vel, psum'd
    n_live) directly, so health checking costs 3 scalar fetches — no state
    download. Failure policy:

      * non-finite global max |v|, or above the acoustic limit  -> blowup
      * global live count != the initial count                   -> particles
        lost (migration/store overflow beyond `drop_budget`)

    On failure: restore the on-device SlabState snapshot, dt *= backoff,
    rebind the step via `make_step(params)` and retry, as GuardedRunner.
    `checkpointer`, when given, must be an io.checkpoint.Checkpointer; slab
    snapshots are written with save_slab_checkpoint (orbax reshards on load).
    """

    def __init__(self, slabs, params: FluidParams,
                 make_step: Callable[[FluidParams], Callable],
                 check_every: int = 25, vel_limit: float = 1.0,
                 drop_budget: int = 0, dt_backoff: float = 0.5,
                 max_retries: int = 3, checkpointer=None):
        self.slabs = slabs
        self.params = params
        self.make_step = make_step
        self.step_fn = make_step(params)
        self.check_every = check_every
        self.vel_limit = vel_limit
        self.drop_budget = drop_budget
        self.dt_backoff = dt_backoff
        self.max_retries = max_retries
        self.checkpointer = checkpointer
        self.step_count = 0
        self.recoveries = 0
        self._last_saved = 0
        self.n0 = float(jnp.sum(slabs.alive))
        self._snapshot = (slabs, 0)

    @property
    def sound_speed(self) -> float:
        return float(np.sqrt(self.params.tait_w / self.params.d0))

    def run(self, steps: int):
        """Advance `steps` frames; returns (max_vel, n_live) of the last
        chunk. Blocks once per chunk (required on CPU-emulated meshes — see
        parallel.halo docstring — and a single 2-scalar fetch on a GPU)."""
        import jax

        done = 0
        max_vel = n_live = None
        while done < steps:
            n = min(self.check_every, steps - done)
            s = self.slabs
            for _ in range(n):
                s, max_vel, n_live, *_rest = self.step_fn(s)
            jax.block_until_ready(s.pos)
            mv = float(np.asarray(max_vel))
            nl = float(np.asarray(n_live))
            failure = None
            if not np.isfinite(mv):
                failure = "non-finite velocities"
            elif mv > self.vel_limit * self.sound_speed:
                failure = "velocity blowup past the acoustic limit"
            elif nl < self.n0 - self.drop_budget:
                failure = (f"particles lost ({self.n0 - nl:.0f} > budget "
                           f"{self.drop_budget})")
            if failure is None:
                self.slabs = s
                self.step_count += n
                done += n
                self._snapshot = (s, self.step_count)
                if self.checkpointer is not None and (
                    self.step_count - self._last_saved
                    >= self.checkpointer.interval
                ):
                    from dieselfluid_tpu.io.checkpoint import save_slab_checkpoint
                    import os

                    save_slab_checkpoint(
                        os.path.join(self.checkpointer.root,
                                     f"step_{self.step_count:09d}"),
                        self.slabs, self.step_count, self.params)
                    self.checkpointer._prune()
                    self._last_saved = self.step_count
                continue
            if self.recoveries >= self.max_retries:
                rep = HealthReport(jnp.asarray(np.isfinite(mv)),
                                   jnp.float32(mv), jnp.float32(0.0),
                                   jnp.int32(int(self.n0 - nl)))
                raise SimulationDiverged(failure, rep, self.step_count)
            self.recoveries += 1
            self.slabs, self.step_count = self._snapshot
            self.params = self.params.replace(
                dt=float(self.params.dt * self.dt_backoff))
            self.step_fn = self.make_step(self.params)
        return max_vel, n_live


class GuardedRunner:
    """Steps a simulation with periodic health checks and rollback recovery.

    Failure policy (all thresholds relative to physical scales):
      * non-finite positions/velocities        -> always fatal for the chunk
      * max |v| > vel_limit * sound_speed      -> CFL/Tait blowup
      * max rho > rho_limit * d0               -> compression blowup
      * overflow > overflow_budget             -> neighbor structure too small

    On failure the runner restores the snapshot taken at the last healthy
    check, multiplies dt by `dt_backoff`, rebinds the step via `make_step`,
    and retries the chunk — up to `max_retries` times, then raises
    SimulationDiverged. Snapshots stay on device (jax.device_put of the
    healthy state), so recovery never round-trips the state through the host.
    """

    def __init__(self, state: FluidState, params: FluidParams,
                 make_step: Callable[[FluidParams], Callable],
                 check_every: int = 25, vel_limit: float = 1.0,
                 rho_limit: float = 4.0, overflow_budget: int = 0,
                 dt_backoff: float = 0.5, max_retries: int = 3,
                 checkpointer=None):
        self.state = state
        self.params = params
        self.make_step = make_step
        self.step_fn = make_step(params)
        self.check_every = check_every
        self.vel_limit = vel_limit
        self.rho_limit = rho_limit
        self.overflow_budget = overflow_budget
        self.dt_backoff = dt_backoff
        self.max_retries = max_retries
        self.checkpointer = checkpointer
        self.step_count = 0
        self.recoveries = 0
        self._last_saved = 0
        self._snapshot: Tuple[FluidState, int] = (state, 0)
        self._check = jax.jit(health_check, static_argnames=("params",))
        self._chunk_cache = {}

    # ------------------------------------------------------------ internals
    @property
    def sound_speed(self) -> float:
        """c from the Tait stiffness: w = d0 * c^2 (config.for_spacing)."""
        return float(np.sqrt(self.params.tait_w / self.params.d0))

    def _classify(self, rep: HealthReport) -> Optional[str]:
        r = jax.tree.map(np.asarray, rep)    # 4 scalars over the wire
        if not bool(r.finite):
            return "non-finite positions/velocities"
        if float(r.max_vel) > self.vel_limit * self.sound_speed:
            return "velocity blowup past the acoustic limit"
        if float(r.max_rho_ratio) > self.rho_limit:
            return "density blowup (Tait compression runaway)"
        if int(r.overflow) > self.overflow_budget:
            return "neighbor-structure overflow"
        return None

    def _chunk(self, n: int):
        """n steps under one scan; diagnostics of the LAST step ride the carry.
        Compiled once per (chunk length, step binding)."""
        key = (n, id(self.step_fn))
        if key not in self._chunk_cache:
            step_fn = self.step_fn
            zero = StepDiagnostics(max_vel=jnp.float32(0),
                                   max_force=jnp.float32(0),
                                   overflow=jnp.int32(0))

            def body(carry, _):
                s, _ = carry
                s, d = step_fn(s)
                d = d._replace(overflow=jnp.asarray(d.overflow, jnp.int32))
                return (s, d), None

            self._chunk_cache[key] = jax.jit(
                lambda s: jax.lax.scan(body, (s, zero), None, length=n)[0])
        return self._chunk_cache[key](self.state)

    # -------------------------------------------------------------- running
    def run(self, steps: int) -> HealthReport:
        """Advance `steps` frames with health checks; returns last report."""
        rep = None
        done = 0
        while done < steps:
            n = min(self.check_every, steps - done)
            candidate, diag = self._chunk(n)
            rep = self._check(candidate, self.params, diag)
            failure = self._classify(rep)
            if failure is None:
                self.state = candidate
                self.step_count += n
                done += n
                self._snapshot = (candidate, self.step_count)
                if self.checkpointer is not None and (
                    self.step_count - self._last_saved
                    >= self.checkpointer.interval
                ):
                    # Chunked stepping rarely lands on exact interval
                    # multiples, so save by steps-since-last-save, not by
                    # step % interval (which silently never fires unless
                    # interval divides the chunk size).
                    self.checkpointer.save(self.state, self.step_count,
                                           self.params)
                    self._last_saved = self.step_count
                continue
            if self.recoveries >= self.max_retries:
                raise SimulationDiverged(failure, rep, self.step_count)
            # Elastic recovery: rollback + shorten dt + rebind the step.
            self.recoveries += 1
            self.state, self.step_count = self._snapshot
            self.params = self.params.replace(
                dt=float(self.params.dt * self.dt_backoff))
            self.step_fn = self.make_step(self.params)
        return rep
