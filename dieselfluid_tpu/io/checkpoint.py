"""Simulation checkpoint/resume via orbax (capability gap in the reference).

Saves the full FluidState pytree + params/config metadata + step counter;
restores onto any device/mesh layout (orbax handles resharding). Works for
single-chip and sharded states alike.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

import jax
import numpy as np

try:
    import orbax.checkpoint as ocp
except ImportError as e:  # pragma: no cover - depends on the installation
    raise ImportError(
        "dieselfluid_tpu.io.checkpoint needs orbax (the orbax-checkpoint "
        "package) for --checkpoint-every/--resume") from e

from dieselfluid_tpu.config import FluidParams, SimConfig
from dieselfluid_tpu.models.particles import FluidState


def _params_dict(params: FluidParams) -> dict:
    return dataclasses.asdict(params)


def save_checkpoint(path: str, state: FluidState, step: int,
                    params: Optional[FluidParams] = None,
                    config: Optional[SimConfig] = None):
    """Write state + metadata to `path` (a directory)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        # Overwrite semantics: orbax refuses existing destinations, which
        # would break re-running into the same output directory.
        import shutil

        shutil.rmtree(path)
    ckptr = ocp.StandardCheckpointer()
    arrays = {k: v for k, v in state._asdict().items() if v is not None}
    ckptr.save(os.path.join(path, "state"), arrays)
    ckptr.wait_until_finished()
    meta = {
        "step": int(step),
        "params": _params_dict(params) if params else None,
        "config": dataclasses.asdict(config) if config else None,
        "has_boundary": state.boundary_pos is not None,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str) -> Tuple[FluidState, int, Optional[FluidParams],
                                        Optional[SimConfig]]:
    """Restore (state, step, params, config) from a checkpoint directory."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ckptr = ocp.StandardCheckpointer()
    arrays = ckptr.restore(os.path.join(path, "state"))
    state = FluidState(
        pos=arrays["pos"], vel=arrays["vel"], force=arrays["force"],
        density=arrays["density"], pressure=arrays["pressure"],
        boundary_pos=arrays.get("boundary_pos"),
    )
    params = FluidParams(**{**meta["params"],
                            "gravity": tuple(meta["params"]["gravity"])}) \
        if meta.get("params") else None
    config = SimConfig(**meta["config"]) if meta.get("config") else None
    return state, meta["step"], params, config


def save_slab_checkpoint(path: str, slabs, step: int,
                         params: Optional[FluidParams] = None):
    """Checkpoint a sharded SlabState (parallel.halo). orbax gathers the
    sharded leaves; restore re-shards onto whatever mesh loads it."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        import shutil

        shutil.rmtree(path)
    ckptr = ocp.StandardCheckpointer()
    arrays = {k: v for k, v in slabs._asdict().items() if v is not None}
    ckptr.save(os.path.join(path, "slabs"), arrays)
    ckptr.wait_until_finished()
    meta = {
        "step": int(step),
        "params": _params_dict(params) if params else None,
        "kind": "slab",
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_slab_checkpoint(path: str):
    """Restore (SlabState, step, params) saved by save_slab_checkpoint."""
    from dieselfluid_tpu.parallel.halo import SlabState

    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ckptr = ocp.StandardCheckpointer()
    arrays = ckptr.restore(os.path.join(path, "slabs"))
    slabs = SlabState(
        pos=arrays["pos"], vel=arrays["vel"], alive=arrays["alive"],
        dropped=arrays["dropped"], pressure=arrays.get("pressure"),
        boundary_pos=arrays.get("boundary_pos"),
        boundary_mask=arrays.get("boundary_mask"),
    )
    params = FluidParams(**{**meta["params"],
                            "gravity": tuple(meta["params"]["gravity"])}) \
        if meta.get("params") else None
    return slabs, meta["step"], params


class Checkpointer:
    """Rolling checkpoint manager: keeps the latest k checkpoints."""

    def __init__(self, root: str, keep: int = 3, interval: int = 100):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.interval = interval
        os.makedirs(self.root, exist_ok=True)

    def maybe_save(self, state: FluidState, step: int,
                   params: Optional[FluidParams] = None,
                   config: Optional[SimConfig] = None) -> bool:
        if step % self.interval != 0:
            return False
        return self.save(state, step, params, config)

    def save(self, state: FluidState, step: int,
             params: Optional[FluidParams] = None,
             config: Optional[SimConfig] = None) -> bool:
        """Unconditional save (callers that step in chunks can't rely on
        landing exactly on interval multiples — see utils.guard)."""
        save_checkpoint(os.path.join(self.root, f"step_{step:09d}"),
                        state, step, params, config)
        self._prune()
        return True

    def _steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def _prune(self):
        import shutil

        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"))

    def latest(self):
        steps = self._steps()
        if not steps:
            return None
        return load_checkpoint(os.path.join(self.root, f"step_{steps[-1]:09d}"))
