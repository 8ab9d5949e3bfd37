"""Configuration dataclasses for the simulator.

Replaces the reference's compile-time constant blocks (ref: model/model.go:5-45,
kernel/std_kernel.go:26-28, atmosphere/atmosphere.go:25-34) with explicit,
serializable configs. All fields are static (Python numbers) so they can be
closed over by jit without retracing on value changes that matter.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

# Water model constants (ref: model/model.go:40-45)
FLUID_MASS = 0.1
FLUID_DENSITY = 87.0
FLUID_STIFF = 6.1
FLUID_KERN_RAD = 0.2
FLUID_SOS = 1480.0

# Tait EOS constants (ref: model/model.go TaitEos — g=7.16, w=2.15)
TAIT_GAMMA = 7.16
TAIT_W = 2.15

# Viscosity + NN cache constants (ref: model/sph/fluid.go:18-20)
VISCOSITY_WATER = 1.3059
CACHE_L = 0.8

GRAVITY = -9.81


@dataclasses.dataclass(frozen=True)
class FluidParams:
    """Physical + numerical parameters of one SPH fluid.

    Matches the construction in the reference's sph.Init
    (ref: model/sph/fluid.go:41-88): h is the kernel support radius, mass the
    per-particle mass, d0 the reference (rest) density, mu dynamic viscosity,
    dt the fixed CFL timestep (ref: model/sph/fluid.go:111-114 pins dt=0.01).
    """

    h: float = 1.0
    mass: float = 1.0
    d0: float = 512.0
    mu: float = VISCOSITY_WATER
    dt: float = 0.01
    gravity: Tuple[float, float, float] = (0.0, GRAVITY, 0.0)
    # Tait EOS
    tait_gamma: float = TAIT_GAMMA
    tait_w: float = TAIT_W
    p0: float = 0.0
    # PCISPH policy (ref: solver/pcisph/pcisph_darwin.go:49-50)
    pci_max_iters: int = 5
    pci_max_density_error_ratio: float = 0.01

    def replace(self, **kw) -> "FluidParams":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def reference_lattice(n3: int, scale: float = 1.0) -> "FluidParams":
        """Parameters the reference derives for an n3**3 lattice in a [-1,1]^3 box.

        ref: model/sph/fluid.go:48-63 — h=1, mass=1, d0 = N / volume(8).
        NOTE: these are *parity* parameters. With h=1 the kernel radius spans
        half the domain, every particle neighbors thousands of others, and any
        finite sample cap (the reference's 100-sample LSH probe or our k-capped
        lists) undersamples density so Tait pressure clamps to zero. Use
        `for_spacing` + `neighbors.calibrate_rest_density` for physical runs.
        """
        num = n3 ** 3
        volume = (2.0 * scale) ** 3
        return FluidParams(h=1.0, mass=1.0, d0=float(num) / volume)

    @staticmethod
    def for_spacing(dx: float, h_factor: float = 2.0, mass: float = 1.0,
                    sound_speed: float = 25.0, mu: float = 0.05) -> "FluidParams":
        """Physically-sane parameters for a lattice of spacing dx.

        h = h_factor*dx gives ~33 neighbors (h_factor=2) in 3D — the textbook
        SPH regime the reference's fixed h=1 misses. Tait stiffness is derived
        from `sound_speed` (w = d0*c^2 so dp/drho|_{d0} = c^2; the reference's
        fixed w=2.15 yields a near-zero sound speed, so pressure cannot resist
        compression until the fluid is ~10x compressed and then explodes), and
        dt follows the acoustic CFL dt = 0.25 h / c. d0 should be refined with
        `neighbors.calibrate_rest_density` on the actual initial state (which
        rescales tait_w to keep the sound speed).
        """
        h = h_factor * dx
        d0 = mass / dx ** 3
        return FluidParams(
            h=h, mass=mass, d0=d0, mu=mu,
            tait_w=d0 * sound_speed ** 2,
            dt=0.25 * h / sound_speed,
        )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level simulation configuration (solver choice, sizes, neighbor policy)."""

    n3: int = 16                      # cubic root of particle count (ref default 16 -> 4096)
    solver: str = "wcsph"             # "wcsph" | "pcisph"
    neighbors: str = "cellgrid"       # "bruteforce" | "cellgrid" | "dense"
    max_neighbors: int = 128          # fixed neighbor-list degree (ref caps at 100-150 samples)
    cell_capacity: int = 32           # particles per cell in the cell table
    steps_per_frame: int = 1
    seed: int = 0
    warm_start: bool = False          # PCISPH: carry pressure across frames
                                      # (production knob; the reference
                                      # resets Press each frame, fluid.go:192)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        return SimConfig(**json.loads(s))
