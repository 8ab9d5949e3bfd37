"""dieselfluid_tpu — a differentiable SPH fluid simulation + rendering framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of andewx/dieselfluid
(reference surveyed in SURVEY.md): SPH solvers (WCSPH / PCISPH), neighbor search,
field operators, differentiable rendering, atmosphere/sky environment light,
checkpointing and multi-chip sharding.

Layout (bottom-up, mirrors SURVEY.md §7 architecture sketch):
  mathx/      quaternions, polar coords, transforms, rays (ref: math/)
  geometry/   grids, triangles, meshes, octree, colliders (ref: geom/)
  ops/        smoothing kernels, EOS, Pallas compute kernels (ref: kernel/, data/shaders/)
  models/     particle state pytrees, water model, SPH field operators (ref: model/)
  neighbors/  brute-force + cell-grid + LSH neighbor search (ref: sampler/)
  solvers/    WCSPH, PCISPH step functions (ref: solver/)
  parallel/   device mesh, spatial sharding, halo exchange (ref: compute/ — single-device analog)
  render/     differentiable splat renderer, PBR, camera, GLTF scenes (ref: render/)
  sky/        Rayleigh/Mie atmosphere, solar spectrum, CIE (ref: atmosphere/)
  io/         checkpoint/resume, animation export, JSON samplers (gap in ref)
  app/        CLI simulation runner / offline viewer (ref: dslapp/)
  utils/      logging, profiling, jit helpers
"""

__version__ = "0.1.0"

from dieselfluid_tpu.config import FluidParams, SimConfig  # noqa: F401
