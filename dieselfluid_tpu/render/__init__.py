"""Differentiable rendering: cameras, PBR shading, splat/ray renderers,
spectra and lights, GLTF scenes, cubemaps, textures.

The replacement for the reference's OpenGL stack (ref: render/, shader/,
gltf/ — SURVEY.md §2.8): instead of a GL state machine, rendering is pure
jnp image programs with gradients to particle positions, radii, and material
parameters.
"""

from dieselfluid_tpu.render.camera import Camera  # noqa: F401
