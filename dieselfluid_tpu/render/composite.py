"""Depth-composited frame: fluid splats over a ray-traced scene + sky.

The repo equivalent of the reference's canonical output — one GL frame with
the GLTF meshes AND the particle pass together (ref: render/
rendersystem_darwin.go Run:545-561 draws meshes then the particle program
into the same framebuffer; render/glr/glr_darwin.go Draw:481-491) — built
from the two differentiable renderers:

  * render/raytrace.py renders the scene (PBR + textures + sky cubemap on
    miss) with per-pixel ray depth;
  * render/splat.py renders the fluid with weighted-blended OIT coverage and
    a weighted mean depth;
  * this module merges them with a SOFT depth test (sigmoid in view-z), so
    the composite stays differentiable w.r.t. particle positions, material
    parameters, lights and the camera — no Z-buffer discontinuity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from dieselfluid_tpu.render.camera import Camera
from dieselfluid_tpu.render.raytrace import RayImage, render_scene
from dieselfluid_tpu.render.splat import SplatImage, splat_particles

_FAR = 1.0e6


class CompositeImage(NamedTuple):
    color: jnp.ndarray       # (H, W, 3)
    fluid_alpha: jnp.ndarray # (H, W) effective fluid coverage after depth test
    scene: RayImage
    fluid: SplatImage


def composite_images(fluid: SplatImage, scene: RayImage, cam: Camera,
                     dirs_z: jnp.ndarray, softness: float = 0.05):
    """Merge a splat image over a ray image with a soft depth test.

    `dirs_z` is dot(ray_dir, camera_front) per pixel — converts the ray
    renderer's along-ray t into the splat renderer's view-z metric.
    """
    z_scene = jnp.where(scene.hit, scene.depth * dirs_z, _FAR)
    has_fluid = fluid.alpha > 1e-6
    z_fluid = jnp.where(has_fluid, fluid.depth, _FAR)
    # Soft visibility: 1 when the fluid is clearly in front, 0 when occluded.
    occl = jnp.where(
        has_fluid,
        jnp.clip((z_scene - z_fluid) / softness + 0.5, 0.0, 1.0),
        0.0,
    )
    a = fluid.alpha * occl
    color = fluid.color * a[..., None] + scene.color * (1.0 - a[..., None])
    return color, a


def render_composite(
    pos: jnp.ndarray,
    radius,
    cam: Camera,
    tris: jnp.ndarray,
    tri_normals: jnp.ndarray,
    tri_materials: jnp.ndarray,
    materials,
    light_pos,
    light_color=(1.0, 1.0, 1.0),
    env_cube: Optional[jnp.ndarray] = None,
    width: int = 256,
    height: int = 256,
    colors: Optional[jnp.ndarray] = None,
    softness: float = 0.05,
    tri_uvs=None, textures=None, mat_base_tex=None, mat_normal_tex=None,
    tile: Optional[int] = None,
    splat_chunk: Optional[int] = None,
    scene_env_mode: str = "sh",
) -> CompositeImage:
    """One differentiable frame: fluid + GLTF scene + sky environment."""
    # scene_env_mode="sh" (default): the scene pass evaluates the sky's SH9
    # projection instead of per-pixel cubemap gathers, which dominated the
    # 1080p scene time (see render_scene env_mode). Pass "cubemap" for exact
    # texel parity.
    scene = render_scene(
        tris, tri_normals, tri_materials, materials, cam,
        jnp.asarray(light_pos, jnp.float32), light_color=light_color,
        env_cube=env_cube, width=width, height=height, tile=tile,
        tri_uvs=tri_uvs, textures=textures, mat_base_tex=mat_base_tex,
        mat_normal_tex=mat_normal_tex, env_mode=scene_env_mode,
    )
    # Splat background = black with zero alpha; composite supplies the scene.
    # The sky cubemap lights the FLUID too (env diffuse + reflection in
    # splat_particles), not just the raytracer's miss/reflection rays.
    fluid = splat_particles(pos, radius, cam, width=width, height=height,
                            colors=colors, background=(0.0, 0.0, 0.0),
                            env_cube=env_cube, chunk=splat_chunk)
    _, dirs = cam.pixel_rays(width, height)
    dirs_z = jnp.sum(dirs * cam.front, axis=-1)
    color, a = composite_images(fluid, scene, cam, dirs_z, softness)
    return CompositeImage(color=color, fluid_alpha=a, scene=scene, fluid=fluid)
