"""Ray-traced mesh renderer: GLTF scenes with PBR shading + sky environment.

The array-program replacement for the reference's GL mesh pipeline
(ref: render/glr/glr.go Draw + rendersystem.go Run): instead of rasterizing
VAOs, each pixel ray intersects the scene triangle soup (Moller-Trumbore,
fully vectorized pixels x triangles, tiled to bound memory), shades with the
Cook-Torrance model (render/pbr.py) and falls back to the environment cubemap
on miss — the render path for the `materialcube` / `rendersphere` style
scenes. Differentiable in materials, lights and camera; triangle visibility
is hard (matching GL), so geometry gradients are at shading level.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dieselfluid_tpu.render.camera import Camera
from dieselfluid_tpu.render.cubemap import sample_cubemap
from dieselfluid_tpu.render.pbr import PBRMaterial, reflect, shade

_EPS = 1e-7


def ray_triangle(origins, dirs, tris):
    """Moller-Trumbore: rays (R, 3) x triangles (T, 3, 3) -> (R, T) hits.

    Returns (t, hit, u, v) with t = +inf on miss; (u, v) are the barycentric
    weights of vertices 1 and 2 (vertex 0 gets 1-u-v) — the interpolation
    coordinates for UVs/attributes (ref: geom/triangle/tri.go Barycentric:79).
    """
    v0 = tris[:, 0, :]                          # (T, 3)
    e1 = tris[:, 1, :] - v0
    e2 = tris[:, 2, :] - v0
    pvec = jnp.cross(dirs[:, None, :], e2[None, :, :])       # (R, T, 3)
    det = jnp.sum(pvec * e1[None, :, :], axis=-1)            # (R, T)
    inv_det = jnp.where(jnp.abs(det) > _EPS, 1.0 / jnp.where(jnp.abs(det) > _EPS, det, 1.0), 0.0)
    tvec = origins[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(dirs[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    # Edge-tolerant bounds: without the slack, rays along a shared edge can
    # miss BOTH triangles by one ulp (seam cracks — observed on CPU f32);
    # with it they may hit both, and argmin picks either at the same t.
    tol = 1e-5
    hit = ((jnp.abs(det) > _EPS) & (u >= -tol) & (v >= -tol)
           & (u + v <= 1 + tol) & (t > 1e-4))
    return jnp.where(hit, t, jnp.inf), hit, u, v


def _sample_stack(textures: jnp.ndarray, tex_idx: jnp.ndarray,
                  uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear lookup into a (K, S, S, 3) texture stack with a per-point
    texture index (clipped; callers mask idx < 0). Differentiable in uv."""
    k, hgt, wid = textures.shape[:3]
    ti = jnp.clip(tex_idx, 0, k - 1)
    u = uv[..., 0] * wid - 0.5
    v = uv[..., 1] * hgt - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), wid)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, wid)
    y0i = jnp.mod(y0.astype(jnp.int32), hgt)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, hgt)
    c00 = textures[ti, y0i, x0i]
    c10 = textures[ti, y0i, x1i]
    c01 = textures[ti, y1i, x0i]
    c11 = textures[ti, y1i, x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def tangent_frames(tris: jnp.ndarray, tri_uvs: jnp.ndarray):
    """Per-triangle (tangent, bitangent) from UV edge deltas — the mesh-
    analytic version of the reference's screen-space cotangent frame
    (ref: data/shaders/glsl/render/material/material.frag:152-177 builds
    T/B from dFdx/dFdy; a ray tracer has exact surface derivatives)."""
    e1 = tris[:, 1, :] - tris[:, 0, :]
    e2 = tris[:, 2, :] - tris[:, 0, :]
    duv1 = tri_uvs[:, 1, :] - tri_uvs[:, 0, :]
    duv2 = tri_uvs[:, 2, :] - tri_uvs[:, 0, :]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0), 0.0)
    tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    bitang = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv[:, None]

    def norm(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-9)

    return norm(tang), norm(bitang)


class RayImage(NamedTuple):
    color: jnp.ndarray
    depth: jnp.ndarray
    hit: jnp.ndarray


@partial(jax.jit, static_argnames=("width", "height", "tile", "env_mode"))
def render_scene(
    tris: jnp.ndarray,                 # (T, 3, 3)
    tri_normals: jnp.ndarray,          # (T, 3)
    tri_materials: jnp.ndarray,        # (T,) int32 indices into materials
    materials: PBRMaterial,            # stacked pytree, leaves (M, ...)
    cam: Camera,
    light_pos: jnp.ndarray,
    light_color=(1.0, 1.0, 1.0),
    env_cube: Optional[jnp.ndarray] = None,    # (6, S, S, 3)
    width: int = 256,
    height: int = 256,
    tile: Optional[int] = None,
    tri_uvs: Optional[jnp.ndarray] = None,       # (T, 3, 2)
    textures: Optional[jnp.ndarray] = None,      # (K, S, S, 3) stack
    mat_base_tex: Optional[jnp.ndarray] = None,  # (M,) int32, -1 = none
    mat_normal_tex: Optional[jnp.ndarray] = None,
    env_mode: str = "cubemap",
) -> RayImage:
    """Primary-ray render with PBR shading and cubemap environment.

    With tri_uvs + textures, hit-point UVs interpolate barycentrically and
    base-color/normal maps sample per material (ref: material.frag colorTex
    at :186 and normTex via the cotangent frame at :152-177).

    env_mode="sh": the environment (reflection term AND miss background)
    evaluates the cubemap's 9-coefficient SH projection instead of
    per-pixel texel gathers — band-limited but gather-free, the same
    deferred-SH trade the tile rasterizer makes (render/sh.py). Measured:
    the per-pixel cubemap gathers dominated the 1080p scene pass."""
    origins, dirs = cam.pixel_rays(width, height)
    if env_cube is not None and env_mode == "sh":
        from dieselfluid_tpu.render.sh import eval_sh9, project_sh9

        sh_coeffs = project_sh9(env_cube)
        env_sample = lambda d: eval_sh9(sh_coeffs, d)
    else:
        env_sample = lambda d: sample_cubemap(env_cube, d)
    if tris.shape[0] == 0:
        # Empty scene: pure environment (or flat background).
        d = dirs.reshape(-1, 3)
        bg = (env_sample(d) if env_cube is not None
              else jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.1]), d.shape))
        return RayImage(color=bg.reshape(height, width, 3),
                        depth=jnp.zeros((height, width), jnp.float32),
                        hit=jnp.zeros((height, width), bool))
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    npix = o.shape[0]
    if tile is None:
        # Pixel tile of the lax.map over rays. On the earlier accelerator
        # small tiles won: launch overhead was negligible next to the
        # locality loss of big ones. Not yet measured on the GPU.
        tile = 4096
    textured = tri_uvs is not None and textures is not None
    if textured:
        tang, bitang = tangent_frames(tris, tri_uvs)

    def render_tile(args):
        ot, dt = args
        t, hit, bu, bv = ray_triangle(ot, dt, tris)
        best = jnp.argmin(t, axis=1)
        t_best = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
        any_hit = jnp.isfinite(t_best)
        n = tri_normals[best]
        # Face normals toward the viewer (two-sided shading, GL default)
        facing = jnp.sum(n * dt, axis=-1) < 0
        n = jnp.where(facing[:, None], n, -n)
        p = ot + dt * jnp.where(any_hit, t_best, 1.0)[:, None]

        m_idx = jnp.maximum(tri_materials[best], 0)
        mat = jax.tree.map(lambda leaf: leaf[m_idx], materials)
        if textured:
            u_b = jnp.take_along_axis(bu, best[:, None], axis=1)[:, 0]
            v_b = jnp.take_along_axis(bv, best[:, None], axis=1)[:, 0]
            uvs = tri_uvs[best]                              # (R, 3, 2)
            uv = ((1.0 - u_b - v_b)[:, None] * uvs[:, 0]
                  + u_b[:, None] * uvs[:, 1] + v_b[:, None] * uvs[:, 2])
            if mat_base_tex is not None:
                bt = mat_base_tex[m_idx]
                texel = _sample_stack(textures, bt, uv)
                base = jnp.where((bt >= 0)[:, None],
                                 mat.base_color * texel, mat.base_color)
                mat = mat._replace(base_color=base)
            if mat_normal_tex is not None:
                nt = mat_normal_tex[m_idx]
                nm = _sample_stack(textures, nt, uv) * 2.0 - 1.0
                tb, bb = tang[best], bitang[best]
                n_pert = (nm[:, 0:1] * tb + nm[:, 1:2] * bb + nm[:, 2:3] * n)
                n_pert = n_pert / jnp.maximum(
                    jnp.linalg.norm(n_pert, axis=-1, keepdims=True), 1e-8)
                n = jnp.where((nt >= 0)[:, None], n_pert, n)
        v = -dt
        l = light_pos - p
        l = l / jnp.maximum(jnp.linalg.norm(l, axis=-1, keepdims=True), 1e-8)
        env = None
        if env_cube is not None:
            env = env_sample(reflect(-v, n))
        col = shade(n, v, l, mat, light_color=light_color, env_reflection=env)
        if env_cube is not None:
            bg = env_sample(dt)
        else:
            bg = jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.1]), col.shape)
        col = jnp.where(any_hit[:, None], col, bg)
        return col, jnp.where(any_hit, t_best, 0.0), any_hit

    pad = (-npix) % tile
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    o_b = o_p.reshape(-1, tile, 3)
    d_b = d_p.reshape(-1, tile, 3)
    col, dep, hit = jax.lax.map(render_tile, (o_b, d_b))
    col = col.reshape(-1, 3)[:npix].reshape(height, width, 3)
    dep = dep.reshape(-1)[:npix].reshape(height, width)
    hit = hit.reshape(-1)[:npix].reshape(height, width)
    return RayImage(color=col, depth=dep, hit=hit)


def stack_materials(mats) -> PBRMaterial:
    """Stack a list of PBRMaterial into one leaves-(M, ...) pytree."""
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *mats)
