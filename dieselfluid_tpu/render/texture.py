"""Texture library: image decode + differentiable bilinear sampling.

ref: render/texture/texture.go (PNG/JPEG decode -> RGBA8 GL upload). The GL
commit step becomes keeping images as device arrays; sampling is bilinear
jnp gather, differentiable in the UV coordinates (the analog of the
hardware sampler).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class TexLibrary:
    """Name -> (H, W, C) float32 [0,1] image registry. ref: texture.go TexLibrary."""

    textures: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)

    def load(self, path: str, name: str | None = None) -> jnp.ndarray:
        """Decode an image file. ref: texture.go Load:54 (PNG/JPEG)."""
        import imageio.v2 as imageio

        img = np.asarray(imageio.imread(path), np.float32)
        if img.max() > 1.0:
            img = img / 255.0
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        arr = jnp.asarray(img[..., :3])
        self.textures[name or path] = arr
        return arr

    def add(self, name: str, image) -> jnp.ndarray:
        arr = jnp.asarray(image, jnp.float32)
        self.textures[name] = arr
        return arr

    def remove(self, name: str):
        """ref: texture.go RemoveTexture."""
        self.textures.pop(name, None)

    def get(self, name: str) -> jnp.ndarray:
        return self.textures[name]


def sample_bilinear(texture: jnp.ndarray, uv: jnp.ndarray,
                    wrap: str = "repeat") -> jnp.ndarray:
    """Bilinear texture lookup. texture (H, W, C); uv (..., 2) in [0,1].

    Differentiable in uv (and texture). wrap: 'repeat' | 'clamp'.
    """
    h, w = texture.shape[:2]
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]

    def wrap_idx(i, n):
        if wrap == "repeat":
            return jnp.mod(i.astype(jnp.int32), n)
        return jnp.clip(i.astype(jnp.int32), 0, n - 1)

    x0i, x1i = wrap_idx(x0, w), wrap_idx(x0 + 1, w)
    y0i, y1i = wrap_idx(y0, h), wrap_idx(y0 + 1, h)
    c00 = texture[y0i, x0i]
    c10 = texture[y0i, x1i]
    c01 = texture[y1i, x0i]
    c11 = texture[y1i, x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def write_image(path: str, image, gamma: float | None = None):
    """Write an (H, W, 3) float image to disk (PNG/JPEG by extension).

    The tone-mapped JPEG writer analog (ref: atmosphere/atmosphere.go
    ImageFromPixels:142-193) lives in sky/bake.py; this is the raw writer.
    """
    import imageio.v2 as imageio

    img = np.asarray(image)
    if gamma is not None:
        img = np.power(np.clip(img, 0.0, 1.0), 1.0 / gamma)
    imageio.imwrite(path, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
