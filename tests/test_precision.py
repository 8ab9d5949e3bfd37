"""Position and direction matmuls ask for full fp32 precision.

On the GPU an fp32 matmul may run in TF32 (about three decimal digits)
unless the call asks for HIGHEST. That flips LSH hash signs near a plane,
moves projected splats by pixels, and skews rotated normals. Each call site
below must carry `precision=HIGHEST` on every dot_general in its jaxpr.
"""

import jax
import jax.numpy as jnp
import pytest

from dieselfluid_tpu.mathx import quaternion, transforms
from dieselfluid_tpu.neighbors.lsh import lsh_hash
from dieselfluid_tpu.render import sh, spectrum
from dieselfluid_tpu.render.camera import Camera
from dieselfluid_tpu.render.splat import _project, splat_particles


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


_CAM = Camera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                 aspect=1.0)
_P = jnp.linspace(-0.5, 0.5, 24, dtype=jnp.float32).reshape(8, 3)
_CUBE = jnp.ones((6, 4, 4, 3), jnp.float32)

SITES = {
    "splat_projection": lambda: _project(_CAM, _P, 32, 32),
    "splat_env_lookup": lambda: splat_particles(_P, 0.05, _CAM, 16, 16,
                                                env_cube=_CUBE).color,
    "transforms_apply": lambda: transforms.apply(jnp.eye(4), _P),
    "quaternion_rotate": lambda: quaternion.rotate(
        jnp.asarray([0.0, 0.0, 0.0, 1.0]), _P),
    "lsh_hash": lambda: lsh_hash(_P, jnp.ones((4, 3), jnp.float32), 16),
    "sh_project": lambda: sh.project_sh9(_CUBE),
    "sh_eval": lambda: sh.eval_sh9(jnp.ones((9, 3), jnp.float32), _P),
    "xyz_to_rgb": lambda: spectrum.xyz_to_rgb(_P),
    "rgb_to_xyz": lambda: spectrum.rgb_to_xyz(_P),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_matmul_precision_is_highest(site):
    closed = jax.make_jaxpr(SITES[site])()
    dots = list(_dots(closed.jaxpr))
    assert dots, f"{site}: no dot_general traced"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), (site, prec)
