"""Spectral power distributions, CIE XYZ color matching, solar SPD.

ref: render/light/spectrum.go + sunlight.go. Spectra are (..., S) jnp arrays
sampled uniformly over [380, 625] nm (SP_VIOLET..SP_RED, spectrum.go:17-18);
all arithmetic is ordinary array math. The CIE x/y/z color-matching curves use
the multi-lobe Gaussian analytic fit of Wyman, Sloan & Shirley (JCGT 2013)
instead of loading the reference's tabulated JSON (data/CIEX.json etc.) —
same curves, no data copied, and differentiable in wavelength.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

SP_VIOLET = 380.0
SP_RED = 625.0
WATTS = 0
LUMENS = 1

# Burr solar SPD constants (ref: sunlight.go:6-11)
SPD_B = 9.6
SPD_C = 3.1
SPD_K = 1.68
SPD_G = 0.45


def wavelengths(samples: int) -> jnp.ndarray:
    """Uniform sample wavelengths. ref: spectrum.go Wavelength:96-99."""
    i = jnp.arange(samples, dtype=jnp.float32)
    return SP_VIOLET + (SP_RED - SP_VIOLET) / samples * i


def _gauss(x, alpha, mu, s1, s2):
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * jnp.exp(-0.5 * t * t)


def cie_x(lam):
    """CIE 1931 x-bar analytic fit (Wyman-Sloan-Shirley 2013, eq. 1)."""
    return (_gauss(lam, 1.056, 599.8, 37.9, 31.0)
            + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
            + _gauss(lam, -0.065, 501.1, 20.4, 26.2))


def cie_y(lam):
    return _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(lam, 0.286, 530.9, 16.3, 31.1)


def cie_z(lam):
    return _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(lam, 0.681, 459.0, 26.0, 13.8)


class SampledSpectrum(NamedTuple):
    """An SPD with its wavelength grid. ref: spectrum.go SampledSpectrum:56-64."""

    values: jnp.ndarray      # (..., S)
    lam: jnp.ndarray         # (S,)
    units: int = WATTS

    @staticmethod
    def constant(samples: int, total_power: float = 1.0, units: int = WATTS):
        """Flat SPD splitting total_power evenly. ref: spectrum.go InitSpectrum."""
        lam = wavelengths(samples)
        return SampledSpectrum(
            jnp.full((samples,), total_power / samples, jnp.float32), lam, units
        )

    @property
    def samples(self) -> int:
        return self.values.shape[-1]

    def is_black(self) -> jnp.ndarray:
        return jnp.all(self.values == 0.0, axis=-1)

    # Arithmetic (ref: spectrum.go Add/Mul/Div/Sub/Neg/Sqrt/Lerp/Pow/Clamp)
    def add(self, o): return self._replace(values=self.values + o.values)
    def sub(self, o): return self._replace(values=self.values - o.values)
    def mul(self, o): return self._replace(values=self.values * o.values)
    def div(self, o): return self._replace(values=self.values / o.values)
    def neg(self): return self._replace(values=-self.values)
    def sqrt(self): return self._replace(values=jnp.sqrt(self.values))
    def pow(self, k): return self._replace(values=jnp.power(self.values, k))
    def scale(self, k): return self._replace(values=self.values * k)

    def lerp(self, o, t):
        return self._replace(values=self.values * (1 - t) + o.values * t)

    def clamp(self, lo, hi):
        return self._replace(values=jnp.clip(self.values, lo, hi))

    def to_xyz(self) -> jnp.ndarray:
        """Riemann-sum projection onto CIE XYZ normalized by the Y integral.

        ref: spectrum.go ToXYZ:288-302 (sum over samples, / yint).
        """
        x = cie_x(self.lam)
        y = cie_y(self.lam)
        z = cie_z(self.lam)
        yint = jnp.sum(y)
        return jnp.stack([
            jnp.sum(x * self.values, axis=-1) / yint,
            jnp.sum(y * self.values, axis=-1) / yint,
            jnp.sum(z * self.values, axis=-1) / yint,
        ], axis=-1)

    def luminance(self) -> jnp.ndarray:
        """Y channel only. ref: spectrum.go YY:304-310."""
        return jnp.sum(cie_y(self.lam) * self.values, axis=-1) / jnp.sum(cie_y(self.lam))

    def to_rgb(self) -> jnp.ndarray:
        return xyz_to_rgb(self.to_xyz())


def resample_average_1d(domain: jnp.ndarray, values: jnp.ndarray,
                        g0: jnp.ndarray, g1: jnp.ndarray) -> jnp.ndarray:
    """Window-averaged resampling of a tabulated piecewise-linear function.

    Capability of the reference's windowed resampler (ref: sampler/
    sampler_utilities.go:52 SampleAverage1D): the average of the tabulated
    curve over each window [g0, g1], with constant extension outside the
    knot range and the reference's midpoint rule per interior segment
    (``Lerp(0.5, v0, v1) * overlap``). Unlike the Go original — a stateful
    forward scan with a bind index — every window is computed at once by
    broadcasting segment/window overlaps, so it vmaps and differentiates.

    domain: (n,) sorted knots; values: (n,); g0/g1: (...,) window edges.
    """
    x0, x1 = domain[:-1], domain[1:]                    # (n-1,) segments
    vmid = 0.5 * (values[:-1] + values[1:])
    g0b, g1b = g0[..., None], g1[..., None]
    overlap = jnp.maximum(jnp.minimum(g1b, x1) - jnp.maximum(g0b, x0), 0.0)
    seg = jnp.sum(vmid * overlap, axis=-1)
    left = values[0] * jnp.maximum(jnp.minimum(g1, domain[0]) - g0, 0.0)
    right = values[-1] * jnp.maximum(g1 - jnp.maximum(g0, domain[-1]), 0.0)
    return (seg + left + right) / (g1 - g0)


def spectrum_from_tabulated(domain, values, samples: int,
                            units: int = WATTS) -> SampledSpectrum:
    """SampledSpectrum from tabulated (wavelength, value) data, bin-averaged
    onto the uniform sample grid (ref: spectrum.go FromSampled:241-260 —
    the consumer of SampleAverage1D; also covers FromFile when paired with
    io.sampler_json)."""
    edges = SP_VIOLET + (SP_RED - SP_VIOLET) / samples * jnp.arange(
        samples + 1, dtype=jnp.float32)
    vals = resample_average_1d(jnp.asarray(domain, jnp.float32),
                               jnp.asarray(values, jnp.float32),
                               edges[:-1], edges[1:])
    return SampledSpectrum(vals, wavelengths(samples), units)


def xyz_to_rgb(xyz):
    """CIE XYZ -> linear sRGB. ref: spectrum.go XYZToRGB:317-323 (same standard matrix)."""
    m = jnp.asarray([
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ], jnp.float32)
    return jnp.einsum("ij,...j->...i", m, xyz, precision=jax.lax.Precision.HIGHEST)


def rgb_to_xyz(rgb):
    """ref: spectrum.go RGBToXYZ:325-331."""
    m = jnp.asarray([
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ], jnp.float32)
    return jnp.einsum("ij,...j->...i", m, rgb, precision=jax.lax.Precision.HIGHEST)


def sunlight_spd(lam):
    """Burr-distribution solar SPD. ref: sunlight.go SunlightSpectrum:14-17."""
    x = lam / 100.0
    g = jnp.power(SPD_G * x, SPD_C - 1.0)
    return SPD_B * SPD_B * SPD_C * SPD_K * g / jnp.power(SPD_B + g, SPD_K + 1.0)


def sunlight_spd_attenuated(lam, k_atten):
    """ref: sunlight.go SunlightSpectrumAttenuate:20-23."""
    x = lam / 100.0
    g = jnp.power(SPD_G * x, SPD_C - 1.0)
    return (SPD_B * SPD_B * SPD_C * SPD_K * k_atten * g
            / jnp.power(SPD_B + g, SPD_K * k_atten + 1.0))


def init_sunlight(samples: int = 20, k_atten: float = 1.086) -> SampledSpectrum:
    """Solar SPD over the visible band. ref: sunlight.go InitSunlight:26-42."""
    lam = wavelengths(samples)
    return SampledSpectrum(sunlight_spd_attenuated(lam, k_atten), lam, WATTS)
