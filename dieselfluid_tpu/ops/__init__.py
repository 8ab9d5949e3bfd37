"""Compute ops: smoothing kernels, EOS, and the dense stencil sweeps of the hot loops."""

from dieselfluid_tpu.ops.smoothing import (  # noqa: F401
    KernelCoeffs,
    w_poly6,
    dw_spiky,
    d2w_visc,
    grad_w,
    w0,
    tait_eos,
    eos_gamma,
)
