"""Numerically stable special functions for log-space greybody evaluation.

Torch twin of mbb_emcee_tpu/ops/special.py. fp32-safe over the whole
sampling prior box: the Wien side of the Planck term reaches
x = h c / (lambda k T) ~ O(10^3) where e^x overflows, and the optically-thin
tail reaches tau ~ O(10^-30) where 1 - e^-tau underflows. Every function is
branchless (torch.where with both branches finite) so it batches over any
leading shape. The CUDA kernels (csrc/lnprob.cuh) use the same formulas
with libdevice expm1f/logf.
"""

import torch

# exp(x) for x > ~88 overflows fp32; cut well below that so the discarded
# where-branch stays finite.
EXP_CUT = 25.0


def log_expm1(x):
    """log(e^x - 1) for x > 0, stable for both tiny and huge x."""
    xs = torch.clamp(x, max=EXP_CUT)
    return torch.where(x < EXP_CUT, torch.log(torch.expm1(xs)), x)


def log1mexp(x):
    """log(1 - e^{-x}) for x > 0; an underflowed x (exactly 0) is clamped
    so the result stays finite."""
    xc = torch.clamp(x, min=1e-35)
    return torch.log(-torch.expm1(-xc))


def xoexpm1x(x):
    """x / (e^x - 1), stable: -> 1 as x -> 0, -> 0 as x -> inf."""
    xc = torch.clamp(x, 1e-30, EXP_CUT)
    val = xc / torch.expm1(xc)
    return torch.where(x > EXP_CUT, torch.zeros_like(val), val)
