"""Numeric building blocks (stable special functions, fixed-iteration root
finding, fixed-node quadrature, the Philox generator) and the CUDA kernels'
wrappers (lnprob_kernel, sampler_kernel, multifit_kernel, derived_kernel)
with their build (build). Neither the wrappers nor the build are imported
here: a kernel is built when its wrapper first launches it."""

from mbb_emcee_tpu_torch.ops.special import log_expm1, log1mexp, xoexpm1x
from mbb_emcee_tpu_torch.ops.rootfind import bisect_decreasing, golden_max
from mbb_emcee_tpu_torch.ops.quadrature import gauss_legendre, loglam_nodes

__all__ = [
    "log_expm1", "log1mexp", "xoexpm1x",
    "bisect_decreasing", "golden_max",
    "gauss_legendre", "loglam_nodes",
]


def kernel_launches():
    """The launches of the hand-written kernels (K1-K3) so far, summed: a
    graph capture during which it moves holds a launch that a replay would
    make uncounted (sampler._StepGraphs)."""
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    from mbb_emcee_tpu_torch.ops.multifit_kernel import mbb_multi_stretch_run
    from mbb_emcee_tpu_torch.ops.sampler_kernel import mbb_stretch_run
    return (mbb_lnprob.launches + mbb_stretch_run.launches
            + mbb_multi_stretch_run.launches)
