"""Numeric building blocks (stable special functions, fixed-iteration root
finding, fixed-node quadrature, the Philox generator) and the CUDA kernels'
wrappers (lnprob_kernel, sampler_kernel) with their build (build)."""


def kernel_launches():
    """The launches of the hand-written kernels (K1-K3) so far, summed: a
    graph capture during which it moves holds a launch that a replay would
    make uncounted (sampler._StepGraphs)."""
    from mbb_emcee_tpu_torch.ops.lnprob_kernel import mbb_lnprob
    from mbb_emcee_tpu_torch.ops.multifit_kernel import mbb_multi_stretch_run
    from mbb_emcee_tpu_torch.ops.sampler_kernel import mbb_stretch_run
    return (mbb_lnprob.launches + mbb_stretch_run.launches
            + mbb_multi_stretch_run.launches)
