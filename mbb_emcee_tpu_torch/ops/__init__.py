"""Numeric building blocks (stable special functions, fixed-iteration root
finding, fixed-node quadrature, the Philox generator) and the CUDA kernels'
wrappers (lnprob_kernel, sampler_kernel) with their build (build)."""
