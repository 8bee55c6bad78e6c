"""The roofline yardstick of the port's sampler kernels: fp32 operations
and bytes each launch needs, and the H100's published peaks.

Frozen copy of chip_smoke.py:381-447 (PEAK_FP32_OPS, PEAK_BYTES,
OPS_TRANS, OPS_DIV, lnprob_ops, stretch_step_ops, bound, k1_bound,
k2_bound) as of the commit that added this benchmark, so that a later
change to the program cannot move the yardstick it is measured by.
"""

# The card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
# limit): fp32 outside the tensor cores, and device memory.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operation counts of the bound: a libdevice exp, expm1 or log counts as 20
# fp32 operations and a division as 10 (their instruction sequences), any
# other add, multiply, compare, min/max or select as 1.
OPS_TRANS, OPS_DIV = 20, 10


def lnprob_ops(icfg):
    """fp32 operations of one lnprob for the likelihood configuration icfg
    (opthin, noalpha, use_chol, nb, nnodes, ...), counted from the model's
    formulas: the same for every walker (out-of-box walkers run the whole
    chain on clipped values)."""
    opthin, noalpha, use_chol, nb, nnodes = (int(v) for v in icfg[:5])
    t, d = OPS_TRANS, OPS_DIV
    # grey ln S: x, 3u - log_expm1(x) [+ beta u | + log1mexp(tau)]
    grey = 3 * t + 5 + (2 if opthin else 3 * t + 6)
    # g and g': x, q, g'_Planck [+ tau, h(tau), clamp, g'] + g
    slope = 2 * t + d + 7 + (3 if opthin else 2 * t + d + 17)
    node = 1 + grey + 5 + (t + 4)       # ln x, ln S, Wien select, w e^(..)
    n = 20 + 2 * t + 2 + t              # box, ln T, ln x0, ln fnorm
    if not noalpha:                     # bracket, 6 bisections, 2 Newton
        n += (2 * t + 7) + 6 * (slope + 5) + 2 * (slope + d + 4) + grey
    n += 1 + grey + 5                   # the normalization point
    n += nb * nnodes * node + 3 * nb    # band sums, residuals
    n += nb * (nb + 1) + 2 * nb if use_chol else 3 * nb
    return n + 20 + 4                   # priors, lnp


def stretch_step_ops(philox):
    """fp32/int32 operations of one walker's proposal and accept test beside
    its lnprob: the Philox-4x32-10 draw (10 rounds of 2 multiplies, 2
    high multiplies, 4 xors and 2 key adds; 3 uniform maps) or nothing for
    external uniforms, z, the partner, the proposal, and ln z, ln u2."""
    draw = 10 * 10 + 9 if philox else 0
    return draw + (4 + OPS_DIV) + 3 + 3 * 5 + (2 * OPS_TRANS + 5) + 1


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops at the fp32 peak and bytes at
    the memory peak."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def k1_bound(icfg, n, nfree, nconsts):
    """K1 on n vectors: n lnprobs; reads theta and the constants, writes n
    floats."""
    return bound(n * lnprob_ops(icfg), 4 * (n * nfree + nconsts + n))


def k2_bound(icfg, nsrc, nw, nfree, nconsts, nsteps, nrec):
    """K2 (nsrc = 1) or K3 over nsrc ensembles of nw walkers, Philox mode:
    the initial lnprob of every walker, then one lnprob and one proposal
    per walker per step; reads positions, accepts and the constants, writes
    the chain records and the final state."""
    ops = nsrc * nw * (lnprob_ops(icfg)
                       + nsteps * (lnprob_ops(icfg) + stretch_step_ops(True)))
    nbytes = 4 * (nsrc * nw * (nfree + 1) + nconsts
                  + nsrc * nrec * nw * (nfree + 1) + nsrc * nw * (nfree + 2))
    return bound(ops, nbytes)
