"""Philox-4x32-10 counter-based generator in plain torch.

The stretch-move kernels (csrc/stretch.cuh) draw their proposal randomness
with Philox-4x32-10 (Salmon et al. 2011, "Parallel random numbers: as easy
as 1, 2, 3"), keyed by a 64-bit launch seed and counted by (step,
half + 2 * source, lane).
This module is the same generator written with int64 torch ops, so the
plain sampler draws the identical stream on any device and a kernel run can
be replayed exactly by the plain version.

Parallel tempering, HMC and nested sampling (tempering.py, hmc.py,
nested.py) draw from the same generator under the same key on counters the
stretch move never uses (tagged_bits): a tempered or nested run on the
lnprob kernel is replayed by the plain likelihood on the same draws, and a
source's stream does not depend on its batch.

32-bit words live in int64 tensors; the 32x32 -> 64-bit products are split
into 16-bit limbs so nothing overflows int64.
"""

import math

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_ROUNDS = 10


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of the 64-bit product of constant m and x."""
    x_lo = x & 0xFFFF
    x_hi = x >> 16
    p_lo = x_lo * m                      # < 2^48
    p_hi = x_hi * m                      # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    lo = mid & _MASK32
    hi = (p_hi >> 16) + (mid >> 32)
    return hi & _MASK32, lo


def philox4x32(c0, c1, c2, c3, key):
    """Philox-4x32-10 of the counter words (int64 tensors holding 32-bit
    values, broadcastable) under the 64-bit python-int `key`. Returns the
    four output words as int64 tensors."""
    k0 = key & _MASK32
    k1 = (key >> 32) & _MASK32
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits):
    """32-bit words -> fp32 uniforms in (0, 1): (bits >> 8) 2^-24 + 2^-25,
    the mapping of mbb_emcee_tpu/ops/pallas_sampler.py and of the kernel."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


def stretch_uniforms(key, step0, nsteps, half, device, source=0, lane0=0):
    """The kernels' proposal uniforms for `nsteps` ensemble steps starting
    at global step `step0`, laid out as the external-uniforms input:
    (6 * nsteps, half) fp32, rows 6t + 3h + c for step t, half h (0 = A,
    1 = B) and draw c (0 z, 1 partner, 2 accept), for walker lanes
    lane0..lane0 + half - 1 of each half (a walker shard's block of the
    ensemble's lanes: parallel.ShardedEnsembleSampler).

    Counter words: (step low 32 bits, h + 2 * source, lane, step high 32
    bits), so source 0 is the single-ensemble kernel's stream. `source` is
    an int, or a 1-D sequence of S source indices, which adds a leading
    axis: (S, 6 * nsteps, half), the multi-source kernel's streams."""
    src = torch.as_tensor(source, dtype=torch.int64, device=device)
    lead = tuple(src.shape)
    src = src.reshape(lead + (1, 1, 1))
    step = (torch.arange(nsteps, dtype=torch.int64, device=device)
            + int(step0)).view(nsteps, 1, 1)
    h = torch.arange(2, dtype=torch.int64, device=device).view(1, 2, 1)
    lane = (torch.arange(half, dtype=torch.int64, device=device)
            + int(lane0)).view(1, 1, half)
    full = lead + (nsteps, 2, half)
    c0 = (step & _MASK32).expand(full)
    c1 = ((h + 2 * src) & _MASK32).expand(full)
    c3 = (step >> 32).expand(full)
    x0, x1, x2, _ = philox4x32(c0, c1, lane.expand(full), c3, int(key))
    u = torch.stack([bits_to_uniform(x) for x in (x0, x1, x2)], dim=-2)
    return u.reshape(lead + (6 * nsteps, half))


# Draw tags of the parallel-tempering and HMC streams. stretch_uniforms puts
# step >> 32 in the fourth counter word, which stays below 2^31 for any step
# below 2^63; these streams put 2^31 + tag * 2^20 + (step >> 32) there, so no
# counter of theirs is ever one of the stretch move's under the same key.
_TAG_BASE = 0x80000000
PT_TAG, HMC_TAG_A, HMC_TAG_B, NESTED_TAG = 1, 2, 3, 4
_MAX_TAGGED_STEP = 1 << 52
# Nested sampling's start draws sit on lanes from 2^31 of iteration 0; an
# iteration's draws use lanes below nsteps * nbatch, which stays under it.
_NESTED_START_LANE = 1 << 31


def tagged_bits(key, tag, step0, nsteps, nlanes, device, source=0, lane0=0):
    """The four Philox words of counter (step low 32 bits, source, lane,
    2^31 + tag * 2^20 + step high bits) for `nsteps` steps from global step
    `step0` and lanes lane0..lane0+nlanes-1: int64 tensors of shape
    (nsteps, nlanes), or (nsteps, S, nlanes) when `source` is a 1-D
    sequence of S source indices. A source's words depend on its index
    alone, not on the batch it is drawn with."""
    if int(step0) < 0 or int(step0) + int(nsteps) > _MAX_TAGGED_STEP:
        raise ValueError(f"step {step0} + {nsteps} outside the tagged "
                         f"streams' range [0, 2^52)")
    if int(lane0) < 0 or int(lane0) + int(nlanes) > 1 << 32:
        raise ValueError(f"lanes {lane0} + {nlanes} outside [0, 2^32)")
    src = torch.as_tensor(source, dtype=torch.int64, device=device)
    lead = tuple(src.shape)
    ones = (1,) * len(lead)
    step = (torch.arange(nsteps, dtype=torch.int64, device=device)
            + int(step0)).view((nsteps,) + ones + (1,))
    full = (nsteps,) + lead + (nlanes,)
    c0 = (step & _MASK32).expand(full)
    c1 = (src.view((1,) + lead + (1,)) & _MASK32).expand(full)
    c2 = (torch.arange(nlanes, dtype=torch.int64, device=device)
          + int(lane0)).expand(full)
    c3 = (_TAG_BASE + (int(tag) << 20) + (step >> 32)).expand(full)
    return philox4x32(c0, c1, c2, c3, int(key))


def pt_uniforms(key, step0, nsteps, nrungs, nwalkers, device, source=0):
    """Parallel tempering's uniforms for `nsteps` tempered steps from global
    step `step0`: one Philox call per (step, rung, walker) gives that
    walker's three move uniforms (z, partner, accept) and the swap uniform
    of the pair (rung, rung + 1). Returns (u (nsteps, [S,] 3, K, W),
    us (nsteps, [S,] K - 1, W)) fp32."""
    x = tagged_bits(key, PT_TAG, step0, nsteps, nrungs * nwalkers, device,
                    source)
    lead = x[0].shape[:-1]
    u = torch.stack([bits_to_uniform(w) for w in x[:3]], dim=-2)
    u = u.reshape(lead + (3, nrungs, nwalkers))
    us = bits_to_uniform(x[3]).reshape(lead + (nrungs, nwalkers))
    return u, us[..., :-1, :]


def hmc_draws(key, step0, nsteps, nchains, nfree, device, source=0):
    """HMC's draws for `nsteps` transitions from global step `step0`: two
    Philox calls per (step, chain) give eight uniforms, the first six turned
    into Box-Muller normals (momenta; nfree <= 6), the seventh the step-size
    jitter 0.8 + 0.4 u and the eighth the accept uniform. Returns (normals
    (nsteps, [S,] nchains, nfree), jitter (nsteps, [S,] nchains, 1), accept
    uniforms (nsteps, [S,] nchains)) fp32."""
    if nfree > 6:
        raise ValueError(f"hmc_draws serves at most 6 free parameters; "
                         f"got {nfree}")
    u = [bits_to_uniform(w) for tag in (HMC_TAG_A, HMC_TAG_B)
         for w in tagged_bits(key, tag, step0, nsteps, nchains, device,
                              source)]
    normals = []
    for k in range(3):
        r = torch.sqrt(-2.0 * torch.log(u[2 * k]))
        th = (2.0 * math.pi) * u[2 * k + 1]
        normals += [r * torch.cos(th), r * torch.sin(th)]
    return (torch.stack(normals[:nfree], dim=-1),
            (0.8 + 0.4 * u[6])[..., None], u[7])


def _index(u, n):
    """Uniforms in (0, 1) -> indices in [0, n), the stretch move's
    partner mapping."""
    return torch.clamp((u * n).to(torch.int64), max=int(n) - 1)


def nested_draws(key, iteration0, niters, nbatch, nsteps, nsurv, device,
                 source=0):
    """Nested sampling's draws for `niters` iterations from global
    iteration `iteration0`: one Philox call per (iteration, step k, lane b)
    gives replacement b's partner index in [0, nsurv), its z and accept
    uniforms at step k, and (at k = 0) its seed index in [0, nsurv).
    Returns (seed (niters, [S,] nbatch) int64, partner (niters, [S,]
    nsteps, nbatch) int64, uz, ua (niters, [S,] nsteps, nbatch) fp32)."""
    if int(nsteps) * int(nbatch) > _NESTED_START_LANE:
        raise ValueError("nsteps * nbatch must stay below 2^31")
    x = tagged_bits(key, NESTED_TAG, iteration0, niters,
                    int(nsteps) * int(nbatch), device, source)
    lead = x[0].shape[:-1]
    x = [w.reshape(lead + (int(nsteps), int(nbatch))) for w in x]
    return (_index(bits_to_uniform(x[3][..., 0, :]), nsurv),
            _index(bits_to_uniform(x[0]), nsurv),
            bits_to_uniform(x[1]), bits_to_uniform(x[2]))


def nested_start(key, nlive, ndim, device, source=0):
    """Nested sampling's start: ([S,] nlive, ndim) fp32 uniforms in the
    unit cube, the four words of each Philox call in order, on lanes from
    2^31 of iteration 0 (no iteration's draws use them)."""
    nwords = int(nlive) * int(ndim)
    x = tagged_bits(key, NESTED_TAG, 0, 1, -(-nwords // 4), device, source,
                    lane0=_NESTED_START_LANE)
    w = torch.stack(x, dim=-1)[0]
    lead = w.shape[:-2]
    w = w.reshape(lead + (-1,))[..., :nwords]
    return bits_to_uniform(w).reshape(lead + (int(nlive), int(ndim)))


# Lanes x steps per block of draws: bounds the int64 intermediates of one
# tagged_bits call (a dozen tensors of this many elements).
BLOCK_ELEMS = 1 << 20


def step_blocks(draw, step0, total, lanes):
    """Yield each step's draws for `total` steps from `step0`, drawn
    `draw(step, n)` a block at a time (n steps of `lanes` lanes each within
    BLOCK_ELEMS). Counter-based: a step's draws do not depend on the
    blocks."""
    done = 0
    while done < total:
        n = max(1, min(total - done, BLOCK_ELEMS // max(int(lanes), 1)))
        block = draw(step0 + done, n)
        for t in range(n):
            yield tuple(b[t] for b in block)
        done += n
