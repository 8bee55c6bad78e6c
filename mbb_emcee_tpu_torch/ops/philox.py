"""Philox-4x32-10 counter-based generator in plain torch.

The stretch-move kernels (csrc/stretch.cuh) draw their proposal randomness
with Philox-4x32-10 (Salmon et al. 2011, "Parallel random numbers: as easy
as 1, 2, 3"), keyed by a 64-bit launch seed and counted by (step,
half + 2 * source, lane).
This module is the same generator written with int64 torch ops, so the
plain sampler draws the identical stream on any device and a kernel run can
be replayed exactly by the plain version.

32-bit words live in int64 tensors; the 32x32 -> 64-bit products are split
into 16-bit limbs so nothing overflows int64.
"""

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


def stretch_uniforms(key, step0, nsteps, half, device, source=0):
    """The kernels' proposal uniforms for `nsteps` ensemble steps starting
    at global step `step0`, laid out as the external-uniforms input:
    (6 * nsteps, half) fp32, rows 6t + 3h + c for step t, half h (0 = A,
    1 = B) and draw c (0 z, 1 partner, 2 accept).

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
    lane = torch.arange(half, dtype=torch.int64, device=device).view(1, 1,
                                                                     half)
    full = lead + (nsteps, 2, half)
    c0 = (step & _MASK32).expand(full)
    c1 = ((h + 2 * src) & _MASK32).expand(full)
    c3 = (step >> 32).expand(full)
    x0, x1, x2, _ = philox4x32(c0, c1, lane.expand(full), c3, int(key))
    u = torch.stack([bits_to_uniform(x) for x in (x0, x1, x2)], dim=-2)
    return u.reshape(lead + (6 * nsteps, half))
