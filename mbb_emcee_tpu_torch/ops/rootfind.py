"""Fixed-iteration, branchless 1-D root finding and maximization.

Torch twin of mbb_emcee_tpu/ops/rootfind.py. A fixed iteration count keeps
every call shape-static and batched over any leading shape (walkers, chain
samples); the loops are plain Python over whole tensors.
"""

import torch

_INVPHI = 0.6180339887498949   # 1/phi
_INVPHI2 = 0.3819660112501051  # 1/phi^2


def bisect_newton_decreasing(g_and_gp, lo, hi, bisect_iters=10,
                             newton_iters=3):
    """Root of a strictly DECREASING g on [lo, hi] (g(lo) > 0 > g(hi)):
    fixed bisection to localize, then bracket-clamped Newton to polish.

    g_and_gp(u) -> (g(u), g'(u)) with g' < 0 on the bracket; lo/hi are
    tensors of the batch shape. The clamp keeps every Newton iterate inside
    the current bracket, so the solve cannot diverge.
    """
    a, b = lo, hi
    for _ in range(bisect_iters):
        m = 0.5 * (a + b)
        gm, _ = g_and_gp(m)
        pos = gm > 0.0
        a = torch.where(pos, m, a)
        b = torch.where(pos, b, m)
    return _clamped_newton(g_and_gp, a, b, newton_iters)


def _clamped_newton(g_and_gp, a, b, iters):
    u = 0.5 * (a + b)
    for _ in range(iters):
        gu, gpu = g_and_gp(u)
        u = torch.minimum(torch.maximum(
            u - gu / torch.clamp(gpu, max=-1e-10), a), b)
    return u


def bisect_tree_newton_decreasing(g_and_gp, lo, hi, rounds=2, levels=3,
                                  newton_iters=3):
    """bisect_newton_decreasing with rounds * levels bisections taken as
    `rounds` rounds of a tree: each round forms the midpoints of `levels`
    bisection levels at once (2^levels - 1 of them, in heap order, each as
    0.5 * (lo + hi) of its own bracket, the bisection's own operations),
    evaluates g at all of them, then walks the tree on the signs of g. The
    bracket, and so the result, is the sequential solve's bit for bit.

    The plain twin of the merge solve in csrc/lnprob.cuh's
    mbb_lnprob_eval_group (2 rounds of 3 levels), for tests.
    """
    a, b = torch.broadcast_tensors(lo, hi)
    n = 2 ** levels - 1
    for _ in range(rounds):
        los, his, mids = [a], [b], [0.5 * (a + b)]
        for i in range(1, n):
            p = (i - 1) // 2
            # node i's bracket: its parent's left half (odd i: the parent's
            # g <= 0 sets b = m) or right half (even i: a = m)
            lo_i, hi_i = (los[p], mids[p]) if i % 2 else (mids[p], his[p])
            los.append(lo_i)
            his.append(hi_i)
            mids.append(0.5 * (lo_i + hi_i))
        g = torch.stack([g_and_gp(m)[0] for m in mids])
        mids = torch.stack(mids)
        node = torch.zeros((1, *a.shape), dtype=torch.int64)
        for _ in range(levels):
            m = torch.gather(mids, 0, node)[0]
            pos = torch.gather(g, 0, node)[0] > 0.0
            a = torch.where(pos, m, a)
            b = torch.where(pos, b, m)
            node = 2 * node + torch.where(pos, 2, 1)
    return _clamped_newton(g_and_gp, a, b, newton_iters)


def golden_max(f, lo, hi, iters=64):
    """Argmax of a unimodal function on [lo, hi] by golden-section search.

    lo/hi are tensors of the batch shape; f maps such a tensor to values of
    the same shape. iters=64 shrinks the interval by 0.618^64 ~ 4e-14 of its
    width (fp32-saturating). Returns (x_max, f(x_max)).
    """
    a, b = lo, hi
    x1 = a + _INVPHI2 * (b - a)
    x2 = a + _INVPHI * (b - a)
    f1, f2 = f(x1), f(x2)
    for _ in range(iters):
        # If f1 >= f2 the max is in [a, x2]; else in [x1, b].
        left = f1 >= f2
        a_n = torch.where(left, a, x1)
        b_n = torch.where(left, x2, b)
        x1_n = torch.where(left, a_n + _INVPHI2 * (b_n - a_n), x2)
        x2_n = torch.where(left, x1, a_n + _INVPHI * (b_n - a_n))
        # One new evaluation per iteration: the other interior value carries.
        f_new = f(torch.where(left, x1_n, x2_n))
        f1, f2 = torch.where(left, f_new, f2), torch.where(left, f1, f_new)
        a, b, x1, x2 = a_n, b_n, x1_n, x2_n
    xm = 0.5 * (a + b)
    return xm, f(xm)
