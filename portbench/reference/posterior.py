"""The posterior's percentiles by importance sampling, in float64: the
plain reference that a fit's summaries (par_cen) are judged against.

The density is model.lnprob of the source's own photometry, box and
priors; nothing of the sampler under test is read. Population Monte Carlo
with mixtures of multivariate Student-t proposals: the first proposal is
centred on the configuration's true parameters with the configuration's
starting widths. Each round splits the weighted draws into CLUSTERS cells
by weighted k-means in whitened coordinates and fits a t to each cell, so
that a curved posterior (the MBB's tail towards low alpha bends T and
lambda0 with it) is covered piece by piece; a draw's weight is truncated
at sqrt(n) times the mean for the fit, and the best-weighted draws stand
in while the weights are degenerate. Every proposal is a defensive
mixture of those cells' t, one t of the whole sample twice as wide, and
the first, broad proposal, which keeps every weight bounded. The last
mixture's weighted draws give the percentiles.
"""

from __future__ import annotations

import math

import torch

DF = 5.0
# draws that stand in for the weighted sample while its weights are
# degenerate (an effective sample size below this)
ELITE = 512
# the summaries' central interval, as par_cen's
PERCENTILE = 68.3


def _t_draw(g, n, mu, chol, df=DF):
    d = mu.shape[0]
    z = torch.randn((n, d), generator=g, dtype=mu.dtype, device=mu.device)
    chi = torch.randn((n, int(df)), generator=g, dtype=mu.dtype,
                      device=mu.device).pow(2).sum(-1)
    return mu + (z @ chol.T) * torch.sqrt(df / chi)[:, None]


def _t_logpdf(x, mu, chol, df=DF):
    d = mu.shape[0]
    y = torch.linalg.solve_triangular(chol, (x - mu).T, upper=False).T
    maha = (y * y).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    return (math.lgamma((df + d) / 2) - math.lgamma(df / 2)
            - 0.5 * d * math.log(df * math.pi) - 0.5 * logdet
            - 0.5 * (df + d) * torch.log1p(maha / df))


def _chol(cov):
    d = cov.shape[0]
    cov = 0.5 * (cov + cov.T)
    jitter = 1e-12 * torch.diagonal(cov).mean()
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    for _ in range(8):
        out, info = torch.linalg.cholesky_ex(cov + jitter * eye)
        if int(info) == 0:
            return out
        jitter = jitter * 100.0
    raise RuntimeError("proposal covariance is not positive definite")


def _moments(x, w):
    w = w / w.sum()
    mu = (w[:, None] * x).sum(0)
    d = x - mu
    return mu, (w[:, None] * d).T @ d


def _weights(logw):
    logw = torch.where(torch.isfinite(logw), logw,
                       torch.full_like(logw, -math.inf))
    w = torch.exp(logw - logw.max())
    return w, float(w.sum() ** 2 / (w * w).sum())


CLUSTERS = 8
# shares of the cells' t, the wide t of the whole sample, the first
# proposal; and the least share of a cell within the first
SHARES = (0.75, 0.15, 0.10)
CELL_FLOOR = 0.25 / CLUSTERS


def _fit(x, w, g, mu0, chol0):
    """The next proposal [(mu, chol, share)] from draws x (n, d) with
    weights w (n,)."""
    mu, cov = _moments(x, w)
    chol = _chol(cov)
    y = torch.linalg.solve_triangular(chol, (x - mu).T, upper=False).T
    pick = torch.multinomial(w / w.sum(), CLUSTERS, replacement=False,
                             generator=g)
    centres = y[pick]
    for _ in range(12):
        lab = torch.cdist(y, centres).argmin(1)
        for j in range(CLUSTERS):
            sel = lab == j
            if w[sel].sum() > 0:
                centres[j] = _moments(y[sel], w[sel])[0]
    cells = []
    for j in range(CLUSTERS):
        sel = lab == j
        if int(sel.sum()) > 10 * x.shape[1] and float(w[sel].sum()) > 0:
            m, c = _moments(x[sel], w[sel])
            cells.append((m, _chol(c * 2.0), float(w[sel].sum())))
    total = sum(s for _, _, s in cells)
    share = [max(s / total, CELL_FLOOR) for _, _, s in cells]
    norm = sum(share)
    out = [(m, c, SHARES[0] * s / norm)
           for (m, c, _), s in zip(cells, share)]
    out.append((mu, _chol(cov * 1.5) * 2.0, SHARES[1]))
    out.append((mu0, chol0, SHARES[2]))
    return out


def _logq_mix(x, comps):
    return torch.logsumexp(torch.stack(
        [_t_logpdf(x, m, c) + math.log(s) for m, c, s in comps]), dim=0)


def _draw_mix(g, n, comps):
    counts = [int(n * s) for _, _, s in comps[1:]]
    counts = [n - sum(counts)] + counts
    return torch.cat([_t_draw(g, k, m, c)
                      for (m, c, _), k in zip(comps, counts)])


def weighted_percentiles(x, w, qs):
    """Weighted percentiles qs (in %) of each column of x (n, d): the
    inverse of the weights' midpoint CDF, linear between draws."""
    out = []
    for j in range(x.shape[1]):
        v, idx = torch.sort(x[:, j])
        ws = w[idx]
        c = torch.cumsum(ws, 0) - 0.5 * ws
        c = c / ws.sum()
        q = torch.as_tensor([p / 100.0 for p in qs], dtype=x.dtype,
                            device=x.device)
        k = torch.searchsorted(c, q).clamp(1, v.shape[0] - 1)
        c0, c1 = c[k - 1], c[k]
        f = ((q - c0) / (c1 - c0).clamp_min(1e-300)).clamp(0.0, 1.0)
        out.append(v[k - 1] + f * (v[k] - v[k - 1]))
    return torch.stack(out)               # (d, len(qs))


def posterior_summary(lnp_fn, start, scale, g, rounds=6, n_round=1 << 16,
                      n_final=1 << 20, block=1 << 18):
    """(median, +err, -err) of each parameter (d, 3) under the density
    exp(lnp_fn(theta (n, d) float64)), and the final effective sample
    size. `start` and `scale` (d,) place the first proposal; `g` is the
    torch.Generator of the draws, on the device the work runs on."""
    dev = g.device
    mu = torch.as_tensor(start, dtype=torch.float64, device=dev)
    sd = torch.as_tensor(scale, dtype=torch.float64, device=dev)
    chol = torch.diag(sd)

    def lnp_blocks(x):
        return torch.cat([lnp_fn(x[i:i + block])
                          for i in range(0, x.shape[0], block)])

    mu0, chol0 = mu, chol
    comps = [(mu, chol, 1.0)]
    for _ in range(rounds):
        x = _draw_mix(g, n_round, comps)
        logw = lnp_blocks(x) - _logq_mix(x, comps)
        w, ess = _weights(logw)
        if ess < ELITE:
            top = torch.topk(torch.nan_to_num(logw, nan=-math.inf),
                             ELITE).indices
            x = x[top]
            w = torch.ones(ELITE, dtype=x.dtype, device=dev)
        else:
            w = torch.minimum(w, w.mean() * math.sqrt(n_round))
        comps = _fit(x, w, g, mu0, chol0)
    xs, lws = [], []
    for i in range(0, n_final, block):
        x = _draw_mix(g, min(block, n_final - i), comps)
        xs.append(x)
        lws.append(lnp_fn(x) - _logq_mix(x, comps))
    x, logw = torch.cat(xs), torch.cat(lws)
    w, ess = _weights(logw)
    p = PERCENTILE
    lo, mid, hi = weighted_percentiles(x, w, [50 - p / 2, 50.0,
                                              50 + p / 2]).unbind(-1)
    cen = torch.stack([mid, hi - mid, mid - lo], dim=-1)
    return cen.cpu().numpy(), ess
