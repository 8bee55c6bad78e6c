"""Posterior visualization: SED bands, corner plots, walker traces, the
posterior-predictive picture, population bands and photo-z P(z).

Torch twin of mbb_emcee_tpu/plotting.py. The figures read what the results
objects already compute (sed_percentiles, best_fit_model, parameter_chain,
the population's marginal_pdf) on their own device; only the Monte-Carlo
marginal of a population without marginal_pdf (_mc_marginal) evaluates
torch here, on the population fitter's device, from the same numpy
importance draws as the JAX package's.

matplotlib is imported lazily, at the first plot call, so the package
imports without it and each plot call raises an ImportError naming it;
every function accepts ax/fig handles for composition and returns the
figure. Use `matplotlib.use("Agg")` (or save via `savefig=`) on servers.
"""

from __future__ import annotations

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import PARAM_NAMES

_LABELS = {
    "T": r"$T/(1+z)$ [K]",
    "beta": r"$\beta$",
    "lambda0": r"$\lambda_0 (1+z)$ [$\mu$m]",
    "alpha": r"$\alpha$",
    "fnorm": r"$f_{\nu,\mathrm{norm}}$ [mJy]",
}


def _mpl():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plotting requires matplotlib (not a core dependency; "
            "install it to use plot_sed/plot_corner/plot_chain)") from e
    return plt


def _finish(fig, savefig):
    if savefig is not None:
        fig.savefig(savefig, bbox_inches="tight", dpi=150)
    return fig


def _host(x):
    """A tensor (on any device) or array as host fp64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float)


def plot_sed(res, ax=None, wave_range=None, n_wave=200, percentile=68.3,
             thin=1, show_best=True, savefig=None):
    """Photometry with the posterior-predictive SED band.

    Draws the data (error bars; downward arrows for bands flagged as
    photometric upper limits), the posterior median SED and its
    `percentile` band (batched evaluation over the thinned chain on the
    results' device), and optionally the maximum-probability model.
    Log-log axes, observed frame.

    Returns the matplotlib figure.
    """
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(6.0, 4.2))
    else:
        fig = ax.figure

    wave = _host(res.data_wave)
    flux = _host(res.data_flux)
    unc = _host(res.data_flux_unc)
    if wave_range is None:
        wave_range = (0.3 * wave.min(), 3.0 * wave.max())
    grid = np.geomspace(wave_range[0], wave_range[1], int(n_wave))

    mid, hi, lo = res.sed_percentiles(grid, percentile=percentile, thin=thin)
    ax.fill_between(grid, lo, hi, alpha=0.25, lw=0,
                    label=f"{percentile:.0f}% posterior band")
    ax.plot(grid, mid, lw=1.5, label="posterior median")
    if show_best:
        best = res.best_fit_model()
        ax.plot(grid, _host(best(grid)), lw=1.0, ls="--",
                label="best fit (max lnprob)")

    uplims = getattr(res.param_spec, "uplim_bands", None)
    uplims = (np.zeros(wave.size, bool) if uplims is None
              else np.asarray(uplims, bool))
    det = ~uplims
    ax.errorbar(wave[det], flux[det], yerr=unc[det], fmt="o", ms=5,
                capsize=2, color="k", zorder=5, label="photometry")
    if uplims.any():
        ax.errorbar(wave[uplims], flux[uplims], yerr=0.25 * flux[uplims],
                    uplims=True, fmt="none", color="k", zorder=5,
                    label="upper limits")

    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"observed wavelength [$\mu$m]")
    ax.set_ylabel(r"$f_\nu$ [mJy]")
    ax.legend(loc="best", fontsize=8)
    return _finish(fig, savefig)


def plot_corner(res, params=None, bins=40, percentile=68.3, fig=None,
                savefig=None):
    """Corner plot of the (free) parameter posteriors.

    1-D histograms on the diagonal with the median and +/- percentile/2
    lines; 2-D histograms below. `params` defaults to the free
    parameters; fixed parameters are zero-width and excluded.

    Returns the matplotlib figure.
    """
    plt = _mpl()
    if params is None:
        params = res.free_param_names
    params = list(params)
    chains = [_host(res.parameter_chain(p)) for p in params]
    n = len(params)
    if n == 0:
        raise ValueError("no free parameters to plot")
    if fig is None:
        fig, axes = plt.subplots(n, n, figsize=(2.0 * n, 2.0 * n),
                                 squeeze=False)
    else:
        axes = np.asarray(fig.subplots(n, n, squeeze=False))

    p = float(percentile)
    qs = [50.0 - p / 2, 50.0, 50.0 + p / 2]
    for i in range(n):
        for j in range(n):
            ax = axes[i][j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(chains[i], bins=bins, histtype="step",
                        color="C0", density=True)
                for q, ls in zip(np.percentile(chains[i], qs),
                                 (":", "--", ":")):
                    ax.axvline(q, color="k", lw=0.8, ls=ls)
                ax.set_yticks([])
            else:
                ax.hist2d(chains[j], chains[i], bins=bins, cmap="Blues")
            if i == n - 1:
                ax.set_xlabel(_LABELS.get(params[j], params[j]), fontsize=8)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(_LABELS.get(params[i], params[i]), fontsize=8)
            elif j > 0:
                ax.set_yticklabels([])
            ax.tick_params(labelsize=7)
    fig.subplots_adjust(hspace=0.08, wspace=0.08)
    return _finish(fig, savefig)


def plot_ppc(res, ppc=None, thin=1, seed=0, bins=40, ax=None,
             savefig=None):
    """Posterior-predictive check figure: the replicated chi-square
    distribution (exactly chi-square with ndata dof) against the
    observed-discrepancy distribution, with the p-value annotated -- the
    picture behind `posterior_predictive().p_value`. Overlapping
    histograms mean the model reproduces its own photometry; an observed
    distribution far to the right means misfit, far to the left means
    overestimated errors.

    `ppc` takes an existing PPCResult; otherwise one is computed via
    res.posterior_predictive(thin=thin, seed=seed). Returns the figure.
    """
    plt = _mpl()
    if ppc is None:
        ppc = res.posterior_predictive(thin=thin, seed=seed)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5.4, 3.8))
    else:
        fig = ax.figure
    hi = float(np.percentile(np.concatenate(
        [ppc.chi2_obs, ppc.chi2_rep]), 99.5))
    grid = np.linspace(0.0, max(hi, 1.0), int(bins) + 1)
    ax.hist(ppc.chi2_rep, bins=grid, density=True, alpha=0.45,
            color="C0", label=r"replicated $\chi^2$ ($T_{\rm rep}$)")
    ax.hist(ppc.chi2_obs, bins=grid, density=True, histtype="step",
            lw=1.6, color="C3",
            label=r"observed discrepancy ($T_{\rm obs}$)")
    ax.axvline(float(np.median(ppc.chi2_obs)), color="C3", lw=0.9,
               ls="--")
    ax.set_xlabel(r"whitened $\chi^2$")
    ax.set_ylabel("density")
    ax.set_title(f"posterior predictive: p = {ppc.p_value:.3f} "
                 f"(ndata = {ppc.ndata}, nfree = {ppc.nfree})",
                 fontsize=9)
    ax.legend(loc="best", fontsize=8)
    return _finish(fig, savefig)


def plot_chain(res, params=None, max_walkers=50, savefig=None):
    """Per-walker trace plots of the recorded production chain (one panel
    per parameter) -- the standard eyeball check that burn-in ended
    before the recording started. Thick line: across-walker median.

    Returns the matplotlib figure.
    """
    plt = _mpl()
    if params is None:
        params = res.free_param_names
    params = list(params)
    from mbb_emcee_tpu_torch.likelihood import param_index

    def _idx(name):
        # Generic-model results (sed.SEDResults) resolve names themselves;
        # the MBB results fall back to the package-wide 5-param lookup.
        lookup = getattr(res, "_param_index", None)
        return lookup(name) if lookup is not None else param_index(name)

    chain = _host(res.chain)                    # (nwalkers, nsteps, npar)
    nw = min(int(max_walkers), chain.shape[0])
    fig, axes = plt.subplots(len(params), 1, sharex=True,
                             figsize=(6.0, 1.6 * len(params)),
                             squeeze=False)
    for ax, name in zip(axes[:, 0], params):
        tr = chain[:nw, :, _idx(name)]
        ax.plot(tr.T, color="C0", alpha=0.15, lw=0.5)
        ax.plot(np.median(chain[:, :, _idx(name)], axis=0),
                color="k", lw=1.2)
        ax.set_ylabel(_LABELS.get(name, name), fontsize=8)
        ax.tick_params(labelsize=7)
    axes[-1, 0].set_xlabel("recorded step")
    return _finish(fig, savefig)


def _mc_marginal(pop, k, n_mc=256, seed=0, device=None):
    """marginal(phi, x) for a population model WITHOUT `marginal_pdf`,
    built from the fitting contract it must already satisfy (`ln_dist`,
    normalized over the box), evaluated on `device` (None: the card; the
    population fitter passes its own). 1-parameter populations evaluate
    the density on the grid exactly; multi-parameter ones marginalize the
    other dimensions by uniform importance sampling over their box (fixed
    numpy draws from `seed`, the JAX package's, so the figure is
    deterministic; MC error shrinks the band estimate by ~1/sqrt(n_mc),
    fine for a plotted envelope)."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    K = len(pop.param_names)
    lo = np.asarray(pop.box_lower, np.float64)
    hi = np.asarray(pop.box_upper, np.float64)

    def dens(phi, th):
        phi = torch.as_tensor(np.asarray(phi, np.float32), device=device)
        th = torch.as_tensor(th, device=device)
        return torch.exp(pop.ln_dist(phi, th)).double().cpu().numpy()

    if K == 1:
        def marginal(phi, x):
            return dens(phi, np.asarray(x, np.float32)[:, None])
        return marginal

    others = [i for i in range(K) if i != k]
    rng = np.random.default_rng(seed)
    u = (lo[others] + (hi[others] - lo[others])
         * rng.random((n_mc, len(others)))).astype(np.float32)
    vol = float(np.prod(hi[others] - lo[others]))

    def marginal(phi, x):
        x = np.asarray(x, np.float32)
        th = np.empty((x.size, n_mc, K), np.float32)
        th[..., k] = x[:, None]
        for j, o in enumerate(others):
            th[..., o] = u[None, :, j]
        return vol * dens(phi, th).mean(axis=1)

    return marginal


def plot_population(hf, param, grid=400, n_draw=256, bins=24, ax=None,
                    savefig=None):
    """Population posterior for one parameter: the hyper-chain's band of
    population densities (median + 68% envelope of exact box-truncated
    marginals per hyper draw) over a histogram of the per-source posterior
    medians. The histogram is the measurement-broadened view; the band is
    the deconvolved population -- the figure a hierarchical fit exists to
    produce.

    `hf` is a finished HierarchicalFitter. When the population model
    exposes `marginal_pdf(phi, k, x)` (both built-in families do) the band
    uses those exact marginals; a custom model WITHOUT one still gets the
    figure through a Monte-Carlo fallback that marginalizes the model's
    own `ln_dist` numerically on the fitter's device (exact grid
    evaluation for 1-parameter populations; uniform-importance
    marginalization over the other box dimensions otherwise). `param` is
    the population-parameter name (e.g. "T").

    Returns the matplotlib figure.
    """
    plt = _mpl()
    pop = hf.population
    names = [str(p).lower() for p in pop.param_names]
    key = str(param).lower()
    if key not in names:
        raise ValueError(
            f"unknown population parameter {param!r}; "
            f"known: {pop.param_names}")
    k = names.index(key)

    lo = float(np.asarray(pop.box_lower)[k])
    hi = float(np.asarray(pop.box_upper)[k])

    flat = hf.flatchain
    stride = max(1, flat.shape[0] // int(n_draw))
    draws = flat[::stride][:int(n_draw)]
    medians = np.median(np.asarray(hf.samples)[..., k], axis=1)

    if hasattr(pop, "marginal_pdf"):
        def marginal(phi, xg):
            return pop.marginal_pdf(phi, k, xg)
    else:
        marginal = _mc_marginal(pop, k, device=hf.device)

    def band(xg):
        cs = np.stack([marginal(hf.free_space.expand(d), xg)
                       for d in draws])
        return (np.median(cs, axis=0),
                *np.percentile(cs, [15.85, 84.15], axis=0))

    # two passes: a coarse full-box pass finds the populated region (the
    # interim box is often far wider than the population and would crush
    # the figure), then the plotted grid resolves just that window
    x = np.linspace(lo, hi, int(grid))
    _, _, band_hi = band(x)
    support = x[band_hi > 1e-3 * band_hi.max()]
    x_lo = min(medians.min(), support.min())
    x_hi = max(medians.max(), support.max())
    pad = 0.08 * (x_hi - x_lo)
    x_lo, x_hi = max(lo, x_lo - pad), min(hi, x_hi + pad)
    x = np.linspace(x_lo, x_hi, int(grid))
    med, band_lo, band_hi = band(x)

    if ax is None:
        fig, ax = plt.subplots(figsize=(5.0, 3.4))
    else:
        fig = ax.figure
    ax.hist(medians, bins=bins, range=(x_lo, x_hi), density=True,
            color="0.8", edgecolor="0.55",
            label="per-source medians (broadened)")
    ax.set_xlim(x_lo, x_hi)
    ax.fill_between(x, band_lo, band_hi, color="C0", alpha=0.3,
                    label="population 68% band")
    ax.plot(x, med, color="C0", lw=1.5, label="population median")
    ax.set_xlabel(_LABELS.get(param, str(param)))
    ax.set_ylabel("density")
    ax.legend(fontsize=7, frameon=False)
    return _finish(fig, savefig)


def plot_pz(res, param="z", bins=60, percentile=68.3, reweight=None,
            z_true=None, ax=None, savefig=None):
    """P(z): the photo-z posterior of one source as a normalized histogram
    curve with median and +/- percentile/2 interval markers -- the figure
    a submm photo-z fit exists to produce.

    `res` is an SEDResults over a photo-z model (photoz.photoz_mbb);
    `param` names the sampled redshift. `reweight=` overlays a
    ReweightResult from the SAME result object (reweight.reweight_prior --
    a prior-sensitivity band in one figure); the overlay's legend says so
    when the reweighting is unreliable. `z_true` draws a truth/spec-z
    marker. Returns the figure.
    """
    plt = _mpl()
    z = _host(res.parameter_chain(param))
    p = float(percentile)
    qs = np.percentile(z, [50.0 - p / 2, 50.0, 50.0 + p / 2])
    if ax is None:
        fig, ax = plt.subplots(figsize=(5.0, 3.4))
    else:
        fig = ax.figure
    hist, edges = np.histogram(z, bins=int(bins), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.stairs(hist, edges, fill=True, color="C0", alpha=0.25)
    ax.stairs(hist, edges, color="C0", lw=1.5,
              label=f"P({param}) median {qs[1]:.2f} "
                    f"+{qs[2] - qs[1]:.2f} -{qs[1] - qs[0]:.2f}")
    ax.axvline(qs[1], color="C0", lw=1.0)
    for q in (qs[0], qs[2]):
        ax.axvline(q, color="C0", lw=0.8, ls=":")
    if reweight is not None:
        w = _host(reweight.weights)
        zs = _host(reweight.parameter_chain(param))
        hw, _ = np.histogram(zs, bins=edges, weights=w, density=True)
        tag = "reweighted"
        if not reweight.reliable:
            tag += " [UNRELIABLE: refit]"
        ax.stairs(hw, edges, color="C3", lw=1.3, ls="--", label=tag)
    if z_true is not None:
        ax.axvline(float(z_true), color="0.25", lw=1.2, ls="-.",
                   label=f"{param} = {float(z_true):g}")
    ax.set_xlim(centers[hist > 0].min() - 0.05 * np.ptp(z) - 1e-9,
                centers[hist > 0].max() + 0.05 * np.ptp(z) + 1e-9)
    ax.set_xlabel(str(param))
    ax.set_ylabel("posterior density")
    ax.legend(fontsize=7, frameon=False)
    return _finish(fig, savefig)


# Parameter-name sanity: every label key is a real parameter.
assert all(k in PARAM_NAMES for k in _LABELS)
