"""The comparison that decides `correct`: what the timed path returned,
judged by the plain reference (reference/, float64 on the device given).

For every kept request (a reservoir sample of the window's requests,
drawn from the seed) and every checked source of it, the numbers are:

- lnp_gap: the largest gap between the lnprob the kernel recorded beside
  a stored sample and the reference's lnprob at that sample, over every
  stored sample, as a share of max(1, |reference|); where the
  configuration holds filter responses, the reference's band fluxes are
  its own quadrature over each curve (reference/response.py);
- summary_gap: the largest gap between a summary the port returned
  (par_cen of each parameter; the derived posteriors' *_cen) and the
  reference's percentiles of the same samples, as a share of the
  reference's 68% half-width;
- lir_gap, dustmass_gap, peaklambda_gap: the largest relative gap between
  a derived posterior sample the port returned and the reference's value
  at that chain sample and the source's redshift, over a sample of them
  drawn from the seed;
- frozen_share: the largest share of a source's walkers whose first and
  last stored positions are the same (a sampler that never moves them);
- post_gap: the largest gap between a parameter's summary the port
  returned (median, +err, -err of par_cen) and the same percentiles of the
  posterior itself, as a share of the posterior's 68% half-width, over
  the parameters that the model depends on. The
  posterior is reference/posterior.py's importance sampling of the
  reference density for the source's photometry, box and priors: it
  reads nothing of the port's chain, so it judges the sampler's
  transition, which the numbers above take as given. Only where the
  traffic mix's check names the importance sampler's sizes ("posterior"):
  a mix whose chains are too short to reach the posterior has none.

A derived quantity that the traffic mix names and a kept item lacks reads
infinite, so a path that leaves the derived layer out fails.

The control (mode "bf16") puts the reference, computed in bfloat16, in
the port's place: its lnprob, its percentiles of the bfloat16 samples and
its derived quantities, at the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import mockdata
from portbench.reference import model as ref
from portbench.reference import posterior
from portbench.reference.response import pack_of

ROWS = 1 << 18


def _shape(cfg):
    m = cfg["model"]
    return ref.Shape(opthin=m["opthin"], noalpha=m["noalpha"],
                     wavenorm=m["wavenorm"])


def _prior_arrays(cfg):
    mean = np.zeros(5)
    sigma = np.full(5, np.inf)
    for name, m, s in cfg["priors"]:
        i = cfg["params"].index(name)
        mean[i], sigma[i] = m, s
    return mean, sigma


def _blocks(fn, theta, dtype, device):
    out = []
    for i in range(0, theta.shape[0], ROWS):
        t = torch.as_tensor(theta[i:i + ROWS], dtype=torch.float64)
        out.append(fn(t.to(device=device, dtype=dtype)).double().cpu())
    return torch.cat(out).numpy()


def _rel(got, want, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.maximum(np.abs(want), floor)
    gap = np.abs(got - want) / den
    bad = ~np.isfinite(gap)
    return float(np.inf if bad.any() else gap.max(initial=0.0))


def _start(cfg, mean, sigma):
    """The first importance proposal: the configuration's true parameters,
    with a prior's width where one is set, else a fifth of the value."""
    true = np.asarray(cfg["true"], np.float64)
    return true, np.where(np.isfinite(sigma), sigma, 0.2 * np.abs(true))


def _posterior(cfg, traffic, seed, index, k, lnp_fn, mean, sigma,
               device):
    """The reference posterior's (median, +err, -err) of each parameter
    that the density depends on, {index in params: (3,)}, for kept item k
    of request `index`, fp64 on `device`. A parameter that the model
    leaves out (lambda0 of optically thin dust, alpha without the Wien
    power law) is held at its true value: its posterior would be the flat
    box, which no fit samples."""
    pc = traffic["check"]["posterior"]
    g = torch.Generator(device=device)
    g.manual_seed(int(mockdata.rng(seed, index, 4, k).integers(2 ** 62)))
    start, scale = _start(cfg, mean, sigma)
    free = ref.free_indices(_shape(cfg))
    fn = lnp_fn
    if len(free) < len(start):
        full = torch.as_tensor(start, dtype=torch.float64, device=device)

        def fn(t):
            theta = full.expand(t.shape[0], -1).clone()
            theta[:, free] = t
            return lnp_fn(theta)
        start, scale = start[free], scale[free]
    cen, _ = posterior.posterior_summary(
        fn, start, scale, g, rounds=int(pc["rounds"]),
        n_round=int(pc["round_samples"]), n_final=int(pc["samples"]),
        block=min(int(pc["samples"]), ROWS))
    return dict(zip(free, cen))


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float64)).bfloat16().double()\
        .numpy()


def judge(kept, cfg, traffic, seed, mode="port", device="cpu"):
    """{number: value} over the kept items [(index, [source dicts])]."""
    shape = _shape(cfg)
    free = ref.free_indices(shape)
    mean, sigma = _prior_arrays(cfg)
    cosmo = cfg["cosmology"]
    wave = np.asarray(cfg["wave"], np.float64)
    pack = pack_of(cfg)
    low = torch.bfloat16
    numbers = {"lnp_gap": 0.0, "summary_gap": 0.0, "frozen_share": 0.0}
    checks_posterior = "posterior" in traffic["check"]
    if checks_posterior:
        numbers["post_gap"] = 0.0
    for q in traffic["derived"]:
        numbers[f"{q}_gap"] = 0.0
    for index, items in kept:
        for k, it in enumerate(items):
            chain = np.asarray(it["chain"], np.float64)   # (nrec, nw, 5)
            theta = chain.reshape(-1, 5)

            def lnp_fn(t, it=it):
                return ref.lnprob(t, wave, it["flux"], it["unc"],
                                  cfg["lower"], cfg["upper"], mean, sigma,
                                  shape, pack)
            want = _blocks(lnp_fn, theta, torch.float64, device)
            got = (np.asarray(it["lnp"], np.float64).reshape(-1)
                   if mode == "port" else _blocks(lnp_fn, theta, low, device))
            numbers["lnp_gap"] = max(numbers["lnp_gap"],
                                     _rel(got, want, 1.0))

            first, last = chain[0], chain[-1]
            frozen = float(np.mean(np.all(first == last, axis=-1)))
            numbers["frozen_share"] = max(numbers["frozen_share"], frozen)

            post = (_posterior(cfg, traffic, seed, index, k, lnp_fn, mean,
                               sigma, device)
                    if checks_posterior else None)
            for i, p in enumerate(cfg["params"]):
                if p not in it["cen"]:
                    # a catalog summarises only the parameters it fits
                    if i in free:
                        numbers["summary_gap"] = math.inf
                        if checks_posterior:
                            numbers["post_gap"] = math.inf
                    continue
                got_cen = it["cen"][p]
                col = theta[:, i]
                want_cen = ref.percentile_summary(col)
                if mode != "port":
                    got_cen = _bf16(ref.percentile_summary(_bf16(col)))
                numbers["summary_gap"] = max(
                    numbers["summary_gap"], _summary_gap(got_cen, want_cen))
                if checks_posterior and i in post:
                    numbers["post_gap"] = max(
                        numbers["post_gap"], _summary_gap(got_cen, post[i]))
            for q in traffic["derived"]:
                if q not in it["derived"] or q not in it["derived_cen"]:
                    numbers[f"{q}_gap"] = math.inf
            for q, got_cen in it["derived_cen"].items():
                chain_q = np.asarray(it["derived"][q], np.float64)
                want_cen = ref.percentile_summary(chain_q)
                if mode != "port":
                    got_cen = _bf16(ref.percentile_summary(_bf16(chain_q)))
                numbers["summary_gap"] = max(
                    numbers["summary_gap"], _summary_gap(got_cen, want_cen))

            if it["derived"]:
                n = theta.shape[0]
                m = min(int(traffic["check"]["derived_samples"]), n)
                pick = np.sort(mockdata.rng(seed, index, 2, k).choice(
                    n, m, replace=False))
                th = theta[pick]
                for q, vals in it["derived"].items():
                    want_q = _derived(q, th, it["z"], shape, cosmo,
                                      torch.float64, "cpu")
                    got_q = (np.asarray(vals, np.float64)[pick]
                             if mode == "port" else
                             _derived(q, th, it["z"], shape, cosmo, low,
                                      device))
                    numbers[f"{q}_gap"] = max(numbers[f"{q}_gap"],
                                              _rel(got_q, want_q))
    return numbers


def _summary_gap(got, want):
    got = np.asarray(got, np.float64)
    half = 0.5 * (want[1] + want[2])
    den = half if half > 0 else max(abs(want[0]), 1.0) * 1e-12
    gap = np.abs(got - want) / den
    return float(gap.max()) if np.all(np.isfinite(gap)) else math.inf


def _derived(q, theta, z, shape, cosmo, dtype, device):
    t = torch.as_tensor(theta, dtype=torch.float64).to(device=device,
                                                       dtype=dtype)
    zz = np.full(theta.shape[0], float(z))
    if q == "lir":
        return ref.lir_lsun(t, zz, shape, cosmo["H0"], cosmo["Om0"])
    if q == "dustmass":
        return ref.dustmass_msun(t, zz, shape, cosmo["H0"], cosmo["Om0"])
    if q == "peaklambda":
        return ref.peak_lambda_um(t, shape)
    raise ValueError(f"no reference for the derived quantity {q!r}")
