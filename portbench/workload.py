"""One cell's requests against the port: the general generator and driver
that every configuration and traffic mix is read into.

A request is new photometry from (seed, request index) (mockdata.py),
handed to the port's public entry points as a user calls them, with its
outputs read back to the host: for a single fit MBBFitter.run, then
MBBResults' par_cen of every parameter and the acceptance fraction; for a
catalog MultiFitter.run, par_cen of every free parameter. Either then
computes the derived posteriors that the traffic mix names, and their
summaries. A configuration that holds filter responses fits in response
mode: the port's built-in curves of its bands (ResponseSet.builtin, as
--builtin-responses builds them) and the band names in set_data. The
harness's spans wrap the calls into each layer.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import mockdata

# The launch counters of the port's kernels and plain samplers that a
# request's path is judged by: (module, function, attribute).
COUNTERS = {
    "k1": ("mbb_emcee_tpu_torch.ops.lnprob_kernel", "mbb_lnprob",
           "launches"),
    "k2": ("mbb_emcee_tpu_torch.ops.sampler_kernel", "mbb_stretch_run",
           "launches"),
    "k3": ("mbb_emcee_tpu_torch.ops.multifit_kernel",
           "mbb_multi_stretch_run", "launches"),
    "plain": ("mbb_emcee_tpu_torch.sampler", "stretch_run_plain", "runs"),
    "plain_multi": ("mbb_emcee_tpu_torch.sampler", "multi_stretch_run_plain",
                    "runs"),
    "graphed": ("mbb_emcee_tpu_torch.sampler", "stretch_run_graphed",
                "runs"),
    "graphed_multi": ("mbb_emcee_tpu_torch.sampler",
                      "multi_stretch_run_graphed", "runs"),
}


def read_counters():
    import importlib
    out = {}
    for key, (mod, fn, attr) in COUNTERS.items():
        out[key] = int(getattr(getattr(importlib.import_module(mod), fn),
                               attr, 0))
    return out


def left_kernels(fitter, launches):
    """Why a request's launches show that it left the kernels, or None: a
    single fit needs K2, a catalog K3, and neither may run a plain
    sampler."""
    need = "k2" if fitter == "single" else "k3"
    plain = sum(launches[k] for k in ("plain", "plain_multi", "graphed",
                                      "graphed_multi"))
    if launches[need] < 1:
        return f"no {need.upper()} launch"
    if plain:
        return f"{plain} plain sampler runs"
    return None


class Spans:
    """The harness's spans of one request: host-clock intervals, closed
    after a device synchronisation when `sync` (the traced run), and
    mirrored as profiler annotations when `annotate`."""

    def __init__(self, sync, annotate):
        self.sync = sync
        self.annotate = annotate
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        rf = (torch.profiler.record_function(f"portbench.{name}")
              if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
            if self.sync:
                torch.cuda.synchronize()
        self.spans.append((name, t0, time.perf_counter()))


class Workload:
    """The port driven by one configuration and traffic mix."""

    def __init__(self, cfg, traffic, device="cuda"):
        self.cfg = cfg
        self.traffic = traffic
        self.device = device
        self.fitter = cfg["fitter"]
        if self.fitter not in ("single", "catalog"):
            raise ValueError(f"unknown fitter {self.fitter!r}")
        self._true_flux = mockdata.true_flux(cfg)
        self._responses = None
        if "responses" in cfg:
            from mbb_emcee_tpu_torch.response import ResponseSet
            self._responses = ResponseSet.builtin(
                cfg["bands"], nnodes=int(cfg["responses"]["nnodes"]))

    @property
    def steps_per_walker(self):
        """Ensemble steps of one request: burn, re-burn and production."""
        t = self.traffic
        return 2 * int(t["nburn"]) + int(t["nsteps"])

    @property
    def walker_steps(self):
        return (self.steps_per_walker * int(self.cfg["nwalkers"])
                * int(self.cfg["nsources"]))

    def _constrain(self, fit):
        cfg = self.cfg
        for name, lo, hi in zip(cfg["params"], cfg["lower"], cfg["upper"]):
            fit.set_lowlim(name, lo)
            fit.set_uplim(name, hi)
        for name, mean, sigma in cfg["priors"]:
            fit.set_gaussian_prior(name, mean, sigma)

    def run(self, seed, index, span):
        """Run request `index` through the port. Returns (acceptance
        fraction's mean, extract): extract(seed, index) reads back what the
        check compares (chains, lnprob, summaries, derived posteriors of
        the checked sources), and is called only for a kept request."""
        flux, unc, z, fit_seed = mockdata.request_data(
            self.cfg, self.traffic, seed, index, self._true_flux)
        if self.fitter == "single":
            return self._single(flux[0], unc[0], float(z[0]), fit_seed,
                                span)
        return self._catalog(flux, unc, z, fit_seed, span)

    def _model_kw(self):
        m = self.cfg["model"]
        kw = dict(nwalkers=int(self.cfg["nwalkers"]),
                  wavenorm=float(m["wavenorm"]), noalpha=bool(m["noalpha"]),
                  opthin=bool(m["opthin"]))
        if self._responses is not None:
            kw["responses"] = self._responses
        return kw

    def _data_kw(self):
        """set_data's band names, which response mode needs."""
        if self._responses is None:
            return {}
        return dict(band_names=list(self.cfg["bands"]))

    def _single(self, flux, unc, z, fit_seed, span):
        from mbb_emcee_tpu_torch import MBBFitter, MBBResults
        t = self.traffic
        fit = MBBFitter(seed=fit_seed, device=self.device, **self._model_kw())
        fit.set_data(np.asarray(self.cfg["wave"]), flux, unc,
                     **self._data_kw())
        self._constrain(fit)
        with span("run"):
            fit.run(nburn=int(t["nburn"]), nsteps=int(t["nsteps"]),
                    thin=int(t["thin"]))
        with span("summary"):
            res = MBBResults(fit, redshift=z,
                             cosmology=self.cfg["cosmology"]["name"])
            cen = {p: res.par_cen(p) for p in self.cfg["params"]}
            acc = float(np.mean(res.acceptance_fraction))
        derived, derived_cen = {}, {}
        if t["derived"]:
            with span("derived"):
                for q in t["derived"]:
                    derived[q] = getattr(res, f"compute_{q}")()
                    derived_cen[q] = getattr(res, f"{q}_cen")()

        def extract(seed, index):
            # MBBResults holds the chain (nwalkers, nrec, 5) and the lnprob
            # (nwalkers, nrec) on the host already; its derived chains run
            # over walkers first, the check's over records
            nw, nrec = res.chain.shape[:2]
            return [dict(chain=np.transpose(res.chain, (1, 0, 2)),
                         lnp=np.transpose(res.lnprobability, (1, 0)),
                         cen=cen, flux=flux, unc=unc, z=z,
                         derived={q: np.asarray(v).reshape(nw, nrec).T
                                  .reshape(-1) for q, v in derived.items()},
                         derived_cen=derived_cen)]
        return acc, extract

    def _catalog(self, flux, unc, z, fit_seed, span):
        from mbb_emcee_tpu_torch import MultiFitter
        t = self.traffic
        mf = MultiFitter(seed=fit_seed, device=self.device,
                         **self._model_kw())
        mf.set_data(np.asarray(self.cfg["wave"]), flux, unc, redshifts=z,
                    **self._data_kw())
        self._constrain(mf)
        with span("run"):
            mf.run(nburn=int(t["nburn"]), nsteps=int(t["nsteps"]),
                   thin=int(t["thin"]))
        with span("summary"):
            cen = {p: mf.par_cen(p) for p in mf.free_param_names}
            acc = float(np.mean(mf.acceptance_fraction))
        derived, derived_cen = {}, {}
        if t["derived"]:
            with span("derived"):
                for q in t["derived"]:
                    derived[q] = getattr(mf, f"compute_{q}")()
                    derived_cen[q] = getattr(mf, f"{q}_cen")()

        def extract(seed, index):
            src = self.check_sources(seed, index)
            chain = [mf.chain_free[s].double().cpu().numpy() for s in src]
            lnp = [mf.lnprobability[s].double().cpu().numpy() for s in src]
            return [dict(chain=mf.free_space.expand(chain[k]), lnp=lnp[k],
                         cen={p: cen[p][s] for p in cen}, flux=flux[s],
                         unc=unc[s], z=float(z[s]),
                         derived={q: derived[q][s] for q in derived},
                         derived_cen={q: derived_cen[q][s] for q in derived})
                    for k, s in enumerate(src)]
        return acc, extract

    def check_sources(self, seed, index):
        """The sources of a kept catalog request that the check compares,
        drawn from (seed, index): the configured number, one of them with
        a missing band when the catalog has such sources."""
        S = int(self.cfg["nsources"])
        k = min(int(self.traffic["check"]["sources"]), S)
        g = mockdata.rng(seed, index, 1)
        every = int(self.cfg.get("missing_every", 0))
        first = []
        if every:
            missing = np.arange(1, S, every)
            first = [int(g.choice(missing))]
        rest = g.permutation(np.setdiff1d(np.arange(S), first))[:k - len(first)]
        return sorted(first + [int(s) for s in rest])
