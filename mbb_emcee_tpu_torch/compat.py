"""Drop-in aliases for the upstream `mbb_emcee` API surface.

Torch twin of mbb_emcee_tpu/compat.py. Upstream code written against
`aconley/mbb_emcee` (ref: mbb_emcee/mbb_fit.py class mbb_fitter,
mbb_emcee/mbb_results.py class mbb_results,
mbb_emcee/modified_blackbody.py, mbb_emcee/response.py -- reconstructed,
SURVEY.md provenance note) can switch by changing one import:

    from mbb_emcee import mbb_fitter, mbb_results                  # upstream
    from mbb_emcee_tpu_torch.compat import mbb_fitter, mbb_results  # here

    fit = mbb_fitter(nwalkers=250, photfile="phot.txt", redshift=2.5)
    fit.set_gaussian_prior("beta", 1.9, 0.3)
    fit.run(500, 1000)
    res = mbb_results(fit=fit)
    res.compute_lir(); res.lir_cen()
    res.writeToHDF5("fit.h5")

Everything below is a thin rename/kw-translation layer over the native
classes (MBBFitter / MBBResults / ModifiedBlackbody / Response /
ResponseSet) -- no behavior of its own. Like them it runs on the card
unless `device="cpu"` is named. Known behavioral differences from upstream
(fp32 device compute, reduced-space fixed parameters, a different PRNG
stream, reflecting walker init) are documented in MIGRATION.md
"Behavioral differences".
"""

from __future__ import annotations

from mbb_emcee_tpu_torch.fitter import MBBFitter
from mbb_emcee_tpu_torch.results import MBBResults
from mbb_emcee_tpu_torch.models.modified_blackbody import ModifiedBlackbody
from mbb_emcee_tpu_torch.response import Response, ResponseSet

__all__ = ["mbb_fitter", "mbb_results", "modified_blackbody",
           "response", "response_set"]


class mbb_fitter(MBBFitter):
    """Upstream-named fitter (ref: mbb_emcee/mbb_fit.py class mbb_fitter
    [reconstructed]) with the upstream POSITIONAL order -- nthreads sits
    in the 8th slot, before redshift, so upstream positional calls like
    mbb_fitter(250, "phot.txt", None, 0, 500.0, False, False, 4) bind 4
    to nthreads (accepted and ignored: walker parallelism is one kernel
    launch on the device), never to redshift. All upstream methods exist
    under their upstream names (read_data, set_data, set_uplim/set_lowlim,
    set_gaussian_prior, fix_param, run(nburn, nsteps), __call__). The
    native keywords (device=, seed=, ...) pass through **kwargs."""

    def __init__(self, nwalkers=250, photfile=None, covfile=None,
                 covextn=0, wavenorm=500.0, noalpha=False, opthin=False,
                 nthreads=1, redshift=None, **kwargs):
        super().__init__(nwalkers, photfile, covfile, covextn, wavenorm,
                         noalpha, opthin, nthreads=nthreads,
                         redshift=redshift, **kwargs)

    def like(self, params):
        """Upstream alias: lnprob at a full parameter vector."""
        return self(params)


class mbb_results(MBBResults):
    """Upstream-named results (ref: mbb_emcee/mbb_results.py class
    mbb_results [reconstructed]); translates the upstream `cosmo_type=`
    keyword to `cosmology=`. par_cen/par_uplim/par_lowlim, compute_lir /
    lir_cen, compute_dustmass / dustmass_cen, compute_peaklambda /
    peaklambda_cen, best_fit and writeToHDF5 all keep their upstream
    names and conventions. `device` is MBBResults' (None: the fit's
    device, or the card for a file)."""

    def __init__(self, fit=None, h5file=None, redshift=None,
                 lumdist=None, cosmo_type=None, cosmology=None,
                 device=None):
        if cosmo_type is not None and cosmology is not None:
            raise ValueError("give cosmo_type= or cosmology=, not both")
        super().__init__(fit=fit, h5file=h5file, redshift=redshift,
                         lumdist=lumdist,
                         cosmology=cosmology if cosmology is not None
                         else cosmo_type, device=device)


# The physics / instrument classes already carry the upstream call
# surfaces; only the names differ.
modified_blackbody = ModifiedBlackbody
response = Response
response_set = ResponseSet
