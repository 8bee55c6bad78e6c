"""mbb_emcee_tpu_torch: modified-blackbody SED fitting in PyTorch, with the
hot path as hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of mbb_emcee_tpu (JAX + Pallas), which stays beside it as the
reference. The single-fit main path:

  * greybody SED model, batched over parameter vectors (models/)
  * Gaussian likelihood with covariance, box limits, Gaussian priors, fixed
    parameters and photometric upper limits (likelihood.py); on a CUDA
    device one lnprob kernel launch per batch (ops/lnprob_kernel.py,
    csrc/lnprob.cu)
  * the affine-invariant stretch-move sampler; on a CUDA device each
    sampling phase is one kernel launch (ops/sampler_kernel.py,
    csrc/sampler.cu); on the CPU the plain torch sampler (sampler.py)
  * the MBBFitter burn -> re-center -> re-burn -> production protocol
  * instrument-response mode: band-integrated fluxes over filter curves
    (response.py, instruments.py), packed into the kernels' band sums
  * derived posteriors (L_IR, dust mass, peak wavelength) and HDF5 files
    readable by either package (results.py, hdf5io.py)
  * checkpoint / resume of the production run and extend() of a finished
    one, bitwise the uninterrupted chain (checkpoint.py)

and the batch tier that serves a catalog: MultiFitter (multifit.py,
batchengine.py, catalog.py, the run_mbb_emcee_tpu_torch_batch CLI) and
MBBFitter(n_ensembles > 1), on a CUDA device one launch of the
multi-source stretch-move kernel per sampling phase
(ops/multifit_kernel.py, csrc/multifit.cu).

Triage and model checking: MAP + Laplace fits (MBBFitter.fit_map,
MultiFitter.run_map; mapfit.py) with Laplace importance sampling and
MAP-seeded walker balls (run(init="map")), posterior-predictive checks,
WAIC / PSIS-LOO and exact leave-one-band-out refits (modelcheck.py), and
prior reweighting of a finished chain (reweight.py).

The inference tiers beside the stretch move: Hamiltonian MC (hmc.py;
MBBFitter.run_hmc, MultiFitter.run_hmc) with torch.autograd forces, and
parallel tempering with stepping-stone evidence (tempering.py;
MBBFitter.run_pt on the lnprob kernel, MultiFitter.run_pt), whose batch
runs checkpoint through checkpoint.save_tier_checkpoint. Nested sampling
(nested.py; MBBFitter.compute_evidence on the lnprob kernel,
MultiFitter.compute_evidence per source) gives each model variant's
evidence for Bayes factors.

The population tier (hierarchy.py): HierarchicalFitter infers a catalog's
population distribution of T, beta, ... by reweighting the batch's stored
chains, with a survey selection function, its own evidence and HDF5 files.

The generic-model tier (sed.py): any SED written as a single-theta torch
function fnu(theta, wave), batched with torch.func.vmap, runs through the
same likelihood and every sampler tier (SEDModel, SEDFitter, SEDResults;
the plain torch sampler on the fitter's device), among them the
CMB-corrected greybody of models/cmb.py; forecast.py gives Fisher
forecasts of a proposed observation from the same model code.

The kernels are built with nvcc at first use (ops/build.py). Importing the
package imports neither jax nor mbb_emcee_tpu, and h5py only when a file is
read or written.
"""

from mbb_emcee_tpu_torch.constants import PARAM_NAMES, NPARAMS
from mbb_emcee_tpu_torch.models.modified_blackbody import (
    MBBShape, ModifiedBlackbody, log_mbb_fnu, mbb_fnu)
from mbb_emcee_tpu_torch.models.cosmology import (
    Cosmology, luminosity_distance)
from mbb_emcee_tpu_torch.likelihood import (
    LikelihoodSpec, Photometry, build_lnprob)
from mbb_emcee_tpu_torch.sampler import EnsembleSampler, SamplerState
from mbb_emcee_tpu_torch.ops.build import build_kernels
from mbb_emcee_tpu_torch.ops.sampler_kernel import FusedSampler
from mbb_emcee_tpu_torch.fitter import MBBFitter
from mbb_emcee_tpu_torch.results import MBBResults, PPCResult
from mbb_emcee_tpu_torch.ops.multifit_kernel import FusedMultiSampler
from mbb_emcee_tpu_torch.multifit import MultiFitter, PPCBatchResult
from mbb_emcee_tpu_torch.response import Response, ResponseSet
from mbb_emcee_tpu_torch.mapfit import MAPResult
from mbb_emcee_tpu_torch.hmc import hmc_sample, HMCResult
from mbb_emcee_tpu_torch.tempering import (
    pt_sample, PTResult, ParallelTemperingSampler, geometric_ladder)
from mbb_emcee_tpu_torch.modelcheck import (
    LooResult, LooBatchResult, LooComparison, compare_loo)
from mbb_emcee_tpu_torch.reweight import (
    reweight_prior, reweight_prior_batch, ReweightResult,
    ReweightBatchResult)
from mbb_emcee_tpu_torch.nested import (
    nested_sample, nested_sample_batch, NestedResult, NestedBatchResult)
from mbb_emcee_tpu_torch.hierarchy import (
    TruncatedGaussianPopulation, CorrelatedGaussianPopulation, Selection,
    HierarchicalFitter, fit_population)
from mbb_emcee_tpu_torch.sed import (
    SEDModel, SEDFitter, SEDResults, build_sed_lnprob)
from mbb_emcee_tpu_torch.models.cmb import cmb_corrected_mbb
from mbb_emcee_tpu_torch.forecast import (
    forecast, forecast_mbb, ForecastResult)

__version__ = "0.1.0"

__all__ = [
    "PARAM_NAMES", "NPARAMS",
    "MBBShape", "ModifiedBlackbody", "log_mbb_fnu", "mbb_fnu",
    "Cosmology", "luminosity_distance",
    "LikelihoodSpec", "Photometry", "build_lnprob",
    "EnsembleSampler", "SamplerState", "FusedSampler", "build_kernels",
    "MBBFitter", "MBBResults", "FusedMultiSampler", "MultiFitter",
    "Response", "ResponseSet", "MAPResult", "PPCResult", "PPCBatchResult",
    "hmc_sample", "HMCResult", "pt_sample", "PTResult",
    "ParallelTemperingSampler", "geometric_ladder",
    "LooResult", "LooBatchResult", "LooComparison", "compare_loo",
    "reweight_prior", "reweight_prior_batch", "ReweightResult",
    "ReweightBatchResult", "nested_sample", "nested_sample_batch",
    "NestedResult", "NestedBatchResult", "TruncatedGaussianPopulation",
    "CorrelatedGaussianPopulation", "Selection", "HierarchicalFitter",
    "fit_population", "SEDModel", "SEDFitter", "SEDResults",
    "build_sed_lnprob", "cmb_corrected_mbb", "forecast", "forecast_mbb",
    "ForecastResult", "__version__",
]
