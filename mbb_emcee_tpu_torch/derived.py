"""Derived-quantity evaluators: L_IR, dust mass, SED peak, SED band.

Torch twin of mbb_emcee_tpu/derived.py. Each evaluator takes a (n, 5)
fp32 tensor of chain samples, or (S, n, 5) with per-source operands, and
computes one batched pass on the samples' device (chunked, so a long chain
never materializes more than a chunk of (samples x nodes) intermediates);
the large cosmological prefactors (4 pi D_L^2 ~ 1e53 m^2) stay fp64 on the
host. The single fit (results.py) and the batch tier (multifit.py,
batchengine.py) share these formulas, `_chunked_samples` and
`_percentile_summary`; the derived kernel (ops/derived_kernel.py) is the
formulas' CUDA twin.
"""

from __future__ import annotations

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import (
    HCOK_UM_K, C_UM_HZ, MPC_M, LSUN_W, MSUN_KG, MJY_WM2HZ, H_JS)
from mbb_emcee_tpu_torch.models.modified_blackbody import (
    log_mbb_fnu, log_mbb_fnu_params)
from mbb_emcee_tpu_torch.ops.quadrature import loglam_nodes
from mbb_emcee_tpu_torch.ops.rootfind import golden_max
from mbb_emcee_tpu_torch.utils.profiling import count, span

LIR_NODES = 128
# Observed-um search window + fixed iteration count for the SED peak.
PEAK_RANGE = (1.0, 5.0e4)
PEAK_ITERS = 64
# expm1 argument clamp in the dust-mass Planck factor (fp32 overflow guard).
DUST_X_CLAMP = 80.0
# Samples per evaluation pass.
CHUNK = 1 << 16

_C_MS = 2.99792458e8


def batched(fn, samples, chunk=CHUNK):
    """fn over `samples` in row chunks, concatenated along dim 0."""
    out = []
    for k, i in enumerate(range(0, samples.shape[0], chunk)):
        part = samples[i:i + chunk]
        with span("mbb.derived.chunk", index=k, samples=int(part.shape[0])):
            out.append(fn(part))
    return torch.cat(out, dim=0)


def _chunked_samples(fn, samples, inner_elems):
    """fn over (S, N, npar) samples in sample-axis chunks (about 64M
    elements of intermediates each, `inner_elems` = per-sample fan-out
    such as quadrature nodes), as (S, N, ...) host fp64."""
    S, N = samples.shape[:2]
    chunk = max(1, (64 << 20) // max(S * inner_elems, 1))
    out = []
    for k, i in enumerate(range(0, N, chunk)):
        part = samples[:, i:i + chunk]
        with span("mbb.derived.chunk", index=k, samples=int(part.shape[1])):
            out.append(fn(part).double().cpu().numpy())
            count("d2h_bytes", out[-1].nbytes)
    return np.concatenate(out, axis=1)


def lir_nodes_weights(opz, wavemin, wavemax, n=LIR_NODES):
    """Quadrature nodes/weights for the L_IR integral, host fp64: observed
    wavelengths spanning [wavemin, wavemax]*(1+z) log-spaced, weights with
    the 1/lam^2 flux -> F_nu Jacobian folded in (c goes into
    `lir_prefactor`)."""
    base_lam, base_w = loglam_nodes(n, wavemin, wavemax)
    return opz * base_lam, (1.0 / opz) * (base_w / base_lam ** 2)


def _params(theta):
    """(..., n, 5) samples -> five (..., n, 1) parameter tensors."""
    return [theta[..., i:i + 1] for i in range(5)]


def lir_integrand(shape):
    """one(theta (n, 5), lam (m,), w (m,)) -> (n,): integral of f_nu dnu in
    mJy/um units; with leading source axes, theta (S, n, 5) against each
    source's nodes lam, w (S, m) -> (S, n)."""
    def one(theta, lam, w):
        lnf = log_mbb_fnu_params(*_params(theta), lam[..., None, :], shape)
        return torch.sum(w[..., None, :] * torch.exp(lnf), dim=-1)
    return one


def lir_zparam_integrand(fnu, zi, wavemin, wavemax, n=LIR_NODES,
                         device=None):
    """one(theta (npar,)) -> 0-dim tensor: the L_IR integral of a generic
    model (sed.SEDModel's single-theta `fnu`) whose parameter `zi` is a
    SAMPLED redshift, for torch.func.vmap over the chain. The z = 0
    ln-lambda nodes scale by the sample's own (1 + z) on the device (nodes
    *= opz, weights /= opz: the lir_nodes_weights map), so no (nsamples,
    nodes) host arrays are built. The nodes live on `device` (None: the
    card; without one this raises, naming device="cpu"); pair with a
    per-sample D_L from cosmology.luminosity_distance_batch and
    `lir_prefactor`."""
    from mbb_emcee_tpu_torch.fitter import resolve_device
    device = resolve_device(device)
    base_lam, base_w = lir_nodes_weights(1.0, wavemin, wavemax, n)
    lam = torch.as_tensor(base_lam.astype(np.float32), device=device)
    w = torch.as_tensor(base_w.astype(np.float32), device=device)

    def one(theta):
        opz = 1.0 + theta[zi]
        return torch.sum(w / opz * fnu(theta, lam * opz))
    return one


def lir_prefactor(dl_mpc):
    """HOST fp64 prefactor: 4 pi D_L^2 * (mJy -> W/m^2/Hz) * c / L_sun."""
    dl_m = np.asarray(dl_mpc, np.float64) * MPC_M
    return 4.0 * np.pi * dl_m ** 2 * MJY_WM2HZ * C_UM_HZ / LSUN_W


def dustmass_integrand(shape):
    """one(theta (n, 5), lam_obs 0-dim tensor) -> (n,):
    S_obs(lam_obs)[mJy] * (e^x - 1), x = h nu_rest / (k T_rest), equal to
    the observed-frame x at lam_obs = kappa_wave*(1+z); with leading source
    axes, theta (S, n, 5) and lam_obs (S,) -> (S, n)."""
    def one(theta, lam_obs):
        s_mjy = torch.exp(log_mbb_fnu_params(
            *_params(theta), lam_obs[..., None, None], shape))[..., 0]
        x = HCOK_UM_K / (lam_obs[..., None] * theta[..., 0])
        return s_mjy * torch.expm1(torch.clamp(x, max=DUST_X_CLAMP))
    return one


def dustmass_prefactor(dl_mpc, opz, kappa, kappa_wave):
    """HOST fp64 prefactor: D_L^2 / ((1+z) kappa B_nu-amplitude) / M_sun,
    kappa in m^2/kg at REST wavelength kappa_wave um (2.64 at 125 um:
    Dunne et al. 2003)."""
    dl_m = np.asarray(dl_mpc, np.float64) * MPC_M
    nu_rest = _C_MS / (kappa_wave * 1e-6)
    planck_amp = 2.0 * H_JS * nu_rest ** 3 / _C_MS ** 2
    return (dl_m ** 2 * MJY_WM2HZ
            / (np.asarray(opz, np.float64) * kappa * planck_amp) / MSUN_KG)


def peak_finder(shape, lo=PEAK_RANGE[0], hi=PEAK_RANGE[1],
                iters=PEAK_ITERS):
    """peak(theta (..., n, 5)) -> (..., n): observed f_nu peak wavelength
    in um by fixed-iteration golden-section in ln-lambda, per sample."""
    ulo, uhi = float(np.log(lo)), float(np.log(hi))

    def peak(theta):
        p = [theta[..., i] for i in range(5)]

        def log_flux(u):
            return log_mbb_fnu_params(*p, torch.exp(u), shape)

        n = theta.shape[:-1]
        um, _ = golden_max(
            log_flux,
            torch.full(n, ulo, dtype=theta.dtype, device=theta.device),
            torch.full(n, uhi, dtype=theta.dtype, device=theta.device),
            iters=iters)
        return torch.exp(um)
    return peak


def sed_eval(shape, waves_j):
    """sed(theta (n, 5)) -> (n, nwave): f_nu in mJy at fixed observed
    wavelengths `waves_j` (fp32 tensor)."""
    def sed(theta):
        return torch.exp(log_mbb_fnu(theta, waves_j, shape))
    return sed


def band_flux_eval(shape, wave, response_pack=None):
    """fluxes(theta (n, 5)) -> (n, nbands): the model's band fluxes in mJy,
    point evaluation at the data wavelengths or band-integrated over a
    (waves, weights) response pack, as the fitted likelihood saw them."""
    def fluxes(theta):
        dev = theta.device
        if response_pack is None:
            w = torch.as_tensor(np.asarray(wave, np.float32), device=dev)
            return torch.exp(log_mbb_fnu(theta, w, shape))
        nodes, wts = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                      for a in response_pack)
        return torch.sum(wts * torch.exp(log_mbb_fnu(theta, nodes, shape)),
                         dim=-1)
    return fluxes


def _percentile_summary(samples, percentile=68.3):
    """(central, +err, -err): median and distance to the percentile bounds
    (ref: mbb_results.par_cen convention, 50 +- 34.15) of (n,) samples, or
    (S, 3) of (S, n), along the last axis."""
    p = float(percentile)
    lo, mid, hi = np.percentile(np.asarray(samples, np.float64),
                                [50.0 - p / 2, 50.0, 50.0 + p / 2], axis=-1)
    return np.stack([mid, hi - mid, mid - lo], axis=-1)


def sed_band(fluxes, percentile, sample_axis):
    """[median, upper, lower] percentiles of per-sample SEDs along
    `sample_axis`, stacked where that axis was."""
    p = float(percentile)
    lo, mid, hi = np.percentile(
        fluxes, [50.0 - p / 2, 50.0, 50.0 + p / 2], axis=sample_axis)
    return np.stack([mid, hi, lo], axis=sample_axis)
