"""K1: the batched lnprob as a hand-written CUDA kernel, and its wrapper.

Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_lnprob.py::_make_kernel
(:248; body _make_lnp_compute :136-245), which build_pallas_lnprob (:338)
launches. The CUDA source is csrc/lnprob.cu with the per-walker body in
csrc/lnprob.cuh, which the stretch-move kernel (csrc/sampler.cu) shares.
What bounds it and how it is laid out is noted in csrc/lnprob.cuh.

The plain PyTorch version of this kernel is likelihood.build_lnprob's
batched function; `prepare_lnprob_inputs` builds it beside the packed kernel
operands. `mbb_lnprob` runs the plain version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises; `mbb_lnprob.launches`
counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from mbb_emcee_tpu_torch.constants import NPARAMS
from mbb_emcee_tpu_torch.likelihood import FreeSpace, build_lnprob
from mbb_emcee_tpu_torch.models.modified_blackbody import LOG_C2
from mbb_emcee_tpu_torch.ops.build import build_kernels


@dataclasses.dataclass(frozen=True)
class LnprobOperands:
    """Everything both kernels need for one likelihood, on one device:
    the packed constant buffer (layout in csrc/lnprob.cuh), the runtime
    configuration as host int32/fp32 arrays, and the plain version."""
    consts: torch.Tensor
    icfg: np.ndarray
    fcfg: np.ndarray
    free_space: FreeSpace
    plain: Callable

    @property
    def nfree(self):
        return self.free_space.nfree

    @property
    def device(self):
        return self.consts.device


def lnprob_smem_bytes(nb, nnodes):
    """Shared memory one block of the lnprob kernel takes for a likelihood
    of nb bands x nnodes nodes, as csrc/lnprob.cu computes it (builds the
    kernels)."""
    return int(build_kernels().mbb_lnprob_smem_bytes(nb, nnodes))


@functools.lru_cache(maxsize=None)
def smem_optin_bytes(index):
    """The opt-in maximum of shared memory per block of CUDA device `index`
    (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    limit = build_kernels().mbb_smem_optin(index)
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of CUDA "
                           f"device {index}")
    return limit


def check_smem(nbytes, device, what):
    """Raise ValueError when a block of `nbytes` of shared memory does not
    fit the card: the kernels size their shared memory at launch and have
    no other cap."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    limit = smem_optin_bytes(index)
    if nbytes > limit:
        raise ValueError(
            f"{what} needs {nbytes} bytes of shared memory per block; the "
            f"card's opt-in maximum per block "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin) is {limit} bytes")


def response_nodes(wave, response_pack=None, device="cpu"):
    """The (nbands, nnodes) fp64 wavelength nodes and weights the kernels
    sum over: the response pack, or one unit-weight node per band at the
    data wavelength. On a CUDA device a pack the lnprob kernel's block
    cannot hold is refused; on the CPU the plain version takes any size."""
    nb = len(wave)
    if response_pack is not None:
        waves = np.asarray(response_pack[0], np.float64)
        weights = np.asarray(response_pack[1], np.float64)
        if waves.shape != weights.shape or waves.ndim != 2 \
                or waves.shape[0] != nb:
            raise ValueError("response pack must be two (nbands, nnodes) "
                             "arrays")
    else:
        waves = np.asarray(wave, np.float64)[:, None]
        weights = np.ones((nb, 1))
    if torch.device(device).type == "cuda":
        check_smem(lnprob_smem_bytes(nb, waves.shape[1]), device,
                   f"a {nb} x {waves.shape[1]} response pack")
    return waves, weights


def pack_constants(shape, spec, free_space, flux, whiten, nodes, use_chol,
                   device):
    """(consts, icfg, fcfg): the packed constant buffer on `device` (layout
    in csrc/lnprob.cuh) and the host configuration arrays, for fluxes
    `flux` (nb,), whitening `whiten` (nb, nb), `nodes` = (waves, weights)
    from response_nodes and the upper-limit flags of spec.uplim_bands."""
    waves, weights = nodes
    nb, nnodes = waves.shape
    # Fixed parameters get a finite window centered on their value: the
    # kernel uses the same limits for the in-box check and the clip, so
    # they must contain the value (fix_param('alpha', 0.0) with the
    # default lower bound of 0.01).
    fv = np.asarray(spec.fixed_values, np.float64)
    lower = np.where(spec.fixed, fv - 1.0, spec.lower)
    upper = np.where(spec.fixed, fv + 1.0, spec.upper)
    uplim = np.zeros(nb)
    if spec.uplim_bands is not None:
        uplim[np.asarray(spec.uplim_bands, bool)] = 1.0
    packed = np.concatenate([
        lower, upper, spec.prior_mean, spec.prior_isigma,
        flux, np.ravel(whiten), waves.ravel(), weights.ravel(), uplim])
    consts = torch.as_tensor(packed.astype(np.float32), device=device)

    free_idx = np.zeros(NPARAMS, np.int64)
    free_idx[:free_space.nfree] = free_space.free_idx
    icfg = np.array([int(shape.opthin), int(shape.noalpha), int(use_chol),
                     nb, nnodes, free_space.nfree, *free_idx], np.int32)
    fcfg = np.array([*free_space.template, LOG_C2,
                     LOG_C2 - math.log(shape.wavenorm)], np.float32)
    return consts, icfg, fcfg


def prepare_lnprob_inputs(phot, shape, spec, response_pack=None,
                          device="cpu") -> LnprobOperands:
    """Pack a likelihood (photometry, model shape, spec, optional
    (waves, weights) response pack of shape (nbands, nnodes)) into kernel
    operands on `device`, with the plain version built beside them."""
    plain, free_space = build_lnprob(phot, shape, spec,
                                     response_pack=response_pack,
                                     device=device)
    nodes = response_nodes(phot.wave, response_pack, device)
    use_chol = phot.cov is not None
    whiten = (np.linalg.inv(np.linalg.cholesky(phot.cov)) if use_chol
              else np.diag(1.0 / phot.unc))
    consts, icfg, fcfg = pack_constants(shape, spec, free_space, phot.flux,
                                        whiten, nodes, use_chol, device)
    return LnprobOperands(consts=consts, icfg=icfg, fcfg=fcfg,
                          free_space=free_space, plain=plain)


def current_stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def mbb_lnprob(theta_free, ops: LnprobOperands):
    """Batched lnprob (n, nfree) -> (n,) of the likelihood in `ops`:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if theta_free.device != ops.device:
        raise ValueError(f"theta on {theta_free.device}, likelihood "
                         f"operands on {ops.device}")
    if theta_free.device.type == "cpu":
        return ops.plain(theta_free)
    if theta_free.device.type != "cuda":
        raise ValueError(f"unsupported device {theta_free.device}")
    if theta_free.dtype != torch.float32 or theta_free.dim() != 2 \
            or theta_free.shape[1] != ops.nfree \
            or not theta_free.is_contiguous():
        raise ValueError(
            f"theta must be a contiguous float32 (n, {ops.nfree}) tensor; "
            f"got {theta_free.dtype} {tuple(theta_free.shape)}")
    lib = build_kernels()
    n = theta_free.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=theta_free.device)
    with torch.cuda.device(theta_free.device):
        rc = lib.mbb_lnprob_launch(
            theta_free.data_ptr(), ops.consts.data_ptr(), out.data_ptr(), n,
            ops.icfg.ctypes.data, ops.fcfg.ctypes.data,
            current_stream_handle(theta_free.device))
    if rc != 0:
        raise RuntimeError(f"mbb_lnprob kernel launch failed: CUDA error "
                           f"{rc}")
    mbb_lnprob.launches += 1
    return out


mbb_lnprob.launches = 0
