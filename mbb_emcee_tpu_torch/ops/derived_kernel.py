"""The derived posteriors (L_IR, dust mass, peak wavelength) of the
modified blackbody as one hand-written CUDA kernel launch a quantity.

Replaces no TPU kernel (the JAX package leaves derived.py's jnp chains to
XLA's fusion): on the card the port's plain version, derived.py's
integrands and peak finder and MultiFitter's integrands, ran thousands of
small torch operations a call. The CUDA source is csrc/derived.cu (what
bounds it and how it is laid out are noted there); its per-sample formulas
are csrc/lnprob.cuh's, which K1-K3 share.

`MBBResults` and `MultiFitter` take each quantity's device part from
`device_part`: (S, n, 5) samples on a CUDA device go through `mbb_derived`,
one launch over every sample of every source, whose values stay on the card
for the summaries (derived.derived_summary); elsewhere the kernel's plain
twin runs derived.py's formulas on the operands' own fp32 inputs, in
derived._chunked_samples' chunks, and stays the kernel's twin in the tests.
The `*_operands` builders make the operands from derived.py's fp64 host
arrays and constants. `mbb_derived.launches` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mbb_emcee_tpu_torch import derived
from mbb_emcee_tpu_torch.constants import HCOK_UM_K, NPARAMS
from mbb_emcee_tpu_torch.models.modified_blackbody import LOG_C2, MBBShape
from mbb_emcee_tpu_torch.ops.build import build_kernels
from mbb_emcee_tpu_torch.utils.profiling import count, span

# The kernel's quantity codes (csrc/derived.cu).
QUANTITIES = {"lir": 0, "dustmass": 1, "peaklambda": 2}


@dataclasses.dataclass(frozen=True)
class DerivedOperands:
    """One quantity's operands besides the samples: the model's `shape`,
    the per-source fp32 `nodes` (L_IR's observed wavelengths, (S, nnodes);
    the dust mass's lambda_obs, (S, 1)) and L_IR's `weights` (S, nnodes),
    the quantity's two fp32 scalars p0, p1 (the peak's ln lo and ln hi; the
    dust mass's h c / k and its expm1 clamp) and the peak's golden-section
    iterations."""
    quantity: str
    shape: MBBShape
    nodes: np.ndarray | None = None
    weights: np.ndarray | None = None
    p0: np.float32 = np.float32(0.0)
    p1: np.float32 = np.float32(0.0)
    iters: int = 0

    @property
    def opthin(self):
        return bool(self.shape.opthin)

    @property
    def noalpha(self):
        return bool(self.shape.noalpha)

    @property
    def lxn_base(self):
        """fp32 (LOG_C2 - ln wavenorm), as the plain path rounds it."""
        return np.float32(LOG_C2 - math.log(self.shape.wavenorm))

    @property
    def nsources(self):
        """Sources the per-source operands hold (None: any number)."""
        return None if self.nodes is None else self.nodes.shape[0]

    @property
    def evals_per_sample(self):
        """SED evaluations a sample: L_IR's nodes, the dust mass's one
        wavelength, the peak's 2 + iters golden-section points."""
        if self.quantity == "peaklambda":
            return 2 + self.iters
        return self.nodes.shape[1]

    def consts(self):
        """The fp32 constants the kernel reads, in one host array: the
        nodes, then L_IR's weights (None for the peak, which reads none)."""
        if self.nodes is None:
            return None
        parts = [self.nodes.ravel()]
        if self.weights is not None:
            parts.append(self.weights.ravel())
        return np.concatenate(parts)


def _per_source(opz):
    return np.reshape(np.asarray(opz, np.float64), (-1, 1))


def lir_operands(shape, opz, wavemin, wavemax):
    """L_IR over [wavemin, wavemax] rest um for sources at 1 + z = `opz`
    (a number or one a source): derived.lir_nodes_weights per source, cast
    to fp32."""
    lam, w = derived.lir_nodes_weights(_per_source(opz), wavemin, wavemax)
    return DerivedOperands("lir", shape, nodes=lam.astype(np.float32),
                           weights=w.astype(np.float32))


def dustmass_operands(shape, opz, kappa_wave):
    """The dust mass's S(lambda_obs) (e^x - 1) at lambda_obs = kappa_wave
    (1 + z), per source, cast to fp32."""
    lam_obs = (kappa_wave * _per_source(opz)).astype(np.float32)
    return DerivedOperands("dustmass", shape, nodes=lam_obs,
                           p0=np.float32(HCOK_UM_K),
                           p1=np.float32(derived.DUST_X_CLAMP))


def peak_operands(shape, lo=derived.PEAK_RANGE[0], hi=derived.PEAK_RANGE[1],
                  iters=derived.PEAK_ITERS):
    """The observed f_nu peak by `iters` golden-section steps over [ln lo,
    ln hi], as derived.peak_finder bounds it (fp32)."""
    return DerivedOperands("peaklambda", shape,
                           p0=np.float32(float(np.log(lo))),
                           p1=np.float32(float(np.log(hi))), iters=int(iters))


def to_host(values):
    """A device tensor as a host fp64 array, its bytes counted as
    `d2h_bytes`."""
    out = values.double().cpu().numpy()
    count("d2h_bytes", out.nbytes)
    return out


def device_part(samples, ops: DerivedOperands):
    """A derived quantity's fp32 device part at every sample of (S, n, 5)
    samples: (S, n) host fp64 and, on a CUDA device, the same values as an
    (S, n) fp32 tensor there (None elsewhere), for derived_summary. One
    kernel launch when the samples lie on a CUDA device, else the plain
    twin; the host copy is counted as `d2h_bytes` either way."""
    if samples.device.type == "cuda":
        values = mbb_derived(samples, ops)
        return to_host(values), values.float()
    return _plain_twin(samples, ops), None


def _plain_twin(samples, ops):
    """The kernel's plain twin on (S, n, 5) samples on any device: derived.
    py's formula of `ops.quantity` on the operands' fp32 nodes, weights,
    ln-bounds and iterations, chunked by derived._chunked_samples (its
    spans and host copies) at the formula's fan-out of intermediates a
    sample."""
    dev = samples.device
    if ops.quantity == "peaklambda":
        # peak_finder takes the window in um and rounds its logs to fp32:
        # exp of the fp32 ln-bounds rounds back to p0, p1 exactly.
        fn = derived.peak_finder(ops.shape, math.exp(ops.p0),
                                 math.exp(ops.p1), ops.iters)
        return derived._chunked_samples(fn, samples, 8)
    nodes = torch.as_tensor(ops.nodes, device=dev)
    if ops.quantity == "dustmass":
        one = derived.dustmass_integrand(ops.shape)
        return derived._chunked_samples(lambda th: one(th, nodes[:, 0]),
                                        samples, 4)
    one = derived.lir_integrand(ops.shape)
    w = torch.as_tensor(ops.weights, device=dev)
    return derived._chunked_samples(lambda th: one(th, nodes, w), samples,
                                    derived.LIR_NODES)


def _check(samples, ops):
    """(sources, samples a source) of a launch, or ValueError for what the
    wrapper does not take; the launcher refuses what the kernel cannot run
    (its shared memory, its grid)."""
    if samples.dtype != torch.float32 or samples.dim() not in (2, 3) \
            or samples.shape[-1] != NPARAMS or not samples.is_contiguous():
        raise ValueError(
            f"samples must be a contiguous float32 (n, {NPARAMS}) or "
            f"(sources, n, {NPARAMS}) tensor; got {samples.dtype} "
            f"{tuple(samples.shape)}")
    if ops.quantity not in QUANTITIES:
        raise ValueError(f"unknown derived quantity {ops.quantity!r}")
    nsrc = samples.shape[0] if samples.dim() == 3 else 1
    n = samples.shape[-2]
    if ops.nsources is not None and ops.nsources != nsrc:
        raise ValueError(f"{ops.nsources} sources of {ops.quantity} "
                         f"operands for samples of {nsrc} sources")
    if samples.device.type != "cuda":
        raise ValueError(f"the derived kernel runs on a CUDA device; got "
                         f"samples on {samples.device}")
    return nsrc, n


def mbb_derived(samples, ops: DerivedOperands):
    """The quantity of `ops` at every sample, (n,) for (n, 5) samples and
    (S, n) for (S, n, 5): an fp64 tensor of the fp32 values, on the samples'
    CUDA device, from one kernel launch on its current stream.

    Under the profiler its span `mbb.kernel.derived` records the quantity,
    the samples (all sources'), the sources and `evals_per_sample`, the SED
    evaluations a sample (L_IR's nodes, 1, the peak's 2 + iters), and
    counts `derived_sed_evals`: samples x evals_per_sample."""
    nsrc, n = _check(samples, ops)
    evals = ops.evals_per_sample
    with span("mbb.kernel.derived", quantity=ops.quantity,
              samples=nsrc * n, sources=nsrc, evals_per_sample=evals):
        count("derived_sed_evals", nsrc * n * evals)
        return _launch(samples, ops, nsrc, n)


def _launch(samples, ops, nsrc, n):
    lib = build_kernels()
    dev = samples.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    consts = ops.consts()
    if consts is not None:
        consts = torch.as_tensor(consts, device=dev)
    out = torch.empty(samples.shape[:-1], dtype=torch.float64, device=dev)
    nnodes = 0 if ops.nodes is None else ops.nodes.shape[1]
    with torch.cuda.device(index):
        rc = lib.mbb_derived_launch(
            samples.data_ptr(), 0 if consts is None else consts.data_ptr(),
            out.data_ptr(),
            QUANTITIES[ops.quantity], int(ops.opthin), int(ops.noalpha),
            nsrc, n, nnodes, ops.iters, np.float32(LOG_C2), ops.lxn_base,
            ops.p0, ops.p1, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mbb_derived kernel launch failed: CUDA error "
                           f"{rc} ({ops.quantity}, {nsrc} x {n} samples)")
    mbb_derived.launches += 1
    return out


mbb_derived.launches = 0
