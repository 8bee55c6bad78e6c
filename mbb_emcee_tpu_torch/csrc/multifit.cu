// K3: the stretch-move runs of S independent sources in one launch.
//
// Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_multifit.py
// ::_make_multi_kernel (:203-343, lnprob _make_multi_lnp :69-166), launched
// by FusedMultiPallasSampler._make_run (:597-720, pallas_call at :653).
// Every source has its own fluxes and its own error operand: signed inverse
// uncertainties (a negative value marks a one-sided upper-limit band, 0 a
// missing band) or a lower-triangular whitening matrix (correlated band
// errors). Model shape, box, priors, fixed parameters and band geometry are
// shared.
//
// Bound: each source is K2's workload (a latency-bound chain of dependent
// half updates, one lnprob evaluation deep; see sampler.cu), and the
// sources are independent. Design: one thread block per source, so the
// sources fill the card's SMs side by side (at 250 walkers a block is 128
// threads, so 256 sources are resident at once on 132 SMs); each block
// stages the shared constants exactly as mbb_stage_consts does, overwrites
// the flux, whitening and upper-limit flags in its shared memory with its
// own source's row, and runs mbb_stretch_body (stretch.cuh) on K2's G = 1,
// C = 1 layout (one thread per walker, mbb_lnprob_eval of lnprob.cuh), so
// K1, K2 and K3 evaluate one device function (K3 at one source is K2 bit
// for bit in point mode, on any of K2's layouts). The TPU kernel's record
// cap and source padding were grid and tile workarounds: here one launch
// covers the whole run and the grid is exactly S blocks. Chains are written straight into (S, nrec, nw, nfree) /
// (S, nrec, nw) tensors.

#include "stretch.cuh"

__global__ void __launch_bounds__(1024)
mbb_multi_stretch_kernel(const float* __restrict__ pos_in,
                         const int* __restrict__ nacc_in,
                         const float* __restrict__ consts,
                         const float* __restrict__ flux,
                         const float* __restrict__ errs,
                         const float* __restrict__ uniforms,
                         float* __restrict__ chain,
                         float* __restrict__ lnpchain,
                         float* __restrict__ pos_out,
                         float* __restrict__ lnp_out,
                         int* __restrict__ nacc_out, int half, int nrec,
                         int thin, float a, unsigned long long seed,
                         unsigned long long step0, MbbConfig c) {
  extern __shared__ float dyn[];
  const MbbShared s = mbb_shared_layout(dyn, c);
  const int src = blockIdx.x;
  const int nb = c.nb;
  const int nw = 2 * half;
  const size_t nfree = (size_t)c.nfree;
  const float* frow = flux + (size_t)src * nb;
  const float* erow = errs + (size_t)src * (c.use_chol ? nb * nb : nb);

  mbb_stage_consts(s, consts, c);
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s.flux[i] = frow[i];
  if (c.use_chol) {
    for (int i = threadIdx.x; i < nb * nb; i += blockDim.x)
      s.whiten[i] = erow[i];
  } else {
    // This source's upper-limit bands: a `<` test, not the sign bit, so a
    // missing band flagged as a limit (-0.0, weight 0) stays two-sided.
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      s.whiten[i * nb + i] = fabsf(erow[i]);
      s.uplim[i] = erow[i] < 0.0f ? 1.0f : 0.0f;
    }
  }
  const size_t ns = (size_t)src;
  mbb_stretch_body<1, false>(
      pos_in + ns * nw * nfree, nacc_in + ns * nw,
      uniforms == nullptr ? nullptr
                          : uniforms + ns * nrec * 6 * thin * half,
      chain + ns * nrec * nw * nfree, lnpchain + ns * nrec * nw,
      pos_out + ns * nw * nfree, lnp_out + ns * nw, nacc_out + ns * nw,
      half, blockDim.x, nrec, thin, a, seed, step0, (uint32_t)src, c, s,
      mbb_shared_end(s, c));
}

// Launch `nsources` blocks of round_up(half, 32) threads on `stream`, each
// with the likelihood's and the run's dynamic shared memory (the opt-in
// limit raised to it); returns the first CUDA error (0 on success). flux is
// (S, nb); errs is
// (S, nb) signed 1/sigma, or (S, nb, nb) whitening when icfg's use_chol is
// set; `uniforms` is (S, nrec, 6 * thin, half) or null (Philox mode).
extern "C" int mbb_multi_stretch_launch(
    const float* pos_in, const int* nacc_in, const float* consts,
    const float* flux, const float* errs, const float* uniforms,
    float* chain, float* lnpchain, float* pos_out, float* lnp_out,
    int* nacc_out, int nsources, int half, int nrec, int thin, float a,
    unsigned long long seed, unsigned long long step0, const int* icfg,
    const float* fcfg, void* stream) {
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  const int hp = (half + 31) / 32 * 32;
  const size_t dyn = mbb_run_dyn_bytes(c.nb, c.nnodes, half, hp);
  cudaError_t err = cudaFuncSetAttribute(
      mbb_multi_stretch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  if (nsources > 0)
    mbb_multi_stretch_kernel<<<nsources, hp, dyn, (cudaStream_t)stream>>>(
        pos_in, nacc_in, consts, flux, errs, uniforms, chain, lnpchain,
        pos_out, lnp_out, nacc_out, half, nrec, thin, a, seed, step0, c);
  return (int)cudaGetLastError();
}
