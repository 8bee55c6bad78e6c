// K2: the whole stretch-move run (nrec records x thin steps) in one launch.
//
// Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_sampler.py
// ::_make_sampler_kernel (:63-194), launched by FusedPallasSampler._make_run
// (:327-422, pallas_call at :395). The run loop (update rule, Philox stream,
// record layout) is mbb_stretch_body in stretch.cuh, which the multi-source
// kernel (multifit.cu) runs once per source.
//
// Bound: at 250 walkers x 5 bands the ensemble fits in one block on one SM,
// and every step is a chain of two dependent half updates, each one lnprob
// evaluation deep (lnprob.cuh: a latency-bound transcendental chain). The
// run is therefore bound by that per-step latency, not by bytes or by SM
// count. Design: one launch per run, so there is no per-step host round
// trip or kernel launch; positions, lnprob and accept counts stay in shared
// memory for the whole run (a barrier between half updates is the only
// synchronization); the partner gather is an indexed shared-memory load;
// randomness is Philox-4x32-10 computed in registers, or read from an
// external uniforms array (rows z/partner/accept for half A, then half B)
// for replay against the plain version. Chain records are written straight
// into (nrec, nwalkers, nfree) / (nrec, nwalkers) tensors.

#include "stretch.cuh"

__global__ void __launch_bounds__(1024)
mbb_stretch_kernel(const float* __restrict__ pos_in,
                   const int* __restrict__ nacc_in,
                   const float* __restrict__ consts,
                   const float* __restrict__ uniforms,
                   float* __restrict__ chain, float* __restrict__ lnpchain,
                   float* __restrict__ pos_out, float* __restrict__ lnp_out,
                   int* __restrict__ nacc_out, int half, int nrec, int thin,
                   float a, unsigned long long seed,
                   unsigned long long step0, MbbConfig c) {
  extern __shared__ float dyn[];
  const MbbShared s = mbb_shared_layout(dyn, c);
  mbb_stage_consts(s, consts, c);
  mbb_stretch_body(pos_in, nacc_in, uniforms, chain, lnpchain, pos_out,
                   lnp_out, nacc_out, half, nrec, thin, a, seed, step0, 0u,
                   c, s, mbb_shared_end(s, c));
}

// Launch one block of round_up(half, 32) threads on `stream` with the
// likelihood's and the run's dynamic shared memory (the opt-in limit raised
// to it); returns the first CUDA error (0 on success). `uniforms` may be
// null (Philox mode).
extern "C" int mbb_stretch_launch(
    const float* pos_in, const int* nacc_in, const float* consts,
    const float* uniforms, float* chain, float* lnpchain, float* pos_out,
    float* lnp_out, int* nacc_out, int half, int nrec, int thin, float a,
    unsigned long long seed, unsigned long long step0, const int* icfg,
    const float* fcfg, void* stream) {
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  const int hp = (half + 31) / 32 * 32;
  const size_t dyn = mbb_run_dyn_bytes(c.nb, c.nnodes, half);
  cudaError_t err = cudaFuncSetAttribute(
      mbb_stretch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  mbb_stretch_kernel<<<1, hp, dyn, (cudaStream_t)stream>>>(
      pos_in, nacc_in, consts, uniforms, chain, lnpchain, pos_out, lnp_out,
      nacc_out, half, nrec, thin, a, seed, step0, c);
  return (int)cudaGetLastError();
}

// Bytes of shared memory one block of K2 or K3 takes for this likelihood
// and half-ensemble (the refusal check of the wrappers reads it here).
extern "C" long long mbb_run_smem_bytes(int nb, int nnodes, int half) {
  return (long long)mbb_run_dyn_bytes(nb, nnodes, half);
}
