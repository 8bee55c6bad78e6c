// K2: the whole stretch-move run (nrec records x thin steps) of one ensemble
// in one launch.
//
// Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_sampler.py
// ::_make_sampler_kernel (:63-194), launched by FusedPallasSampler._make_run
// (:327-422, pallas_call at :395). The run loop (update rule, Philox stream,
// record layout) is mbb_stretch_body in stretch.cuh, which the multi-source
// kernel (multifit.cu) runs once per source.
//
// Bound: every step is a chain of two dependent half updates, each one
// lnprob evaluation deep (lnprob.cuh: a latency-bound transcendental
// chain), so the run is bound by that per-step latency, not by bytes (a few
// KB) or by the card's fp32 rate (the whole run's operations would take it
// microseconds).
// Design: one launch per run, so there is no per-step host round trip;
// positions, lnprob and accept counts stay in shared memory; the partner
// gather is an indexed shared-memory load; randomness is Philox-4x32-10 in
// registers, or an external uniforms array (rows z/partner/accept for half
// A, then half B) for replay against the plain version. What shortens the
// per-step chain is the layout, which the caller plans
// (ops/sampler_kernel.py plan_stretch_launch):
//   - G lanes of one warp per walker (G in {1, 8, 16, 32}): the merge solve
//     as a 7-node tree and the band nodes spread over the lanes
//     (lnprob.cuh mbb_lnprob_eval_group);
//   - a thread-block cluster of C blocks (C <= 8, one SM each), each owning
//     walkers_per_block walkers of each half, the ensemble mirrored in every
//     block's shared memory and kept in step through distributed shared
//     memory (stretch.cuh).
// G = 1, C = 1 is one block of round_up(half, 32) threads, one per walker.
// Chain records are written straight into (nrec, nwalkers, nfree) /
// (nrec, nwalkers) tensors.

#include "stretch.cuh"

// Grouped layouts run at most 512 threads per block, so their kernels may
// take 128 registers a thread (at 1024 threads the cap of 64 spills them).
template <int G, bool CLUSTER>
__global__ void __launch_bounds__(G == 1 ? 1024 : 512)
mbb_stretch_kernel(const float* __restrict__ pos_in,
                   const int* __restrict__ nacc_in,
                   const float* __restrict__ consts,
                   const float* __restrict__ uniforms,
                   float* __restrict__ chain, float* __restrict__ lnpchain,
                   float* __restrict__ pos_out, float* __restrict__ lnp_out,
                   int* __restrict__ nacc_out, int half, int wpb, int nrec,
                   int thin, float a, unsigned long long seed,
                   unsigned long long step0, MbbConfig c) {
  extern __shared__ float dyn[];
  const MbbShared s = mbb_shared_layout(dyn, c);
  mbb_stage_consts(s, consts, c);
  mbb_stretch_body<G, CLUSTER>(pos_in, nacc_in, uniforms, chain, lnpchain,
                               pos_out, lnp_out, nacc_out, half, wpb, nrec,
                               thin, a, seed, step0, 0u, c, s,
                               mbb_shared_end(s, c));
}

typedef void (*MbbStretchKernel)(const float*, const int*, const float*,
                                 const float*, float*, float*, float*,
                                 float*, int*, int, int, int, int, float,
                                 unsigned long long, unsigned long long,
                                 MbbConfig);

template <bool CLUSTER>
static MbbStretchKernel mbb_stretch_kernel_for(int group) {
  switch (group) {
    case 1: return mbb_stretch_kernel<1, CLUSTER>;
    case 8: return mbb_stretch_kernel<8, CLUSTER>;
    case 16: return mbb_stretch_kernel<16, CLUSTER>;
    case 32: return mbb_stretch_kernel<32, CLUSTER>;
    default: return nullptr;
  }
}

// Launch the run on `stream` under the plan (group lanes per walker,
// `cluster` blocks of `threads` threads, `wpb` walkers of each half per
// block) with the likelihood's and the run's dynamic shared memory (the
// opt-in limit raised to it). Returns the first CUDA error (0 on success),
// cudaErrorInvalidValue for a plan the kernel cannot run, or
// MBB_ERR_CLUSTER_UNPLACEABLE when cudaOccupancyMaxActiveClusters finds no
// room for one cluster. `uniforms` may be null (Philox mode).
extern "C" int mbb_stretch_launch(
    const float* pos_in, const int* nacc_in, const float* consts,
    const float* uniforms, float* chain, float* lnpchain, float* pos_out,
    float* lnp_out, int* nacc_out, int half, int group, int cluster,
    int wpb, int threads, int nrec, int thin, float a,
    unsigned long long seed, unsigned long long step0, const int* icfg,
    const float* fcfg, void* stream) {
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  const MbbStretchKernel kernel = cluster > 1
      ? mbb_stretch_kernel_for<true>(group)
      : mbb_stretch_kernel_for<false>(group);
  if (kernel == nullptr || cluster < 1 || cluster > 8 || wpb < 1 ||
      (long long)wpb * cluster < half || threads > (group == 1 ? 1024 : 512)
      || threads % 32 || wpb * group > threads ||
      (group == 1 && cluster == 1 && threads != (half + 31) / 32 * 32))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = mbb_run_dyn_bytes(c.nb, c.nnodes, half, threads);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int nclusters = 0;
    err = cudaOccupancyMaxActiveClusters(&nclusters, (void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (nclusters < 1) return MBB_ERR_CLUSTER_UNPLACEABLE;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, pos_in, nacc_in, consts, uniforms,
                           chain, lnpchain, pos_out, lnp_out, nacc_out, half,
                           wpb, nrec, thin, a, seed, step0, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Bytes of shared memory one block of K2 or K3 of `threads` threads takes
// for this likelihood and half-ensemble (the refusal checks of the wrappers
// and the launch planner's table read it here).
extern "C" long long mbb_run_smem_bytes(int nb, int nnodes, int half,
                                        int threads) {
  return (long long)mbb_run_dyn_bytes(nb, nnodes, half, threads);
}
