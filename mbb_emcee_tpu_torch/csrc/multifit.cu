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
// Bound: each source is K2's workload (a chain of dependent half updates,
// one lnprob evaluation deep; see sampler.cu), and the sources are
// independent. What binds depends on how many sources share an SM. A few
// sources leave most SMs idle, and each step waits on one serial lnprob:
// latency. At 256 sources of 250 walkers one thread per walker runs 2
// blocks of 4 warps per SM, and the run takes about one ensemble's time
// (1.1x that of 4 sources), yet the SM's issue slots are no longer idle:
// 1024 sources (32 warps per SM) take 2.3x, not 4x. G lanes per walker
// (mbb_lnprob_eval_group of lnprob.cuh) shorten the chain but repeat each
// walker's serial work (draw, proposal, Newton steps, accept) on every
// lane, so they cost G times its issue slots; they pay where the split part
// dominates. The layout is planned per launch (ops/multifit_kernel.py
// plan_multi_launch, from chip_smoke.py's sweep), and only where the whole
// catalog runs at once, as the card reports it (mbb_multi_resident below):
//   - a small catalog: K2's cluster layout, C blocks of G in {8, 16, 32}
//     lanes per source, kept in step through distributed shared memory
//     (stretch.cuh), while the card places all S clusters with a block per
//     SM (cudaOccupancyMaxActiveClusters: the GPCs hold 15 groups of 8 SMs
//     of an H100's 132, 30 of 4, 66 of 2); beyond that two clusters share
//     SMs and the launch waits on them, so the planner takes smaller ones;
//   - response mode (hundreds of band nodes per walker), while S blocks are
//     resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs):
//     G = 4 lanes per walker in one block per source, 512 threads at 250
//     walkers, bounded to 64 registers so two blocks share an SM (65,536
//     registers) and a 256-source catalog stays one wave;
//   - otherwise one thread per walker (G = 1): in point mode beyond the
//     clusters, and for a catalog of more than one wave in either mode.
// Each block stages the shared constants exactly as mbb_stage_consts does,
// overwrites the flux, whitening and upper-limit flags in its shared memory
// with its own source's row, and runs mbb_stretch_body (stretch.cuh), so
// K1, K2 and K3 evaluate one device function; in point mode every layout
// gives the same chains bit for bit, and K3 at one source is K2. The TPU
// kernel's record cap and source padding were grid and tile workarounds:
// here one launch covers the whole run and the grid is exactly S x C
// blocks. Chains are written straight into (S, nrec, nw, nfree) /
// (S, nrec, nw) tensors.

#include "stretch.cuh"

// Launch bounds per layout: one thread per walker at up to 1024 threads
// (64 registers); G = 4 at 512 threads with two blocks per SM (64
// registers); the cluster layouts as K2's grouped ones (512 threads, 128
// registers).
template <int G, bool CLUSTER>
__global__ void __launch_bounds__(G == 1 ? 1024 : 512, G == 4 ? 2 : 1)
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
                         int* __restrict__ nacc_out, int half, int wpb,
                         int nrec, int thin, float a, unsigned long long seed,
                         unsigned long long step0, int source0,
                         MbbConfig c) {
  extern __shared__ float dyn[];
  const MbbShared s = mbb_shared_layout(dyn, c);
  int src = blockIdx.x;
  if constexpr (CLUSTER)
    src /= (int)cooperative_groups::this_cluster().num_blocks();
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
  mbb_stretch_body<G, CLUSTER>(
      pos_in + ns * nw * nfree, nacc_in + ns * nw,
      uniforms == nullptr ? nullptr
                          : uniforms + ns * nrec * 6 * thin * half,
      chain + ns * nrec * nw * nfree, lnpchain + ns * nrec * nw,
      pos_out + ns * nw * nfree, lnp_out + ns * nw, nacc_out + ns * nw,
      half, wpb, nrec, thin, a, seed, step0, (uint32_t)(source0 + src), c,
      s, mbb_shared_end(s, c));
}

typedef void (*MbbMultiKernel)(const float*, const int*, const float*,
                               const float*, const float*, const float*,
                               float*, float*, float*, float*, int*, int,
                               int, int, int, float, unsigned long long,
                               unsigned long long, int, MbbConfig);

// The instantiated layouts: G in {1, 4} in one block per source, G in
// {8, 16, 32} in a cluster per source; null for any other.
static MbbMultiKernel mbb_multi_kernel_for(int group, int cluster) {
  if (cluster == 1) {
    switch (group) {
      case 1: return mbb_multi_stretch_kernel<1, false>;
      case 4: return mbb_multi_stretch_kernel<4, false>;
      default: return nullptr;
    }
  }
  switch (group) {
    case 8: return mbb_multi_stretch_kernel<8, true>;
    case 16: return mbb_multi_stretch_kernel<16, true>;
    case 32: return mbb_multi_stretch_kernel<32, true>;
    default: return nullptr;
  }
}

// The launch configuration of `nsources` x `cluster` blocks on `stream`
// under the plan (group lanes per walker, `cluster` blocks per source, one
// thread-block cluster each when above 1, of `threads` threads, `wpb`
// walkers of each half per block), each with the likelihood's and the
// run's dynamic shared memory (the kernel's opt-in limit raised to it);
// `attr` holds the cluster attribute. Sets *kernel and returns 0, or
// cudaErrorInvalidValue for a plan the kernel cannot run, or the CUDA error.
static int mbb_multi_config(int nsources, int nb, int nnodes, int half,
                            int group, int cluster, int wpb, int threads,
                            void* stream, MbbMultiKernel* kernel,
                            cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
  *kernel = mbb_multi_kernel_for(group, cluster);
  if (*kernel == nullptr || nsources < 0 || cluster < 1 || cluster > 8 ||
      wpb < 1 ||
      (long long)wpb * cluster < half || threads > (group == 1 ? 1024 : 512)
      || threads % 32 || wpb * group > threads ||
      (group == 1 && threads != (half + 31) / 32 * 32))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = mbb_run_dyn_bytes(nb, nnodes, half, threads);
  const cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)nsources * (unsigned)cluster, 1, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = dyn;
  cfg->stream = (cudaStream_t)stream;
  if (cluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }
  return 0;
}

// How many sources the current card runs at once on the plan for nb bands
// x nnodes nodes and 2 * half walkers (the planner's one-wave test). For a
// cluster plan, the clusters cudaOccupancyMaxActiveClusters places with one
// block per SM (the opt-in maximum of shared memory per block), i.e. the
// groups of C SMs of their own the card's GPCs hold: a cluster layout pays
// only while each block has its SM. Else the plan's blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with its shared memory)
// times the SMs. Returns a negative CUDA error on failure
// (cudaErrorInvalidValue for a plan the kernel cannot run).
extern "C" int mbb_multi_resident(int nb, int nnodes, int half, int group,
                                  int cluster, int wpb, int threads) {
  MbbMultiKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int rc = mbb_multi_config(1, nb, nnodes, half, group, cluster, wpb,
                                  threads, nullptr, &kernel, &cfg, attr);
  if (rc != 0) return -rc;
  int dev = 0, n = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (cluster > 1) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    cfg.dynamicSmemBytes = (size_t)optin;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  } else {
    int sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, threads, cfg.dynamicSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n *= sms;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// Launch the plan (mbb_multi_config) for `nsources` sources. Returns the
// first CUDA error (0 on success), cudaErrorInvalidValue for a plan the
// kernel cannot run, or MBB_ERR_CLUSTER_UNPLACEABLE when
// cudaOccupancyMaxActiveClusters finds no room for one cluster. flux is
// (S, nb); errs is (S, nb) signed 1/sigma, or (S, nb, nb) whitening when
// icfg's use_chol is set; `uniforms` is (S, nrec, 6 * thin, half) or null
// (Philox mode). Source s of the launch draws the Philox stream of global
// source source0 + s: a shard of a catalog (batchengine's mesh blocks)
// passes its first source's index, so a source's draws do not depend on
// the shard it lands in.
extern "C" int mbb_multi_stretch_launch(
    const float* pos_in, const int* nacc_in, const float* consts,
    const float* flux, const float* errs, const float* uniforms,
    float* chain, float* lnpchain, float* pos_out, float* lnp_out,
    int* nacc_out, int nsources, int half, int group, int cluster, int wpb,
    int threads, int nrec, int thin, float a, unsigned long long seed,
    unsigned long long step0, int source0, const int* icfg,
    const float* fcfg, void* stream) {
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  MbbMultiKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int rc = mbb_multi_config(nsources, c.nb, c.nnodes, half, group,
                                  cluster, wpb, threads, stream, &kernel,
                                  &cfg, attr);
  if (rc != 0 || nsources == 0) return rc;
  cudaError_t err;
  if (cluster > 1) {
    int nclusters = 0;
    err = cudaOccupancyMaxActiveClusters(&nclusters, (void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (nclusters < 1) return MBB_ERR_CLUSTER_UNPLACEABLE;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, pos_in, nacc_in, consts, flux, errs,
                           uniforms, chain, lnpchain, pos_out, lnp_out,
                           nacc_out, half, wpb, nrec, thin, a, seed, step0,
                           source0, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
