// K1: batched modified-blackbody lnprob, (n, nfree) -> (n,).
//
// Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_lnprob.py::_make_kernel
// (:248), launched by build_pallas_lnprob (:338, pallas_call at :364). The
// per-vector body is in lnprob.cuh, which the stretch-move kernels
// (sampler.cu, multifit.cu) call too; see there for what bounds it.
//
// Layout, planned by the caller (ops/lnprob_kernel.py plan_lnprob_launch):
//   - G lanes of one warp per vector, G in {1, 4, 8, 16, 32}. G = 1 is one
//     thread per vector (mbb_lnprob_eval); G > 1 splits the vector's chain
//     over its lanes (mbb_lnprob_eval_group<G>: the merge solve's bisections
//     as a tree, item i on lane i mod G) and lane 0 stores the result. In
//     point mode every G gives the same bits; in response mode the band
//     sums are added in another order.
//   - blocks of `threads` threads (a multiple of 32, at most 256), so a
//     tile of threads / G vectors per block.
//   - a grid of `blocks` blocks. The planner gives every tile its own block
//     (mbb_lnprob_kernel). With fewer blocks than tiles each block stages
//     the constants once and loops over the tiles blockIdx.x, blockIdx.x +
//     blocks, ... (mbb_lnprob_loop_kernel): a resident wave that stages
//     less often, which the sweep on an H100 found a tenth or more slower
//     at a million vectors (the tiles no longer balance over the SMs, and
//     staging is a few loads per thread); it stays as a layout the sweep
//     times.
// With G > 1 a vector index past n is clamped for the evaluation (all lanes
// of a group stay in its shuffles) and masked at the store.

#include <limits.h>

#include "lnprob.cuh"

#define MBB_LNPROB_MAX_THREADS 256
#define MBB_LNPROB_MAX_DEVICES 64
#define MBB_LNPROB_KERNELS 10

// mbb_stage_consts for a kernel that is one lnprob deep, where staging
// shows (the stretch-move kernels stage once per run): the same values.
// Constants that fit one trip of the block (point mode) take the plain
// loop: a large batch's blocks are bound by the work their warps dispatch,
// and a longer staging body cost them a tenth to a fifth of their time. A
// response pack is copied with a thread's loads started eight at a time, so
// some hundred nodes cost a block one or two trips to device memory and not
// one per node (0.8 us of 6.5 at 250 vectors x 5 x 65 on an H100); each
// thread then turns the wavelengths it copied itself into their ln terms.
static __device__ __forceinline__ void mbb_stage_consts_batched(
    const MbbShared& s, const float* __restrict__ consts,
    const MbbConfig& c) {
  constexpr int kBatch = 8;
  const int total = mbb_consts_floats(c.nb, c.nnodes);
  const int stride = blockDim.x;
  if (total <= stride) {
    mbb_stage_consts(s, consts, c);
    return;
  }
  for (int base = threadIdx.x; base < total; base += kBatch * stride) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * stride;
      v[j] = i < total ? consts[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * stride;
      if (i < total) s.lo[i] = v[j];
    }
  }
  // the first index >= w0 that this thread copied (i = threadIdx.x mod stride)
  const int w0 = 20 + c.nb + c.nb * c.nb, w1 = w0 + c.nb * c.nnodes;
  const int first = w0 + (threadIdx.x + stride - w0 % stride) % stride;
  for (int i = first; i < w1; i += stride)
    s.lo[i] = c.log_c2 - logf(s.lo[i]);
}

// The tiles blockIdx.x, blockIdx.x + gridDim.x, ... (LOOP), or the tile
// blockIdx.x alone.
template <int G, bool LOOP>
static __device__ __forceinline__ void mbb_lnprob_tiles(
    const float* __restrict__ theta_free, const float* __restrict__ consts,
    float* __restrict__ out, int n, int ntiles, const MbbConfig& c) {
  extern __shared__ float dyn[];
  const MbbShared s = mbb_shared_layout(dyn, c);
  mbb_stage_consts_batched(s, consts, c);
  __syncthreads();
  const int vpb = blockDim.x / G;               // vectors per tile
  const int v = threadIdx.x / G, lane = threadIdx.x % G;
  int tile = blockIdx.x;
  do {
    const int w = tile * vpb + v;
    if (G == 1 && w >= n) return;               // no shuffle to stay in
    const int wc = w < n ? w : n - 1;
    float th[MBB_NPARAMS];
#pragma unroll
    for (int i = 0; i < MBB_NPARAMS; ++i) {
      const int k = c.fmap[i];
      th[i] = k >= 0 ? theta_free[(size_t)wc * c.nfree + k] : c.tmpl[i];
    }
    float lp;
    if constexpr (G == 1) {
      lp = mbb_lnprob_eval(th, c, s);
    } else {
      lp = mbb_lnprob_eval_group<G>(th, c, s, lane);
    }
    if (lane == 0 && w < n) out[w] = lp;
    tile += gridDim.x;
  } while (LOOP && tile < ntiles);
}

template <int G>
__global__ void __launch_bounds__(MBB_LNPROB_MAX_THREADS)
mbb_lnprob_kernel(const float* __restrict__ theta_free,
                  const float* __restrict__ consts,
                  float* __restrict__ out, int n, int ntiles, MbbConfig c) {
  mbb_lnprob_tiles<G, false>(theta_free, consts, out, n, ntiles, c);
}

template <int G>
__global__ void __launch_bounds__(MBB_LNPROB_MAX_THREADS)
mbb_lnprob_loop_kernel(const float* __restrict__ theta_free,
                       const float* __restrict__ consts,
                       float* __restrict__ out, int n, int ntiles,
                       MbbConfig c) {
  mbb_lnprob_tiles<G, true>(theta_free, consts, out, n, ntiles, c);
}

typedef void (*MbbLnprobKernel)(const float*, const float*, float*, int, int,
                                MbbConfig);

// The instantiation of `group` lanes per vector, looping over tiles or not,
// and its index in the per-kernel table below, or nullptr.
static MbbLnprobKernel mbb_lnprob_kernel_for(int group, bool loop,
                                             int* slot) {
  *slot = loop ? 5 : 0;
  switch (group) {
    case 1:
      return loop ? mbb_lnprob_loop_kernel<1> : mbb_lnprob_kernel<1>;
    case 4: *slot += 1;
      return loop ? mbb_lnprob_loop_kernel<4> : mbb_lnprob_kernel<4>;
    case 8: *slot += 2;
      return loop ? mbb_lnprob_loop_kernel<8> : mbb_lnprob_kernel<8>;
    case 16: *slot += 3;
      return loop ? mbb_lnprob_loop_kernel<16> : mbb_lnprob_kernel<16>;
    case 32: *slot += 4;
      return loop ? mbb_lnprob_loop_kernel<32> : mbb_lnprob_kernel<32>;
    default: return nullptr;
  }
}

// Raise the kernel's opt-in limit of dynamic shared memory to `dyn` bytes
// on the current device, once per kernel, device and size: the largest size
// set so far is kept, so a launch within it makes no runtime call.
static cudaError_t mbb_lnprob_allow_smem(MbbLnprobKernel kernel, int slot,
                                         size_t dyn) {
  static size_t allowed[MBB_LNPROB_MAX_DEVICES][MBB_LNPROB_KERNELS];
  if (dyn <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < MBB_LNPROB_MAX_DEVICES;
  if (tracked && dyn <= allowed[dev][slot]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err == cudaSuccess && tracked) allowed[dev][slot] = dyn;
  return err;
}

static bool mbb_lnprob_layout_ok(int group, int threads) {
  return threads >= 32 && threads <= MBB_LNPROB_MAX_THREADS &&
         threads % 32 == 0 && group >= 1 && 32 % group == 0;
}

// Launch on `stream` under the plan (`group` lanes per vector, `blocks`
// blocks of `threads` threads; fewer blocks than tiles loop over them);
// returns the first CUDA error (0 on success), cudaErrorInvalidValue for a
// plan the kernel cannot run. icfg and fcfg are host arrays (see
// mbb_read_config); the pointers are device memory.
extern "C" int mbb_lnprob_launch(const float* theta_free, const float* consts,
                                 float* out, int n, int group, int threads,
                                 int blocks, const int* icfg,
                                 const float* fcfg, void* stream) {
  if (!mbb_lnprob_layout_ok(group, threads) || n < 0 ||
      n > INT_MAX - MBB_LNPROB_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int vpb = threads / group;
  const int ntiles = (n + vpb - 1) / vpb;
  if (blocks < 1 || blocks > ntiles) return (int)cudaErrorInvalidValue;
  int slot = 0;
  const MbbLnprobKernel kernel =
      mbb_lnprob_kernel_for(group, blocks < ntiles, &slot);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  const size_t dyn = mbb_lik_dyn_bytes(c.nb, c.nnodes, threads);
  const cudaError_t err = mbb_lnprob_allow_smem(kernel, slot, dyn);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, dyn, (cudaStream_t)stream>>>(
      theta_free, consts, out, n, ntiles, c);
  return (int)cudaGetLastError();
}

// Bytes of shared memory one block of `threads` threads of this kernel
// takes for a likelihood of nb bands x nnodes nodes (the refusal check of
// the wrappers and the launch planner's size read it here).
extern "C" long long mbb_lnprob_smem_bytes(int nb, int nnodes, int threads) {
  return (long long)mbb_lik_dyn_bytes(nb, nnodes, threads);
}

// The card's opt-in maximum of shared memory per block, in bytes, or -1.
extern "C" int mbb_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
