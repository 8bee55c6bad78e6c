// K1: batched modified-blackbody lnprob, (n, nfree) -> (n,).
//
// Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_lnprob.py::_make_kernel
// (:248), launched by build_pallas_lnprob (:338, pallas_call at :364). The
// per-walker body is mbb_lnprob_eval in lnprob.cuh, which the stretch-move
// kernel (sampler.cu) calls too. One thread per walker, blocks of 128; each
// block stages the constants in dynamic shared memory once. See lnprob.cuh
// for what bounds it.

#include "lnprob.cuh"

#define MBB_LNPROB_BLOCK 128

__global__ void __launch_bounds__(MBB_LNPROB_BLOCK)
mbb_lnprob_kernel(const float* __restrict__ theta_free,
                  const float* __restrict__ consts,
                  float* __restrict__ out, int n, MbbConfig c) {
  extern __shared__ float dyn[];
  const MbbShared s = mbb_shared_layout(dyn, c);
  mbb_stage_consts(s, consts, c);
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  float th[MBB_NPARAMS];
#pragma unroll
  for (int i = 0; i < MBB_NPARAMS; ++i) {
    const int k = c.fmap[i];
    th[i] = k >= 0 ? theta_free[(size_t)w * c.nfree + k] : c.tmpl[i];
  }
  out[w] = mbb_lnprob_eval(th, c, s);
}

// Launch on `stream`; returns the first CUDA error (0 on success).
// icfg/fcfg are host arrays (see mbb_read_config); the pointers are device
// memory. Above 48 KB of shared memory the kernel's opt-in limit is raised
// first.
extern "C" int mbb_lnprob_launch(const float* theta_free, const float* consts,
                                 float* out, int n, const int* icfg,
                                 const float* fcfg, void* stream) {
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  const size_t dyn = mbb_lik_dyn_bytes(c.nb, c.nnodes, MBB_LNPROB_BLOCK);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mbb_lnprob_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    const int grid = (n + MBB_LNPROB_BLOCK - 1) / MBB_LNPROB_BLOCK;
    mbb_lnprob_kernel<<<grid, MBB_LNPROB_BLOCK, dyn,
                        (cudaStream_t)stream>>>(theta_free, consts, out, n,
                                                c);
  }
  return (int)cudaGetLastError();
}

// Bytes of shared memory one block of this kernel takes for a likelihood of
// nb bands x nnodes nodes (the refusal check of the wrappers reads it here).
extern "C" long long mbb_lnprob_smem_bytes(int nb, int nnodes) {
  return (long long)mbb_lik_dyn_bytes(nb, nnodes, MBB_LNPROB_BLOCK);
}

// The card's opt-in maximum of shared memory per block, in bytes, or -1.
extern "C" int mbb_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
