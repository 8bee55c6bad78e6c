// K1: batched modified-blackbody lnprob, (n, nfree) -> (n,).
//
// Replaces the TPU kernel mbb_emcee_tpu/ops/pallas_lnprob.py::_make_kernel
// (:248), launched by build_pallas_lnprob (:338, pallas_call at :364). The
// per-walker body is mbb_lnprob_eval in lnprob.cuh, which the stretch-move
// kernel (sampler.cu) calls too. One thread per walker, blocks of 128; each
// block stages the constants in shared memory once. See lnprob.cuh for what
// bounds it.

#include "lnprob.cuh"

#define MBB_LNPROB_BLOCK 128

__global__ void __launch_bounds__(MBB_LNPROB_BLOCK)
mbb_lnprob_kernel(const float* __restrict__ theta_free,
                  const float* __restrict__ consts,
                  float* __restrict__ out, int n, MbbConfig c) {
  __shared__ MbbShared s;
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

// Launch on `stream`; returns cudaGetLastError() (0 on success). icfg/fcfg
// are host arrays (see mbb_read_config); the pointers are device memory.
extern "C" int mbb_lnprob_launch(const float* theta_free, const float* consts,
                                 float* out, int n, const int* icfg,
                                 const float* fcfg, void* stream) {
  const MbbConfig c = mbb_read_config(icfg, fcfg);
  if (n > 0) {
    const int grid = (n + MBB_LNPROB_BLOCK - 1) / MBB_LNPROB_BLOCK;
    mbb_lnprob_kernel<<<grid, MBB_LNPROB_BLOCK, 0,
                        (cudaStream_t)stream>>>(theta_free, consts, out, n,
                                                c);
  }
  return (int)cudaGetLastError();
}
