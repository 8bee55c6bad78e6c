// The derived posteriors of the modified blackbody in one launch per
// quantity, over every sample of every source: L_IR's quadrature, the dust
// mass's S(lambda_obs) (e^x - 1), and the observed f_nu peak's
// golden-section search.
//
// Replaces no TPU kernel: the JAX package leaves these to XLA, which fuses
// mbb_emcee_tpu/derived.py's jnp chains. The port's plain version
// (derived.py's integrands and peak_finder, MultiFitter's integrands in
// multifit.py) runs that chain as thousands of small torch operations a
// call (each golden-section evaluation solves the Wien merge again), which
// on the card costs the host's dispatch for one source and the device's
// memory traffic for a catalog. This kernel is that chain per sample in
// registers, with the formulas of models/modified_blackbody.py in the same
// fp32 operation order through lnprob.cuh's device functions (-fmad=false);
// only the L_IR sum runs in another order (node by node).
//
// Bound: operations. Per sample the merge solve (8 slope evaluations) and
// the normalization once, then 128 ln S evaluations (L_IR), 1 (dust mass)
// or 66 (the peak: 2 + 64 golden-section points), each ~6 libdevice
// transcendentals; the bytes are the 5 fp32 parameters in and one fp64
// value out a sample.
// Design: one thread per sample, blocks of MBB_DERIVED_THREADS threads, each
// block inside one source (blocks_per_source blocks a source), so a block
// stages its source's L_IR nodes (as log_c2 - ln lambda, the plain
// version's first two operations) and weights in shared memory once. The
// merge point, ln S at the normalization wavelength and ln fnorm are formed
// once a sample and reused by every evaluation. The four model shapes are
// template arguments, so a shape's branches compile away.

#include <limits.h>

#include "lnprob.cuh"

#define MBB_DERIVED_THREADS 128
#define MBB_DERIVED_SMEM_MAX (48 * 1024)

enum { MBB_DERIVED_LIR = 0, MBB_DERIVED_DUSTMASS = 1, MBB_DERIVED_PEAK = 2 };

// One sample's terms that every evaluation of its SED shares.
struct MbbSampleSed {
  MbbConfig c;   // only opthin and noalpha are read (mbb_log_s)
  float log_T, beta, log_x0, alpha, u_m, ls_m, ls_norm, log_fnorm;
};

// log_mbb_fnu_params' per-sample part: ln T, ln x0, the merge point and ln S
// there, ln S at the normalization wavelength, ln fnorm.
template <bool OPTHIN, bool NOALPHA>
static __device__ __forceinline__ MbbSampleSed mbb_sample_sed(
    const float th[MBB_NPARAMS], float log_c2, float lxn_base) {
  MbbSampleSed s;
  s.c = MbbConfig{};
  s.c.opthin = OPTHIN;
  s.c.noalpha = NOALPHA;
  s.beta = th[1];
  s.alpha = th[3];
  s.log_T = logf(th[0]);
  s.log_x0 = (log_c2 - logf(th[2])) - s.log_T;
  s.u_m = 0.0f;
  s.ls_m = 0.0f;
  if (!NOALPHA) {
    s.u_m = mbb_merge_log_x(s.beta, s.log_x0, s.alpha, OPTHIN);
    s.ls_m = mbb_log_s_grey(s.u_m, s.beta, s.log_x0, OPTHIN);
  }
  s.ls_norm = mbb_log_s(lxn_base - s.log_T, s.beta, s.log_x0, s.alpha, s.u_m,
                        s.ls_m, s.c);
  s.log_fnorm = logf(th[4]);
  return s;
}

// ln f_nu at the wavelength whose log_c2 - ln(wave) is lxw.
static __device__ __forceinline__ float mbb_sample_log_fnu(
    const MbbSampleSed& s, float lxw) {
  const float log_x = lxw - s.log_T;
  return (s.log_fnorm + mbb_log_s(log_x, s.beta, s.log_x0, s.alpha, s.u_m,
                                  s.ls_m, s.c)) -
         s.ls_norm;
}

// ln f_nu at wave = e^u (derived.peak_finder's log_flux).
static __device__ __forceinline__ float mbb_peak_log_flux(
    const MbbSampleSed& s, float u, float log_c2) {
  return mbb_sample_log_fnu(s, log_c2 - logf(expf(u)));
}

// ops/rootfind.golden_max over [ulo, uhi] in ln lambda, without its final
// f(xm), which the peak discards: e^xm.
static __device__ __forceinline__ float mbb_peak_lambda(
    const MbbSampleSed& s, float ulo, float uhi, int iters, float log_c2) {
  const float c1 = 0.6180339887498949f;   // 1/phi
  const float c2 = 0.3819660112501051f;   // 1/phi^2
  float a = ulo, b = uhi;
  float x1 = a + c2 * (b - a);
  float x2 = a + c1 * (b - a);
  float f1 = mbb_peak_log_flux(s, x1, log_c2);
  float f2 = mbb_peak_log_flux(s, x2, log_c2);
  for (int it = 0; it < iters; ++it) {
    const bool left = f1 >= f2;
    const float a_n = left ? a : x1;
    const float b_n = left ? x2 : b;
    const float x1_n = left ? a_n + c2 * (b_n - a_n) : x2;
    const float x2_n = left ? x1 : a_n + c1 * (b_n - a_n);
    const float f_new = mbb_peak_log_flux(s, left ? x1_n : x2_n, log_c2);
    const float f1_n = left ? f_new : f2;
    f2 = left ? f1 : f_new;
    f1 = f1_n;
    a = a_n;
    b = b_n;
    x1 = x1_n;
    x2 = x2_n;
  }
  return expf(0.5f * (a + b));
}

// consts: L_IR: nsources x nnodes observed wavelengths, then nsources x
// nnodes weights; dust mass: nsources observed wavelengths lambda_obs;
// the peak: unused. p0, p1: the peak's ln lo and ln hi; the dust mass's
// h c / k [um K] and its expm1 clamp.
template <int Q, bool OPTHIN, bool NOALPHA>
__global__ void __launch_bounds__(MBB_DERIVED_THREADS)
mbb_derived_kernel(const float* __restrict__ theta,
                   const float* __restrict__ consts,
                   double* __restrict__ out, int nsources, int n, int nnodes,
                   int iters, int blocks_per_source, float log_c2,
                   float lxn_base, float p0, float p1) {
  extern __shared__ float dyn[];
  const int src = blockIdx.x / blocks_per_source;
  const int i =
      (blockIdx.x - src * blocks_per_source) * blockDim.x + threadIdx.x;
  if constexpr (Q == MBB_DERIVED_LIR) {
    const float* lam = consts + (size_t)src * nnodes;
    const float* w = consts + ((size_t)nsources + src) * nnodes;
    for (int k = threadIdx.x; k < nnodes; k += blockDim.x) {
      dyn[k] = log_c2 - logf(lam[k]);
      dyn[nnodes + k] = w[k];
    }
    __syncthreads();
  }
  if (i >= n) return;
  const size_t idx = (size_t)src * n + i;
  float th[MBB_NPARAMS];
#pragma unroll
  for (int j = 0; j < MBB_NPARAMS; ++j) th[j] = theta[idx * MBB_NPARAMS + j];
  const MbbSampleSed s = mbb_sample_sed<OPTHIN, NOALPHA>(th, log_c2, lxn_base);
  float v;
  if constexpr (Q == MBB_DERIVED_LIR) {
    v = 0.0f;
    for (int k = 0; k < nnodes; ++k)
      v += dyn[nnodes + k] * expf(mbb_sample_log_fnu(s, dyn[k]));
  } else if constexpr (Q == MBB_DERIVED_DUSTMASS) {
    const float lam = consts[src];
    const float s_mjy = expf(mbb_sample_log_fnu(s, log_c2 - logf(lam)));
    // HCOK / t is t.reciprocal() * HCOK in torch; clamp(max=) keeps a NaN
    const float x = (1.0f / (lam * th[0])) * p0;
    v = s_mjy * expm1f(x > p1 ? p1 : x);
  } else {
    v = mbb_peak_lambda(s, p0, p1, iters, log_c2);
  }
  out[idx] = (double)v;
}

typedef void (*MbbDerivedKernel)(const float*, const float*, double*, int,
                                 int, int, int, int, float, float, float,
                                 float);

template <int Q>
static MbbDerivedKernel mbb_derived_shape(int opthin, int noalpha) {
  if (opthin)
    return noalpha ? mbb_derived_kernel<Q, true, true>
                   : mbb_derived_kernel<Q, true, false>;
  return noalpha ? mbb_derived_kernel<Q, false, true>
                 : mbb_derived_kernel<Q, false, false>;
}

// Bytes of dynamic shared memory one block takes: L_IR's staged nodes and
// weights, nothing for the other quantities.
static long long mbb_derived_smem_bytes(int quantity, int nnodes) {
  return quantity == MBB_DERIVED_LIR
             ? 2LL * (long long)nnodes * (long long)sizeof(float)
             : 0LL;
}

// Launch on `stream` over nsources x n samples (theta: nsources x n x 5
// fp32, out: nsources x n fp64, both device memory); returns the first CUDA
// error (0 on success), cudaErrorInvalidValue for arguments the kernel
// cannot run.
extern "C" int mbb_derived_launch(const float* theta, const float* consts,
                                  double* out, int quantity, int opthin,
                                  int noalpha, int nsources, int n,
                                  int nnodes, int iters, float log_c2,
                                  float lxn_base, float p0, float p1,
                                  void* stream) {
  if (quantity < MBB_DERIVED_LIR || quantity > MBB_DERIVED_PEAK ||
      nsources < 1 || n < 0 || iters < 0 ||
      (quantity != MBB_DERIVED_PEAK && nnodes < 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const long long smem = mbb_derived_smem_bytes(quantity, nnodes);
  const long long bps =
      ((long long)n + MBB_DERIVED_THREADS - 1) / MBB_DERIVED_THREADS;
  if (smem > MBB_DERIVED_SMEM_MAX || bps * nsources > INT_MAX)
    return (int)cudaErrorInvalidValue;
  MbbDerivedKernel kernel;
  switch (quantity) {
    case MBB_DERIVED_LIR:
      kernel = mbb_derived_shape<MBB_DERIVED_LIR>(opthin, noalpha);
      break;
    case MBB_DERIVED_DUSTMASS:
      kernel = mbb_derived_shape<MBB_DERIVED_DUSTMASS>(opthin, noalpha);
      break;
    default:
      kernel = mbb_derived_shape<MBB_DERIVED_PEAK>(opthin, noalpha);
  }
  kernel<<<(unsigned)(bps * nsources), MBB_DERIVED_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>(theta, consts, out, nsources, n, nnodes,
                                   iters, (int)bps, log_c2, lxn_base, p0,
                                   p1);
  return (int)cudaGetLastError();
}
