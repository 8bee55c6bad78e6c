// Per-walker modified-blackbody log-probability, shared by the standalone
// lnprob kernel (lnprob.cu) and the stretch-move kernel (sampler.cu).
//
// Replaces the body of the TPU kernel mbb_emcee_tpu/ops/pallas_lnprob.py
// (_make_lnp_compute, :136-245, and its helpers make_log_s_mbb :82,
// make_merge_g_gp :96, merge_log_x_pallas :114). The formulas are those of
// mbb_emcee_tpu_torch/models/modified_blackbody.py and likelihood.py, in the
// same fp32 operation order; libdevice expm1f/logf/expf take the place of
// the TPU kernel's series stand-ins (pallas_lnprob.py:43-79). Build with
// -fmad=false so no multiply-add is contracted and the kernel rounds as the
// plain torch version does, op by op.
//
// Bound: per walker this is a dependent chain of transcendentals (the Wien
// merge solve alone is 8 slope evaluations of 4 exp/expm1 each, then one
// ln S per band node and for the normalization), so at the main path's 250
// walkers it is bound by the latency of the special-function units, not by
// bytes: the constants are a few KB and live in shared memory, and each
// walker reads 5 floats.
// Design: one thread per walker, every per-band constant staged once per
// block into dynamic shared memory sized at launch for this likelihood's
// band and node counts (no compile-time cap: a measured filter table of
// hundreds of rows per band fits as long as the block's bytes stay under
// the card's opt-in maximum), ln(wavelength) terms precomputed there, the
// nb residuals of each walker in a shared-memory slot of its own, and the
// rest of the evaluation in registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MBB_NPARAMS 5
#define MBB_LNPROB_FLOOR (-1e30f)
#define MBB_SUPPORT_FLOOR (-1e25f)
#define MBB_EXP_CUT 25.0f
#define MBB_TAU_BIG 60.0f
#define MBB_MERGE_BISECT 6
#define MBB_MERGE_NEWTON 2

// Runtime configuration, uniform across a launch. The host fills it from
// the integer and float arrays the ctypes wrapper passes (mbb_read_config).
struct MbbConfig {
  int opthin, noalpha, use_chol;
  int nb, nnodes;
  int nfree;
  int free_idx[MBB_NPARAMS];  // free slot k -> parameter index
  int fmap[MBB_NPARAMS];      // parameter i -> free slot, or -1 if fixed
  float tmpl[MBB_NPARAMS];    // fixed values (0 at free slots)
  float log_c2;               // fp32 ln(h c / k) [um K]
  float lxn_base;             // fp32 (ln(h c / k) - ln wavenorm)
};

// Packed constant operand, one fp32 device buffer (offsets in floats):
//   [0,5) lower  [5,10) upper  [10,15) prior mean  [15,20) prior 1/sigma
//   [20, 20+nb) flux   then nb*nb whitening (L^-1 or diag 1/unc)
//   then nb*nnodes wavelengths, then nb*nnodes quadrature weights,
//   then nb upper-limit flags (1: the band is a one-sided upper limit).
static __host__ __device__ __forceinline__ int mbb_consts_floats(int nb,
                                                                 int nnodes) {
  return 20 + nb * (nb + 2) + 2 * nb * nnodes;
}

// Bytes of dynamic shared memory one likelihood takes in a block of
// `nthreads` threads: the staged constants, then one residual slot per band
// per thread.
static inline size_t mbb_lik_dyn_bytes(int nb, int nnodes, int nthreads) {
  return ((size_t)mbb_consts_floats(nb, nnodes) + (size_t)nb * nthreads) *
         sizeof(float);
}

// The likelihood's arrays in the block's dynamic shared memory, in the
// order of the packed buffer (ln-wavelength terms in place of the
// wavelengths), then the residual slots: band b of thread t at
// delta[b * blockDim.x + t].
struct MbbShared {
  float *lo, *hi, *pmean, *pisig;
  float* flux;     // [nb]
  float* whiten;   // [nb * nb]
  float* lxw;      // [nb * nnodes] log_c2 - ln(wave)
  float* wts;      // [nb * nnodes]
  float* uplim;    // [nb]
  float* delta;    // [nb * blockDim.x]
};

static __device__ __forceinline__ MbbShared mbb_shared_layout(
    float* base, const MbbConfig& c) {
  const int nb = c.nb, nr = c.nb * c.nnodes;
  MbbShared s;
  s.lo = base;
  s.hi = base + 5;
  s.pmean = base + 10;
  s.pisig = base + 15;
  s.flux = base + 20;
  s.whiten = s.flux + nb;
  s.lxw = s.whiten + nb * nb;
  s.wts = s.lxw + nr;
  s.uplim = s.wts + nr;
  s.delta = s.uplim + nb;
  return s;
}

// First float past the likelihood's region of a block of blockDim.x
// threads (where the stretch-move kernels' own arrays start).
static __device__ __forceinline__ float* mbb_shared_end(const MbbShared& s,
                                                        const MbbConfig& c) {
  return s.delta + c.nb * blockDim.x;
}

static inline MbbConfig mbb_read_config(const int* icfg, const float* fcfg) {
  // icfg: opthin, noalpha, use_chol, nb, nnodes, nfree, free_idx[5];
  // fcfg: tmpl[5], log_c2, lxn_base
  MbbConfig c;
  c.opthin = icfg[0];
  c.noalpha = icfg[1];
  c.use_chol = icfg[2];
  c.nb = icfg[3];
  c.nnodes = icfg[4];
  c.nfree = icfg[5];
  for (int i = 0; i < MBB_NPARAMS; ++i) c.fmap[i] = -1;
  for (int k = 0; k < MBB_NPARAMS; ++k) {
    c.free_idx[k] = icfg[6 + k];
    if (k < c.nfree) c.fmap[c.free_idx[k]] = k;
  }
  for (int i = 0; i < MBB_NPARAMS; ++i) c.tmpl[i] = fcfg[i];
  c.log_c2 = fcfg[5];
  c.lxn_base = fcfg[6];
  return c;
}

// Cooperative load of the packed constants into shared memory; the caller
// synchronizes afterwards.
static __device__ __forceinline__ void mbb_stage_consts(
    const MbbShared& s, const float* __restrict__ consts,
    const MbbConfig& c) {
  const int w0 = 20 + c.nb + c.nb * c.nb, w1 = w0 + c.nb * c.nnodes;
  const int total = mbb_consts_floats(c.nb, c.nnodes);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float v = consts[i];
    s.lo[i] = (i >= w0 && i < w1) ? c.log_c2 - logf(v) : v;
  }
}

static __device__ __forceinline__ float mbb_log_expm1(float x) {
  const float xs = fminf(x, MBB_EXP_CUT);
  const float v = logf(expm1f(xs));
  return x < MBB_EXP_CUT ? v : x;
}

static __device__ __forceinline__ float mbb_log1mexp(float x) {
  const float xc = fmaxf(x, 1e-35f);
  return logf(-expm1f(-xc));
}

static __device__ __forceinline__ float mbb_xoexpm1x(float x) {
  const float xc = fminf(fmaxf(x, 1e-30f), MBB_EXP_CUT);
  const float v = xc / expm1f(xc);
  return x > MBB_EXP_CUT ? 0.0f : v;
}

// Unnormalized ln S of the pure greybody at u = ln x.
static __device__ __forceinline__ float mbb_log_s_grey(
    float log_x, float beta, float log_x0, int opthin) {
  const float x = expf(log_x);
  const float log_planck = 3.0f * log_x - mbb_log_expm1(x);
  if (opthin) return beta * log_x + log_planck;
  const float tau = expf(beta * (log_x - log_x0));
  return mbb_log1mexp(tau) + log_planck;
}

// g = d ln S / d ln x + alpha and its derivative g'.
static __device__ __forceinline__ void mbb_merge_g_gp(
    float log_x, float beta, float log_x0, float alpha, int opthin,
    float* g, float* gp) {
  const float x = expf(log_x);
  const float q = x / (-expm1f(-fmaxf(x, 1e-30f)));
  const float gp_planck = (-q) * ((1.0f - q) + x);
  if (opthin) {
    *g = ((3.0f + beta) - q) + alpha;
    *gp = gp_planck;
    return;
  }
  const float tau = expf(beta * (log_x - log_x0));
  const float ht = mbb_xoexpm1x(tau);
  const float tau_c = fminf(tau, MBB_TAU_BIG);
  *gp = (((beta * beta) * ht) * ((1.0f - tau_c) - ht)) + gp_planck;
  *g = ((3.0f + beta * ht) - q) + alpha;
}

// ln x_merge: bisection + bracket-clamped Newton on (2+a, 3+a+b).
static __device__ __forceinline__ float mbb_merge_log_x(
    float beta, float log_x0, float alpha, int opthin) {
  const float lo_arg = fmaxf(2.0f + alpha, 1e-3f);
  float a = logf(lo_arg);
  float b = logf(fmaxf((3.0f + alpha) + beta, 1.01f * lo_arg));
  float g, gp;
#pragma unroll
  for (int it = 0; it < MBB_MERGE_BISECT; ++it) {
    const float m = 0.5f * (a + b);
    mbb_merge_g_gp(m, beta, log_x0, alpha, opthin, &g, &gp);
    if (g > 0.0f) a = m; else b = m;
  }
  float u = 0.5f * (a + b);
#pragma unroll
  for (int it = 0; it < MBB_MERGE_NEWTON; ++it) {
    mbb_merge_g_gp(u, beta, log_x0, alpha, opthin, &g, &gp);
    u = fminf(fmaxf(u - g / fminf(gp, -1e-10f), a), b);
  }
  return u;
}

// ln S with the Wien-side power law blueward of the merge point.
static __device__ __forceinline__ float mbb_log_s(
    float log_x, float beta, float log_x0, float alpha, float u_m,
    float ls_m, const MbbConfig& c) {
  const float base = mbb_log_s_grey(log_x, beta, log_x0, c.opthin);
  if (c.noalpha) return base;
  return log_x > u_m ? ls_m - alpha * (log_x - u_m) : base;
}

// Log-probability of one full parameter vector th[5] (free slots filled,
// fixed slots at their template values).
static __device__ __forceinline__ float mbb_lnprob_eval(
    const float th[MBB_NPARAMS], const MbbConfig& c, const MbbShared& s) {
  bool inbox = true;
  float v[MBB_NPARAMS];
#pragma unroll
  for (int i = 0; i < MBB_NPARAMS; ++i) {
    inbox = inbox && (th[i] >= s.lo[i]) && (th[i] <= s.hi[i]);
    v[i] = fminf(fmaxf(th[i], s.lo[i]), s.hi[i]);
  }
  const float T = v[0], beta = v[1], lam0 = v[2], alpha = v[3];
  const float log_T = logf(T);
  const float log_x0 = (c.log_c2 - logf(lam0)) - log_T;

  float u_m = 0.0f, ls_m = 0.0f;
  if (!c.noalpha) {
    u_m = mbb_merge_log_x(beta, log_x0, alpha, c.opthin);
    ls_m = mbb_log_s_grey(u_m, beta, log_x0, c.opthin);
  }
  const float ls_norm =
      mbb_log_s(c.lxn_base - log_T, beta, log_x0, alpha, u_m, ls_m, c);
  const float log_fnorm = logf(v[4]);

  // Band fluxes as sum_k w_k S(node_k) (one unit-weight node per band in
  // point mode), residuals with the one-sided clamp on upper-limit bands
  // BEFORE whitening, then chi^2.
  float* delta = s.delta + threadIdx.x;     // band b at delta[b * blockDim.x]
  const int ds = blockDim.x;
  for (int b = 0; b < c.nb; ++b) {
    float model = 0.0f;
    for (int k = 0; k < c.nnodes; ++k) {
      const int r = b * c.nnodes + k;
      const float ls =
          mbb_log_s(s.lxw[r] - log_T, beta, log_x0, alpha, u_m, ls_m, c);
      model += s.wts[r] * expf((log_fnorm + ls) - ls_norm);
    }
    float d = model - s.flux[b];
    if (s.uplim[b] != 0.0f) d = fmaxf(d, 0.0f);
    delta[b * ds] = d;
  }
  float chi2 = 0.0f;
  for (int i = 0; i < c.nb; ++i) {
    float r;
    if (c.use_chol) {
      r = 0.0f;
      for (int j = 0; j <= i; ++j)
        r += s.whiten[i * c.nb + j] * delta[j * ds];
    } else {
      r = delta[i * ds] * s.whiten[i * c.nb + i];
    }
    chi2 += r * r;
  }
  float pri = 0.0f;
#pragma unroll
  for (int i = 0; i < MBB_NPARAMS; ++i) {
    const float dp = (th[i] - s.pmean[i]) * s.pisig[i];
    pri += dp * dp;
  }
  const float lnp = -0.5f * chi2 + -0.5f * pri;
  return inbox ? lnp : MBB_LNPROB_FLOOR;
}
