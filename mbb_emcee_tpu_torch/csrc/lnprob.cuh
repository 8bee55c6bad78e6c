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
// ln S per band node and for the normalization): bound by the latency of
// the dependent fp32 and special-function chain, not by bytes (the
// constants are a few KB and live in shared memory, each walker reads 5
// floats) and not by the card's rate (~2,300 fp32 ops per walker in point
// mode, counting a libdevice exp/expm1/log as 20 and a division as 10).
// Design: every per-band constant is staged once per block into dynamic
// shared memory sized at launch for this likelihood's band and node
// counts (no compile-time cap), ln(wavelength) terms precomputed there,
// and each thread keeps nb residual (or partial-sum) slots there. Two
// layouts of one walker's evaluation, each used by K1, K2 and K3:
//   - mbb_lnprob_eval: one thread per walker (the G=1 layouts), the whole
//     chain serial in that thread.
//   - mbb_lnprob_eval_group<G>: G lanes of one warp per walker, to shorten
//     the chain. From 8 lanes the 6 bisections run as 2 rounds of a
//     7-node tree: each round forms the 3 levels' midpoints in the
//     bisection's own operations, evaluates the slope at node j on lane j,
//     and walks the tree on the signs of g, which is the sequential bracket
//     bit for bit. On 4 lanes (K3's one-wave layout, where registers allow
//     no more lanes, and K1's) they run as 3 rounds of a 3-node tree.
//     The rounds evaluate the slope alone, on every lane alike: a round that
//     also evaluated ln S at band nodes took about as long as the 6
//     sequential bisections. A lane's first node (node i on lane i mod G;
//     node 0 is the normalization point) is evaluated in the Newton steps'
//     basic block, so its chain overlaps theirs; only the Wien-side select
//     waits for the merge point. Per-band partial sums combine by
//     __shfl_xor_sync in a fixed tree order, 4 bands at a time, and every
//     lane forms the same residuals, chi^2 in band order and prior. With one
//     node per band (point mode) no sum is reordered, so the result is
//     bitwise that of mbb_lnprob_eval.
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

// Box check and clip of th[5] against the staged limits.
static __device__ __forceinline__ void mbb_box(
    const float th[MBB_NPARAMS], const MbbShared& s, bool* inbox,
    float v[MBB_NPARAMS]) {
  bool in = true;
#pragma unroll
  for (int i = 0; i < MBB_NPARAMS; ++i) {
    in = in && (th[i] >= s.lo[i]) && (th[i] <= s.hi[i]);
    v[i] = fminf(fmaxf(th[i], s.lo[i]), s.hi[i]);
  }
  *inbox = in;
}

// chi^2 of the nb residuals delta[b * ds], whitened by L^-1 or 1/sigma,
// summed in band order.
static __device__ __forceinline__ float mbb_chi2(
    const float* delta, int ds, const MbbConfig& c, const MbbShared& s) {
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
  return chi2;
}

// lnprob from chi^2, the Gaussian priors, and the floor outside the box.
static __device__ __forceinline__ float mbb_prior_lnp(
    const float th[MBB_NPARAMS], bool inbox, float chi2, const MbbShared& s) {
  float pri = 0.0f;
#pragma unroll
  for (int i = 0; i < MBB_NPARAMS; ++i) {
    const float dp = (th[i] - s.pmean[i]) * s.pisig[i];
    pri += dp * dp;
  }
  const float lnp = -0.5f * chi2 + -0.5f * pri;
  return inbox ? lnp : MBB_LNPROB_FLOOR;
}

// Log-probability of one full parameter vector th[5] (free slots filled,
// fixed slots at their template values).
static __device__ __forceinline__ float mbb_lnprob_eval(
    const float th[MBB_NPARAMS], const MbbConfig& c, const MbbShared& s) {
  bool inbox;
  float v[MBB_NPARAMS];
  mbb_box(th, s, &inbox, v);
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
  return mbb_prior_lnp(th, inbox, mbb_chi2(delta, ds, c, s), s);
}

// Lane mask of this thread's group of G lanes (G divides 32; a group is G
// consecutive lanes of one warp).
template <int G>
static __device__ __forceinline__ unsigned mbb_group_mask() {
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(unsigned)(G - 1));
}

// The normalization point (item 0) or band node i - 1 (item i >= 1).
static __device__ __forceinline__ float mbb_item_log_x(
    int i, float log_T, const MbbConfig& c, const MbbShared& s) {
  return i == 0 ? c.lxn_base - log_T : s.lxw[i - 1] - log_T;
}

// The Wien-side select of mbb_log_s on an already evaluated grey ln S.
static __device__ __forceinline__ float mbb_wien_select(
    float base, float log_x, float alpha, float u_m, float ls_m,
    const MbbConfig& c) {
  if (c.noalpha) return base;
  return log_x > u_m ? ls_m - alpha * (log_x - u_m) : base;
}

// Levels of the merge solve's bisection tree on G lanes: 3 (7 nodes, 2
// rounds) from 8 lanes, 2 (3 nodes, 3 rounds) on 4.
template <int G>
struct MbbMergeTree {
  static constexpr int levels = G >= 8 ? 3 : 2;
  static constexpr int rounds = MBB_MERGE_BISECT / levels;
};

// Log-probability of th[5] evaluated by the G lanes of this thread's group
// (lane in [0, G); G in {4, 8, 16, 32}); every lane returns it. The
// thread's nb band slots are s.delta[b * blockDim.x + threadIdx.x]. Items
// are the normalization point (0) and the nb * nnodes band nodes (1 + r);
// item i is on lane i mod G. An item's term goes into its band's slot on
// the lane that evaluated it (in item order), and the slots combine over
// the group by __shfl_xor_sync in a fixed order.
template <int G>
static __device__ __forceinline__ float mbb_lnprob_eval_group(
    const float th[MBB_NPARAMS], const MbbConfig& c, const MbbShared& s,
    int lane) {
  static_assert(G == 4 || G == 8 || G == 16 || G == 32, "G lanes per walker");
  static_assert(MBB_MERGE_BISECT == 6, "6 bisections: 2 x 3 or 3 x 2");
  constexpr int kLevels = MbbMergeTree<G>::levels;
  const unsigned mask = mbb_group_mask<G>();
  bool inbox;
  float v[MBB_NPARAMS];
  mbb_box(th, s, &inbox, v);
  const float T = v[0], beta = v[1], lam0 = v[2], alpha = v[3];
  const float log_T = logf(T);
  const float log_x0 = (c.log_c2 - logf(lam0)) - log_T;
  const int nitems = c.nb * c.nnodes + 1;
  float* slot = s.delta + threadIdx.x;   // band b at slot[b * blockDim.x]
  const int ds = blockDim.x;
  for (int b = 0; b < c.nb; ++b) slot[b * ds] = 0.0f;

  // Item i is on lane i mod G. A lane's first item's grey ln S does not
  // depend on the merge point: it is evaluated beside the Newton steps, in
  // one basic block, so the two chains overlap.
  const bool has0 = lane < nitems;
  const float lx0 = mbb_item_log_x(has0 ? lane : 0, log_T, c, s);
  float ls0, u_m = 0.0f, ls_m = 0.0f;
  if (!c.noalpha) {
    const float lo_arg = fmaxf(2.0f + alpha, 1e-3f);
    float a = logf(lo_arg);
    float b = logf(fmaxf((3.0f + alpha) + beta, 1.01f * lo_arg));
#pragma unroll
    for (int round = 0; round < MbbMergeTree<G>::rounds; ++round) {
      // The midpoints of kLevels bisection levels in the bisection's own
      // operations (level 1: n0; level 2: n1, n2; level 3: n3-n6), the
      // slope at node j on lane j (lanes past the last node repeat node 0).
      const float n0 = 0.5f * (a + b);
      const float n1 = 0.5f * (a + n0);
      const float n2 = 0.5f * (n0 + b);
      if constexpr (kLevels == 2) {
        const float p = lane == 1 ? n1 : lane == 2 ? n2 : n0;
        float g, gp;
        mbb_merge_g_gp(p, beta, log_x0, alpha, c.opthin, &g, &gp);
        float gt[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) gt[j] = __shfl_sync(mask, g, j, G);
        const bool b0 = gt[0] > 0.0f;
        if (b0) a = n0; else b = n0;
        const float m2 = b0 ? n2 : n1;
        const bool b1 = (b0 ? gt[2] : gt[1]) > 0.0f;
        if (b1) a = m2; else b = m2;
        continue;
      }
      const float n3 = 0.5f * (a + n1);
      const float n4 = 0.5f * (n1 + n0);
      const float n5 = 0.5f * (n0 + n2);
      const float n6 = 0.5f * (n2 + b);
      const float p = lane == 1 ? n1 : lane == 2 ? n2 : lane == 3 ? n3
                    : lane == 4 ? n4 : lane == 5 ? n5 : lane == 6 ? n6 : n0;
      float g, gp;
      mbb_merge_g_gp(p, beta, log_x0, alpha, c.opthin, &g, &gp);
      float gt[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) gt[j] = __shfl_sync(mask, g, j, G);
      // Walk the tree as the sequential bisection would: a = m if g > 0.
      const bool b0 = gt[0] > 0.0f;
      if (b0) a = n0; else b = n0;
      const float m2 = b0 ? n2 : n1;
      const bool b1 = (b0 ? gt[2] : gt[1]) > 0.0f;
      if (b1) a = m2; else b = m2;
      const int i3 = 2 * (int)b0 + (int)b1;
      const float m3 = i3 == 0 ? n3 : i3 == 1 ? n4 : i3 == 2 ? n5 : n6;
      const float g3 = i3 == 0 ? gt[3] : i3 == 1 ? gt[4]
                     : i3 == 2 ? gt[5] : gt[6];
      if (g3 > 0.0f) a = m3; else b = m3;
    }
    ls0 = mbb_log_s_grey(lx0, beta, log_x0, c.opthin);
    float u = 0.5f * (a + b);
    float g, gp;
#pragma unroll
    for (int it = 0; it < MBB_MERGE_NEWTON; ++it) {
      mbb_merge_g_gp(u, beta, log_x0, alpha, c.opthin, &g, &gp);
      u = fminf(fmaxf(u - g / fminf(gp, -1e-10f), a), b);
    }
    u_m = u;
    ls_m = mbb_log_s_grey(u_m, beta, log_x0, c.opthin);
  } else {
    ls0 = mbb_log_s_grey(lx0, beta, log_x0, c.opthin);
  }
  const float sel0 = mbb_wien_select(ls0, lx0, alpha, u_m, ls_m, c);
  const float ls_norm = __shfl_sync(mask, sel0, 0, G);   // item 0, lane 0
  const float log_fnorm = logf(v[4]);

  // Band fluxes: each lane adds its items' w_k S(node_k) into its slots.
  if (has0 && lane >= 1) {
    const int r = lane - 1;
    slot[(r / c.nnodes) * ds] +=
        s.wts[r] * expf((log_fnorm + sel0) - ls_norm);
  }
  for (int i = G + lane; i < nitems; i += G) {
    const int r = i - 1;
    const float lx = s.lxw[r] - log_T;
    const float ls = mbb_wien_select(
        mbb_log_s_grey(lx, beta, log_x0, c.opthin), lx, alpha, u_m, ls_m, c);
    slot[(r / c.nnodes) * ds] += s.wts[r] * expf((log_fnorm + ls) - ls_norm);
  }
  // Combine the group's slots, 4 bands at a time (every lane ends with the
  // same sums), then the residuals with the one-sided clamp on upper-limit
  // bands; with diagonal whitening chi^2 is summed here, in band order.
  float chi2 = 0.0f;
  for (int b0 = 0; b0 < c.nb; b0 += 4) {
    float model[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      model[q] = b0 + q < c.nb ? slot[(b0 + q) * ds] : 0.0f;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        model[q] += __shfl_xor_sync(mask, model[q], off, G);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + q;
      if (b < c.nb) {
        float d = model[q] - s.flux[b];
        if (s.uplim[b] != 0.0f) d = fmaxf(d, 0.0f);
        if (c.use_chol) {
          slot[b * ds] = d;
        } else {
          const float r = d * s.whiten[b * c.nb + b];
          chi2 += r * r;
        }
      }
    }
  }
  if (c.use_chol) chi2 = mbb_chi2(slot, ds, c, s);
  return mbb_prior_lnp(th, inbox, chi2, s);
}
