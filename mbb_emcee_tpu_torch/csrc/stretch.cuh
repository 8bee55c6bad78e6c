// The stretch-move run of one ensemble inside one thread block, shared by
// the single-ensemble kernel (sampler.cu, K2) and the multi-source kernel
// (multifit.cu, K3): the Philox-4x32-10 generator, the uniform mapping, and
// the whole run loop over records and steps.
//
// Per step: half A updates against half B, then half B against the NEW
// half A, with
//   z = ((a-1) u0 + 1)^2 / a,  j = min(floor(u1 * half), half - 1),
//   accept iff ln u2 < (nfree-1) ln z + dlnp  and  lnp' > SUPPORT_FLOOR.
// Both halves' lnprob are recomputed at the start, as the TPU kernels do.
// Positions, lnprob and accept counts stay in dynamic shared memory for the
// whole run; the partner gather is an indexed shared-memory load; two
// barriers per step. No atomics: the same seed gives bitwise-identical
// chains.

#pragma once

#include "lnprob.cuh"

static __device__ __forceinline__ uint4 mbb_philox4x32_10(uint4 ctr,
                                                          uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// (bits >> 8) 2^-24 + 2^-25: the uniform mapping of the TPU kernel
// (pallas_sampler.py:171-172) and of ops/philox.py.
static __device__ __forceinline__ float mbb_bits_to_uniform(uint32_t b) {
  return (float)(b >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
}

// Bytes of dynamic shared memory mbb_stretch_body needs for `half` walkers
// per half-ensemble: positions [2][5][hp], lnprob [2][hp], accepts [2][hp].
// They follow the likelihood's region (mbb_lik_dyn_bytes) in the block.
static inline size_t mbb_stretch_dyn_bytes(int half) {
  const size_t hp = (size_t)(half + 31) / 32 * 32;
  return hp * (2 * MBB_NPARAMS + 2) * sizeof(float) + hp * 2 * sizeof(int);
}

// Bytes of dynamic shared memory of one block of K2 or K3 (one ensemble of
// 2 * half walkers): the likelihood's region for round_up(half, 32)
// threads, then the run's arrays.
static inline size_t mbb_run_dyn_bytes(int nb, int nnodes, int half) {
  return mbb_lik_dyn_bytes(nb, nnodes, (half + 31) / 32 * 32) +
         mbb_stretch_dyn_bytes(half);
}

// One ensemble's run by one block of blockDim.x = round_up(half, 32)
// threads. The caller has written the likelihood constants into `s` (the
// first barrier here publishes them); `dyn` is the block's shared memory
// past the likelihood's region (mbb_shared_end). The pointers are this
// ensemble's
// slices: pos_in/pos_out (nw, nfree), nacc_in/nacc_out and lnp_out (nw),
// uniforms (nrec, 6 * thin, half) or null for Philox mode, chain
// (nrec, nw, nfree), lnpchain (nrec, nw). Philox counter words:
// (step low 32 bits, h + 2 * source, lane, step high 32 bits) under the
// 64-bit `seed`, so source 0 draws the single-ensemble stream.
static __device__ __forceinline__ void mbb_stretch_body(
    const float* __restrict__ pos_in, const int* __restrict__ nacc_in,
    const float* __restrict__ uniforms, float* __restrict__ chain,
    float* __restrict__ lnpchain, float* __restrict__ pos_out,
    float* __restrict__ lnp_out, int* __restrict__ nacc_out, int half,
    int nrec, int thin, float a, unsigned long long seed,
    unsigned long long step0, uint32_t source, const MbbConfig& c,
    const MbbShared& s, float* dyn) {
  const int hp = blockDim.x;                 // half rounded up to 32
  float* pos = dyn;                          // [2][5][hp]
  float* lnp = pos + 2 * MBB_NPARAMS * hp;   // [2][hp]
  int* acc = (int*)(lnp + 2 * hp);           // [2][hp]
  const int k = threadIdx.x;
  const int nw = 2 * half;

  if (k < half) {
    for (int h = 0; h < 2; ++h) {
      const int w = h * half + k;
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i) {
        const int f = c.fmap[i];
        pos[(h * MBB_NPARAMS + i) * hp + k] =
            f >= 0 ? pos_in[(size_t)w * c.nfree + f] : c.tmpl[i];
      }
      acc[h * hp + k] = nacc_in[w];
    }
  }
  __syncthreads();
  if (k < half) {
    for (int h = 0; h < 2; ++h) {
      float th[MBB_NPARAMS];
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i)
        th[i] = pos[(h * MBB_NPARAMS + i) * hp + k];
      lnp[h * hp + k] = mbb_lnprob_eval(th, c, s);
    }
  }
  __syncthreads();

  const float am1 = a - 1.0f;
  const float dexp = (float)(c.nfree - 1);
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  for (int r = 0; r < nrec; ++r) {
    for (int t = 0; t < thin; ++t) {
      const unsigned long long step =
          step0 + (unsigned long long)r * thin + t;
      for (int h = 0; h < 2; ++h) {
        if (k < half) {
          float u0, u1, u2;
          if (uniforms != nullptr) {
            const float* ub =
                uniforms + ((size_t)r * 6 * thin + 6 * t + 3 * h) * half;
            u0 = ub[k];
            u1 = ub[half + k];
            u2 = ub[2 * half + k];
          } else {
            const uint4 x = mbb_philox4x32_10(
                make_uint4((uint32_t)step, (uint32_t)h + 2u * source,
                           (uint32_t)k, (uint32_t)(step >> 32)),
                key);
            u0 = mbb_bits_to_uniform(x.x);
            u1 = mbb_bits_to_uniform(x.y);
            u2 = mbb_bits_to_uniform(x.z);
          }
          const float zw = am1 * u0 + 1.0f;
          const float z = (zw * zw) / a;
          const int j = min((int)(u1 * (float)half), half - 1);
          float* act = pos + h * MBB_NPARAMS * hp;
          const float* pas = pos + (1 - h) * MBB_NPARAMS * hp;
          float prop[MBB_NPARAMS];
#pragma unroll
          for (int i = 0; i < MBB_NPARAMS; ++i) {
            const float pp = pas[i * hp + j];
            prop[i] = pp + z * (act[i * hp + k] - pp);
          }
          const float lp = mbb_lnprob_eval(prop, c, s);
          const float lr = dexp * logf(z) + lp - lnp[h * hp + k];
          if (logf(u2) < lr && lp > MBB_SUPPORT_FLOOR) {
#pragma unroll
            for (int i = 0; i < MBB_NPARAMS; ++i) act[i * hp + k] = prop[i];
            lnp[h * hp + k] = lp;
            acc[h * hp + k] += 1;
          }
        }
        __syncthreads();
      }
    }
    if (k < half) {
      for (int h = 0; h < 2; ++h) {
        const int w = h * half + k;
#pragma unroll
        for (int i = 0; i < MBB_NPARAMS; ++i) {
          const int f = c.fmap[i];
          if (f >= 0)
            chain[((size_t)r * nw + w) * c.nfree + f] =
                pos[(h * MBB_NPARAMS + i) * hp + k];
        }
        lnpchain[(size_t)r * nw + w] = lnp[h * hp + k];
      }
    }
  }
  if (k < half) {
    for (int h = 0; h < 2; ++h) {
      const int w = h * half + k;
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i) {
        const int f = c.fmap[i];
        if (f >= 0)
          pos_out[(size_t)w * c.nfree + f] =
              pos[(h * MBB_NPARAMS + i) * hp + k];
      }
      lnp_out[w] = lnp[h * hp + k];
      nacc_out[w] = acc[h * hp + k];
    }
  }
}
