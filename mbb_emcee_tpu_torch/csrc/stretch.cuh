// The stretch-move run of one ensemble, shared by the single-ensemble
// kernel (sampler.cu, K2) and the multi-source kernel (multifit.cu, K3): the
// Philox-4x32-10 generator, the uniform mapping, and the whole run loop over
// records and steps.
//
// Per step: half A updates against half B, then half B against the NEW
// half A, with
//   z = ((a-1) u0 + 1)^2 / a,  j = min(floor(u1 * half), half - 1),
//   accept iff ln u2 < (nfree-1) ln z + dlnp  and  lnp' > SUPPORT_FLOOR.
// Both halves' lnprob are recomputed at the start, as the TPU kernels do.
//
// Bound: two dependent half updates per step, each one lnprob deep (a
// latency-bound transcendental chain, lnprob.cuh), so a step costs the
// latency of one lnprob twice plus the barriers; bytes and the card's
// arithmetic rate are far from binding.
// Design: mbb_stretch_body<G, CLUSTER> runs the ensemble on a layout the
// caller picks (K2: ops/sampler_kernel.py plan_stretch_launch; K3, one
// ensemble per source: ops/multifit_kernel.py plan_multi_launch):
//   - G lanes of one warp per walker (G = 1: one thread per walker, the
//     lnprob of mbb_lnprob_eval; G in {4, 8, 16, 32}:
//     mbb_lnprob_eval_group), so a walker's lnprob latency is split over
//     its lanes;
//   - CLUSTER: the ensemble spread over the C blocks of a thread-block
//     cluster (Hopper), each block owning a slice of each half's walkers
//     on its own SM. Every block keeps a mirror of both halves' positions
//     and lnprob in its shared memory; after a half update each walker's
//     lanes write its new state into all C mirrors through distributed
//     shared memory, and the cluster's barrier takes the place of the block
//     barrier, so the partner gather stays a local shared-memory load.
// Positions, lnprob and accept counts stay in shared memory for the whole
// run; one barrier per half update, and what does not wait on it overlaps
// it: the next half update's uniforms are drawn between the cluster
// barrier's arrive and wait, and a record is written by the walker's lanes
// right after its last half update of the record. The Philox counter is
// keyed by the walker (never by thread or block), and each block writes
// its own walkers' chain records. No atomics: the same seed gives
// bitwise-identical chains on every layout in point mode.

#pragma once

#include <cooperative_groups.h>

#include "lnprob.cuh"

// What the K2 and K3 launches return when the card cannot hold one cluster
// of the plan (cudaOccupancyMaxActiveClusters finds no room).
#define MBB_ERR_CLUSTER_UNPLACEABLE (-1)

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

// Bytes of dynamic shared memory of the run's arrays for `half` walkers per
// half-ensemble: positions [2][5][hp], lnprob [2][hp], accepts [2][hp]
// (hp = half rounded up to 32; with a cluster each block holds this mirror
// of the whole ensemble). They follow the likelihood's region
// (mbb_lik_dyn_bytes) in the block.
static inline size_t mbb_stretch_dyn_bytes(int half) {
  const size_t hp = (size_t)(half + 31) / 32 * 32;
  return hp * (2 * MBB_NPARAMS + 2) * sizeof(float) + hp * 2 * sizeof(int);
}

// Bytes of dynamic shared memory of one block of K2 or K3 of `threads`
// threads (one ensemble of 2 * half walkers): the likelihood's region for
// those threads, then the run's arrays. The G=1, C=1 layout of either runs
// round_up(half, 32) threads.
static inline size_t mbb_run_dyn_bytes(int nb, int nnodes, int half,
                                       int threads) {
  return mbb_lik_dyn_bytes(nb, nnodes, threads) + mbb_stretch_dyn_bytes(half);
}

// The lnprob of th[5] on this thread's layout. With G lanes per walker the
// group synchronizes on the way out, so every lane has finished reading the
// walker's old state before any lane publishes the new one.
template <int G>
static __device__ __forceinline__ float mbb_lnprob_on(
    const float th[MBB_NPARAMS], const MbbConfig& c, const MbbShared& s,
    int lane) {
  if constexpr (G == 1) {
    return mbb_lnprob_eval(th, c, s);
  } else {
    const float lp = mbb_lnprob_eval_group<G>(th, c, s, lane);
    __syncwarp(mbb_group_mask<G>());
    return lp;
  }
}

// The barrier between two half updates: the cluster's, with `between()`
// done while it completes (after this thread's arrival, whose release
// publishes its distributed-shared-memory writes, and before its wait);
// or the block's, where `between` is not run. `between` must not touch
// another block's shared memory.
template <bool CLUSTER, typename F>
static __device__ __forceinline__ void mbb_run_barrier(F&& between) {
  if constexpr (CLUSTER) {
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
    between();
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

template <bool CLUSTER>
static __device__ __forceinline__ void mbb_run_barrier() {
  mbb_run_barrier<CLUSTER>([] {});
}

// The uniforms (z, partner, accept) of walker k's half-h update at step t
// of record r: the external rows (nrec, 6 * thin, half), or the Philox
// stream at counter (step low 32 bits, h + 2 * source, k, step high 32
// bits).
static __device__ __forceinline__ void mbb_draw(
    const float* __restrict__ uniforms, int half, int k, int thin,
    unsigned long long step0, uint32_t source, uint2 key, int r, int t,
    int h, float u[3]) {
  if (uniforms != nullptr) {
    const float* ub =
        uniforms + ((size_t)r * 6 * thin + 6 * t + 3 * h) * half;
    u[0] = ub[k];
    u[1] = ub[half + k];
    u[2] = ub[2 * half + k];
  } else {
    const unsigned long long step = step0 + (unsigned long long)r * thin + t;
    const uint4 x = mbb_philox4x32_10(
        make_uint4((uint32_t)step, (uint32_t)h + 2u * source, (uint32_t)k,
                   (uint32_t)(step >> 32)),
        key);
    u[0] = mbb_bits_to_uniform(x.x);
    u[1] = mbb_bits_to_uniform(x.y);
    u[2] = mbb_bits_to_uniform(x.z);
  }
}

// Write walker k's state (position column and lnprob) of half h into the
// ensemble mirror of every block: with a cluster, lanes take the blocks in
// turn through distributed shared memory; otherwise lane 0 writes the
// block's own.
template <int G, bool CLUSTER>
static __device__ __forceinline__ void mbb_publish(
    float* pos, float* lnp, int hp, int h, int k, int lane,
    const float th[MBB_NPARAMS], float lp) {
  if constexpr (CLUSTER) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const int nrank = (int)cl.num_blocks();
    for (int r = lane; r < nrank; r += G) {
      float* rpos = cl.map_shared_rank(pos, r);
      float* rlnp = cl.map_shared_rank(lnp, r);
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i)
        rpos[(h * MBB_NPARAMS + i) * hp + k] = th[i];
      rlnp[h * hp + k] = lp;
    }
  } else {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i)
        pos[(h * MBB_NPARAMS + i) * hp + k] = th[i];
      lnp[h * hp + k] = lp;
    }
  }
}

// Write walker k's state of half h from this block's mirror into chain
// record r: value i (the 5 parameters, then lnprob) by lane i mod G.
template <int G>
static __device__ __forceinline__ void mbb_write_record(
    float* __restrict__ chain, float* __restrict__ lnpchain,
    const float* pos, const float* lnp, int hp, int h, int k, int half,
    int r, int lane, const MbbConfig& c) {
  const int nw = 2 * half, w = h * half + k;
#pragma unroll
  for (int i = 0; i < MBB_NPARAMS; ++i) {
    const int f = c.fmap[i];
    if (lane == i % G && f >= 0)
      chain[((size_t)r * nw + w) * c.nfree + f] =
          pos[(h * MBB_NPARAMS + i) * hp + k];
  }
  if (lane == MBB_NPARAMS % G)
    lnpchain[(size_t)r * nw + w] = lnp[h * hp + k];
}

// One ensemble's run. Thread t of block `rank` (the block's rank in its
// cluster, 0 without one) is lane t % G of walker k = rank * wpb + t / G of
// each half, for wpb walkers per block that the launch plans (one block:
// wpb >= half; the G=1, C=1 layout: wpb = blockDim.x = round_up(half, 32),
// which the launches must keep); a group with k >= half idles. The cluster's
// first barrier also makes sure every block runs before any writes into
// another's mirror, and its last one that none leaves while another still
// writes into it. The caller has written the likelihood constants
// into `s` (the first barrier here publishes them); `dyn` is the block's
// shared memory past the likelihood's region (mbb_shared_end). The pointers
// are this ensemble's slices: pos_in/pos_out (nw, nfree), nacc_in/nacc_out
// and lnp_out (nw), uniforms (nrec, 6 * thin, half) or null for Philox
// mode, chain (nrec, nw, nfree), lnpchain (nrec, nw). Philox counter words:
// (step low 32 bits, h + 2 * source, walker k, step high 32 bits) under the
// 64-bit `seed`, so source 0 draws the single-ensemble stream, and every
// layout of K3 draws the same streams.
template <int G, bool CLUSTER>
static __device__ __forceinline__ void mbb_stretch_body(
    const float* __restrict__ pos_in, const int* __restrict__ nacc_in,
    const float* __restrict__ uniforms, float* __restrict__ chain,
    float* __restrict__ lnpchain, float* __restrict__ pos_out,
    float* __restrict__ lnp_out, int* __restrict__ nacc_out, int half,
    int wpb, int nrec, int thin, float a, unsigned long long seed,
    unsigned long long step0, uint32_t source, const MbbConfig& c,
    const MbbShared& s, float* dyn) {
  // half rounded up to 32: in one block of one thread per walker that is
  // blockDim.x, which costs no register
  const int hp = (G == 1 && !CLUSTER) ? (int)blockDim.x
                                      : (half + 31) / 32 * 32;
  float* pos = dyn;                          // [2][5][hp]
  float* lnp = pos + 2 * MBB_NPARAMS * hp;   // [2][hp]
  int* acc = (int*)(lnp + 2 * hp);           // [2][hp]
  int rank = 0;
  if constexpr (CLUSTER)
    rank = (int)cooperative_groups::this_cluster().block_rank();
  const int lane = (int)threadIdx.x % G;
  const int k = rank * wpb + (int)threadIdx.x / G;
  const bool mine = (int)threadIdx.x / G < wpb && k < half;

  // Every block mirrors the whole ensemble's positions.
  for (int q = threadIdx.x; q < half; q += blockDim.x) {
    for (int h = 0; h < 2; ++h) {
      const int w = h * half + q;
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i) {
        const int f = c.fmap[i];
        pos[(h * MBB_NPARAMS + i) * hp + q] =
            f >= 0 ? pos_in[(size_t)w * c.nfree + f] : c.tmpl[i];
      }
      acc[h * hp + q] = nacc_in[w];
    }
  }
  mbb_run_barrier<CLUSTER>();
  if (mine) {
    for (int h = 0; h < 2; ++h) {
      float th[MBB_NPARAMS];
#pragma unroll
      for (int i = 0; i < MBB_NPARAMS; ++i)
        th[i] = pos[(h * MBB_NPARAMS + i) * hp + k];
      const float lp = mbb_lnprob_on<G>(th, c, s, lane);
      mbb_publish<G, CLUSTER>(pos, lnp, hp, h, k, lane, th, lp);
    }
  }
  mbb_run_barrier<CLUSTER>();

  const float am1 = a - 1.0f;
  const float dexp = (float)(c.nfree - 1);
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  // With a cluster, the next half update's uniforms are drawn while the
  // barrier completes and a record is written right after the walker's
  // last half update of it, so both overlap the cluster's barrier. In one
  // block the barrier is short and that order measured slower: the draw
  // opens each half update and the records follow the record's last step.
  float u[3];
  if (CLUSTER && mine && nrec > 0)
    mbb_draw(uniforms, half, k, thin, step0, source, key, 0, 0, 0, u);
  for (int r = 0; r < nrec; ++r) {
    for (int t = 0; t < thin; ++t) {
      for (int h = 0; h < 2; ++h) {
        if (mine) {
          if constexpr (!CLUSTER)
            mbb_draw(uniforms, half, k, thin, step0, source, key, r, t, h,
                     u);
          const float zw = am1 * u[0] + 1.0f;
          const float z = (zw * zw) / a;
          const int j = min((int)(u[1] * (float)half), half - 1);
          const float* act = pos + h * MBB_NPARAMS * hp;
          const float* pas = pos + (1 - h) * MBB_NPARAMS * hp;
          float prop[MBB_NPARAMS];
#pragma unroll
          for (int i = 0; i < MBB_NPARAMS; ++i) {
            const float pp = pas[i * hp + j];
            prop[i] = pp + z * (act[i * hp + k] - pp);
          }
          // G > 1: read before the group synchronizes at the end of the
          // lnprob (a lane may publish right after it); G = 1: after it,
          // so the value does not occupy a register through the lnprob
          float lnp_old = 0.0f;
          if constexpr (G > 1) lnp_old = lnp[h * hp + k];
          const float lp = mbb_lnprob_on<G>(prop, c, s, lane);
          if constexpr (G == 1) lnp_old = lnp[h * hp + k];
          const float lr = dexp * logf(z) + lp - lnp_old;
          if (logf(u[2]) < lr && lp > MBB_SUPPORT_FLOOR) {
            mbb_publish<G, CLUSTER>(pos, lnp, hp, h, k, lane, prop, lp);
            if (lane == 0) acc[h * hp + k] += 1;
          }
          if (CLUSTER && t + 1 == thin) {
            if constexpr (G > 1) __syncwarp(mbb_group_mask<G>());
            mbb_write_record<G>(chain, lnpchain, pos, lnp, hp, h, k, half,
                                r, lane, c);
          }
        }
        const int nh = 1 - h;
        const int nt = h == 0 ? t : (t + 1 == thin ? 0 : t + 1);
        const int nr = h == 1 && t + 1 == thin ? r + 1 : r;
        mbb_run_barrier<CLUSTER>([&] {
          if (mine && nr < nrec)
            mbb_draw(uniforms, half, k, thin, step0, source, key, nr, nt,
                     nh, u);
        });
      }
    }
    if (!CLUSTER && mine) {
      for (int h = 0; h < 2; ++h)
        mbb_write_record<G>(chain, lnpchain, pos, lnp, hp, h, k, half, r,
                            lane, c);
    }
  }
  if (mine && lane == 0) {
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
