// K11 — BC6H two-region rows of the precision groups in a mask over given
// shape candidates, each candidate evaluated in full, as lane jobs: a CTA
// of four warps evaluates 32 blocks, one per lane.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_2region_pallas /
// _bc6h_2region_kernel (_k_bc6h_group), the two-region half of the
// BC6H_SHARED_FIT=False search, which the TPU launched once per precision
// group (rows {0} {1} {2,3,4} {5} {6,7,8} {9}: c_group_first /
// c_group_rows). Plain twin: bc6h._bc6h_2region_plain for one group, and
// for several bc6h._bc6h_2region_groups_plain (the groups' results folded
// in group order, the first taken as it is, then a strict `<`); the plain
// form of this decomposition is bc6h._bc6h_2region_jobs_plain +
// _bc6h_2region_jobs_fold_plain. Phases:
//   1. the CTA stages its 32 blocks' pixels once in shared memory (int16,
//      [48][32], PxT<32>);
//   2. a job is one (candidate rank k, group g) pair, job j = k + C * i
//      for the i-th group of the mask, on warp j % 4 (four candidates:
//      warp k runs candidate k over every group). A job is the full
//      quantized-domain evaluation of both regions at the group's endpoint
//      precision in one pass over the 16 pixels per step (eval_pair_q:
//      pixel i takes its own region's state and adds only to its sums,
//      which is what eval_subset_q computes for each region on its own),
//      the anchor swaps, then per row of the group its own delta fit and
//      emit. A job keeps its best row by `beats` on (error, position),
//      the position row * C + k: the twin's fold order over (row,
//      candidate), the rows of every group in the mask in row order;
//   3. warp 0 folds the four warps' bests of each block by `beats` and
//      stores once.
// Every job starts from (inf, past the last position), so a block on which
// no row fits gets the first position's words (the first group's first
// row's first candidate), as the TPU kernel gave each launch; the unshared
// search's fold (bc6h._fold_launches) never takes an infinite error.
// `beats` picks the least (error, position) whatever the order of the
// visits, so the winner is the twin's strict-`<` fold's.
//
// Bound: operations. A block needs 96 bytes of pixels and C shape bytes
// in and 20 bytes out, against about 10^4 elementwise operations per
// candidate and group (tests/test_torch_op_counts.py). The one-thread
// kernel this replaces (80 registers) was launched once per group, staged
// the pixels again in each launch, and ran each region of a candidate as a
// loop over all 16 pixels with the other region masked off: two passes
// where the work is one. Here one launch covers the groups, the pixels
// are staged once, a block's 24 jobs run on four warps, and a candidate's
// two regions cost one pass.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#include <climits>

#include "bc6h_common.cuh"

namespace bc6h {

constexpr int kTeam = 32;           // blocks a CTA, one per lane
constexpr int kWarps = kThreads / 32;
using PxJ = PxT<kTeam>;

// eval_subset_q of both regions of a candidate (m1: region 1's pixels) in
// one pass per step: q[region][end][channel], every entry of idx, each
// region's error into err[region]
template <int K, class P>
__device__ __forceinline__ void eval_pair_q(const P& px, unsigned m1,
                                            bool sgn, int prec_w,
                                            int q[2][2][3],
                                            unsigned long long& idx,
                                            float err[2]) {
  float e0[2][3], e1[2][3], cap[2][3];
  mag_cap_pair(px, m1, e0, e1, cap);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[s][0][c] = quantize((int)rintf(e0[s][c]), prec_w, sgn);
      q[s][1][c] = quantize((int)rintf(e1[s][c]), prec_w, sgn);
    }
  }
  idx = 0ull;
  palette_err_pair<K>(px, m1, q, prec_w, sgn, idx, err);
  int qb[2][2][3];
  unsigned long long idx_b = idx;
  float err_b[2];
#pragma unroll 1
  for (int r = 0; r < kRefitRounds; ++r) {
    ls_refit_pair<K, true>(px, m1, idx_b, cap, sgn, e0, e1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        qb[s][0][c] = quantize((int)rintf(e0[s][c]), prec_w, sgn);
        qb[s][1][c] = quantize((int)rintf(e1[s][c]), prec_w, sgn);
      }
    }
    palette_err_pair<K>(px, m1, qb, prec_w, sgn, idx_b, err_b);
  }
  const unsigned long long nm1 = nibble_mask(m1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (err_b[s] < err[s]) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[s][0][c] = qb[s][0][c];
        q[s][1][c] = qb[s][1][c];
      }
      const unsigned long long nm = s ? nm1 : ~nm1;
      idx = (idx & ~nm) | (idx_b & nm);
    }
    err[s] = fminf(err_b[s], err[s]);
  }
}

// Job (candidate rank k of n_cand, precision group g) of one block
template <class P>
__device__ __forceinline__ void group_job(const P& px, int shape, int k,
                                          int n_cand, int g, bool sgn,
                                          Best& best) {
  const unsigned m1 = bc7::subset1_mask(shape);
  const unsigned m0 = ~m1 & 0xFFFFu;
  const int a2 = bc7::c_pa2[shape] & 0xF;
  const int first = c_group_first[g];
  int q[2][2][3];
  unsigned long long idx;
  float err[2];
  eval_pair_q<8>(px, m1, sgn, c_info[first].prec_w, q, idx, err);
  float total = 0.0f;
  total = total + err[0];
  total = total + err[1];
  anchor_swap<8>(m0, 0, q[0][0], q[0][1], idx);
  anchor_swap<8>(m1, a2, q[1][0], q[1][1], idx);
#pragma unroll 1
  for (int row = first; row < first + c_group_rows[g]; ++row) {
    int f[2][2][3];
    const float e = transform_fit(row, sgn, q, f) ? total : INFINITY;
    const int order = row * n_cand + k;
    if (beats(best, e, order)) {
      best.err = e;
      best.order = order;
      best.w = emit(row, shape, f, idx, a2);
    }
  }
}

// the i-th set bit of a group mask
__device__ __forceinline__ int nth_group(unsigned groups, int i) {
#pragma unroll 1
  for (; i > 0; --i) groups &= groups - 1u;
  return __ffs(groups) - 1;
}

struct TwoRegionSmem {
  int16_t px[48 * kTeam];                       // [48][kTeam]
  float err[kWarps][kTeam];                     // each warp's best job
  int order[kWarps][kTeam];
  uint32_t w[kWarps][4][kTeam];
};

__global__ void __launch_bounds__(kThreads, 4)
    bc6h_2region_jobs_kernel(const int32_t* __restrict__ px_g,
                             const int32_t* __restrict__ s_blks,
                             float* __restrict__ err_out,
                             uint32_t* __restrict__ words, int nb,
                             int n_cand, unsigned groups, int sgn_i) {
  __shared__ TwoRegionSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kTeam, b = b0 + lane;
  const bool sgn = sgn_i != 0;
  // phase 1: pixel row r of block b0 + l into px[r][l]; a lane past the
  // last block stages zeros (its results are never stored)
#pragma unroll 4
  for (int i = tid; i < 48 * kTeam; i += kThreads) {
    const int r = i / kTeam, l = i % kTeam;
    sm.px[i] = b0 + l < nb ? (int16_t)px_g[(size_t)r * nb + b0 + l] : 0;
  }
  __syncthreads();
  // phase 2: the jobs of warp `warp`
  const PxJ px{sm.px + lane};
  Best best{INFINITY, INT_MAX, {0ull, 0ull}};
  const int n_jobs = __popc(groups) * n_cand;
#pragma unroll 1
  for (int j = warp; j < n_jobs; j += kWarps) {
    const int k = j % n_cand;
    const int shape = b < nb ? s_blks[(size_t)k * nb + b] : 0;
    group_job(px, shape, k, n_cand, nth_group(groups, j / n_cand), sgn,
              best);
  }
  sm.err[warp][lane] = best.err;
  sm.order[warp][lane] = best.order;
  sm.w[warp][0][lane] = (uint32_t)best.w.lo;
  sm.w[warp][1][lane] = (uint32_t)(best.w.lo >> 32);
  sm.w[warp][2][lane] = (uint32_t)best.w.hi;
  sm.w[warp][3][lane] = (uint32_t)(best.w.hi >> 32);
  __syncthreads();
  // phase 3: warp 0 folds the warps by (error, position)
  if (warp != 0 || b >= nb) return;
  Best fold{INFINITY, INT_MAX, {0ull, 0ull}};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float e = sm.err[w][lane];
    const int o = sm.order[w][lane];
    if (beats(fold, e, o)) {
      fold.err = e;
      fold.order = o;
      fold.w.lo = (unsigned long long)sm.w[w][0][lane]
                | ((unsigned long long)sm.w[w][1][lane] << 32);
      fold.w.hi = (unsigned long long)sm.w[w][2][lane]
                | ((unsigned long long)sm.w[w][3][lane] << 32);
    }
  }
  err_out[b] = fold.err;
  bc7::store_words(words, nb, b, fold.w);
}

}  // namespace bc6h

// groups: a mask of the precision groups 0-5 (bit g: group g, in row
// order); s_blks [n_cand, NB] int32 shapes 0..31. An empty mask, a bit
// past 5 or n_cand < 1 returns cudaErrorInvalidValue unlaunched.
extern "C" int bc6h_2region_launch(const void* px, const void* s_blks,
                                   void* err, void* words, int nb,
                                   int n_cand, int groups, int sgn,
                                   void* stream) {
  if (groups <= 0 || groups >= (1 << 6) || n_cand < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (nb + bc6h::kTeam - 1) / bc6h::kTeam;
  bc6h::bc6h_2region_jobs_kernel<<<grid, bc6h::kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)s_blks, (float*)err,
      (uint32_t*)words, nb, n_cand, (unsigned)groups, sgn);
  return (int)cudaGetLastError();
}
