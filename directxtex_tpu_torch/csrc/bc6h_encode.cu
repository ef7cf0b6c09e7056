// K5 — the whole BC6H shared-fit search, as lane jobs: a CTA of four
// warps searches 32 blocks, one per lane.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_encode_pallas /
// _bc6h_all_kernel (BC6H_SHARED_FIT, keep-better off). Plain twin:
// bc6h._bc6h_search_plain (the JAX package's jnp search), step for step
// and in the same operation order:
//   - rows 10-13: one precision-free float trajectory over the block
//     (min/max box, float assignment at 16 levels, 3 LS rounds), then per
//     row a quantize + exact rescore, one quantized LS refit below 11 bits
//     of endpoint precision, anchor swap, delta fit and emit;
//   - off-axis ranking of the 32 two-region shapes (axis_w = 0, three
//     power iterations) and the top 4 by (estimate, shape) — rank_slice,
//     bc6h_shapes.cuh;
//   - per candidate, one trajectory per region, then per precision group
//     (rows {0} {1} {2,3,4} {5} {6,7,8} {9}) one rescore shared by the
//     group's rows, each of which applies its own delta fit and emit.
// The twin folds rows 10-13, then rows 0-9 with candidates in rank order,
// strict `<`.
//
// Design. A block's search is a set of jobs (bc6h._bc6h_search_jobs_plain
// is their plain form):
//   - the one-region job: rows 10-13 off the block's trajectory;
//   - candidate job k (k = 0..3): candidate rank k's two trajectories and
//     its 6 precision groups.
// Phase 1, the CTA stages its 32 blocks' pixels once in shared memory
// (int16, [48][32], PxT<32>). Phase 2, warps 0-2 rank shapes w, w + 3,
// ... of every block (rank_slice) into local top-4 lists, while warp 3
// runs the one-region jobs. Phase 3, warp k merges the three lists by
// (estimate, shape), the lower shape first on an equal estimate, which
// gives a one-thread ranking's cand[k] exactly (merged_candidate:
// each estimate is computed by the same operations whichever warp
// computes it), and runs candidate job k.
// A candidate job scores both regions in one pass over the 16 pixels
// (shared_fit_pair, rescore_pair with palette_err_pair): pixel i takes
// its own region's state and adds only to that region's sums, in pixel
// order, which is what the one-region loops compute (they skip the other
// region's pixels, or weigh them by an exact zero in the LS sums), so
// each region's endpoints, indices and errors are those loops'. Each job
// keeps its best row by (error, position in the twin's fold order) with
// `beats`, emitting on each improvement, and leaves (error, position,
// words) in its slot; phase 4, warp 0 folds each
// block's five slots with `beats` and stores once. `beats` picks the
// least (error, position), whatever the order of the visits, so the
// winner is the twin's strict-`<` fold's.
//
// Bound: operations. A block needs 96 bytes in (48 halves; read here as
// int32) and 16 out, against about 174,000 elementwise operations of the
// search (tests/test_torch_op_counts.py). The one-thread kernel (96
// registers, 1.16 waves of CTAs on config 4) ran a block's 1 + 4 jobs in
// series, and each region loop of a warp ran for the union of its lanes'
// pixel slots, since the lanes' shapes differ: two full passes for the
// two regions. Here a block's jobs run on four warps, 5 x 98,304 jobs on
// config 4, and a candidate's two regions cost one pass.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#include "bc6h_shapes.cuh"

namespace bc6h {

constexpr int kRankWarps = 3;       // warps of the ranking slices
constexpr int kJobs = 5;            // one-region job, candidate jobs 0-3
using PxG = PxT<kGroup>;

// Float-endpoint palette assignment of the masked pixels
// (_bc6h_palette_err_f with score=False)
template <int K, class P>
__device__ __forceinline__ unsigned long long float_assign(const P& px,
                                                           unsigned msk,
                                                           const float e0[3],
                                                           const float e1[3]) {
  float e[3];
  float span = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e[c] = e1[c] - e0[c];
    span = span + e[c] * e[c];
  }
  const float s64 = 64.0f / (span > 0.0f ? span : 1.0f);
  unsigned long long idx = 0ull;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    if (!((msk >> i) & 1u)) continue;
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) dot = dot + (px.f(c, i) - e0[c]) * e[c];
    const float p64 = fminf(fmaxf(dot * s64, 0.0f), 64.0f);
    const float kf = fminf(fmaxf(rintf(p64 * (float)((K - 1) / 64.0)), 0.0f),
                           K - 1.0f);
    const float wk = pal_weight_f<K>(kf);
    const float wkp = pal_weight_f<K>(fminf(kf + 1.0f, K - 1.0f));
    const float wkm = pal_weight_f<K>(fmaxf(kf - 1.0f, 0.0f));
    const bool up = kf < K - 1 && 2.0f * p64 > wk + wkp;
    const bool dn = kf > 0 && 2.0f * p64 < wk + wkm;
    idx_set(idx, i, (int)(up ? kf + 1.0f : (dn ? kf - 1.0f : kf)));
  }
  return idx;
}

// One precision-free fit trajectory of a subset (_bc6h_shared_fit)
template <int K, class P>
__device__ __forceinline__ void shared_fit(const P& px, unsigned msk,
                                           bool sgn, float e0[3],
                                           float e1[3]) {
  float cap[3];
  mag_cap(px, msk, e0, e1, cap);
  unsigned long long idx = float_assign<K>(px, msk, e0, e1);
#pragma unroll 1
  for (int r = 0; r < 3; ++r) {   // BC6H_SHARED_ROUNDS
    ls_refit<K, false>(px, msk, idx, cap, sgn, e0, e1);
    if (r < 2) idx = float_assign<K>(px, msk, e0, e1);
  }
}

// One subset of _bc6h_group_rescore: quantize the trajectory endpoints at
// precision prec_w, rescore exactly, and below BC6H_GROUP_REFIT_MINPREC
// one quantized-domain LS round kept where it scores lower. Writes the
// subset's pixels of idx; returns the subset error.
template <int K, class P>
__device__ __forceinline__ float rescore_subset(const P& px, unsigned msk,
                                                bool sgn, int prec_w,
                                                const float e0[3],
                                                const float e1[3], int q0[3],
                                                int q1[3],
                                                unsigned long long& idx) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q0[c] = quantize((int)rintf(e0[c]), prec_w, sgn);
    q1[c] = quantize((int)rintf(e1[c]), prec_w, sgn);
  }
  float err = palette_err_q<K>(px, msk, q0, q1, prec_w, sgn, idx);
  if (prec_w < 11) {
    float mi[3], ma[3], cap[3], r0[3], r1[3];
    mag_cap(px, msk, mi, ma, cap);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r0[c] = e0[c];
      r1[c] = e1[c];
    }
    ls_refit<K, true>(px, msk, idx, cap, sgn, r0, r1);
    int qr0[3], qr1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      qr0[c] = quantize((int)rintf(r0[c]), prec_w, sgn);
      qr1[c] = quantize((int)rintf(r1[c]), prec_w, sgn);
    }
    unsigned long long idx_r = idx;
    const float err_r = palette_err_q<K>(px, msk, qr0, qr1, prec_w, sgn,
                                         idx_r);
    if (err_r < err) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q0[c] = qr0[c];
        q1[c] = qr1[c];
      }
      idx = idx_r;
    }
    err = fminf(err_r, err);
  }
  return err;
}

// ---------------------------------------------------------------------------
// Both regions of a two-region candidate in one pass over the 16 pixels:
// pixel i takes region (m1 >> i) & 1's state and adds only to its sums
// ---------------------------------------------------------------------------
// float_assign of each region; writes every entry of the plane
template <int K, class P>
__device__ __forceinline__ unsigned long long float_assign_pair(
    const P& px, unsigned m1, const float e0[2][3], const float e1[2][3]) {
  float e[2][3], s64[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float span = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[s][c] = e1[s][c] - e0[s][c];
      span = span + e[s][c] * e[s][c];
    }
    s64[s] = 64.0f / (span > 0.0f ? span : 1.0f);
  }
  unsigned long long idx = 0ull;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const bool s1 = (m1 >> i) & 1u;
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dot = dot + (px.f(c, i) - (s1 ? e0[1][c] : e0[0][c]))
                  * (s1 ? e[1][c] : e[0][c]);
    const float p64 = fminf(fmaxf(dot * (s1 ? s64[1] : s64[0]), 0.0f),
                            64.0f);
    const float kf = fminf(fmaxf(rintf(p64 * (float)((K - 1) / 64.0)), 0.0f),
                           K - 1.0f);
    const float wk = pal_weight_f<K>(kf);
    const float wkp = pal_weight_f<K>(fminf(kf + 1.0f, K - 1.0f));
    const float wkm = pal_weight_f<K>(fmaxf(kf - 1.0f, 0.0f));
    const bool up = kf < K - 1 && 2.0f * p64 > wk + wkp;
    const bool dn = kf > 0 && 2.0f * p64 < wk + wkm;
    idx_set(idx, i, (int)(up ? kf + 1.0f : (dn ? kf - 1.0f : kf)));
  }
  return idx;
}

// shared_fit of each region
template <int K, class P>
__device__ __forceinline__ void shared_fit_pair(const P& px, unsigned m1,
                                                bool sgn, float e0[2][3],
                                                float e1[2][3]) {
  float cap[2][3];
  mag_cap_pair(px, m1, e0, e1, cap);
  unsigned long long idx = float_assign_pair<K>(px, m1, e0, e1);
#pragma unroll 1
  for (int r = 0; r < 3; ++r) {   // BC6H_SHARED_ROUNDS
    ls_refit_pair<K, false>(px, m1, idx, cap, sgn, e0, e1);
    if (r < 2) idx = float_assign_pair<K>(px, m1, e0, e1);
  }
}

// rescore_subset of each region: q[region][end][channel], every entry of
// idx, each region's error into err[region]
template <int K, class P>
__device__ __forceinline__ void rescore_pair(const P& px, unsigned m1,
                                             bool sgn, int prec_w,
                                             const float e0[2][3],
                                             const float e1[2][3],
                                             int q[2][2][3],
                                             unsigned long long& idx,
                                             float err[2]) {
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
  if (prec_w < 11) {
    float mi[2][3], ma[2][3], cap[2][3], r0[2][3], r1[2][3];
    mag_cap_pair(px, m1, mi, ma, cap);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r0[s][c] = e0[s][c];
        r1[s][c] = e1[s][c];
      }
    }
    ls_refit_pair<K, true>(px, m1, idx, cap, sgn, r0, r1);
    int qr[2][2][3];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        qr[s][0][c] = quantize((int)rintf(r0[s][c]), prec_w, sgn);
        qr[s][1][c] = quantize((int)rintf(r1[s][c]), prec_w, sgn);
      }
    }
    unsigned long long idx_r = idx;
    float err_r[2];
    palette_err_pair<K>(px, m1, qr, prec_w, sgn, idx_r, err_r);
    const unsigned long long nm1 = nibble_mask(m1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (err_r[s] < err[s]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          q[s][0][c] = qr[s][0][c];
          q[s][1][c] = qr[s][1][c];
        }
        const unsigned long long nm = s ? nm1 : ~nm1;
        idx = (idx & ~nm) | (idx_r & nm);
      }
      err[s] = fminf(err_r[s], err[s]);
    }
  }
}

// The one-region job: rows 10-13 off one trajectory over the whole block
// (positions 0-3 of the fold order)
template <class P>
__device__ __forceinline__ Best one_region_job(const P& px, bool sgn) {
  Best best{INFINITY, -1, {0ull, 0ull}};
  float se0[3], se1[3];
  shared_fit<16>(px, 0xFFFFu, sgn, se0, se1);
#pragma unroll 1
  for (int row = 10; row < 14; ++row) {
    int q[2][2][3] = {}, f[2][2][3];
    unsigned long long idx = 0ull;
    float total = 0.0f;
    total = total + rescore_subset<16>(px, 0xFFFFu, sgn, c_info[row].prec_w,
                                       se0, se1, q[0][0], q[0][1], idx);
    anchor_swap<16>(0xFFFFu, 0, q[0][0], q[0][1], idx);
    const float err = transform_fit(row, sgn, q, f) ? total : INFINITY;
    if (beats(best, err, row - 10)) {
      best.err = err;
      best.order = row - 10;
      best.w = emit(row, 0, f, idx, -1);
    }
  }
  return best;
}

// Candidate job k: rows 0-9 on shape candidate rank k (position 4 + 4 *
// row + k of the fold order), both regions in one pass
template <class P>
__device__ __forceinline__ Best candidate_job(const P& px, int shape, int k,
                                              bool sgn) {
  Best best{INFINITY, -1, {0ull, 0ull}};
  const unsigned m1 = bc7::subset1_mask(shape);
  const unsigned m0 = ~m1 & 0xFFFFu;
  const int a2 = bc7::c_pa2[shape] & 0xF;
  float e0[2][3], e1[2][3];
  shared_fit_pair<8>(px, m1, sgn, e0, e1);
#pragma unroll 1
  for (int g = 0; g < 6; ++g) {
    const int first = c_group_first[g];
    int q[2][2][3];
    unsigned long long idx;
    float err[2];
    rescore_pair<8>(px, m1, sgn, c_info[first].prec_w, e0, e1, q, idx, err);
    float total = 0.0f;
    total = total + err[0];
    total = total + err[1];
    anchor_swap<8>(m0, 0, q[0][0], q[0][1], idx);
    anchor_swap<8>(m1, a2, q[1][0], q[1][1], idx);
#pragma unroll 1
    for (int row = first; row < first + c_group_rows[g]; ++row) {
      int f[2][2][3];
      const float err_r = transform_fit(row, sgn, q, f) ? total : INFINITY;
      const int order = 4 + 4 * row + k;
      if (beats(best, err_r, order)) {
        best.err = err_r;
        best.order = order;
        best.w = emit(row, shape, f, idx, a2);
      }
    }
  }
  return best;
}

struct SearchSmem {
  int16_t px[48 * kGroup];                      // [48][kGroup]
  float top_est[kRankWarps][4][kGroup];         // each slice's top 4
  int top_shape[kRankWarps][4][kGroup];
  float err[kJobs][kGroup];                     // slot 0: one-region job,
  int order[kJobs][kGroup];                     // slot 1 + k: candidate k
  uint32_t w[kJobs][4][kGroup];
};

// Phase 1: pixel row r of block b0 + l into px[r][l]; a lane past the
// last block stages zeros (its results are never stored)
__device__ __forceinline__ void stage_group(SearchSmem& sm,
                                            const int32_t* __restrict__ px,
                                            int nb, int b0, int tid) {
#pragma unroll 4
  for (int k = tid; k < 48 * kGroup; k += kThreads) {
    const int r = k / kGroup, l = k % kGroup;
    sm.px[k] = b0 + l < nb ? (int16_t)px[(size_t)r * nb + b0 + l] : 0;
  }
}

__device__ __forceinline__ void put_job(SearchSmem& sm, int slot, int lane,
                                        const Best& r) {
  sm.err[slot][lane] = r.err;
  sm.order[slot][lane] = r.order;
  sm.w[slot][0][lane] = (uint32_t)r.w.lo;
  sm.w[slot][1][lane] = (uint32_t)(r.w.lo >> 32);
  sm.w[slot][2][lane] = (uint32_t)r.w.hi;
  sm.w[slot][3][lane] = (uint32_t)(r.w.hi >> 32);
}

// Phase 2: warps 0-2 rank their slices, warp 3 runs the one-region job
__device__ __forceinline__ void rank_or_one_region(SearchSmem& sm, int warp,
                                                   int lane, bool sgn) {
  const PxG px{sm.px + lane};
  if (warp < kRankWarps) {
    float mu[3];
    block_mean(px, mu);
    float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    int bi[4] = {0, 0, 0, 0};
    rank_slice(px, mu, warp, kRankWarps, bv, bi);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm.top_est[warp][k][lane] = bv[k];
      sm.top_shape[warp][k][lane] = bi[k];
    }
  } else {
    put_job(sm, 0, lane, one_region_job(px, sgn));
  }
}

// Phase 3: warp k's candidate job
__device__ __forceinline__ void candidate_phase(SearchSmem& sm, int warp,
                                                int lane, bool sgn) {
  const PxG px{sm.px + lane};
  const int shape = merged_candidate(sm.top_est, sm.top_shape, warp, lane);
  put_job(sm, 1 + warp, lane, candidate_job(px, shape, warp, sgn));
}

// Phase 4: lane `lane`'s fold by (error, position), stored for a block
// below nb
__device__ __forceinline__ void fold_group(const SearchSmem& sm, int lane,
                                           float* __restrict__ err_out,
                                           uint32_t* __restrict__ words,
                                           int nb, int b0) {
  Best best{INFINITY, -1, {0ull, 0ull}};
#pragma unroll
  for (int j = 0; j < kJobs; ++j) {
    const float e = sm.err[j][lane];
    const int o = sm.order[j][lane];
    if (beats(best, e, o)) {
      best.err = e;
      best.order = o;
      best.w.lo = (unsigned long long)sm.w[j][0][lane]
                | ((unsigned long long)sm.w[j][1][lane] << 32);
      best.w.hi = (unsigned long long)sm.w[j][2][lane]
                | ((unsigned long long)sm.w[j][3][lane] << 32);
    }
  }
  const int b = b0 + lane;
  if (b < nb) {
    err_out[b] = best.err;
    bc7::store_words(words, nb, b, best.w);
  }
}

static_assert(kThreads == 32 * (kRankWarps + 1), "3 ranking warps + 1");

__global__ void __launch_bounds__(kThreads, 4)
    bc6h_encode_kernel(const int32_t* __restrict__ px_g,
                       float* __restrict__ err_out,
                       uint32_t* __restrict__ words, int nb, int sgn_i) {
  __shared__ SearchSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kGroup;
  const bool sgn = sgn_i != 0;
  stage_group(sm, px_g, nb, b0, tid);
  __syncthreads();
  rank_or_one_region(sm, warp, lane, sgn);
  __syncthreads();
  candidate_phase(sm, warp, lane, sgn);
  __syncthreads();
  if (warp == 0) fold_group(sm, lane, err_out, words, nb, b0);
}

}  // namespace bc6h

extern "C" int bc6h_encode_launch(const void* px, void* err, void* words,
                                  int nb, int sgn, void* stream) {
  const int grid = (nb + bc6h::kGroup - 1) / bc6h::kGroup;
  bc6h::bc6h_encode_kernel<<<grid, bc6h::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (float*)err, (uint32_t*)words, nb, sgn);
  return (int)cudaGetLastError();
}
