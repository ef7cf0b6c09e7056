// K7 — one BC7 partition mode over given shape candidates, as a team: a
// CTA of four warps evaluates 32 blocks, one per lane, one candidate a
// warp.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:partition_mode_pallas /
// _partition_mode_kernel for modes 0, 1, 2, 3 and 7. Plain twin:
// bc67._partition_mode_plain (_try_partition_mode's candidate loop,
// bc67.py:1370-1384); the plain form of this decomposition is
// bc67._partition_jobs_plain + _partition_jobs_fold_plain. Phases:
//   1. the CTA stages its blocks' pixels in shared memory, packed RGBA8
//      (team_stage_pixels);
//   2. candidate rank j of s_blks [C, NB] is a job, on warp j % 4, the
//      same job on every lane of a warp (USE_3SUBSETS' four candidates:
//      one job a warp). A job is eval_partition_ns: every subset of the
//      candidate fitted in one pass per step (fit_ns: axis fit, quantize
//      and assign, one LS refit and re-assign, each subset keeping its
//      better by its own strict `<`; three subsets for modes 0 and 2, two
//      for 1, 3 and 7), its pixels read from shared memory at each pass
//      (PixShared), the index plane packed 4 bits a pixel, then anchor
//      swaps (three subsets: c_pa3's two nibbles) and emit. A warp keeps
//      the best of its jobs by a strict `<` in rank order, and its rank;
//   3. warp 0 folds the four warps' bests of each block by (error, rank):
//      a lower error wins, an equal one the lower rank. That is the
//      twin's strict-`<` fold in rank order (the first candidate of least
//      error stands); with four candidates or fewer it is that fold over
//      ranks 0..3.
// fit_ns gives each subset the one-subset fit's bits (bc7_encode.cuh), so
// the words and errors are the plain twin's. USE_3SUBSETS launches it for
// modes 0 and 2 on K9's picks. Mode 7's opaque blocks are not masked
// here, as in the twin. Each mode has a weighted instance (W) that scales
// the alpha channel's squared error by alpha_weight; at 1.0 the
// unweighted one runs.
//
// Bound: compute. A block reads 64 bytes and 16 bytes of candidates and
// writes 20, against about 21,000 operations (modes 0 and 2): per
// candidate and subset two 16-pixel index assignments and an LS refit.
// The one-thread kernel this replaces held 255 registers and spilled
// (8 warps an SM), and ran each subset's fit over all 16 pixels with the
// others masked off, three times over for modes 0 and 2. Here a warp
// holds one candidate's fit state at 128 registers (16 warps an SM) and a
// pass issues each pixel's work once. Modes 0 and 2 build from sources of
// their own (bc7_partition_0.cu, bc7_partition_2.cu) so that the parallel
// build's longest compile stays short.
#pragma once

#include "bc7_encode.cuh"

namespace bc7 {

struct PartitionSmem {
  uint32_t pix[16][kTeamBlocks];                // packed RGBA8
  struct {                                      // each warp's best job
    float err[kTeamWarps][kTeamBlocks];
    uint32_t w[kTeamWarps][4][kTeamBlocks];
  } res;
  int rank[kTeamWarps][kTeamBlocks];            // its candidate rank
};

template <int M, bool W>
__global__ void __launch_bounds__(kThreads, 4)
    bc7_partition_team_kernel(const int32_t* __restrict__ px,
                              const int32_t* __restrict__ s_blks,
                              float* __restrict__ err,
                              uint32_t* __restrict__ words, int nb,
                              int n_cand, float aw) {
  __shared__ PartitionSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kTeamBlocks, b = b0 + lane;
  team_stage_pixels(sm, px, nb, b0, tid);
  __syncthreads();
  const PixShared pxs{&sm.pix[0][lane], 0};
  Best best{INFINITY, {0ull, 0ull}};
  int rank = n_cand;
#pragma unroll 1
  for (int k = warp; k < n_cand; k += kTeamWarps) {
    const int shape = b < nb ? s_blks[(size_t)k * nb + b] : 0;
    const float before = best.err;
    eval_partition_ns<M, W>(pxs, shape,
                            parts(M) == 1 ? subset1_mask(shape) : 0u, aw,
                            best);
    if (best.err < before) rank = k;
  }
  team_put(sm, warp, lane, best);
  sm.rank[warp][lane] = rank;
  __syncthreads();
  if (warp != 0 || b >= nb) return;
  Best fold{INFINITY, {0ull, 0ull}};
  int fold_rank = n_cand + 1;
#pragma unroll
  for (int w = 0; w < kTeamWarps; ++w) {
    const Best r = team_get(sm, w, lane);
    const int rk = sm.rank[w][lane];
    if (r.err < fold.err || (r.err == fold.err && rk < fold_rank)) {
      fold = r;
      fold_rank = rk;
    }
  }
  err[b] = fold.err;
  store_words(words, nb, b, fold.w);
}

// Host launcher of mode M: alpha_weight arrives as its f32 bit pattern
template <int M>
int launch_partition(const void* px, const void* s_blks, void* err,
                     void* words, int nb, int n_cand, int aw_bits,
                     void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const int grid = (nb + kTeamBlocks - 1) / kTeamBlocks;
  const cudaStream_t s = (cudaStream_t)stream;
  if (aw != 1.0f)
    bc7_partition_team_kernel<M, true><<<grid, kThreads, 0, s>>>(
        (const int32_t*)px, (const int32_t*)s_blks, (float*)err,
        (uint32_t*)words, nb, n_cand, aw);
  else
    bc7_partition_team_kernel<M, false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)px, (const int32_t*)s_blks, (float*)err,
        (uint32_t*)words, nb, n_cand, aw);
  return (int)cudaGetLastError();
}

// modes 0 and 2, built in bc7_partition_0.cu and bc7_partition_2.cu
int launch_partition_mode0(const void* px, const void* s_blks, void* err,
                           void* words, int nb, int n_cand, int aw_bits,
                           void* stream);
int launch_partition_mode2(const void* px, const void* s_blks, void* err,
                           void* words, int nb, int n_cand, int aw_bits,
                           void* stream);

}  // namespace bc7
