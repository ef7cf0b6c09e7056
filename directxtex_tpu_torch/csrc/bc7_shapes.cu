// K9 — BC7 shape ranking as a team: a CTA of four warps ranks 32 blocks,
// one per lane, and writes the top 4 of the first S shapes with NS
// subsets by the off-axis estimate; on the USE_3SUBSETS path one launch
// also writes the top 4 of shapes 0..15.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:partition_shapes_pallas /
// _shape_topk_kernel (off_axis=True at _ON_AXIS_W). Plain twin:
// bc67._partition_shapes_plain (_shape_estimates_table + _top_k_shapes);
// the plain form of this decomposition is bc67._shape_lists_plain. The
// phases:
//   1. the CTA stages the blocks' pixels (team_stage_pixels), then each
//      pixel's 11 moment terms (team_moments) in shared memory, as K2's
//      default team does (bc7_encode.cuh);
//   2. warp w ranks shapes w, w + 4, ... below S (rank_shapes, which
//      reads its moment terms through MomentsShared) into a running top
//      4 by (estimate, shape), and stores the estimates of its shapes
//      below 16 in the pixels' place;
//   3. warp 0 merges the four warps' lists by (estimate, shape) with the
//      lower shape first on an equal estimate (merge_top4, the default
//      team's rule), and warp 1 runs the same running top 4 over the
//      stored estimates of shapes 0..15 in shape order: each gives
//      _top_k_shapes's picks exactly.
// A shape's estimate does not depend on how many shapes are ranked
// (_shape_estimates_table has one row per (subset, shape)), so the 16
// estimates are those a ranking of shapes 0..15 alone computes.
// USE_3SUBSETS launches it once (three subsets, 64 shapes, both lists):
// mode 2 ranks all 64 shapes, mode 0 only 0..15 (its partition field has
// 4 bits), which the JAX kernel takes as a slice of the 64-shape table
// (pallas_kernels.py:1913-1915). The wrapper's other rankings are (three
// subsets, 16 shapes) and (two subsets, 64) for K7's modes 1, 3 and 7.
//
// Bound: compute. A block reads 64 bytes and writes 16 (4 int32 picks) a
// list, against about 550 operations per three-subset shape: per subset
// 11 sums of 16 terms, a 3x3 covariance and its power iteration. The
// one-thread kernel this replaces held 223-233 registers (8 warps an SM)
// and was launched twice on the path, ranking shapes 0..15 twice. Here a
// warp's ranking holds one shape's sums at 64 registers, and the lists
// go where the moment terms were once every warp has read them, so that
// shared memory (26 KB) lets 8 CTAs, 32 warps, share an SM: the ranking
// waits on shared-memory loads and on the power iteration's IEEE
// divisions and square roots, and more warps hide more of that. Built
// with --fmad=false like every kernel here.
#include "bc7_encode.cuh"

namespace bc7 {

constexpr int kShapesCtas = 8;                  // CTAs an SM (launch bound)

// K9's shared memory: 26,624 bytes, so that 8 CTAs fit an SM
struct ShapesSmem {
  // the blocks' pixels; after the moment terms, the estimates of shapes
  // 0..15 (the pixels are not read again)
  union {
    uint32_t pix[16][kTeamBlocks];              // packed RGBA8
    float est16[16][kTeamBlocks];
  };
  // the moment terms; after the ranking, each warp's local top 4
  union {
    float4 mom[16][3][kTeamBlocks];             // 11 moment terms a pixel
    struct {
      float est[kTeamWarps][4][kTeamBlocks];
      int shape[kTeamWarps][4][kTeamBlocks];
    } top;
  };
};

// s_blks [4, NB]: the top 4 of shapes 0..n_shapes-1; s_blks16 [4, NB] or
// null: the top 4 of shapes 0..15
template <int NS>
__global__ void __launch_bounds__(kThreads, kShapesCtas)
    bc7_shapes_team_kernel(const int32_t* __restrict__ px,
                           int32_t* __restrict__ s_blks,
                           int32_t* __restrict__ s_blks16, int nb,
                           int n_shapes) {
  __shared__ ShapesSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kTeamBlocks;
  team_stage_pixels(sm, px, nb, b0, tid);
  __syncthreads();
  team_moments(sm, warp, lane);
  __syncthreads();
  float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  int bi[4] = {0, 0, 0, 0};
  rank_shapes<NS, kTeamWarps>(MomentsShared<ShapesSmem>{&sm, lane}, warp,
                              n_shapes, bv, bi, [&](int s, float est) {
                                if (s < 16) sm.est16[s][lane] = est;
                              });
  __syncthreads();                              // the moment terms are read
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sm.top.est[warp][k][lane] = bv[k];
    sm.top.shape[warp][k][lane] = bi[k];
  }
  __syncthreads();
  const int b = b0 + lane;
  if (b >= nb || warp > 1 || (warp == 1 && !s_blks16)) return;
  if (warp == 0) {
    merge_top4(sm.top.est, sm.top.shape, lane, bi);
  } else {                                      // shapes 0..15 in order
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bv[k] = INFINITY;
      bi[k] = 0;
    }
#pragma unroll 1
    for (int s = 0; s < 16; ++s) top4_insert(bv, bi, sm.est16[s][lane], s);
  }
  int32_t* out = warp == 0 ? s_blks : s_blks16;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[(size_t)k * nb + b] = bi[k];
}

template <int NS>
int launch_shapes(const void* px, void* s_blks, void* s_blks16, int nb,
                  int n_shapes, void* stream) {
  const int grid = (nb + kTeamBlocks - 1) / kTeamBlocks;
  bc7_shapes_team_kernel<NS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (int32_t*)s_blks, (int32_t*)s_blks16, nb,
      n_shapes);
  return (int)cudaGetLastError();
}

}  // namespace bc7

// (partitions, n_shapes): (1, 64), (2, 16) or (2, 64); 4 candidates into
// s_blks. s_blks16 is null, or with (2, 64) a second [4, NB] output that
// gets the top 4 of shapes 0..15 from the same launch (USE_3SUBSETS'
// modes 0 and 2). Anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int bc7_partition_shapes_launch(const void* px, void* s_blks,
                                           void* s_blks16, int nb,
                                           int partitions, int n_shapes,
                                           void* stream) {
  if (s_blks16 && !(partitions == 2 && n_shapes == 64))
    return (int)cudaErrorInvalidValue;
  if (partitions == 1 && n_shapes == 64)
    return bc7::launch_shapes<2>(px, s_blks, nullptr, nb, 64, stream);
  if (partitions == 2 && (n_shapes == 16 || n_shapes == 64))
    return bc7::launch_shapes<3>(px, s_blks, s_blks16, nb, n_shapes,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
