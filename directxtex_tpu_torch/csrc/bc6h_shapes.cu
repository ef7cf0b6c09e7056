// The BC6H shape ranking as a launch of its own, as a team: a CTA of four
// warps ranks 32 blocks, one per lane. The top 4 of the 32 two-region
// shapes by the off-axis estimate at axis_w = 0, for K11's candidates in
// the BC6H_SHARED_FIT=False search.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:partition_shapes_pallas /
// _shape_topk_kernel at (partitions 1, 32 shapes, 3 channels,
// off_axis=True, axis_w=0.0), the ranking that _bc6h_all_kernel runs
// inline. Plain twin: bc6h._bc6h_shapes_plain (_shape_estimates_table +
// _top_k_shapes on RGB and a zero alpha plane); the team's plain form is
// bc6h._bc6h_shapes_slices_plain (bc67._top4_merge_plain over the same
// table).
//
// Design, K5's ranking phase (bc6h_shapes.cuh):
//   1. the CTA stages its 32 blocks' 48 halves once in shared memory, as
//      f32 ([48][32], PxF): each F16-int is converted once here, where
//      K5's int16 staging converts it at every read, 32 times a block;
//   2. warp w ranks shapes w, w + 4, ..., 28 + w of every block
//      (rank_slice: per shape, 10 masked 16-pixel sums per subset in
//      pixel order, the within-subset SSE less the dominant-axis
//      variance, 3 power iterations) into a local top 4, which it writes
//      to shared memory;
//   3. after a barrier, warp k merges the four lists by (estimate, shape),
//      the lower shape first on an equal estimate (merged_candidate),
//      and stores rank k of its 32 blocks, one coalesced row of s_blks.
// Each estimate is computed by the same operations whichever warp
// computes it, so the merge gives a one-thread ranking's picks exactly.
//
// Why: one thread a block ran 32 shapes x 16 pixels in series, 768 CTAs
// on config 4's 98,304 blocks, under one wave. Here four warps share a
// block's shapes and the grid is 3,072 CTAs. Both kernels issue the same
// instructions a shape (the 16-pixel sums, then the power iterations'
// IEEE square roots and divisions), and both are bound by issue, not by
// latency: the team takes 7% less device time. Staged as int16, as K5
// stages, it was slower than the one thread: it converted the 48 halves
// again for every shape (PERF.md).
//
// Bound: operations. A block reads 96 bytes (48 halves) and writes 16
// (4 int32 picks), against about 1.4 x 10^4 operations.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same shapes.
#include "bc6h_shapes.cuh"

namespace bc6h {

constexpr int kSlices = kThreads / 32;   // one slice of the shapes a warp
static_assert(kSlices == 4, "four ranking warps");

// a block's column of an f32 [48][kGroup] array, as rank_slice reads it
struct PxF {
  const float* p;
  __device__ __forceinline__ float f(int c, int i) const {
    return p[(c * 16 + i) * kGroup];
  }
};

struct ShapesSmem {
  float px[48 * kGroup];                        // [48][kGroup]
  float top_est[kSlices][4][kGroup];            // each slice's top 4
  int top_shape[kSlices][4][kGroup];
};

__global__ void __launch_bounds__(kThreads, 8)
    bc6h_shapes_team_kernel(const int32_t* __restrict__ px_g,
                            int32_t* __restrict__ s_blks, int nb) {
  __shared__ ShapesSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kGroup;
  // pixel row r of block b0 + l into px[r][l], as the int16 that K5
  // stages, then as f32; a lane past the last block stages zeros (its
  // picks are never stored)
#pragma unroll 4
  for (int k = tid; k < 48 * kGroup; k += kThreads) {
    const int r = k / kGroup, l = k % kGroup;
    sm.px[k] = b0 + l < nb
                   ? (float)(int16_t)px_g[(size_t)r * nb + b0 + l]
                   : 0.0f;
  }
  __syncthreads();
  {
    const PxF px{sm.px + lane};
    float mu[3];
    block_mean(px, mu);
    float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    int bi[4] = {0, 0, 0, 0};
    rank_slice(px, mu, warp, kSlices, bv, bi);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm.top_est[warp][k][lane] = bv[k];
      sm.top_shape[warp][k][lane] = bi[k];
    }
  }
  __syncthreads();
  const int b = b0 + lane;
  if (b < nb)
    s_blks[(size_t)warp * nb + b] =
        merged_candidate(sm.top_est, sm.top_shape, warp, lane);
}

}  // namespace bc6h

extern "C" int bc6h_shapes_launch(const void* px, void* s_blks, int nb,
                                  void* stream) {
  const int grid = (nb + bc6h::kGroup - 1) / bc6h::kGroup;
  bc6h::bc6h_shapes_team_kernel<<<grid, bc6h::kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t*)px, (int32_t*)s_blks, nb);
  return (int)cudaGetLastError();
}
