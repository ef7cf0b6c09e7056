// The BC6H shape ranking as a launch of its own, one thread per 4x4
// block: the top 4 of the 32 two-region shapes by the off-axis estimate
// at axis_w = 0, for K11's candidates in the BC6H_SHARED_FIT=False search.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:partition_shapes_pallas /
// _shape_topk_kernel at (partitions 1, 32 shapes, 3 channels,
// off_axis=True, axis_w=0.0), the ranking that _bc6h_all_kernel runs
// inline. Plain twin: bc6h._bc6h_shapes_plain (_shape_estimates_table +
// _top_k_shapes on RGB and a zero alpha plane). The body is K5's
// shape_top4 (bc6h_shapes.cuh): per shape, 10 masked 16-pixel sums per
// subset in pixel order, the within-subset SSE less the dominant-axis
// variance (3 power iterations), and a running top 4 in which a tie keeps
// the lower shape first, as jnp.argmin does.
//
// Bound: operations. A block reads 96 bytes (48 halves) and writes 16
// (4 int32 picks), against about 10^4 operations. Pixels are staged in
// shared memory as int16 as in K5; the shape loop is not unrolled.
#include "bc6h_shapes.cuh"

namespace bc6h {

__global__ void __launch_bounds__(kThreads)
    bc6h_shapes_kernel(const int32_t* __restrict__ px_g,
                       int32_t* __restrict__ s_blks, int nb) {
  __shared__ int16_t s_px[48 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const Px px = stage_pixels(px_g, nb, b, s_px);
  int cand[4];
  shape_top4(px, cand);
#pragma unroll
  for (int k = 0; k < 4; ++k) s_blks[k * nb + b] = cand[k];
}

}  // namespace bc6h

extern "C" int bc6h_shapes_launch(const void* px, void* s_blks, int nb,
                                  void* stream) {
  const int grid = (nb + bc6h::kThreads - 1) / bc6h::kThreads;
  bc6h::bc6h_shapes_kernel<<<grid, bc6h::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)px, (int32_t*)s_blks, nb);
  return (int)cudaGetLastError();
}
