// K9 — BC7 shape ranking, one thread per 4x4 block: the top 4 of the
// first S shapes with NS subsets by the off-axis estimate.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:partition_shapes_pallas /
// _shape_topk_kernel (off_axis=True at _ON_AXIS_W). Plain twin:
// bc67._partition_shapes_plain (_shape_estimates_table + _top_k_shapes).
// The body is K2's shape_top4 (bc7_encode.cuh) at NS subsets and S
// shapes: per shape, 11 masked 16-pixel sums per subset in pixel order,
// the within-subset RGB SSE less (1 - _ON_AXIS_W) of the dominant-axis
// variance (3 power iterations), and a running top 4 in which a tie keeps
// the lower shape first, as jnp.argmin does. USE_3SUBSETS launches it for
// mode 0 (three subsets, shapes 0..15: its partition field has 4 bits)
// and mode 2 (three subsets, all 64); the two-subset instance (64 shapes)
// ranks for K7's modes 1, 3 and 7.
//
// Bound: compute. A block reads 64 bytes and writes 16 (4 int32 picks),
// against about 400 operations per (shape, subset): 11 sums of 16 terms,
// a 3x3 covariance and its power iteration. The TPU took the sums as one
// [n_sub * S, 16] x [16, 11 T] matrix product on the MXU; here a thread
// keeps its block's pixels packed (16 registers), recomputes the cross
// moments per shape rather than holding 16 x 11 of them, and walks the
// shapes in a loop that is not unrolled, so code size and registers stay
// those of one shape. Built with --fmad=false like every kernel here.
#include "bc7_encode.cuh"

namespace bc7 {

template <int NS, int S>
__global__ void __launch_bounds__(kThreads)
    bc7_shapes_kernel(const int32_t* __restrict__ px,
                      int32_t* __restrict__ s_blks, int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);
  int cand[4];
  shape_top4<NS, S>(pix, cand);
#pragma unroll
  for (int k = 0; k < 4; ++k) s_blks[k * nb + b] = cand[k];
}

template <int NS, int S>
int launch_shapes(const void* px, void* s_blks, int nb, void* stream) {
  const int grid = (nb + kThreads - 1) / kThreads;
  bc7_shapes_kernel<NS, S><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (int32_t*)s_blks, nb);
  return (int)cudaGetLastError();
}

}  // namespace bc7

// (partitions, n_shapes): (1, 64), (2, 16) or (2, 64); 4 candidates.
// Anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int bc7_partition_shapes_launch(const void* px, void* s_blks,
                                           int nb, int partitions,
                                           int n_shapes, void* stream) {
  if (partitions == 1 && n_shapes == 64)
    return bc7::launch_shapes<2, 64>(px, s_blks, nb, stream);
  if (partitions == 2 && n_shapes == 64)
    return bc7::launch_shapes<3, 64>(px, s_blks, nb, stream);
  if (partitions == 2 && n_shapes == 16)
    return bc7::launch_shapes<3, 16>(px, s_blks, nb, stream);
  return (int)cudaErrorInvalidValue;
}
