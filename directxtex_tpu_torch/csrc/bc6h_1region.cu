// K10 — BC6H one-region rows 10-13, each evaluated in full, one thread per
// 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_1region_pallas /
// _bc6h_1region_kernel (_k_bc6h_1region), the one-region half of the
// BC6H_SHARED_FIT=False search. Plain twin: bc6h._bc6h_1region_plain, step
// for step and in the same operation order: per row, the full
// quantized-domain evaluation of the block at the row's endpoint
// precision (min/max box, quantize, exact rescore, two LS refit rounds at
// the integer palette weights, each requantized and rescored, keep the
// better: eval_subset_q in bc6h_common.cuh), the anchor swap, the delta
// fit and the emit; the rows fold in order with a strict `<`, row 10
// taken as it is (so a block on which no row fits still gets row 10's
// words, as in the TPU kernel; the search's fold over launches never
// takes an infinite error).
//
// Bound: operations. A block needs 96 bytes in (48 halves; read here as
// int32) and 20 out, against about 2.3 * 10^4 elementwise operations for
// its four rows (tests/test_torch_op_counts.py), in per-thread dependence
// chains (16-pixel sums in order, LS solves). The design is K5's: the 48
// pixels staged in shared memory as int16, one row's state live at a time
// in a loop that is not unrolled, indices packed 4 bits a pixel.
//
// Why one thread a block: the kernel is bound by issue. Its SASS issues
// about 3.7 * 10^4 instructions a block (chip_ab.py --sass), which fill
// most of the issue slots of its time on the card; a team of four warps
// per 32 blocks, warp r on row 10 + r from pixels staged once, issued 5%
// more (staging, shared-memory results, the fold) and ran 8% longer, and
// two warps of two rows each ran no faster (PERF.md).
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#include "bc6h_common.cuh"

namespace bc6h {

__global__ void __launch_bounds__(kThreads)
    bc6h_1region_kernel(const int32_t* __restrict__ px_g,
                        float* __restrict__ err_out,
                        uint32_t* __restrict__ words, int nb, int sgn_i) {
  __shared__ int16_t s_px[48 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const bool sgn = sgn_i != 0;
  const Px px = stage_pixels(px_g, nb, b, s_px);
  float best_err = INFINITY;
  Bits128 best_w{0ull, 0ull};
#pragma unroll 1
  for (int row = 10; row < 14; ++row) {
    int q[2][2][3] = {}, f[2][2][3];
    unsigned long long idx = 0ull;
    float total = 0.0f;
    total = total + eval_subset_q<16>(px, 0xFFFFu, sgn, c_info[row].prec_w,
                                      q[0][0], q[0][1], idx);
    anchor_swap<16>(0xFFFFu, 0, q[0][0], q[0][1], idx);
    const float err = transform_fit(row, sgn, q, f) ? total : INFINITY;
    if (row == 10 || err < best_err) {
      best_err = err;
      best_w = emit(row, 0, f, idx, -1);
    }
  }
  err_out[b] = best_err;
  bc7::store_words(words, nb, b, best_w);
}

}  // namespace bc6h

extern "C" int bc6h_1region_launch(const void* px, void* err, void* words,
                                   int nb, int sgn, void* stream) {
  const int grid = (nb + bc6h::kThreads - 1) / bc6h::kThreads;
  bc6h::bc6h_1region_kernel<<<grid, bc6h::kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)px, (float*)err, (uint32_t*)words, nb, sgn);
  return (int)cudaGetLastError();
}
