// K11 — BC6H two-region rows of one precision group over given shape
// candidates, each candidate evaluated in full, one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_2region_pallas /
// _bc6h_2region_kernel (_k_bc6h_group), the two-region half of the
// BC6H_SHARED_FIT=False search, launched once per precision group (rows
// {0} {1} {2,3,4} {5} {6,7,8} {9}: c_group_first / c_group_rows). Plain
// twin: bc6h._bc6h_2region_plain, in the same operation order: per
// candidate shape (s_blks [C, NB], in rank order) the full
// quantized-domain evaluation of each region at the group's endpoint
// precision (eval_subset_q in bc6h_common.cuh), evaluated once at the
// group's first row since the group's rows share (endpoint precision,
// index precision); the anchor swaps; then per row of the group its own
// delta fit and emit. The twin folds within a row over the candidates,
// then across the rows, each with a strict `<` and its first entry taken
// as it is. This kernel walks the candidates outermost (one candidate's
// state live at a time) and keeps the least (error, row, candidate),
// which is the same winner, a block on which nothing fits included
// (it gets the first row's first candidate, as in the TPU kernel).
//
// Bound: operations. A block needs 96 bytes of pixels and C shape bytes
// in and 20 bytes out, against about 10^4 elementwise operations per
// candidate (tests/test_torch_op_counts.py), in per-thread dependence
// chains. The design is K5's: pixels staged in shared memory as int16,
// loops not unrolled, indices packed 4 bits a pixel.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#include <climits>

#include "bc6h_common.cuh"

namespace bc6h {

__global__ void __launch_bounds__(kThreads)
    bc6h_2region_kernel(const int32_t* __restrict__ px_g,
                        const int32_t* __restrict__ s_blks,
                        float* __restrict__ err_out,
                        uint32_t* __restrict__ words, int nb, int n_cand,
                        int group, int sgn_i) {
  __shared__ int16_t s_px[48 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const bool sgn = sgn_i != 0;
  const Px px = stage_pixels(px_g, nb, b, s_px);
  const int first = c_group_first[group];
  const int n_rows = c_group_rows[group];
  const int prec_w = c_info[first].prec_w;
  float best_err = INFINITY;
  int best_order = INT_MAX;
  Bits128 best_w{0ull, 0ull};
#pragma unroll 1
  for (int k = 0; k < n_cand; ++k) {
    const int shape = s_blks[k * nb + b];
    const unsigned m1 = bc7::subset1_mask(shape);
    const unsigned m0 = ~m1 & 0xFFFFu;
    const int a2 = bc7::c_pa2[shape] & 0xF;
    int q[2][2][3];
    unsigned long long idx = 0ull;
    float total = 0.0f;
    total = total + eval_subset_q<8>(px, m0, sgn, prec_w, q[0][0], q[0][1],
                                     idx);
    total = total + eval_subset_q<8>(px, m1, sgn, prec_w, q[1][0], q[1][1],
                                     idx);
    anchor_swap<8>(m0, 0, q[0][0], q[0][1], idx);
    anchor_swap<8>(m1, a2, q[1][0], q[1][1], idx);
#pragma unroll 1
    for (int r = 0; r < n_rows; ++r) {
      int f[2][2][3];
      const float err =
          transform_fit(first + r, sgn, q, f) ? total : INFINITY;
      const int order = r * n_cand + k;
      if (err < best_err || (err == best_err && order < best_order)) {
        best_err = err;
        best_order = order;
        best_w = emit(first + r, shape, f, idx, a2);
      }
    }
  }
  err_out[b] = best_err;
  bc7::store_words(words, nb, b, best_w);
}

}  // namespace bc6h

// group: 0-5 (the precision groups in row order); s_blks [n_cand, NB]
// int32 shapes 0..31. A group outside 0-5 or n_cand < 1 returns
// cudaErrorInvalidValue unlaunched.
extern "C" int bc6h_2region_launch(const void* px, const void* s_blks,
                                   void* err, void* words, int nb,
                                   int n_cand, int group, int sgn,
                                   void* stream) {
  if (group < 0 || group > 5 || n_cand < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (nb + bc6h::kThreads - 1) / bc6h::kThreads;
  bc6h::bc6h_2region_kernel<<<grid, bc6h::kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)s_blks, (float*)err,
      (uint32_t*)words, nb, n_cand, group, sgn);
  return (int)cudaGetLastError();
}
