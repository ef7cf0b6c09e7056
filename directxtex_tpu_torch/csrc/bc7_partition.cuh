// K7 — one BC7 partition mode over given shape candidates, one thread per
// 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:partition_mode_pallas /
// _partition_mode_kernel for modes 0, 1, 2, 3 and 7. Plain twin:
// bc67._partition_mode_plain (_try_partition_mode's candidate loop,
// bc67.py:1370-1384). Each of the block's candidate shapes (s_blks
// [C, NB], in rank order) is evaluated by K2's eval_partition<M>
// (bc7_encode.cuh): per subset an axis fit, quantize and assign, one LS
// refit and re-assign, keep the better; then anchor swaps (three subsets:
// c_pa3's two nibbles) and emit; the best candidate by a strict `<` in
// candidate order stands. USE_3SUBSETS launches it for modes 0 and 2 on
// K9's picks. Mode 7's opaque blocks are not masked here, as in the twin.
// Each mode has a weighted instance (W) that scales the alpha channel's
// squared error by alpha_weight; at 1.0 the unweighted one runs.
//
// Bound: compute. A block reads 64 bytes and 16 bytes of candidates and
// writes 20, against tens of thousands of operations: per candidate and
// subset two 16-pixel index assignments and an LS refit. The design is
// K2's: packed pixels, one candidate's fit state live at a time (the
// candidate loop is not unrolled), and a per-subset fit that writes its
// indices into the block's one index plane. Modes 0 and 2 build from
// sources of their own (bc7_partition_0.cu, bc7_partition_2.cu) so that
// the parallel build's longest compile stays short.
#pragma once

#include "bc7_encode.cuh"

namespace bc7 {

template <int M, bool W>
__global__ void __launch_bounds__(kThreads)
    bc7_partition_kernel(const int32_t* __restrict__ px,
                         const int32_t* __restrict__ s_blks,
                         float* __restrict__ err,
                         uint32_t* __restrict__ words, int nb, int n_cand,
                         float aw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);
  Best best{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int k = 0; k < n_cand; ++k) {
    const int shape = s_blks[k * nb + b];
    eval_partition<M, W>(pix, shape, parts(M) == 1 ? subset1_mask(shape) : 0u,
                         aw, best);
  }
  err[b] = best.err;
  store_words(words, nb, b, best.w);
}

// Host launcher of mode M: alpha_weight arrives as its f32 bit pattern
template <int M>
int launch_partition(const void* px, const void* s_blks, void* err,
                     void* words, int nb, int n_cand, int aw_bits,
                     void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const int grid = (nb + kThreads - 1) / kThreads;
  if (aw != 1.0f)
    bc7_partition_kernel<M, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (const int32_t*)s_blks, (float*)err,
        (uint32_t*)words, nb, n_cand, aw);
  else
    bc7_partition_kernel<M, false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
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
