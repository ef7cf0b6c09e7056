// K2's mode 7 as launches of its own: the searches with mode 7 in either
// tier, (1, 3, 5, 6, 7, 4), are K2's (1, 3, 5, 6, 4) search (the opaque
// team kernel or the maxq variant, which also write the top-4 two-subset
// shapes they ranked), then
//   1. bc7_alpha_list: the blocks with some alpha below 255, listed (one
//      __ballot_sync + __popc per warp, a shared-memory atomic per warp,
//      one global atomicAdd per CTA; the count stays on the card);
//   2. bc7_mode7: per listed block, mode 7 on the search's four shapes,
//      each candidate fitted on its own (K7's code, eval_partition<7>,
//      the best by a strict `<` in rank order), folded into the search's
//      result in place.
// A block not listed keeps the search's result: its mode-7 error is inf
// (pallas_kernels.py:1952-1956), which never wins.
//
// Replaces the mode-7 part of directxtex_tpu/bc/pallas_kernels.py:
// bc7_encode_pallas / _bc7_all_kernel (_k_partition_fold(7) on modes
// 1/3's top-4 shapes). Plain twins: bc67._alpha_list_plain and
// bc67._mode7_fold_plain; with the search, bc67._bc7_search_plain over
// SEARCH_MODES_ALPHA.
//
// The fold. The search folds (1, 3, 5, 6, 7, 4) in that order with a
// strict `<`. Let F be the fold of (1, 3, 5, 6, 4) and P that of
// (1, 3, 5, 6). If F's words are not mode 4's, mode 4 lost to P
// (e4 >= eP) and F = P; the full fold takes 7 exactly where e7 < eP = eF
// (after 7 wins, e4 >= eP > e7 keeps it). If F's words are mode 4's,
// e4 < eP = the bar 7 must pass: 7 stands after 4 exactly where e7 < eP
// and not e4 < e7, that is e7 <= e4 = eF. So
//   take7 = mode(F) == 4 ? e7 <= eF : e7 < eF,
// and the words and errors are the one fold's
// (tests/test_torch_bc7_mode7_split.py holds the rule against the strict
// fold under drawn ties).
//
// Bound: operations for mode 7 (about 2.3 x 10^4 a block with alpha,
// tests/test_torch_op_counts.py), bytes for the list pass (a block's 16
// alpha texels in, one list entry out). The list gives mode 7's launch
// only blocks that need it, so a warp's lanes all evaluate; mode 7's
// state no longer shares a thread with the other modes' (the one-thread
// alpha variants spilled up to 4.4 KB a thread at 255 registers).
#include "bc7_encode.cuh"

namespace bc7 {

constexpr int kListThreads = 512;

// list[0..count) = the blocks with some alpha below 255 (count zeroed
// first), a warp's in lane order, the warps' order the atomics'
__global__ void __launch_bounds__(kListThreads)
    bc7_alpha_list_kernel(const int32_t* __restrict__ px,
                          int32_t* __restrict__ list,
                          int32_t* __restrict__ count, int nb) {
  __shared__ int cta_count, cta_base;
  const int b = blockIdx.x * kListThreads + threadIdx.x;
  if (threadIdx.x == 0) cta_count = 0;
  bool has_alpha = false;
  if (b < nb) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      has_alpha |= px[(size_t)(i * 4 + 3) * nb + b] != 255;
  }
  __syncthreads();
  // every lane stays for the ballot (the grid is whole warps)
  const int lane = threadIdx.x & 31;
  const unsigned hit = __ballot_sync(0xFFFFFFFFu, has_alpha);
  int pos = 0;
  if (hit) {
    const int leader = __ffs(hit) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&cta_count, __popc(hit));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    pos = base + __popc(hit & ((1u << lane) - 1u));
  }
  __syncthreads();
  if (threadIdx.x == 0 && cta_count) cta_base = atomicAdd(count, cta_count);
  __syncthreads();
  if (has_alpha) list[cta_base + pos] = b;
}

// mode 7 of the listed blocks on their picks [4, NB], folded into
// (err, words) in place by the take7 rule above
template <bool W>
__global__ void __launch_bounds__(kThreads)
    bc7_mode7_kernel(const int32_t* __restrict__ px,
                     const int32_t* __restrict__ picks,
                     const int32_t* __restrict__ list,
                     const int32_t* __restrict__ count,
                     float* __restrict__ err, uint32_t* __restrict__ words,
                     int nb, float aw) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= *count) return;
  const int b = list[t];
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);
  Best best7{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int shape = picks[(size_t)k * nb + b];
    eval_partition<7, W>(pix, shape, subset1_mask(shape), aw, best7);
  }
  const float e_f = err[b];
  const bool after4 = block_mode(load_words(words, nb, b)) == 4;
  if (after4 ? best7.err <= e_f : best7.err < e_f) {
    err[b] = best7.err;
    store_words(words, nb, b, best7.w);
  }
}

}  // namespace bc7

// px [64, NB] -> list [NB] (the first count[0] entries set), count [1]
extern "C" int bc7_alpha_list_launch(const void* px, void* list, void* count,
                                     int nb, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (nb + bc7::kListThreads - 1) / bc7::kListThreads;
  bc7::bc7_alpha_list_kernel<<<grid, bc7::kListThreads, 0, s>>>(
      (const int32_t*)px, (int32_t*)list, (int32_t*)count, nb);
  return (int)cudaGetLastError();
}

// mode 7 over list[0..count) on picks [4, NB], folded into err [NB] and
// words [4, NB]; alpha_weight arrives as its f32 bit pattern, and at 1.0
// the unweighted instance runs
extern "C" int bc7_mode7_launch(const void* px, const void* picks,
                                const void* list, const void* count,
                                void* err, void* words, int nb, int aw_bits,
                                void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = (nb + bc7::kThreads - 1) / bc7::kThreads;
  const int32_t *p = (const int32_t*)px, *k = (const int32_t*)picks,
                *l = (const int32_t*)list, *c = (const int32_t*)count;
  if (aw != 1.0f)
    bc7::bc7_mode7_kernel<true><<<grid, bc7::kThreads, 0, s>>>(
        p, k, l, c, (float*)err, (uint32_t*)words, nb, aw);
  else
    bc7::bc7_mode7_kernel<false><<<grid, bc7::kThreads, 0, s>>>(
        p, k, l, c, (float*)err, (uint32_t*)words, nb, aw);
  return (int)cudaGetLastError();
}
