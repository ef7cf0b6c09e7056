// K3's launcher side: the bucket pass and the per-mode launches, in one
// call from the host. The refine kernels are bc7_refine.cuh's;
// bc7_refine_<M>.cu builds mode M's.
//
// bc7_mode_buckets copies each block's words to the output (a block out of
// scope, or whose error does not drop, passes through as this copy) and,
// for each mode in the mode mask, appends the block's index to that
// mode's list: lists [8, NB] int32, counts [8] int32, zeroed first. A warp
// appends its blocks of a mode in lane order (__ballot_sync + __popc) at
// an offset from one shared-memory atomic, and a CTA of 512 threads takes
// its room in the list with one global atomicAdd per mode, so few atomics
// meet on the eight counters. Neighbouring blocks stay neighbours for the
// refine's pixel gather. Plain twin:
// bc67._mode_buckets_plain (the same counts and, per mode, the same set
// of indices; the order across warps is the atomics').
//
// Bound: bytes. A block reads 16 and writes 16 + 4.
#include "bc7_refine.cuh"

namespace bc7 {

constexpr int kBucketThreads = 512;

__global__ void __launch_bounds__(kBucketThreads)
    bc7_mode_buckets_kernel(const uint32_t* __restrict__ words_in,
                            uint32_t* __restrict__ words_out,
                            int32_t* __restrict__ lists,
                            int32_t* __restrict__ counts, int nb,
                            int mode_mask) {
  __shared__ int cta_count[8], cta_base[8];
  const int b = blockIdx.x * kBucketThreads + threadIdx.x;
  if (threadIdx.x < 8) cta_count[threadIdx.x] = 0;
  int mode = 8;
  if (b < nb) {
    const Bits128 w = load_words(words_in, nb, b);
    store_words(words_out, nb, b, w);
    mode = block_mode(w);
  }
  __syncthreads();
  // every lane stays for the ballots (the grid is whole warps)
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int pos = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if (!((mode_mask >> m) & 1)) continue;       // the same in every lane
    const unsigned hit = __ballot_sync(0xFFFFFFFFu, mode == m);
    if (!hit) continue;
    const int leader = __ffs(hit) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(cta_count + m, __popc(hit));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (mode == m) pos = base + __popc(hit & below);
  }
  __syncthreads();
  if (threadIdx.x < 8 && cta_count[threadIdx.x])
    cta_base[threadIdx.x] = atomicAdd(counts + threadIdx.x,
                                      cta_count[threadIdx.x]);
  __syncthreads();
  if (mode < 8 && ((mode_mask >> mode) & 1))
    lists[(size_t)mode * nb + cta_base[mode] + pos] = b;
}

}  // namespace bc7

// words_in [4, NB] -> words_out [4, NB] (a copy), lists [8, NB], counts
// [8] of the modes in mode_mask
extern "C" int bc7_mode_buckets_launch(const void* words_in, void* words_out,
                                       void* lists, void* counts, int nb,
                                       int mode_mask, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(counts, 0, 8 * sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (nb + bc7::kBucketThreads - 1) / bc7::kBucketThreads;
  bc7::bc7_mode_buckets_kernel<<<grid, bc7::kBucketThreads, 0, s>>>(
      (const uint32_t*)words_in, (uint32_t*)words_out, (int32_t*)lists,
      (int32_t*)counts, nb, mode_mask);
  return (int)cudaGetLastError();
}

// K3's whole call: the bucket pass (words_out a copy of words_in, lists
// [8, NB], counts [8]), then one launch per mode in mode_mask of that
// mode's refine over its bucket, into words_out; all on `stream`, with no
// host sync. exact 0: LADDER_MOMENT; 1: the exact ladder of `rounds`
// rounds and `deltas` (one byte each, low byte first, a zero byte ends
// the list). alpha_weight arrives as its f32 bit pattern.
extern "C" int bc7_refine_launch(const void* px, const void* words_in,
                                 void* words_out, void* lists, void* counts,
                                 int nb, int mode_mask, int aw_bits,
                                 int exact, int rounds, int deltas,
                                 void* stream) {
  int rc = bc7_mode_buckets_launch(words_in, words_out, lists, counts, nb,
                                   mode_mask, stream);
  if (rc != 0) return rc;
  bc7::RefineArgs a;
  a.px = (const int32_t*)px;
  a.words_in = (const uint32_t*)words_in;
  a.words_out = (uint32_t*)words_out;
  a.lists = (const int32_t*)lists;
  a.counts = (const int32_t*)counts;
  a.nb = nb;
  std::memcpy(&a.aw, &aw_bits, sizeof a.aw);
  a.exact = exact != 0;
  a.lad = bc7::ExactLadder{rounds, deltas};
  a.stream = (cudaStream_t)stream;
  int (*const launch[8])(const bc7::RefineArgs&) = {
      bc7::launch_refine_mode_0, bc7::launch_refine_mode_1,
      bc7::launch_refine_mode_2, bc7::launch_refine_mode_3,
      bc7::launch_refine_mode_4, bc7::launch_refine_mode_5,
      bc7::launch_refine_mode_6, bc7::launch_refine_mode_7};
  for (int m = 0; m < 8 && rc == 0; ++m)
    if ((mode_mask >> m) & 1) rc = launch[m](a);
  return rc;
}
