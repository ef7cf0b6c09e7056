// K8 — BC7 modes 4, 5 and 6 in one pass, each mode's winner emitted, as a
// team: a CTA of five warps takes 32 blocks, one per lane.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:single_modes_pallas /
// _single_modes_kernel at its defaults (rotations 0-3, mode-4 index modes
// m4_ims = _MODE4_IMS = (0,)). Plain twins: bc67._try_mode6 and
// bc67._try_single_mode45 (the JAX package's _try_single_mode), in the
// same operation order; the team's plain form is
// bc67._single_modes_jobs_plain + _single_modes_fold_plain.
//
// Design. A block's nine evaluations run as five jobs, job j on warp j,
// the same job on every lane of a warp:
//   jobs 0-3  rotation j: rot_data_ns, then mode 4 at index mode 0 and
//             mode 5 (eval_45_packed), each into its slot;
//   job 4     mode 6 (eval_mode6_packed).
// The CTA stages its 32 blocks' packed RGBA8 pixels once in shared
// memory, and a job reads them through PixShared at each pass, rotated
// by its rotation, never from a register copy. These are the maxq team's
// rotation and mode-6 jobs (bc7_encode.cuh), whose packed fits equal the
// one-subset fits bit for bit. After a barrier warp 0 folds each block:
// modes 4 and 5 each over rotations 0-3 in order with keep_if_better's
// strict `<` (the twins' order), mode 6 as it is. The weighted instance
// (W) scales the alpha channel's squared error by alpha_weight; at 1.0
// the unweighted one runs.
//
// Why: the one-thread kernel ran a block's nine evaluations in one
// dependence chain at 255 registers, 8 warps an SM. Here a warp holds one
// job's state at 96 registers (4 CTAs, 20 warps an SM; a little spill).
// Four warps, job j on warp j % 4, held 128 registers without spill and
// ran slower: warp 0 carried two jobs while the others waited at the
// barrier (PERF.md).
//
// Bound: operations. A block reads 64 bytes and writes 3 x 20, against
// about 5 x 10^4 operations (tests/test_torch_op_counts.py).
//
// Built with --fmad=false: every float step rounds as the plain twins'
// separate torch ops do, so kernel and twins pick the same words.
#include "bc7_encode.cuh"

namespace bc7 {

// result slots of a block: mode 4 per rotation, mode 5 per rotation,
// mode 6
enum SingleSlot { kS4 = 0, kS5 = 4, kS6 = 8, kSSlots = 9 };
constexpr int kSJobs = 5;                       // rotations 0-3, mode 6
constexpr int kSWarps = kSJobs;                 // one job a warp
constexpr int kSThreads = 32 * kSWarps;

struct SingleSmem {
  uint32_t pix[16][kTeamBlocks];                // packed RGBA8
  struct {
    float err[kSSlots][kTeamBlocks];
    uint32_t w[kSSlots][4][kTeamBlocks];
  } res;
};

// Job j of lane `lane`'s block: j < 4 rotation j, whose rot_data feeds
// mode 4 at index mode 0 and mode 5 in turn; 4 mode 6
template <bool W>
__device__ __forceinline__ void single_job(SingleSmem& sm, int j, int lane,
                                           float aw) {
  if (j < kS5) {
    const PixShared prp{&sm.pix[0][lane], j};
    float e0[4], e1[4];
    rot_data_ns(prp, e0, e1);
    Best r4{INFINITY, {0ull, 0ull}};
    eval_45_packed<4, 0, W>(prp, j, e0, e1, aw, r4);
    team_put(sm, kS4 + j, lane, r4);
    Best r5{INFINITY, {0ull, 0ull}};
    eval_45_packed<5, 0, W>(prp, j, e0, e1, aw, r5);
    team_put(sm, kS5 + j, lane, r5);
  } else {
    team_put(sm, kS6, lane,
             eval_mode6_packed<W>(PixShared{&sm.pix[0][lane], 0}, aw));
  }
}

// Lane `lane`'s fold in the twins' order, stored in mode order 4, 5, 6
// (err [3, NB], words [3, 4, NB]) for a block below nb
__device__ __forceinline__ void single_fold(const SingleSmem& sm, int lane,
                                            float* __restrict__ err,
                                            uint32_t* __restrict__ words,
                                            int nb, int b0) {
  Best best4{INFINITY, {0ull, 0ull}}, best5{INFINITY, {0ull, 0ull}};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    Best x = team_get(sm, kS4 + r, lane);
    keep_if_better(best4, x.err, x.w);
    x = team_get(sm, kS5 + r, lane);
    keep_if_better(best5, x.err, x.w);
  }
  const Best best6 = team_get(sm, kS6, lane);
  const int b = b0 + lane;
  if (b < nb) {
    err[b] = best4.err;
    err[nb + b] = best5.err;
    err[2 * nb + b] = best6.err;
    store_words(words, nb, b, best4.w);
    store_words(words + 4 * (size_t)nb, nb, b, best5.w);
    store_words(words + 8 * (size_t)nb, nb, b, best6.w);
  }
}

template <bool W>
__global__ void __launch_bounds__(kSThreads, 4)
    bc7_single_modes_team_kernel(const int32_t* __restrict__ px,
                                 float* __restrict__ err,
                                 uint32_t* __restrict__ words, int nb,
                                 float aw) {
  __shared__ SingleSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kTeamBlocks;
  // pixel i of block b0 + l into pix[i][l]; a lane past the last block
  // stages zeros (its results are never stored)
#pragma unroll 1
  for (int slot = tid; slot < 16 * kTeamBlocks; slot += kSThreads) {
    const int i = slot / kTeamBlocks, l = slot % kTeamBlocks;
    const int b = b0 + l;
    uint32_t v = 0;
    if (b < nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v |= ((uint32_t)px[(i * 4 + c) * nb + b] & 0xFFu) << (8 * c);
    }
    sm.pix[i][l] = v;
  }
  __syncthreads();
  single_job<W>(sm, warp, lane, aw);
  __syncthreads();
  if (warp == 0) single_fold(sm, lane, err, words, nb, b0);
}

}  // namespace bc7

// alpha_weight arrives as its f32 bit pattern; at 1.0 the unweighted
// instance runs
extern "C" int bc7_single_modes_launch(const void* px, void* err,
                                       void* words, int nb, int aw_bits,
                                       void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const int grid = (nb + bc7::kTeamBlocks - 1) / bc7::kTeamBlocks;
  const cudaStream_t s = (cudaStream_t)stream;
  if (aw != 1.0f)
    bc7::bc7_single_modes_team_kernel<true><<<grid, bc7::kSThreads, 0, s>>>(
        (const int32_t*)px, (float*)err, (uint32_t*)words, nb, aw);
  else
    bc7::bc7_single_modes_team_kernel<false><<<grid, bc7::kSThreads, 0, s>>>(
        (const int32_t*)px, (float*)err, (uint32_t*)words, nb, aw);
  return (int)cudaGetLastError();
}
