// K8 — BC7 modes 4, 5 and 6 in one pass, each mode's winner emitted, one
// thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:single_modes_pallas /
// _single_modes_kernel at its defaults (rotations 0-3, mode-4 index modes
// m4_ims = _MODE4_IMS = (0,)). Plain twins: bc67._try_mode6 and
// bc67._try_single_mode45 (the JAX package's _try_single_mode), in the
// same operation order. The body is K2's device code (bc7_encode.cuh):
// eval_mode6 (axis fit, assign, LS refit, re-assign, keep the better,
// anchor swap), and per rotation rot_data (RGB axis fit with alpha
// min/max) feeding eval_45_own<4, 0> and eval_45_own<5, 0> (each
// candidate fitted on its own: quantize, colour and alpha assignment, one
// LS refit per group, re-evaluate, keep the better, independent colour and
// alpha anchor fixes). Each mode keeps its own best over the rotations
// with a strict `<`, in rotation order, as the twins fold. The weighted
// instance (W) scales the alpha channel's squared error by alpha_weight;
// at 1.0 the unweighted one runs.
//
// Bound: operations. A block reads 64 bytes and writes 3 x 20, against
// about 4 x 10^4 operations (tests/test_torch_op_counts.py). The design
// is K2's: packed pixels, one rotation's fit state live at a time.
//
// Built with --fmad=false: every float step rounds as the plain twins'
// separate torch ops do, so kernel and twins pick the same words.
#include "bc7_encode.cuh"

namespace bc7 {

template <bool W>
__global__ void __launch_bounds__(kThreads)
    bc7_single_modes_kernel(const int32_t* __restrict__ px,
                            float* __restrict__ err,
                            uint32_t* __restrict__ words, int nb, float aw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);
  Best best4{INFINITY, {0ull, 0ull}}, best5{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int rot = 0; rot < 4; ++rot) {
    uint32_t prp[16];
    float e0[4], e1[4];
    rot_data(pix, rot, prp, e0, e1);
    eval_45_own<4, 0, W>(prp, rot, e0, e1, aw, best4);
    eval_45_own<5, 0, W>(prp, rot, e0, e1, aw, best5);
  }
  const Best best6 = eval_mode6<W>(pix, aw);
  // outputs in mode order 4, 5, 6: err [3, NB], words [3, 4, NB]
  err[b] = best4.err;
  err[nb + b] = best5.err;
  err[2 * nb + b] = best6.err;
  store_words(words, nb, b, best4.w);
  store_words(words + 4 * (size_t)nb, nb, b, best5.w);
  store_words(words + 8 * (size_t)nb, nb, b, best6.w);
}

}  // namespace bc7

// alpha_weight arrives as its f32 bit pattern; at 1.0 the unweighted
// instance runs
extern "C" int bc7_single_modes_launch(const void* px, void* err,
                                       void* words, int nb, int aw_bits,
                                       void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const int grid = (nb + bc7::kThreads - 1) / bc7::kThreads;
  if (aw != 1.0f)
    bc7::bc7_single_modes_kernel<true>
        <<<grid, bc7::kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)px, (float*)err, (uint32_t*)words, nb, aw);
  else
    bc7::bc7_single_modes_kernel<false>
        <<<grid, bc7::kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)px, (float*)err, (uint32_t*)words, nb, aw);
  return (int)cudaGetLastError();
}
