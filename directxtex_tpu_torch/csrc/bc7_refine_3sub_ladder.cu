// K3 with an exact ladder (LADDER_FULL, LADDER_LIGHT) over modes 0 and 2
// (USE_3SUBSETS): the instances of bc7_refine.cuh's
// bc7_refine_3sub_kernel, launched as a second K3 launch beside
// bc7_refine_ladder.cu's instance over the scope's other modes. rounds
// and deltas (one byte each, low byte first, a zero byte ends the list)
// are launch arguments.
#include "bc7_refine.cuh"

extern "C" int bc7_refine_3sub_ladder_launch(const void* px,
                                             const void* words_in,
                                             void* words_out, int nb,
                                             int mode_mask, int aw_bits,
                                             int rounds, int deltas,
                                             void* stream) {
  return bc7::launch_refine_3sub<bc7::kExact>(
      px, words_in, words_out, nb, mode_mask, aw_bits,
      bc7::ExactLadder{rounds, deltas}, stream);
}
