// K3 with an exact ladder (LADDER_FULL, LADDER_LIGHT): the maxq tier's
// second refine. The kernel is bc7_refine.cuh's; this source builds its
// exact-ladder instances. rounds and deltas (one byte each, low byte
// first, a zero byte ends the list) are launch arguments.
#include "bc7_refine.cuh"

extern "C" int bc7_refine_ladder_launch(const void* px, const void* words_in,
                                        void* words_out, int nb,
                                        int mode_mask, int aw_bits,
                                        int rounds, int deltas,
                                        void* stream) {
  return bc7::launch_refine<bc7::kExact, true>(
      px, words_in, words_out, nb, mode_mask, aw_bits,
      bc7::ExactLadder{rounds, deltas}, stream);
}
