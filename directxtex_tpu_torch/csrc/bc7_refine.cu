// K3 with LADDER_MOMENT: the default tier's refine and the maxq tier's
// first refine. The kernel is bc7_refine.cuh's; this source builds its
// moment instances. Mode-mask bit 6 (mode 6 in scope, the maxq tier)
// takes the instance with mode 6; without it the default tier's instance
// runs, which has no mode-6 code.
#include "bc7_refine.cuh"

extern "C" int bc7_refine_launch(const void* px, const void* words_in,
                                 void* words_out, int nb, int mode_mask,
                                 int aw_bits, void* stream) {
  const bc7::ExactLadder none{0, 0};
  if ((mode_mask >> 6) & 1)
    return bc7::launch_refine<bc7::kMoment, true>(
        px, words_in, words_out, nb, mode_mask, aw_bits, none, stream);
  return bc7::launch_refine<bc7::kMoment, false>(
      px, words_in, words_out, nb, mode_mask, aw_bits, none, stream);
}
