// K2, variant kMaxqAlpha: the maxq tier's search on images with alpha,
// modes (1, 3, 5, 6, 7, 4), every mode fitted on its own. The kernel is
// bc7_encode.cuh's; this source builds its instances.
#include "bc7_encode.cuh"

extern "C" int bc7_encode_maxq_alpha_launch(const void* px, void* err,
                                            void* words, int nb,
                                            int aw_bits, void* stream) {
  return bc7::launch_encode<bc7::kMaxqAlpha>(px, err, words, nb, aw_bits,
                                             stream);
}
