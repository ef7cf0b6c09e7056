// K2, variant kMaxq: the maxq tier's search over modes (1, 3, 5, 6, 4),
// every mode fitted on its own. The kernel is bc7_encode.cuh's; this
// source builds its instances.
#include "bc7_encode.cuh"

extern "C" int bc7_encode_maxq_launch(const void* px, void* err, void* words,
                                      void* picks, int nb, int aw_bits,
                                      void* stream) {
  return bc7::launch_encode<bc7::kMaxq>(px, err, words, picks, nb, aw_bits,
                                        stream);
}
