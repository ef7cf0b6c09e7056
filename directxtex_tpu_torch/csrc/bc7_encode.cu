// K2, variant kOpaque: the default tier's search over modes
// (1, 3, 5, 6, 4), as a team of four warps per 32 blocks
// (bc7_encode.cuh's bc7_encode_opaque_kernel); this source builds its
// instances.
#include "bc7_encode.cuh"

extern "C" int bc7_encode_launch(const void* px, void* err, void* words,
                                 void* picks, int nb, int aw_bits,
                                 void* stream) {
  return bc7::launch_encode<bc7::kOpaque>(px, err, words, picks, nb, aw_bits,
                                          stream);
}
