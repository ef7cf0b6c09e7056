// K2, variant kQuick: the QUICK tier's search, mode 6 alone. The kernel is
// bc7_encode.cuh's; this source builds its instances.
#include "bc7_encode.cuh"

extern "C" int bc7_encode_quick_launch(const void* px, void* err,
                                       void* words, int nb, int aw_bits,
                                       void* stream) {
  return bc7::launch_encode<bc7::kQuick>(px, err, words, nb, aw_bits,
                                         stream);
}
