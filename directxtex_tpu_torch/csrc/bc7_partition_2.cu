// K7, mode 2: the instances of bc7_partition.cuh's kernel for mode 2
// (three subsets), launched through bc7_partition.cu's entry point.
#include "bc7_partition.cuh"

int bc7::launch_partition_mode2(const void* px, const void* s_blks,
                                void* err, void* words, int nb, int n_cand,
                                int aw_bits, void* stream) {
  return launch_partition<2>(px, s_blks, err, words, nb, n_cand, aw_bits,
                             stream);
}
