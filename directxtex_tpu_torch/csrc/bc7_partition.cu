// K7: the launcher of every mode, and the instances of modes 1, 3 and 7
// (their fits are the maxq team's, eval_partition_ns). The kernel is
// bc7_partition.cuh's team.
#include "bc7_partition.cuh"

// mode: 0, 1, 2, 3 or 7; anything else returns cudaErrorInvalidValue
// unlaunched. s_blks [n_cand, NB] int32 shape candidates.
extern "C" int bc7_partition_mode_launch(const void* px, const void* s_blks,
                                         void* err, void* words, int nb,
                                         int n_cand, int mode, int aw_bits,
                                         void* stream) {
  switch (mode) {
    case 0: return bc7::launch_partition_mode0(px, s_blks, err, words, nb,
                                               n_cand, aw_bits, stream);
    case 1: return bc7::launch_partition<1>(px, s_blks, err, words, nb,
                                            n_cand, aw_bits, stream);
    case 2: return bc7::launch_partition_mode2(px, s_blks, err, words, nb,
                                               n_cand, aw_bits, stream);
    case 3: return bc7::launch_partition<3>(px, s_blks, err, words, nb,
                                            n_cand, aw_bits, stream);
    case 7: return bc7::launch_partition<7>(px, s_blks, err, words, nb,
                                            n_cand, aw_bits, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
