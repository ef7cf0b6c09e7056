// K3, mode 3: its instances of bc7_refine.cuh's bc7_refine_mode_kernel
// (LADDER_MOMENT and the exact ladders, unweighted and weighted), launched
// by bc7_refine.cu on the mode-3 bucket.
#include "bc7_refine.cuh"

int bc7::launch_refine_mode_3(const RefineArgs& a) {
  return launch_refine_mode<3>(a);
}
