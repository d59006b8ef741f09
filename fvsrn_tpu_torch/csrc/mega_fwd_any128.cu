// The megakernel's forward at hidden width 128, every other network (any
// activation, direction input) on the piecewise TF or an rgbo head: the
// kernel is mega_fwd.cuh (MEGA_PART 2) on warp_mlp.cuh's wide plan (the
// activation a switch in the epilogue), a library of its own.
#define MEGA_WIDTH 128
#define MEGA_PART 2
#include "mega_fwd.cuh"
