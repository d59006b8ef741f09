// The megakernel's forward (the render and the training forward) at hidden
// width 128, SnakeAlt networks without direction input on the piecewise
// TF: the kernel is mega_fwd.cuh (MEGA_PART 0) on warp_mlp.cuh's wide
// plan (the hidden matrices read from device memory), a library of its
// own, built in parallel with the others.
#define MEGA_WIDTH 128
#define MEGA_PART 0
#include "mega_fwd.cuh"
