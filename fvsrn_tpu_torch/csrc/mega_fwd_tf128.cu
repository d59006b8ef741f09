// The megakernel's forward at hidden width 128, SnakeAlt networks without
// direction input on the texture, 1D- and 2D-preintegrated and Gaussian
// TFs: the kernel is mega_fwd.cuh (MEGA_PART 1) on warp_mlp.cuh's wide
// plan, a library of its own, built in parallel with the others.
#define MEGA_WIDTH 128
#define MEGA_PART 1
#include "mega_fwd.cuh"
