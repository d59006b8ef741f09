// The megakernel's forward at hidden width 128, every network other than
// SnakeAlt without direction input on the Gaussian TF, unmasked (the
// training forward's): the kernel is mega_fwd.cuh (MEGA_PART 4) on
// warp_mlp.cuh's wide plan, a library of its own.
#define MEGA_WIDTH 128
#define MEGA_PART 4
#include "mega_fwd.cuh"
