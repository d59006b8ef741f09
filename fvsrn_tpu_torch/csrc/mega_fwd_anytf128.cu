// The megakernel's forward at hidden width 128, every network other than
// SnakeAlt without direction input on the texture, 1D- and 2D-preintegrated
// TFs: the kernel is mega_fwd.cuh (MEGA_PART 3) on warp_mlp.cuh's wide
// plan, a library of its own.
#define MEGA_WIDTH 128
#define MEGA_PART 3
#include "mega_fwd.cuh"
