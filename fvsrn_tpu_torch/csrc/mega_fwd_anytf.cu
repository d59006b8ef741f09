// The megakernel's forward (the render) at hidden width 32, the instances
// of every network other than SnakeAlt without direction input (any
// activation, direction input) on the texture, 1D- and 2D-preintegrated
// TFs: the kernel is mega_fwd.cuh (MEGA_PART 3), a library of its own,
// built in parallel with the others.
#define MEGA_WIDTH 32
#define MEGA_PART 3
#include "mega_fwd.cuh"
