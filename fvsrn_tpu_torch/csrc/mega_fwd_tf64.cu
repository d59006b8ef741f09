// The megakernel's forward (the render and the training forward) at hidden
// width 64, the instances of the TF modes other than piecewise (texture, 1D-
// and 2D-preintegrated, Gaussians) of SnakeAlt networks without direction
// input: the kernel is mega_fwd.cuh (MEGA_PART 1), a library of its own,
// built in parallel with the others.
#define MEGA_WIDTH 64
#define MEGA_PART 1
#include "mega_fwd.cuh"
