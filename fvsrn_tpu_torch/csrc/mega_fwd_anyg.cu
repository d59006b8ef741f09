// The megakernel's forward at hidden width 32, the instances of every
// network other than SnakeAlt without direction input (any activation,
// direction input) on the Gaussian TF, unmasked (the training forward's:
// the render refuses Gaussians): the kernel is mega_fwd.cuh (MEGA_PART 4),
// a library of its own, built in parallel with the others.
#define MEGA_WIDTH 32
#define MEGA_PART 4
#include "mega_fwd.cuh"
