// The megakernel's forward (the render and the training forward) at hidden
// width 32, the instances of every other network (any activation, direction
// input; piecewise TF or rgbo heads): the kernel is mega_fwd.cuh (MEGA_PART
// 2), a library of its own, built in parallel with the others.
#define MEGA_WIDTH 32
#define MEGA_PART 2
#include "mega_fwd.cuh"
