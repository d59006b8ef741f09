// The megakernel's forward (the render and the training forward) at hidden
// width 64, the instances of SnakeAlt networks without direction input on the
// piecewise TF (the product's; the other networks and TF modes are
// mega_fwd_any64.cu and mega_fwd_tf64.cu): the kernel is mega_fwd.cuh
// (MEGA_PART 0), a library of its own, built in parallel with the others.
#define MEGA_WIDTH 64
#include "mega_fwd.cuh"
