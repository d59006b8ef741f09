// The megakernel's forward (the render and the training forward) at hidden
// width 32, the instances of SnakeAlt networks without direction input on the
// piecewise TF (the product's; the other networks and TF modes are
// mega_fwd_any.cu and mega_fwd_tf.cu): the kernel is mega_fwd.cuh (MEGA_PART
// 0), a library of its own, built in parallel with the others.
#define MEGA_WIDTH 32
#include "mega_fwd.cuh"
