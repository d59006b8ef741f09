// The megakernel's backward at hidden width 128: the kernel is
// mega_bwd.cuh on sample_mlp.cuh's wide plan (the hidden matrices read
// from the packed weights in device memory), a library of its own.
#define MEGA_WIDTH 128
#include "mega_bwd.cuh"
