// The megakernel's backward at hidden width 64 on 128-ray tiles
// (mega_common.cuh's MEGA_TILE): the kernel is mega_bwd.cuh; a library of
// its own, built in parallel with the others.
#define MEGA_WIDTH 64
#define MEGA_TILE 128
#include "mega_bwd.cuh"
