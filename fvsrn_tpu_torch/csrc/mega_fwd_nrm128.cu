// The megakernel's normals instances at hidden width 128 (mega_fwd.cuh,
// MEGA_NORMALS): the tile's layers on warp_mlp.cuh's wide plan, then each
// counting sample's scalar network and position-gradient sweep
// (position_grad.cuh) on the packed weights in device memory, its record
// in local memory. A library of its own, built in parallel with the
// others.
#define MEGA_WIDTH 128
#define MEGA_NORMALS
#include "mega_fwd.cuh"
