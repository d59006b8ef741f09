// The megakernel's normals instances at hidden width 32 (mega_fwd.cuh,
// MEGA_NORMALS): a library of its own, built in parallel with the others.
#define MEGA_WIDTH 32
#define MEGA_NORMALS
#include "mega_fwd.cuh"
