// The megakernel's forward (the render and the training forward) at hidden width 64: the kernel is
// mega_fwd.cuh; one source per width, so that nvcc builds the widths in
// parallel, each into its own library.
#define MEGA_WIDTH 64
#include "mega_fwd.cuh"
