// The megakernel's backward at hidden width 64: the kernel is
// mega_bwd.cuh; one source per width, so that nvcc builds the widths in
// parallel, each into its own library.
#define MEGA_WIDTH 64
#include "mega_bwd.cuh"
