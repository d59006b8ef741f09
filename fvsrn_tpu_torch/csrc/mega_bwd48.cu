// The megakernel's backward at hidden width 48: the kernel is
// mega_bwd.cuh; one source per width, so that nvcc builds the widths in
// parallel, each into its own library.
#define MEGA_WIDTH 48
#include "mega_bwd.cuh"
