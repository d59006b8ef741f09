// The per-segment fused march's forward at hidden width 128 (warp_mlp.cuh's
// wide plan), the piecewise TF's instances, a library of its own.
#define SEGMENT_WIDE 1
#include "segment_fwd.cu"
