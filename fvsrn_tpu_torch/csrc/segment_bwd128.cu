// The per-segment fused march's backward at hidden width 128
// (sample_mlp.cuh's wide plan), a library of its own.
#define SEGMENT_WIDE 1
#include "segment_bwd.cu"
