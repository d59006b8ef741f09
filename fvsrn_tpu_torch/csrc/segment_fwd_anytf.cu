// The per-segment fused march's forward, the instances of the texture, 1D-
// and 2D-preintegrated TFs for every activation other than SnakeAlt (the
// generic activation switch; segment_fwd.cuh's SEGMENT_TF_MODES 2), a
// library of their own.
#define SEGMENT_TF_MODES 2
#include "segment_fwd.cu"
