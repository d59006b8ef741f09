// The per-segment fused march's forward, the instances of the Gaussian TF
// for every activation other than SnakeAlt (the generic activation switch;
// segment_fwd.cuh's SEGMENT_TF_MODES 3; the training forward's, the render
// refuses Gaussians on these networks), a library of their own.
#define SEGMENT_TF_MODES 3
#include "segment_fwd.cu"
