// The per-segment fused march's forward, the instances of the TF modes
// other than piecewise (texture, 1D- and 2D-preintegrated, Gaussians;
// segment_fwd.cuh's SEGMENT_TF_MODES), a library of their own.
#define SEGMENT_TF_MODES 1
#include "segment_fwd.cu"
