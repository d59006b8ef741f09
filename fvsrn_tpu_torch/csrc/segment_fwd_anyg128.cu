// The per-segment fused march's forward at hidden width 128, the Gaussian
// TF of every other activation (SEGMENT_TF_MODES 3), a library of its own.
#define SEGMENT_WIDE 1
#define SEGMENT_TF_MODES 3
#include "segment_fwd.cu"
