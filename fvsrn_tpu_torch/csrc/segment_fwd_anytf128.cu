// The per-segment fused march's forward at hidden width 128, the texture,
// 1D- and 2D-preintegrated TFs of every other activation (SEGMENT_TF_MODES
// 2), a library of its own.
#define SEGMENT_WIDE 1
#define SEGMENT_TF_MODES 2
#include "segment_fwd.cu"
