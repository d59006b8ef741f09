// The per-segment fused march's forward at hidden width 128, the other TF
// modes of SnakeAlt networks (SEGMENT_TF_MODES 1), a library of its own.
#define SEGMENT_WIDE 1
#define SEGMENT_TF_MODES 1
#include "segment_fwd.cu"
