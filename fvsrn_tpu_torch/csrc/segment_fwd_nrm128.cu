// The per-segment fused march's normals instances at hidden width 128
// (segment_fwd.cuh's segment_nrm_kernel): the tile's layers on
// warp_mlp.cuh's wide plan, then each counting sample's scalar network and
// position-gradient sweep (position_grad.cuh) on the packed weights in
// device memory, its record in local memory. A library of its own.
#define SEGMENT_WIDE 1
#include "segment_fwd_nrm.cu"
