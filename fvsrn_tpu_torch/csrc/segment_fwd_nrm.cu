// The per-segment fused march's normals instances (segment_fwd.cuh's
// segment_nrm_kernel): a library of their own, built in parallel with the
// render's.

#include "segment_fwd.cuh"

// One phase of the normals march: segment_fwd_launch's arguments for a
// density head and the piecewise TF (no carries, no iso), with `nd`
// ((R,) float4: phase 0 writes it, phase 1 continues from it) the blended
// normal and depth, and the shading: shade_i = [magnitude scaling on, Phong
// on, directional light, specular exponent], shade_f = [magnitude scaling,
// ambient, specular, smoothstep edge, smoothstep width, lobe
// normalisation, light x, y, z] (march_common.cuh's Shade; host arrays).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int segment_fwd_nrm_launch(
    const float* rays, const float* kbase, const void* table, int table_f32,
    const float* weights, int n_weights, float* out, float* nd, int* death,
    unsigned long long* stats, int n_rays, int gx, int gy, int gz, int chunks,
    int n_fourier, int n_hidden, int hidden, int tf_points, int act,
    float act_param, int head, int has_dir, int lattice, int blend_alpha,
    int seg, int n_seg, float stepsize, float density_min, float inv_range,
    float early_alpha, float bmin_x, float bmin_y, float bmin_z,
    float bsize_x, float bsize_y, float bsize_z, int phase,
    const int* shade_i, const float* shade_f, void* stream) {
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  const Seg P = make_seg(rays, kbase, table, weights, n_weights, n_rays, gx,
                         gy, gz, chunks, n_fourier, n_hidden, tf_points, act,
                         act_param, head, has_dir, lattice, blend_alpha, 0,
                         0.0f, seg, n_seg, stepsize, density_min, inv_range,
                         early_alpha, bmin, bsize);
  if (!seg_valid(P) || head > kDensityDirect || (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
  FLayer L;
  if (!fill_layer(L, P, hidden, P.tf_points))
    return (int)cudaErrorInvalidValue;
  const Shade S = make_shade(shade_i, shade_f);
  SegOut O;
  O.out = reinterpret_cast<float4*>(out);
  O.death = death;
  O.stats = stats;
  O.carries = nullptr;
  O.dens = nullptr;
  O.dens_carries = nullptr;
  float4* nd4 = reinterpret_cast<float4*>(nd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32
             ? launch_nrm_width<F32Table>(P, O, L, hidden, phase, S, nd4, st)
             : launch_nrm_width<Bf16Table>(P, O, L, hidden, phase, S, nd4,
                                           st);
}
