// The per-segment fused march's forward, the render's and the training
// forward's instances (the kernels are segment_fwd.cuh): the piecewise
// TF's here, the other TF modes' of SnakeAlt networks in segment_fwd_tf.cu,
// the texture and preintegrated TFs' of every other activation in
// segment_fwd_anytf.cu and their Gaussians' in segment_fwd_anyg.cu, which
// include this file with SEGMENT_TF_MODES 1, 2 and 3.

#include "segment_fwd.cuh"

#ifdef SMLP_PROFILE
// The phase timers' sums since the last read (march_common.cuh), reset.
extern "C" int smlp_prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, smlp_prof, sizeof(smlp_prof));
  unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(smlp_prof, zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif

// The shared-memory plan a launch takes for these widths (warp_mlp.cuh's
// choose_fwd_plan) with `tf_floats` TF floats (5 a piecewise knot): out =
// [bytes, warps a block, matrices pre-split]. Returns 0, or -1 when no
// plan fits in 227 KB.
extern "C" int segment_fwd_smem(int hidden, int n_fourier, int chunks,
                                int n_hidden, int tf_floats, int has_dir,
                                long* out) {
  FDims D;
  set_columns(D, n_fourier, chunks, has_dir);
  FPlan pl;
  if (!choose_fwd_plan(hidden, D.K, n_hidden, D.F4, tf_floats, 0, pl))
    return -1;
  out[0] = pl.total;
  out[1] = pl.warps;
  out[2] = pl.pre;
  return 0;
}

// One phase of the march (0: each ray to its own death, 1: the
// continuation up to the call's stop). Weights packed as `Wts`
// (segment_common.cuh) with the padded hidden width `hidden` (32, 48 or
// 64). `table` is (gz, gy, gx, 16 * chunks), bf16 (table_f32 = 0) or
// float32; with chunks = 0 it is not read. `kbase` is read in lattice mode
// only. `stats` ([S, samples], int64) must be zero before phase 0. With
// `carries` ((n_seg, R) float4, phase 0 only) each ray also stores the
// carry entering every segment it runs, for the backward
// (segment_bwd.cu). The TF: mode `tfm` (march_common.cuh's TfMode; every
// mode takes every activation), `tf_points` rows, `tf_pre`
// cumulative rows, `tf_floats` packed floats, `tf2d` the preint2d table
// ((tf_points, tf_points) float4); those modes keep each ray's last density
// in `dens` ((R,) float, phase 0 writes it, phase 1 reads it) and, with
// carries, in `dens_carries` ((n_seg, R) float). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int segment_fwd_launch(
    const float* rays, const float* kbase, const void* table, int table_f32,
    const float* weights, int n_weights, float* out, int* death,
    unsigned long long* stats, float* carries, int n_rays, int gx, int gy,
    int gz, int chunks, int n_fourier, int n_hidden, int hidden,
    int tf_points, int act, float act_param, int head, int has_dir,
    int lattice, int blend_alpha, int iso, float iso_value, int seg,
    int n_seg, float stepsize, float density_min, float inv_range,
    float early_alpha, float bmin_x, float bmin_y, float bmin_z,
    float bsize_x, float bsize_y, float bsize_z, int phase, int tfm,
    int tf_pre, int tf_floats, const float* tf2d, float* dens,
    float* dens_carries, void* stream) {
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  Seg P = make_seg(rays, kbase, table, weights, n_weights, n_rays, gx, gy,
                   gz, chunks, n_fourier, n_hidden, tf_points, act,
                   act_param, head, has_dir, lattice, blend_alpha, iso,
                   iso_value, seg, n_seg, stepsize, density_min, inv_range,
                   early_alpha, bmin, bsize);
  P.tfm = tfm;
  P.tf_pre = tf_pre;
  P.tf_floats = tf_floats;
  P.tf2d = reinterpret_cast<const float4*>(tf2d);
  if (!seg_valid(P) || (phase != 0 && phase != 1)
      || (carries != nullptr && phase != 0)
      || (tfm != kTfPiecewise
          && (iso || dens == nullptr
              || (carries != nullptr && dens_carries == nullptr))))
    return (int)cudaErrorInvalidValue;
  FLayer L;
  if (!fill_layer(L, P, hidden, P.tf_points))
    return (int)cudaErrorInvalidValue;
  SegOut O;
  O.out = reinterpret_cast<float4*>(out);
  O.death = death;
  O.stats = stats;
  O.carries = reinterpret_cast<float4*>(carries);
  O.dens = dens;
  O.dens_carries = dens_carries;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch_width<F32Table>(P, O, L, hidden, phase, st)
                   : launch_width<Bf16Table>(P, O, L, hidden, phase, st);
}
