// The per-segment engine's packed weights (segment_common.cuh's `Wts`) on
// the warp-owned tile (warp_mlp.cuh): staging them into a launch's
// shared-memory plan, and the tile's dims and plan of a call. Shared by
// the per-segment march (segment_fwd.cu) and the sample evaluator
// (sample_eval.cu), which read the same packed weights.
#pragma once

#include "segment_common.cuh"
#include "warp_mlp.cuh"

namespace segment {

using wmlp::FDims;
using wmlp::FLayer;
using wmlp::FPlan;

// The packed weights into the plan's layout: the first layer's inputs in
// the tile's column order, zeros for the padding; B and Bd padded to F4
// rows; D.tfn floats of the TF (none for the evaluator).
template <int H>
__device__ __forceinline__ void stage_weights(const Seg& P, const FPlan& pl,
                                              const FDims& D, float* sm) {
  const int F = D.F, nh = D.nh;
  const int K1 = 6 + 2 * F + kLat * D.chunks;
  const float* w = P.weights;
  wmlp::stage_matrix<H>(pl, sm + pl.W1, D.K, [&](int k, int o) {
    int src;   // the packed row: pos 3, dir 3, cos F, sin F, latent
    if (k < D.sin) src = 6 + k - D.cos;
    else if (k < D.lat) src = 6 + F + k - D.sin;
    else if (k < D.pos) src = 6 + 2 * F + k - D.lat;
    else src = k - D.pos < (D.has_dir ? 6 : 3) ? k - D.pos : -1;
    return src >= 0 ? w[src * H + o] : 0.0f;
  });
  const int off_wh = K1 * H + H;
  // the wide plan reads its hidden matrices from device memory
  for (int l = 0; l < (smlp::wide_width(H) ? 0 : nh); ++l)
    wmlp::stage_matrix<H>(pl, sm + pl.Wh + l * pl.wl, H,
                          [&](int k, int o) {
                            return w[off_wh + (l * H + k) * H + o];
                          });
  // b1; bh, Wo (4, H), bo (4) as packed; B, Bd padded; TF
  for (int i = threadIdx.x; i < H; i += blockDim.x)
    sm[pl.b1 + i] = w[K1 * H + i];
  const int off_bh = off_wh + nh * H * H, n_tail = nh * H + 4 * H + 4;
  for (int i = threadIdx.x; i < n_tail; i += blockDim.x)
    sm[pl.bh + i] = w[off_bh + i];
  const int off_b = off_bh + n_tail;
  for (int i = threadIdx.x; i < 3 * D.F4; i += blockDim.x) {
    sm[pl.B + i] = i < 3 * F ? w[off_b + i] : 0.0f;
    sm[pl.Bd + i] = i < 3 * F ? w[off_b + 3 * F + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < D.tfn; i += blockDim.x)
    sm[pl.TF + i] = w[off_b + 6 * F + i];
}

// The tile's dims and the shared-memory plan of a call whose block takes
// `tp` TF points (the call's TF; 0: none), staged up to kTfStaged
// piecewise knots or Gaussians; false when no plan fits.
inline bool fill_layer(FLayer& L, const Seg& P, int hidden, int tp) {
  FDims& D = L.D;
  wmlp::set_columns(D, P.n_fourier, P.chunks, P.has_dir);
  D.nh = P.n_hidden;
  D.tp = tp;
  D.tpre = P.tf_pre;
  D.tfn = tp ? staged_tf_floats(P.tfm, tp, P.tf_floats) : 0;
  D.tf2d = P.tf2d;
  // a piecewise or Gaussian TF above kTfStaged points: the packed one
  D.tfg = tp && D.tfn < P.tf_floats ? carve(P.weights, P, hidden).TF
                                    : nullptr;
  D.has_dir = P.has_dir;
  D.act = P.act;
  D.head = P.head;
  D.n_out = P.head >= kRgbo ? 4 : 1;
  D.blend_alpha = P.blend_alpha;
  D.iso = P.iso;
  D.p = P.act_param;
  D.inv_p = 1.0f / P.act_param;
  D.inv_2p = 1.0f / (2.0f * P.act_param);
  D.iso_value = P.iso_value;
  D.density_min = P.density_min;
  D.inv_range = P.inv_range;
  D.h = P.stepsize;
  D.gx = P.gx;
  D.gy = P.gy;
  D.gz = P.gz;
  D.table = P.table;
  // the wide plan's hidden matrices: the packed ones, input-major
  D.wg = P.weights == nullptr
             ? nullptr
             : P.weights + (6 + 2 * P.n_fourier + kLat * P.chunks) * hidden
                   + hidden;
  D.wg_k = hidden;
  D.wg_o = 1;
  D.wg_l = hidden * hidden;
  return wmlp::choose_fwd_plan(hidden, D.K, D.nh, D.F4, D.tfn, 0, L.pl);
}

}  // namespace segment
