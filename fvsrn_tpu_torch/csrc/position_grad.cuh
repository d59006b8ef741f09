// The SRN's position gradient on one sample, shared by the sample
// evaluator's gradient instance (sample_eval.cu, TPU kernel row 7) and the
// normals instances of the fused forwards (mega_fwd.cuh, segment_fwd.cuh;
// rows 1 and 4): the adjoint normal sweep of the JAX package's
// _mlp_position_grad_T (fvsrn_tpu/ops/fused_dvr.py:1216). From the
// evaluation that segment_common.cuh's `network` records (`Keep`): dv/dy
// from the head's adjoint (strict gates: a clipped density has no
// gradient), a sweep back through the hidden layers and, at the first
// layer, the position rows, the Fourier term B^T (cos * d_sin - sin *
// d_cos) and the analytic trilinear derivative (each axis' lerp factor
// replaced by +-1, times the grid size on that axis). No gradient with
// respect to the direction.
//
// Bound: operations, about twice a sample's forward multiply-adds on the
// CUDA cores (the recorded forward and the transposed layers), one thread a
// sample; the record (every layer's activation derivative) lives in local
// memory at the wider widths.
#pragma once

#include "segment_common.cuh"

namespace segment {

// d value / d pos01 of one evaluation recorded in `keep` (head values `v`).
// `hs` is the thread's column of the activation scratch (stride kStride):
// each transposed layer writes its outputs there, so the loop over them
// is a loop and not H unrolled copies (nvcc's time stays in seconds).
template <int H, typename Table, int kStride>
__device__ __forceinline__ void position_grad(const Seg& P, const Wts& N,
                                              const Keep<H>& keep,
                                              const float* v, float* hs,
                                              float* g) {
  const int F = P.n_fourier;
  const float d_out[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  float d_y[4];
  head_adjoint(P.head, keep.y, v, d_out, d_y);
  float dh[H];
#pragma unroll
  for (int i = 0; i < H; ++i) dh[i] = N.Wo[i] * d_y[0];
#pragma unroll 1
  for (int l = P.n_hidden; l >= 0; --l) {
    const float* dact = keep.dact + l * H;
#pragma unroll
    for (int o = 0; o < H; ++o) dh[o] *= dact[o];
    if (l == 0) break;
    const float* W = N.Wh + (l - 1) * H * H;
#pragma unroll 1
    for (int i = 0; i < H; ++i) hs[i * kStride] = dot_row<H>(W + i * H, dh);
#pragma unroll
    for (int o = 0; o < H; ++o) dh[o] = hs[o * kStride];
  }
  // dh: the first layer's pre-activation cotangent. Position rows:
  float g0 = dot_row<H>(N.W1, dh);
  float g1 = dot_row<H>(N.W1 + H, dh);
  float g2 = dot_row<H>(N.W1 + 2 * H, dh);
  // Fourier features: d phase_i = cos_i * d_sin_i - sin_i * d_cos_i
#pragma unroll 1
  for (int i = 0; i < F; ++i) {
    const float d_cos = dot_row<H>(N.W1 + (6 + i) * H, dh);
    const float d_sin = dot_row<H>(N.W1 + (6 + F + i) * H, dh);
    const float d_f = keep.in1[6 + i] * d_sin - keep.in1[6 + F + i] * d_cos;
    g0 = fmaf(N.B[3 * i], d_f, g0);
    g1 = fmaf(N.B[3 * i + 1], d_f, g1);
    g2 = fmaf(N.B[3 * i + 2], d_f, g2);
  }
  // latent grid: s_k = <d_lat, corner k's row>, then the derivative of
  // each corner weight along each axis
  if (P.chunks > 0) {
    const float x0 = keep.in1[0], x1 = keep.in1[1], x2 = keep.in1[2];
    Corners c;
    grid_corners(P.gx, P.gy, P.gz, x0, x1, x2, c);
    int lo, hi;
    float fx, fy, fz;
    corner_axis(x0, P.gx, lo, hi, fx);
    corner_axis(x1, P.gy, lo, hi, fy);
    corner_axis(x2, P.gz, lo, hi, fz);
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = 0.0f;
#pragma unroll 1
    for (int q = 0; q < P.chunks; ++q) {
      float d_lat[kLat];
#pragma unroll
      for (int ch = 0; ch < kLat; ++ch)
        d_lat[ch] = dot_row<H>(N.W1 + (6 + 2 * F + kLat * q + ch) * H, dh);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float row[kLat];
#pragma unroll
        for (int ch = 0; ch < kLat; ++ch) row[ch] = 0.0f;
        Table::add(P.table, c.row[k] * P.chunks + q, 1.0f, row);
#pragma unroll
        for (int ch = 0; ch < kLat; ++ch)
          s[k] = fmaf(d_lat[ch], row[ch], s[k]);
      }
    }
    g[0] = g0;
    g[1] = g1;
    g[2] = g2;
    trilerp_position_grad(s, fx, fy, fz, P.gx, P.gy, P.gz, g);
    return;
  }
  g[0] = g0;
  g[1] = g1;
  g[2] = g2;
}

// The normals of the fused forwards' rows (wmlp::warp_chunk's `Nrm`): a
// row's sample through the scalar `network` recorded, then position_grad,
// divided by the box size (the world-space gradient). `P` holds the
// network in the per-segment engine's packed layout (`Wts`, in global
// memory) and the box; `S` the shading (march_common.cuh).
struct RowNormal {
  static constexpr bool kOn = true;
  const Seg& P;
  const Shade& S;

  // g = d value / d world position at normalized position x, direction d;
  // `hs` is H floats of the lane's own scratch (stride 1).
  template <int H, typename Table>
  __device__ __forceinline__ void grad(float* hs, const float* x,
                                       const float* d, float* g) const {
    const Wts N = carve(P.weights, P, H);
    float v[4];
    Keep<H> keep;
    network<H, Table, 1, true>(P, N, hs, x[0], x[1], x[2], d[0], d[1], d[2],
                               v, &keep);
    position_grad<H, Table, 1>(P, N, keep, v, hs, g);
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] /= P.bsize[c];
  }
};

}  // namespace segment
