// The SRN sample evaluator (sm_90a): density, and optionally its gradient
// with respect to the normalized position, at arbitrary positions.
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_eval.py:_eval_kernel, which
// make_fused_eval launches for every batch of scattered positions (one
// launch per delta-tracking round of Monte-Carlo path tracing). It computes
// the same function, not the TPU's layout: the JAX kernel gathers one
// (N, 128) row of an 8x neighborhood table per position, moves channels
// onto sublanes and evaluates a polynomial sine, all for Mosaic. Here each
// position reads its 8 trilinear corners from the channel-last latent
// table of the per-segment engine (<= 16 channels: 2 MiB in float32 for
// the flagship's 16x32^3 grid, resident in L2), and the network is the
// engine's own per-sample code (segment_common.cuh: `network`), so the
// evaluator and the DVR kernels compute the same SRN with the same
// instances (hidden width 32/48/64, every activation, direction input).
//
// The gradient instance keeps the evaluation (`Keep`), takes dv/dy from
// the head's adjoint (strict gates: a clipped density has no gradient),
// sweeps back through the hidden layers and, at the first layer, sums the
// position rows, the Fourier term B^T (cos * d_sin - sin * d_cos) and the
// analytic trilinear derivative (each axis' lerp factor replaced by +-1,
// times the grid size on that axis), as the JAX kernel's
// _mlp_position_grad_T does. No gradient with respect to the direction.
//
// Layout: one thread per position, 128 threads per block, positions in the
// caller's order; the packed weights (segment_common.cuh `Wts`) are staged
// once per block in shared memory and every thread reads the same weight
// at the same time. Out-of-box positions are evaluated too (the corners
// clamp to the grid's border, as the JAX package's edge-padded table does).
//
// Bound: operations (a flagship position costs ~7.6 kFLOP and ~50
// transcendentals against 16 bytes in and out). This first version runs
// the MLP on the float32 CUDA cores, one position per thread.

#include "segment_common.cuh"

namespace {

using namespace march;
using namespace segment;

constexpr int kBlock = 128;

struct EvalArgs {
  const float* pos01;   // (n, 3) positions in the box's [0, 1]^3
  const float* dirs;    // (n, 3) directions, or null (a zero direction)
  float* out;           // (n,) values, or (n, 4) [value, d/dx, d/dy, d/dz]
  int n;
};

// d value / d pos01 of one evaluation recorded in `keep` (head values `v`).
// `hs` is the thread's column of the activation scratch (stride kBlock):
// each transposed layer writes its outputs there, so the loop over them
// is a loop and not H unrolled copies (nvcc's time stays in seconds).
template <int H, typename Table>
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
    for (int i = 0; i < H; ++i) hs[i * kBlock] = dot_row<H>(W + i * H, dh);
#pragma unroll
    for (int o = 0; o < H; ++o) dh[o] = hs[o * kBlock];
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
    float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int cx = k & 1, cy = (k >> 1) & 1, cz = k >> 2;
      const float wx = cx ? fx : 1.0f - fx;
      const float wy = cy ? fy : 1.0f - fy;
      const float wz = cz ? fz : 1.0f - fz;
      l0 += (cx ? s[k] : -s[k]) * wy * wz;
      l1 += (cy ? s[k] : -s[k]) * wx * wz;
      l2 += (cz ? s[k] : -s[k]) * wx * wy;
    }
    g0 = fmaf(l0, (float)P.gx, g0);
    g1 = fmaf(l1, (float)P.gy, g1);
    g2 = fmaf(l2, (float)P.gz, g2);
  }
  g[0] = g0;
  g[1] = g1;
  g[2] = g2;
}

// Shared memory: the packed weights, then (from a 16-byte boundary) the
// activation scratch, H rows of kBlock floats.
template <int H, typename Table, bool kGrad>
__global__ void __launch_bounds__(kBlock) sample_eval_kernel(const Seg P,
                                                             const EvalArgs A) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < P.n_weights; i += kBlock) sw[i] = P.weights[i];
  __syncthreads();
  const Wts N = carve(sw, P, H);
  float* hs = sw + scratch_offset(P.n_weights) + threadIdx.x;

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= A.n) return;
  const float* p = A.pos01 + (size_t)i * 3;
  const float x0 = p[0], x1 = p[1], x2 = p[2];
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (P.has_dir && A.dirs != nullptr) {
    const float* d = A.dirs + (size_t)i * 3;
    d0 = d[0];
    d1 = d[1];
    d2 = d[2];
  }
  float v[4];
  if (!kGrad) {
    network<H, Table, kBlock, false>(P, N, hs, x0, x1, x2, d0, d1, d2, v,
                                     nullptr);
    A.out[i] = v[0];
    return;
  }
  Keep<H> keep;
  network<H, Table, kBlock, true>(P, N, hs, x0, x1, x2, d0, d1, d2, v, &keep);
  float g[3];
  position_grad<H, Table>(P, N, keep, v, hs, g);
  reinterpret_cast<float4*>(A.out)[i] = make_float4(v[0], g[0], g[1], g[2]);
}

template <int H, typename Table, bool kGrad>
int launch(const Seg& P, const EvalArgs& A, cudaStream_t stream) {
  const size_t smem =
      (scratch_offset(P.n_weights) + (size_t)H * kBlock) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sample_eval_kernel<H, Table, kGrad>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (A.n + kBlock - 1) / kBlock;
  if (blocks > 0)
    sample_eval_kernel<H, Table, kGrad><<<blocks, kBlock, smem, stream>>>(P,
                                                                           A);
  return (int)cudaGetLastError();
}

template <typename Table, bool kGrad>
int launch_width(const Seg& P, const EvalArgs& A, int hidden,
                 cudaStream_t stream) {
  switch (hidden) {
    case 32: return launch<32, Table, kGrad>(P, A, stream);
    case 48: return launch<48, Table, kGrad>(P, A, stream);
    case 64: return launch<64, Table, kGrad>(P, A, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Table>
int launch_table(const Seg& P, const EvalArgs& A, int hidden, int want_grad,
                 cudaStream_t stream) {
  return want_grad ? launch_width<Table, true>(P, A, hidden, stream)
                   : launch_width<Table, false>(P, A, hidden, stream);
}

}  // namespace

// Evaluate the density SRN at n positions `pos01` ((n, 3), in the box's
// [0, 1]^3): `out` (n,) values, or with want_grad (n, 4) [value, d value /
// d pos01]. Weights packed as segment_common.cuh's `Wts` (any two TF
// points) with the padded hidden width `hidden` (32, 48 or 64); `table` is
// the channel-last latent grid (gz, gy, gx, 16 * chunks), bf16 (table_f32 =
// 0) or float32, not read with chunks = 0. `dirs` ((n, 3)) is read with
// has_dir only; null is a zero direction. Density heads only. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sample_eval_launch(const float* pos01, const float* dirs,
                                  const void* table, int table_f32,
                                  const float* weights, int n_weights,
                                  float* out, int n, int gx, int gy, int gz,
                                  int chunks, int n_fourier, int n_hidden,
                                  int hidden, int act, float act_param,
                                  int head, int has_dir, int want_grad,
                                  void* stream) {
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  const Seg P = make_seg(nullptr, nullptr, table, weights, n_weights, n, gx,
                         gy, gz, chunks, n_fourier, n_hidden, 2, act,
                         act_param, head, has_dir, 0, 0, 0, 0.0f, 1, 1, 1.0f,
                         0.0f, 1.0f, 2.0f, zero3, zero3);
  if (!seg_valid(P) || head > kDensityDirect || n < 0)
    return (int)cudaErrorInvalidValue;
  EvalArgs A;
  A.pos01 = pos01;
  A.dirs = dirs;
  A.out = out;
  A.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch_table<F32Table>(P, A, hidden, want_grad, st)
                   : launch_table<Bf16Table>(P, A, hidden, want_grad, st);
}
