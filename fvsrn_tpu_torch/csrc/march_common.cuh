// Per-sample device code shared by every fused march of the port: the
// megakernel (mega_fwd.cu, mega_bwd.cu through mega_common.cuh) and the
// per-segment engine (segment_fwd.cu, segment_bwd.cu through
// segment_common.cuh). The trilinear latent fetch with grid_sample
// semantics from a channel-last table in rows of 16 channels, its adjoint,
// the Fourier phase, the activations with their derivatives, the output
// heads with their adjoints, the piecewise-linear TF with its interval
// choice and its adjoint, the other TF modes (texture, 1D- and
// 2D-preintegrated, Gaussians) with theirs, the normal and the shading of
// a sample (the normals instances of the forwards), and the front-to-back
// "over" step. The adjoints
// gate every clip strictly (a gradient passes only strictly inside it),
// as the TPU kernels' hand-written adjoints do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace march {

// Phase timers of the forwards (clock64, summed per thread) in a build
// with -DSMLP_PROFILE; nothing otherwise.
#ifdef SMLP_PROFILE
__device__ unsigned long long smlp_prof[16];
struct FwdProf {
  long long t;
  unsigned long long acc[8];
};
#define FWD_MARK(fp, i)                                   \
  do {                                                    \
    if (fp) {                                             \
      const long long n_ = clock64();                     \
      (fp)->acc[i] += (unsigned long long)(n_ - (fp)->t); \
      (fp)->t = n_;                                       \
    }                                                     \
  } while (0)
__device__ __forceinline__ void fwd_prof_flush(const FwdProf& f) {
  for (int i = 0; i < 8; ++i) {
    unsigned long long v = f.acc[i];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(&smlp_prof[i], v);
  }
}
#else
struct FwdProf {};
#define FWD_MARK(fp, i) \
  do {                  \
  } while (0)
#endif

constexpr int kLat = 16;        // channels in one table row (zero padded)

enum Act { kNone = 0, kReLU, kSine, kSigmoid, kSoftplus, kSnake, kSnakeAlt };
enum Head { kDensity = 0, kDensityDirect, kRgbo, kRgboDirect, kRgboExp };

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {  // torch's threshold 20
  return x > 20.0f ? x : log1pf(expf(x));
}

// One neuron's activation (the switch is uniform across the block).
__device__ __forceinline__ float activation(float x, int act, float p) {
  switch (act) {
    case kReLU: return fmaxf(x, 0.0f);
    case kSine: return sinf(p * x);
    case kSigmoid: return sigmoid(x);
    case kSoftplus: return softplus(x);
    case kSnake: {
      const float s = sinf(p * x);
      return x + s * s / p;
    }
    case kSnakeAlt: return (x + 1.0f - cosf(2.0f * p * x)) / (2.0f * p);
    default: return x;
  }
}

// Its derivative at the pre-activation x (ReLU's is 0 at 0).
__device__ __forceinline__ float activation_deriv(float x, int act, float p) {
  switch (act) {
    case kReLU: return x > 0.0f ? 1.0f : 0.0f;
    case kSine: return p * cosf(p * x);
    case kSigmoid: {
      const float s = sigmoid(x);
      return s * (1.0f - s);
    }
    case kSoftplus: return sigmoid(x);
    case kSnake: return 1.0f + sinf(2.0f * p * x);
    case kSnakeAlt: return 1.0f / (2.0f * p) + sinf(2.0f * p * x);
    default: return 1.0f;
  }
}

// The output head on the last layer's pre-activation y: 1 value for the
// density heads, 4 (rgb, absorption) for the rgbo heads.
__device__ __forceinline__ void head_value(int head, const float* y,
                                           float* out) {
  switch (head) {
    case kDensity:
      out[0] = sigmoid(y[0]);
      break;
    case kDensityDirect:
      out[0] = fminf(fmaxf(y[0], 0.0f), 1.0f);
      break;
    case kRgbo:
      for (int r = 0; r < 3; ++r) out[r] = sigmoid(y[r]);
      out[3] = softplus(y[3]);
      break;
    case kRgboDirect:
      for (int r = 0; r < 3; ++r) out[r] = fminf(fmaxf(y[r], 0.0f), 1.0f);
      out[3] = fmaxf(y[3], 0.0f);
      break;
    default:  // kRgboExp
      for (int r = 0; r < 3; ++r) out[r] = sigmoid(y[r]);
      out[3] = expf(y[3]);
      break;
  }
}

// Adjoint of head_value: d_y from the cotangent d_out of its outputs
// (`out` the values it returned).
__device__ __forceinline__ void head_adjoint(int head, const float* y,
                                             const float* out,
                                             const float* d_out,
                                             float* d_y) {
  switch (head) {
    case kDensity:
      d_y[0] = d_out[0] * out[0] * (1.0f - out[0]);
      break;
    case kDensityDirect:
      d_y[0] = (y[0] > 0.0f && y[0] < 1.0f) ? d_out[0] : 0.0f;
      break;
    case kRgboDirect:
      for (int r = 0; r < 3; ++r)
        d_y[r] = (y[r] > 0.0f && y[r] < 1.0f) ? d_out[r] : 0.0f;
      d_y[3] = y[3] > 0.0f ? d_out[3] : 0.0f;
      break;
    default:  // kRgbo, kRgboExp: sigmoid rgb
      for (int r = 0; r < 3; ++r) d_y[r] = d_out[r] * out[r] * (1.0f - out[r]);
      d_y[3] = d_out[3] * (head == kRgbo ? sigmoid(y[3]) : out[3]);
      break;
  }
}

// The 8 corners of a trilinear fetch with grid_sample semantics
// (align_corners=False, border clamp): x in [0, 1] maps to voxel centers
// at (i + 0.5) / n. `row` is the voxel's index in (z, y, x) order, 32 bits
// (registers; every index of a table, times its rows and channels, stays
// below 2^32).
struct Corners {
  uint32_t row[8];
  float w[8];
};

__device__ __forceinline__ void corner_axis(float x, int n, int& lo, int& hi,
                                            float& f) {
  float v = x * (float)n - 0.5f;
  float fl = floorf(v);
  f = v - fl;
  fl = fminf(fmaxf(fl, -1.0f), (float)n);
  int i = (int)fl;
  lo = min(max(i, 0), n - 1);
  hi = min(max(i + 1, 0), n - 1);
}

__device__ __forceinline__ void grid_corners(int gx, int gy, int gz, float x0,
                                             float x1, float x2,
                                             Corners& c) {
  int lx, hx, ly, hy, lz, hz;
  float fx, fy, fz;
  corner_axis(x0, gx, lx, hx, fx);
  corner_axis(x1, gy, ly, hy, fy);
  corner_axis(x2, gz, lz, hz, fz);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k & 1, cy = (k >> 1) & 1, cz = k >> 2;
    c.w[k] = (cz ? fz : 1.0f - fz) * (cy ? fy : 1.0f - fy)
             * (cx ? fx : 1.0f - fx);
    c.row[k] = ((uint32_t)(cz ? hz : lz) * gy + (cy ? hy : ly)) * gx
               + (cx ? hx : lx);
  }
}

// The derivative of a trilinear fetch with respect to the normalized
// position: `s[k]` is <d_lat, corner k's row> for grid_corners' corner
// order, (fx, fy, fz) the lerp factors of corner_axis; each axis' factor
// replaced by +-1, times the grid size on that axis, ADDED into g. A
// border-clamped axis (both corners one voxel) gives zero by itself.
__device__ __forceinline__ void trilerp_position_grad(const float* s,
                                                      float fx, float fy,
                                                      float fz, int gx,
                                                      int gy, int gz,
                                                      float* g) {
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
  g[0] = fmaf(l0, (float)gx, g[0]);
  g[1] = fmaf(l1, (float)gy, g[1]);
  g[2] = fmaf(l2, (float)gz, g[2]);
}

// Four consecutive channels of a table, the `i`-th group of four (16 bytes
// of float32, 8 of bf16), widened to float32: the training backwards read
// a bf16 or float32 table through it (a run-time choice, uniform across
// the launch).
__device__ __forceinline__ float4 table_quad(const void* table, size_t i,
                                             bool bf16) {
  if (bf16) {
    const uint2 q = __ldg(static_cast<const uint2*>(table) + i);
    return make_float4(__uint_as_float(q.x << 16),
                       __uint_as_float(q.x & 0xffff0000u),
                       __uint_as_float(q.y << 16),
                       __uint_as_float(q.y & 0xffff0000u));
  }
  return __ldg(static_cast<const float4*>(table) + i);
}

// Table element types, one 16-channel row per call: bf16 (2 x 16 bytes)
// and float32 (4 x 16 bytes).
struct Bf16Table {
  static constexpr int kBytes = 2;
  static __device__ __forceinline__ void add(const void* table, size_t row,
                                             float w, float* lat) {
    const uint4* p = static_cast<const uint4*>(table) + row * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 q = __ldg(p + h);
      const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* l = lat + 8 * h + 2 * i;
        l[0] = fmaf(w, __uint_as_float(u[i] << 16), l[0]);
        l[1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), l[1]);
      }
    }
  }
};

struct F32Table {
  static constexpr int kBytes = 4;
  static __device__ __forceinline__ void add(const void* table, size_t row,
                                             float w, float* lat) {
    const float4* p = static_cast<const float4*>(table) + row * 4;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 q = __ldg(p + h);
      lat[4 * h] = fmaf(w, q.x, lat[4 * h]);
      lat[4 * h + 1] = fmaf(w, q.y, lat[4 * h + 1]);
      lat[4 * h + 2] = fmaf(w, q.z, lat[4 * h + 2]);
      lat[4 * h + 3] = fmaf(w, q.w, lat[4 * h + 3]);
    }
  }
};

// Channels 16*chunk .. 16*chunk+15 of the trilinear fetch from a table of
// `chunks` 16-channel rows per voxel.
template <typename Table>
__device__ __forceinline__ void trilerp16(const void* table,
                                          const Corners& c, int chunks,
                                          int chunk, float* lat) {
#pragma unroll
  for (int i = 0; i < kLat; ++i) lat[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    Table::add(table, c.row[k] * chunks + chunk, c.w[k], lat);
}

// Adjoint of the float32 trilerp of channels 16*chunk .. 16*chunk+15 of a
// table of `chunks` 16-channel rows per voxel: d_table[corner] += w *
// d_lat, by sm_90's 16-byte vector atomics (four a corner; `n_lat` real
// channels in the row).
__device__ __forceinline__ void trilerp_adjoint(float* d_table,
                                                const Corners& c,
                                                const float* d_lat,
                                                int n_lat, int chunks = 1,
                                                int chunk = 0) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float* row = d_table + (c.row[k] * chunks + chunk) * kLat;
#pragma unroll
    for (int q = 0; q < kLat / 4; ++q) {
      if (4 * q >= n_lat) break;
      const float w = c.w[k];
      atomicAdd(reinterpret_cast<float4*>(row) + q,
                make_float4(w * d_lat[4 * q], w * d_lat[4 * q + 1],
                            w * d_lat[4 * q + 2], w * d_lat[4 * q + 3]));
    }
  }
}

// Phase of Fourier feature i: row i of B (F, 3) dotted with (x0, x1, x2).
__device__ __forceinline__ float fourier_phase(const float* B, int i,
                                               float x0, float x1,
                                               float x2) {
  return B[3 * i] * x0 + B[3 * i + 1] * x1 + B[3 * i + 2] * x2;
}

// The piecewise-linear TF at a normalized density d in [0, 1], control
// points (tf_points, 5) as [r, g, b, absorption, position]: the interval
// is the number of interior knots <= d.
struct TfSample {
  int iv;
  float frac, r, g, b, op;
};

__device__ __forceinline__ void tf_lookup(const float* TF, int tf_points,
                                          float d, TfSample& s) {
  int iv = 0;
  for (int q = 1; q < tf_points - 1; ++q) iv += (TF[q * 5 + 4] <= d);
  const float* c0 = TF + iv * 5;
  const float* c1 = c0 + 5;
  s.iv = iv;
  s.frac = (fminf(fmaxf(d, c0[4]), c1[4]) - c0[4]) / (c1[4] - c0[4]);
  s.r = c0[0] + s.frac * (c1[0] - c0[0]);
  s.g = c0[1] + s.frac * (c1[1] - c0[1]);
  s.b = c0[2] + s.frac * (c1[2] - c0[2]);
  s.op = c0[3] + s.frac * (c1[3] - c0[3]);
}

// Adjoint of tf_lookup at d (the same sample `s`): the cotangent dc of its
// (r, g, b, absorption) goes into the control points' gradient `tfg`
// (tf_points, 5), knot positions only strictly inside the interval.
// Returns the cotangent of d.
__device__ __forceinline__ float tf_adjoint(const float* TF,
                                            const TfSample& s, float d,
                                            const float* dc, float* tfg) {
  const float* c0 = TF + s.iv * 5;
  const float* c1 = c0 + 5;
  float* g0 = tfg + s.iv * 5;
  float* g1 = g0 + 5;
  float d_frac = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    g0[q] += dc[q] * (1.0f - s.frac);
    g1[q] += dc[q] * s.frac;
    d_frac += dc[q] * (c1[q] - c0[q]);
  }
  if (!(d > c0[4] && d < c1[4])) return 0.0f;
  const float inv_dp = 1.0f / (c1[4] - c0[4]);
  g0[4] += d_frac * (s.frac - 1.0f) * inv_dp;
  g1[4] += -d_frac * s.frac * inv_dp;
  return d_frac * inv_dp;
}

// ---------------------------------------------------------------------------
// the other TF modes (ops/fused_dvr.py TF_MODES, the kernels' template
// parameter), after the JAX package's _march_epilogue and its adjoint
// (fvsrn_tpu/ops/fused_dvr.py:1871-1990, fused_dvr_bwd.py:663-860). `T` is
// the mode's table as rows of 4 floats (texture: R texels; preint1d: R
// texels, then the Rp rows of the cumulative table), or (G, 6) Gaussians
// [r, g, b, opacity, mean, sigma]; `T2` the (R2, R2) float4 cells of the
// preint2d table, read through the read-only path (256 KB at R2 = 128, over
// a block's shared memory). A sample's color is (r, g, b, absorption):
// texture and Gaussian absorptions are scaled by the stepsize, the
// preintegrated ones are opacities already (the blend turns each into
// alpha the same way).

enum TfMode { kTfPiecewise = 0, kTfTexture, kTfPreint1d, kTfPreint2d,
              kTfGaussian };

// A lerped lookup of a table of r rows at s: rows lo and hi, fraction f.
struct Lut {
  int lo, hi;
  float f;
};

// The texture convention: x = s r - 0.5, the ends clamped.
__device__ __forceinline__ Lut lut_texture(float s, int r) {
  const float x = s * (float)r - 0.5f;
  const float i0 = floorf(x);
  Lut l;
  l.f = x - i0;
  l.lo = (int)fminf(fmaxf(i0, 0.0f), (float)(r - 1));
  l.hi = (int)fminf(fmaxf(i0 + 1.0f, 0.0f), (float)(r - 1));
  return l;
}

// The cumulative convention: x = clip(s, 0, 1) (r - 1).
__device__ __forceinline__ Lut lut_cumulative(float s, int r) {
  const float x = fminf(fmaxf(s, 0.0f), 1.0f) * (float)(r - 1);
  const float lo = fminf(fmaxf(floorf(x), 0.0f), (float)(r - 2));
  Lut l;
  l.lo = (int)lo;
  l.hi = l.lo + 1;
  l.f = x - lo;
  return l;
}

__device__ __forceinline__ float4 lerp_rows(const float* T, const Lut& l) {
  const float* a = T + 4 * l.lo;
  const float* b = T + 4 * l.hi;
  const float g = 1.0f - l.f;
  return make_float4(a[0] * g + b[0] * l.f, a[1] * g + b[1] * l.f,
                     a[2] * g + b[2] * l.f, a[3] * g + b[3] * l.f);
}

// The (front, back) cell of the preint2d table at the previous density
// (clipped; none: d) and d, both clipped.
__device__ __forceinline__ int cell_2d(float d, float prev, int r2) {
  const float pe = prev < 0.0f ? d : fminf(fmaxf(prev, 0.0f), 1.0f);
  const float fr = (float)r2;
  const int i = (int)fminf(floorf(pe * fr), fr - 1.0f);
  const int j = (int)fminf(floorf(d * fr), fr - 1.0f);
  return i * r2 + j;
}

__device__ __forceinline__ float guarded_inv(float a) {
  return a > 1e-5f ? 1.0f / fmaxf(a, 1e-5f) : 1.0f;
}

// (r, g, b, absorption) of a sample of clipped density d whose previous
// sample's normalized density is `prev` (unclipped; < 0: none), in mode
// TFM (not piecewise). `r` the table's rows (texels, Gaussians, R2), `rp`
// the cumulative table's.
template <int TFM>
__device__ __forceinline__ float4 tf_color(const float* T, const float4* T2,
                                           int r, int rp, float d,
                                           float prev, float h) {
  if (TFM == kTfGaussian) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < r; ++q) {
      const float* gq = T + 6 * q;
      const float u = d - gq[4];
      const float w = expf(-(u * u) / (gq[5] * gq[5]));
      acc.x = fmaf(w, gq[0], acc.x);
      acc.y = fmaf(w, gq[1], acc.y);
      acc.z = fmaf(w, gq[2], acc.z);
      acc.w = fmaf(w, gq[3], acc.w);
    }
    acc.w *= h;
    return acc;
  }
  if (TFM == kTfPreint2d) {
    const float4 v = __ldg(T2 + cell_2d(d, prev, r));
    const float inv = guarded_inv(v.w);
    return make_float4(v.x * inv, v.y * inv, v.z * inv, v.w);
  }
  float4 plain = lerp_rows(T, lut_texture(d, r));
  plain.w *= h;
  if (TFM == kTfTexture) return plain;
  const float pe = prev < 0.0f ? d : prev;
  const float denom = d - pe;
  if (fabsf(denom) < 1e-3f) return plain;   // the near branch
  const float* C = T + 4 * r;
  const float4 vf = lerp_rows(C, lut_cumulative(pe, rp));
  const float4 vb = lerp_rows(C, lut_cumulative(d, rp));
  const float a = 1.0f - expf(-h * (vb.w - vf.w) / denom);
  const float inv = guarded_inv(a);
  return make_float4(h * (vb.x - vf.x) / denom * inv,
                     h * (vb.y - vf.y) / denom * inv,
                     h * (vb.z - vf.z) / denom * inv, a);
}

// What the adjoint of tf_color leaves for the table's gradient: up to two
// lookups (lo < 0: none) of the rows [lo, hi] by the fraction f, the first
// with cotangent dc, the second with -dc (texture and preint1d); or, for
// the Gaussians, d and dc.
struct TfRecord {
  float lo1, hi1, f1, lo2, hi2, f2;
  float4 dc;
};

// The gradient of a sample's preint2d cell (set in `c`) from the
// cotangent dcol of its (r, g, b, opacity): the cell's normalized color
// and its opacity through the guarded inverse.
__device__ __forceinline__ float4 preint2d_cell_grad(const float4* T2,
                                                     int r, float d,
                                                     float prev, float4 dcol,
                                                     int& c) {
  c = cell_2d(d, prev, r);
  const float4 v = __ldg(T2 + c);
  const float inv = guarded_inv(v.w);
  const float d_inv = dcol.x * v.x + dcol.y * v.y + dcol.z * v.z;
  const float da = dcol.w + d_inv * (v.w > 1e-5f
                                         ? -1.0f / (fmaxf(v.w, 1e-5f)
                                                    * fmaxf(v.w, 1e-5f))
                                         : 0.0f);
  return make_float4(dcol.x * inv, dcol.y * inv, dcol.z * inv, da);
}

// Adjoint of tf_color at (d, prev) for the cotangent dcol of its
// (r, g, b, absorption): returns the cotangent of d (the clipped density)
// and sets d_prev (that of `prev`; 0 where there is none) and the record.
// preint2d takes none (nearest cells) and adds dcol's cell gradient to
// dT2 by atomics.
template <int TFM>
__device__ __forceinline__ float tf_color_adjoint(
    const float* T, const float4* T2, float4* dT2, int r, int rp, float d,
    float prev, float h, float4 dcol, float& d_prev, TfRecord& rec) {
  d_prev = 0.0f;
  rec.lo1 = rec.lo2 = -1.0f;
  rec.hi1 = rec.hi2 = rec.f1 = rec.f2 = 0.0f;
  rec.dc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (TFM == kTfGaussian) {
    const float4 df = make_float4(dcol.x, dcol.y, dcol.z, dcol.w * h);
    float dd = 0.0f;
    for (int q = 0; q < r; ++q) {
      const float* gq = T + 6 * q;
      const float u = d - gq[4];
      const float s2 = gq[5] * gq[5];
      const float w = expf(-(u * u) / s2);
      const float dgw = gq[0] * df.x + gq[1] * df.y + gq[2] * df.z
                        + gq[3] * df.w;
      dd += dgw * w * (-2.0f) * (u / s2);
    }
    rec.f1 = d;
    rec.dc = df;
    return dd;
  }
  if (TFM == kTfPreint2d) {
    int c;
    const float4 g = preint2d_cell_grad(T2, r, d, prev, dcol, c);
    atomicAdd(dT2 + c, g);
    return 0.0f;
  }
  const float pe = prev < 0.0f ? d : prev;
  const float denom = d - pe;
  if (TFM == kTfTexture || fabsf(denom) < 1e-3f) {
    // the plain texture fetch: its slope times r
    const Lut l = lut_texture(d, r);
    rec.dc = make_float4(dcol.x, dcol.y, dcol.z, dcol.w * h);
    rec.lo1 = (float)l.lo;
    rec.hi1 = (float)l.hi;
    rec.f1 = l.f;
    const float* a = T + 4 * l.lo;
    const float* b = T + 4 * l.hi;
    return (rec.dc.x * (b[0] - a[0]) + rec.dc.y * (b[1] - a[1])
            + rec.dc.z * (b[2] - a[2]) + rec.dc.w * (b[3] - a[3]))
           * (float)r;
  }
  const float* C = T + 4 * r;
  const Lut lf = lut_cumulative(pe, rp), lb = lut_cumulative(d, rp);
  const float4 vf = lerp_rows(C, lf), vb = lerp_rows(C, lb);
  const float coef = h / denom;
  const float rp3[3] = {(vb.x - vf.x) * coef, (vb.y - vf.y) * coef,
                        (vb.z - vf.z) * coef};
  const float m = (vb.w - vf.w) * coef;
  const float a = 1.0f - expf(-m);
  const float inv = guarded_inv(a);
  const float drgb[3] = {dcol.x * inv, dcol.y * inv, dcol.z * inv};
  const float d_inv = dcol.x * rp3[0] + dcol.y * rp3[1] + dcol.z * rp3[2];
  const float d_a = dcol.w + d_inv * (a > 1e-5f ? -1.0f / (fmaxf(a, 1e-5f)
                                                           * fmaxf(a, 1e-5f))
                                                : 0.0f);
  const float d_m = d_a * expf(-m);
  const float4 dv = make_float4(drgb[0] * coef, drgb[1] * coef,
                                drgb[2] * coef, d_m * coef);
  const float d_denom = -(drgb[0] * rp3[0] + drgb[1] * rp3[1]
                          + drgb[2] * rp3[2] + d_m * m) / denom;
  const float* b0 = C + 4 * lb.lo;
  const float* b1 = C + 4 * lb.hi;
  const float* f0 = C + 4 * lf.lo;
  const float* f1 = C + 4 * lf.hi;
  float sb = (dv.x * (b1[0] - b0[0]) + dv.y * (b1[1] - b0[1])
              + dv.z * (b1[2] - b0[2]) + dv.w * (b1[3] - b0[3]))
             * (float)(rp - 1);
  float sf = -(dv.x * (f1[0] - f0[0]) + dv.y * (f1[1] - f0[1])
               + dv.z * (f1[2] - f0[2]) + dv.w * (f1[3] - f0[3]))
             * (float)(rp - 1);
  if (!(d > 0.0f && d < 1.0f)) sb = 0.0f;     // the cumulative clip
  if (!(pe > 0.0f && pe < 1.0f)) sf = 0.0f;
  rec.dc = dv;
  rec.lo1 = (float)(r + lb.lo);
  rec.hi1 = (float)(r + lb.hi);
  rec.f1 = lb.f;
  rec.lo2 = (float)(r + lf.lo);
  rec.hi2 = (float)(r + lf.hi);
  rec.f2 = lf.f;
  d_prev = sf - d_denom;   // off the near branch prev is no sentinel
  return sb + d_denom;
}

// Whether the TF of a call is one the kernels take: tf_points knots (>=
// 2), texels (>= 2; preint1d also tf_pre >= 2 cumulative rows), Gaussians
// (>= 1) or R2 >= 1, and tf_floats of the packed TF.
inline bool tf_valid(int tfm, int tf_points, int tf_pre, int tf_floats,
                     const void* tf2d) {
  switch (tfm) {
    case kTfPiecewise:
      return tf_points >= 2 && tf_floats == 5 * tf_points;
    case kTfTexture:
      return tf_points >= 2 && tf_floats == 4 * tf_points;
    case kTfPreint1d:
      return tf_points >= 2 && tf_pre >= 2
             && tf_floats == 4 * (tf_points + tf_pre);
    case kTfPreint2d:
      return tf_points >= 1 && tf_floats == 0 && tf2d != nullptr;
    case kTfGaussian:
      return tf_points >= 1 && tf_floats == 6 * tf_points;
    default:
      return false;
  }
}

// Piecewise knots or Gaussians a launch stages in shared memory: the
// largest count at which every instance's plan is its 16-point plan
// (ops/sample_mlp.py's TF_STAGED_POINTS). A larger TF is read from the
// packed weights in device memory, and the plan counts none of it.
constexpr int kTfStaged = 19;

// TF floats a launch stages of the `tf_floats` packed ones.
__host__ __device__ inline int staged_tf_floats(int tfm, int tf_points,
                                                int tf_floats) {
  return (tfm == kTfPiecewise || tfm == kTfGaussian) && tf_points > kTfStaged
             ? 0 : tf_floats;
}

// ---------------------------------------------------------------------------
// normals and shading, after the JAX package's _march_epilogue
// (fvsrn_tpu/ops/fused_dvr.py:1997-2051), which both engines share; the
// plain version is ops/fused_dvr.py shade_samples. The host folds the
// BRDF's constants (ops/fused_dvr.py brdf_tuple): the light's unit
// direction -l/|l| for a directional light, the smoothstep's lower edge
// center - radius and width 2 radius, and the lobe's normalisation
// (e + 2) 0.159155.
struct Shade {
  int mag, phong, directional, spec_exp;
  float m_scale, ambient, specular, edge, width, spec_norm;
  float lx, ly, lz;   // the light's unit direction, or its position
};

// The Shade of a launch's host arrays: si = [magnitude scaling on, Phong
// on, directional light, specular exponent], sf = [magnitude scaling,
// ambient, specular, edge, width, lobe normalisation, light x, y, z].
inline Shade make_shade(const int* si, const float* sf) {
  Shade S;
  S.mag = si[0];
  S.phong = si[1];
  S.directional = si[2];
  S.spec_exp = si[3];
  S.m_scale = sf[0];
  S.ambient = sf[1];
  S.specular = sf[2];
  S.edge = sf[3];
  S.width = sf[4];
  S.spec_norm = sf[5];
  S.lx = sf[6];
  S.ly = sf[7];
  S.lz = sf[8];
  return S;
}

// The normal n of a sample of world-space density gradient g (g / |g|,
// zero where |g|^2 <= 1e-12), and with S.mag or S.phong its color c (r, g,
// b, absorption) shaded: the absorption times 1 - exp(-m |g|^2), the rgb
// mixed from itself and a Lambert term |n.l| rgb plus a Blinn-Phong lobe
// by the ambient strength's smoothstep of |g|. pw is the sample's world
// position (the point light's direction), rd its ray's direction.
__device__ __forceinline__ void shade_sample(const Shade& S, float4& c,
                                             const float* g, const float* pw,
                                             const float* rd, float* n) {
  const float gns = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
  const float inv = rsqrtf(fmaxf(gns, 1e-20f));
  const bool nz = gns > 1e-12f;
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = nz ? g[k] * inv : 0.0f;
  if (S.mag) c.w *= 1.0f - expf(-S.m_scale * gns);
  if (!S.phong) return;
  float ld[3] = {S.lx, S.ly, S.lz};
  if (!S.directional) {
#pragma unroll
    for (int k = 0; k < 3; ++k) ld[k] -= pw[k];
    const float ll =
        rsqrtf(fmaxf(ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2], 1e-20f));
#pragma unroll
    for (int k = 0; k < 3; ++k) ld[k] *= ll;
  }
  const float gn = sqrtf(fmaxf(gns, 1e-20f));
  const float t = fminf(fmaxf((gn - S.edge) / S.width, 0.0f), 1.0f);
  const float amb = 1.0f + (S.ambient - 1.0f) * (t * t * (3.0f - 2.0f * t));
  const float ndotl = n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2];
  // reflect(l, -n) = l - 2 (n.l) n
  float base = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) base += rd[k] * (ld[k] - 2.0f * ndotl * n[k]);
  base = fmaxf(base, 0.0f);
  float spec = 1.0f;
  for (int e = S.spec_exp; e; e >>= 1) {   // the integer power by squaring
    if (e & 1) spec *= base;
    base *= base;
  }
  const float lobe = S.specular * (S.spec_norm * spec);
  const float dif = fabsf(ndotl);
  c.x = amb * c.x + (1.0f - amb) * (dif * c.x + lobe);
  c.y = amb * c.y + (1.0f - amb) * (dif * c.y + lobe);
  c.z = amb * c.z + (1.0f - amb) * (dif * c.z + lobe);
}

// The blend of a ray's normal and depth (nx, ny, nz, t): a run of samples
// (N, T), each premultiplied by its sample's alpha and composed as the
// color is, into the carry `nd` under the carry's transmittance w = 1 - A
// (the normal and depth take the color's weights, as the JAX package's
// _compose_tree and the reference's blending do).
__device__ __forceinline__ void over_nd(float4& nd, float w, const float4& run) {
  nd.x = fmaf(w, run.x, nd.x);
  nd.y = fmaf(w, run.y, nd.y);
  nd.z = fmaf(w, run.z, nd.z);
  nd.w = fmaf(w, run.w, nd.w);
}

// One front-to-back "over" step of a sample of color (r, g, b) and alpha
// `a` into the ray's carry.
__device__ __forceinline__ void over(float& cr, float& cg, float& cb,
                                     float& ca, float r, float g, float b,
                                     float a) {
  const float w = (1.0f - ca) * a;
  cr = fmaf(w, r, cr);
  cg = fmaf(w, g, cg);
  cb = fmaf(w, b, cb);
  ca = ca + (1.0f - ca) * a;
}

}  // namespace march
