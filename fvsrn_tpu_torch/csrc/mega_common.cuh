// Device code shared by the fused march's forward (mega_fwd.cu) and
// backward (mega_bwd.cu): the packed-weight layout, the trilinear latent
// fetch with grid_sample semantics and its adjoint, SnakeAlt with its
// derivative, the SRN's MLP, the density:direct head and the piecewise-
// linear TF with its interval choice. Both kernels evaluate a sample with
// the same function (`shade`), so the backward's replay reproduces the
// forward's values and gates.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mega {

constexpr int kHid = 32;        // hidden width
constexpr int kLat = 16;        // latent channels in the table (zero padded)
constexpr int kTile = 256;      // rays per block = threads per block
constexpr int kMaxFourier = 32;
constexpr int kMaxHidden = 6;   // hidden->hidden layers
constexpr int kMaxTf = 16;      // TF control points
constexpr int kMaxK1 = 3 + 2 * kMaxFourier + kLat;

// Geometry and options of one march, shared by both kernels.
struct March {
  const float* rays;        // (R, 8): start xyz, dir xyz, k0_ray, tmax
  const void* table;        // (gz, gy, gx, 16), bf16 or float32
  const float* weights;     // packed, see `Net`
  int n_weights;
  int gx, gy, gz;
  int n_fourier, n_hidden, tf_points;
  float act_param;          // SnakeAlt frequency
  int seg;
  int n_seg_max;            // segments a tile may visit (carry storage)
  float stepsize, density_min, inv_range, early_alpha;
  float bmin[3], bsize[3];
};

// Packed float32 weights, in this order: Fourier matrix B (F, 3); layer 1
// (32, K1 = 3 + 2F + 16) over [pos, cos, sin, latent]; its bias (32);
// n_hidden hidden layers (32, 32) each, then their biases (n_hidden, 32);
// output row (32); output bias (1); TF control points (tf_points, 5) as
// [r, g, b, absorption, position]. The backward's weight gradient uses the
// same layout.
struct Net {
  const float *B, *W1, *b1, *Wh, *bh, *Wo, *bo, *TF;
  int F, K1, n_hidden, tf_points;
  float p;
};

struct Offsets {
  int B, W1, b1, Wh, bh, Wo, bo, TF;
};

__host__ __device__ inline Offsets weight_offsets(int F, int n_hidden) {
  Offsets o;
  const int K1 = 3 + 2 * F + kLat;
  o.B = 0;
  o.W1 = o.B + 3 * F;
  o.b1 = o.W1 + kHid * K1;
  o.Wh = o.b1 + kHid;
  o.bh = o.Wh + n_hidden * kHid * kHid;
  o.Wo = o.bh + n_hidden * kHid;
  o.bo = o.Wo + kHid;
  o.TF = o.bo + 1;
  return o;
}

__device__ inline Net carve(const float* w, const March& P) {
  const Offsets o = weight_offsets(P.n_fourier, P.n_hidden);
  Net N;
  N.B = w + o.B; N.W1 = w + o.W1; N.b1 = w + o.b1; N.Wh = w + o.Wh;
  N.bh = w + o.bh; N.Wo = w + o.Wo; N.bo = w + o.bo; N.TF = w + o.TF;
  N.F = P.n_fourier;
  N.K1 = 3 + 2 * P.n_fourier + kLat;
  N.n_hidden = P.n_hidden;
  N.tf_points = P.tf_points;
  N.p = P.act_param;
  return N;
}

// SnakeAlt: (x + 1 - cos(2 p x)) / (2 p); its derivative 1/(2p) + sin(2 p x)
__device__ __forceinline__ float snake_alt(float x, float p) {
  return (x + 1.0f - cosf(2.0f * p * x)) / (2.0f * p);
}

__device__ __forceinline__ float snake_alt_deriv(float x, float p) {
  return 1.0f / (2.0f * p) + sinf(2.0f * p * x);
}

// The 8 corners of a trilinear fetch with grid_sample semantics
// (align_corners=False, border clamp): x in [0, 1] maps to voxel centers
// at (i + 0.5) / n. Row r of the channel-last table holds voxel r.
struct Corners {
  size_t row[8];
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

__device__ __forceinline__ void corners(const March& P, float x0, float x1,
                                        float x2, Corners& c) {
  int lx, hx, ly, hy, lz, hz;
  float fx, fy, fz;
  corner_axis(x0, P.gx, lx, hx, fx);
  corner_axis(x1, P.gy, ly, hy, fy);
  corner_axis(x2, P.gz, lz, hz, fz);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k & 1, cy = (k >> 1) & 1, cz = k >> 2;
    c.w[k] = (cz ? fz : 1.0f - fz) * (cy ? fy : 1.0f - fy)
             * (cx ? fx : 1.0f - fx);
    c.row[k] = ((size_t)(cz ? hz : lz) * P.gy + (cy ? hy : ly)) * P.gx
               + (cx ? hx : lx);
  }
}

// Table element types: bf16 (the render's table, 2 x 16 bytes a corner)
// and float32 (the training table, 4 x 16 bytes a corner).
struct Bf16Table {
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

template <typename Table>
__device__ __forceinline__ void trilerp(const March& P, const Corners& c,
                                        float* lat) {
#pragma unroll
  for (int i = 0; i < kLat; ++i) lat[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) Table::add(P.table, c.row[k], c.w[k], lat);
}

// Adjoint of the float32 trilerp: d_table[corner] += w * d_lat, by sm_90's
// 16-byte vector atomics (four a corner; `n_lat` real channels).

__device__ __forceinline__ void trilerp_adjoint(float* d_table,
                                                const Corners& c,
                                                const float* d_lat,
                                                int n_lat) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float* row = d_table + c.row[k] * kLat;
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

// What the backward keeps of one sample's MLP evaluation: the first
// layer's input [pos, cos, sin, latent], every hidden layer's output and
// the activation's derivative at its pre-activation.
struct Keep {
  float in1[kMaxK1];
  float hs[(kMaxHidden + 1) * kHid];
  float dact[(kMaxHidden + 1) * kHid];
};

// The SRN on one sample: layer 1 over [pos, cos(Bx), sin(Bx), latent],
// SnakeAlt hidden layers, the linear output row. Returns the output's
// pre-activation y; with kKeep it also fills `keep`.
template <bool kKeep>
__device__ __forceinline__ float mlp(const Net& N, float x0, float x1,
                                     float x2, const float* lat,
                                     Keep* keep) {
  const int F = N.F, K1 = N.K1;
  float acc[kHid];
#pragma unroll
  for (int o = 0; o < kHid; ++o) {
    const float* w = N.W1 + o * K1;
    acc[o] = fmaf(w[0], x0, fmaf(w[1], x1, fmaf(w[2], x2, N.b1[o])));
  }
  if (kKeep) {
    keep->in1[0] = x0; keep->in1[1] = x1; keep->in1[2] = x2;
  }
  for (int i = 0; i < F; ++i) {
    const float f = N.B[3 * i] * x0 + N.B[3 * i + 1] * x1
                    + N.B[3 * i + 2] * x2;
    float sn, cs;
    sincosf(f, &sn, &cs);
    if (kKeep) {
      keep->in1[3 + i] = cs;
      keep->in1[3 + F + i] = sn;
    }
#pragma unroll
    for (int o = 0; o < kHid; ++o) {
      const float* w = N.W1 + o * K1 + 3;
      acc[o] = fmaf(w[i], cs, fmaf(w[F + i], sn, acc[o]));
    }
  }
#pragma unroll
  for (int c = 0; c < kLat; ++c) {
    if (kKeep) keep->in1[3 + 2 * F + c] = lat[c];
#pragma unroll
    for (int o = 0; o < kHid; ++o)
      acc[o] = fmaf(N.W1[o * K1 + 3 + 2 * F + c], lat[c], acc[o]);
  }
  float hid[kHid];
#pragma unroll
  for (int o = 0; o < kHid; ++o) {
    hid[o] = snake_alt(acc[o], N.p);
    if (kKeep) {
      keep->hs[o] = hid[o];
      keep->dact[o] = snake_alt_deriv(acc[o], N.p);
    }
  }
  for (int l = 0; l < N.n_hidden; ++l) {
    const float* W = N.Wh + l * kHid * kHid;
#pragma unroll
    for (int o = 0; o < kHid; ++o) acc[o] = N.bh[l * kHid + o];
#pragma unroll
    for (int i = 0; i < kHid; ++i) {
#pragma unroll
      for (int o = 0; o < kHid; ++o)
        acc[o] = fmaf(W[o * kHid + i], hid[i], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kHid; ++o) {
      hid[o] = snake_alt(acc[o], N.p);
      if (kKeep) {
        keep->hs[(l + 1) * kHid + o] = hid[o];
        keep->dact[(l + 1) * kHid + o] = snake_alt_deriv(acc[o], N.p);
      }
    }
  }
  float y = N.bo[0];
#pragma unroll
  for (int i = 0; i < kHid; ++i) y = fmaf(N.Wo[i], hid[i], y);
  return y;
}

// The piecewise-linear TF at a normalized density d in [0, 1]: the
// interval is the number of interior knots <= d.
struct TfSample {
  int iv;
  float frac, r, g, b, op;
};

__device__ __forceinline__ void tf_eval(const Net& N, float d, TfSample& s) {
  int iv = 0;
  for (int q = 1; q < N.tf_points - 1; ++q) iv += (N.TF[q * 5 + 4] <= d);
  const float* c0 = N.TF + iv * 5;
  const float* c1 = c0 + 5;
  s.iv = iv;
  s.frac = (fminf(fmaxf(d, c0[4]), c1[4]) - c0[4]) / (c1[4] - c0[4]);
  s.r = c0[0] + s.frac * (c1[0] - c0[0]);
  s.g = c0[1] + s.frac * (c1[1] - c0[1]);
  s.b = c0[2] + s.frac * (c1[2] - c0[2]);
  s.op = c0[3] + s.frac * (c1[3] - c0[3]);
}

// One lattice sample: latent fetch, MLP, density:direct head, TF. Returns
// false when the sample does not count (value < density_min). `y` and
// `value` are the head's input and output.
struct Shaded {
  float y, value;
  TfSample tf;
  Corners c;
};

template <typename Table, bool kKeep>
__device__ __forceinline__ bool shade(const March& P, const Net& N, float x0,
                                      float x1, float x2, Shaded& s,
                                      Keep* keep) {
  float lat[kLat];
  corners(P, x0, x1, x2, s.c);
  trilerp<Table>(P, s.c, lat);
  s.y = mlp<kKeep>(N, x0, x1, x2, lat, keep);
  s.value = fminf(fmaxf(s.y, 0.0f), 1.0f);  // density:direct
  if (!(s.value >= P.density_min)) return false;
  const float d = fminf(fmaxf((s.value - P.density_min) * P.inv_range, 0.0f),
                        1.0f);
  tf_eval(N, d, s.tf);
  return true;
}

// Per-ray setup shared by both kernels: the ray packet and the tile's
// lattice base k0t (the minimum of k0_ray over every ray of the tile;
// fminf skips NaN). `red` is kTile/32 floats of shared memory. Ends with a
// block barrier.
struct Ray {
  float sx, sy, sz, dx, dy, dz, k0r, tmx, k0t;
};

__device__ __forceinline__ Ray load_ray(const March& P, float* red) {
  const int ray = blockIdx.x * kTile + threadIdx.x;
  const float* rp = P.rays + (size_t)ray * 8;
  Ray r;
  r.sx = rp[0]; r.sy = rp[1]; r.sz = rp[2];
  r.dx = rp[3]; r.dy = rp[4]; r.dz = rp[5];
  r.k0r = rp[6]; r.tmx = rp[7];
  float m = r.k0r;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float k0t = red[0];
#pragma unroll
  for (int w = 1; w < kTile / 32; ++w) k0t = fminf(k0t, red[w]);
  r.k0t = k0t;
  return r;
}

__device__ __forceinline__ void sample_pos(const March& P, const Ray& r,
                                           float t, float& x0, float& x1,
                                           float& x2) {
  x0 = (r.sx + t * r.dx - P.bmin[0]) / P.bsize[0];
  x1 = (r.sy + t * r.dy - P.bmin[1]) / P.bsize[1];
  x2 = (r.sz + t * r.dz - P.bmin[2]) / P.bsize[2];
}

inline void fill_march(March& P, const float* rays, const void* table,
                       const float* weights, int n_weights, int gx, int gy,
                       int gz, int n_fourier, int n_hidden, int tf_points,
                       float act_param, int seg, int n_seg_max,
                       float stepsize, float density_min, float inv_range,
                       float early_alpha, const float* bmin,
                       const float* bsize) {
  P.rays = rays;
  P.table = table;
  P.weights = weights;
  P.n_weights = n_weights;
  P.gx = gx; P.gy = gy; P.gz = gz;
  P.n_fourier = n_fourier;
  P.n_hidden = n_hidden;
  P.tf_points = tf_points;
  P.act_param = act_param;
  P.seg = seg;
  P.n_seg_max = n_seg_max;
  P.stepsize = stepsize;
  P.density_min = density_min;
  P.inv_range = inv_range;
  P.early_alpha = early_alpha;
  for (int i = 0; i < 3; ++i) {
    P.bmin[i] = bmin[i];
    P.bsize[i] = bsize[i];
  }
}

}  // namespace mega
