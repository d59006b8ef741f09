// Device code shared by the per-segment engine's forward (segment_fwd.cu)
// and backward (segment_bwd.cu) and the sample evaluator (sample_eval.cu):
// the call's parameters, the packed-weight layout, the SRN on one sample
// and the sampling of a ray. The forward and the evaluator evaluate a
// sample with the same functions; the backward evaluates its samples as
// tiles (sample_mlp.cuh), its replay agreeing with `network` to float32
// rounding, not bit for bit.
#pragma once

#include "march_common.cuh"

namespace segment {

using namespace march;

constexpr int kMaxFourier = 32;
constexpr int kMaxHidden = 6;   // hidden->hidden layers
constexpr int kMaxTf = 16;
constexpr int kMaxChunks = 4;   // latent channels <= 64, in rows of 16
constexpr int kMaxK1 = 6 + 2 * kMaxFourier + kLat * kMaxChunks;

struct Seg {
  const float* rays;     // (R, 8): start xyz, dir xyz, a, tmax; a = tmin
                         // (per-ray sampling) or k0_ray (lattice)
  const float* kbase;    // (R,) lattice base of the ray's tile, or null
  const void* table;     // (gz, gy, gx, 16 * chunks), bf16 or float32
  const float* weights;  // packed, see `Wts`
  int n_weights, n_rays;
  int gx, gy, gz, chunks;
  int n_fourier, n_hidden, tf_points;
  int act, head, has_dir, lattice, blend_alpha, iso;
  float act_param, iso_value;
  int seg, n_seg;
  float stepsize, density_min, inv_range, early_alpha;
  float bmin[3], bsize[3];
  int tfm;               // TF mode (march_common.cuh's TfMode)
  int tf_pre, tf_floats; // cumulative rows (preint1d), TF floats packed
  const float4* tf2d;    // the preint2d table (R2 = tf_points), or null
};

// Whether the call's options are ones the kernels take.
inline bool seg_valid(const Seg& P) {
  return P.n_fourier <= kMaxFourier && P.n_hidden <= kMaxHidden
         && tf_valid(P.tfm, P.tf_points, P.tf_pre, P.tf_floats, P.tf2d,
                     kMaxTf)
         && P.chunks <= kMaxChunks && P.chunks >= 0 && P.seg >= 1
         && P.act >= kNone && P.act <= kSnakeAlt && P.head >= kDensity
         && P.head <= kRgboExp;
}

// Packed float32 weights, H the padded hidden width, F Fourier features,
// K1 = 6 + 2F + 16*chunks, every matrix stored input-major (row i holds
// the H outputs' weights of input i): layer 1 (K1, H) over [pos 3, dir 3,
// cos F, sin F, latent]; its bias (H); n_hidden hidden layers (H, H),
// their biases (n_hidden, H); the output rows (4, H) (output-major) and
// biases (4), unused rows zero; Fourier B (F, 3) over positions; its
// direction block (F, 3); the TF: control points (tf_points, 5), or the
// other modes' table (tf_floats floats; none for preint2d, whose table is
// its own array). Every block before B starts at a multiple of 4 floats
// (H is a multiple of 16). The backward's weight gradient uses the same
// layout.
struct Wts {
  const float *W1, *b1, *Wh, *bh, *Wo, *bo, *B, *Bd, *TF;
};

__device__ __forceinline__ Wts carve(const float* w, const Seg& P, int H) {
  const int F = P.n_fourier;
  const int K1 = 6 + 2 * F + kLat * P.chunks;
  Wts N;
  N.W1 = w;
  N.b1 = N.W1 + K1 * H;
  N.Wh = N.b1 + H;
  N.bh = N.Wh + P.n_hidden * H * H;
  N.Wo = N.bh + P.n_hidden * H;
  N.bo = N.Wo + 4 * H;
  N.B = N.bo + 4;
  N.Bd = N.B + 3 * F;
  N.TF = N.Bd + 3 * F;
  return N;
}

// acc += x * w[0:H], w 16-byte aligned in shared memory.
template <int H>
__device__ __forceinline__ void axpy(float* acc, const float* w, float x) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 v = w4[q];
    acc[4 * q] = fmaf(v.x, x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(v.y, x, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v.z, x, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v.w, x, acc[4 * q + 3]);
  }
}

// w[0:H] (16-byte aligned, shared memory) . v[0:H]
template <int H>
__device__ __forceinline__ float dot_row(const float* w, const float* v) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 x = w4[q];
    acc = fmaf(x.x, v[4 * q], acc);
    acc = fmaf(x.y, v[4 * q + 1], acc);
    acc = fmaf(x.z, v[4 * q + 2], acc);
    acc = fmaf(x.w, v[4 * q + 3], acc);
  }
  return acc;
}

// What the backward keeps of one sample's network evaluation: the first
// layer's input [pos, dir, cos, sin, latent] (dir zero without direction
// input), every hidden layer's output and the activation's derivative at
// its pre-activation, and the head's input y.
template <int H>
struct Keep {
  float in1[kMaxK1];
  float hs[(kMaxHidden + 1) * H];
  float dact[(kMaxHidden + 1) * H];
  float y[4];
};

// The layer's activation, from the accumulators into the thread's column
// `hs` (stride kStride) of shared memory; with kKeep also into the
// thread's record (outputs and derivatives).
template <int H, int kStride, bool kKeep>
__device__ __forceinline__ void activate_into(const float* acc, float* hs,
                                              int act, float p,
                                              float* keep_h,
                                              float* keep_d) {
#pragma unroll
  for (int o = 0; o < H; ++o) hs[o * kStride] = acc[o];
#pragma unroll 1
  for (int o = 0; o < H; ++o) {
    const float x = hs[o * kStride];
    const float v = activation(x, act, p);
    hs[o * kStride] = v;
    if (kKeep) {
      keep_h[o] = v;
      keep_d[o] = activation_deriv(x, act, p);
    }
  }
}

// The SRN at one sample: world-normalized position x, ray direction d.
// Writes the output head's values (1 for density heads, 4 for rgbo).
// `hs` is the thread's column of the activation scratch; with kKeep the
// evaluation is also recorded in `keep`.
template <int H, typename Table, int kStride, bool kKeep>
__device__ __forceinline__ void network(const Seg& P, const Wts& N, float* hs,
                                        float x0, float x1, float x2,
                                        float d0, float d1, float d2,
                                        float* out, Keep<H>* keep) {
  const int F = P.n_fourier;
  float acc[H];
#pragma unroll
  for (int o = 0; o < H; ++o) acc[o] = N.b1[o];
  axpy<H>(acc, N.W1, x0);
  axpy<H>(acc, N.W1 + H, x1);
  axpy<H>(acc, N.W1 + 2 * H, x2);
  if (P.has_dir) {
    axpy<H>(acc, N.W1 + 3 * H, d0);
    axpy<H>(acc, N.W1 + 4 * H, d1);
    axpy<H>(acc, N.W1 + 5 * H, d2);
  }
  if (kKeep) {
    keep->in1[0] = x0;
    keep->in1[1] = x1;
    keep->in1[2] = x2;
    keep->in1[3] = P.has_dir ? d0 : 0.0f;
    keep->in1[4] = P.has_dir ? d1 : 0.0f;
    keep->in1[5] = P.has_dir ? d2 : 0.0f;
  }
#pragma unroll 1
  for (int i = 0; i < F; ++i) {
    float f = fourier_phase(N.B, i, x0, x1, x2);
    if (P.has_dir) f += fourier_phase(N.Bd, i, d0, d1, d2);
    float sn, cs;
    sincosf(f, &sn, &cs);
    axpy<H>(acc, N.W1 + (6 + i) * H, cs);
    axpy<H>(acc, N.W1 + (6 + F + i) * H, sn);
    if (kKeep) {
      keep->in1[6 + i] = cs;
      keep->in1[6 + F + i] = sn;
    }
  }
  if (P.chunks > 0) {
    Corners c;
    grid_corners(P.gx, P.gy, P.gz, x0, x1, x2, c);
#pragma unroll 1
    for (int q = 0; q < P.chunks; ++q) {
      float lat[kLat];
      trilerp16<Table>(P.table, c, P.chunks, q, lat);
      const float* w = N.W1 + (6 + 2 * F + kLat * q) * H;
#pragma unroll
      for (int ch = 0; ch < kLat; ++ch) axpy<H>(acc, w + ch * H, lat[ch]);
      if (kKeep) {
#pragma unroll
        for (int ch = 0; ch < kLat; ++ch)
          keep->in1[6 + 2 * F + kLat * q + ch] = lat[ch];
      }
    }
  }
  activate_into<H, kStride, kKeep>(acc, hs, P.act, P.act_param,
                                   kKeep ? keep->hs : nullptr,
                                   kKeep ? keep->dact : nullptr);
#pragma unroll 1
  for (int l = 0; l < P.n_hidden; ++l) {
    const float* W = N.Wh + l * H * H;
#pragma unroll
    for (int o = 0; o < H; ++o) acc[o] = N.bh[l * H + o];
#pragma unroll 4
    for (int i = 0; i < H; ++i) axpy<H>(acc, W + i * H, hs[i * kStride]);
    activate_into<H, kStride, kKeep>(
        acc, hs, P.act, P.act_param, kKeep ? keep->hs + (l + 1) * H : nullptr,
        kKeep ? keep->dact + (l + 1) * H : nullptr);
  }
  float y[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) y[r] = N.bo[r];
#pragma unroll 4
  for (int i = 0; i < H; ++i) {
    const float x = hs[i * kStride];
#pragma unroll
    for (int r = 0; r < 4; ++r) y[r] = fmaf(N.Wo[r * H + i], x, y[r]);
  }
  if (kKeep) {
#pragma unroll
    for (int r = 0; r < 4; ++r) keep->y[r] = y[r];
  }
  head_value(P.head, y, out);
}

struct Ray {
  float sx, sy, sz, dx, dy, dz, a, tmx, kb;
};

__device__ __forceinline__ Ray load_ray(const Seg& P, int ray) {
  const float* rp = P.rays + (size_t)ray * 8;
  Ray r;
  r.sx = rp[0]; r.sy = rp[1]; r.sz = rp[2];
  r.dx = rp[3]; r.dy = rp[4]; r.dz = rp[5];
  r.a = rp[6]; r.tmx = rp[7];
  r.kb = P.lattice ? P.kbase[ray] : 0.0f;
  return r;
}

// Start of segment s (its first sample's t).
__device__ __forceinline__ float segment_start(const Seg& P, const Ray& r,
                                               float s0) {
  return P.lattice ? __fmul_rn(r.kb + s0, P.stepsize)
                   : __fadd_rn(r.a, __fmul_rn(s0, P.stepsize));
}

// Sample k (a float) of the ray: its t, and whether it is valid (t <=
// tmax; in lattice mode also k at or past the ray's own first point).
__device__ __forceinline__ bool sample_t(const Seg& P, const Ray& r, float kf,
                                         float& t) {
  if (P.lattice) {
    const float kk = r.kb + kf;
    t = __fmul_rn(kk, P.stepsize);
    return t <= r.tmx && kk >= r.a;
  }
  t = __fadd_rn(r.a, __fmul_rn(kf, P.stepsize));
  return t <= r.tmx;
}

__device__ __forceinline__ void sample_pos(const Seg& P, const Ray& r,
                                           float t, float& x0, float& x1,
                                           float& x2) {
  x0 = (r.sx + t * r.dx - P.bmin[0]) / P.bsize[0];
  x1 = (r.sy + t * r.dy - P.bmin[1]) / P.bsize[1];
  x2 = (r.sz + t * r.dz - P.bmin[2]) / P.bsize[2];
}

// A sample's color and absorption from the head's values `v`: the rgbo
// heads' own, or the piecewise TF at the normalized density (then `tf`
// holds the lookup). Returns false when the sample does not count (a
// density below density_min).
__device__ __forceinline__ bool sample_color(const Seg& P, const Wts& N,
                                             const float* v, float& cr,
                                             float& cg, float& cb,
                                             float& absn, TfSample& tf) {
  const float h = P.stepsize;
  if (P.head >= kRgbo) {
    cr = v[0];
    cg = v[1];
    cb = v[2];
    absn = v[3] * h;
    return true;
  }
  if (!(v[0] >= P.density_min)) return false;
  const float d = fminf(fmaxf((v[0] - P.density_min) * P.inv_range, 0.0f),
                        1.0f);
  tf_lookup(N.TF, P.tf_points, d, tf);
  cr = tf.r;
  cg = tf.g;
  cb = tf.b;
  absn = tf.op * h;
  return true;
}

// Opacity of a sample of absorption `absn`.
__device__ __forceinline__ float sample_alpha(const Seg& P, float absn) {
  return P.blend_alpha ? fminf(1.0f, absn) : 1.0f - expf(-absn);
}

// Shared memory: the packed weights, then (from a 16-byte boundary) the
// rest of the kernel's buffers.
__host__ __device__ inline size_t scratch_offset(int n_weights) {
  return ((size_t)n_weights + 3) / 4 * 4;
}

inline Seg make_seg(const float* rays, const float* kbase, const void* table,
                    const float* weights, int n_weights, int n_rays, int gx,
                    int gy, int gz, int chunks, int n_fourier, int n_hidden,
                    int tf_points, int act, float act_param, int head,
                    int has_dir, int lattice, int blend_alpha, int iso,
                    float iso_value, int seg, int n_seg, float stepsize,
                    float density_min, float inv_range, float early_alpha,
                    const float* bmin, const float* bsize) {
  Seg P;
  P.rays = rays;
  P.kbase = kbase;
  P.table = table;
  P.weights = weights;
  P.n_weights = n_weights;
  P.n_rays = n_rays;
  P.gx = gx; P.gy = gy; P.gz = gz;
  P.chunks = chunks;
  P.n_fourier = n_fourier;
  P.n_hidden = n_hidden;
  P.tf_points = tf_points;
  P.act = act;
  P.head = head;
  P.has_dir = has_dir;
  P.lattice = lattice;
  P.blend_alpha = blend_alpha;
  P.iso = iso;
  P.act_param = act_param;
  P.iso_value = iso_value;
  P.seg = seg;
  P.n_seg = n_seg;
  P.stepsize = stepsize;
  P.density_min = density_min;
  P.inv_range = inv_range;
  P.early_alpha = early_alpha;
  for (int i = 0; i < 3; ++i) {
    P.bmin[i] = bmin[i];
    P.bsize[i] = bsize[i];
  }
  P.tfm = kTfPiecewise;
  P.tf_pre = 0;
  P.tf_floats = 5 * tf_points;
  P.tf2d = nullptr;
  return P;
}

}  // namespace segment
