// Device code shared by the megakernel's forward (mega_fwd.cu) and
// backward (mega_bwd.cu): the packed-weight layout, the call's geometry,
// the tile's rays and occupancy mask. The per-sample pieces every fused
// march shares (trilinear latent fetch and its adjoint, Fourier phase,
// TFs of every mode, the "over" step) are in march_common.cuh. Both
// kernels evaluate their samples as tiles: the forward on warp_mlp.cuh,
// the backward on sample_mlp.cuh; the backward's replay agrees with the
// forward to float32 rounding, not bit for bit. The hidden width is a
// template parameter of both (32, 48 or 64; narrower networks are
// zero-padded by the wrapper, which is exact), one source per width
// (mega_fwd.cu, mega_fwd48.cu, mega_fwd64.cu and the same for mega_bwd).
// The ray tile is MEGA_TILE rays (a block's threads), 256 unless the
// source defines 128 first (mega_fwd_t128.cu and the like, a library
// each). The tile is part of the result, not a schedule: the early-out
// is a saturation vote per tile (replayed by the backward), so the two
// tiles give different images wherever the vote fires. Only 128 and 256
// are built: the JAX package's config chooser yields multiples of 128
// (fvsrn_tpu/ops/fused_dvr.py:choose_fused_config), its benchmark marches
// 128-ray tiles and its product render 256-ray ones.
#pragma once

#include "march_common.cuh"

#ifndef MEGA_TILE
#define MEGA_TILE 256
#endif
#if MEGA_TILE != 128 && MEGA_TILE != 256
#error "MEGA_TILE must be 128 or 256"
#endif

namespace mega {

using namespace march;

constexpr int kTile = MEGA_TILE;   // rays per block = threads per block
constexpr int kMaxFourier = 32;
constexpr int kMaxHidden = 6;   // hidden->hidden layers
constexpr int kMaxTf = 16;      // TF control points

// Geometry and options of one march, shared by both kernels.
struct March {
  const float* rays;        // (R, 8): start xyz, dir xyz, k0_ray, tmax
  const void* table;        // (gz, gy, gx, 16), bf16 or float32
  const float* weights;     // packed, see `Offsets`
  int n_weights;
  int gx, gy, gz;
  int n_fourier, n_hidden, tf_points;
  int act, head, has_dir;   // march_common.cuh's Act and Head, direction
  float act_param;          // the activation's parameter
  int seg;
  int n_seg_max;            // segments a tile may visit (carry storage)
  float stepsize, density_min, inv_range, early_alpha;
  float bmin[3], bsize[3];
  const uint8_t* seg_active;  // (tiles, mask_cols) occupancy mask, or null
  int mask_cols;
};

// Packed float32 weights of hidden width H (padded), in this order:
// Fourier matrix B (F, 3) over the position; with direction input its
// direction block Bd (F, 3); layer 1 (H, K1) over [pos 3, dir 3 (with
// direction input), cos F, sin F, latent 16]; its bias (H); n_hidden
// hidden layers (H, H) each, then their biases (n_hidden, H); the output
// rows (n_out, H) (1 for a density head, 4 for rgbo) and biases (n_out);
// a density head's TF: control points (tf_points, 5) as [r, g, b,
// absorption, position], or the other modes' table (tf_floats floats;
// none for preint2d, whose table is its own array). Every matrix is
// output-major. The backward's weight gradient uses the same layout.
struct Offsets {
  int B, Bd, W1, b1, Wh, bh, Wo, bo, TF, K1;
};

__host__ __device__ inline Offsets weight_offsets(int H, int F, int n_hidden,
                                                  int n_out, int has_dir) {
  Offsets o;
  o.K1 = (has_dir ? 6 : 3) + 2 * F + kLat;
  o.B = 0;
  o.Bd = o.B + 3 * F;
  o.W1 = o.Bd + (has_dir ? 3 * F : 0);
  o.b1 = o.W1 + H * o.K1;
  o.Wh = o.b1 + H;
  o.bh = o.Wh + n_hidden * H * H;
  o.Wo = o.bh + n_hidden * H;
  o.bo = o.Wo + n_out * H;
  o.TF = o.bo + n_out;
  return o;
}

// Values of an output head.
__host__ __device__ inline int head_outputs(int head) {
  return head >= kRgbo ? 4 : 1;
}

// Whether a launch's network and TF are ones the kernels take: an rgbo
// head reads no TF (piecewise with no rows), a density head one the
// kernels hold (march_common.cuh's tf_valid).
inline bool mega_valid(int act, int head, int tfm, int tf_points,
                       int tf_pre, int tf_floats, const void* tf2d) {
  if (act < kNone || act > kSnakeAlt || head < kDensity || head > kRgboExp)
    return false;
  if (head >= kRgbo)
    return tfm == kTfPiecewise && tf_points == 0 && tf_floats == 0;
  return tf_valid(tfm, tf_points, tf_pre, tf_floats, tf2d, kMaxTf);
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
                       int act, float act_param, int head, int has_dir,
                       int seg, int n_seg_max,
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
  P.act = act;
  P.head = head;
  P.has_dir = has_dir;
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
  P.seg_active = nullptr;
  P.mask_cols = 0;
}


// The caller's per-(tile, segment) occupancy mask (the JAX kernel's
// `segment_active`), ANDed into a segment's activity by both kernels: a 0
// culls the segment before any sample of it is evaluated. No mask
// (kMasked false, or a null mask), or a segment past the mask's last
// column, culls nothing. Uniform across the block.
template <bool kMasked = true>
__device__ __forceinline__ bool segment_on(const March& P, int s) {
  if (!kMasked) return true;
  return P.seg_active == nullptr || s >= P.mask_cols
         || P.seg_active[(size_t)blockIdx.x * P.mask_cols + s] != 0;
}

}  // namespace mega
