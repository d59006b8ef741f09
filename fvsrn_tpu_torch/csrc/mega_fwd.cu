// Fused SRN volume-rendering march, forward only (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_mega.py:_mega_fwd_kernel in
// its non-differentiable launch. Per sample: lattice position, trilinear
// latent fetch from a bf16 channel-last table, Fourier features, the SRN's
// MLP in float32, output head, piecewise-linear TF and Beer-Lambert "over"
// into the ray's carry.
//
// Layout: one thread block per tile of 256 rays (one thread per ray), in
// the caller's order (the product path passes 16x16 pixel blocks). The
// weights and TF control points are staged once per block in shared
// memory; every thread reads the same weight at the same time, so the
// reads are broadcasts. The 16-channel latent corner is 32 contiguous bytes
// (two 16-byte loads); the ~1 MB table stays in L2.
//
// Semantics kept from the TPU kernel (they decide the image):
//  - samples sit on the global lattice t = k*h; the tile's base k0t is the
//    minimum of ceil(tmin/h) over ALL its rays, box-missing rays included;
//  - the march runs in segments of `seg` lattice points from k0t; a
//    segment runs only when some ray of the tile has a live point in it,
//    and only while some ray of the tile has alpha < early_alpha (the vote
//    is taken at the segment's start, on the carry of the previous one);
//  - a sample counts when t <= tmax (already clipped) and k >= k0_ray, and
//    its value is >= density_min.
// A per-ray early-out would give another image; the vote is per tile.
//
// Bound: operations. A sample costs ~7.6 kFLOP (2*(14*3 + 47*32 + 2*32*32
// + 32) for the MLP, plus trilerp and TF) and 110 transcendentals, against
// 44 bytes of ray data per ray; this first version runs it on the float32
// CUDA cores, one sample at a time per thread. Moving the 32-wide layers
// to mma/wgmma over samples batched per warpgroup is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHid = 32;      // hidden width
constexpr int kLat = 16;      // latent channels in the table (zero padded)
constexpr int kTile = 256;    // rays per block = threads per block

struct Params {
  const float* rays;        // (R, 8): start xyz, dir xyz, k0_ray, tmax
  const uint4* table;       // (gz, gy, gx, 16) bf16
  const float* weights;     // packed, see mega_fwd_launch
  float* out;               // (R, 4) rgba
  int* tile_samples;        // (R / 256,) samples evaluated per tile
  int n_weights;
  int gx, gy, gz;
  int n_fourier, n_hidden, tf_points;
  float act_param;          // SnakeAlt frequency
  int seg;
  float stepsize, density_min, inv_range, early_alpha;
  float bmin[3], bsize[3];
};

// SnakeAlt: (x + 1 - cos(2 p x)) / (2 p)
__device__ __forceinline__ float snake_alt(float x, float p) {
  return (x + 1.0f - cosf(2.0f * p * x)) / (2.0f * p);
}

// Trilinear fetch with grid_sample semantics (align_corners=False, border
// clamp); x in [0, 1] maps to voxel centers at (i + 0.5) / n.
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

__device__ __forceinline__ void accumulate_bf16x8(uint4 q, float w,
                                                  float* lat) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lat[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), lat[2 * i]);
    lat[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u),
                          lat[2 * i + 1]);
  }
}

__device__ __forceinline__ void trilerp(const Params& P, float x0, float x1,
                                        float x2, float* lat) {
  int lx, hx, ly, hy, lz, hz;
  float fx, fy, fz;
  corner_axis(x0, P.gx, lx, hx, fx);
  corner_axis(x1, P.gy, ly, hy, fy);
  corner_axis(x2, P.gz, lz, hz, fz);
#pragma unroll
  for (int c = 0; c < kLat; ++c) lat[c] = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int cx = corner & 1, cy = (corner >> 1) & 1, cz = corner >> 2;
    const float w = (cz ? fz : 1.0f - fz) * (cy ? fy : 1.0f - fy)
                    * (cx ? fx : 1.0f - fx);
    const size_t row = ((size_t)(cz ? hz : lz) * P.gy + (cy ? hy : ly))
                       * P.gx + (cx ? hx : lx);
    const uint4* p = P.table + row * 2;
    accumulate_bf16x8(__ldg(p), w, lat);
    accumulate_bf16x8(__ldg(p + 1), w, lat + 8);
  }
}

__global__ void __launch_bounds__(kTile) mega_fwd_kernel(const Params P) {
  extern __shared__ float sw[];
  __shared__ float red_f[kTile / 32];
  __shared__ int red_i[kTile / 32];

  for (int i = threadIdx.x; i < P.n_weights; i += kTile) sw[i] = P.weights[i];
  const int F = P.n_fourier;
  const int K1 = 3 + 2 * F + kLat;
  const float* sB = sw;                          // (F, 3)
  const float* sW1 = sB + 3 * F;                 // (32, K1)
  const float* sb1 = sW1 + kHid * K1;            // (32)
  const float* sWh = sb1 + kHid;                 // (n_hidden, 32, 32)
  const float* sbh = sWh + P.n_hidden * kHid * kHid;
  const float* sWo = sbh + P.n_hidden * kHid;    // (32)
  const float* sbo = sWo + kHid;                 // (1)
  const float* sTF = sbo + 1;                    // (tf_points, 5)

  const int ray = blockIdx.x * kTile + threadIdx.x;
  const float* rp = P.rays + (size_t)ray * 8;
  const float sx = rp[0], sy = rp[1], sz = rp[2];
  const float dx = rp[3], dy = rp[4], dz = rp[5];
  const float k0r = rp[6], tmx = rp[7];

  // k0t: minimum of k0_ray over every ray of the tile (fminf skips NaN)
  float m = k0r;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red_f[threadIdx.x >> 5] = m;
  __syncthreads();  // also publishes the staged weights
  float k0t = red_f[0];
#pragma unroll
  for (int w = 1; w < kTile / 32; ++w) k0t = fminf(k0t, red_f[w]);

  const float h = P.stepsize;
  const float segf = (float)P.seg;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
  int n_samples = 0;

  for (int s = 0;; ++s) {
    const float ka = k0t + (float)s * segf;
    const float first = fmaxf(k0r, ka) * h;
    const bool later = first <= tmx;   // a live point at or after ka
    const bool alive = first <= fminf(tmx, (ka + (segf - 1.0f)) * h);
    if (!__syncthreads_or(later)) break;          // the tile is done
    const bool active = __syncthreads_or(alive);
    if (!__syncthreads_or(ca < P.early_alpha)) break;  // tile saturated
    if (!active || !alive) continue;

    for (int j = 0; j < P.seg; ++j) {
      const float k = ka + (float)j;
      const float t = k * h;
      if (!(t <= tmx && k >= k0r)) continue;
      ++n_samples;
      const float x0 = (sx + t * dx - P.bmin[0]) / P.bsize[0];
      const float x1 = (sy + t * dy - P.bmin[1]) / P.bsize[1];
      const float x2 = (sz + t * dz - P.bmin[2]) / P.bsize[2];

      // layer 1 over [pos, cos(Bx), sin(Bx), latent]
      float acc[kHid];
#pragma unroll
      for (int o = 0; o < kHid; ++o) {
        const float* w = sW1 + o * K1;
        acc[o] = fmaf(w[0], x0, fmaf(w[1], x1, fmaf(w[2], x2, sb1[o])));
      }
      for (int i = 0; i < F; ++i) {
        const float f = sB[3 * i] * x0 + sB[3 * i + 1] * x1
                        + sB[3 * i + 2] * x2;
        float sn, cs;
        sincosf(f, &sn, &cs);
#pragma unroll
        for (int o = 0; o < kHid; ++o) {
          const float* w = sW1 + o * K1 + 3;
          acc[o] = fmaf(w[i], cs, fmaf(w[F + i], sn, acc[o]));
        }
      }
      float lat[kLat];
      trilerp(P, x0, x1, x2, lat);
#pragma unroll
      for (int c = 0; c < kLat; ++c) {
#pragma unroll
        for (int o = 0; o < kHid; ++o)
          acc[o] = fmaf(sW1[o * K1 + 3 + 2 * F + c], lat[c], acc[o]);
      }
      float hid[kHid];
#pragma unroll
      for (int o = 0; o < kHid; ++o)
        hid[o] = snake_alt(acc[o], P.act_param);
      for (int l = 0; l < P.n_hidden; ++l) {
        const float* W = sWh + l * kHid * kHid;
#pragma unroll
        for (int o = 0; o < kHid; ++o) acc[o] = sbh[l * kHid + o];
#pragma unroll
        for (int i = 0; i < kHid; ++i) {
#pragma unroll
          for (int o = 0; o < kHid; ++o)
            acc[o] = fmaf(W[o * kHid + i], hid[i], acc[o]);
        }
#pragma unroll
        for (int o = 0; o < kHid; ++o)
          hid[o] = snake_alt(acc[o], P.act_param);
      }
      float y = sbo[0];
#pragma unroll
      for (int i = 0; i < kHid; ++i) y = fmaf(sWo[i], hid[i], y);
      const float value = fminf(fmaxf(y, 0.0f), 1.0f);  // density:direct
      if (!(value >= P.density_min)) continue;

      // piecewise-linear TF: interval = number of interior knots <= d
      const float d = fminf(fmaxf((value - P.density_min) * P.inv_range,
                                  0.0f), 1.0f);
      int iv = 0;
      for (int q = 1; q < P.tf_points - 1; ++q) iv += (sTF[q * 5 + 4] <= d);
      const float* c0 = sTF + iv * 5;
      const float* c1 = c0 + 5;
      const float frac = (fminf(fmaxf(d, c0[4]), c1[4]) - c0[4])
                         / (c1[4] - c0[4]);
      const float r = c0[0] + frac * (c1[0] - c0[0]);
      const float g = c0[1] + frac * (c1[1] - c0[1]);
      const float b = c0[2] + frac * (c1[2] - c0[2]);
      const float absn = (c0[3] + frac * (c1[3] - c0[3])) * h;
      const float a = 1.0f - expf(-absn);  // Beer-Lambert
      const float w = (1.0f - ca) * a;
      cr = fmaf(w, r, cr);
      cg = fmaf(w, g, cg);
      cb = fmaf(w, b, cb);
      ca = ca + (1.0f - ca) * a;
    }
  }

  reinterpret_cast<float4*>(P.out)[ray] = make_float4(cr, cg, cb, ca);
  const int n = __reduce_add_sync(0xffffffffu, n_samples);
  if ((threadIdx.x & 31) == 0) red_i[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) total += red_i[w];
    P.tile_samples[blockIdx.x] = total;
  }
}

}  // namespace

// Packed weights (float32, in this order): Fourier matrix B (F, 3); layer 1
// (32, 3 + 2F + 16) over [pos, cos, sin, latent]; its bias (32); n_hidden
// hidden layers (32, 32) each, then their biases (n_hidden, 32); output
// row (32); output bias (1); TF control points (tf_points, 5) as [r, g, b,
// absorption, position]. n_rays must be a multiple of 256. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mega_fwd_launch(
    const float* rays, const void* table, const float* weights,
    int n_weights, float* out, int* tile_samples, int n_rays,
    int gx, int gy, int gz, int n_fourier, int n_hidden, int tf_points,
    float act_param, int seg, float stepsize, float density_min, float inv_range,
    float early_alpha, float bmin_x, float bmin_y, float bmin_z,
    float bsize_x, float bsize_y, float bsize_z, void* stream) {
  Params P;
  P.rays = rays;
  P.table = static_cast<const uint4*>(table);
  P.weights = weights;
  P.out = out;
  P.tile_samples = tile_samples;
  P.n_weights = n_weights;
  P.gx = gx; P.gy = gy; P.gz = gz;
  P.n_fourier = n_fourier;
  P.n_hidden = n_hidden;
  P.tf_points = tf_points;
  P.act_param = act_param;
  P.seg = seg;
  P.stepsize = stepsize;
  P.density_min = density_min;
  P.inv_range = inv_range;
  P.early_alpha = early_alpha;
  P.bmin[0] = bmin_x; P.bmin[1] = bmin_y; P.bmin[2] = bmin_z;
  P.bsize[0] = bsize_x; P.bsize[1] = bsize_y; P.bsize[2] = bsize_z;
  const size_t smem = (size_t)n_weights * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = n_rays / kTile;
  if (blocks > 0) {
    mega_fwd_kernel<<<blocks, kTile, smem,
                      static_cast<cudaStream_t>(stream)>>>(P);
  }
  return (int)cudaGetLastError();
}
