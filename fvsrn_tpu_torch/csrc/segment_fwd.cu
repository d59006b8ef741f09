// The per-segment fused march, forward (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_dvr.py:_segment_kernel as
// fused_trace_dvr launches it (differentiable=False): every network the
// SRN takes (any activation, the five output heads, direction input, no
// latent grid, a grid of <= 16 channels as a bf16 or float32 table, or
// more than 16 channels in float32), per-ray sampling t = tmin + k*h or the
// lattice t = k*h from the ray tile's base, the piecewise-linear TF or the
// rgbo heads' own color, Beer-Lambert or alpha blending, and the
// isosurface first-hit epilogue.
//
// The image is decided by the TPU engine's stop rule, which is global to
// the call: segment s runs for EVERY ray while some ray of the call is
// alive at s (its segment start still <= tmax and its alpha < early_alpha
// on entry to s). A ray that saturated keeps compositing until the last
// live ray of the call is done; a per-ray or per-tile early-out would
// differ by ~1e-3. The kernel reproduces the stop S exactly without a host
// sync, in two launches of the same kernel:
//  - phase 0: each ray marches until its own death (segment start past
//    tmax, or alpha >= early_alpha on entry) and atomicMax-es S;
//  - phase 1: each ray that died of saturation before S composites its
//    segments up to S (a ray past tmax has no valid sample left).
// Segments are independent per ray, so there is no block barrier besides
// the one that publishes the weights.
//
// Layout: one thread per ray, 128 threads per block, rays in the caller's
// order. The packed float32 weights (layout below) are staged once per
// block in shared memory; every thread reads the same weight at the same
// time (broadcasts). Each thread keeps its layer's accumulators in
// registers and the activated layer in its own column of shared memory,
// so the loops over a layer's inputs and the activation run as loops and
// not as unrolled copies: every transcendental of the activations and
// heads is compiled once per instance, which keeps nvcc's time in seconds.
// Samples past tmax are not evaluated. The hidden width is a template
// parameter (32, 48 or 64; narrower networks are zero-padded by the
// wrapper, which is exact), the latent table type too; the activation and
// the output head are runtime switches, uniform across the block.
//
// Bound: operations. A sample of the dense flagship costs ~7.6 kFLOP
// (the MLP's multiply-adds, trilerp, TF) and ~110 transcendentals against
// 32 bytes of ray data per ray; the table stays in L2. This first version
// runs the MLP on the float32 CUDA cores, one sample per thread at a time.

#include "march_common.cuh"

namespace {

using namespace march;

constexpr int kBlock = 128;
constexpr int kMaxFourier = 32;
constexpr int kMaxHidden = 6;   // hidden->hidden layers
constexpr int kMaxTf = 16;
constexpr int kMaxChunks = 4;   // latent channels <= 64, in rows of 16

enum Act { kNone = 0, kReLU, kSine, kSigmoid, kSoftplus, kSnake, kSnakeAlt };
enum Head { kDensity = 0, kDensityDirect, kRgbo, kRgboDirect, kRgboExp };

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
};

struct SegOut {
  float4* out;                 // (R,) rgba, or (depth, 0, 0, found) for iso
  int* death;                  // (R,) segment at which the ray died
  unsigned long long* stats;   // [stop segment S, samples evaluated]
};

// Packed float32 weights, H the padded hidden width, F Fourier features,
// K1 = 6 + 2F + 16*chunks, every matrix stored input-major (row i holds
// the H outputs' weights of input i): layer 1 (K1, H) over [pos 3, dir 3,
// cos F, sin F, latent]; its bias (H); n_hidden hidden layers (H, H),
// their biases (n_hidden, H); the output rows (4, H) (output-major) and
// biases (4), unused rows zero; Fourier B (F, 3) over positions; its
// direction block (F, 3); TF control points (tf_points, 5). Every block
// before B starts at a multiple of 4 floats (H is a multiple of 16).
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

// The layer's activation, from the accumulators into the thread's column
// `hs` (stride kBlock) of shared memory.
template <int H>
__device__ __forceinline__ void activate_into(const float* acc, float* hs,
                                              int act, float p) {
#pragma unroll
  for (int o = 0; o < H; ++o) hs[o * kBlock] = acc[o];
#pragma unroll 1
  for (int o = 0; o < H; ++o)
    hs[o * kBlock] = activation(hs[o * kBlock], act, p);
}

// The SRN at one sample: world-normalized position x, ray direction d.
// Writes the output head's values (1 for density heads, 4 for rgbo).
// `hs` is the thread's column of the activation scratch.
template <int H, typename Table>
__device__ __forceinline__ void network(const Seg& P, const Wts& N, float* hs,
                                        float x0, float x1, float x2,
                                        float d0, float d1, float d2,
                                        float* out) {
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
#pragma unroll 1
  for (int i = 0; i < F; ++i) {
    float f = fourier_phase(N.B, i, x0, x1, x2);
    if (P.has_dir) f += fourier_phase(N.Bd, i, d0, d1, d2);
    float sn, cs;
    sincosf(f, &sn, &cs);
    axpy<H>(acc, N.W1 + (6 + i) * H, cs);
    axpy<H>(acc, N.W1 + (6 + F + i) * H, sn);
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
    }
  }
  activate_into<H>(acc, hs, P.act, P.act_param);
#pragma unroll 1
  for (int l = 0; l < P.n_hidden; ++l) {
    const float* W = N.Wh + l * H * H;
#pragma unroll
    for (int o = 0; o < H; ++o) acc[o] = N.bh[l * H + o];
#pragma unroll 4
    for (int i = 0; i < H; ++i) axpy<H>(acc, W + i * H, hs[i * kBlock]);
    activate_into<H>(acc, hs, P.act, P.act_param);
  }
  float y[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) y[r] = N.bo[r];
#pragma unroll 4
  for (int i = 0; i < H; ++i) {
    const float x = hs[i * kBlock];
#pragma unroll
    for (int r = 0; r < 4; ++r) y[r] = fmaf(N.Wo[r * H + i], x, y[r]);
  }
  switch (P.head) {
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

struct Ray {
  float sx, sy, sz, dx, dy, dz, a, tmx, kb;
};

// Segments [s_begin, s_end) of one ray. Returns the first segment at which
// the ray is dead: its segment start lies past tmax (then it has no valid
// sample left) or, with `vote`, its alpha is >= early_alpha on entry.
template <int H, typename Table>
__device__ __forceinline__ int march(const Seg& P, const Wts& N, float* hs,
                                     const Ray& r, int s_begin, int s_end,
                                     bool vote, float4& c, unsigned& n) {
  const float h = P.stepsize;
  for (int s = s_begin; s < s_end; ++s) {
    const float s0 = (float)(s * P.seg);
    const float t0 = P.lattice ? __fmul_rn(r.kb + s0, h)
                               : __fadd_rn(r.a, __fmul_rn(s0, h));
    if (t0 > r.tmx) return s;
    if (vote && c.w >= P.early_alpha) return s;
    for (int j = 0; j < P.seg; ++j) {
      const float kf = s0 + (float)j;
      float t;
      bool valid;
      if (P.lattice) {
        const float kk = r.kb + kf;
        t = __fmul_rn(kk, h);
        valid = t <= r.tmx && kk >= r.a;
      } else {
        t = __fadd_rn(r.a, __fmul_rn(kf, h));
        valid = t <= r.tmx;
      }
      if (!valid) continue;
      if (P.iso && c.w > 0.5f) break;   // the hit is found: nothing changes
      ++n;
      const float x0 = (r.sx + t * r.dx - P.bmin[0]) / P.bsize[0];
      const float x1 = (r.sy + t * r.dy - P.bmin[1]) / P.bsize[1];
      const float x2 = (r.sz + t * r.dz - P.bmin[2]) / P.bsize[2];
      float v[4];
      network<H, Table>(P, N, hs, x0, x1, x2, r.dx, r.dy, r.dz, v);
      if (P.iso) {
        if (v[0] > P.iso_value) {
          c.x = t;
          c.w = 1.0f;
        }
        continue;
      }
      float cr, cg, cb, absn;
      if (P.head >= kRgbo) {
        cr = v[0];
        cg = v[1];
        cb = v[2];
        absn = v[3] * h;
      } else {
        if (!(v[0] >= P.density_min)) continue;
        const float d = fminf(
            fmaxf((v[0] - P.density_min) * P.inv_range, 0.0f), 1.0f);
        TfSample tf;
        tf_lookup(N.TF, P.tf_points, d, tf);
        cr = tf.r;
        cg = tf.g;
        cb = tf.b;
        absn = tf.op * h;
      }
      const float a = P.blend_alpha ? fminf(1.0f, absn) : 1.0f - expf(-absn);
      over(c.x, c.y, c.z, c.w, cr, cg, cb, a);
    }
  }
  return s_end;
}

// Shared memory: the packed weights, then (from a 16-byte boundary) the
// activation scratch, H rows of kBlock floats.
__host__ __device__ inline size_t scratch_offset(int n_weights) {
  return ((size_t)n_weights + 3) / 4 * 4;
}

template <int H, typename Table>
__global__ void __launch_bounds__(kBlock) segment_fwd_kernel(const Seg P,
                                                             const SegOut O,
                                                             int phase) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < P.n_weights; i += kBlock) sw[i] = P.weights[i];
  __syncthreads();
  const Wts N = carve(sw, P, H);
  float* hs = sw + scratch_offset(P.n_weights) + threadIdx.x;

  const int ray = blockIdx.x * kBlock + threadIdx.x;
  int death = 0;
  unsigned n = 0;
  if (ray < P.n_rays) {
    // phase 0 marches every segment from the start, voting; phase 1
    // continues a ray that died of saturation before the call's stop
    int from = 0, to = P.n_seg;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (phase == 1) {
      from = O.death[ray];
      to = (int)O.stats[0];
      if (from < to) c = O.out[ray];
    }
    if (from < to) {
      const float* rp = P.rays + (size_t)ray * 8;
      Ray r;
      r.sx = rp[0]; r.sy = rp[1]; r.sz = rp[2];
      r.dx = rp[3]; r.dy = rp[4]; r.dz = rp[5];
      r.a = rp[6]; r.tmx = rp[7];
      r.kb = P.lattice ? P.kbase[ray] : 0.0f;
      death = march<H, Table>(P, N, hs, r, from, to, phase == 0, c, n);
    }
    if (phase == 0) {
      O.out[ray] = c;
      O.death[ray] = death;
    } else if (from < to) {
      O.out[ray] = c;
    }
  }
  // one atomic per warp (every lane reaches here)
  const unsigned m = __reduce_max_sync(0xffffffffu, (unsigned)death);
  const unsigned total = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) {
    if (phase == 0) atomicMax(O.stats, (unsigned long long)m);
    atomicAdd(O.stats + 1, (unsigned long long)total);
  }
}

template <int H, typename Table>
int launch(const Seg& P, const SegOut& O, int phase, cudaStream_t stream) {
  const size_t smem =
      (scratch_offset(P.n_weights) + (size_t)H * kBlock) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_fwd_kernel<H, Table>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P.n_rays + kBlock - 1) / kBlock;
  if (blocks > 0)
    segment_fwd_kernel<H, Table><<<blocks, kBlock, smem, stream>>>(P, O,
                                                                   phase);
  return (int)cudaGetLastError();
}

template <typename Table>
int launch_width(const Seg& P, const SegOut& O, int hidden, int phase,
                 cudaStream_t stream) {
  switch (hidden) {
    case 32: return launch<32, Table>(P, O, phase, stream);
    case 48: return launch<48, Table>(P, O, phase, stream);
    case 64: return launch<64, Table>(P, O, phase, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One phase of the march (0: each ray to its own death, 1: the
// continuation up to the call's stop). Weights packed as `Wts` above with
// the padded hidden width `hidden` (32, 48 or 64). `table` is (gz, gy, gx,
// 16 * chunks), bf16 (table_f32 = 0) or float32; with chunks = 0 it is not
// read. `kbase` is read in lattice mode only. `stats` ([S, samples], int64)
// must be zero before phase 0. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int segment_fwd_launch(
    const float* rays, const float* kbase, const void* table, int table_f32,
    const float* weights, int n_weights, float* out, int* death,
    unsigned long long* stats, int n_rays, int gx, int gy, int gz,
    int chunks, int n_fourier, int n_hidden, int hidden, int tf_points,
    int act, float act_param, int head, int has_dir, int lattice,
    int blend_alpha, int iso, float iso_value, int seg, int n_seg,
    float stepsize, float density_min, float inv_range, float early_alpha,
    float bmin_x, float bmin_y, float bmin_z, float bsize_x, float bsize_y,
    float bsize_z, int phase, void* stream) {
  if (n_fourier > kMaxFourier || n_hidden > kMaxHidden || tf_points > kMaxTf
      || tf_points < 2 || chunks > kMaxChunks || chunks < 0 || seg < 1
      || act < kNone || act > kSnakeAlt || head < kDensity
      || head > kRgboExp || (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
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
  P.bmin[0] = bmin_x; P.bmin[1] = bmin_y; P.bmin[2] = bmin_z;
  P.bsize[0] = bsize_x; P.bsize[1] = bsize_y; P.bsize[2] = bsize_z;
  SegOut O;
  O.out = reinterpret_cast<float4*>(out);
  O.death = death;
  O.stats = stats;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch_width<F32Table>(P, O, hidden, phase, st)
                   : launch_width<Bf16Table>(P, O, hidden, phase, st);
}
