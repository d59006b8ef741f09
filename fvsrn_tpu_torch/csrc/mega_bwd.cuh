// Fused SRN volume-rendering march, backward (sm_90a). Included by one
// source per hidden width (mega_bwd.cu: 32, mega_bwd48.cu, mega_bwd64.cu,
// mega_bwd128.cu), each defining MEGA_WIDTH first; width 128 takes
// sample_mlp.cuh's wide plan (the hidden matrices read from the packed
// weights in device memory) on 256-ray tiles, layers of one width.
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_mega.py:_mega_bwd_kernel
// (per-segment math fvsrn_tpu/ops/fused_dvr_bwd.py:bwd_segment_core). It
// computes the same gradients, not the TPU's layout: from the cotangent of
// the march's rgba, the gradients of the Fourier matrix (its position and
// direction blocks), every layer's weight and bias (any activation, every
// output head: sample_mlp.cuh switches on both at run time), a density
// head's TF (control points, or the texture, preint1d and
// Gaussian tables; packed as the forward's weights, one partial row per
// tile; the preint2d table's by float atomics into its own array, the one
// leaf not bitwise reproducible) and the latent table (read float32 or
// bf16, the JAX kernel's slab_dtype; its gradient summed in float32,
// rounded by the wrapper). The ray-gradient instances (kRay, the JAX
// kernel's want_ray_grads) also return each ray's start and direction
// cotangent (sample_mlp.cuh's ray_fold); the others compile without it. The TF
// mode is a template parameter (sample_mlp.cuh's group_segment_tf for the
// modes other than piecewise: the previous-density chain runs through
// the stored densities and a cotangent carried to each segment's start),
// on every network: the activation, the head and the direction input are
// run-time switches in every mode, as in the JAX kernel.
//
// Layout: one block per tile of kTile rays (256, or 128 in the _t128
// sources), kTile threads, thread i owning ray i of the tile, as the
// forward. Segments run in reverse from the tile's
// last visited one (the forward stored their count and incoming carries);
// a segment is replayed only where the forward ran it: some ray of the
// tile has a live point in it and the STORED incoming carry passes the
// vote (min alpha < early_alpha), and the forward's occupancy mask (if
// any) keeps it. Skipped segments pass the carry cotangent through
// unchanged.
//
// Per replayed segment, the tile's rays go as groups of 32 (warp w
// owns group w) through sample_mlp.cuh's group_segment: the replay of the
// group's lattice points from the stored carries, as tiles of samples; the
// reverse compositing recurrence per ray (fused_dvr_bwd.py:604-628, its
// sequential form); the adjoint of the contributing samples as tiles: the
// MLP's layers, their transposes and the weight gradients as TF32
// three-pass tensor-core products over the tile's rows, the TF adjoint
// (knot positions only strictly inside the interval) and the clip gates
// (0 < density < 1, 0 < y < 1) per row, d_cos/d_sin -> d_B and d_latent ->
// the trilerp adjoint (atomics into the table gradient). Every entry of
// the tile's partial row is owned by one thread: deterministic; the
// wrapper sums the rows over tiles.
//
// Bound: operations (replay ~2x the forward's MLP per contributing sample,
// the adjoint ~1x, the weight-gradient products ~1x) against bytes of the
// stored carries read and the latent gradient.

#include "sample_mlp.cuh"
#include "mega_common.cuh"

#ifndef MEGA_WIDTH
#error "define MEGA_WIDTH (32, 48, 64 or 128) before including mega_bwd.cuh"
#endif

namespace {

using namespace mega;
using namespace smlp;

struct BwdArgs {
  const float4* carries;    // (tiles, n_seg_max, kTile)
  const int* seg_count;     // (tiles,)
  const float4* d_out;      // (R,) rgba cotangent
  float* d_weights;         // (tiles, n_weights) partial rows
  int* tile_work;           // (tiles, 2): samples replayed, contributing
  Layer L;                  // the plan, dims and gradient layout
  const float* dens_carries;  // (tiles, n_seg_max, kTile) (TF modes)
  float* d_rays;            // (R, 8) ray cotangent (kRay instances), zeroed
};

// A lattice point's position, and its ray's direction, from the group's
// staged rays; with kRay, the lattice point's t and the tile's rays'
// cotangent (sample_mlp.cuh's ray_fold).
template <bool kRay>
struct MegaSrc {
  static constexpr bool kRayGrads = kRay;
  const March& P;      // the kernel's parameters
  const float* sray;
  float ka;
  float* d_rays;       // the tile's first ray's row of the (R, 8) cotangent
  __device__ __forceinline__ float t(int j) const {
    return (ka + (float)j) * P.stepsize;
  }
  // ray r of the tile: its row gets [sum d_x / bsize, sum d_x t / bsize +
  // the direction input's], in the order ray_fold calls it
  __device__ __forceinline__ void add_ray(int r, const float* acc) const {
    float* o = d_rays + (size_t)r * 8;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] += acc[c] / P.bsize[c];
      o[3 + c] += acc[3 + c] / P.bsize[c] + acc[6 + c];
    }
  }
  __device__ __forceinline__ void pos(int rl, int j, float* x,
                                      float* d) const {
    const float* r = sray + rl * kRayF;
    const float t = (ka + (float)j) * P.stepsize;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = (r[c] + t * r[3 + c] - P.bmin[c]) / P.bsize[c];
      d[c] = r[3 + c];
    }
  }
};

template <int H, int TFM, bool kRay>
__global__ void __launch_bounds__(kTile, 2) mega_bwd_kernel(const March P,
                                                            const BwdArgs A) {
  extern __shared__ float4 smem4[];
  const Plan& pl = A.L.pl;
  const Smem S{reinterpret_cast<float*>(smem4), pl};
  const int F = P.n_fourier, nh = P.n_hidden, n_out = A.L.D.n_out;
  const Offsets off = weight_offsets(H, F, nh, n_out, P.has_dir);
  const int K1 = off.K1;
  float* g = A.d_weights + (size_t)blockIdx.x * P.n_weights;

  // the weights, transposed to input-major rows of stride ldw (zero
  // padded to K16 rows), the vectors (b1, bh, the output rows padded to
  // four, bo, B, Bd, TF), and a zero partial row
  const float* w = P.weights;
  for (int i = threadIdx.x; i < pl.K16 * pl.ldw; i += kTile) {
    const int k = i / pl.ldw, o = i % pl.ldw;
    S.W1()[i] = (k < K1 && o < H) ? w[off.W1 + o * K1 + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < (wide_width(H) ? 0 : nh * H * pl.ldw);
       i += kTile) {
    const int l = i / (H * pl.ldw), k = (i / pl.ldw) % H, o = i % pl.ldw;
    S.Wh()[i] = o < H ? w[off.Wh + (l * H + o) * H + k] : 0.0f;
  }
  const int vo = (5 + nh) * H;   // bo's start in the vector region
  for (int i = threadIdx.x; i < pl.n_vec; i += kTile) {
    float v = 0.0f;
    if (i < H) {
      v = w[off.b1 + i];
    } else if (i < (1 + nh) * H) {
      v = w[off.bh + i - H];
    } else if (i < vo) {
      const int e = i - (1 + nh) * H;
      v = e < n_out * H ? w[off.Wo + e] : 0.0f;
    } else if (i < vo + 4) {
      v = i - vo < n_out ? w[off.bo + i - vo] : 0.0f;
    } else if (i < vo + 4 + 3 * F) {
      v = w[off.B + i - vo - 4];
    } else if (i < vo + 4 + 6 * F) {
      if (P.has_dir) v = w[off.Bd + i - vo - 4 - 3 * F];
    } else {
      v = w[off.TF + i - vo - 4 - 6 * F];
    }
    S.b1()[i] = v;
  }
  for (int i = threadIdx.x; i < pl.M * pl.ldx; i += kTile) S.X()[i] = 0.0f;
  for (int i = threadIdx.x; i < P.n_weights; i += kTile) g[i] = 0.0f;
  const Ray R = load_ray(P, reinterpret_cast<float*>(S.misc()));
  // its barrier publishes the weights and the zeroed row

  MegaSrc<kRay> src{P, S.sray(), 0.0f,
                    kRay ? A.d_rays + (size_t)blockIdx.x * kTile * 8
                         : nullptr};

  const float h = P.stepsize;
  const float segf = (float)kSegMax;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kTile + threadIdx.x;
  const float4 dout = A.d_out[ray];
  float da = dout.w;                      // cotangent of the carry's alpha
  float dpc = 0.0f;          // and of its last density (TF modes)
  unsigned n_rep = 0, n_con = 0;

  for (int s = A.seg_count[blockIdx.x] - 1; s >= 0; --s) {
    const float ka = R.k0t + (float)s * segf;
    const float first = fmaxf(R.k0r, ka) * h;
    const bool alive = first <= fminf(R.tmx, (ka + (segf - 1.0f)) * h);
    const bool active = __syncthreads_or(alive) && segment_on(P, s);
    const float4 cin = A.carries[((size_t)blockIdx.x * P.n_seg_max + s)
                                 * kTile + threadIdx.x];
    const bool vote = __syncthreads_or(cin.w < P.early_alpha);
    if (!(active && vote)) continue;
    src.ka = ka;
    float pin = 0.0f;
    if (TFM != kTfPiecewise)
      pin = A.dens_carries[((size_t)blockIdx.x * P.n_seg_max + s) * kTile
                           + threadIdx.x];
#pragma unroll 1
    for (int grp = 0; grp < kTile / kGroup; ++grp) {
      uint32_t valid = 0u, first = 0u, donly = 0u;
      if (warp == grp) {
        float* sr = S.sray() + lane * kRayF;
        sr[0] = R.sx; sr[1] = R.sy; sr[2] = R.sz;
        sr[3] = R.dx; sr[4] = R.dy; sr[5] = R.dz;
        for (int j = 0; j < kSegMax; ++j) {
          const float k = ka + (float)j;
          if (k * h <= R.tmx && k >= R.k0r) valid |= 1u << j;
          if (TFM != kTfPiecewise && k == R.k0r) first |= 1u << j;
        }
        // the masked forward's density-only point (mega_fwd.cu)
        if ((TFM == kTfPreint1d || TFM == kTfPreint2d)
            && P.seg_active != nullptr && valid == 0u
            && R.k0r > ka + (segf - 1.0f))
          donly = 1u << (kSegMax - 1);
      }
      if constexpr (TFM == kTfPiecewise)
        group_segment<H, kTile>(A.L.D, S, A.L.G, g, src, grp, valid,
                                   cin.w, dout.x, dout.y, dout.z, da, n_rep,
                                   n_con);
      else
        group_segment_tf<H, kTile, MegaSrc<kRay>, TFM>(
            A.L.D, S, A.L.G, g, src, grp, valid, first, pin, cin.w, dout.x,
            dout.y, dout.z, da, dpc, n_rep, n_con, donly);
    }
  }
  if (threadIdx.x == 0) {
    A.tile_work[2 * blockIdx.x] = (int)n_rep;
    A.tile_work[2 * blockIdx.x + 1] = (int)n_con;
  }
}

template <int TFM, bool kRay>
int launch_instance(const March& P, const BwdArgs& A, int n_rays,
                    cudaStream_t st) {
  constexpr int H = MEGA_WIDTH;
  const size_t smem = (size_t)A.L.pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      mega_bwd_kernel<H, TFM, kRay>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_rays / kTile;
  if (blocks > 0)
    mega_bwd_kernel<H, TFM, kRay><<<blocks, kTile, smem, st>>>(P, A);
  return (int)cudaGetLastError();
}

// The ray-gradient instance of a TF mode only where the caller asks for
// the rays' cotangent.
template <int TFM>
int launch(const March& P, const BwdArgs& A, int n_rays, cudaStream_t st) {
  return A.d_rays != nullptr ? launch_instance<TFM, true>(P, A, n_rays, st)
                             : launch_instance<TFM, false>(P, A, n_rays, st);
}

}  // namespace

// Inputs as mega_fwd_launch's (the TF modes other than piecewise: density
// heads of every network the forward takes; `table` bf16 or float32 by
// `table_f32`), plus the forward's `carries` (tiles x n_seg_max
// x kTile float4) and `seg_count`, and the rgba cotangent `d_out` (R, 4).
// Writes `d_weights` (tiles x n_weights partial rows, packed as the
// weights) and `tile_work` (tiles x 2: samples replayed, samples
// contributing), and ADDS into `d_table` ((gz, gy, gx, 16) float32 whatever
// the table's type, zeroed by the caller). With `d_rays` ((R, 8), zeroed
// by the caller; null: no ray gradients) the ray-gradient instance ADDS
// each ray's start and direction cotangent into its columns 0-5 (6-7, the
// packet's k0_ray and tmax, stay zero as the JAX kernel's rows).
// `seg_active` is the forward's mask (or null). The TF as
// mega_fwd_launch takes it, with the forward's `dens_carries` (TF modes);
// preint2d ADDS its table's gradient into `d_tf2d` ((tf_points, tf_points)
// float4, zeroed by the caller). seg must be 32.
// Returns cudaGetLastError() (0 on success).
extern "C" int mega_bwd_launch(
    const float* rays, const void* table, int table_f32,
    const float* weights, int n_weights, const float* carries,
    const int* seg_count,
    const float* d_out, float* d_weights, float* d_table, int* tile_work,
    int n_rays, int gx, int gy, int gz, int n_lat, int n_fourier,
    int n_hidden, int tf_points, int hidden, int act, float act_param,
    int head, int has_dir, int seg, int n_seg_max, float stepsize,
    float density_min, float inv_range, float early_alpha, float bmin_x,
    float bmin_y, float bmin_z, float bsize_x, float bsize_y, float bsize_z,
    const uint8_t* seg_active, int mask_cols, int tfm, int tf_pre,
    int tf_floats, const float* tf2d, float* d_tf2d,
    const float* dens_carries, float* d_rays, void* stream) {
  if (hidden != MEGA_WIDTH || seg != kSegMax || n_fourier > kMaxFourier
      || n_hidden > kMaxHidden
      || !mega_valid(act, head, tfm, tf_points, tf_pre, tf_floats, tf2d)
      || n_lat > kLat
      || (tfm != kTfPiecewise && dens_carries == nullptr)
      || (tfm == kTfPreint2d && d_tf2d == nullptr))
    return (int)cudaErrorInvalidValue;
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  March P;
  fill_march(P, rays, table, weights, n_weights, gx, gy, gz, n_fourier,
             n_hidden, tf_points, act, act_param, head, has_dir, seg,
             n_seg_max, stepsize, density_min, inv_range, early_alpha, bmin,
             bsize);
  P.seg_active = seg_active;
  P.mask_cols = mask_cols;
  BwdArgs A;
  A.carries = reinterpret_cast<const float4*>(carries);
  A.dens_carries = dens_carries;
  A.seg_count = seg_count;
  A.d_out = reinterpret_cast<const float4*>(d_out);
  A.d_weights = d_weights;
  A.tile_work = tile_work;
  A.d_rays = d_rays;
  const int F = n_fourier, nh = n_hidden, H = MEGA_WIDTH;
  const int n_out = head_outputs(head);
  // the packed layout (mega_common.cuh's weight_offsets); the columns of
  // a row: [pos 3, dir 3 (with direction input), cos F, sin F, latent 16]
  const Offsets off = weight_offsets(H, F, nh, n_out, has_dir);
  const int K1 = off.K1, c0 = has_dir ? 6 : 3;
  const int tfn = staged_tf_floats(tfm, tf_points, tf_floats);
  if (!choose_plan(H, K1, nh, F, tfn, A.L.pl, tfm != kTfPiecewise))
    return (int)cudaErrorInvalidValue;
  Dims& D = A.L.D;
  D.F = F; D.nh = nh; D.chunks = 1; D.n_lat = n_lat; D.tp = tf_points;
  D.tpre = tf_pre;
  D.tf2d = reinterpret_cast<const float4*>(tf2d);
  D.d_tf2d = reinterpret_cast<float4*>(d_tf2d);
  D.tfg = tfn < tf_floats ? weights + off.TF : nullptr;
  D.K1 = K1; D.n_out = n_out;
  D.pos = 0; D.dir = has_dir ? 3 : -1; D.cos = c0; D.sin = c0 + F;
  D.lat = c0 + 2 * F;
  D.has_dir = has_dir; D.act = act; D.head = head;
  D.blend_alpha = 0;
  D.p = act_param; D.inv_p = 1.0f / act_param;
  D.inv_2p = 1.0f / (2.0f * act_param); D.density_min = density_min;
  D.inv_range = inv_range; D.h = stepsize;
  D.gx = gx; D.gy = gy; D.gz = gz;
  D.table = table;
  D.table_bf16 = !table_f32;
  D.d_table = d_table;
  D.Wg = weights + off.Wh;   // the wide plan's: the packed, output-major
  D.wg_om = 1;
  GOut& G = A.L.G;
  G.W1 = off.W1; G.W1_k = 1; G.W1_o = K1;
  G.Wh = off.Wh; G.Wh_l = H * H; G.Wh_i = 1; G.Wh_o = H;
  G.b1 = off.b1; G.bh = off.bh; G.Wo = off.Wo; G.Wo_r = H; G.bo = off.bo;
  G.B = off.B; G.Bd = has_dir ? off.Bd : -1; G.TF = off.TF;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tfm) {
    case kTfTexture: return launch<kTfTexture>(P, A, n_rays, st);
    case kTfPreint1d: return launch<kTfPreint1d>(P, A, n_rays, st);
    case kTfPreint2d: return launch<kTfPreint2d>(P, A, n_rays, st);
    case kTfGaussian: return launch<kTfGaussian>(P, A, n_rays, st);
    default: return launch<kTfPiecewise>(P, A, n_rays, st);
  }
}
