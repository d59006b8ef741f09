// The per-segment fused march, backward (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_dvr_bwd.py:_segment_bwd_kernel
// (make_segment_op's backward; its math in bwd_segment_core), which the
// differentiable scan of fused_trace_dvr(differentiable=True) runs once per
// (ray tile, segment) program, segments in reverse. It computes the same
// gradients, not the TPU's layout: from the cotangent of the march's rgba,
// the gradients of every layer's weight and bias, the Fourier matrix (its
// position and direction blocks), the TF control points (colors, opacity,
// interior knot positions; the texture, preint1d and Gaussian tables;
// packed as the forward's weights, one partial row per block; the preint2d
// table's by float atomics into its own array, the one leaf not bitwise
// reproducible) and the latent table (read float32 or bf16, its gradient
// summed in float32 either way, rounded by the wrapper as the JAX
// package's table_dtype cast). The rays get none (the
// TPU's custom VJP gives them zeros). The TF mode is a template parameter
// (sample_mlp.cuh's group_segment_tf for the modes other than piecewise,
// density heads), every mode on every network: the activation and the
// direction input are run-time switches.
//
// One launch per step, 64 rays per block in two groups of 32, 256
// threads. Each ray walks its segments in reverse from its last
// (segment_fwd.cu's phase 0 stored the number it ran and the carry
// entering each); the differentiable march has no early-out, so every
// segment before that count ran and none after it has a valid sample. Per
// segment and group, sample_mlp.cuh's group_segment: the replay of the
// group's valid samples from the stored carries, as tiles; the reverse
// compositing recurrence per ray (fused_dvr_bwd.py:606-628, its sequential
// form, no alpha gating); the adjoint of the contributing samples as
// tiles: the network's layers, their transposes and the weight gradients
// as TF32 three-pass tensor-core products over the tile's rows, the head /
// TF adjoint and clip gates (strictly inside) per row, d_cos/d_sin -> d_B
// (and d_Bd with direction input), d_latent -> the trilerp adjoint
// (16-byte atomics into the table gradient). Weight gradients go into the
// block's partial row, each entry owned by one thread: deterministic; the
// wrapper sums the rows.
//
// Bound: operations (the replay as much as the forward, the adjoint about
// three times its MLP per contributing sample: recompute, transposed
// layers, weight-gradient products) against the stored carries read and
// the latent gradient written.

#include "sample_mlp.cuh"
#include "segment_common.cuh"

namespace {

using namespace march;
using namespace segment;
using namespace smlp;

constexpr int kBlockB = 64;                 // rays per block
constexpr int kThreads = 256;               // threads per block
constexpr int kGroups = kBlockB / kGroup;   // warp w < kGroups owns group w

struct BwdArgs {
  const float4* carries;       // (n_seg, R) carry entering each segment
  const float* dens_carries;   // (n_seg, R) its last density (TF modes)
  const int* death;            // (R,) segments each ray ran
  const float4* d_out;         // (R,) rgba cotangent
  float* d_weights;            // (blocks, n_weights) partial rows, zeroed
  unsigned long long* work;    // [samples replayed, samples contributing]
  Layer L;                     // the plan, dims and gradient layout
};

// A sample's position from the group's staged rays (segment_common.cuh's
// sample_t and sample_pos).
struct SegSrc {
  static constexpr bool kRayGrads = false;   // the rays get none
  const Seg& P;        // the kernel's parameters
  const float* sray;
  float s0;
  __device__ __forceinline__ void pos(int rl, int j, float* x,
                                      float* d) const {
    const float* r = sray + rl * kRayF;
    const float kf = s0 + (float)j;
    const float t = P.lattice ? __fmul_rn(r[8] + kf, P.stepsize)
                              : __fadd_rn(r[6], __fmul_rn(kf, P.stepsize));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = (r[c] + t * r[3 + c] - P.bmin[c]) / P.bsize[c];
      d[c] = r[3 + c];
    }
  }
};

template <int H, int TFM>
__global__ void __launch_bounds__(kThreads, 2) segment_bwd_kernel(const Seg P,
                                                                  const BwdArgs A) {
  extern __shared__ float4 smem4[];
  const Plan& pl = A.L.pl;
  const Smem S{reinterpret_cast<float*>(smem4), pl};
  const int nh = P.n_hidden, K1 = A.L.D.K1;

  // the weights: matrices input-major with row stride ldw, zero padded to
  // K16 rows; then b1 and the packed tail (bh, Wo, bo, B, Bd, TF)
  const float* w = P.weights;
  for (int i = threadIdx.x; i < pl.K16 * pl.ldw; i += kThreads) {
    const int k = i / pl.ldw, o = i % pl.ldw;
    S.W1()[i] = (k < K1 && o < H) ? w[k * H + o] : 0.0f;
  }
  const int off_wh = K1 * H + H;
  for (int i = threadIdx.x; i < nh * H * pl.ldw; i += kThreads) {
    const int l = i / (H * pl.ldw), k = (i / pl.ldw) % H, o = i % pl.ldw;
    S.Wh()[i] = o < H ? w[off_wh + (l * H + k) * H + o] : 0.0f;
  }
  for (int i = threadIdx.x; i < H; i += kThreads) S.b1()[i] = w[K1 * H + i];
  const int off_bh = off_wh + nh * H * H;
  for (int i = threadIdx.x; i < P.n_weights - off_bh; i += kThreads)
    S.bh()[i] = w[off_bh + i];
  for (int i = threadIdx.x; i < pl.M * pl.ldx; i += kThreads) S.X()[i] = 0.0f;
  float* g = A.d_weights + (size_t)blockIdx.x * P.n_weights;

  SegSrc src{P, S.sray(), 0.0f};

  // the ray this thread owns (warps < kGroups)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kBlockB + warp * kGroup + lane;
  const bool live = warp < kGroups && ray < P.n_rays;
  const int death = live ? A.death[ray] : 0;
  const float4 dout = live ? A.d_out[ray]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float da = dout.w;                      // cotangent of the carry's alpha
  float dpc = 0.0f;          // and of its last density (TF modes)
  const int m = __reduce_max_sync(0xffffffffu, death);
  if (lane == 0 && warp < kGroups) S.misc()[2 + warp] = m;
  __syncthreads();  // also publishes the weights
  int s_top = 0;
  for (int v = 0; v < kGroups; ++v) s_top = max(s_top, S.misc()[2 + v]);
  unsigned n_rep = 0, n_con = 0;

  for (int s = s_top - 1; s >= 0; --s) {
    src.s0 = (float)(s * P.seg);
#pragma unroll 1
    for (int grp = 0; grp < kGroups; ++grp) {
      uint32_t valid = 0u, first = 0u;
      float alpha0 = 0.0f, pin = 0.0f;
      if (warp == grp && live) {
        const Ray r = load_ray(P, ray);
        float* sr = S.sray() + lane * kRayF;
        sr[0] = r.sx; sr[1] = r.sy; sr[2] = r.sz;
        sr[3] = r.dx; sr[4] = r.dy; sr[5] = r.dz;
        sr[6] = r.a; sr[7] = r.tmx; sr[8] = r.kb;
        if (s < death) {
          alpha0 = A.carries[(size_t)s * P.n_rays + ray].w;
          if (TFM != kTfPiecewise)
            pin = A.dens_carries[(size_t)s * P.n_rays + ray];
          for (int j = 0; j < P.seg; ++j) {
            float t;
            if (sample_t(P, r, src.s0 + (float)j, t)) valid |= 1u << j;
            if (TFM != kTfPiecewise && P.lattice
                && r.kb + (src.s0 + (float)j) == r.a)
              first |= 1u << j;
          }
        }
      }
      if constexpr (TFM == kTfPiecewise)
        group_segment<H, kThreads>(A.L.D, S, A.L.G, g, src, grp, valid,
                                   alpha0, dout.x, dout.y, dout.z, da, n_rep,
                                   n_con);
      else
        group_segment_tf<H, kThreads, SegSrc, TFM>(
            A.L.D, S, A.L.G, g, src, grp, valid, first, pin, alpha0, dout.x,
            dout.y, dout.z, da, dpc, n_rep, n_con);
    }
  }
  if (threadIdx.x == 0) {
    atomicAdd(A.work, (unsigned long long)n_rep);
    atomicAdd(A.work + 1, (unsigned long long)n_con);
  }
}

template <int H, int TFM>
int launch(const Seg& P, const BwdArgs& A, cudaStream_t stream) {
  const size_t smem = (size_t)A.L.pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      segment_bwd_kernel<H, TFM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (P.n_rays + kBlockB - 1) / kBlockB;
  if (blocks > 0)
    segment_bwd_kernel<H, TFM><<<blocks, kThreads, smem, stream>>>(P, A);
  return (int)cudaGetLastError();
}

template <int H>
int launch_tf(const Seg& P, const BwdArgs& A, cudaStream_t stream) {
  switch (P.tfm) {
    case kTfTexture: return launch<H, kTfTexture>(P, A, stream);
    case kTfPreint1d: return launch<H, kTfPreint1d>(P, A, stream);
    case kTfPreint2d: return launch<H, kTfPreint2d>(P, A, stream);
    case kTfGaussian: return launch<H, kTfGaussian>(P, A, stream);
    default: return launch<H, kTfPiecewise>(P, A, stream);
  }
}

}  // namespace

// Rays per block of the backward: the wrapper allocates one partial
// gradient row per block.
extern "C" int segment_bwd_block() { return kBlockB; }

#ifdef SMLP_PROFILE
// The phase timers' sums since the last read (sample_mlp.cuh), reset.
extern "C" int smlp_prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, smlp_prof, sizeof(smlp_prof));
  unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(smlp_prof, zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif

// The shared-memory plan a launch takes for these widths (sample_mlp.cuh's
// choose_plan) with `tf_floats` TF floats (5 a piecewise knot) and, with
// `tf_state`, the TF modes' per-sample state: out = [bytes, tile rows,
// weight-row padding]. Returns 0, or -1 when no plan fits in 227 KB.
extern "C" int segment_bwd_smem(int hidden, int n_fourier, int chunks,
                                int n_hidden, int tf_floats, int tf_state,
                                long* out) {
  Plan pl;
  if (!choose_plan(hidden, 6 + 2 * n_fourier + kLat * chunks, n_hidden,
                   n_fourier, tf_floats, pl, tf_state))
    return -1;
  out[0] = pl.total;
  out[1] = pl.M;
  out[2] = pl.pad;
  return 0;
}

// The backward of the differentiable march (no early-out). Inputs as
// segment_fwd_launch's (`table` bf16 or float32 by `table_f32`; its
// gradient `d_table` float32 either way), plus phase 0's `carries`
// ((n_seg, R) float4) and `death` (R,), and the rgba cotangent `d_out` (R,
// 4). Writes into `d_weights` (blocks x n_weights partial rows, packed as
// the weights, zeroed by the caller) and ADDS into `d_table` (zeroed by the
// caller) and `work` ([samples replayed, samples contributing], int64).
// The TF as segment_fwd_launch takes it (modes other than piecewise:
// density heads), with phase 0's `dens_carries`; preint2d ADDS its table's
// gradient into `d_tf2d` ((tf_points, tf_points) float4, zeroed by the
// caller). seg <= 32. Returns cudaGetLastError() (0 on success).
extern "C" int segment_bwd_launch(
    const float* rays, const float* kbase, const void* table, int table_f32,
    const float* weights, int n_weights, const float* carries,
    const int* death, const float* d_out, float* d_weights, float* d_table,
    unsigned long long* work, int n_rays, int gx, int gy, int gz, int chunks,
    int n_lat, int n_fourier, int n_hidden, int hidden, int tf_points,
    int act, float act_param, int head, int has_dir, int lattice,
    int blend_alpha, int seg, int n_seg, float stepsize, float density_min,
    float inv_range, float bmin_x, float bmin_y, float bmin_z,
    float bsize_x, float bsize_y, float bsize_z, int tfm, int tf_pre,
    int tf_floats, const float* tf2d, float* d_tf2d,
    const float* dens_carries, void* stream) {
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  Seg P = make_seg(rays, kbase, table, weights, n_weights, n_rays, gx, gy,
                   gz, chunks, n_fourier, n_hidden, tf_points, act,
                   act_param, head, has_dir, lattice, blend_alpha, 0, 0.0f,
                   seg, n_seg, stepsize, density_min, inv_range, 2.0f, bmin,
                   bsize);
  P.tfm = tfm;
  P.tf_pre = tf_pre;
  P.tf_floats = tf_floats;
  P.tf2d = reinterpret_cast<const float4*>(tf2d);
  if (!seg_valid(P) || seg > kSegMax || n_lat < 0 || n_lat > kLat * chunks
      || (tfm != kTfPiecewise
          && (head >= kRgbo || dens_carries == nullptr))
      || (tfm == kTfPreint2d && d_tf2d == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs A;
  A.carries = reinterpret_cast<const float4*>(carries);
  A.dens_carries = dens_carries;
  A.death = death;
  A.d_out = reinterpret_cast<const float4*>(d_out);
  A.d_weights = d_weights;
  A.work = work;
  const int F = n_fourier, nh = n_hidden, H = hidden;
  const int K1 = 6 + 2 * F + kLat * chunks;
  if (!choose_plan(H, K1, nh, F, tf_floats, A.L.pl, tfm != kTfPiecewise))
    return (int)cudaErrorInvalidValue;
  Dims& D = A.L.D;
  D.F = F; D.nh = nh; D.chunks = chunks; D.n_lat = n_lat;
  D.tp = tf_points; D.K1 = K1; D.n_out = head >= kRgbo ? 4 : 1;
  D.tpre = tf_pre;
  D.tf2d = reinterpret_cast<const float4*>(tf2d);
  D.d_tf2d = reinterpret_cast<float4*>(d_tf2d);
  D.pos = 0; D.dir = 3; D.cos = 6; D.sin = 6 + F; D.lat = 6 + 2 * F;
  D.has_dir = has_dir; D.act = act; D.head = head;
  D.blend_alpha = blend_alpha;
  D.p = act_param; D.inv_p = 1.0f / act_param;
  D.inv_2p = 1.0f / (2.0f * act_param); D.density_min = density_min;
  D.inv_range = inv_range; D.h = stepsize;
  D.gx = gx; D.gy = gy; D.gz = gz;
  D.table = table;
  D.table_bf16 = !table_f32;
  D.d_table = d_table;
  // the packed layout (segment_common.cuh's Wts)
  GOut& G = A.L.G;
  G.W1 = 0; G.W1_k = H; G.W1_o = 1;
  G.b1 = K1 * H;
  G.Wh = G.b1 + H; G.Wh_l = H * H; G.Wh_i = H; G.Wh_o = 1;
  G.bh = G.Wh + nh * H * H;
  G.Wo = G.bh + nh * H; G.Wo_r = H;
  G.bo = G.Wo + 4 * H;
  G.B = G.bo + 4;
  G.Bd = has_dir ? G.B + 3 * F : -1;
  G.TF = G.B + 6 * F;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 32: return launch_tf<32>(P, A, st);
    case 48: return launch_tf<48>(P, A, st);
    case 64: return launch_tf<64>(P, A, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
