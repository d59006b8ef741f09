// The per-segment fused march, backward (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_dvr_bwd.py:_segment_bwd_kernel
// (make_segment_op's backward; its math in bwd_segment_core), which the
// differentiable scan of fused_trace_dvr(differentiable=True) runs once per
// (ray tile, segment) program, segments in reverse. It computes the same
// gradients, not the TPU's layout: from the cotangent of the march's rgba,
// the gradients of every layer's weight and bias, the Fourier matrix (its
// position and direction blocks), the TF control points (colors, opacity,
// interior knot positions; packed as the forward's weights, one partial
// row per block) and the float32 latent table. The rays get none (the
// TPU's custom VJP gives them zeros).
//
// One launch per step, one thread per ray, 64 rays per block. Each ray
// walks its segments in reverse from its last (segment_fwd.cu's phase 0
// stored the number it ran and the carry entering each); the
// differentiable march has no early-out, so every segment before that
// count ran and none after it has a valid sample. Per segment and thread:
//  A. replay the segment's samples from the stored carry (the forward's
//     code, segment_common.cuh), keeping per sample the color, the
//     absorption, the alpha entering it and whether it contributes
//     (counts and absorbs: a sample that absorbs nothing passes no
//     gradient);
//  B. the reverse compositing recurrence (fused_dvr_bwd.py:606-628, its
//     sequential form, no alpha gating), which leaves per sample the
//     cotangents of its rgb and opacity and carries the alpha cotangent to
//     the segment's start;
//  C. for each contributing sample, in step with the block: recompute the
//     network keeping its activations, chain back through the TF adjoint
//     or the rgbo head's own, the clip gates (strictly inside), the
//     transposed layers and the activations' derivatives to the first
//     layer's input: d_cos/d_sin -> d_B (and d_Bd with direction input),
//     d_latent -> the trilerp adjoint (16-byte atomics into the table
//     gradient).
// Weight gradients: the block stages one layer's (input, cotangent)
// vectors of its 64 rays in shared memory and reduces the 64 outer
// products into gradient entries that each thread owns (entry e of a block
// belongs to thread e % 64) in the block's own partial row in device
// memory; the first layer goes in chunks of H input rows. No atomics, so
// the sum is deterministic; the wrapper sums the rows. TF gradients
// accumulate per thread and are reduced once per block the same way.
//
// Bound: operations (the replay as much as the forward, the adjoint about
// three times its MLP per contributing sample: recompute, transposed
// layers, outer products) against the stored carries read and the latent
// gradient written. This first version runs on the float32 CUDA cores, one
// sample per thread at a time, and keeps each sample's activations in
// local memory; tensor-core layers and a shared-memory window for the
// latent gradient are later work.

#include "segment_common.cuh"

namespace {

using namespace march;
using namespace segment;

constexpr int kBlockB = 64;              // rays per block = threads
constexpr int kStrideB = kBlockB + 4;    // staged row stride: 16-byte
                                         // loads without bank conflicts
constexpr int kMaxSeg = 32;              // samples per segment

struct BwdArgs {
  const float4* carries;       // (n_seg, R) carry entering each segment
  const int* death;            // (R,) segments each ray ran
  const float4* d_out;         // (R,) rgba cotangent
  float* d_weights;            // (blocks, n_weights) partial rows, zeroed
  float* d_table;              // (gz, gy, gx, 16 * chunks), zeroed
  unsigned long long* work;    // [samples replayed, samples contributing]
  int n_lat;                   // real latent channels
  int stage_rows;
};

// Stage n values of this thread's column at rows [row0, row0 + n); zeros
// where `on` is false.
__device__ __forceinline__ void put(float* stage, int row0, const float* v,
                                    int n, bool on) {
  float* p = stage + row0 * kStrideB + threadIdx.x;
  if (on) {
    for (int i = 0; i < n; ++i) p[i * kStrideB] = v[i];
  } else {
    for (int i = 0; i < n; ++i) p[i * kStrideB] = 0.0f;
  }
}

template <int N>
__device__ __forceinline__ void put_n(float* stage, int row0, const float* v,
                                      bool on) {
  float* p = stage + row0 * kStrideB + threadIdx.x;
#pragma unroll
  for (int i = 0; i < N; ++i) p[i * kStrideB] = on ? v[i] : 0.0f;
}

// Sums over the block's rays of staged rows: a . b and a.
__device__ __forceinline__ float rows_dot(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < kBlockB / 4; ++q) {
    const float4 x = a4[q], y = b4[q];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float row_sum(const float* a) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < kBlockB / 4; ++q) {
    const float4 x = a4[q];
    acc += (x.x + x.y) + (x.z + x.w);
  }
  return acc;
}

// g[a * n_b + b] += sum over the block's rays of A[a] * B[b], A the staged
// rows [a0, a0 + n_a), B the rows [b0, b0 + n_b); g[e] belongs to thread
// e % kBlockB. Caller brackets with barriers.
__device__ __forceinline__ void reduce_outer(const float* stage, int a0,
                                             int n_a, int b0, int n_b,
                                             float* g) {
  const int n = n_a * n_b;
  for (int e = threadIdx.x; e < n; e += kBlockB)
    g[e] += rows_dot(stage + (a0 + e / n_b) * kStrideB,
                     stage + (b0 + e % n_b) * kStrideB);
}

// g[e] += sum over the block's rays of staged row row0 + e, e < n.
__device__ __forceinline__ void reduce_rows(const float* stage, int row0,
                                            int n, float* g) {
  for (int e = threadIdx.x; e < n; e += kBlockB)
    g[e] += row_sum(stage + (row0 + e) * kStrideB);
}

// Shared memory: the packed weights, the staging rows (stage_rows x
// kStrideB), the activation scratch (H rows of kBlockB).
template <int H>
__global__ void __launch_bounds__(kBlockB) segment_bwd_kernel(const Seg P,
                                                              const BwdArgs A) {
  extern __shared__ float4 smem4[];
  __shared__ int red[kBlockB / 32];
  float* sw = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < P.n_weights; i += kBlockB) sw[i] = P.weights[i];
  const Wts N = carve(sw, P, H);
  float* stage = sw + scratch_offset(P.n_weights);
  float* hs = stage + (size_t)A.stage_rows * kStrideB + threadIdx.x;

  // this block's gradient row, packed as the weights
  float* g = A.d_weights + (size_t)blockIdx.x * P.n_weights;
  float* gW1 = g + (N.W1 - sw);
  float* gb1 = g + (N.b1 - sw);
  float* gWh = g + (N.Wh - sw);
  float* gbh = g + (N.bh - sw);
  float* gWo = g + (N.Wo - sw);
  float* gbo = g + (N.bo - sw);
  float* gB = g + (N.B - sw);
  float* gBd = g + (N.Bd - sw);
  float* gTF = g + (N.TF - sw);

  const int ray = blockIdx.x * kBlockB + threadIdx.x;
  const bool live = ray < P.n_rays;
  const int death = live ? A.death[ray] : 0;
  const int m = __reduce_max_sync(0xffffffffu, death);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();  // also publishes the weights
  int s_top = 0;
  for (int w = 0; w < kBlockB / 32; ++w) s_top = max(s_top, red[w]);

  Ray r = {};
  if (live) r = load_ray(P, ray);
  const float4 dout = live ? A.d_out[ray] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float dr = dout.x, dg = dout.y, db = dout.z;
  float da = dout.w;                      // cotangent of the carry's alpha
  const int F = P.n_fourier, nh = P.n_hidden;
  const int K1 = 6 + 2 * F + kLat * P.chunks;
  const int n_out = P.head >= kRgbo ? 4 : 1;
  const float h = P.stepsize;
  float tfg[kMaxTf * 5];
  for (int i = 0; i < kMaxTf * 5; ++i) tfg[i] = 0.0f;
  unsigned n_rep = 0, n_con = 0;
  Keep<H> keep;

  for (int s = s_top - 1; s >= 0; --s) {
    const bool run = s < death;
    const float s0 = (float)(s * P.seg);

    // A. forward replay from the stored carry
    float s_r[kMaxSeg], s_g[kMaxSeg], s_b[kMaxSeg], s_ab[kMaxSeg],
        s_ain[kMaxSeg];
    uint32_t contrib = 0u;
    if (run) {
      float alpha = A.carries[(size_t)s * P.n_rays + ray].w;
      for (int j = 0; j < P.seg; ++j) {
        s_ain[j] = alpha;
        float t;
        if (!sample_t(P, r, s0 + (float)j, t)) continue;
        ++n_rep;
        float x0, x1, x2;
        sample_pos(P, r, t, x0, x1, x2);
        float v[4];
        network<H, F32Table, kBlockB, false>(P, N, hs, x0, x1, x2, r.dx, r.dy,
                                             r.dz, v, nullptr);
        float cr, cg, cb, absn;
        TfSample tf;
        if (!sample_color(P, N, v, cr, cg, cb, absn, tf)) continue;
        if (absn > 0.0f) contrib |= 1u << j;
        s_r[j] = cr;
        s_g[j] = cg;
        s_b[j] = cb;
        s_ab[j] = absn;
        alpha = alpha + (1.0f - alpha) * sample_alpha(P, absn);
      }
    }

    // B. reverse compositing: s_r/g/b become the cotangents of the
    // samples' rgb, s_ab that of their opacity (absorption = opacity * h)
    for (int j = P.seg - 1; j >= 0; --j) {
      if (!((contrib >> j) & 1u)) continue;
      const float absn = s_ab[j];
      const float a = sample_alpha(P, absn);
      const float trans = 1.0f - s_ain[j];
      const float dw = dr * s_r[j] + dg * s_g[j] + db * s_b[j] + da;
      const float w = trans * a;
      const float d_ca = trans * dw;
      da = da - a * dw;
      const float d_absn = P.blend_alpha ? (absn < 1.0f ? d_ca : 0.0f)
                                         : d_ca * expf(-absn);
      s_r[j] = w * dr;
      s_g[j] = w * dg;
      s_b[j] = w * db;
      s_ab[j] = d_absn * h;
    }

    // C. the network's adjoint, sample by sample in step with the block
    for (int j = 0; j < P.seg; ++j) {
      const bool c = run && ((contrib >> j) & 1u);
      if (!__syncthreads_or(c)) continue;
      float d_y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (c) {
        ++n_con;
        float t, x0, x1, x2;
        sample_t(P, r, s0 + (float)j, t);
        sample_pos(P, r, t, x0, x1, x2);
        float v[4];
        network<H, F32Table, kBlockB, true>(P, N, hs, x0, x1, x2, r.dx, r.dy,
                                            r.dz, v, &keep);
        float d_v[4] = {s_r[j], s_g[j], s_b[j], s_ab[j]};
        if (P.head < kRgbo) {
          // the TF, then the density's normalization and clip
          const float density2 = (v[0] - P.density_min) * P.inv_range;
          const float d = fminf(fmaxf(density2, 0.0f), 1.0f);
          TfSample tf;
          tf_lookup(N.TF, P.tf_points, d, tf);
          const float d_d = tf_adjoint(N.TF, tf, d, d_v, tfg);
          d_v[0] = (density2 > 0.0f && density2 < 1.0f) ? d_d * P.inv_range
                                                          : 0.0f;
        }
        head_adjoint(P.head, keep.y, v, d_v, d_y);
      }

      // output rows: A = d_y (rows 0-3), B = the last hidden output
      put_n<4>(stage, 0, d_y, c);
      put(stage, 4, keep.hs + nh * H, H, c);
      __syncthreads();
      reduce_outer(stage, 0, n_out, 4, H, gWo);
      reduce_rows(stage, 0, n_out, gbo);
      float dh[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc = fmaf(N.Wo[q * H + i], d_y[q], acc);
        dh[i] = acc;
      }
      __syncthreads();

      // hidden layers: A = the layer's input, B = its pre-activation's
      // cotangent
      for (int l = nh; l >= 0; --l) {
        const float* dact = keep.dact + l * H;
#pragma unroll
        for (int o = 0; o < H; ++o) dh[o] = c ? dh[o] * dact[o] : 0.0f;
        if (l == 0) break;
        put(stage, 0, keep.hs + (l - 1) * H, H, c);
        put_n<H>(stage, H, dh, true);
        __syncthreads();
        reduce_outer(stage, 0, H, H, H, gWh + (l - 1) * H * H);
        reduce_rows(stage, H, H, gbh + (l - 1) * H);
        const float* W = N.Wh + (l - 1) * H * H;
        float dp[H];
#pragma unroll
        for (int o = 0; o < H; ++o) dp[o] = dh[o];
#pragma unroll
        for (int i = 0; i < H; ++i) dh[i] = dot_row<H>(W + i * H, dp);
        __syncthreads();
      }

      // first layer (dh is its pre-activation's cotangent): B = dh in rows
      // [0, H), A = chunks of its input in rows [H, 2H)
      put_n<H>(stage, 0, dh, true);
      for (int k0 = 0; k0 < K1; k0 += H) {
        const int kc = min(H, K1 - k0);
        put(stage, H, keep.in1 + k0, kc, c);
        __syncthreads();
        reduce_outer(stage, H, kc, 0, H, gW1 + k0 * H);
        if (k0 == 0) reduce_rows(stage, 0, H, gb1);
        __syncthreads();
      }

      // Fourier features: d_f = d phase, A = d_f, B = position, direction
      if (F > 0) {
        float d_f[kMaxFourier];
#pragma unroll 1
        for (int i = 0; i < F; ++i) {
          const float d_cos = dot_row<H>(N.W1 + (6 + i) * H, dh);
          const float d_sin = dot_row<H>(N.W1 + (6 + F + i) * H, dh);
          d_f[i] = keep.in1[6 + i] * d_sin - keep.in1[6 + F + i] * d_cos;
        }
        put(stage, 0, d_f, F, c);
        put(stage, F, keep.in1, 6, c);
        __syncthreads();
        reduce_outer(stage, 0, F, F, 3, gB);
        if (P.has_dir) reduce_outer(stage, 0, F, F + 3, 3, gBd);
        __syncthreads();
      }

      // latent features: the trilerp adjoint
      if (c && P.chunks > 0) {
        Corners cn;
        grid_corners(P.gx, P.gy, P.gz, keep.in1[0], keep.in1[1], keep.in1[2],
                     cn);
#pragma unroll 1
        for (int q = 0; q < P.chunks; ++q) {
          float d_lat[kLat];
#pragma unroll
          for (int ch = 0; ch < kLat; ++ch)
            d_lat[ch] = dot_row<H>(N.W1 + (6 + 2 * F + kLat * q + ch) * H, dh);
          trilerp_adjoint(A.d_table, cn, d_lat, min(kLat, A.n_lat - kLat * q),
                          P.chunks, q);
        }
      }
    }
  }

  // TF gradients: one reduction over the block's rays
  if (P.head < kRgbo) {
    const int n_tf = P.tf_points * 5;
    __syncthreads();
    put(stage, 0, tfg, n_tf, live);
    __syncthreads();
    reduce_rows(stage, 0, n_tf, gTF);
  }
  const unsigned nr = __reduce_add_sync(0xffffffffu, n_rep);
  const unsigned nc = __reduce_add_sync(0xffffffffu, n_con);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(A.work, (unsigned long long)nr);
    atomicAdd(A.work + 1, (unsigned long long)nc);
  }
}

template <int H>
int launch(const Seg& P, const BwdArgs& A, cudaStream_t stream) {
  const size_t smem = (scratch_offset(P.n_weights)
                       + (size_t)A.stage_rows * kStrideB
                       + (size_t)H * kBlockB) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (P.n_rays + kBlockB - 1) / kBlockB;
  if (blocks > 0)
    segment_bwd_kernel<H><<<blocks, kBlockB, smem, stream>>>(P, A);
  return (int)cudaGetLastError();
}

}  // namespace

// Rays per block of the backward: the wrapper allocates one partial
// gradient row per block.
extern "C" int segment_bwd_block() { return kBlockB; }

// The backward of the differentiable march (no early-out). Inputs as
// segment_fwd_launch's, with a float32 table, plus phase 0's `carries`
// ((n_seg, R) float4) and `death` (R,), and the rgba cotangent `d_out` (R,
// 4). Writes into `d_weights` (blocks x n_weights partial rows, packed as
// the weights, zeroed by the caller) and ADDS into `d_table` (zeroed by the
// caller) and `work` ([samples replayed, samples contributing], int64).
// seg <= 32. Returns cudaGetLastError() (0 on success).
extern "C" int segment_bwd_launch(
    const float* rays, const float* kbase, const float* table,
    const float* weights, int n_weights, const float* carries,
    const int* death, const float* d_out, float* d_weights, float* d_table,
    unsigned long long* work, int n_rays, int gx, int gy, int gz, int chunks,
    int n_lat, int n_fourier, int n_hidden, int hidden, int tf_points,
    int act, float act_param, int head, int has_dir, int lattice,
    int blend_alpha, int seg, int n_seg, float stepsize, float density_min,
    float inv_range, float bmin_x, float bmin_y, float bmin_z,
    float bsize_x, float bsize_y, float bsize_z, void* stream) {
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  const Seg P = make_seg(rays, kbase, table, weights, n_weights, n_rays, gx,
                         gy, gz, chunks, n_fourier, n_hidden, tf_points, act,
                         act_param, head, has_dir, lattice, blend_alpha, 0,
                         0.0f, seg, n_seg, stepsize, density_min, inv_range,
                         2.0f, bmin, bsize);
  if (!seg_valid(P) || seg > kMaxSeg || n_lat < 0 || n_lat > kLat * chunks)
    return (int)cudaErrorInvalidValue;
  BwdArgs A;
  A.carries = reinterpret_cast<const float4*>(carries);
  A.death = death;
  A.d_out = reinterpret_cast<const float4*>(d_out);
  A.d_weights = d_weights;
  A.d_table = d_table;
  A.work = work;
  A.n_lat = n_lat;
  A.stage_rows = max(max(2 * hidden, n_fourier + 6), 5 * tf_points);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 32: return launch<32>(P, A, st);
    case 48: return launch<48>(P, A, st);
    case 64: return launch<64>(P, A, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
