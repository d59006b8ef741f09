// Fused SRN volume-rendering march, backward (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_mega.py:_mega_bwd_kernel
// (per-segment math fvsrn_tpu/ops/fused_dvr_bwd.py:bwd_segment_core). It
// computes the same gradients, not the TPU's layout: from the cotangent of
// the march's rgba, the gradients of the Fourier matrix, every layer's
// weight and bias, the TF control points (packed as the forward's weights,
// one partial row per tile) and the float32 latent table.
//
// Layout: one block per 256-ray tile, one thread per ray, as the forward.
// Segments run in reverse from the tile's last visited one (the forward
// stored their count and incoming carries); a segment is replayed only
// where the forward ran it: some ray of the tile has a live point in it
// and the STORED incoming carry passes the vote (min alpha < early_alpha),
// and the forward's occupancy mask (if any) keeps it.
// Skipped segments pass the carry cotangent through unchanged.
//
// Per segment and thread:
//  A. replay the segment's samples from the stored carry, keeping per
//     sample the TF rgb, the absorption, the alpha entering it and whether
//     it contributes (require & absorption > 0: a sample that absorbs
//     nothing passes no gradient);
//  B. the reverse compositing recurrence (fused_dvr_bwd.py:604-628, its
//     sequential form), which leaves per sample the cotangents of the TF's
//     rgb and opacity and updates the carry's alpha cotangent;
//  C. for each contributing sample (in step with the block), recompute the
//     MLP keeping its activations, then chain back through the TF adjoint
//     (knot positions only strictly inside the interval), the clip gates
//     (0 < density < 1, 0 < y < 1), the transposed hidden layers, SnakeAlt's
//     derivative and the first layer, to d_cos/d_sin -> d_B and d_latent ->
//     the trilerp adjoint (atomics into the table gradient).
// Weight gradients: the block stages one layer's (cotangent, input) vectors
// of its 256 rays in shared memory and reduces the 256 outer products into
// gradient entries that each thread owns (entry e belongs to thread
// e % 256) for the whole tile, in shared memory; no atomics, so the sum
// over a tile is deterministic. Each block writes one partial row; the
// wrapper sums the rows over tiles. TF gradients accumulate per thread and
// are reduced once per tile the same way.
//
// Bound: operations (replay ~2x the forward's MLP per contributing sample,
// the adjoint ~1x, the weight-gradient reduction ~1x) against bytes of the
// stored carries read and the latent gradient. This first version runs on
// the float32 CUDA cores and spills its per-sample arrays to local memory;
// tensor-core layers and a shared-memory window for the latent gradient
// are later work.

#include "mega_common.cuh"

namespace {

using namespace mega;

constexpr int kSeg = 32;             // lattice points per segment
constexpr int kStride = kTile + 1;   // staged row stride, conflict-free

struct BwdArgs {
  const float4* carries;    // (tiles, n_seg_max, 256)
  const int* seg_count;     // (tiles,)
  const float4* d_out;      // (R,) rgba cotangent
  float* d_weights;         // (tiles, n_weights) partial rows
  float* d_table;           // (gz, gy, gx, 16) float32, accumulated
  int* tile_work;           // (tiles, 2): samples replayed, contributing
  int n_lat;                // real latent channels
};

// Stage rows [0, n) of this thread's column.
__device__ __forceinline__ void put(float* stage, int row0, const float* v,
                                    int n) {
  for (int i = 0; i < n; ++i) stage[(row0 + i) * kStride + threadIdx.x] = v[i];
}

// Reduce the staged outer products into owned entries: rows [0, n_out)
// hold the cotangent a, rows [n_out, n_out + n_in) the input b. Entry
// (o, i) of gW (row-major n_out x n_in) gains sum_r a[o][r] * b[i][r];
// with gb, entry o of gb gains sum_r a[o][r]. Caller brackets with
// barriers.
__device__ __forceinline__ void reduce_outer(const float* stage, int n_out,
                                             int n_in, float* gW, float* gb) {
  const int nw = n_out * n_in;
  const int n = nw + (gb != nullptr ? n_out : 0);
  for (int e = threadIdx.x; e < n; e += kTile) {
    float acc = 0.0f;
    if (e < nw) {
      const float* pa = stage + (e / n_in) * kStride;
      const float* pb = stage + (n_out + e % n_in) * kStride;
      for (int r = 0; r < kTile; ++r) acc = fmaf(pa[r], pb[r], acc);
      gW[e] += acc;
    } else {
      const float* pa = stage + (e - nw) * kStride;
      for (int r = 0; r < kTile; ++r) acc += pa[r];
      gb[e - nw] += acc;
    }
  }
}

__global__ void __launch_bounds__(kTile) mega_bwd_kernel(const March P,
                                                         const BwdArgs A) {
  extern __shared__ float smem[];
  __shared__ float red_f[kTile / 32];
  __shared__ int red_i[2][kTile / 32];
  float* sw = smem;                       // weights
  float* sg = sw + P.n_weights;           // owned gradient entries
  float* stage = sg + P.n_weights;        // (stage_rows, kStride)

  for (int i = threadIdx.x; i < P.n_weights; i += kTile) {
    sw[i] = P.weights[i];
    sg[i] = 0.0f;
  }
  const Net N = carve(sw, P);
  const Offsets off = weight_offsets(P.n_fourier, P.n_hidden);
  float* gB = sg + off.B;
  float* gW1 = sg + off.W1;
  float* gb1 = sg + off.b1;
  float* gWh = sg + off.Wh;
  float* gbh = sg + off.bh;
  float* gWo = sg + off.Wo;
  float* gbo = sg + off.bo;
  float* gTF = sg + off.TF;
  const Ray R = load_ray(P, red_f);  // its barrier publishes sw and sg

  const float h = P.stepsize;
  const float segf = (float)kSeg;
  const int ray = blockIdx.x * kTile + threadIdx.x;
  const float4 dout = A.d_out[ray];
  const float dr = dout.x, dg = dout.y, db = dout.z;
  float da = dout.w;                      // cotangent of the carry's alpha
  float tfg[kMaxTf * 5];
  for (int i = 0; i < N.tf_points * 5; ++i) tfg[i] = 0.0f;
  const int F = N.F, K1 = N.K1, nh = N.n_hidden;
  int n_replayed = 0, n_contrib = 0;

  for (int s = A.seg_count[blockIdx.x] - 1; s >= 0; --s) {
    const float ka = R.k0t + (float)s * segf;
    const float first = fmaxf(R.k0r, ka) * h;
    const bool alive = first <= fminf(R.tmx, (ka + (segf - 1.0f)) * h);
    const bool active = __syncthreads_or(alive) && segment_on(P, s);
    const float4 cin = A.carries[((size_t)blockIdx.x * P.n_seg_max + s)
                                 * kTile + threadIdx.x];
    const bool vote = __syncthreads_or(cin.w < P.early_alpha);
    if (!(active && vote)) continue;

    // A. forward replay from the stored carry
    float s_r[kSeg], s_g[kSeg], s_b[kSeg], s_ab[kSeg], s_ain[kSeg];
    uint32_t contrib = 0u;
    float alpha = cin.w;
    for (int j = 0; j < kSeg; ++j) {
      s_r[j] = s_g[j] = s_b[j] = s_ab[j] = 0.0f;
      s_ain[j] = alpha;
      const float k = ka + (float)j;
      const float t = k * h;
      if (!(t <= R.tmx && k >= R.k0r)) continue;
      ++n_replayed;
      float x0, x1, x2;
      sample_pos(P, R, t, x0, x1, x2);
      Shaded sh;
      if (!shade<F32Table, false>(P, N, x0, x1, x2, sh, nullptr)) continue;
      const float absn = sh.tf.op * h;
      const float a = 1.0f - expf(-absn);
      if (absn > 0.0f) contrib |= 1u << j;
      s_r[j] = sh.tf.r;
      s_g[j] = sh.tf.g;
      s_b[j] = sh.tf.b;
      s_ab[j] = absn;
      alpha = alpha + (1.0f - alpha) * a;
    }

    n_contrib += __popc(contrib);

    // B. reverse compositing: s_r/g/b become the TF rgb cotangents, s_ab
    // the TF opacity cotangent
    for (int j = kSeg - 1; j >= 0; --j) {
      if (!((contrib >> j) & 1u)) {
        s_r[j] = s_g[j] = s_b[j] = s_ab[j] = 0.0f;
        continue;
      }
      const float e = expf(-s_ab[j]);
      const float a = 1.0f - e;
      const float trans = 1.0f - s_ain[j];
      const float dw = dr * s_r[j] + dg * s_g[j] + db * s_b[j] + da;
      const float w = trans * a;
      const float d_ca = trans * dw;
      da = da - a * dw;
      s_r[j] = w * dr;
      s_g[j] = w * dg;
      s_b[j] = w * db;
      s_ab[j] = d_ca * e * h;
    }

    // C. MLP adjoint and weight gradients, sample by sample in step
    for (int j = 0; j < kSeg; ++j) {
      const bool c = (contrib >> j) & 1u;
      if (!__syncthreads_or(c)) continue;
      Keep keep;
      Shaded sh;
      float d_y = 0.0f;
      if (c) {
        const float t = (ka + (float)j) * h;
        float x0, x1, x2;
        sample_pos(P, R, t, x0, x1, x2);
        shade<F32Table, true>(P, N, x0, x1, x2, sh, &keep);
        // TF adjoint
        const int iv = sh.tf.iv;
        const float* c0 = N.TF + iv * 5;
        const float* c1 = c0 + 5;
        const float dc[4] = {s_r[j], s_g[j], s_b[j], s_ab[j]};
        const float frac = sh.tf.frac;
        float d_frac = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tfg[iv * 5 + q] += dc[q] * (1.0f - frac);
          tfg[(iv + 1) * 5 + q] += dc[q] * frac;
          d_frac += dc[q] * (c1[q] - c0[q]);
        }
        const float density2 = (sh.value - P.density_min) * P.inv_range;
        const float d = fminf(fmaxf(density2, 0.0f), 1.0f);
        float d_d = 0.0f;
        if (d > c0[4] && d < c1[4]) {            // strictly interior
          const float inv_dp = 1.0f / (c1[4] - c0[4]);
          d_d = d_frac * inv_dp;
          tfg[iv * 5 + 4] += d_frac * (frac - 1.0f) * inv_dp;
          tfg[(iv + 1) * 5 + 4] += -d_frac * frac * inv_dp;
        }
        const float d_density2 = (density2 > 0.0f && density2 < 1.0f)
                                     ? d_d : 0.0f;
        const float d_value = d_density2 * P.inv_range;
        d_y = (sh.y > 0.0f && sh.y < 1.0f) ? d_value : 0.0f;
      } else {
        for (int i = 0; i < K1; ++i) keep.in1[i] = 0.0f;
        for (int i = 0; i < (nh + 1) * kHid; ++i) {
          keep.hs[i] = 0.0f;
          keep.dact[i] = 0.0f;
        }
      }

      // output row: a = d_y, b = last hidden output
      __syncthreads();
      put(stage, 0, &d_y, 1);
      put(stage, 1, keep.hs + nh * kHid, kHid);
      __syncthreads();
      reduce_outer(stage, 1, kHid, gWo, gbo);

      float dh[kHid], dpre[kHid];
#pragma unroll
      for (int o = 0; o < kHid; ++o) dh[o] = N.Wo[o] * d_y;
      for (int l = nh; l >= 1; --l) {
        const float* W = N.Wh + (l - 1) * kHid * kHid;
#pragma unroll
        for (int o = 0; o < kHid; ++o) dpre[o] = dh[o] * keep.dact[l * kHid + o];
        __syncthreads();
        put(stage, 0, dpre, kHid);
        put(stage, kHid, keep.hs + (l - 1) * kHid, kHid);
        __syncthreads();
        reduce_outer(stage, kHid, kHid, gWh + (l - 1) * kHid * kHid,
                     gbh + (l - 1) * kHid);
#pragma unroll
        for (int i = 0; i < kHid; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int o = 0; o < kHid; ++o) acc = fmaf(W[o * kHid + i], dpre[o], acc);
          dh[i] = acc;
        }
      }
#pragma unroll
      for (int o = 0; o < kHid; ++o) dpre[o] = dh[o] * keep.dact[o];
      __syncthreads();
      put(stage, 0, dpre, kHid);
      put(stage, kHid, keep.in1, K1);
      __syncthreads();
      reduce_outer(stage, kHid, K1, gW1, gb1);

      // first layer's input cotangent: Fourier features and latent
      float d_f[kMaxFourier];
      for (int i = 0; i < F; ++i) {
        float d_cos = 0.0f, d_sin = 0.0f;
#pragma unroll
        for (int o = 0; o < kHid; ++o) {
          d_cos = fmaf(N.W1[o * K1 + 3 + i], dpre[o], d_cos);
          d_sin = fmaf(N.W1[o * K1 + 3 + F + i], dpre[o], d_sin);
        }
        d_f[i] = -keep.in1[3 + F + i] * d_cos + keep.in1[3 + i] * d_sin;
      }
      if (F > 0) {
        __syncthreads();
        put(stage, 0, d_f, F);
        put(stage, F, keep.in1, 3);
        __syncthreads();
        reduce_outer(stage, F, 3, gB, nullptr);
      }
      if (c) {
        float d_lat[kLat];
#pragma unroll
        for (int ch = 0; ch < kLat; ++ch) {
          float acc = 0.0f;
#pragma unroll
          for (int o = 0; o < kHid; ++o)
            acc = fmaf(N.W1[o * K1 + 3 + 2 * F + ch], dpre[o], acc);
          d_lat[ch] = acc;
        }
        trilerp_adjoint(A.d_table, sh.c, d_lat, A.n_lat);
      }
    }
  }

  // TF gradients: one reduction over the tile's rays
  const int n_tf = N.tf_points * 5;
  __syncthreads();
  put(stage, 0, tfg, n_tf);
  __syncthreads();
  for (int e = threadIdx.x; e < n_tf; e += kTile) {
    float acc = 0.0f;
    for (int r = 0; r < kTile; ++r) acc += stage[e * kStride + r];
    gTF[e] += acc;
  }
  const int nr = __reduce_add_sync(0xffffffffu, n_replayed);
  const int nc = __reduce_add_sync(0xffffffffu, n_contrib);
  if ((threadIdx.x & 31) == 0) {
    red_i[0][threadIdx.x >> 5] = nr;
    red_i[1][threadIdx.x >> 5] = nc;
  }
  __syncthreads();
  float* row = A.d_weights + (size_t)blockIdx.x * P.n_weights;
  for (int i = threadIdx.x; i < P.n_weights; i += kTile) row[i] = sg[i];
  if (threadIdx.x < 2) {
    int total = 0;
    for (int w = 0; w < kTile / 32; ++w) total += red_i[threadIdx.x][w];
    A.tile_work[2 * blockIdx.x + threadIdx.x] = total;
  }
}

}  // namespace

// Shared memory rows the staging buffer needs for these widths.
static int stage_rows(int n_fourier, int tf_points) {
  const int k1 = 3 + 2 * n_fourier + kLat;
  int rows = kHid + k1;
  if (2 * kHid > rows) rows = 2 * kHid;
  if (n_fourier + 3 > rows) rows = n_fourier + 3;
  if (5 * tf_points > rows) rows = 5 * tf_points;
  return rows;
}

// Inputs as mega_fwd_launch's, with a float32 table, plus the forward's
// `carries` (tiles x n_seg_max x 256 float4) and `seg_count`, and the
// rgba cotangent `d_out` (R, 4). Writes `d_weights` (tiles x n_weights
// partial rows, packed as the weights) and `tile_work` (tiles x 2: samples
// replayed, samples contributing), and ADDS into `d_table` (zeroed by the
// caller). `seg_active` is the forward's mask (or null). seg must be 32.
// Returns cudaGetLastError() (0 on success).
extern "C" int mega_bwd_launch(
    const float* rays, const float* table, const float* weights,
    int n_weights, const float* carries, const int* seg_count,
    const float* d_out, float* d_weights, float* d_table, int* tile_work,
    int n_rays, int gx, int gy, int gz, int n_lat, int n_fourier,
    int n_hidden, int tf_points, float act_param, int seg, int n_seg_max,
    float stepsize,
    float density_min, float inv_range, float early_alpha, float bmin_x,
    float bmin_y, float bmin_z, float bsize_x, float bsize_y, float bsize_z,
    const uint8_t* seg_active, int mask_cols, void* stream) {
  if (seg != kSeg || n_fourier > kMaxFourier || n_hidden > kMaxHidden
      || tf_points > kMaxTf || tf_points < 2 || n_lat > kLat)
    return (int)cudaErrorInvalidValue;
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  March P;
  fill_march(P, rays, table, weights, n_weights, gx, gy, gz, n_fourier,
             n_hidden, tf_points, act_param, seg, n_seg_max, stepsize,
             density_min, inv_range, early_alpha, bmin, bsize);
  P.seg_active = seg_active;
  P.mask_cols = mask_cols;
  BwdArgs A;
  A.carries = reinterpret_cast<const float4*>(carries);
  A.seg_count = seg_count;
  A.d_out = reinterpret_cast<const float4*>(d_out);
  A.d_weights = d_weights;
  A.d_table = d_table;
  A.tile_work = tile_work;
  A.n_lat = n_lat;
  const size_t smem = ((size_t)2 * n_weights
                       + (size_t)stage_rows(n_fourier, tf_points) * kStride)
                      * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = n_rays / kTile;
  if (blocks > 0)
    mega_bwd_kernel<<<blocks, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        P, A);
  return (int)cudaGetLastError();
}
