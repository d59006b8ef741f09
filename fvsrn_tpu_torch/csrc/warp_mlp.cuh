// The warp-owned sample tile: the device layer both forward marches
// (segment_fwd.cu, mega_fwd.cu) and the sample evaluator's value instance
// (sample_eval.cu: a warp's 32 consecutive positions as one tile, steps 3
// and 4 below replaced by the density head) evaluate their network on.
//
// A warp owns a group of 32 rays (lane = ray) and marches them segment by
// segment on its own. Per segment (in chunks of at most 32 samples):
//  1. each lane forms its ray's mask of valid samples (the kernel's rule);
//  2. the warp lists them ray by ray in sample order: list row i belongs
//     to the lane whose inclusive prefix count first passes i, found by a
//     binary search over shuffled counts, so the list is never stored;
//  3. the warp evaluates the list in tiles of 32 rows (lane m builds row
//     m: Fourier features, trilinear latent fetch, position, direction),
//     runs every layer as TF32 three-pass mma.sync products over the
//     tile's 16-row blocks with the activation in the product's
//     epilogue, and folds the output layer into the last epilogue (each
//     lane's partial dot products, summed over the four lanes of a row by
//     shuffles); lane m then applies the head and the TF to row m;
//  4. the rows are composited in order: a ray's rows are contiguous and
//     in sample order in the list, so a segmented scan of "over" across
//     the lanes gives each ray's run in the tile, which its lane folds
//     into its carry; the carry crosses tile boundaries and no (ray,
//     sample) state is stored.
// A layer's output goes from the accumulator fragments to the next
// layer's A fragments through the warp's own tile in shared memory (the
// C and A fragments of m16n8k8 differ), with __syncwarp: no block barrier
// inside a segment. Every fragment of a layer is in registers before the
// epilogue writes, so each layer writes over its own input in place.
//
// Precision: every product is a = a_hi + a_lo, b = b_hi + b_lo in TF32
// (sample_mlp.cuh's split), a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated
// in float32, so the network stays float32-accurate. Sines and cosines
// are the SFU's after a Cody-Waite reduction (sample_mlp.cuh's
// reduce_angle).
//
// Shared memory (`FPlan`, mirrored by fvsrn_tpu_torch/ops/sample_mlp.py
// `fwd_plan`): the layer matrices in the tile's column order, staged split
// in B-fragment order (one 16-byte load a fragment, no split in the loop)
// where that fits, else input-major with a row stride of H + 8
// (conflict-free B fragments); the vectors (biases, output rows, Fourier
// matrices padded to whole groups of 4, the TF: 5 floats a piecewise
// knot, 4 a texel, 6 a Gaussian, none for the preint2d table, which stays
// in L2); then per warp its tile: 32
// rows of max(K, H) + 4 floats (conflict-free A fragments), 32 rows of 4
// (head outputs) and its rays' fields (8 a ray, read by the lanes that
// build their rows). The weights are staged once per block and read-only
// after that.
#pragma once

#include "sample_mlp.cuh"

namespace wmlp {

using namespace march;
using smlp::split;
using smlp::take;

constexpr int kRows = 32;        // rows of a tile: one a lane
constexpr int kRayF = 8;         // ray fields a lane lends its tile rows
constexpr int kMaxWarps = 8;     // warps a block

// Offsets (floats) of the shared-memory regions; total in bytes. With
// `pre` the layer matrices are staged split (TF32 hi and lo) in the mma's
// B-fragment order, else input-major with a row stride of ldw.
struct FPlan {
  int warps, pre, ldw, lds, wl;    // wl: floats of one hidden matrix
  int W1, Wh, vec, tiles, per_warp, total;
  int b1, bh, Wo, bo, B, Bd, TF;   // in the vector region
};

// What the tile reads of the call. A tile row's columns: cos (F), sin (F),
// latent (16 * chunks), position, direction (with direction input), zeros
// up to K, the row's width (a multiple of 8); F4 is F rounded up to 4 (the
// Fourier matrices' staged rows). The TF: tp rows (knots, texels,
// Gaussians, or R2), tpre cumulative rows (preint1d), tfn floats staged,
// tf2d the preint2d table.
struct FDims {
  int F, F4, nh, chunks, K, tp;
  int cos, sin, lat, pos;
  int has_dir, act, head, n_out, blend_alpha, iso;
  float p, inv_p, inv_2p, iso_value, density_min, inv_range, h;
  int gx, gy, gz;
  const void* table;
  int tpre, tfn;
  const float4* tf2d;
};

// What a launch passes the layer; the kernels take it by reference to
// their parameters, so none of it takes registers.
struct FLayer {
  FPlan pl;
  FDims D;
};

__host__ __device__ inline FPlan make_fwd_plan(int H, int K, int nh, int F4,
                                               int tfn, int warps, int pre) {
  FPlan p;
  p.warps = warps;
  p.pre = pre;
  p.ldw = H + 8;
  p.lds = (K > H ? K : H) + 4;
  p.wl = pre ? 2 * H * H : H * p.ldw;
  int o = 0;
  p.W1 = take(o, pre ? 2L * K * H : (long)K * p.ldw);
  p.Wh = take(o, (long)nh * p.wl);
  p.vec = take(o, H + nh * H + 4 * H + 4 + 6 * F4 + tfn);
  p.per_warp = kRows * p.lds + kRows * 4 + kRows * kRayF;
  p.tiles = take(o, (long)warps * p.per_warp);
  p.total = o * 4;
  p.b1 = p.vec;
  p.bh = p.b1 + H;
  p.Wo = p.bh + nh * H;
  p.bo = p.Wo + 4 * H;
  p.B = p.bo + 4;
  p.Bd = p.B + 3 * F4;
  p.TF = p.Bd + 3 * F4;
  return p;
}

// The plan of a launch whose block takes `warps` warps (0: any of 8, 4, 2,
// 1) and stages `tfn` TF floats: the most warps an SM holds (warps a block
// times the blocks that fit in its shared memory, two or one), and of
// those the first with the matrices pre-split, then the most warps a
// block. False when none fits.
__host__ __device__ inline bool choose_fwd_plan(int H, int K, int nh, int F4,
                                                int tfn, int warps,
                                                FPlan& p) {
  const int ws[4] = {8, 4, 2, 1};
  int best = 0;
  for (int c = 0; c < 4; ++c) {
    if (warps != 0 && ws[c] != warps) continue;
    for (int pre = 1; pre >= 0; --pre) {
      const FPlan q = make_fwd_plan(H, K, nh, F4, tfn, ws[c], pre);
      const int blocks = q.total <= smlp::kSmemTwo     ? 2
                         : q.total <= smlp::kSmemLimit ? 1 : 0;
      if (ws[c] * blocks > best) {
        best = ws[c] * blocks;
        p = q;
      }
    }
  }
  return best > 0;
}

// Blocks of a persistent launch over n independent rows (tiles of 32,
// pl.warps tiles at a time a block): as many as `sms` SMs hold resident by
// the plan (two blocks an SM or one, as choose_fwd_plan counts them), or
// fewer when the call has fewer tiles.
__host__ inline int persistent_blocks(long n, const FPlan& pl, int sms) {
  const long tiles = (n + kRows - 1) / kRows;
  const long blocks = (tiles + pl.warps - 1) / pl.warps;
  const long resident = (long)(pl.total <= smlp::kSmemTwo ? 2 : 1) * sms;
  return (int)(blocks < resident ? blocks : resident);
}

// The tile's columns of a network (as FDims says); `dir` with direction
// input.
__host__ inline void set_columns(FDims& D, int F, int chunks, int dir) {
  D.F = F;
  D.F4 = (F + 3) / 4 * 4;
  D.chunks = chunks;
  D.cos = 0;
  D.sin = F;
  D.lat = 2 * F;
  D.pos = D.lat + kLat * chunks;
  D.K = (D.pos + (dir ? 6 : 3) + 7) / 8 * 8;
}

// A layer matrix (K x H, entry w(k, o): input k, output o) into the plan's
// layout at dst, by the block's threads. Pre-split, k-step ks and n-tile
// nt hold for lane (g, t) the hi and lo of W[8 ks + t][8 nt + g] and of
// W[8 ks + t + 4][8 nt + g]: one 16-byte load a fragment.
template <int H, class Fn>
__device__ __forceinline__ void stage_matrix(const FPlan& pl, float* dst,
                                             int K, const Fn& w) {
  if (pl.pre) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
      const int k = i / H, o = i % H, r = k & 7;
      const int lane = (o & 7) * 4 + (r & 3);
      const int at = (((k >> 3) * (H / 8) + (o >> 3)) * 32 + lane) * 4
                     + 2 * (r >> 2);
      smlp::split(w(k, o), d[at], d[at + 1]);
    }
  } else {
    for (int i = threadIdx.x; i < K * pl.ldw; i += blockDim.x) {
      const int k = i / pl.ldw, o = i % pl.ldw;
      dst[i] = o < H ? w(k, o) : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// transcendentals (the SFU's, after sample_mlp.cuh's reduction)

__device__ __forceinline__ float fast_sin(float x) {
  return __sinf(smlp::reduce_angle(x));
}

__device__ __forceinline__ float fast_cos(float x) {
  return __cosf(smlp::reduce_angle(x));
}

// march_common.cuh's activation, one instance per activation.
template <int ACT>
__device__ __forceinline__ float act_of(float x, const FDims& D) {
  if (ACT == kReLU) return fmaxf(x, 0.0f);
  if (ACT == kSine) return fast_sin(D.p * x);
  if (ACT == kSigmoid) return sigmoid(x);
  if (ACT == kSoftplus) return softplus(x);
  if (ACT == kSnake) {
    const float s = fast_sin(D.p * x);
    return x + s * s * D.inv_p;
  }
  if (ACT == kSnakeAlt)
    return (x + 1.0f - fast_cos(2.0f * D.p * x)) * D.inv_2p;
  return x;
}

// ---------------------------------------------------------------------------
// the products

// sample_mlp.cuh's mma_tf32, not volatile: the scheduler may move it
// among the independent products of a k-step.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[rb] (rows 16 rb .. 16 rb + 15 from A, all H columns as H/8 m16n8
// fragments) = bias + A[rows, 0:K] W[0:K, 0:H] for rb < NB. A is the
// warp's tile from the run's first row (row stride lds), W staged as the
// plan says (PRE: split in fragment order; else input-major, row stride
// ldw). No branch inside the loop: the scheduler interleaves the
// fragments' independent products.
template <int H, int NB, bool PRE>
__device__ __forceinline__ void product(float (&c)[NB][H / 8][4],
                                        const float* A, int lds,
                                        const float* W, int ldw, int K,
                                        const float* bias) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * t);
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) {
      c[rb][nt][0] = b.x;
      c[rb][nt][1] = b.y;
      c[rb][nt][2] = b.x;
      c[rb][nt][3] = b.y;
    }
  }
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[NB][4], al[NB][4];
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) {
      const float* p = A + (16 * rb + g) * lds + k0 + t;
      split(p[0], ah[rb][0], al[rb][0]);
      split(p[8 * lds], ah[rb][1], al[rb][1]);
      split(p[4], ah[rb][2], al[rb][2]);
      split(p[8 * lds + 4], ah[rb][3], al[rb][3]);
    }
    // each B fragment split once (or staged split) for every row block
    const float* wp = W + (k0 + t) * ldw + g;
    const uint4* wf = reinterpret_cast<const uint4*>(W)
                      + (k0 >> 3) * (H / 8) * 32 + lane;
    uint4 b[H / 8];   // (hi, lo) of the fragment's two values
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      if constexpr (PRE) {
        b[nt] = wf[32 * nt];
      } else {
        split(wp[8 * nt], b[nt].x, b[nt].y);
        split(wp[8 * nt + 4 * ldw], b[nt].z, b[nt].w);
      }
    }
    // the three passes in turn over every fragment: the products of one
    // accumulator are H/8 * NB issues apart
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) mma(c[rb][nt], al[rb], b[nt].x, b[nt].z);
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) mma(c[rb][nt], ah[rb], b[nt].y, b[nt].w);
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) mma(c[rb][nt], ah[rb], b[nt].x, b[nt].z);
  }
}

// The activation of c into the tile (in place of the layer's input).
template <int H, int NB, int ACT>
__device__ __forceinline__ void store_act(const float (&c)[NB][H / 8][4],
                                          float* A, int lds,
                                          const FDims& D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();   // every lane has read the layer's input
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = 16 * rb + g + 4 * e;
        *reinterpret_cast<float2*>(A + row * lds + 8 * nt + 2 * t) =
            make_float2(act_of<ACT>(c[rb][nt][e], D),
                        act_of<ACT>(c[rb][nt][e + 1], D));
      }
  __syncwarp();
}

// The output layer on the activation of c: y[row][0:n_out] = bo +
// Wo act(c[row]), each lane's part over its columns, summed over the four
// lanes of a row; into ybuf (4 floats a row, from the run's first row).
template <int H, int NB, int ACT, int NO>
__device__ __forceinline__ void head_rows(const float (&c)[NB][H / 8][4],
                                          const float* Wo, const float* bo,
                                          float* ybuf, const FDims& D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float y[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) y[o] = 0.0f;
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = act_of<ACT>(c[rb][nt][2 * half + e], D);
          const int col = 8 * nt + 2 * t + e;
#pragma unroll
          for (int o = 0; o < NO; ++o) y[o] = fmaf(Wo[o * H + col], v, y[o]);
        }
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        y[o] += __shfl_xor_sync(0xffffffffu, y[o], 1);
        y[o] += __shfl_xor_sync(0xffffffffu, y[o], 2);
      }
      if (t == 0) {
        float* yr = ybuf + (16 * rb + 8 * half + g) * 4;
#pragma unroll
        for (int o = 0; o < NO; ++o) yr[o] = bo[o] + y[o];
      }
    }
}

// Every layer of a run of NB 16-row blocks of the tile (its first-layer
// input built), the output layer's values into ybuf. Each row block reads
// and writes only its own rows, so a run writes over its input in place.
template <int H, int NB, int ACT, bool PRE>
__device__ __forceinline__ void layers_run(const FPlan& pl, const FDims& D,
                                           const float* sm, float* A,
                                           float* ybuf) {
  float c[NB][H / 8][4];
#pragma unroll 1
  for (int l = 0; l <= D.nh; ++l) {
    const float* W = l ? sm + pl.Wh + (l - 1) * pl.wl : sm + pl.W1;
    const float* bias = l ? sm + pl.bh + (l - 1) * H : sm + pl.b1;
    product<H, NB, PRE>(c, A, pl.lds, W, pl.ldw, l ? H : D.K, bias);
    if (l < D.nh)
      store_act<H, NB, ACT>(c, A, pl.lds, D);
    else if (D.n_out == 1)
      head_rows<H, NB, ACT, 1>(c, sm + pl.Wo, sm + pl.bo, ybuf, D);
    else
      head_rows<H, NB, ACT, 4>(c, sm + pl.Wo, sm + pl.bo, ybuf, D);
  }
}

// Every layer of the tile's `nrb` row blocks. Width 32 takes both blocks
// in one run when the tile has more than 16 rows (each B fragment split
// once for both); wider layers take one block a run (the accumulators of
// two would not fit in registers).
template <int H, int ACT, bool PRE>
__device__ __forceinline__ void layers_pre(const FPlan& pl, const FDims& D,
                                           const float* sm, float* tile,
                                           float* ybuf, int nrb) {
  if constexpr (H == 32) {
    if (nrb == 2) {
      layers_run<H, 2, ACT, PRE>(pl, D, sm, tile, ybuf);
      return;
    }
  }
#pragma unroll 1
  for (int r0 = 0; r0 < nrb; ++r0)
    layers_run<H, 1, ACT, PRE>(pl, D, sm, tile + 16 * r0 * pl.lds,
                               ybuf + 64 * r0);
}

template <int H, int ACT>
__device__ __forceinline__ void layers(const FPlan& pl, const FDims& D,
                                       const float* sm, float* tile,
                                       float* ybuf, int nrb) {
  if (pl.pre)
    layers_pre<H, ACT, true>(pl, D, sm, tile, ybuf, nrb);
  else
    layers_pre<H, ACT, false>(pl, D, sm, tile, ybuf, nrb);
}

template <int H>
__device__ __forceinline__ void layers_any(const FPlan& pl, const FDims& D,
                                           const float* sm, float* tile,
                                           float* ybuf, int nrb) {
  switch (D.act) {
    case kReLU: layers<H, kReLU>(pl, D, sm, tile, ybuf, nrb); break;
    case kSine: layers<H, kSine>(pl, D, sm, tile, ybuf, nrb); break;
    case kSigmoid: layers<H, kSigmoid>(pl, D, sm, tile, ybuf, nrb); break;
    case kSoftplus: layers<H, kSoftplus>(pl, D, sm, tile, ybuf, nrb); break;
    case kSnake: layers<H, kSnake>(pl, D, sm, tile, ybuf, nrb); break;
    case kSnakeAlt: layers<H, kSnakeAlt>(pl, D, sm, tile, ybuf, nrb); break;
    default: layers<H, kNone>(pl, D, sm, tile, ybuf, nrb); break;
  }
}

// ---------------------------------------------------------------------------
// a tile's rows

// Channels 16 q .. 16 q + 15 of the trilinear fetch (march_common.cuh's
// trilerp16, the same sums) into o: a bf16 row in one pass of sixteen
// 16-byte loads, a float32 row in four passes of eight (more in flight
// would take the registers the tile's layers need).
template <typename Table>
__device__ __forceinline__ void fetch_row(const void* table,
                                          const Corners& c, int chunks,
                                          int q, float* o, bool aligned) {
  constexpr int kParts = Table::kBytes;   // 16-byte loads a 16-channel row
  constexpr int kCh = kLat / kParts;      // channels a load holds
  constexpr int kPass = kParts == 2 ? 2 : 1;   // loads a corner a pass
  const uint4* tb = static_cast<const uint4*>(table);
#pragma unroll 1
  for (int part = 0; part < kParts; part += kPass) {
    float acc[kPass * kCh];
#pragma unroll
    for (int i = 0; i < kPass * kCh; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4* p = tb + ((size_t)c.row[k] * chunks + q) * kParts + part;
      const float w = c.w[k];
#pragma unroll
      for (int h = 0; h < kPass; ++h) {
        const uint4 v = __ldg(p + h);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
        float* a = acc + kCh * h;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kParts == 2) {   // bf16 pairs: low half first
            a[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), a[2 * i]);
            a[2 * i + 1] =
                fmaf(w, __uint_as_float(u[i] & 0xffff0000u), a[2 * i + 1]);
          } else {
            a[i] = fmaf(w, __uint_as_float(u[i]), a[i]);
          }
        }
      }
    }
    float* d = o + kCh * part;
#pragma unroll
    for (int i = 0; i < kPass * kCh; i += 4) {
      if (aligned) {
        *reinterpret_cast<float4*>(d + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i + e] = acc[i + e];
      }
    }
  }
}

// Row m of the tile: a sample at normalized position x, ray direction d.
template <typename Table>
__device__ __forceinline__ void build_row(const FDims& D, const float* sm,
                                          const FPlan& pl, float* row,
                                          const float* x, const float* d) {
  const float4* B4 = reinterpret_cast<const float4*>(sm + pl.B);
  const float4* Bd4 = reinterpret_cast<const float4*>(sm + pl.Bd);
  // Fourier features four at a time (B padded with zero rows)
#pragma unroll 1
  for (int u = 0; u < D.F4; u += 4) {
    // rows u..u+3 of B (F4, 3): 12 floats, three float4
    const float4 b0 = B4[3 * u / 4], b1 = B4[3 * u / 4 + 1],
                 b2 = B4[3 * u / 4 + 2];
    float f0 = b0.x * x[0] + b0.y * x[1] + b0.z * x[2];
    float f1 = b0.w * x[0] + b1.x * x[1] + b1.y * x[2];
    float f2 = b1.z * x[0] + b1.w * x[1] + b2.x * x[2];
    float f3 = b2.y * x[0] + b2.z * x[1] + b2.w * x[2];
    if (D.has_dir) {
      const float4 e0 = Bd4[3 * u / 4], e1 = Bd4[3 * u / 4 + 1],
                   e2 = Bd4[3 * u / 4 + 2];
      f0 += e0.x * d[0] + e0.y * d[1] + e0.z * d[2];
      f1 += e0.w * d[0] + e1.x * d[1] + e1.y * d[2];
      f2 += e1.z * d[0] + e1.w * d[1] + e2.x * d[2];
      f3 += e2.y * d[0] + e2.z * d[1] + e2.w * d[2];
    }
    float sn[4], cs[4];
    smlp::fast_sincos(f0, &sn[0], &cs[0]);
    smlp::fast_sincos(f1, &sn[1], &cs[1]);
    smlp::fast_sincos(f2, &sn[2], &cs[2]);
    smlp::fast_sincos(f3, &sn[3], &cs[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (u + e < D.F) {
        row[D.cos + u + e] = cs[e];
        row[D.sin + u + e] = sn[e];
      }
    }
  }
  if (D.chunks > 0) {
    Corners cn;
    grid_corners(D.gx, D.gy, D.gz, x[0], x[1], x[2], cn);
    const bool aligned = (D.lat & 3) == 0;
#pragma unroll 1
    for (int q = 0; q < D.chunks; ++q)
      fetch_row<Table>(D.table, cn, D.chunks, q, row + D.lat + kLat * q,
                       aligned);
  }
  // position, direction, zeros up to K
  float* pd = row + D.pos;
  pd[0] = x[0];
  pd[1] = x[1];
  pd[2] = x[2];
  int k = 3;
  if (D.has_dir) {
    pd[3] = d[0];
    pd[4] = d[1];
    pd[5] = d[2];
    k = 6;
  }
  for (; D.pos + k < D.K; ++k) pd[k] = 0.0f;
}

// A row's color (r, g, b, alpha) from the head's input y, alpha < 0 when
// the sample does not count (a density below density_min); with iso the
// head's value in x. As segment_common.cuh's sample_color / sample_alpha.
__device__ __forceinline__ float4 row_color(const FDims& D, const float* TF,
                                            const float* y) {
  float v[4];
  head_value(D.head, y, v);
  if (D.iso) return make_float4(v[0], 0.0f, 0.0f, 0.0f);
  float cr, cg, cb, absn;
  if (D.head >= kRgbo) {
    cr = v[0];
    cg = v[1];
    cb = v[2];
    absn = v[3] * D.h;
  } else {
    if (!(v[0] >= D.density_min)) return make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    const float dn = fminf(fmaxf((v[0] - D.density_min) * D.inv_range, 0.0f),
                           1.0f);
    TfSample tf;
    tf_lookup(TF, D.tp, dn, tf);
    cr = tf.r;
    cg = tf.g;
    cb = tf.b;
    absn = tf.op * D.h;
  }
  const float a = D.blend_alpha ? fminf(1.0f, absn) : 1.0f - expf(-absn);
  return make_float4(cr, cg, cb, a);
}

// Row color in TF mode TFM (not piecewise): as row_color, the density's
// TF by tf_color at the row's normalized density `dens` and its previous
// sample's `prev`.
template <int TFM>
__device__ __forceinline__ float4 row_color_tf(const FDims& D, const float* TF,
                                               const float* y, float dens,
                                               float prev) {
  float v[4];
  head_value(D.head, y, v);
  float4 c;
  if (D.head >= kRgbo) {
    c = make_float4(v[0], v[1], v[2], v[3] * D.h);
  } else {
    if (!(v[0] >= D.density_min)) return make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    c = tf_color<TFM>(TF, D.tf2d, D.tp, D.tpre,
                      fminf(fmaxf(dens, 0.0f), 1.0f), prev, D.h);
  }
  c.w = D.blend_alpha ? fminf(1.0f, c.w) : 1.0f - expf(-c.w);
  return c;
}

// What a lane carries through its ray's samples: the carry (rgba, or
// (depth, 0, 0, found) for iso) and the samples evaluated.
struct Carry {
  float4 c;
  unsigned n;
};

// warp_chunk's `Nrm` of the instances without normals (position_grad.cuh's
// RowNormal is the other).
struct NoNormal {
  static constexpr bool kOn = false;
};

// The warp's rays' fields in its tile region: 8 floats a lane.
__device__ __forceinline__ float* ray_fields(const FPlan& pl, float* tile) {
  return tile + kRows * pl.lds + kRows * 4;
}

// The warp's samples of one chunk through the network, composited into
// each lane's carry in order. On each lane: `mask` its ray's valid samples
// of the chunk (bit j: sample j of the chunk); ray_fields holds the rays'
// fields. `Pt::point(rf, j, t, x, d)` gives sample j's t, normalized
// position and direction from its ray's fields. ACT is the activation
// (-1: D.act, any). Every lane of the warp calls this.
//
// Compositing: "over" is associative, (C, A) of a run of samples (C the
// premultiplied color, A the alpha) composing front to back as
// (C1 + (1 - A1) C2, A1 + (1 - A1) A2). Lane m holds row m's (a rgb, a); a
// segmented inclusive scan over the lanes (a segment: one ray's rows in
// the tile) leaves each ray's run at its last row, which its lane folds
// into the carry as "over" folds a sample. A run of samples that absorb
// nothing is (0, 0) exactly and leaves the carry's bits unchanged, as the
// samples a culled segment skips must (culled and unculled renders agree
// bit for bit). The iso march takes each ray's first row above the
// isovalue, in order, on its own lane.
//
// In a TF mode TFM other than piecewise, `dp` is the lane's ray's last
// normalized density (-1 before its first sample): row m reads row m - 1's
// density (a shuffle) when both are its ray's, else its ray's `dp`, or none
// where `Pt::first(rf, j)` marks the ray's first sample; after the tile
// each ray's `dp` is its last row's density, whether or not that row
// counted (a culled or skipped segment leaves it alone). The rows of
// `donly` (a subset of `mask`, each lane's) give their density and no
// color.
//
// With normals (`Nrm::kOn`, the piecewise TF, no iso), once the tile's
// layers have run each lane takes its row's counting sample through
// nrm.grad (the scalar network and its adjoint sweep, the row of the tile
// as the lane's scratch), shades it (march_common.cuh shade_sample) and
// gives the normal and depth (n, t) besides the color; the scan composes
// them with the color's weights into each lane's `nd` (over_nd).
template <int H, typename Table, int ACT, class Pt, int TFM = kTfPiecewise,
          class Nrm = NoNormal>
__device__ __forceinline__ void warp_chunk(const FPlan& pl, const FDims& D,
                                           const float* sm, float* tile,
                                           uint32_t mask, const Pt& pt,
                                           Carry& cy, FwdProf* fp,
                                           float& dp, uint32_t donly = 0u,
                                           const Nrm& nrm = Nrm(),
                                           float4* nd = nullptr) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float* ybuf = tile + kRows * pl.lds;
  const float* rays = ray_fields(pl, tile);
  // the list: lane L's samples are rows [incl_L - popc, incl_L)
  const int own = __popc(mask);
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - own;
  const int total = __shfl_sync(full, incl, 31);
  uint32_t rem = mask;   // this lane's samples not yet composited (iso)
  FWD_MARK(fp, 5);
#pragma unroll 1
  for (int tile0 = 0; tile0 < total; tile0 += kRows) {
    const int cnt = min(kRows, total - tile0);
    // row lane of the tile: its owner L (the lanes with incl <= i) and
    // sample j (the owner's (i - excl_L)-th valid sample)
    const int i = tile0 + lane;
    int L = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const int v = __shfl_sync(full, incl, L + step - 1);
      if (v <= i) L += step;
    }
    const int ex = __shfl_sync(full, excl, L);
    const uint32_t ml = __shfl_sync(full, mask, L);
    if (lane < cnt) {
      const int j = (int)__fns(ml, 0, i - ex + 1);
      float t, x[3], d[3];
      pt.point(rays + kRayF * L, j, t, x, d);
      build_row<Table>(D, sm, pl, tile + lane * pl.lds, x, d);
    }
    __syncwarp();
    FWD_MARK(fp, 0);
    const int nrb = cnt > 16 ? 2 : 1;
    if constexpr (ACT < 0)
      layers_any<H>(pl, D, sm, tile, ybuf, nrb);
    else
      layers<H, ACT>(pl, D, sm, tile, ybuf, nrb);
    __syncwarp();
    FWD_MARK(fp, 1);
    float4 col = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    float dens = 0.0f;   // the row's normalized density (TF modes)
    float4 nt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // normal, depth
    if constexpr (Nrm::kOn) {
      if (lane < cnt) {
        const float4 y = reinterpret_cast<const float4*>(ybuf)[lane];
        const float ya[4] = {y.x, y.y, y.z, y.w};
        float v[4];
        head_value(D.head, ya, v);
        if (v[0] >= D.density_min) {
          TfSample tf;
          tf_lookup(sm + pl.TF, D.tp,
                    fminf(fmaxf((v[0] - D.density_min) * D.inv_range, 0.0f),
                          1.0f),
                    tf);
          col = make_float4(tf.r, tf.g, tf.b, tf.op * D.h);
          const float* rf = rays + kRayF * L;
          const int j = (int)__fns(ml, 0, i - ex + 1);
          float t, x[3], d[3], g[3], n[3];
          pt.point(rf, j, t, x, d);
          nrm.template grad<H, Table>(tile + lane * pl.lds, x, d, g);
          const float pw[3] = {rf[0] + t * rf[3], rf[1] + t * rf[4],
                               rf[2] + t * rf[5]};
          shade_sample(nrm.S, col, g, pw, rf + 3, n);
          col.w = D.blend_alpha ? fminf(1.0f, col.w) : 1.0f - expf(-col.w);
          nt = make_float4(n[0], n[1], n[2], t);
        }
      }
    } else if constexpr (TFM == kTfPiecewise) {
      if (lane < cnt) {
        const float4 y = reinterpret_cast<const float4*>(ybuf)[lane];
        const float ya[4] = {y.x, y.y, y.z, y.w};
        col = row_color(D, sm + pl.TF, ya);
      }
    } else {
      const float4 y = reinterpret_cast<const float4*>(ybuf)[lane];
      const float ya[4] = {y.x, y.y, y.z, y.w};
      if (lane < cnt && D.head < kRgbo) {
        float v[4];
        head_value(D.head, ya, v);
        dens = (v[0] - D.density_min) * D.inv_range;
      }
      const float up = __shfl_up_sync(full, dens, 1);
      const int up_l = __shfl_up_sync(full, L, 1);
      const float own = __shfl_sync(full, dp, L);
      const uint32_t dl = __shfl_sync(full, donly, L);
      float prev = (lane > 0 && up_l == L) ? up : own;
      if (lane < cnt) {
        const int j = (int)__fns(ml, 0, i - ex + 1);
        if (pt.first(rays + kRayF * L, j)) prev = -1.0f;
        if (!((dl >> j) & 1u))
          col = row_color_tf<TFM>(D, sm + pl.TF, ya, dens, prev);
      }
    }
    FWD_MARK(fp, 2);
    // this lane's rows of the tile
    const int lo = max(excl, tile0) - tile0;
    const int hi = min(incl, tile0 + kRows) - tile0;
    if (D.iso) {
      reinterpret_cast<float4*>(ybuf)[lane] = col;
      __syncwarp();
#pragma unroll 1
      for (int m = lo; m < hi; ++m) {
        const int j = __ffs(rem) - 1;
        rem &= rem - 1;
        if (cy.c.w > 0.5f) continue;   // the hit is found: nothing changes
        ++cy.n;
        if (ybuf[4 * m] > D.iso_value) {
          float t, x[3], d[3];
          pt.point(rays + kRayF * lane, j, t, x, d);
          cy.c.x = t;
          cy.c.w = 1.0f;
        }
      }
      __syncwarp();
    } else {
      // row lane's (C, A); rows that do not count are the identity
      const bool counts = col.w >= 0.0f;
      float cr = counts ? col.w * col.x : 0.0f;
      float cg = counts ? col.w * col.y : 0.0f;
      float cb = counts ? col.w * col.z : 0.0f;
      float ar = counts ? col.w : 0.0f;
      float4 cn = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (Nrm::kOn) {
        if (counts)
          cn = make_float4(col.w * nt.x, col.w * nt.y, col.w * nt.z,
                           col.w * nt.w);
      }
      // a segment starts at row 0 and wherever the owner changes
      const int prev = __shfl_up_sync(full, L, 1);
      bool start = lane == 0 || prev != L;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float pr = __shfl_up_sync(full, cr, o);
        const float pg = __shfl_up_sync(full, cg, o);
        const float pb = __shfl_up_sync(full, cb, o);
        const float pa = __shfl_up_sync(full, ar, o);
        const bool ps = __shfl_up_sync(full, (int)start, o) != 0;
        float4 pn;
        if constexpr (Nrm::kOn) {
          pn.x = __shfl_up_sync(full, cn.x, o);
          pn.y = __shfl_up_sync(full, cn.y, o);
          pn.z = __shfl_up_sync(full, cn.z, o);
          pn.w = __shfl_up_sync(full, cn.w, o);
        }
        if (lane >= o && !start) {
          const float tl = 1.0f - pa;
          cr = fmaf(tl, cr, pr);
          cg = fmaf(tl, cg, pg);
          cb = fmaf(tl, cb, pb);
          ar = fmaf(tl, ar, pa);
          if constexpr (Nrm::kOn) {
            cn.x = fmaf(tl, cn.x, pn.x);
            cn.y = fmaf(tl, cn.y, pn.y);
            cn.z = fmaf(tl, cn.z, pn.z);
            cn.w = fmaf(tl, cn.w, pn.w);
          }
          start = ps;
        }
      }
      // each ray's run at its last row of the tile, into its carry
      const int last = hi > lo ? hi - 1 : 0;
      const float Cr = __shfl_sync(full, cr, last);
      const float Cg = __shfl_sync(full, cg, last);
      const float Cb = __shfl_sync(full, cb, last);
      const float Ar = __shfl_sync(full, ar, last);
      if constexpr (Nrm::kOn) {
        const float4 run = make_float4(
            __shfl_sync(full, cn.x, last), __shfl_sync(full, cn.y, last),
            __shfl_sync(full, cn.z, last), __shfl_sync(full, cn.w, last));
        if (hi > lo) over_nd(*nd, 1.0f - cy.c.w, run);
      }
      if (hi > lo) {
        const float w = 1.0f - cy.c.w;
        cy.c.x = fmaf(w, Cr, cy.c.x);
        cy.c.y = fmaf(w, Cg, cy.c.y);
        cy.c.z = fmaf(w, Cb, cy.c.z);
        cy.c.w = fmaf(w, Ar, cy.c.w);
      }
      if constexpr (TFM != kTfPiecewise) {
        const float dl = __shfl_sync(full, dens, last);
        if (hi > lo) dp = dl;
      }
    }
    FWD_MARK(fp, 3);
  }
}

}  // namespace wmlp
