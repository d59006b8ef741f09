// The batched sample MLP: the device layer both training backwards
// (segment_bwd.cu, mega_bwd.cu) run their network work on.
//
// A block takes its rays in groups of 32 (one warp owns a group's rays)
// and, per segment, evaluates the group's samples as tiles of M rows (one
// row a (ray, sample) pair):
//  A. the replay: every valid sample of the segment, forward only; each
//     row's color, absorption and whether it counts / contributes go to
//     shared memory, per (ray, sample);
//  B. the reverse compositing recurrence, per ray on the owning warp's
//     lanes, which turns those into the cotangents of each contributing
//     sample's rgb and absorption;
//  C. the adjoint: the contributing samples, compacted by a prefix sum over
//     the rays' masks, forward again keeping each layer's output and
//     activation derivative for the tile, then the head/TF adjoint per row
//     and the transposed layers and weight gradients as products.
// Every layer is a product over the tile: Z = X W (forward), dX = dZ W^T
// and dW += X^T dZ (the weight gradient, its K the tile's rows), on the
// tensor cores by mma.sync m16n8k8 in TF32 with the three-pass split
// (a = a_hi + a_lo, a_hi b_hi + a_hi b_lo + a_lo b_hi accumulated in
// float32), which keeps every product float32-accurate. The activations,
// their derivatives, the Fourier features and their adjoint, the trilinear
// latent fetch and its adjoint (16-byte atomics into the float32 table
// gradient; the table itself float32 or bf16, widened as it is read) stay
// scalar.
//
// Ray gradients: a source type (`Src`) with kRayGrads (the megakernel's
// ray-gradient instances) also folds each contributing row's position
// cotangent over the segment into its ray's start and direction
// (`ray_fold`); every other instance compiles as if it did not exist.
//
// Gradients: every entry of the block's partial row (packed as the
// weights, `GOut` gives the kernel's strides) belongs to one thread (the
// mma fragment's element, or entry e of a loop over the row), which adds
// each tile's sum to it in device memory: no atomics on weights, so a
// launch's partial rows are bitwise reproducible.
//
// Shared memory (`Plan`, mirrored by fvsrn_tpu_torch/ops/sample_mlp.py):
// the layer matrices input-major with a row stride of H + 8 (conflict-free
// B fragments) or H where only that fits (in the wide plan, hidden widths
// above kSmemMaxWidth, the first layer's only: the hidden matrices are read
// from the packed weights in device memory, where they stay in L2), the
// vectors (biases, output
// rows, Fourier matrices, TF), the tile's first-layer input X (M x K16),
// each layer's activation derivative and output (M x (H + 4)), per-row
// scalars, and the group's per-(ray, sample) state (in the TF modes other
// than piecewise also each sample's density and its cotangent, and each
// ray's incoming density). M is 64, 48, 32 or
// 16: the largest with which an SM holds two blocks of 256 threads (the
// kernels' launch bounds cap them at 128 registers), else the largest
// that fits one block in 227 KB.
//
// Sines and cosines (the Fourier features, the Sine / Snake / SnakeAlt
// activations and their derivatives) are the SFU's after a Cody-Waite
// reduction (`fast_sincos`), not CUDA's accurate sinf/cosf.
#pragma once

#include "march_common.cuh"

namespace smlp {

using namespace march;

// Phase timers (clock64 on thread 0 of each block, into smlp_prof of
// march_common.cuh) in a build with -DSMLP_PROFILE; nothing otherwise.
#ifdef SMLP_PROFILE
#define SMLP_START(t) long long t = clock64()
#define SMLP_MARK(t, i)                                                  \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long n_ = clock64();                                    \
      atomicAdd(&smlp_prof[i], (unsigned long long)(n_ - t));            \
      t = n_;                                                            \
    }                                                                    \
  } while (0)
#else
#define SMLP_START(t) \
  do {                \
  } while (0)
#define SMLP_MARK(t, i) \
  do {                  \
  } while (0)
#endif

constexpr int kGroup = 32;          // rays of a group = lanes of its warp
constexpr int kSegMax = 32;         // samples per segment
constexpr int kRowF = 24;           // per-row scalars (see `Row`)
constexpr int kRayF = 12;           // per-ray scalars: [0, 9) a kernel's,
                                    // [9, 12) the ray's rgb cotangent
constexpr long kSmemLimit = 232448; // bytes a block may use (227 KB)
constexpr long kSmemTwo = 115712;   // bytes each of two blocks an SM holds
// The widest hidden layer whose matrices the plans stage in shared memory;
// the wide instances (kWideWidth) read their hidden matrices from device
// memory: a 128 x 128 float32 matrix takes 69.6 KB in shared memory with
// its padded rows, eight warps' forward tiles at that width 147 KB.
constexpr int kSmemMaxWidth = 64;
constexpr int kWideWidth = 128;

__host__ __device__ constexpr bool wide_width(int H) {
  return H > kSmemMaxWidth;
}

// Per-row scalars: [0] the row's (ray << 5 | sample) or -1, [1, 5) the
// head's input y, [5, 9) its cotangent, [9] the TF interval (or -2),
// [10, 15) and [15, 20) the TF gradient of its two control points. In the
// other TF modes [9, 19) hold march_common.cuh's TfRecord of the row:
// lo1, hi1, f1, dc (4), lo2, hi2, f2 (lo1 < 0: none).
enum Row { kRowId = 0, kRowY = 1, kRowDy = 5, kRowIv = 9, kRowG0 = 10,
           kRowG1 = 15 };
enum RowTf { kRecLo1 = 9, kRecHi1 = 10, kRecF1 = 11, kRecDc = 12,
             kRecLo2 = 16, kRecHi2 = 17, kRecF2 = 18 };
constexpr int kScTf = 4 * kGroup * kSegMax + kGroup;   // sc in the TF modes

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Offsets (floats) of the shared-memory regions, and the tile's shape.
struct Plan {
  int M, pad, ldw, ldx, lda, K8, K16, n_vec;
  int W1, Wh, vec, X, dact, hreg, rows, sc, sray, masks, list, misc, total;
  int b1, bh, Wo, bo, B, Bd, TF;   // in the vector region
};

__host__ __device__ inline int take(int& o, long n) {
  const int at = o;
  o += (int)((n + 3) / 4 * 4);
  return at;
}

// `tfn` TF floats in the vectors; `tf_state`: the TF modes' per-sample
// state (sc of kScTf floats, else two per (ray, sample)).
__host__ __device__ inline Plan make_plan(int H, int K1, int nh, int F,
                                          int tfn, int M, int pad,
                                          int tf_state = 0) {
  Plan p;
  p.M = M;
  p.pad = pad;
  p.ldw = H + pad;
  p.K8 = round_up(K1, 8);
  p.K16 = round_up(K1, 16);
  p.ldx = p.K16 + 4;
  p.lda = H + 4;
  p.n_vec = H + nh * H + 4 * H + 4 + 6 * F + tfn;
  int o = 0;
  p.W1 = take(o, (long)p.K16 * p.ldw);
  // the wide plan's hidden matrices stay in device memory
  p.Wh = take(o, wide_width(H) ? 0L : (long)nh * H * p.ldw);
  p.vec = take(o, p.n_vec);
  p.X = take(o, (long)M * p.ldx);
  p.dact = take(o, (long)(nh + 1) * M * p.lda);
  const long hn = (long)(nh + 1) * M * p.lda;
  const long xn = (long)M * p.ldx;
  p.hreg = take(o, hn > xn ? hn : xn);
  p.rows = take(o, (long)M * kRowF);
  p.sc = take(o, tf_state ? (long)kScTf : 2L * kGroup * kSegMax);
  p.sray = take(o, (long)kGroup * kRayF);
  p.masks = take(o, 4L * kGroup);
  p.list = take(o, kGroup * kSegMax / 2);   // uint16 entries
  p.misc = take(o, 8);
  p.total = o * 4;
  p.b1 = p.vec;
  p.bh = p.b1 + H;
  p.Wo = p.bh + nh * H;
  p.bo = p.Wo + 4 * H;
  p.B = p.bo + 4;
  p.Bd = p.B + 3 * F;
  p.TF = p.Bd + 3 * F;
  return p;
}

// The plan a launch takes: the first of the tiles (64, 48, 32, 16 rows)
// with padded weight rows, then 16 rows unpadded, that lets an SM hold two
// blocks; else the first that fits one. False when none fits.
__host__ __device__ inline bool choose_plan(int H, int K1, int nh, int F,
                                            int tfn, Plan& p,
                                            int tf_state = 0) {
  const int Ms[5] = {64, 48, 32, 16, 16};
  const int pads[5] = {8, 8, 8, 8, 0};
  for (int lim = 0; lim < 2; ++lim)
    for (int c = 0; c < 5; ++c) {
      p = make_plan(H, K1, nh, F, tfn, Ms[c], pads[c], tf_state);
      if (p.total <= (lim ? kSmemLimit : kSmemTwo)) return true;
    }
  return false;
}

// What the layer reads of the call.
struct Dims {
  int F, nh, chunks, n_lat, tp, K1, n_out;
  int pos, dir, cos, sin, lat;   // columns of X (dir -1: no direction)
  int has_dir, act, head, blend_alpha;
  float p, inv_p, inv_2p;        // activation parameter, 1/p, 1/(2p)
  float density_min, inv_range, h;
  int gx, gy, gz;
  const void* table;             // (gz, gy, gx, 16 * chunks), float32 or
  int table_bf16;                // bf16 (table_bf16 = 1)
  float* d_table;                // float32, like the table
  const float* Wg;               // the wide plan's hidden matrices (H x H
  int wg_om;                     // each, in device memory): output-major
                                 // ([o][i], wg_om = 1) or input-major
  int tpre;                      // cumulative TF rows (preint1d)
  const float4* tf2d;            // the preint2d table, and its gradient
  float4* d_tf2d;
  const float* tfg;              // the TF in device memory when it is not
                                 // staged (kTfStaged), else null
};

// Where each gradient entry goes in the block's partial row: base offset
// plus index times stride.
struct GOut {
  int W1, W1_k, W1_o;            // first layer (input k, output o)
  int Wh, Wh_l, Wh_i, Wh_o;      // hidden layers
  int b1, bh, Wo, Wo_r, bo, B, Bd, TF;   // Bd < 0: none
};

// What a launch passes the layer, filled on the host; the kernels hand it
// down by reference to their parameters, so none of it takes registers.
struct Layer {
  Plan pl;
  Dims D;
  GOut G;
};

// The block's shared memory under plan p.
struct Smem {
  float* s;
  const Plan& p;
  __device__ float* W1() const { return s + p.W1; }
  __device__ float* Wh() const { return s + p.Wh; }
  __device__ float* b1() const { return s + p.b1; }
  __device__ float* bh() const { return s + p.bh; }
  __device__ float* Wo() const { return s + p.Wo; }
  __device__ float* bo() const { return s + p.bo; }
  __device__ float* B() const { return s + p.B; }
  __device__ float* Bd() const { return s + p.Bd; }
  __device__ float* TF() const { return s + p.TF; }
  __device__ float* X() const { return s + p.X; }
  __device__ float* dact() const { return s + p.dact; }
  __device__ float* hreg() const { return s + p.hreg; }
  __device__ float* rows() const { return s + p.rows; }
  __device__ float* sc() const { return s + p.sc; }
  __device__ float* sray() const { return s + p.sray; }
  __device__ uint32_t* valid() const {
    return reinterpret_cast<uint32_t*>(s + p.masks);
  }
  __device__ uint32_t* counted() const { return valid() + kGroup; }
  __device__ uint32_t* contrib() const { return valid() + 2 * kGroup; }
  __device__ uint32_t* first() const { return valid() + 3 * kGroup; }
  // the TF modes' state: each (ray, sample)'s normalized density and its
  // cotangent, each ray's incoming density
  __device__ float* dens() const { return sc() + 2 * kGroup * kSegMax; }
  __device__ float* ddens() const { return sc() + 3 * kGroup * kSegMax; }
  __device__ float* pin() const { return sc() + 4 * kGroup * kSegMax; }
  __device__ uint16_t* list() const {
    return reinterpret_cast<uint16_t*>(s + p.list);
  }
  __device__ int* misc() const { return reinterpret_cast<int*>(s + p.misc); }
  __device__ float* hbuf(int l) const {
    return s + p.hreg + (size_t)l * p.M * p.lda;
  }
  __device__ float* dbuf(int l) const {
    return s + p.dact + (size_t)l * p.M * p.lda;
  }
};

// ---------------------------------------------------------------------------
// TF32 three-pass products

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (|x - hi - lo| <= 2^-22 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (a warp's 16 x 16 block, two m16n8 fragments) += A[r0:r0+16, 0:K] .
// B[0:K, n0:n0+16], K a multiple of 8. A is stored row-major with leading
// dimension lda ([row][k]) or, with kAT, as its transpose ([k][row]); B
// as [k][n] or, with kBT, as [n][k].
template <bool kAT, bool kBT>
__device__ __forceinline__ void mma16x16(float (&c)[2][4], const float* A,
                                         int lda, int r0, const float* B,
                                         int ldb, int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the cross terms in accumulators of their own: three independent mma
  // chains a fragment
  float x1[2][4] = {}, x2[2][4] = {};
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    float a[4];
    if (kAT) {
      const float* p = A + (size_t)(k0 + t) * lda + r0 + g;
      a[0] = p[0];
      a[1] = p[8];
      a[2] = p[4 * lda];
      a[3] = p[4 * lda + 8];
    } else {
      const float* p = A + (size_t)(r0 + g) * lda + k0 + t;
      a[0] = p[0];
      a[1] = p[8 * lda];
      a[2] = p[4];
      a[3] = p[8 * lda + 4];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split(a[q], ah[q], al[q]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 8 * j + g;
      float b0, b1;
      if (kBT) {
        const float* p = B + (size_t)n * ldb + k0 + t;
        b0 = p[0];
        b1 = p[4];
      } else {
        const float* p = B + (size_t)(k0 + t) * ldb + n;
        b0 = p[0];
        b1 = p[4 * ldb];
      }
      uint32_t bh0, bl0, bh1, bl1;
      split(b0, bh0, bl0);
      split(b1, bh1, bl1);
      mma_tf32(c[j], ah, bh0, bh1);
      mma_tf32(x1[j], al, bh0, bh1);
      mma_tf32(x2[j], ah, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += x1[j][e] + x2[j][e];
}

// Sum over the tile's rows m < M (a multiple of 4) of f(m), in four
// interleaved partial sums: independent chains, a fixed order.
template <class Fn>
__device__ __forceinline__ float sum_rows(int M, const Fn& f) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 2
  for (int m = 0; m < M; m += 4) {
    s0 += f(m);
    s1 += f(m + 1);
    s2 += f(m + 2);
    s3 += f(m + 3);
  }
  return (s0 + s1) + (s2 + s3);
}

// The (row, col) of fragment element e of n-tile j in a 16 x 16 block.
__device__ __forceinline__ void frag_rc(int j, int e, int& r, int& c) {
  const int lane = threadIdx.x & 31;
  r = (lane >> 2) + (e >> 1) * 8;
  c = 8 * j + 2 * (lane & 3) + (e & 1);
}

// sin and cos of x: the angle reduced to [-pi, pi] by a two-constant
// Cody-Waite step (reduce_angle), then the SFU's __sincosf (absolute error
// about 4e-7 on that interval). CUDA's accurate sinf/cosf cost the
// backwards a third of their time; the gates hold the gradients to 2e-4
// of the plain version.
__device__ __forceinline__ float reduce_angle(float x) {
  const float k = rintf(x * 0.159154943091895336f);
  const float r = fmaf(k, -6.28318548202514648f, x);   // 2 pi rounded up
  return fmaf(k, 1.74845553146951724e-7f, r);          // its excess
}

__device__ __forceinline__ void fast_sincos(float x, float* s, float* c) {
  __sincosf(reduce_angle(x), s, c);
}

// The activations without a sine (march_common.cuh's): none, ReLU,
// sigmoid, softplus, and their derivatives.
__device__ __forceinline__ float act_plain(float x, int act) {
  return act == kReLU ? fmaxf(x, 0.0f)
         : act == kSigmoid ? sigmoid(x)
         : act == kSoftplus ? softplus(x) : x;
}

__device__ __forceinline__ float act_plain_deriv(float x, int act) {
  if (act == kReLU) return x > 0.0f ? 1.0f : 0.0f;
  if (act == kSigmoid) {
    const float s = sigmoid(x);
    return s * (1.0f - s);
  }
  return act == kSoftplus ? sigmoid(x) : 1.0f;
}

// activation and activation_deriv (march_common.cuh) with fast_sincos
// and the parameter's reciprocals from the host.
__device__ __forceinline__ float act_value(float x, const Dims& D) {
  float sn, cs;
  switch (D.act) {
    case kSine:
      fast_sincos(D.p * x, &sn, &cs);
      return sn;
    case kSnake:
      fast_sincos(D.p * x, &sn, &cs);
      return x + sn * sn * D.inv_p;
    case kSnakeAlt:
      fast_sincos(2.0f * D.p * x, &sn, &cs);
      return (x + 1.0f - cs) * D.inv_2p;
    default:
      return act_plain(x, D.act);
  }
}

__device__ __forceinline__ void activation_pair(float x, const Dims& D,
                                                float& v, float& d) {
  float sn, cs;
  switch (D.act) {
    case kSine:
      fast_sincos(D.p * x, &sn, &cs);
      v = sn;
      d = D.p * cs;
      break;
    case kSnake:
      fast_sincos(D.p * x, &sn, &cs);
      v = x + sn * sn * D.inv_p;
      d = 1.0f + 2.0f * sn * cs;
      break;
    case kSnakeAlt:
      fast_sincos(2.0f * D.p * x, &sn, &cs);
      v = (x + 1.0f - cs) * D.inv_2p;
      d = D.inv_2p + sn;
      break;
    default:
      v = act_plain(x, D.act);
      d = act_plain_deriv(x, D.act);
  }
}

// ---------------------------------------------------------------------------
// the tile's rows

// The first layer's input of the tile's rows [tile0, tile0 + M) of the
// list (`total` entries); rows past it are zero. `Src::pos(rl, j, x, d)`
// gives a sample's normalized position and its ray's direction.
template <int NTH, class Src>
__device__ __forceinline__ void build_rows(const Dims& D, const Smem& S, const Src& src,
                           int tile0, int total) {
  const int M = S.p.M, cnt = min(M, total - tile0);
  // each row's id, position and direction
  for (int m = threadIdx.x; m < M; m += NTH) {
    const bool on = m < cnt;
    const int e = on ? (int)S.list()[tile0 + m] : -1;
    S.rows()[m * kRowF + kRowId] = __int_as_float(e);
    float x[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    if (on) src.pos(e >> 5, e & 31, x, d);
    float* xr = S.X() + (size_t)m * S.p.ldx;
#pragma unroll
    for (int c = 0; c < 3; ++c) xr[D.pos + c] = x[c];
    if (D.dir >= 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) xr[D.dir + c] = D.has_dir ? d[c] : 0.0f;
    }
  }
  __syncthreads();
  // the Fourier features, then the latent features 4 channels a unit
  const int F = D.F;
  const int units = F + 4 * D.chunks;
#pragma unroll 1
  for (int it = threadIdx.x; it < M * units; it += NTH) {
    const int m = it % M, u = it / M;
    float* xr = S.X() + (size_t)m * S.p.ldx;
    const bool on = m < cnt;
    const float x0 = xr[D.pos], x1 = xr[D.pos + 1], x2 = xr[D.pos + 2];
    if (u < F) {
      float sn = 0.0f, cs = 0.0f;
      if (on) {
        float f = fourier_phase(S.B(), u, x0, x1, x2);
        if (D.has_dir)
          f += fourier_phase(S.Bd(), u, xr[D.dir], xr[D.dir + 1],
                             xr[D.dir + 2]);
        fast_sincos(f, &sn, &cs);
      }
      xr[D.cos + u] = cs;
      xr[D.sin + u] = sn;
    } else {
      const int q = (u - F) >> 2, hq = (u - F) & 3;
      float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f, l3 = 0.0f;
      if (on) {
        Corners cn;
        grid_corners(D.gx, D.gy, D.gz, x0, x1, x2, cn);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 v = table_quad(
              D.table, (cn.row[k] * D.chunks + q) * 4 + hq, D.table_bf16);
          l0 = fmaf(cn.w[k], v.x, l0);
          l1 = fmaf(cn.w[k], v.y, l1);
          l2 = fmaf(cn.w[k], v.z, l2);
          l3 = fmaf(cn.w[k], v.w, l3);
        }
      }
      float* o = xr + D.lat + kLat * q + 4 * hq;
      o[0] = l0;
      o[1] = l1;
      o[2] = l2;
      o[3] = l3;
    }
  }
  __syncthreads();
}

// The network on the tile: each layer's output into hbuf(l) (and, with
// `keep`, the activation's derivative into dbuf(l)), the head's input y
// into the rows.
template <int H, int NTH>
__device__ __forceinline__ void forward(const Dims& D, const Smem& S, bool keep) {
  const int M = S.p.M, warp = threadIdx.x >> 5, lda = S.p.lda;
  constexpr int kWarps = NTH / 32;
  SMLP_START(tf);
#pragma unroll 1
  for (int l = 0; l <= D.nh; ++l) {
    const float* A = l ? S.hbuf(l - 1) : S.X();
    const int la = l ? lda : S.p.ldx;
    const int K = l ? H : S.p.K8;
    const float* W = l ? S.Wh() + (size_t)(l - 1) * H * S.p.ldw : S.W1();
    const float* bias = l ? S.bh() + (l - 1) * H : S.b1();
    float* out = S.hbuf(l);
    float* dd = S.dbuf(l);
    const int rbs = M / 16, items = rbs * (H / 16);
#pragma unroll 1
    for (int it = warp; it < items; it += kWarps) {
      const int r0 = (it % rbs) * 16, n0 = (it / rbs) * 16;
      float c[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r, cc;
          frag_rc(j, e, r, cc);
          c[j][e] = bias[n0 + cc];
        }
      if constexpr (wide_width(H)) {
        // the hidden matrices from device memory, as they are packed
        if (l == 0)
          mma16x16<false, false>(c, A, la, r0, W, S.p.ldw, n0, K);
        else if (D.wg_om)
          mma16x16<false, true>(c, A, la, r0, D.Wg + (size_t)(l - 1) * H * H,
                                H, n0, K);
        else
          mma16x16<false, false>(c, A, la, r0,
                                 D.Wg + (size_t)(l - 1) * H * H, H, n0, K);
      } else {
        mma16x16<false, false>(c, A, la, r0, W, S.p.ldw, n0, K);
      }
      // the activation on the fragment: two neighbouring columns of a row
      // per (n-tile, half)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          int r, cc;
          frag_rc(j, e, r, cc);
          const size_t at = (size_t)(r0 + r) * lda + n0 + cc;
          float2 v, d;
          if (keep) {
            activation_pair(c[j][e], D, v.x, d.x);
            activation_pair(c[j][e + 1], D, v.y, d.y);
            *reinterpret_cast<float2*>(dd + at) = d;
          } else {
            v.x = act_value(c[j][e], D);
            v.y = act_value(c[j][e + 1], D);
          }
          *reinterpret_cast<float2*>(out + at) = v;
        }
    }
    __syncthreads();
    SMLP_MARK(tf, 12);
  }
  const float* hn = S.hbuf(D.nh);
#pragma unroll 1
  for (int e = threadIdx.x; e < M * D.n_out; e += NTH) {
    const int m = e / D.n_out, r = e % D.n_out;
    const float* w = S.Wo() + r * H;
    const float* x = hn + (size_t)m * lda;
    float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
    for (int i = 0; i < H; i += 4) {
      y0 = fmaf(w[i], x[i], y0);
      y1 = fmaf(w[i + 1], x[i + 1], y1);
      y2 = fmaf(w[i + 2], x[i + 2], y2);
      y3 = fmaf(w[i + 3], x[i + 3], y3);
    }
    S.rows()[m * kRowF + kRowY + r] = S.bo()[r] + ((y0 + y1) + (y2 + y3));
  }
  __syncthreads();
}

// fn(the TF the rows of mode TFM read): a piecewise or Gaussian TF above
// kTfStaged points in device memory (D.tfg), else the one staged in the
// vectors. Each call inlines its own copy of fn, so that the staged one
// reads shared memory as it would alone.
template <int TFM, class Fn>
__device__ __forceinline__ decltype(auto) with_tf(const Dims& D,
                                                  const Smem& S,
                                                  const Fn& fn) {
  if constexpr (TFM == kTfPiecewise || TFM == kTfGaussian) {
    if (D.tfg != nullptr) return fn(D.tfg);
  }
  return fn(static_cast<const float*>(S.TF()));
}

// Adjoint of tf_lookup (march_common.cuh's tf_adjoint) with the gradient
// of its two control points in g0, g1 (zeroed by the caller).
__device__ __forceinline__ float tf_adjoint_rows(const float* TF,
                                                 const TfSample& s, float d,
                                                 const float* dc, float* g0,
                                                 float* g1) {
  const float* c0 = TF + s.iv * 5;
  const float* c1 = c0 + 5;
  float d_frac = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    g0[q] += dc[q] * (1.0f - s.frac);
    g1[q] += dc[q] * s.frac;
    d_frac += dc[q] * (c1[q] - c0[q]);
  }
  if (!(d > c0[4] && d < c1[4])) return 0.0f;
  const float inv_dp = 1.0f / (c1[4] - c0[4]);
  g0[4] += d_frac * (s.frac - 1.0f) * inv_dp;
  g1[4] += -d_frac * s.frac * inv_dp;
  return d_frac * inv_dp;
}

// G (rows x cols) += A^T B over the tile's M rows: A (M x rows, leading
// dimension la) the layer's input, B (M x cols, leading dimension lb) its
// output's cotangent; rows and cols multiples of 16. Entry (k, n) for k <
// k_valid, n < n_valid is g[base + k * sk + n * sn]; the rest is dropped.
template <int NTH>
__device__ __forceinline__ void outer_grad(const Smem& S, const float* A,
                                           int la, int rows, int k_valid,
                                           const float* B, int lb, int cols,
                                           int n_valid, float* g, int base,
                                           int sk, int sn, int wofs = 0) {
  constexpr int kWarps = NTH / 32;
  const int warp = ((threadIdx.x >> 5) + wofs) % kWarps, rbs = rows / 16;
#pragma unroll 1
  for (int it = warp; it < rbs * (cols / 16); it += kWarps) {
    const int r0 = (it % rbs) * 16, n0 = (it / rbs) * 16;
    // the entries' running sums, loaded before the product (independent
    // loads, their latency under the mma)
    float old[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, cc;
        frag_rc(j, e, r, cc);
        old[j][e] = (r0 + r < k_valid && n0 + cc < n_valid)
                        ? g[base + (r0 + r) * sk + (n0 + cc) * sn] : 0.0f;
      }
    float c[2][4] = {};
    mma16x16<true, false>(c, A, la, r0, B, lb, n0, S.p.M);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, cc;
        frag_rc(j, e, r, cc);
        if (r0 + r < k_valid && n0 + cc < n_valid)
          g[base + (r0 + r) * sk + (n0 + cc) * sn] = old[j][e] + c[j][e];
      }
  }
}

// The biases' gradients, colsum of each layer's dZ over the tile's rows,
// as products 1^T dZ (the ones exact in TF32: two passes).
template <int H, int NTH>
__device__ __forceinline__ void bias_grad(const Dims& D, const Smem& S,
                                          const GOut& G, float* g) {
  constexpr int kWarps = NTH / 32, kCb = H / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  uint32_t ah[4] = {g8 == 0 ? to_tf32(1.0f) : 0u, 0u,
                    g8 == 0 ? to_tf32(1.0f) : 0u, 0u};
#pragma unroll 1
  for (int it = warp; it < (D.nh + 1) * kCb; it += kWarps) {
    const int l = it / kCb, n0 = (it % kCb) * 16;
    float* gb = g + (l ? G.bh + (l - 1) * H : G.b1) + n0;
    float old[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        old[j][e] = g8 == 0 ? gb[8 * j + 2 * t + e] : 0.0f;
    const float* dz = S.dbuf(l);
    float c[2][4] = {};
    for (int k0 = 0; k0 < S.p.M; k0 += 8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* p = dz + (size_t)(k0 + t) * S.p.lda + n0 + 8 * j + g8;
        uint32_t bh0, bl0, bh1, bl1;
        split(p[0], bh0, bl0);
        split(p[4 * S.p.lda], bh1, bl1);
        mma_tf32(c[j], ah, bl0, bl1);
        mma_tf32(c[j], ah, bh0, bh1);
      }
    }
    if (g8 == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gb[8 * j + 2 * t + e] = old[j][e] + c[j][e];
    }
  }
}

// out (M x cols, leading dimension lo) = dZ W^T, W stored [n][o] with
// leading dimension ldw (with `om`, the wide plan's output-major matrices
// in device memory, [o][n]); with `scale`, times scale elementwise (same
// layout as out).
template <int H, int NTH>
__device__ __forceinline__ void input_grad(const Smem& S, const float* dZ,
                                           const float* W, int cols,
                                           float* out, int lo,
                                           const float* scale, int ldw,
                                           bool om = false) {
  constexpr int kWarps = NTH / 32;
  const int warp = threadIdx.x >> 5, rbs = S.p.M / 16;
#pragma unroll 1
  for (int it = warp; it < rbs * (cols / 16); it += kWarps) {
    const int r0 = (it % rbs) * 16, n0 = (it / rbs) * 16;
    float c[2][4] = {};
    if constexpr (wide_width(H)) {
      if (om)
        mma16x16<false, false>(c, dZ, S.p.lda, r0, W, ldw, n0, H);
      else
        mma16x16<false, true>(c, dZ, S.p.lda, r0, W, ldw, n0, H);
    } else {
      mma16x16<false, true>(c, dZ, S.p.lda, r0, W, ldw, n0, H);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, cc;
        frag_rc(j, e, r, cc);
        const size_t a = (size_t)(r0 + r) * lo + n0 + cc;
        out[a] = scale ? c[j][e] * scale[a] : c[j][e];
      }
  }
}

// The TF gradient of the tile's rows in mode TFM (texture, preint1d:
// each texel's thread over the rows' records; Gaussians: each entry's
// thread, the weights recomputed), added into the partial row: every
// entry owned by one thread, the rows in order. preint2d's goes by atomics
// (tf_color_adjoint).
template <int NTH, int TFM>
__device__ __forceinline__ void tf_mode_grad(const Dims& D, const Smem& S,
                                             const GOut& G, float* g) {
  const int M = S.p.M;
  if constexpr (TFM == kTfGaussian) {
    with_tf<TFM>(D, S, [&](const float* T) {
#pragma unroll 1
      for (int e = threadIdx.x; e < 6 * D.tp; e += NTH) {
        const int q = e / 6, c = e % 6;
        const float* gq = T + 6 * q;
        const float s2 = gq[5] * gq[5];
        float acc = 0.0f;
#pragma unroll 1
        for (int m = 0; m < M; ++m) {
          const float* rw = S.rows() + m * kRowF;
          if (rw[kRecLo1] < 0.0f) continue;
          const float* df = rw + kRecDc;
          const float u = rw[kRecF1] - gq[4];
          const float w = expf(-(u * u) / s2);
          if (c < 4) {
            acc += w * df[c];
          } else {
            const float core = (gq[0] * df[0] + gq[1] * df[1] + gq[2] * df[2]
                                + gq[3] * df[3]) * w;
            const float t = 2.0f * core * (u / s2);
            acc += c == 4 ? t : t * u / gq[5];
          }
        }
        g[G.TF + e] += acc;
      }
    });
  } else if constexpr (TFM == kTfTexture || TFM == kTfPreint1d) {
    const int rows = D.tp + (TFM == kTfPreint1d ? D.tpre : 0);
#pragma unroll 1
    for (int q = threadIdx.x; q < rows; q += NTH) {
      const float fq = (float)q;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 1
      for (int m = 0; m < M; ++m) {
        const float* rw = S.rows() + m * kRowF;
        if (rw[kRecLo1] < 0.0f) continue;
        float w = 0.0f;
        if (rw[kRecLo1] == fq) w += 1.0f - rw[kRecF1];
        if (rw[kRecHi1] == fq) w += rw[kRecF1];
        if (rw[kRecLo2] >= 0.0f) {
          if (rw[kRecLo2] == fq) w -= 1.0f - rw[kRecF2];
          if (rw[kRecHi2] == fq) w -= rw[kRecF2];
        }
        if (w != 0.0f) {
          a0 = fmaf(w, rw[kRecDc], a0);
          a1 = fmaf(w, rw[kRecDc + 1], a1);
          a2 = fmaf(w, rw[kRecDc + 2], a2);
          a3 = fmaf(w, rw[kRecDc + 3], a3);
        }
      }
      float* gq = g + G.TF + 4 * q;
      gq[0] += a0;
      gq[1] += a1;
      gq[2] += a2;
      gq[3] += a3;
    }
  }
}

// The tile's adjoint, the rows' cotangent dy set: every gradient of the
// tile added into the block's partial row, the latent's into d_table.
template <int H, int NTH, int TFM = kTfPiecewise>
__device__ __forceinline__ void backward(const Dims& D, const Smem& S,
                                         const GOut& G, float* g) {
  SMLP_START(tb);
  const int M = S.p.M, lda = S.p.lda, nh = D.nh, n_out = D.n_out;
  // the output rows, and the last layer's pre-activation cotangent
  const float* hn = S.hbuf(nh);
  float* dn = S.dbuf(nh);
#pragma unroll 1
  for (int e = threadIdx.x; e < M * H; e += NTH) {
    const int m = e / H, i = e % H;
    const float* dy = S.rows() + m * kRowF + kRowDy;
    float s = 0.0f;
    for (int r = 0; r < n_out; ++r) s = fmaf(dy[r], S.Wo()[r * H + i], s);
    dn[(size_t)m * lda + i] *= s;
  }
#pragma unroll 1
  for (int e = threadIdx.x; e < n_out * (H + 1); e += NTH) {
    const int r = e < n_out * H ? e / H : e - n_out * H, i = e % H;
    float* ge = g + (e < n_out * H ? G.Wo + r * G.Wo_r + i : G.bo + r);
    const float old = *ge;
    *ge = old + (e < n_out * H
                     ? sum_rows(M, [&](int m) {
                         return S.rows()[m * kRowF + kRowDy + r]
                                * hn[(size_t)m * lda + i];
                       })
                     : sum_rows(M, [&](int m) {
                         return S.rows()[m * kRowF + kRowDy + r];
                       }));
  }
  __syncthreads();
  SMLP_MARK(tb, 7);
  // hidden layers, last first
#pragma unroll 1
  for (int l = nh; l >= 1; --l) {
    const bool wg = wide_width(H);
    const float* W = wg ? D.Wg + (size_t)(l - 1) * H * H
                        : S.Wh() + (size_t)(l - 1) * H * S.p.ldw;
    outer_grad<NTH>(S, S.hbuf(l - 1), lda, H, H, S.dbuf(l), lda, H, H, g,
                    G.Wh + (l - 1) * G.Wh_l, G.Wh_i, G.Wh_o);
    input_grad<H, NTH>(S, S.dbuf(l), W, H, S.dbuf(l - 1), lda,
                       S.dbuf(l - 1), wg ? H : S.p.ldw, wg && D.wg_om);
    __syncthreads();
  }
  SMLP_MARK(tb, 8);
  // the first layer; its input cotangent over the (dead) outputs
  outer_grad<NTH>(S, S.X(), S.p.ldx, S.p.K16, D.K1, S.dbuf(0), lda, H, H, g, G.W1,
                  G.W1_k, G.W1_o);
  input_grad<H, NTH>(S, S.dbuf(0), S.W1(), S.p.K16, S.hreg(), S.p.ldx,
                     nullptr, S.p.ldw);
  __syncthreads();
  SMLP_MARK(tb, 9);
  // the Fourier phases' cotangent d_f = cos d_sin - sin d_cos, over d_cos
  float* dX = S.hreg();
  const int F = D.F;
#pragma unroll 1
  for (int e = threadIdx.x; e < M * F; e += NTH) {
    const int m = e / F, i = e % F;
    const float* xr = S.X() + (size_t)m * S.p.ldx;
    float* dr = dX + (size_t)m * S.p.ldx;
    dr[D.cos + i] = xr[D.cos + i] * dr[D.sin + i]
                    - xr[D.sin + i] * dr[D.cos + i];
  }
  __syncthreads();
  // biases; d_B (d_Bd) = d_f^T x (d_f^T d) over the rows; TF
  bias_grad<H, NTH>(D, S, G, g);
  if (F > 0) {
    const int f16 = round_up(F, 16);
    // on the last warps (the biases' items start at warp 0)
    outer_grad<NTH>(S, dX + D.cos, S.p.ldx, f16, F, S.X() + D.pos, S.p.ldx,
                    16, 3, g, G.B, 3, 1, 1);
    if (G.Bd >= 0)
      outer_grad<NTH>(S, dX + D.cos, S.p.ldx, f16, F, S.X() + D.dir,
                      S.p.ldx, 16, 3, g, G.Bd, 3, 1, 3);
  }
  if constexpr (TFM != kTfPiecewise) {
    tf_mode_grad<NTH, TFM>(D, S, G, g);
  } else if (D.head < kRgbo) {
    // eight lanes an entry, each over every eighth row, then a fixed
    // shuffle tree
    const int lane = threadIdx.x & 31, sub = lane & 7;
    const int n_tf = 5 * D.tp;
#pragma unroll 1
    for (int b = (threadIdx.x >> 5) * 4; b < n_tf; b += NTH / 8) {
      const int f = b + (lane >> 3), q = f / 5, c = f % 5;
      const bool on = f < n_tf;
      const float old = (on && sub == 0) ? g[G.TF + f] : 0.0f;
      float sm = 0.0f;
      for (int m = sub; on && m < M; m += 8) {
        const float* rw = S.rows() + m * kRowF;
        const int iv = (int)rw[kRowIv];
        sm += iv == q ? rw[kRowG0 + c] : (iv + 1 == q ? rw[kRowG1 + c]
                                                      : 0.0f);
      }
      sm += __shfl_xor_sync(0xffffffffu, sm, 1);
      sm += __shfl_xor_sync(0xffffffffu, sm, 2);
      sm += __shfl_xor_sync(0xffffffffu, sm, 4);
      if (on && sub == 0) g[G.TF + f] = old + sm;
    }
  }
  __syncthreads();
  SMLP_MARK(tb, 14);
  // the latent features: the trilinear adjoint, 4 channels a unit
#pragma unroll 1
  for (int it = threadIdx.x; it < M * D.chunks * 4; it += NTH) {
    const int m = it % M, u = it / M, q = u >> 2, hq = u & 3;
    if (__float_as_int(S.rows()[m * kRowF + kRowId]) < 0) continue;
    if (4 * hq >= D.n_lat - kLat * q) continue;
    const float* xr = S.X() + (size_t)m * S.p.ldx;
    const float* d = dX + (size_t)m * S.p.ldx + D.lat + kLat * q + 4 * hq;
    Corners cn;
    grid_corners(D.gx, D.gy, D.gz, xr[D.pos], xr[D.pos + 1], xr[D.pos + 2],
                 cn);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = cn.w[k];
      atomicAdd(reinterpret_cast<float4*>(D.d_table
                                          + (cn.row[k] * D.chunks + q) * kLat)
                    + hq,
                make_float4(w * d[0], w * d[1], w * d[2], w * d[3]));
    }
  }
  __syncthreads();
  SMLP_MARK(tb, 10);
}

// The ray gradients of the adjoint tile's rows (`Src::kRayGrads`), after
// backward(): each row's cotangent of its normalized position x = (start
// + t dir - bmin) / bsize, the first layer's position rows plus the
// Fourier phases' B^T d_f plus the trilinear fetch's position derivative
// (trilerp_position_grad against the table as the replay read it), and
// of the direction input, its own rows plus Bd^T d_f. Per ray of group
// `gw`, in row order, the sums of d_x, of d_x t and of the direction's go
// to `src.add_ray` (d_start = sum d_x / bsize, d_dir = sum d_x t / bsize
// + the direction's). Reads X and dX (hreg) as backward() left them and
// overwrites each row's first nine dX columns; ends with a barrier.
template <int NTH, class Src>
__device__ __forceinline__ void ray_fold(const Dims& D, const Smem& S,
                                         const Src& src, int gw) {
  const int M = S.p.M, F = D.F;
  float* dX = S.hreg();
#pragma unroll 1
  for (int m = threadIdx.x; m < M; m += NTH) {
    const int e = __float_as_int(S.rows()[m * kRowF + kRowId]);
    if (e < 0) continue;
    const float* xr = S.X() + (size_t)m * S.p.ldx;
    float* dr = dX + (size_t)m * S.p.ldx;
    float gp[3], gd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gp[c] = dr[D.pos + c];
      if (D.has_dir) gd[c] = dr[D.dir + c];
    }
#pragma unroll 1
    for (int i = 0; i < F; ++i) {
      const float df = dr[D.cos + i];   // backward()'s d_f
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gp[c] = fmaf(S.B()[3 * i + c], df, gp[c]);
        if (D.has_dir) gd[c] = fmaf(S.Bd()[3 * i + c], df, gd[c]);
      }
    }
    if (D.n_lat > 0) {
      const float x0 = xr[D.pos], x1 = xr[D.pos + 1], x2 = xr[D.pos + 2];
      Corners cn;
      grid_corners(D.gx, D.gy, D.gz, x0, x1, x2, cn);
      int lo, hi;
      float fx, fy, fz;
      corner_axis(x0, D.gx, lo, hi, fx);
      corner_axis(x1, D.gy, lo, hi, fy);
      corner_axis(x2, D.gz, lo, hi, fz);
      float sk[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sk[k] = 0.0f;
#pragma unroll 1
      for (int u = 0; u < 4 * D.chunks; ++u) {
        const int q = u >> 2, hq = u & 3;
        const float* d = dr + D.lat + kLat * q + 4 * hq;
        const float d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 v = table_quad(
              D.table, (size_t)(cn.row[k] * D.chunks + q) * 4 + hq,
              D.table_bf16);
          sk[k] = fmaf(d0, v.x, fmaf(d1, v.y, fmaf(d2, v.z,
                                                   fmaf(d3, v.w, sk[k]))));
        }
      }
      trilerp_position_grad(sk, fx, fy, fz, D.gx, D.gy, D.gz, gp);
    }
    const float t = src.t(e & 31);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dr[c] = gp[c];
      dr[3 + c] = gp[c] * t;
      dr[6 + c] = gd[c];
    }
  }
  __syncthreads();
  if ((threadIdx.x >> 5) == gw) {
    const int lane = threadIdx.x & 31;
    float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool any = false;
#pragma unroll 1
    for (int m = 0; m < M; ++m) {
      const int e = __float_as_int(S.rows()[m * kRowF + kRowId]);
      if (e < 0 || (e >> 5) != lane) continue;
      const float* dr = dX + (size_t)m * S.p.ldx;
#pragma unroll
      for (int c = 0; c < 9; ++c) acc[c] += dr[c];
      any = true;
    }
    if (any) src.add_ray(gw * kGroup + lane, acc);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// one group of rays through one segment

// A sample's color and absorption from the head's values v (rgbo heads:
// their own; density heads: the TF at the normalized density). False when
// it does not count (a density below density_min). As segment_common.cuh's
// sample_color.
__device__ __forceinline__ bool row_color(const Dims& D, const Smem& S,
                                          const float* v, float* c,
                                          TfSample& tf) {
  if (D.head >= kRgbo) {
    c[0] = v[0];
    c[1] = v[1];
    c[2] = v[2];
    c[3] = v[3] * D.h;
    return true;
  }
  if (!(v[0] >= D.density_min)) return false;
  const float d = fminf(fmaxf((v[0] - D.density_min) * D.inv_range, 0.0f),
                        1.0f);
  with_tf<kTfPiecewise>(D, S, [&](const float* T) {
    tf_lookup(T, D.tp, d, tf);
  });
  c[0] = tf.r;
  c[1] = tf.g;
  c[2] = tf.b;
  c[3] = tf.op * D.h;
  return true;
}

__device__ __forceinline__ float row_alpha(const Dims& D, float absn) {
  return D.blend_alpha ? fminf(1.0f, absn) : 1.0f - expf(-absn);
}

// The list of the group's rays' samples in `mask` (one mask a lane of the
// owning warp), ray by ray; returns the count (all lanes of that warp).
__device__ __forceinline__ int list_samples(const Smem& S, uint32_t mask) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(mask);
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int at = incl - n;
  while (mask) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    S.list()[at++] = (uint16_t)((lane << 5) | j);
  }
  return __shfl_sync(0xffffffffu, incl, 31);
}

// One segment of one group: the replay, the reverse recurrence and the
// adjoint (see the file's head). The group's rays are the lanes of warp
// `gw`; on those lanes `valid` is the ray's valid samples in the segment,
// `alpha0` the stored carry's alpha entering it, (dr, dg, db) the ray's
// rgb cotangent and `da` its alpha cotangent, carried to the segment's
// start. The caller has staged S.sray() for `src`. Returns (on thread 0)
// the samples replayed and contributing through n_rep, n_con.
template <int H, int NTH, class Src>
__device__ __forceinline__ void group_segment(const Dims& D, const Smem& S,
                                              const GOut& G, float* g,
                                              const Src& src, int gw,
                                              uint32_t valid,
                              float alpha0, float dr, float dg, float db,
                              float& da, unsigned& n_rep, unsigned& n_con) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, M = S.p.M;
  if (warp == gw) {
    S.counted()[lane] = 0u;
    S.contrib()[lane] = 0u;
    float* rr = S.sray() + lane * kRayF;   // the ray's rgb cotangent
    rr[9] = dr;
    rr[10] = dg;
    rr[11] = db;
    const int n = list_samples(S, valid);
    if (lane == 0) S.misc()[0] = n;
  }
  __syncthreads();
  const int n_valid = S.misc()[0];
  if (threadIdx.x == 0) n_rep += n_valid;

  // A. the replay
  SMLP_START(tg);
#pragma unroll 1
  for (int tile0 = 0; tile0 < n_valid; tile0 += M) {
    build_rows<NTH>(D, S, src, tile0, n_valid);
    SMLP_MARK(tg, 0);
    forward<H, NTH>(D, S, false);
    SMLP_MARK(tg, 1);
    for (int m = threadIdx.x; m < min(M, n_valid - tile0); m += NTH) {
      const float* rw = S.rows() + m * kRowF;
      const int e = __float_as_int(rw[kRowId]), rl = e >> 5, j = e & 31;
      float v[4], c[4];
      head_value(D.head, rw + kRowY, v);
      TfSample tf;
      if (!row_color(D, S, v, c, tf)) continue;
      // what the recurrence reads: the color against the ray's rgb
      // cotangent, and the absorption
      const float* rr = S.sray() + rl * kRayF;
      S.sc()[j * kGroup + rl] = rr[9] * c[0] + rr[10] * c[1] + rr[11] * c[2];
      S.sc()[kGroup * kSegMax + j * kGroup + rl] = c[3];
      atomicOr(S.counted() + rl, 1u << j);
      if (c[3] > 0.0f) atomicOr(S.contrib() + rl, 1u << j);
    }
    __syncthreads();
    SMLP_MARK(tg, 2);
  }

  // B. the reverse compositing recurrence, per ray
  if (warp == gw) {
    const uint32_t counted = S.counted()[lane], contrib = S.contrib()[lane];
    float* sd = S.sc() + lane;            // dr r + dg g + db b, then w
    float* sa = sd + kGroup * kSegMax;    // absorption, then its cotangent
    // the alpha entering each sample, over the tile buffers (no tile is
    // in flight; dact and hreg hold at least 2 * 16 * 36 floats)
    float* ain = S.dact() + lane;
    float alpha = alpha0;
#pragma unroll 1
    for (int j = 0; j < kSegMax; ++j) {
      ain[j * kGroup] = alpha;
      if ((counted >> j) & 1u)
        alpha = alpha + (1.0f - alpha) * row_alpha(D, sa[j * kGroup]);
    }
#pragma unroll 1
    for (int j = kSegMax - 1; j >= 0; --j) {
      if (!((contrib >> j) & 1u)) continue;
      const int o = j * kGroup;
      const float absn = sa[o];
      const float a = row_alpha(D, absn);
      const float trans = 1.0f - ain[o];
      const float dw = sd[o] + da;
      const float w = trans * a;
      const float d_ca = trans * dw;
      da = da - a * dw;
      const float d_absn = D.blend_alpha ? (absn < 1.0f ? d_ca : 0.0f)
                                         : d_ca * expf(-absn);
      sd[o] = w;
      sa[o] = d_absn * D.h;
    }
    const int n = list_samples(S, contrib);
    if (lane == 0) S.misc()[1] = n;
  }
  __syncthreads();
  SMLP_MARK(tg, 3);
  const int n_c = S.misc()[1];
  if (threadIdx.x == 0) n_con += n_c;

  // C. the adjoint
#pragma unroll 1
  for (int tile0 = 0; tile0 < n_c; tile0 += M) {
    build_rows<NTH>(D, S, src, tile0, n_c);
    SMLP_MARK(tg, 4);
    forward<H, NTH>(D, S, true);
    SMLP_MARK(tg, 5);
    for (int m = threadIdx.x; m < M; m += NTH) {
      float* rw = S.rows() + m * kRowF;
      const int e = __float_as_int(rw[kRowId]);
      float dy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float g0[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float g1[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      int iv = -2;
      if (e >= 0) {
        const int rl = e >> 5, j = e & 31;
        const float* y = rw + kRowY;
        float v[4];
        head_value(D.head, y, v);
        const float* rr = S.sray() + rl * kRayF;
        const float w = S.sc()[j * kGroup + rl];
        float d_v[4] = {w * rr[9], w * rr[10], w * rr[11],
                        S.sc()[kGroup * kSegMax + j * kGroup + rl]};
        if (D.head < kRgbo) {
          const float density2 = (v[0] - D.density_min) * D.inv_range;
          const float d = fminf(fmaxf(density2, 0.0f), 1.0f);
          TfSample tf;
          const float d_d =
              with_tf<kTfPiecewise>(D, S, [&](const float* T) {
                tf_lookup(T, D.tp, d, tf);
                return tf_adjoint_rows(T, tf, d, d_v, g0, g1);
              });
          iv = tf.iv;
          d_v[0] = (density2 > 0.0f && density2 < 1.0f) ? d_d * D.inv_range
                                                          : 0.0f;
        }
        head_adjoint(D.head, y, v, d_v, dy);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) rw[kRowDy + q] = dy[q];
      rw[kRowIv] = (float)iv;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        rw[kRowG0 + q] = g0[q];
        rw[kRowG1 + q] = g1[q];
      }
    }
    __syncthreads();
    SMLP_MARK(tg, 6);
    backward<H, NTH>(D, S, G, g);
    if constexpr (Src::kRayGrads) ray_fold<NTH>(D, S, src, gw);
    SMLP_MARK(tg, 11);
  }
}

// One segment of one group in TF mode TFM (texture, preint1d, preint2d,
// Gaussians; density heads), as group_segment with the previous-density
// chain: `first` marks each lane's ray's first lattice sample, `pin` its
// incoming density (the stored carry's), `dpc` the cotangent of the
// density its next segment read as its previous one, carried to the
// segment's start. The replay (A) keeps each valid sample's density; the
// group's warp then takes the colors in sample order (each reads its
// predecessor's density), the reverse recurrence (B), and the TF adjoint
// in reverse (each sample's density cotangent: its own TF's, gated inside
// (0, 1), plus, unclipped, what the next sample's TF read of it). The
// adjoint (C) runs over the samples whose density has a cotangent (a
// sample that does not count still passes the chain), and their TF
// records go into the table's gradient. preint2d's cells take no density
// cotangent: its table's gradient goes by atomics, and no sample reaches
// the network. The samples of `donly` (a lane's ray with no valid sample
// here) are replayed for their density alone: the next segment's first
// sample may have read it (mega_fwd.cu), and its cotangent then reaches
// the network there.
template <int H, int NTH, class Src, int TFM>
__device__ __forceinline__ void group_segment_tf(
    const Dims& D, const Smem& S, const GOut& G, float* g, const Src& src,
    int gw, uint32_t valid, uint32_t first, float pin, float alpha0,
    float dr, float dg, float db, float& da, float& dpc, unsigned& n_rep,
    unsigned& n_con, uint32_t donly = 0u) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, M = S.p.M;
  constexpr int kGS = kGroup * kSegMax;
  if (warp == gw) {
    S.counted()[lane] = 0u;
    S.contrib()[lane] = 0u;
    S.valid()[lane] = valid;
    S.first()[lane] = first;
    S.pin()[lane] = pin;
    float* rr = S.sray() + lane * kRayF;   // the ray's rgb cotangent
    rr[9] = dr;
    rr[10] = dg;
    rr[11] = db;
    const int n = list_samples(S, valid | donly);
    if (lane == 0) S.misc()[0] = n;
  }
  __syncthreads();
  const int n_valid = S.misc()[0];
  if (threadIdx.x == 0) n_rep += n_valid;

  // A. the replay: each listed sample's normalized density
#pragma unroll 1
  for (int tile0 = 0; tile0 < n_valid; tile0 += M) {
    build_rows<NTH>(D, S, src, tile0, n_valid);
    forward<H, NTH>(D, S, false);
    for (int m = threadIdx.x; m < min(M, n_valid - tile0); m += NTH) {
      const float* rw = S.rows() + m * kRowF;
      const int e = __float_as_int(rw[kRowId]);
      float v[4];
      head_value(D.head, rw + kRowY, v);
      S.dens()[(e & 31) * kGroup + (e >> 5)] =
          (v[0] - D.density_min) * D.inv_range;
    }
    __syncthreads();
  }

  // the colors, B. the reverse recurrence, the TF adjoint: per ray
  if (warp == gw) {
    const float* rr = S.sray() + lane * kRayF;
    const float cr = rr[9], cg = rr[10], cb = rr[11];
    float* sd = S.sc() + lane;            // dr r + dg g + db b, then w
    float* sa = sd + kGS;                 // absorption, then its cotangent
    const float* dn = S.dens() + lane;
    float* dd = S.ddens() + lane;
    uint32_t counted = 0u, contrib = 0u;
    float prev = pin;
#pragma unroll 1
    for (uint32_t m = valid; m; m &= m - 1) {
      const int j = __ffs(m) - 1, o = j * kGroup;
      if ((first >> j) & 1u) prev = -1.0f;
      const float d2 = dn[o];
      if (d2 >= 0.0f) {                  // the value reaches density_min
        const float4 c = with_tf<TFM>(D, S, [&](const float* T) {
          return tf_color<TFM>(T, D.tf2d, D.tp, D.tpre, fminf(d2, 1.0f),
                               prev, D.h);
        });
        sd[o] = cr * c.x + cg * c.y + cb * c.z;
        sa[o] = c.w;
        counted |= 1u << j;
        if (c.w > 0.0f) contrib |= 1u << j;
      }
      prev = d2;
    }
    float* ain = S.dact() + lane;
    float alpha = alpha0;
#pragma unroll 1
    for (int j = 0; j < kSegMax; ++j) {
      ain[j * kGroup] = alpha;
      if ((counted >> j) & 1u)
        alpha = alpha + (1.0f - alpha) * row_alpha(D, sa[j * kGroup]);
    }
#pragma unroll 1
    for (int j = kSegMax - 1; j >= 0; --j) {
      if (!((contrib >> j) & 1u)) continue;
      const int o = j * kGroup;
      const float absn = sa[o];
      const float a = row_alpha(D, absn);
      const float trans = 1.0f - ain[o];
      const float dw = sd[o] + da;
      da = da - a * dw;
      sd[o] = trans * a;
      sa[o] = D.blend_alpha ? (absn < 1.0f ? trans * dw : 0.0f)
                            : trans * dw * expf(-absn);
    }
    // the TF adjoint and the density chain, last sample first. preint2d:
    // the ray's consecutive samples in one cell add in registers and the
    // run reaches the table by one atomic (where the density varies
    // slowly most samples share a few cells, and an atomic a sample adds
    // terms below the float32 resolution of the cell's large sum)
    uint32_t need = 0u;
    float chain = dpc;
    const uint32_t listed = valid | donly;
    int run_cell = -1;
    float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
    for (int j = kSegMax - 1; j >= 0; --j) {
      if (!((listed >> j) & 1u)) continue;
      const int o = j * kGroup;
      const float d2 = dn[o];
      float own = 0.0f, d_prev = 0.0f;
      if ((contrib >> j) & 1u) {
        const float p = ((first >> j) & 1u) ? -1.0f
                        : (j > 0 && ((valid >> (j - 1)) & 1u)) ? dn[o - kGroup]
                                                               : pin;
        const float w = sd[o];
        const float dc = fminf(fmaxf(d2, 0.0f), 1.0f);
        const float4 dcol = make_float4(w * cr, w * cg, w * cb, sa[o]);
        if constexpr (TFM == kTfPreint2d) {
          int c;
          const float4 g2 = preint2d_cell_grad(D.tf2d, D.tp, dc, p, dcol, c);
          if (c != run_cell) {
            if (run_cell >= 0) atomicAdd(D.d_tf2d + run_cell, run);
            run_cell = c;
            run = g2;
          } else {
            run.x += g2.x;
            run.y += g2.y;
            run.z += g2.z;
            run.w += g2.w;
          }
        } else {
          TfRecord rec;
          own = with_tf<TFM>(D, S, [&](const float* T) {
            return tf_color_adjoint<TFM>(T, D.tf2d, D.d_tf2d, D.tp, D.tpre,
                                         dc, p, D.h, dcol, d_prev, rec);
          });
        }
      }
      const float tot = ((d2 > 0.0f && d2 < 1.0f) ? own : 0.0f) + chain;
      dd[o] = tot;
      if (tot != 0.0f || ((contrib >> j) & 1u)) need |= 1u << j;
      chain = d_prev;
    }
    if (TFM == kTfPreint2d && run_cell >= 0)
      atomicAdd(D.d_tf2d + run_cell, run);
    if (listed) dpc = chain;
    if (TFM == kTfPreint2d) need = 0u;
    S.contrib()[lane] = contrib;
    const int n = list_samples(S, need);
    if (lane == 0) S.misc()[1] = n;
  }
  __syncthreads();
  const int n_c = S.misc()[1];
  if (threadIdx.x == 0) n_con += n_c;

  // C. the adjoint
#pragma unroll 1
  for (int tile0 = 0; tile0 < n_c; tile0 += M) {
    build_rows<NTH>(D, S, src, tile0, n_c);
    forward<H, NTH>(D, S, true);
    for (int m = threadIdx.x; m < M; m += NTH) {
      float* rw = S.rows() + m * kRowF;
      const int e = __float_as_int(rw[kRowId]);
      float dy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      TfRecord rec;
      rec.lo1 = rec.lo2 = -1.0f;
      rec.hi1 = rec.hi2 = rec.f1 = rec.f2 = 0.0f;
      rec.dc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e >= 0) {
        const int rl = e >> 5, j = e & 31, o = j * kGroup + rl;
        const float* y = rw + kRowY;
        float v[4];
        head_value(D.head, y, v);
        if ((S.contrib()[rl] >> j) & 1u) {
          const uint32_t vm = S.valid()[rl];
          const float* dn = S.dens();
          const float p = ((S.first()[rl] >> j) & 1u) ? -1.0f
                          : (j > 0 && ((vm >> (j - 1)) & 1u))
                              ? dn[o - kGroup] : S.pin()[rl];
          const float* rr = S.sray() + rl * kRayF;
          const float w = S.sc()[o];
          float d_prev;
          with_tf<TFM>(D, S, [&](const float* T) {
            tf_color_adjoint<TFM>(
                T, D.tf2d, D.d_tf2d, D.tp, D.tpre,
                fminf(fmaxf(dn[o], 0.0f), 1.0f), p, D.h,
                make_float4(w * rr[9], w * rr[10], w * rr[11],
                            S.sc()[kGS + o]),
                d_prev, rec);
          });
          if (TFM == kTfGaussian) rec.lo1 = 0.0f;
        }
        const float d_v[4] = {S.ddens()[o] * D.inv_range, 0.0f, 0.0f, 0.0f};
        head_adjoint(D.head, y, v, d_v, dy);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) rw[kRowDy + q] = dy[q];
      rw[kRecLo1] = rec.lo1;
      rw[kRecHi1] = rec.hi1;
      rw[kRecF1] = rec.f1;
      rw[kRecDc] = rec.dc.x;
      rw[kRecDc + 1] = rec.dc.y;
      rw[kRecDc + 2] = rec.dc.z;
      rw[kRecDc + 3] = rec.dc.w;
      rw[kRecLo2] = rec.lo2;
      rw[kRecHi2] = rec.hi2;
      rw[kRecF2] = rec.f2;
    }
    __syncthreads();
    backward<H, NTH, TFM>(D, S, G, g);
    if constexpr (Src::kRayGrads) ray_fold<NTH>(D, S, src, gw);
  }
}

}  // namespace smlp
