// The per-segment fused march, forward (sm_90a): the kernels, included by
// segment_fwd.cu (the render and the training forward) and
// segment_fwd_nrm.cu (the normals instances), each its own library so that
// nvcc builds them in parallel.
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_dvr.py:_segment_kernel as
// fused_trace_dvr launches it (differentiable=False) and as the forward of
// fvsrn_tpu/ops/fused_dvr_bwd.py:make_segment_op launches it inside the
// differentiable scan: every network the SRN takes (any activation, the
// five output heads, direction input, no latent grid, a grid of <= 16
// channels as a bf16 or float32 table, or more than 16 channels in
// float32), per-ray sampling t = tmin + k*h or the lattice t = k*h from the
// ray tile's base, the TF (piecewise-linear, texture, 1D- or
// 2D-preintegrated, Gaussians) or the rgbo heads' own color, Beer-Lambert
// or alpha blending, and the isosurface first-hit epilogue. The TF modes
// other than piecewise are template instances of SnakeAlt networks (the
// activation a template parameter too; segment_fwd_tf.cu), and of every
// other activation (the generic switch): the texture, 1D- and
// 2D-preintegrated TFs (segment_fwd_anytf.cu) and the Gaussians
// (segment_fwd_anyg.cu, the training forward's: the render refuses
// Gaussians on these networks); they carry each ray's last normalized density besides its rgba, across
// segments and into phase 1 (`dens`), and store it with the carries for
// training.
//
// The differentiable march has no early-out (early_alpha = 2: every ray
// runs until its segment start passes tmax), so it is phase 0 alone, which
// then also stores the carry entering each segment a ray runs, (n_seg, R)
// float4, as the backward's residual (the TPU scan keeps the (8, R) carry
// of every segment).
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
// Layout: a warp owns 32 consecutive rays of the caller's order (lane =
// ray) and marches them on its own, segment by segment, while any of them
// is alive; the block's warps (8, 4, 2 or 1, as the shared-memory plan
// allows) share the staged weights. Per segment, warp_mlp.cuh: the live
// rays' valid samples listed ray by ray, evaluated as tiles of 32 rows
// with every layer a TF32 three-pass mma.sync product, composited in
// order by a segmented scan over the tile. Only valid samples of live rays
// become rows, so lanes that died or whose samples lie past tmax cost
// nothing, and phase 1's few continuing rays fill whole tiles. The iso
// epilogue takes a ray's first listed row above the isovalue; rows after
// it are evaluated and ignored, and samples are counted up to the hit.
// The hidden width is a template parameter (32, 48 or 64; narrower
// networks are zero-padded by the wrapper, which is exact; 128, the wide
// plan of warp_mlp.cuh, in the *128.cu libraries), the latent
// table type too; the activation is a switch outside the tile's layers
// (one instance of the layer chain each), the head a runtime switch.
// The normals instances (segment_nrm_kernel, in segment_fwd_nrm.cu's
// library) replace the JAX kernel with need_normals and a BRDF: each
// counting sample's position gradient (position_grad.cuh), shading, and
// its normal and depth blended with the colour's weights, carried across
// the two phases like the colour.
//
// Bound: operations. A sample of the dense flagship costs ~7.6 kFLOP
// (the MLP's multiply-adds, trilerp, TF) and ~110 transcendentals against
// 32 bytes of ray data per ray; the table stays in L2. The products run at
// three TF32 tensor-core passes each (float32-accurate); the activations,
// Fourier features and latent fetch stay on the CUDA cores and the SFU.

#pragma once

#include <climits>

#include "position_grad.cuh"
#include "segment_tile.cuh"

namespace {

using namespace march;
using namespace segment;
using namespace wmlp;

constexpr int kThreads = kMaxWarps * kRows;   // the largest block

struct SegOut {
  float4* out;                 // (R,) rgba, or (depth, 0, 0, found) for iso
  int* death;                  // (R,) segment at which the ray died
  unsigned long long* stats;   // [stop segment S, samples evaluated]
  float4* carries;             // (n_seg, R) carry entering each segment the
                               // ray runs (phase 0), or null
  float* dens;                 // (R,) last density at death (TF modes)
  float* dens_carries;         // (n_seg, R) last density entering each
                               // segment (with carries, TF modes), or null
};

// A sample of a chunk from its ray's fields (sx, sy, sz, dx, dy, dz, a,
// kb): segment_common.cuh's sample_t and sample_pos.
struct SegPt {
  const Seg& P;
  float base;   // the chunk's first sample, from the ray's first segment
  // the ray's first lattice point (per-ray sampling: its carry says)
  __device__ __forceinline__ bool first(const float* r, int j) const {
    return P.lattice && r[7] + (base + (float)j) == r[6];
  }
  __device__ __forceinline__ void point(const float* r, int j, float& t,
                                        float* x, float* d) const {
    const float kf = base + (float)j;
    t = P.lattice ? __fmul_rn(r[7] + kf, P.stepsize)
                  : __fadd_rn(r[6], __fmul_rn(kf, P.stepsize));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = (r[c] + t * r[3 + c] - P.bmin[c]) / P.bsize[c];
      d[c] = r[3 + c];
    }
  }
};

// One launch's march of the block's rays (the kernels' body). With normals
// (`Nrm::kOn`) `nd` ((R,) float4) holds each ray's blended normal and
// depth: phase 0 writes it, phase 1 continues from it. ACT: the activation
// compiled into the layers, or -1 (D.act, any); the piecewise TF's
// instances are generic, the other modes' SnakeAlt unless given.
template <int H, typename Table, int TFM, class Nrm = NoNormal,
          int ACT = (TFM == kTfPiecewise ? -1 : (int)kSnakeAlt)>
__device__ __forceinline__ void segment_march(const Seg& P, const SegOut& O,
                                              const FLayer& L, int phase,
                                              const Nrm& nrm = Nrm(),
                                              float4* nd = nullptr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const FPlan& pl = L.pl;
  const FDims& D = L.D;
  stage_weights<H>(P, pl, D, sm);
  __syncthreads();
#ifdef SMLP_PROFILE
  FwdProf prof = {};
  FwdProf* fp = &prof;
  prof.t = clock64();
#else
  FwdProf* fp = nullptr;
#endif

  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tile = sm + pl.tiles + warp * pl.per_warp;
  const int ray = (blockIdx.x * pl.warps + warp) * kRows + lane;
  const bool real = ray < P.n_rays;
  Ray r = {};
  if (real) r = load_ray(P, ray);
  {   // the fields its rows read: (sx, sy, sz, dx, dy, dz, a, kb)
    float4* rf =
        reinterpret_cast<float4*>(ray_fields(pl, tile) + kRayF * lane);
    rf[0] = make_float4(r.sx, r.sy, r.sz, r.dx);
    rf[1] = make_float4(r.dy, r.dz, r.a, r.kb);
    __syncwarp();
  }
  // phase 0 marches every segment from the start, voting; phase 1
  // continues a ray that died of saturation before the call's stop
  int from = 0, to = P.n_seg;
  Carry cy = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0u};
  float dp = -1.0f;   // the last normalized density (TF modes)
  float4 ndc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // normal, depth
  if (phase == 1 && real) {
    from = O.death[ray];
    to = (int)O.stats[0];
    if (from < to) {
      cy.c = O.out[ray];
      if (TFM != kTfPiecewise) dp = O.dens[ray];
      if constexpr (Nrm::kOn) ndc = nd[ray];
    }
  }
  bool alive = real && from < to;
  int death = 0;
  float4* store = (phase == 0 && O.carries != nullptr && real)
                      ? O.carries + ray : nullptr;
  SegPt pt{P, 0.0f};
  int s = __reduce_min_sync(full, alive ? from : INT_MAX);
  while (__any_sync(full, alive)) {
    const float s0 = (float)(s * P.seg);
    bool run = false;
    if (alive && s >= from) {
      if (segment_start(P, r, s0) > r.tmx
          || (phase == 0 && cy.c.w >= P.early_alpha)) {
        alive = false;
        death = s;
      } else {
        run = true;
        if (store != nullptr) {
          store[(size_t)s * P.n_rays] = cy.c;
          if (TFM != kTfPiecewise)
            O.dens_carries[(size_t)s * P.n_rays + ray] = dp;
        }
      }
    }
#pragma unroll 1
    for (int q0 = 0; q0 < P.seg; q0 += kRows) {
      uint32_t mask = 0u;
      // with iso, a ray whose hit is found takes no more samples
      if (run && !(P.iso && cy.c.w > 0.5f)) {
        const int nj = min(kRows, P.seg - q0);
        for (int j = 0; j < nj; ++j) {
          float t;
          if (sample_t(P, r, s0 + (float)(q0 + j), t)) mask |= 1u << j;
        }
      }
      if (!P.iso) cy.n += __popc(mask);
      if (__any_sync(full, mask != 0u)) {
        pt.base = s0 + (float)q0;
        warp_chunk<H, Table, ACT, SegPt, TFM, Nrm>(pl, D, sm, tile, mask,
                                                   pt, cy, fp, dp, 0u, nrm,
                                                   &ndc);
      }
    }
    ++s;
    if (alive && s >= to) {
      alive = false;
      death = to;
    }
  }
  if (real) {
    if (phase == 0) {
      O.out[ray] = cy.c;
      O.death[ray] = death;
      if (TFM != kTfPiecewise) O.dens[ray] = dp;
      if constexpr (Nrm::kOn) nd[ray] = ndc;
    } else if (from < to) {
      O.out[ray] = cy.c;
      if constexpr (Nrm::kOn) nd[ray] = ndc;
    }
  }
  FWD_MARK(fp, 5);
#ifdef SMLP_PROFILE
  fwd_prof_flush(prof);
#endif
  // one atomic per warp (every lane reaches here)
  const unsigned m = __reduce_max_sync(full, (unsigned)death);
  const unsigned total = __reduce_add_sync(full, cy.n);
  if (lane == 0) {
    if (phase == 0) atomicMax(O.stats, (unsigned long long)m);
    atomicAdd(O.stats + 1, (unsigned long long)total);
  }
}

template <int H, typename Table, int TFM, int ACT>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(H))
    segment_fwd_kernel(
    const Seg P, const SegOut O, const FLayer L, int phase) {
  segment_march<H, Table, TFM, NoNormal, ACT>(P, O, L, phase);
}

// The normals instances (segment_fwd_nrm.cu; width 128 in
// segment_fwd_nrm128.cu): the piecewise TF of density heads, any
// activation and direction input, per-ray or lattice sampling, one
// instance a width and table type. Each counting sample also goes
// through the scalar network and its adjoint sweep (position_grad.cuh
// RowNormal), is shaded (`S`) and blends its normal and depth into `nd`.
template <int H, typename Table>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(H))
    segment_nrm_kernel(
    const Seg P, const SegOut O, const FLayer L, int phase, const Shade S,
    float4* nd) {
  const RowNormal nrm{P, S};
  segment_march<H, Table, kTfPiecewise>(P, O, L, phase, nrm, nd);
}

template <int H, typename Table>
int launch_nrm(const Seg& P, const SegOut& O, const FLayer& L, int phase,
               const Shade& S, float4* nd, cudaStream_t stream) {
  const size_t smem = (size_t)L.pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      segment_nrm_kernel<H, Table>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_block = L.pl.warps * kRows;
  const int blocks = (P.n_rays + per_block - 1) / per_block;
  if (blocks > 0)
    segment_nrm_kernel<H, Table><<<blocks, per_block, smem, stream>>>(
        P, O, L, phase, S, nd);
  return (int)cudaGetLastError();
}

// The widths a library holds: 32, 48 and 64, or with SEGMENT_WIDE (the
// *128.cu sources, libraries of their own) the wide instances' 128.
#ifndef SEGMENT_WIDE
#define SEGMENT_WIDE 0
#endif

template <typename Table>
int launch_nrm_width(const Seg& P, const SegOut& O, const FLayer& L,
                     int hidden, int phase, const Shade& S, float4* nd,
                     cudaStream_t stream) {
#if SEGMENT_WIDE
  return hidden == smlp::kWideWidth
             ? launch_nrm<smlp::kWideWidth, Table>(P, O, L, phase, S, nd,
                                                   stream)
             : (int)cudaErrorInvalidValue;
#else
  switch (hidden) {
    case 32: return launch_nrm<32, Table>(P, O, L, phase, S, nd, stream);
    case 48: return launch_nrm<48, Table>(P, O, L, phase, S, nd, stream);
    case 64: return launch_nrm<64, Table>(P, O, L, phase, S, nd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
#endif
}

template <int H, typename Table, int TFM, int ACT>
int launch(const Seg& P, const SegOut& O, const FLayer& L, int phase,
           cudaStream_t stream) {
  const size_t smem = (size_t)L.pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      segment_fwd_kernel<H, Table, TFM, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_block = L.pl.warps * kRows;
  const int blocks = (P.n_rays + per_block - 1) / per_block;
  if (blocks > 0)
    segment_fwd_kernel<H, Table, TFM, ACT>
        <<<blocks, per_block, smem, stream>>>(P, O, L, phase);
  return (int)cudaGetLastError();
}

// The piecewise instances (segment_fwd.cu), the other TF modes' of
// SnakeAlt networks (SEGMENT_TF_MODES 1: segment_fwd_tf.cu), the texture
// and preintegrated TFs' of every other activation (SEGMENT_TF_MODES 2:
// segment_fwd_anytf.cu) and their Gaussians' (SEGMENT_TF_MODES 3:
// segment_fwd_anyg.cu) are libraries of their own, so that nvcc builds
// them in parallel and the piecewise one, which most paths launch, is
// ready first; a library raises the others' modes.
#ifndef SEGMENT_TF_MODES
#define SEGMENT_TF_MODES 0
#endif

template <int H, typename Table>
int launch_tf(const Seg& P, const SegOut& O, const FLayer& L, int phase,
              cudaStream_t stream) {
  const int part = P.tfm == kTfPiecewise ? 0
                   : P.act == kSnakeAlt ? 1
                   : P.tfm == kTfGaussian ? 3 : 2;
  if (part != SEGMENT_TF_MODES) return (int)cudaErrorInvalidValue;
#if SEGMENT_TF_MODES == 3
  return launch<H, Table, kTfGaussian, -1>(P, O, L, phase, stream);
#elif SEGMENT_TF_MODES == 0
  return launch<H, Table, kTfPiecewise, -1>(P, O, L, phase, stream);
#elif SEGMENT_TF_MODES == 1
  switch (P.tfm) {
    case kTfTexture:
      return launch<H, Table, kTfTexture, kSnakeAlt>(P, O, L, phase, stream);
    case kTfPreint1d:
      return launch<H, Table, kTfPreint1d, kSnakeAlt>(P, O, L, phase,
                                                      stream);
    case kTfPreint2d:
      return launch<H, Table, kTfPreint2d, kSnakeAlt>(P, O, L, phase,
                                                      stream);
    default:
      return launch<H, Table, kTfGaussian, kSnakeAlt>(P, O, L, phase,
                                                      stream);
  }
#else
  switch (P.tfm) {
    case kTfTexture:
      return launch<H, Table, kTfTexture, -1>(P, O, L, phase, stream);
    case kTfPreint1d:
      return launch<H, Table, kTfPreint1d, -1>(P, O, L, phase, stream);
    case kTfPreint2d:
      return launch<H, Table, kTfPreint2d, -1>(P, O, L, phase, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
#endif
}

template <typename Table>
int launch_width(const Seg& P, const SegOut& O, const FLayer& L, int hidden,
                 int phase, cudaStream_t stream) {
#if SEGMENT_WIDE
  return hidden == smlp::kWideWidth
             ? launch_tf<smlp::kWideWidth, Table>(P, O, L, phase, stream)
             : (int)cudaErrorInvalidValue;
#else
  switch (hidden) {
    case 32: return launch_tf<32, Table>(P, O, L, phase, stream);
    case 48: return launch_tf<48, Table>(P, O, L, phase, stream);
    case 64: return launch_tf<64, Table>(P, O, L, phase, stream);
    default: return (int)cudaErrorInvalidValue;
  }
#endif
}

}  // namespace

