// The per-segment fused march, forward (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_dvr.py:_segment_kernel as
// fused_trace_dvr launches it (differentiable=False) and as the forward of
// fvsrn_tpu/ops/fused_dvr_bwd.py:make_segment_op launches it inside the
// differentiable scan: every network the SRN takes (any activation, the
// five output heads, direction input, no latent grid, a grid of <= 16
// channels as a bf16 or float32 table, or more than 16 channels in
// float32), per-ray sampling t = tmin + k*h or the lattice t = k*h from the
// ray tile's base, the piecewise-linear TF or the rgbo heads' own color,
// Beer-Lambert or alpha blending, and the isosurface first-hit epilogue.
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

#include "segment_common.cuh"

namespace {

using namespace march;
using namespace segment;

constexpr int kBlock = 128;

struct SegOut {
  float4* out;                 // (R,) rgba, or (depth, 0, 0, found) for iso
  int* death;                  // (R,) segment at which the ray died
  unsigned long long* stats;   // [stop segment S, samples evaluated]
  float4* carries;             // (n_seg, R) carry entering each segment the
                               // ray runs (phase 0), or null
};

// Segments [s_begin, s_end) of one ray. Returns the first segment at which
// the ray is dead: its segment start lies past tmax (then it has no valid
// sample left) or, with `vote`, its alpha is >= early_alpha on entry. With
// `store` (stride n_rays) the carry entering each segment it runs is kept.
template <int H, typename Table>
__device__ __forceinline__ int march(const Seg& P, const Wts& N, float* hs,
                                     const Ray& r, int s_begin, int s_end,
                                     bool vote, float4& c, unsigned& n,
                                     float4* store) {
  for (int s = s_begin; s < s_end; ++s) {
    const float s0 = (float)(s * P.seg);
    if (segment_start(P, r, s0) > r.tmx) return s;
    if (vote && c.w >= P.early_alpha) return s;
    if (store != nullptr) store[(size_t)s * P.n_rays] = c;
    for (int j = 0; j < P.seg; ++j) {
      float t;
      if (!sample_t(P, r, s0 + (float)j, t)) continue;
      if (P.iso && c.w > 0.5f) break;   // the hit is found: nothing changes
      ++n;
      float x0, x1, x2;
      sample_pos(P, r, t, x0, x1, x2);
      float v[4];
      network<H, Table, kBlock, false>(P, N, hs, x0, x1, x2, r.dx, r.dy,
                                       r.dz, v, nullptr);
      if (P.iso) {
        if (v[0] > P.iso_value) {
          c.x = t;
          c.w = 1.0f;
        }
        continue;
      }
      float cr, cg, cb, absn;
      TfSample tf;
      if (!sample_color(P, N, v, cr, cg, cb, absn, tf)) continue;
      over(c.x, c.y, c.z, c.w, cr, cg, cb, sample_alpha(P, absn));
    }
  }
  return s_end;
}

// Shared memory: the packed weights, then (from a 16-byte boundary) the
// activation scratch, H rows of kBlock floats.
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
      const Ray r = load_ray(P, ray);
      death = march<H, Table>(
          P, N, hs, r, from, to, phase == 0, c, n,
          (phase == 0 && O.carries != nullptr) ? O.carries + ray : nullptr);
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
// continuation up to the call's stop). Weights packed as `Wts`
// (segment_common.cuh) with the padded hidden width `hidden` (32, 48 or
// 64). `table` is (gz, gy, gx, 16 * chunks), bf16 (table_f32 = 0) or
// float32; with chunks = 0 it is not read. `kbase` is read in lattice mode
// only. `stats` ([S, samples], int64) must be zero before phase 0. With
// `carries` ((n_seg, R) float4, phase 0 only) each ray also stores the
// carry entering every segment it runs, for the backward
// (segment_bwd.cu). Launches on `stream` and returns cudaGetLastError() (0
// on success).
extern "C" int segment_fwd_launch(
    const float* rays, const float* kbase, const void* table, int table_f32,
    const float* weights, int n_weights, float* out, int* death,
    unsigned long long* stats, float* carries, int n_rays, int gx, int gy,
    int gz, int chunks, int n_fourier, int n_hidden, int hidden,
    int tf_points, int act, float act_param, int head, int has_dir,
    int lattice, int blend_alpha, int iso, float iso_value, int seg,
    int n_seg, float stepsize, float density_min, float inv_range,
    float early_alpha, float bmin_x, float bmin_y, float bmin_z,
    float bsize_x, float bsize_y, float bsize_z, int phase, void* stream) {
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  const Seg P = make_seg(rays, kbase, table, weights, n_weights, n_rays, gx,
                         gy, gz, chunks, n_fourier, n_hidden, tf_points, act,
                         act_param, head, has_dir, lattice, blend_alpha, iso,
                         iso_value, seg, n_seg, stepsize, density_min,
                         inv_range, early_alpha, bmin, bsize);
  if (!seg_valid(P) || (phase != 0 && phase != 1)
      || (carries != nullptr && phase != 0))
    return (int)cudaErrorInvalidValue;
  SegOut O;
  O.out = reinterpret_cast<float4*>(out);
  O.death = death;
  O.stats = stats;
  O.carries = reinterpret_cast<float4*>(carries);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch_width<F32Table>(P, O, hidden, phase, st)
                   : launch_width<Bf16Table>(P, O, hidden, phase, st);
}
