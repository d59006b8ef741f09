// Fused SRN volume-rendering march, forward (sm_90a). Included by one
// source per hidden width (mega_fwd.cu: 32, mega_fwd48.cu, mega_fwd64.cu),
// each defining MEGA_WIDTH first: a library each, so that nvcc builds the
// widths in parallel.
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_mega.py:_mega_fwd_kernel in
// both its launches: the render's (non-differentiable, bf16 latent table)
// and the training forward's (differentiable=True, float32 table), which
// also stores the carry (r, g, b, alpha) entering every segment a tile
// visits and the number of segments it visited, so that mega_bwd.cu can
// replay the tile's vote in reverse. Per sample: lattice position,
// trilinear latent fetch from the channel-last table, Fourier features,
// the SRN's MLP, output head (a density head through the TF, or an rgbo
// head's own color), the TF (piecewise-linear, texture, 1D- or
// 2D-preintegrated, Gaussians: a template parameter, one instance each)
// and Beer-Lambert "over" into the ray's carry. The preintegrating modes
// carry each ray's last normalized density besides (in registers, across
// segments and the vote; a culled or skipped segment leaves it alone, as
// the JAX kernel's carry row 4), stored with the carries for training.
//
// Layout: one thread block per tile of kTile rays (256, or 128 in the
// _t128 sources; mega_common.cuh), in the caller's order (the product
// path passes 16x16 pixel blocks, bench.py's configuration 16x8): groups
// of 32 rays, warp w owning group w (lane = ray). Per segment each warp
// evaluates its rays' valid samples on the warp-owned sample tile (warp_mlp.cuh): the
// samples listed ray by ray, tiles of 32 rows, every layer a TF32
// three-pass mma.sync product (float32-accurate) with the activation in
// its epilogue, composited in order by a segmented scan over the tile.
// The weights and TF control points are staged once per block in shared
// memory; the table stays in L2 (1 MB bf16, 2 MB float32 at 32^3 x 16).
//
// Instances: per width, every TF mode of SnakeAlt networks without
// direction input (the product's networks; the activation compiled into
// the layers' epilogue, no direction read), and for every other network
// (any activation, a switch outside the tile's layers as in
// segment_fwd.cu; direction input) every TF mode too: the piecewise TF or
// rgbo heads, the texture, 1D- and 2D-preintegrated TFs, each table type,
// masked or not, and the Gaussians unmasked (the training forward's; the
// render refuses Gaussians). The head is a runtime switch.
// Five libraries a width (MEGA_PART), so that nvcc builds them in
// parallel and the one most paths launch is ready first: SnakeAlt networks
// without direction input on the piecewise TF (mega_fwd*.cu), their other
// TF modes (mega_fwd_tf*.cu), every other network on the piecewise TF
// (mega_fwd_any*.cu, whose activation switch makes its instances the
// costliest to compile), every other network on the texture and
// preintegrated TFs (mega_fwd_anytf*.cu) and on the Gaussians
// (mega_fwd_anyg*.cu), the last two on 256-ray tiles only (the render's
// and the screen trainer's tile). The
// normals instances (MEGA_NORMALS: mega_fwd_nrm.cu, mega_fwd_nrm48.cu,
// mega_fwd_nrm64.cu, a library each) replace the JAX kernel's render with
// need_normals and a BRDF: the generic instance's tile, then each counting
// sample's position gradient, shading, and its normal and depth blended
// with the colour's weights (warp_mlp.cuh's warp_chunk with RowNormal).
//
// Semantics kept from the TPU kernel (they decide the image):
//  - samples sit on the global lattice t = k*h; the tile's base k0t is the
//    minimum of ceil(tmin/h) over ALL its rays, box-missing rays included;
//  - the march runs in segments of `seg` lattice points from k0t; a
//    segment runs only when some ray of the tile has a live point in it,
//    and only while some ray of the tile has alpha < early_alpha (the vote
//    is taken at the segment's start, on the carry of the previous one);
//    the caller's occupancy mask, when given, culls a segment besides;
//  - a sample counts when t <= tmax (already clipped) and k >= k0_ray, and
//    its value is >= density_min.
// A per-ray early-out would give another image; the vote is per tile. The
// three block-wide agreements a segment needs (a live point left, a live
// point in the segment, a ray not saturated) are taken at one barrier:
// each warp's ballots into a word of shared memory (two slots, by the
// segment's parity, so that no warp overwrites a word another still
// reads). A warp whose rays have no sample in a segment waits there for
// the others; that wait is the vote barrier's phase in the profile.
//
// Bound: operations. A sample of the flagship costs ~7.6 kFLOP (2*(14*3 +
// 47*32 + 2*32*32 + 32) for the MLP, plus trilerp and TF) and 110
// transcendentals (a 64:64:64 network ~22.5 kFLOP), against 44 bytes of
// ray data per ray (and 16 bytes per ray and visited segment
// of stored carries in training). The products run at three TF32
// tensor-core passes each; the activations, Fourier features and latent
// fetch stay on the CUDA cores and the SFU.

#include "mega_common.cuh"
#include "warp_mlp.cuh"
#ifdef MEGA_NORMALS
#include "position_grad.cuh"
#endif

#ifndef MEGA_WIDTH
#error "define MEGA_WIDTH (32, 48 or 64) before including mega_fwd.cuh"
#endif
#ifndef MEGA_PART
// 0: SnakeAlt, piecewise; 1: SnakeAlt, other TF modes; 2: other networks,
// piecewise; 3: other networks, texture and preintegrated TFs; 4: other
// networks, Gaussians (unmasked)
#define MEGA_PART 0
#endif

namespace {

using namespace mega;
using namespace wmlp;

struct FwdOut {
  float* out;               // (R, 4) rgba
  int* tile_samples;        // (R / kTile,) samples evaluated per tile
  float4* carries;          // (R / kTile, n_seg_max, kTile) or null
  int* seg_count;           // (R / kTile,) segments visited, or null
};

// A lattice point of a chunk from its ray's fields (sx, sy, sz, dx, dy,
// dz, k0r): t = k*h; the ray's first point is k = k0r. kDir: the ray's
// direction as the direction input (JAX feeds the ray packet's direction,
// fvsrn_tpu/ops/fused_mega.py:_build_samples), else zeros, not read.
template <bool kDir>
struct MegaPt {
  const March& P;
  float base;   // the chunk's first lattice index
  __device__ __forceinline__ bool first(const float* r, int j) const {
    return base + (float)j == r[6];
  }
  __device__ __forceinline__ void point(const float* r, int j, float& t,
                                        float* x, float* d) const {
    t = (base + (float)j) * P.stepsize;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = (r[c] + t * r[3 + c] - P.bmin[c]) / P.bsize[c];
      d[c] = kDir ? r[3 + c] : 0.0f;
    }
  }
};

// The packed weights (mega_common.cuh's Offsets: output-major) into the
// plan's layout, transposed to input-major rows in the tile's column
// order (zero rows past the position and direction); the output rows as
// rows 0..n_out-1 of four, B and Bd padded to F4 rows (Bd zero without
// direction input).
template <int H>
__device__ __forceinline__ void stage_weights(const March& P, const FPlan& pl,
                                              const FDims& D, float* sm) {
  const int F = D.F, nh = D.nh, n_in = D.has_dir ? 6 : 3;
  const Offsets off = weight_offsets(H, F, nh, D.n_out, D.has_dir);
  const int K1 = off.K1;
  const float* w = P.weights;
  stage_matrix<H>(pl, sm + pl.W1, D.K, [&](int k, int o) {
    int src;   // the packed column: pos 3, dir 3, cos F, sin F, latent 16
    if (k < D.sin) src = n_in + k - D.cos;
    else if (k < D.lat) src = n_in + F + k - D.sin;
    else if (k < D.pos) src = n_in + 2 * F + k - D.lat;
    else src = k - D.pos < n_in ? k - D.pos : -1;
    return src >= 0 ? w[off.W1 + o * K1 + src] : 0.0f;
  });
  for (int l = 0; l < nh; ++l)
    stage_matrix<H>(pl, sm + pl.Wh + l * pl.wl, H, [&](int k, int o) {
      return w[off.Wh + (l * H + o) * H + k];
    });
  for (int i = threadIdx.x; i < H; i += kTile) {
    sm[pl.b1 + i] = w[off.b1 + i];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sm[pl.Wo + r * H + i] = r < D.n_out ? w[off.Wo + r * H + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < nh * H; i += kTile)
    sm[pl.bh + i] = w[off.bh + i];
  for (int i = threadIdx.x; i < 4; i += kTile)
    sm[pl.bo + i] = i < D.n_out ? w[off.bo + i] : 0.0f;
  for (int i = threadIdx.x; i < 3 * D.F4; i += kTile) {
    sm[pl.B + i] = i < 3 * F ? w[off.B + i] : 0.0f;
    sm[pl.Bd + i] = D.has_dir && i < 3 * F ? w[off.Bd + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < D.tfn; i += kTile)
    sm[pl.TF + i] = w[off.TF + i];
}

// The march of one tile (the kernels' body). `dens_carries` (the TF
// modes'): (R / kTile, n_seg_max, kTile) last densities entering each visited
// segment, or null. ACT: kSnakeAlt (no direction input), or -1: any
// activation (D.act), direction input read. With normals (`Nrm::kOn`)
// `nd_out` ((R,) float4) takes each ray's blended normal and depth.
template <int H, typename Table, bool kMasked, int TFM, int ACT,
          class Nrm = NoNormal>
__device__ __forceinline__ void mega_march(const March& P, const FwdOut& O,
                                           const FLayer& L,
                                           float* dens_carries,
                                           const Nrm& nrm = Nrm(),
                                           float4* nd_out = nullptr) {
  extern __shared__ float4 smem4[];
  __shared__ float red_f[kTile / 32];
  __shared__ int red_i[kTile / 32];
  __shared__ unsigned votes[2][kTile / 32];
  float* sm = reinterpret_cast<float*>(smem4);
  const FPlan& pl = L.pl;
  const FDims& D = L.D;

  stage_weights<H>(P, pl, D, sm);
  const Ray R = load_ray(P, red_f);  // its barrier publishes the weights
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
  {   // the fields its rows read: (sx, sy, sz, dx, dy, dz, k0r)
    float4* rf =
        reinterpret_cast<float4*>(ray_fields(pl, tile) + kRayF * lane);
    rf[0] = make_float4(R.sx, R.sy, R.sz, R.dx);
    rf[1] = make_float4(R.dy, R.dz, TFM != kTfPiecewise ? R.k0r : 0.0f,
                        0.0f);
    __syncwarp();
  }
  MegaPt<(ACT < 0)> pt{P, 0.0f};
  const float h = P.stepsize;
  const float segf = (float)P.seg;
  Carry cy = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0u};
  float dp = -1.0f;   // the last normalized density (TF modes)
  float4 nd = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // normal, depth
  int visited = 0;

  for (int s = 0; s < P.n_seg_max; ++s) {
    const float ka = R.k0t + (float)s * segf;
    const float first = fmaxf(R.k0r, ka) * h;
    const bool later = first <= R.tmx;   // a live point at or after ka
    const bool alive = first <= fminf(R.tmx, (ka + (segf - 1.0f)) * h);
    // the tile's votes: bit 0 a live point left, bit 1 a live point in
    // the segment, bit 2 a ray below early_alpha
    const unsigned mine = (__any_sync(full, later) ? 1u : 0u)
                          | (__any_sync(full, alive) ? 2u : 0u)
                          | (__any_sync(full, cy.c.w < P.early_alpha) ? 4u
                                                                      : 0u);
    if (lane == 0) votes[s & 1][warp] = mine;
    FWD_MARK(fp, 5);
    __syncthreads();
    unsigned v = 0u;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) v |= votes[s & 1][w];
    FWD_MARK(fp, 4);
    if (!(v & 1u)) break;                        // the tile is done
    const bool active = (v & 2u) && segment_on<kMasked>(P, s);
    if (O.carries != nullptr)
      O.carries[((size_t)blockIdx.x * P.n_seg_max + s) * kTile
                + threadIdx.x] = cy.c;
    if (TFM != kTfPiecewise && dens_carries != nullptr)
      dens_carries[((size_t)blockIdx.x * P.n_seg_max + s) * kTile
                   + threadIdx.x] = dp;
    visited = s + 1;
    if (!(v & 4u)) break;                        // tile saturated
    if (!active) continue;
#pragma unroll 1
    for (int q0 = 0; q0 < P.seg; q0 += kRows) {
      uint32_t mask = 0u;
      if (alive) {
        const int nj = min(kRows, P.seg - q0);
        for (int j = 0; j < nj; ++j) {
          const float k = ka + (float)(q0 + j);
          if (k * h <= R.tmx && k >= R.k0r) mask |= 1u << j;
        }
      }
      cy.n += __popc(mask);
      // The JAX kernel's carry row 4 is every ray's density at the
      // segment's last point, valid or not. A ray that starts past this
      // segment reads it at its first sample only when the segment that
      // holds that sample is culled (else its first sample reads none):
      // the masked preintegrating instances evaluate that point's density
      // alone (a row that does not count).
      uint32_t donly = 0u;
      if constexpr (kMasked && (TFM == kTfPreint1d || TFM == kTfPreint2d)) {
        if (!alive && R.k0r > ka + (segf - 1.0f) && q0 + kRows >= P.seg)
          donly = 1u << (P.seg - 1 - q0);
      }
      if (__any_sync(full, (mask | donly) != 0u)) {
        pt.base = ka + (float)q0;
        warp_chunk<H, Table, ACT, MegaPt<(ACT < 0)>, TFM, Nrm>(
            pl, D, sm, tile, mask | donly, pt, cy, fp, dp, donly, nrm, &nd);
      }
    }
  }
  FWD_MARK(fp, 5);
#ifdef SMLP_PROFILE
  fwd_prof_flush(prof);
#endif

  const int ray = blockIdx.x * kTile + threadIdx.x;
  reinterpret_cast<float4*>(O.out)[ray] = cy.c;
  if constexpr (Nrm::kOn) nd_out[ray] = nd;
  const unsigned n = __reduce_add_sync(full, cy.n);
  if (lane == 0) red_i[warp] = (int)n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) total += red_i[w];
    O.tile_samples[blockIdx.x] = total;
    if (O.seg_count != nullptr) O.seg_count[blockIdx.x] = visited;
  }
}

template <int H, typename Table, bool kMasked, int TFM, int ACT>
__global__ void __launch_bounds__(kTile, 2) mega_fwd_kernel(
    const March P, const FwdOut O, const FLayer L, float* dens_carries) {
  mega_march<H, Table, kMasked, TFM, ACT>(P, O, L, dens_carries);
}

// What a launch passes besides March, FwdOut and FLayer: the TF mode and
// the stored densities.
struct TfArgs {
  int tfm;
  float* dens_carries;
};

template <typename Table, bool kMasked, int TFM, int ACT>
int launch_instance(const March& P, const FwdOut& O, const FLayer& L,
                    const TfArgs& T, int n_rays, cudaStream_t stream) {
  constexpr int H = MEGA_WIDTH;
  const size_t smem = (size_t)L.pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      mega_fwd_kernel<H, Table, kMasked, TFM, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_rays / kTile;
  if (blocks > 0)
    mega_fwd_kernel<H, Table, kMasked, TFM, ACT>
        <<<blocks, kTile, smem, stream>>>(P, O, L, T.dens_carries);
  return (int)cudaGetLastError();
}

// SnakeAlt networks without direction input take their TF mode's
// instance; every other network the generic one of its TF mode (piecewise
// TF or rgbo heads, texture, 1D- or 2D-preintegrated, Gaussians unmasked:
// mega_fwd_launch refuses a mask with them). A library holds its part's
// instances only (MEGA_PART) and refuses the others'.
template <typename Table, bool kMasked>
int launch_tf(const March& P, const FwdOut& O, const FLayer& L,
              const TfArgs& T, int n_rays, cudaStream_t stream) {
  const bool generic = P.act != kSnakeAlt || P.has_dir;
  const int part = T.tfm == kTfPiecewise ? (generic ? 2 : 0)
                   : !generic ? 1 : T.tfm == kTfGaussian ? 4 : 3;
  if (part != MEGA_PART) return (int)cudaErrorInvalidValue;
#if MEGA_PART == 4
  // the training forward's Gaussians: no masked instance
  if constexpr (kMasked)
    return (int)cudaErrorInvalidValue;
  else
    return launch_instance<Table, false, kTfGaussian, -1>(P, O, L, T,
                                                          n_rays, stream);
#elif MEGA_PART == 0
  return launch_instance<Table, kMasked, kTfPiecewise, kSnakeAlt>(
      P, O, L, T, n_rays, stream);
#elif MEGA_PART == 2
  return launch_instance<Table, kMasked, kTfPiecewise, -1>(P, O, L, T,
                                                           n_rays, stream);
#elif MEGA_PART == 3
  switch (T.tfm) {
    case kTfTexture:
      return launch_instance<Table, kMasked, kTfTexture, -1>(
          P, O, L, T, n_rays, stream);
    case kTfPreint1d:
      return launch_instance<Table, kMasked, kTfPreint1d, -1>(
          P, O, L, T, n_rays, stream);
    case kTfPreint2d:
      return launch_instance<Table, kMasked, kTfPreint2d, -1>(
          P, O, L, T, n_rays, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
#else
  switch (T.tfm) {
    case kTfTexture:
      return launch_instance<Table, kMasked, kTfTexture, kSnakeAlt>(
          P, O, L, T, n_rays, stream);
    case kTfPreint1d:
      return launch_instance<Table, kMasked, kTfPreint1d, kSnakeAlt>(
          P, O, L, T, n_rays, stream);
    case kTfPreint2d:
      return launch_instance<Table, kMasked, kTfPreint2d, kSnakeAlt>(
          P, O, L, T, n_rays, stream);
    default:
      return launch_instance<Table, kMasked, kTfGaussian, kSnakeAlt>(
          P, O, L, T, n_rays, stream);
  }
#endif
}

// The masked march is its own instance: the unmasked one (every render
// without a zero band, and training) compiles as if the mask did not
// exist.
template <typename Table>
int launch(const March& P, const FwdOut& O, const FLayer& L,
           const TfArgs& T, int n_rays, cudaStream_t stream) {
  return P.seg_active != nullptr
             ? launch_tf<Table, true>(P, O, L, T, n_rays, stream)
             : launch_tf<Table, false>(P, O, L, T, n_rays, stream);
}

// The tile's dims and the shared-memory plan (kTile / 32 warps a block)
// with the TF's cumulative rows, packed floats and preint2d table; false
// when it does not fit.
bool fill_layer(FLayer& L, const March& P, int tf_pre, int tf_floats,
                const float* tf2d) {
  FDims& D = L.D;
  set_columns(D, P.n_fourier, 1, P.has_dir);
  D.nh = P.n_hidden;
  D.tp = P.tf_points;
  D.tpre = tf_pre;
  D.tfn = tf_floats;
  D.tf2d = reinterpret_cast<const float4*>(tf2d);
  D.has_dir = P.has_dir;
  D.act = P.act;
  D.head = P.head;
  D.n_out = head_outputs(P.head);
  D.blend_alpha = 0;
  D.iso = 0;
  D.p = P.act_param;
  D.inv_p = 1.0f / P.act_param;
  D.inv_2p = 1.0f / (2.0f * P.act_param);
  D.iso_value = 0.0f;
  D.density_min = P.density_min;
  D.inv_range = P.inv_range;
  D.h = P.stepsize;
  D.gx = P.gx;
  D.gy = P.gy;
  D.gz = P.gz;
  D.table = P.table;
  return choose_fwd_plan(MEGA_WIDTH, D.K, D.nh, D.F4, D.tfn, kTile / 32,
                         L.pl);
}

#ifdef MEGA_NORMALS
// The normals instances (MEGA_NORMALS, their own library a width): the
// piecewise TF of density heads, any activation and direction input, the
// occupancy mask or none, one instance a table type. Each counting sample
// also goes through the scalar network and its adjoint sweep
// (position_grad.cuh RowNormal, on the engine's packed weights `NP`), is
// shaded (`S`) and blends its normal and depth into `nd_out`.
template <typename Table>
__global__ void __launch_bounds__(kTile, 2) mega_nrm_kernel(
    const March P, const FwdOut O, const FLayer L, const segment::Seg NP,
    const Shade S, float4* nd_out) {
  const segment::RowNormal nrm{NP, S};
  mega_march<MEGA_WIDTH, Table, true, kTfPiecewise, -1>(P, O, L, nullptr,
                                                         nrm, nd_out);
}

template <typename Table>
int launch_nrm(const March& P, const FwdOut& O, const FLayer& L,
               const segment::Seg& NP, const Shade& S, float4* nd_out,
               int n_rays, cudaStream_t stream) {
  const size_t smem = (size_t)L.pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      mega_nrm_kernel<Table>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_rays / kTile;
  if (blocks > 0)
    mega_nrm_kernel<Table><<<blocks, kTile, smem, stream>>>(P, O, L, NP, S,
                                                           nd_out);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifndef MEGA_NORMALS
#ifdef SMLP_PROFILE
// The phase timers' sums since the last read (march_common.cuh), reset.
extern "C" int smlp_prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, smlp_prof, sizeof(smlp_prof));
  unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(smlp_prof, zero, sizeof(zero));
  return (int)cudaGetLastError();
}
#endif

// The shared-memory plan a launch of this width takes (warp_mlp.cuh's
// choose_fwd_plan at kTile / 32 warps) with `tf_floats` TF floats (5 a
// piecewise knot) and direction input `has_dir`: out = [bytes, warps a
// block, matrices pre-split]. Returns 0, or -1 when it does not fit in
// 227 KB.
extern "C" int mega_fwd_smem(int n_fourier, int n_hidden, int tf_floats,
                             int has_dir, long* out) {
  FDims D;
  set_columns(D, n_fourier, 1, has_dir);
  FPlan pl;
  if (!choose_fwd_plan(MEGA_WIDTH, D.K, n_hidden, D.F4, tf_floats,
                       kTile / 32, pl))
    return -1;
  out[0] = pl.total;
  out[1] = pl.warps;
  out[2] = pl.pre;
  return 0;
}

// Weights packed as in mega_common.cuh (`Offsets`) at the padded hidden
// width `hidden`, which must be this library's (MEGA_WIDTH). The network:
// activation `act` with parameter `act_param`, output head `head`
// (march_common.cuh's Act and Head), direction input `has_dir`; every
// TF mode takes every network (MEGA_PART 3 and 4 for the networks other
// than SnakeAlt without direction input; a Gaussian TF there with no
// `seg_active` mask), rgbo heads no TF (tfm piecewise, no rows). `table` is (gz, gy, gx, 16)
// bf16 (table_f32 = 0) or float32 (table_f32 = 1). `carries` and
// `seg_count` may be null (the render); otherwise carries holds
// n_seg_max x kTile float4 per tile. `seg_active` (tiles x mask_cols bytes,
// or null) culls segments (mega_common.cuh `segment_on`). The TF: mode
// `tfm` (march_common.cuh's TfMode), `tf_points` rows, `tf_pre` cumulative
// rows, `tf_floats` packed floats, `tf2d` the preint2d table ((tf_points,
// tf_points) float4); with `dens_carries` (like carries, one float) the
// last density entering each visited segment is stored too. n_rays must be
// a multiple of kTile (this library's tile, 256 or 128).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mega_fwd_launch(
    const float* rays, const void* table, int table_f32, const float* weights,
    int n_weights, float* out, int* tile_samples, float* carries,
    int* seg_count, int n_rays, int gx, int gy, int gz, int n_fourier,
    int n_hidden, int tf_points, int hidden, int act, float act_param,
    int head, int has_dir, int seg, int n_seg_max,
    float stepsize, float density_min, float inv_range, float early_alpha,
    float bmin_x, float bmin_y, float bmin_z, float bsize_x, float bsize_y,
    float bsize_z, const uint8_t* seg_active, int mask_cols, int tfm,
    int tf_pre, int tf_floats, const float* tf2d, float* dens_carries,
    void* stream) {
  if (hidden != MEGA_WIDTH || n_fourier > kMaxFourier
      || n_hidden > kMaxHidden || seg < 1
      || !mega_valid(act, head, tfm, tf_points, tf_pre, tf_floats, tf2d)
      || (tfm == kTfGaussian && (act != kSnakeAlt || has_dir)
          && seg_active != nullptr))
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
  FLayer L;
  if (!fill_layer(L, P, tf_pre, tf_floats, tf2d))
    return (int)cudaErrorInvalidValue;
  FwdOut O;
  O.out = out;
  O.tile_samples = tile_samples;
  O.carries = reinterpret_cast<float4*>(carries);
  O.seg_count = seg_count;
  const TfArgs T = {tfm, dens_carries};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch<F32Table>(P, O, L, T, n_rays, st)
                   : launch<Bf16Table>(P, O, L, T, n_rays, st);
}
#else   // MEGA_NORMALS

// The normals march of this width (MEGA_NORMALS): mega_fwd_launch's
// arguments for a density head and the piecewise TF, with `nweights` the
// network packed as the per-segment engine's `Wts` (segment_common.cuh;
// `chunks` latent rows of 16, 0 without a grid) for the scalar network of
// each sample's gradient, `nd_out` ((R,) float4) the blended normal and
// depth, and the shading: shade_i = [magnitude scaling on, Phong on,
// directional light, specular exponent], shade_f = [magnitude scaling,
// ambient, specular, smoothstep edge, smoothstep width, lobe
// normalisation, light x, y, z] (march_common.cuh's Shade; host arrays).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mega_fwd_nrm_launch(
    const float* rays, const void* table, int table_f32, const float* weights,
    int n_weights, const float* nweights, int n_nweights, int chunks,
    float* out, float* nd_out, int* tile_samples, int n_rays, int gx, int gy,
    int gz, int n_fourier, int n_hidden, int tf_points, int hidden, int act,
    float act_param, int head, int has_dir, int seg, float stepsize,
    float density_min, float inv_range, float early_alpha, float bmin_x,
    float bmin_y, float bmin_z, float bsize_x, float bsize_y, float bsize_z,
    const uint8_t* seg_active, int mask_cols, const int* shade_i,
    const float* shade_f, void* stream) {
  if (hidden != MEGA_WIDTH || n_fourier > kMaxFourier
      || n_hidden > kMaxHidden || seg < 1 || head > kDensityDirect
      || chunks < 0 || chunks > 1
      || !mega_valid(act, head, kTfPiecewise, tf_points, 0, 5 * tf_points,
                     nullptr))
    return (int)cudaErrorInvalidValue;
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  March P;
  fill_march(P, rays, table, weights, n_weights, gx, gy, gz, n_fourier,
             n_hidden, tf_points, act, act_param, head, has_dir, seg,
             1 << 30, stepsize, density_min, inv_range, early_alpha, bmin,
             bsize);
  P.seg_active = seg_active;
  P.mask_cols = mask_cols;
  FLayer L;
  if (!fill_layer(L, P, 0, 5 * tf_points, nullptr))
    return (int)cudaErrorInvalidValue;
  const segment::Seg NP = segment::make_seg(
      rays, nullptr, table, nweights, n_nweights, n_rays, gx, gy, gz, chunks,
      n_fourier, n_hidden, tf_points, act, act_param, head, has_dir, 0, 0, 0,
      0.0f, seg, 1, stepsize, density_min, inv_range, early_alpha, bmin,
      bsize);
  const Shade S = make_shade(shade_i, shade_f);
  FwdOut O;
  O.out = out;
  O.tile_samples = tile_samples;
  O.carries = nullptr;
  O.seg_count = nullptr;
  float4* nd = reinterpret_cast<float4*>(nd_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch_nrm<F32Table>(P, O, L, NP, S, nd, n_rays, st)
                   : launch_nrm<Bf16Table>(P, O, L, NP, S, nd, n_rays, st);
}
#endif  // MEGA_NORMALS
