// Fused SRN volume-rendering march, forward (sm_90a).
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_mega.py:_mega_fwd_kernel in
// both its launches: the render's (non-differentiable, bf16 latent table)
// and the training forward's (differentiable=True, float32 table), which
// also stores the carry (r, g, b, alpha) entering every segment a tile
// visits and the number of segments it visited, so that mega_bwd.cu can
// replay the tile's vote in reverse. Per sample: lattice position,
// trilinear latent fetch from the channel-last table, Fourier features,
// the SRN's MLP in float32, output head, piecewise-linear TF and
// Beer-Lambert "over" into the ray's carry (mega_common.cuh).
//
// Layout: one thread block per tile of 256 rays (one thread per ray), in
// the caller's order (the product path passes 16x16 pixel blocks). The
// weights and TF control points are staged once per block in shared
// memory; every thread reads the same weight at the same time, so the
// reads are broadcasts. The table stays in L2 (1 MB bf16, 2 MB float32 at
// 32^3 x 16).
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
// A per-ray early-out would give another image; the vote is per tile.
//
// Bound: operations. A sample costs ~7.6 kFLOP (2*(14*3 + 47*32 + 2*32*32
// + 32) for the MLP, plus trilerp and TF) and 110 transcendentals, against
// 44 bytes of ray data per ray (and 16 bytes per ray and visited segment
// of stored carries in training); this first version runs it on the
// float32 CUDA cores, one sample at a time per thread. Moving the 32-wide
// layers to mma/wgmma over samples batched per warpgroup is later work.

#include "mega_common.cuh"

namespace {

using namespace mega;

struct FwdOut {
  float* out;               // (R, 4) rgba
  int* tile_samples;        // (R / 256,) samples evaluated per tile
  float4* carries;          // (R / 256, n_seg_max, 256) or null
  int* seg_count;           // (R / 256,) segments visited, or null
};

template <typename Table, bool kMasked>
__global__ void __launch_bounds__(kTile) mega_fwd_kernel(const March P,
                                                         const FwdOut O) {
  extern __shared__ float sw[];
  __shared__ float red_f[kTile / 32];
  __shared__ int red_i[kTile / 32];

  for (int i = threadIdx.x; i < P.n_weights; i += kTile) sw[i] = P.weights[i];
  const Net N = carve(sw, P);
  const Ray R = load_ray(P, red_f);  // its barrier publishes the weights

  const float h = P.stepsize;
  const float segf = (float)P.seg;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
  int n_samples = 0;
  int visited = 0;

  for (int s = 0; s < P.n_seg_max; ++s) {
    const float ka = R.k0t + (float)s * segf;
    const float first = fmaxf(R.k0r, ka) * h;
    const bool later = first <= R.tmx;   // a live point at or after ka
    const bool alive = first <= fminf(R.tmx, (ka + (segf - 1.0f)) * h);
    if (!__syncthreads_or(later)) break;          // the tile is done
    const bool active = __syncthreads_or(alive) && segment_on<kMasked>(P, s);
    if (O.carries != nullptr)
      O.carries[((size_t)blockIdx.x * P.n_seg_max + s) * kTile
                + threadIdx.x] = make_float4(cr, cg, cb, ca);
    visited = s + 1;
    if (!__syncthreads_or(ca < P.early_alpha)) break;  // tile saturated
    if (!active || !alive) continue;

    for (int j = 0; j < P.seg; ++j) {
      const float k = ka + (float)j;
      const float t = k * h;
      if (!(t <= R.tmx && k >= R.k0r)) continue;
      ++n_samples;
      float x0, x1, x2;
      sample_pos(P, R, t, x0, x1, x2);
      Shaded sh;
      if (!shade<Table>(P, N, x0, x1, x2, sh)) continue;
      const float absn = sh.tf.op * h;
      const float a = 1.0f - expf(-absn);  // Beer-Lambert
      over(cr, cg, cb, ca, sh.tf.r, sh.tf.g, sh.tf.b, a);
    }
  }

  const int ray = blockIdx.x * kTile + threadIdx.x;
  reinterpret_cast<float4*>(O.out)[ray] = make_float4(cr, cg, cb, ca);
  const int n = __reduce_add_sync(0xffffffffu, n_samples);
  if ((threadIdx.x & 31) == 0) red_i[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) total += red_i[w];
    O.tile_samples[blockIdx.x] = total;
    if (O.seg_count != nullptr) O.seg_count[blockIdx.x] = visited;
  }
}

template <typename Table, bool kMasked>
int launch_instance(const March& P, const FwdOut& O, int n_rays,
                    cudaStream_t stream) {
  const size_t smem = (size_t)P.n_weights * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_fwd_kernel<Table, kMasked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = n_rays / kTile;
  if (blocks > 0)
    mega_fwd_kernel<Table, kMasked><<<blocks, kTile, smem, stream>>>(P, O);
  return (int)cudaGetLastError();
}

// The masked march is its own instance: the unmasked one (every render
// without a zero band, and training) compiles as if the mask did not
// exist, and keeps its registers.
template <typename Table>
int launch(const March& P, const FwdOut& O, int n_rays, cudaStream_t stream) {
  return P.seg_active != nullptr
             ? launch_instance<Table, true>(P, O, n_rays, stream)
             : launch_instance<Table, false>(P, O, n_rays, stream);
}

}  // namespace

// Weights packed as in mega_common.cuh (`Net`). `table` is (gz, gy, gx, 16)
// bf16 (table_f32 = 0) or float32 (table_f32 = 1). `carries` and
// `seg_count` may be null (the render); otherwise carries holds
// n_seg_max x 256 float4 per tile. `seg_active` (tiles x mask_cols bytes,
// or null) culls segments (mega_common.cuh `segment_on`). n_rays must be a
// multiple of 256.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mega_fwd_launch(
    const float* rays, const void* table, int table_f32, const float* weights,
    int n_weights, float* out, int* tile_samples, float* carries,
    int* seg_count, int n_rays, int gx, int gy, int gz, int n_fourier,
    int n_hidden, int tf_points, float act_param, int seg, int n_seg_max,
    float stepsize, float density_min, float inv_range, float early_alpha,
    float bmin_x, float bmin_y, float bmin_z, float bsize_x, float bsize_y,
    float bsize_z, const uint8_t* seg_active, int mask_cols, void* stream) {
  if (n_fourier > kMaxFourier || n_hidden > kMaxHidden
      || tf_points > kMaxTf || tf_points < 2)
    return (int)cudaErrorInvalidValue;
  const float bmin[3] = {bmin_x, bmin_y, bmin_z};
  const float bsize[3] = {bsize_x, bsize_y, bsize_z};
  March P;
  fill_march(P, rays, table, weights, n_weights, gx, gy, gz, n_fourier,
             n_hidden, tf_points, act_param, seg, n_seg_max, stepsize,
             density_min, inv_range, early_alpha, bmin, bsize);
  P.seg_active = seg_active;
  P.mask_cols = mask_cols;
  FwdOut O;
  O.out = out;
  O.tile_samples = tile_samples;
  O.carries = reinterpret_cast<float4*>(carries);
  O.seg_count = seg_count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32 ? launch<F32Table>(P, O, n_rays, st)
                   : launch<Bf16Table>(P, O, n_rays, st);
}
