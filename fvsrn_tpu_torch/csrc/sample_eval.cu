// The SRN sample evaluator (sm_90a): density, and optionally its gradient
// with respect to the normalized position, at arbitrary positions.
//
// Replaces the TPU kernel fvsrn_tpu/ops/fused_eval.py:_eval_kernel, which
// make_fused_eval launches for every batch of scattered positions (one
// launch per delta-tracking round of Monte-Carlo path tracing). It computes
// the same function, not the TPU's layout: the JAX kernel gathers one
// (N, 128) row of an 8x neighborhood table per position, moves channels
// onto sublanes and evaluates a polynomial sine, all for Mosaic. Here each
// position reads its 8 trilinear corners from the channel-last latent
// table of the per-segment engine (<= 16 channels: 2 MiB in float32 for
// the flagship's 16x32^3 grid, resident in L2) and the network takes the
// engine's packed weights, hidden width 32/48/64, every activation,
// direction input, bf16 or float32 table.
//
// Values (the instance Monte-Carlo tracking launches): the warp-owned tile
// of the forward marches (warp_mlp.cuh). A warp takes 32 consecutive
// positions as one tile of 32 rows: lane m builds row m (Fourier features
// by the SFU after a Cody-Waite reduction, the trilinear fetch, position,
// direction), every layer runs as TF32 three-pass mma.sync products with
// the activation in the epilogue (width 32 takes both 16-row blocks in one
// run), the output layer lands in the tile's head buffer and lane m
// applies the density head and writes its value. The positions are
// independent, so there is no list and no compositing. Rows past n in the
// last tile are built from the box's center and never written. The grid is
// persistent: as many blocks as the card holds resident (blocks an SM by
// the shared-memory plan, times the SMs) or fewer when the call has fewer
// tiles; each block stages the weights once and its warps stride over the
// tiles, so a launch of 2^18 positions (8192 tiles) does not restage the
// plan a thousand times from L2.
//
// The gradient instance (Monte-Carlo tracking launches it once a round
// for a gradient-scaled TF, raytracer/montecarlo.py) keeps the first
// version's scalar code: one thread a position, the engine's per-sample
// `network` recording the evaluation (`Keep`), then position_grad.cuh's
// sweep, the one the fused forwards' normals instances run on their
// samples.
//
// Out-of-box positions are evaluated too (the corners clamp to the grid's
// border, as the JAX package's edge-padded table does).
//
// Bound: operations (a flagship position costs ~7.6 kFLOP and ~50
// transcendentals against 16 bytes in and out); the products run at three
// TF32 tensor-core passes each (float32-accurate), the Fourier features,
// activations and fetch on the CUDA cores and the SFU.

#include <atomic>

#include "position_grad.cuh"
#include "segment_tile.cuh"

namespace {

using namespace march;
using namespace segment;
using namespace wmlp;

constexpr int kThreads = kMaxWarps * kRows;   // the largest value block
constexpr int kBlock = 128;                   // the gradient instance's

struct EvalArgs {
  const float* pos01;   // (n, 3) positions in the box's [0, 1]^3
  const float* dirs;    // (n, 3) directions, or null (a zero direction)
  float* out;           // (n,) values, or (n, 4) [value, d/dx, d/dy, d/dz]
  int n;
};

// The value instance: every warp strides over the tiles of 32 positions
// (tile t of the call: positions 32 t .. 32 t + 31), the block's weights
// staged once. Shared memory: the plan `pl` (warp_mlp.cuh), no TF block.
template <int H, typename Table>
__global__ void __launch_bounds__(kThreads, 2) sample_eval_kernel(
    const Seg P, const EvalArgs A, const FLayer L) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const FPlan& pl = L.pl;
  const FDims& D = L.D;
  stage_weights<H>(P, pl, D, sm);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tile = sm + pl.tiles + warp * pl.per_warp;
  float* ybuf = tile + kRows * pl.lds;
  const bool dirs = D.has_dir && A.dirs != nullptr;
  const int n_tiles = (A.n + kRows - 1) / kRows;
#pragma unroll 1
  for (int t = blockIdx.x * pl.warps + warp; t < n_tiles;
       t += gridDim.x * pl.warps) {
    const int i = t * kRows + lane;
    const int cnt = min(kRows, A.n - t * kRows);
    float x[3] = {0.5f, 0.5f, 0.5f}, d[3] = {0.0f, 0.0f, 0.0f};
    if (lane < cnt) {
      const float* p = A.pos01 + (size_t)i * 3;
      x[0] = p[0];
      x[1] = p[1];
      x[2] = p[2];
      if (dirs) {
        const float* q = A.dirs + (size_t)i * 3;
        d[0] = q[0];
        d[1] = q[1];
        d[2] = q[2];
      }
    }
    build_row<Table>(D, sm, pl, tile + lane * pl.lds, x, d);
    __syncwarp();
    layers_any<H>(pl, D, sm, tile, ybuf, cnt > 16 ? 2 : 1);
    __syncwarp();
    if (lane < cnt) {
      float v[4];
      head_value(D.head, ybuf + 4 * lane, v);
      A.out[i] = v[0];
    }
    __syncwarp();   // the tile and ybuf are read before the next tile
  }
}

// The gradient instance (one thread a position, 128 threads a block).
// Shared memory: the packed weights, then (from a 16-byte boundary) the
// activation scratch, H rows of kBlock floats.
template <int H, typename Table>
__global__ void __launch_bounds__(kBlock) sample_grad_kernel(
    const Seg P, const EvalArgs A) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < P.n_weights; i += kBlock) sw[i] = P.weights[i];
  __syncthreads();
  const Wts N = carve(sw, P, H);
  float* hs = sw + scratch_offset(P.n_weights) + threadIdx.x;

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= A.n) return;
  const float* p = A.pos01 + (size_t)i * 3;
  const float x0 = p[0], x1 = p[1], x2 = p[2];
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (P.has_dir && A.dirs != nullptr) {
    const float* d = A.dirs + (size_t)i * 3;
    d0 = d[0];
    d1 = d[1];
    d2 = d[2];
  }
  float v[4];
  Keep<H> keep;
  network<H, Table, kBlock, true>(P, N, hs, x0, x1, x2, d0, d1, d2, v, &keep);
  float g[3];
  position_grad<H, Table, kBlock>(P, N, keep, v, hs, g);
  reinterpret_cast<float4*>(A.out)[i] = make_float4(v[0], g[0], g[1], g[2]);
}

constexpr int kDevices = 64;   // devices whose attributes are cached

// The current device's index (0 when it is past kDevices: its attributes
// are then read and set at every launch).
int device_slot(int* dev) {
  cudaGetDevice(dev);
  return *dev < kDevices ? *dev : -1;
}

// The SMs of device `dev`, read from the runtime once a device.
int sm_count(int dev, int slot) {
  static std::atomic<int> cached[kDevices];
  int sms = slot >= 0 ? cached[slot].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (slot >= 0) cached[slot].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

int sm_count() {
  int dev = 0;
  const int slot = device_slot(&dev);
  return sm_count(dev, slot);
}

// Let `kernel` take `smem` bytes of dynamic shared memory on the device in
// `slot`: one runtime call an instance and device for each new maximum
// (`allowed` is the instance's own record), none at the launches after.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<int>* allowed, int slot,
                       size_t smem) {
  if (slot >= 0 && (int)smem <= allowed[slot].load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && slot >= 0)
    allowed[slot].store((int)smem, std::memory_order_relaxed);
  return e;
}

template <int H, typename Table>
int launch_values(const Seg& P, const EvalArgs& A, const FLayer& L,
                  cudaStream_t stream) {
  static std::atomic<int> allowed[kDevices];
  const size_t smem = (size_t)L.pl.total;
  int dev = 0;
  const int slot = device_slot(&dev);
  const cudaError_t e =
      allow_smem(sample_eval_kernel<H, Table>, allowed, slot, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = persistent_blocks(A.n, L.pl, sm_count(dev, slot));
  if (blocks > 0)
    sample_eval_kernel<H, Table><<<blocks, L.pl.warps * kRows, smem,
                                   stream>>>(P, A, L);
  return (int)cudaGetLastError();
}

template <int H, typename Table>
int launch_grad(const Seg& P, const EvalArgs& A, cudaStream_t stream) {
  static std::atomic<int> allowed[kDevices];
  const size_t smem =
      (scratch_offset(P.n_weights) + (size_t)H * kBlock) * sizeof(float);
  if (smem > 48 * 1024) {
    int dev = 0;
    const cudaError_t e = allow_smem(sample_grad_kernel<H, Table>, allowed,
                                     device_slot(&dev), smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (A.n + kBlock - 1) / kBlock;
  if (blocks > 0)
    sample_grad_kernel<H, Table><<<blocks, kBlock, smem, stream>>>(P, A);
  return (int)cudaGetLastError();
}

template <int H, typename Table>
int launch(const Seg& P, const EvalArgs& A, const FLayer& L, int want_grad,
           cudaStream_t stream) {
  return want_grad ? launch_grad<H, Table>(P, A, stream)
                   : launch_values<H, Table>(P, A, L, stream);
}

template <typename Table>
int launch_width(const Seg& P, const EvalArgs& A, const FLayer& L,
                 int hidden, int want_grad, cudaStream_t stream) {
  switch (hidden) {
    case 32: return launch<32, Table>(P, A, L, want_grad, stream);
    case 48: return launch<48, Table>(P, A, L, want_grad, stream);
    case 64: return launch<64, Table>(P, A, L, want_grad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The call's parameters as the per-segment engine's (no rays, two dummy
// TF points in the packed weights, none in the plan).
Seg eval_seg(const void* table, const float* weights, int n_weights, int n,
             int gx, int gy, int gz, int chunks, int n_fourier, int n_hidden,
             int act, float act_param, int head, int has_dir) {
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  return make_seg(nullptr, nullptr, table, weights, n_weights, n, gx, gy, gz,
                  chunks, n_fourier, n_hidden, 2, act, act_param, head,
                  has_dir, 0, 0, 0, 0.0f, 1, 1, 1.0f, 0.0f, 1.0f, 2.0f,
                  zero3, zero3);
}

}  // namespace

// The value instance's launch for n positions at these widths:
// out = [plan bytes, warps a block, matrices pre-split, blocks of the
// persistent grid, SMs of the current device]. Returns 0, or -1 when no
// plan fits in 227 KB.
extern "C" int sample_eval_grid(int n, int hidden, int n_fourier, int chunks,
                                int n_hidden, int has_dir, long* out) {
  FLayer L;
  const Seg P = eval_seg(nullptr, nullptr, 0, n, 1, 1, 1, chunks, n_fourier,
                         n_hidden, kNone, 1.0f, kDensity, has_dir);
  if (!fill_layer(L, P, hidden, 0)) return -1;
  const int sms = sm_count();
  out[0] = L.pl.total;
  out[1] = L.pl.warps;
  out[2] = L.pl.pre;
  out[3] = persistent_blocks(n, L.pl, sms);
  out[4] = sms;
  return 0;
}

// Evaluate the density SRN at n positions `pos01` ((n, 3), in the box's
// [0, 1]^3): `out` (n,) values, or with want_grad (n, 4) [value, d value /
// d pos01]. Weights packed as segment_common.cuh's `Wts` (any two TF
// points) with the padded hidden width `hidden` (32, 48 or 64); `table` is
// the channel-last latent grid (gz, gy, gx, 16 * chunks), bf16 (table_f32 =
// 0) or float32, not read with chunks = 0. `dirs` ((n, 3)) is read with
// has_dir only; null is a zero direction. Density heads only. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sample_eval_launch(const float* pos01, const float* dirs,
                                  const void* table, int table_f32,
                                  const float* weights, int n_weights,
                                  float* out, int n, int gx, int gy, int gz,
                                  int chunks, int n_fourier, int n_hidden,
                                  int hidden, int act, float act_param,
                                  int head, int has_dir, int want_grad,
                                  void* stream) {
  const Seg P = eval_seg(table, weights, n_weights, n, gx, gy, gz, chunks,
                         n_fourier, n_hidden, act, act_param, head, has_dir);
  if (!seg_valid(P) || head > kDensityDirect || n < 0)
    return (int)cudaErrorInvalidValue;
  FLayer L;
  if (!fill_layer(L, P, hidden, 0)) return (int)cudaErrorInvalidValue;
  EvalArgs A;
  A.pos01 = pos01;
  A.dirs = dirs;
  A.out = out;
  A.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return table_f32
             ? launch_width<F32Table>(P, A, L, hidden, want_grad, st)
             : launch_width<Bf16Table>(P, A, L, hidden, want_grad, st);
}
