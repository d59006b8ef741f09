// The JAX package's TPU measurement probes, as kernels for sm_90a.
//
// Replaces the four TPU kernels of the JAX package's measurement tools:
//  - tools/proto_mega.py:kernel, the megakernel prototype: a (T, S) grid
//    of (ray tile, segment) programs over a resident 3-D table. Each
//    program reduces three ray rows of its 128-ray tile to scalar slice
//    starts, sums a (BZ, BY, BX) box of the table at those starts into the
//    tile's output block (zeroed at s = 0), and adds ones into a table of
//    counts at the same box (the TPU kept it in persistent scratch and
//    flushed it at the last program);
//  - tools/probe_lane_gather.py:probe_gather_single's and
//    probe_gather_chunked's kernels: out[r, n] = tab[r, idx[r, n]], f32 out,
//    from a (128, K) table (K = 128, f32 or bf16; K = 928 f32, which the
//    TPU cut into 128-lane chunks with a masked select-and-sum);
//  - tools/probe_lane_gather.py:probe_onehot's kernel, the sub-box latent
//    resolve: out[c, n] = tab[lrow[n], c] from a bf16 (rows, C) table into
//    f32 (C, N), which the TPU computed as a one-hot contraction on the MXU.
//
// Designed for the card, not block by block:
//  - proto: one block per 128-ray tile loops over the tile's S segments;
//    the TPU's sequential grid dimension is that loop. Its first 128
//    threads hold one ray each; block min-reductions of rays rows 0-2 give
//    the starts; all 1024 threads share the box (24 elements each at the
//    tool's shapes), summed by a block reduction; the output accumulates
//    in registers and is written once. The counts table replaces the
//    TPU's persistent scratch: atomicAdd(1.0f) into an output the wrapper
//    zeroes (sums of 1.0 are exact in any order).
//  - gathers: one block per table row and 1024 outputs; the row is staged
//    in shared memory (at most 928 floats) and each thread gathers four
//    neighbouring outputs with one 16-byte index load and one 16-byte
//    store. A chunked gather buys nothing here, so rows 9 and 10 share the
//    device code; each has its own entry point and launch count.
//  - resolve: a direct gather, no one-hot. One block per 32 samples: each
//    warp reads whole table rows (8 bytes a lane, 256 contiguous bytes a
//    row at C = 128), every load of a thread in flight at once, and the
//    block writes the transpose through shared memory, 128 contiguous
//    bytes per warp store.
// Indices outside the table give 0, as the masked select and the one-hot
// column give on the TPU.
//
// Bound: bytes, all four. The gathers and the resolve move their indices
// in and their f32 output out (8.4 MB for a (128, 8192) gather, 4.2 MB for
// the resolve): ~2.5 and ~1.3 us at 3.35 TB/s. The prototype writes its
// 2.96 MB counts table and reads 12 boxes of 98 KB: ~1.3 us, so launch
// latency sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;       // rays per tile (the TPU's lane width)
constexpr int kRows = 8;         // rows of the ray packet
constexpr int kProtoBlock = 1024;  // threads a tile: its rays, then the box
constexpr int kGatherBlock = 256;
constexpr int kPerThread = 4;
constexpr int kResolveN = 32;    // samples per resolve block
constexpr int kResolveBlock = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {  // bf16 bits
  return __uint_as_float((uint32_t)v << 16);
}

// floor division by 8, as the JAX kernel's `//` on int32
__device__ __forceinline__ int floor_div8(int a) {
  return a >= 0 ? a / 8 : -((-a + 7) / 8);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Block-wide reduction of one float per thread (kProtoBlock threads); `red`
// holds kProtoBlock / 32 floats. Every thread gets the result.
template <bool kMin>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMin ? fminf(v, w) : v + w;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kProtoBlock / 32; ++w)
    r = kMin ? fminf(r, red[w]) : r + red[w];
  return r;
}

struct Proto {
  const float* rays;   // (8, R) row-major, tile t in columns [128t, 128t+128)
  const float* tab;    // (Z, Y, X)
  float* out;          // (8, R)
  float* counts;       // (Z, Y, X), zeroed by the wrapper
  int n_rays, n_seg, Z, Y, X, bz, by, bx;
};

__global__ void __launch_bounds__(kProtoBlock) proto_kernel(const Proto P) {
  __shared__ float red[kProtoBlock / 32];
  const bool ray_lane = threadIdx.x < kTile;
  const int col = blockIdx.x * kTile + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  float r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    r[i] = ray_lane ? P.rays[(size_t)i * P.n_rays + col] : inf;
  // the slice starts: lane minima to scalars, as float -> int32
  const int z0 = (int)block_reduce<true>(r[0], red);
  const int y0 = (int)block_reduce<true>(r[1], red);
  const int x0 = (int)block_reduce<true>(r[2], red);
  const int ymin = clampi(floor_div8(y0) * 8, 0, P.Y - P.by);
  const int xoff = clampi(x0, 0, (P.X - P.bx) / 128) * 128;
  const int plane = P.by * P.bx;
  const int n_box = P.bz * plane;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;  // the s == 0 init
  for (int s = 0; s < P.n_seg; ++s) {
    const int zmin = clampi(z0 + s, 0, P.Z - P.bz);
    float part = 0.0f;
#pragma unroll 8
    for (int e = threadIdx.x; e < n_box; e += kProtoBlock) {
      const int z = e / plane, rem = e - z * plane;
      const int y = rem / P.bx, x = rem - y * P.bx;
      const size_t at = ((size_t)(zmin + z) * P.Y + (ymin + y)) * P.X
                        + (xoff + x);
      part += P.tab[at];
      atomicAdd(P.counts + at, 1.0f);
    }
    const float val = block_reduce<false>(part, red);
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] += val + r[i];
  }
  if (!ray_lane) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) P.out[(size_t)i * P.n_rays + col] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(kGatherBlock)
    gather_kernel(const T* tab, int k, const int* idx, float* out, int n) {
  extern __shared__ float row[];
  const int r = blockIdx.y;
  for (int i = threadIdx.x; i < k; i += kGatherBlock)
    row[i] = to_float(tab[(size_t)r * k + i]);
  __syncthreads();
  const int n0 = (blockIdx.x * kGatherBlock + threadIdx.x) * kPerThread;
  if (n0 >= n) return;
  const size_t at = (size_t)r * n + n0;
  const int4 q = *reinterpret_cast<const int4*>(idx + at);
  const int ii[kPerThread] = {q.x, q.y, q.z, q.w};
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    v[j] = (ii[j] >= 0 && ii[j] < k) ? row[ii[j]] : 0.0f;
  *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kResolveBlock)
    resolve_kernel(const uint16_t* tab, int rows, int c, const int* lrow,
                   float* out, int n) {
  extern __shared__ float s[];          // (kResolveN, c + 1)
  const int n0 = blockIdx.x * kResolveN;
  const int stride = c + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each warp reads whole table rows, 4 channels (8 bytes) a lane: all of
  // a thread's loads are independent and in flight together
#pragma unroll
  for (int q = 0; q < kResolveN / (kResolveBlock / 32); ++q) {
    const int j = warp + q * (kResolveBlock / 32);
    const int sample = n0 + j;
    const int l = sample < n ? lrow[sample] : -1;
    const bool inside = l >= 0 && l < rows;
    for (int ch = 4 * lane; ch < c; ch += 128) {
      uint2 v = make_uint2(0u, 0u);
      if (inside)
        v = *reinterpret_cast<const uint2*>(tab + (size_t)l * c + ch);
      float* d = s + j * stride + ch;
      d[0] = __uint_as_float(v.x << 16);
      d[1] = __uint_as_float(v.x & 0xffff0000u);
      d[2] = __uint_as_float(v.y << 16);
      d[3] = __uint_as_float(v.y & 0xffff0000u);
    }
  }
  __syncthreads();
  // the transpose out: a warp stores one channel's 32 samples (128 bytes)
  for (int e = threadIdx.x; e < kResolveN * c; e += kResolveBlock) {
    const int ch = e / kResolveN, j = e % kResolveN;
    if (n0 + j < n) out[(size_t)ch * n + n0 + j] = s[j * stride + ch];
  }
}

template <typename T>
int launch_gather(const void* tab, int rows, int k, const int* idx,
                  float* out, int n, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || n % kPerThread || k <= 0
      || k * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kGatherBlock * kPerThread - 1)
                  / (kGatherBlock * kPerThread), rows);
  gather_kernel<T><<<grid, kGatherBlock, k * sizeof(float), stream>>>(
      static_cast<const T*>(tab), k, idx, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// rays (8, n_rays) and tab (Z, Y, X) float32, n_rays a multiple of 128;
// out (8, n_rays); counts (Z, Y, X) zeroed by the caller. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int proto_mega_launch(const float* rays, const float* tab,
                                 float* out, float* counts, int n_rays,
                                 int n_seg, int Z, int Y, int X, int bz,
                                 int by, int bx, void* stream) {
  if (n_rays <= 0 || n_rays % kTile || bz > Z || by > Y || bx > X
      || bx % 128 || X % 128)
    return (int)cudaErrorInvalidValue;
  Proto P{rays, tab, out, counts, n_rays, n_seg, Z, Y, X, bz, by, bx};
  proto_kernel<<<n_rays / kTile, kProtoBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// out[r, n] = tab[r, idx[r, n]] (0 outside [0, k)): tab (rows, k) float32
// (tab_bf16 = 0) or bf16 bits (1), idx (rows, n) int32, out (rows, n)
// float32, n a multiple of 4, idx and out 16-byte aligned.
extern "C" int gather_single_launch(const void* tab, int tab_bf16, int rows,
                                    int k, const int* idx, float* out, int n,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tab_bf16 ? launch_gather<uint16_t>(tab, rows, k, idx, out, n, st)
                  : launch_gather<float>(tab, rows, k, idx, out, n, st);
}

// The same gather from a wide float32 table (rows, k), k up to 12288.
extern "C" int gather_chunked_launch(const float* tab, int rows, int k,
                                     const int* idx, float* out, int n,
                                     void* stream) {
  return launch_gather<float>(tab, rows, k, idx, out, n,
                              static_cast<cudaStream_t>(stream));
}

// out[ch, j] = tab[lrow[j], ch] (0 outside [0, rows)): tab (rows, c) bf16
// bits, c a multiple of 4, lrow (n,) int32, out (c, n) float32.
extern "C" int onehot_resolve_launch(const uint16_t* tab, int rows, int c,
                                     const int* lrow, float* out, int n,
                                     void* stream) {
  if (rows <= 0 || c <= 0 || c % 4 || n <= 0
      || (size_t)kResolveN * (c + 1) * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  resolve_kernel<<<(n + kResolveN - 1) / kResolveN, kResolveBlock,
                   kResolveN * (c + 1) * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(tab, rows, c, lrow,
                                                        out, n);
  return (int)cudaGetLastError();
}
