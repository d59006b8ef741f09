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
//  - proto: two launches over the whole card. The TPU kernel's counts are
//    its persistent scratch, zeroed once and incremented once per (tile,
//    segment) box, so a cell's count is the number of the T*S boxes that
//    cover it: the first launch (proto_fill, a grid of up to two blocks an
//    SM) has every block reduce ray rows 0-2 of each tile to the T*S box
//    starts in its shared memory (the lane minima, as float -> int32),
//    then write every cell's count by testing it against the boxes (four
//    cells a thread, one coalesced 16-byte store: no memset, no atomics),
//    then sum the boxes' table values in items of 8 box rows, one block
//    reduction and one partial sum an item. The second (proto_out, one
//    128-thread block a tile) folds each box's partials in a fixed order
//    and writes out = sum_s (sum_s + r) as the TPU's output block
//    accumulates it. Counts are exact; the output is summed in another
//    order than the plain version's (1e-5 relative).
//  - gathers: one block per table row and 1024 outputs; the row is staged
//    in shared memory (at most 928 floats) and each thread gathers four
//    neighbouring outputs with one 16-byte index load and one 16-byte
//    store. A chunked gather buys nothing here, so rows 9 and 10 share the
//    device code; each has its own entry point and launch count.
//  - resolve: a direct gather, no one-hot, transposed in registers. Four
//    lanes share a table row: a warp takes 32 samples and 32 channels
//    (V = 8 a lane where C % 8 == 0, else 4). Lane (a, b) reads the 4 row
//    ids of samples 4a..4a+3 (one 16-byte load), then its 16 bytes of
//    each of those 4 rows (four rows' 64-byte spans an instruction, all
//    four loads in flight), and writes each channel's 4 samples as one
//    float4: a store instruction fills four channel rows' 128-byte
//    lines, and a block's four warps take consecutive sample groups, so
//    a block writes 512 contiguous bytes of each of its channel rows. No
//    shared memory: nothing to stage and no bank to conflict on. The
//    table (a few hundred KB at most) stays in L1 and L2. At (128, 8192)
//    that is 1,024 warps in 256 blocks of four, about two blocks an SM.
//    Every warp walks the chain row ids -> rows -> stores, so the loads'
//    latency comes before the 4.2 MB drain; fvsrn_tpu_torch/tools/
//    resolve_variants.py times the variants and the stores alone.
// Indices outside the table give 0, as the masked select and the one-hot
// column give on the TPU.
//
// Bound: bytes, all four. The gathers and the resolve move their indices
// in and their f32 output out (8.4 MB for a (128, 8192) gather, 4.2 MB for
// the resolve): ~2.5 and ~1.3 us at 3.35 TB/s. The prototype writes its
// 2.96 MB counts table and reads 12 boxes of 98 KB: ~1 us, so its two
// launches' latency sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;        // rays per tile (the TPU's lane width)
constexpr int kRows = 8;          // rows of the ray packet
constexpr int kProtoBlock = 256;  // threads a block of proto_fill
constexpr int kChunkRows = 8;     // box rows a block sums into one partial
constexpr int kMaxBoxes = 2048;   // T * S: 24 KB of box starts
constexpr int kGatherBlock = 256;
constexpr int kPerThread = 4;
constexpr int kResolveWarps = 4;  // warps a resolve block

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

// Block-wide sum of one float per thread (kProtoBlock threads); `red`
// holds kProtoBlock / 32 floats. Every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // red is free: the last item's sum is read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kProtoBlock / 32; ++w) r += red[w];
  return r;
}

struct Proto {
  const float* rays;   // (8, R) row-major, tile t in columns [128t, 128t+128)
  const float* tab;    // (Z, Y, X)
  float* out;          // (8, R)
  float* counts;       // (Z, Y, X), written whole
  float* part;         // (T * S, n_chunks) partial box sums
  int n_rays, n_seg, Z, Y, X, bz, by, bx, n_chunks;
};

// The (z, y, x) start of box b = t * S + s into st[3 b .. 3 b + 2], every
// box of the call, by the block's warps: a warp reduces one ray row of one
// tile (128 floats, four a lane) to its minimum, as float -> int32, and
// clips it as the TPU kernel does.
__device__ __forceinline__ void box_starts(const Proto& P, int* st) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int tiles = P.n_rays / kTile;
  for (int job = threadIdx.x >> 5; job < 3 * tiles; job += warps) {
    const int t = job / 3, row = job - 3 * t;
    const float4 v = reinterpret_cast<const float4*>(
        P.rays + (size_t)row * P.n_rays + (size_t)t * kTile)[lane];
    float m = fminf(fminf(v.x, v.y), fminf(v.z, v.w));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int r0 = (int)m;
    for (int s = lane; s < P.n_seg; s += 32) {
      int* b = st + 3 * (t * P.n_seg + s) + row;
      if (row == 0) *b = clampi(r0 + s, 0, P.Z - P.bz);
      else if (row == 1) *b = clampi(floor_div8(r0) * 8, 0, P.Y - P.by);
      else *b = clampi(r0, 0, (P.X - P.bx) / 128) * 128;
    }
  }
}

// Every cell's count (grid-stride, four cells a thread a step) and every
// item's partial box sum (block-stride over T * S * n_chunks items).
__global__ void __launch_bounds__(kProtoBlock) proto_fill(const Proto P) {
  extern __shared__ int st[];   // 3 * T * S box starts
  __shared__ float red[kProtoBlock / 32];
  box_starts(P, st);
  __syncthreads();
  const int n_box = P.n_rays / kTile * P.n_seg;
  const int X4 = P.X / 4;
  const long cells4 = (long)P.Z * P.Y * X4;
  for (long q = (long)blockIdx.x * blockDim.x + threadIdx.x; q < cells4;
       q += (long)gridDim.x * blockDim.x) {
    const long zy = q / X4;
    const int x = (int)(q - zy * X4) * 4;
    const int y = (int)(zy % P.Y), z = (int)(zy / P.Y);
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    for (int b = 0; b < n_box; ++b) {
      const int* s = st + 3 * b;
      if ((unsigned)(z - s[0]) < (unsigned)P.bz
          && (unsigned)(y - s[1]) < (unsigned)P.by) {
        const int dx = x - s[2];
        c0 += (unsigned)dx < (unsigned)P.bx ? 1.0f : 0.0f;
        c1 += (unsigned)(dx + 1) < (unsigned)P.bx ? 1.0f : 0.0f;
        c2 += (unsigned)(dx + 2) < (unsigned)P.bx ? 1.0f : 0.0f;
        c3 += (unsigned)(dx + 3) < (unsigned)P.bx ? 1.0f : 0.0f;
      }
    }
    reinterpret_cast<float4*>(P.counts)[q] = make_float4(c0, c1, c2, c3);
  }
  // the box sums: item = (box, kChunkRows rows of bx floats), 16-byte loads
  const int rows = P.bz * P.by, row4 = P.bx / 4;
  for (int it = blockIdx.x; it < n_box * P.n_chunks; it += gridDim.x) {
    const int b = it / P.n_chunks, r0 = (it - b * P.n_chunks) * kChunkRows;
    const int* s = st + 3 * b;
    const int n4 = min(kChunkRows, rows - r0) * row4;
    float part = 0.0f;
    for (int e = threadIdx.x; e < n4; e += kProtoBlock) {
      const int r = r0 + e / row4;
      const int z = s[0] + r / P.by, y = s[1] + r % P.by;
      const float4 v = reinterpret_cast<const float4*>(
          P.tab + ((size_t)z * P.Y + y) * P.X + s[2])[e % row4];
      part += (v.x + v.y) + (v.z + v.w);
    }
    part = block_sum(part, red);
    if (threadIdx.x == 0) P.part[it] = part;
  }
}

// One block a tile, one thread a ray: out[:, ray] = sum over s of (box
// sum_s + the ray's rows), box sums from their partials in order.
__global__ void __launch_bounds__(kTile) proto_out(const Proto P) {
  const int t = blockIdx.x, col = t * kTile + threadIdx.x;
  float r[kRows], acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    r[i] = P.rays[(size_t)i * P.n_rays + col];
    acc[i] = 0.0f;   // the s == 0 init
  }
  for (int s = 0; s < P.n_seg; ++s) {
    const float* pp = P.part + (size_t)(t * P.n_seg + s) * P.n_chunks;
    float val = 0.0f;
    for (int c = 0; c < P.n_chunks; ++c) val += pp[c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] += val + r[i];
  }
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

// bf16 bits -> float: the low and the high half of a 32-bit word
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// V channels of one table row: V / 2 words, one 16-byte (V = 8) or
// 8-byte (V = 4) load; zeros for a row outside the table
template <int V> struct RowChunk { uint32_t w[V / 2]; };

template <int V>
__device__ __forceinline__ RowChunk<V> load_chunk(const uint16_t* tab,
                                                  int rows, int c, int l,
                                                  int ch0) {
  RowChunk<V> r;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) r.w[i] = 0u;
  if (l >= 0 && l < rows) {
    const uint16_t* src = tab + (size_t)l * c + ch0;
    if constexpr (V == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      r.w[0] = v.x; r.w[1] = v.y;
    }
  }
  return r;
}

constexpr int kRowLanes = 4;  // lanes that share a table row (B)

// out[ch, j] = tab[lrow[j], ch]. Lane (a, b) = (lane / B, lane % B) of a
// warp task (sample group, channel block): samples s0..s0+3 (s0 = the
// group's first + 4a), channels ch0..ch0+V-1 (ch0 = the block's first +
// V b). With `vec` (n % 4 == 0) its 4 row ids are one int4 and each
// channel's 4 samples one float4 (all in or all past n), else scalar.
template <int V, bool vec>
__global__ void __launch_bounds__(32 * kResolveWarps)
    resolve_kernel(const uint16_t* tab, int rows, int c, const int* lrow,
                   float* out, int n) {
  constexpr int kSamples = 4 * (32 / kRowLanes);   // a warp task's samples
  const int lane = threadIdx.x & 31;
  const long n_groups = ((long)n + kSamples - 1) / kSamples;
  const long task = (long)blockIdx.x * kResolveWarps + (threadIdx.x >> 5);
  const int blocks_c = (c + V * kRowLanes - 1) / (V * kRowLanes);
  if (task >= n_groups * blocks_c) return;
  // a block's warps take consecutive sample groups of one channel block
  const int cb = (int)(task / n_groups);
  const long sg = task - (long)cb * n_groups;
  const int s0 = (int)(sg * kSamples) + 4 * (lane / kRowLanes);
  const int ch0 = (cb * kRowLanes + lane % kRowLanes) * V;
  if (ch0 >= c) return;
  int l[4] = {-1, -1, -1, -1};
  if constexpr (vec) {
    if (s0 < n) {
      const int4 q = *reinterpret_cast<const int4*>(lrow + s0);
      l[0] = q.x; l[1] = q.y; l[2] = q.z; l[3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s0 + j < n) l[j] = lrow[s0 + j];
  }
  RowChunk<V> r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = load_chunk<V>(tab, rows, c, l[j], ch0);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (k & 1) ? bf16_hi(r[j].w[k >> 1]) : bf16_lo(r[j].w[k >> 1]);
    float* dst = out + (size_t)(ch0 + k) * n + s0;
    if constexpr (vec) {
      if (s0 < n)
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < n) dst[j] = v[j];
    }
  }
}

template <int V, bool vec>
int launch_resolve(const uint16_t* tab, int rows, int c, const int* lrow,
                   float* out, int n, cudaStream_t stream) {
  constexpr int kSamples = 4 * (32 / kRowLanes);
  const long warps = ((long)n + kSamples - 1) / kSamples
                     * ((c + V * kRowLanes - 1) / (V * kRowLanes));
  const long blocks = (warps + kResolveWarps - 1) / kResolveWarps;
  resolve_kernel<V, vec><<<(unsigned)blocks, 32 * kResolveWarps, 0,
                           stream>>>(tab, rows, c, lrow, out, n);
  return (int)cudaGetLastError();
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

// rays (8, n_rays) and tab (Z, Y, X) float32, n_rays a multiple of 128, X
// and bx multiples of 128, all 16-byte aligned; out (8, n_rays) and
// counts (Z, Y, X) are written whole; part holds n_part >= T * S *
// ceil(bz * by / 8) floats of scratch (the partial box sums). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int proto_mega_launch(const float* rays, const float* tab,
                                 float* out, float* counts, float* part,
                                 int n_part, int n_rays, int n_seg, int Z,
                                 int Y, int X, int bz, int by, int bx,
                                 void* stream) {
  const long n_box = (long)(n_rays / kTile) * n_seg;
  const int chunks = (bz * by + kChunkRows - 1) / kChunkRows;
  if (n_rays <= 0 || n_rays % kTile || n_seg < 0 || n_box > kMaxBoxes
      || bz <= 0 || by <= 0 || bz > Z || by > Y || bx > X || bx % 128
      || X % 128 || n_part < n_box * chunks)
    return (int)cudaErrorInvalidValue;
  Proto P{rays, tab, out, counts, part, n_rays, n_seg, Z, Y, X, bz, by, bx,
          chunks};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks for one float4 of counts a thread, at most two an SM
  const long cells4 = (long)Z * Y * (X / 4);
  long blocks = (cells4 + kProtoBlock - 1) / kProtoBlock;
  if (blocks > 2L * sms) blocks = 2L * sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  proto_fill<<<(int)blocks, kProtoBlock, 3 * n_box * sizeof(int), st>>>(P);
  proto_out<<<n_rays / kTile, kTile, 0, st>>>(P);
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
// bits, c a multiple of 4, lrow (n,) int32, out (c, n) float32; tab, lrow
// and out 16-byte aligned.
extern "C" int onehot_resolve_launch(const uint16_t* tab, int rows, int c,
                                     const int* lrow, float* out, int n,
                                     void* stream) {
  if (rows <= 0 || c <= 0 || c % 4 || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 8 == 0)
    return n % 4 ? launch_resolve<8, false>(tab, rows, c, lrow, out, n, st)
                 : launch_resolve<8, true>(tab, rows, c, lrow, out, n, st);
  return n % 4 ? launch_resolve<4, false>(tab, rows, c, lrow, out, n, st)
               : launch_resolve<4, true>(tab, rows, c, lrow, out, n, st);
}
