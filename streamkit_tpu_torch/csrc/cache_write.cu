// SPDX-License-Identifier: Apache-2.0
//
// Windowed ring write into the streaming Whisper caches, written for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C entry point
// and loaded through ctypes (streamkit_tpu_torch/ops/cache_write.py).
//
// Replaces the TPU kernels of streamkit_tpu/ops/cache_write.py:
//   windowed_write        -> _kernel   (pl.pallas_call :117)
//   windowed_write_groups -> _kernel4  (pl.pallas_call :209)
// Both compute, in place,
//   cache[g, s, f, (pos[s] + i) mod T] = upd[g, s, f, i]   for i < min(lim[s], c),
// and leave every other column (and every lim = 0 row) untouched; pos may lie
// outside [0, T). The first is the second with G = 1. One launch takes up to
// kMaxPairs (cache, upd) pairs that share S, pos and lim, each with its own
// G, F, T, c and element size, from a descriptor table passed by value
// (__grid_constant__: no device copy, no host sync). The fused streaming step
// writes its four encoder caches and their scales in one launch and its two
// decoder folds in another.
//
// Bound on an H100 SXM: bytes. Counted as each useful byte read once and
// written once, 2 * G * F * sum_s min(lim[s], c) * itemsize: at the int8
// encoder caches (G = 32 layers, S = 8 slots, F = 20 heads x 64, c = 16)
// 10.5 MB, 3.13 us at 3.35 TB/s. What the layout adds to that: the cache is
// [G, S, F, T], time minor, so a row's window is c * itemsize bytes (16 for
// the int8 caches) inside a row of T * itemsize bytes, and it touches one or
// two 32-byte sectors (1.25 on average at the 8-aligned starts the encoder
// writes at). A write into a cold L2 therefore moves at least the 5.2 MB of
// upd plus 1.25 * 32 bytes per row, about 18 MB (5.5 us at the sequential
// rate), and the sectors lie 512 bytes apart, a random pattern: measured on
// an H100 by streamkit_tpu_torch/tools/k2_probe.py (numbers in PERF.md),
// 327,680 such rows take 13 us cold for full-sector writes, and about 26-28
// us for the partial ones this write needs, whether the L2 merges them or
// the kernel reads and rewrites whole sectors. The layout [L, S, H*hd, T] is
// the reference's and the history attention (K3) reads it, so it stays.
//
// Design, from what bounds it:
// - The grid is indexed by the window's owner: blockIdx.y = slot s,
//   blockIdx.x = (pair, group g, block of kRows feature rows). pos[s],
//   lim[s], the wrapped start, the split before and after the wrap and the
//   access widths are computed once per CTA. They are CTA-uniform, so no
//   branch on them diverges, and a CTA whose lim is 0 exits at once. The
//   copy itself does no division and no modulo.
// - A row's window is cut into pieces of the widest access, 16, 8, 4, 2 or
//   1 bytes, that the runtime byte alignment of the destination (base, row
//   pitch, start, wrap point, length) allows; each lane copies one piece,
//   loading it with the widest access the source (base, row pitch) allows.
//   A row's pieces sit side by side in one warp, so one store instruction
//   carries the whole window and the L2 sees one request per sector: on the
//   card, two stores into one sector cost half as much again as one
//   (tools/k2_probe.py). The int8 caches at 16-aligned starts take one
//   16-byte piece per row, at 8-aligned ones two 8-byte pieces; the f32
//   scales four 16-byte pieces; the bf16 folds (3 columns at any start)
//   three 2-byte pieces. Consecutive lanes load consecutive pieces of upd,
//   and a thread loads up to kBatch pieces before it stores them, so their
//   latencies overlap. The copy is of raw bytes, so it is exact for every
//   dtype.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 8;
constexpr int kThreads = 256;
constexpr int kRows = 256;  // feature rows per CTA
constexpr int kBatch = 4;   // items a thread loads before it stores
constexpr long long kMaxWindowBytes = 1LL << 20;  // c * itemsize: keeps rows * pieces in an int

struct Pair {
  char* cache;      // [G, S, F, T], elements of esz bytes
  const char* upd;  // [G, S, F, c]
  long long rd;     // cache row bytes, T * esz
  int block0;       // this pair's first blockIdx.x
  int fblocks;      // CTAs per (g, s) row group
  int rs;           // upd row bytes, c * esz
  int F, T, c, esz;
};

struct Table {
  Pair p[kMaxPairs];
  const int* pos;  // [S] int32
  const int* lim;  // [S] int32
  int n, S;
};

// The widest access (at most 16 bytes) that every offset in `bits` allows.
__device__ __forceinline__ int widest(unsigned long long bits) {
  const unsigned long long low = bits & (~bits + 1ull);
  return low >= 16 ? 16 : (int)low;
}

// Byte j of a piece lives in b[j / 4] at bit 8 * (j % 4); j is a constant
// after unrolling, so b stays in registers.
template <int W>
__device__ __forceinline__ void load_bytes(const char* src, uint32_t (&b)[4], int j) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    b[j >> 2] = v.x, b[(j >> 2) + 1] = v.y;
  } else if constexpr (W == 4) {
    b[j >> 2] = __ldg(reinterpret_cast<const unsigned int*>(src));
  } else if constexpr (W == 2) {
    b[j >> 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(src)) << ((j & 3) * 8);
  } else {
    b[j >> 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned char*>(src)) << ((j & 3) * 8);
  }
}

template <int W>
__device__ __forceinline__ void store_piece(char* dst, const uint32_t (&b)[4]) {
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
  } else if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(b[0], b[1]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(dst) = b[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)b[0];
  } else {
    *reinterpret_cast<uint8_t*>(dst) = (uint8_t)b[0];
  }
}

// This CTA's `rows` rows: item i = (row i >> lg, piece i & (2^lg - 1)), so a
// row's pieces are adjacent lanes of one warp and go out in one store
// instruction. Piece k is bytes [k*WS, (k+1)*WS) of the window; WS divides
// the wrap point, so no piece straddles it, and WL divides WS and the upd
// row's pitch. A thread loads kBatch items (kThreads apart) before it
// stores any, so their load latencies overlap.
template <int WS, int WL>
__device__ __forceinline__ void copy_pieces(const char* __restrict__ src, char* __restrict__ dst, int rows,
                                            int rs, long long rd, long long start, int pieces, int lg) {
  const int items = rows << lg;
  for (int first = threadIdx.x; first < items; first += kBatch * kThreads) {
    uint32_t b[kBatch][4];
    bool live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int item = first + u * kThreads;
      const int r = item >> lg, k = item & ((1 << lg) - 1);
      live[u] = item < items && k < pieces;
      b[u][0] = b[u][1] = b[u][2] = b[u][3] = 0u;
      if (live[u]) {
        const char* s = src + (long long)r * rs + k * WS;
#pragma unroll
        for (int j = 0; j < WS; j += WL) load_bytes<WL>(s + j, b[u], j);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!live[u]) continue;
      const int item = first + u * kThreads;
      const int r = item >> lg, k = item & ((1 << lg) - 1);
      long long d = start + (long long)k * WS;
      if (d >= rd) d -= rd;  // w <= rd: one wrap at most
      store_piece<WS>(dst + (long long)r * rd + d, b[u]);
    }
  }
}

// The widest load WL <= WS that the source alignment `wl` allows.
template <int WS, int WL = WS>
__device__ __forceinline__ void copy_loading(int wl, const char* src, char* dst, int rows, int rs, long long rd,
                                             long long start, int pieces, int lg) {
  if constexpr (WL == 1) {
    copy_pieces<WS, 1>(src, dst, rows, rs, rd, start, pieces, lg);
  } else {
    if (wl >= WL) {
      copy_pieces<WS, WL>(src, dst, rows, rs, rd, start, pieces, lg);
    } else {
      copy_loading<WS, WL / 2>(wl, src, dst, rows, rs, rd, start, pieces, lg);
    }
  }
}

__global__ void __launch_bounds__(kThreads) windowed_write_kernel(const __grid_constant__ Table t) {
  // CTA-uniform: the pair, the slot, its window and the access widths
  Pair p = t.p[0];
#pragma unroll
  for (int i = 1; i < kMaxPairs; ++i) {
    if (i < t.n && (int)blockIdx.x >= t.p[i].block0) p = t.p[i];
  }
  const int s = blockIdx.y;
  const int lim = min(t.lim[s], p.c);
  if (lim <= 0) return;
  int start = t.pos[s] % p.T;
  if (start < 0) start += p.T;
  const long long start_b = (long long)start * p.esz;
  const int w = lim * p.esz;
  const long long before_wrap = min((long long)w, p.rd - start_b);
  const int ws = widest((unsigned long long)(uintptr_t)p.cache | (unsigned long long)p.rd |
                        (unsigned long long)start_b | (unsigned long long)before_wrap | (unsigned long long)w);
  const int wl = widest((unsigned long long)(uintptr_t)p.upd | (unsigned long long)p.rs);
  const int pieces = w / ws;
  const int lg = pieces > 1 ? 32 - __clz(pieces - 1) : 0;
  const int local = (int)blockIdx.x - p.block0;
  const int g = local / p.fblocks;
  const int f0 = (local - g * p.fblocks) * kRows;
  const int rows = min(kRows, p.F - f0);
  const long long row0 = ((long long)g * t.S + s) * p.F + f0;
  const char* src = p.upd + row0 * p.rs;
  char* dst = p.cache + row0 * p.rd;
  switch (ws) {
    case 16: copy_loading<16>(wl, src, dst, rows, p.rs, p.rd, start_b, pieces, lg); break;
    case 8: copy_loading<8>(wl, src, dst, rows, p.rs, p.rd, start_b, pieces, lg); break;
    case 4: copy_loading<4>(wl, src, dst, rows, p.rs, p.rd, start_b, pieces, lg); break;
    case 2: copy_loading<2>(wl, src, dst, rows, p.rs, p.rd, start_b, pieces, lg); break;
    default: copy_loading<1>(wl, src, dst, rows, p.rs, p.rd, start_b, pieces, lg); break;
  }
}

}  // namespace

extern "C" {

// n (1..8) pairs, each described by 8 int64s: cache pointer, upd pointer,
// element bytes (1, 2, 4 or 8), G, F, T, c, 0. cache [G, S, F, T] and upd
// [G, S, F, c] contiguous; 0 < c <= T; c * element bytes <= 2^20; pos and
// lim [S] int32 on the device. Launches nothing when no pair has a row.
// Returns the cudaError_t of the launch (0 = success).
int sk_windowed_write_many(int n, const long long* desc, int S, const int* pos, const int* lim, void* stream) {
  if (n < 1 || n > kMaxPairs || S < 0 || S > 65535) return cudaErrorInvalidValue;
  Table t{};
  t.pos = pos;
  t.lim = lim;
  t.n = n;
  t.S = S;
  long long blocks = 0;
  for (int k = 0; k < n; ++k) {
    const long long* d = desc + 8 * k;
    const long long esz = d[2], G = d[3], F = d[4], T = d[5], c = d[6];
    if (!(esz == 1 || esz == 2 || esz == 4 || esz == 8) || G < 0 || F < 0 || F > INT_MAX || c < 1 || c > T ||
        T > INT_MAX || c * esz > kMaxWindowBytes)
      return cudaErrorInvalidValue;
    Pair& p = t.p[k];
    p.cache = reinterpret_cast<char*>(d[0]);
    p.upd = reinterpret_cast<const char*>(d[1]);
    p.rd = T * esz;
    p.rs = (int)(c * esz);
    p.F = (int)F;
    p.T = (int)T;
    p.c = (int)c;
    p.esz = (int)esz;
    p.fblocks = (int)((F + kRows - 1) / kRows);
    p.block0 = (int)blocks;
    blocks += G * p.fblocks;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
  }
  if (blocks == 0 || S == 0) return cudaSuccess;
  windowed_write_kernel<<<dim3((unsigned)blocks, (unsigned)S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return cudaGetLastError();
}

const char* sk_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
