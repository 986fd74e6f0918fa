// SPDX-License-Identifier: Apache-2.0
//
// Backward of the non-causal flash attention in csrc/flash_attention.cu
// (K1), written for Hopper (sm_90a). Built with nvcc into a shared library
// with a plain C entry point and loaded through ctypes
// (streamkit_tpu_torch/ops/attention.py, `flash_attention_backward`).
//
// Replaces the backward of the library kernel that
// streamkit_tpu/ops/attention.py `_lib_flash` calls
// (jax.experimental.pallas.ops.tpu.flash_attention, jax 0.9.0):
//   di = rowsum(o * do), outside the pallas_calls (:273) -> flash_bwd_prep
//   _flash_attention_bwd_dkv  (pl.pallas_call :1121)   \
//   _flash_attention_bwd_dq   (pl.pallas_call :1456)   -> flash_bwd_tc (bf16), flash_bwd_f32
// The same function: with s = d**-0.25 applied to q and k as in the forward,
// and lse the forward's base-2 row statistic (flash_attention.cu's header),
//   D  = rowsum(dO * O)
//   P  = 2^(S * s^2 * log2(e) - lse),  S = Q K^T, columns past Tk masked
//   dV = P^T dO
//   dS = P * (dO V^T - D)
//   dQ = s^2 dS K,   dK = s^2 dS^T Q
// with f32 accumulation and the results in the input dtype; the bf16 kernel
// rounds P and dS to bf16 before the products they feed, as the plain
// version (ops/attention.py) does.
//
// Bound on an H100 SXM: per call 10*B*H*Tq*Tk*d FLOPs (five products of
// 2*Tq*Tk*d) against the bytes of q, k, v, O, dO read once and dq, dk, dv
// written once. At the large-v3 encoder's [2, 20, 1500, 64] that is
// 57.6 GFLOP: 58 us at bf16's 989 TFLOP/s, 0.86 ms at the CUDA cores' 67
// TFLOP/s for f32; the bytes (18 us bf16, 37 us f32 at 3.35 TB/s) bound
// neither.
//
// Two launches a backward:
//   * flash_bwd_prep, one block per (b*h, 64-row query tile): D of the
//     tile's rows, the row statistic copied beside it, both padded to whole
//     tiles (rows past Tq: D = 0 and lse = +inf, so their P is 0 without a
//     test), and the tile's dQ counter set to 0. All of it lives in one f32
//     workspace, per head: lse [NQ], D [NQ], the dQ accumulator [NQ, d] and
//     the counters [nq rounded up to 4] (int32), NQ = 64 * nq
//     (work_floats; ops/attention.py allocates it).
//   * the main kernel, one pass over key tiles (FlashAttention-3's split, five
//     products where the split into a dQ and a dK/dV kernel needs seven): a
//     CTA owns one (b*h, key tile), keeps K, V and its dK, dV accumulators,
//     and walks over every 64-row query tile i in order. Per tile: S^T =
//     K Q^T and dP^T = V dO^T; P^T = 2^(S^T s^2 log2e - lse) (0 on key rows
//     past Tk); dS^T = P^T (dP^T - D); dV += P^T dO and dK += dS^T Q; and the
//     tile's dQ partial dS K. dK (times s^2) and dV are stored once at the
//     end, rows past Tk not at all.
//
// Deterministic dQ (FlashAttention-3's deterministic mode): the partials of
// query tile i go into the workspace in the order of the key tiles. The CTA
// of key tile j stages its partial in shared memory, waits until tile i's
// counter reads j, and one thread copies it (j = 0) or reduce-adds it
// (cp.reduce.async.bulk .add.f32: one bulk operation a tile, where
// per-element atomics take 4,096) into the workspace, waits for the write,
// and sets the counter to j + 1; the CTA of the last key tile adds the sum
// to its own partial in registers, scales by s^2 and writes dQ in the input
// dtype (rows past Tq are not written). The sum runs in one fixed order, so two runs give the same bits
// (the resumed train step of chip_smoke.py equals the straight one). No
// deadlock: the key tile is the fastest-varying block index, so blocks are
// dispatched in key order within a head and the tile a CTA waits on is
// resident or done, at any grid size. Every CTA walks the query tiles in the
// same order, so CTA j trails CTA j - 1 by about one tile and seldom queues
// on a counter once running; the first wave pays the skew (`spin` sums the
// cycles spent waiting).
//
// bf16 (tensor cores; K1's forward structure): a producer warpgroup whose
// first thread keeps TMA loads in flight (K and V of 128 keys once, then Q
// and dO tiles of 64 rows through the tensor maps, lse and D rows by bulk
// copy from the workspace, into a ring of 3 stages, 2 at d = 128, guarded by
// mbarriers) and two of whose other threads are the dQ writers, one for each
// parity of query tiles (the ordered add above, off the consumers' path:
// they hand each partial over through that parity's staging buffer, guarded
// by mbarriers, so two tiles' bulk adds are in flight); two consumer
// warpgroups of 64 keys each (wgmma M = 64).
//   * S^T and dP^T are SS products: K, V and Q, dO are K-major tiles in
//     128-byte swizzled shared memory (TMA's SWIZZLE_128B).
//   * dV and dK are RS products: P^T and dS^T come from the accumulator
//     fragments, rounded to bf16 as A operands (as the forward turns S into
//     P); dO and Q are MN-major B operands through the transpose bit.
//   * dQ = dS K needs dS as an A operand: both consumers write their dS^T
//     rows in bf16 (the same rounding as the dK operand) into a swizzled
//     [128 keys][64 queries] buffer, which the product reads MN-major
//     (transpose bit on A), with K MN-major as B. The two consumers take
//     turns: the one of the tile's parity runs the dQ product and stages it
//     while the other goes on to the next tile; one buffer per parity,
//     handed over by named barriers.
//   * setmaxnreg hands the producer's registers to the consumers (40 / 232):
//     at d = 128 they hold dK, dV (64 each), S^T, dP^T (32 each) and the dQ
//     partial (64).
// f32 (CUDA cores; the tensor cores have no full-f32 mode and the port keeps
// TF32 off): the same one pass and ordered dQ; 256 threads over 128 keys (64
// at d = 128), the Q and dO tiles (with their lse and D rows) double-buffered
// by 16-byte cp.async; each thread computes an 8 x 4 block of the 128 x 64
// score tiles (4 x 4 at d = 128) and of the dK, dV accumulators, reading
// every operand four floats at a time (rows padded to 16-byte multiples), so
// a 16-byte shared load feeds 10.7 FMAs (the split design's scalar loads in
// 4 x 4 blocks: 2). The dQ partial is staged in the tile's Q slot, which
// the products have read by then.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;  // query rows per tile (both dtypes)

// error codes beside cudaError_t (sk_bwd_error_string)
constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // it refused a q/k/v/dO geometry

struct Args {
  const void *q, *k, *v, *o, *g;  // g = dO
  const float* lse;               // [B, H, Tq]
  float* work;                    // [B*H, work_floats(nq, hd)]
  void *dq, *dk, *dv;
  unsigned long long* spin;       // null, or the sum of the cycles spent waiting on dQ counters
  int H, Tq, Tk, nq;
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot, gb, gh, gt;
  long long dqb, dqh, dqt, dkb, dkh, dkt, dvb, dvh, dvt;
  float scale_log2;  // s^2 * log2(e): the forward's exponent scale
  float scale2;      // s^2
};

// floats of one head's workspace: lse and D padded to whole query tiles, the
// dQ accumulator, the counters (int32) rounded up to 16 bytes
__host__ __device__ constexpr long long work_floats(int nq, int hd) {
  return static_cast<long long>(nq) * BM * (2 + hd) + (nq + 3) / 4 * 4;
}

__device__ __forceinline__ int* dq_counters(float* work, int nq, int hd) {
  return reinterpret_cast<int*>(work + static_cast<long long>(nq) * BM * (2 + hd));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---- preprocess ------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(256) flash_bwd_prep(Args p) {
  const int i = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = i * BM + r;
  float s = 0.f;
  if (row < p.Tq) {  // four threads a row, HD / 4 columns each
    const T* orow = static_cast<const T*>(p.o) + b * p.ob + h * p.oh + row * p.ot + part * (HD / 4);
    const T* grow = static_cast<const T*>(p.g) + b * p.gb + h * p.gh + row * p.gt + part * (HD / 4);
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) s = fmaf(to_f32(grow[c]), to_f32(orow[c]), s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  float* w = p.work + bh * work_floats(p.nq, HD);
  if (part == 0) {
    w[row] = row < p.Tq ? p.lse[static_cast<long long>(bh) * p.Tq + row] : INFINITY;
    w[p.nq * BM + row] = s;
  }
  if (threadIdx.x == 0) dq_counters(w, p.nq, HD)[i] = 0;
}

// ---- ordered dQ ------------------------------------------------------------------

// Spins until query tile i's counter `ctr` reads this CTA's key tile j (the
// caller's group then meets, so all of it sees the sums before j's).
__device__ __forceinline__ void dq_spin(const Args& p, const int* ctr) {
  const long long t0 = clock64();
  while (sk::ld_acquire(ctr) < static_cast<int>(blockIdx.x)) {
  }
  if (p.spin != nullptr) atomicAdd(p.spin, static_cast<unsigned long long>(clock64() - t0));
}

// ---- f32: CUDA cores ----------------------------------------------------------

constexpr int NT = 256;    // f32 threads: a 16 x 16 grid (tx, ty)
constexpr int LDP = BM + 4;  // row stride (floats) of the P^T / dS^T tile

template <int HD>
__host__ __device__ constexpr int f32_bn() {  // keys per CTA
  return HD == 64 ? 128 : 64;
}

template <int HD>
constexpr int f32_smem_bytes() {  // K, V; the ring of two Q and dO tiles; P^T; lse and D
  return (2 * f32_bn<HD>() * (HD + 4) + 4 * BM * (HD + 4) + f32_bn<HD>() * LDP + 4 * BM) * 4;
}

// rows r0 .. r0 + n - 1 of a [T, HD] f32 matrix (row stride rs; 16-byte
// aligned rows, checked by the wrapper) into an [n][HD + 4] tile by 16-byte
// cp.async; rows past T are zero-filled
template <int HD>
__device__ __forceinline__ void fetch_rows(float* dst, const float* src, long long rs, int r0, int rows, int n) {
  for (int c = threadIdx.x; c < n * HD / 4; c += NT) {
    const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
    const bool in = r0 + r < rows;
    sk::cp_async16(dst + r * (HD + 4) + col, in ? src + static_cast<long long>(r0 + r) * rs + col : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[a][b] = sum_d A[ty + 16a][d] * B[tx + 16b][d] (A: [16 RA][HD + 4], B:
// [64][HD + 4]), d four at a time by 16-byte loads
template <int HD, int RA>
__device__ __forceinline__ void tile_abt(float (&acc)[RA][4], const float* A, const float* B, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[RA], bv[4];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = ld4(A + (ty + 16 * a) * (HD + 4) + d);
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = ld4(B + (tx + 16 * b) * (HD + 4) + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[a][b] = fmaf(av[a].w, bv[b].w, fmaf(av[a].z, bv[b].z, fmaf(av[a].y, bv[b].y, fmaf(av[a].x, bv[b].x, acc[a][b]))));
  }
}

// acc[a][4m + x] += sum_j W[ty + 16a][j] * X[j][4tx + 64m + x] over j < BM
// (W: [16 RA][BM + 4], X: [BM][HD + 4]), both read four at a time by 16-byte
// loads
template <int HD, int RA>
__device__ __forceinline__ void tile_acc(float (&acc)[RA][HD / 16], const float* W, const float* X, int ty, int tx) {
  constexpr int NM = HD / 64;
#pragma unroll 2
  for (int j = 0; j < BM; j += 4) {
    float4 w[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) w[a] = ld4(W + (ty + 16 * a) * LDP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 x[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) x[m] = ld4(X + (j + jj) * (HD + 4) + 4 * tx + 64 * m);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const float wv = jj == 0 ? w[a].x : jj == 1 ? w[a].y : jj == 2 ? w[a].z : w[a].w;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          acc[a][4 * m] = fmaf(wv, x[m].x, acc[a][4 * m]);
          acc[a][4 * m + 1] = fmaf(wv, x[m].y, acc[a][4 * m + 1]);
          acc[a][4 * m + 2] = fmaf(wv, x[m].z, acc[a][4 * m + 2]);
          acc[a][4 * m + 3] = fmaf(wv, x[m].w, acc[a][4 * m + 3]);
        }
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) flash_bwd_f32(Args p) {
  constexpr int BN = f32_bn<HD>(), RA = BN / 16, CE = HD / 16, NM = HD / 64, LD = HD + 4;
  extern __shared__ __align__(16) float sm[];
  float* sK = sm;                  // [BN][HD + 4]
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;        // [2][BM][HD + 4]: the ring of two query tiles
  float* sG = sQ + 2 * BM * LD;    // dO, likewise
  float* sP = sG + 2 * BM * LD;    // P^T, then dS^T [BN][BM + 4]
  float* sL = sP + BN * LDP;       // [2][BM] lse
  float* sD = sL + 2 * BM;         // [2][BM] D

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, nq = p.nq;
  const int j = blockIdx.x, last = gridDim.x - 1, k0 = j * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qp = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* gp = static_cast<const float*>(p.g) + b * p.gb + h * p.gh;
  float* work = p.work + bh * work_floats(nq, HD);
  float* out_q = static_cast<float*>(p.dq) + b * p.dqb + h * p.dqh;

  auto fetch = [&](int i, int buf) {  // query tile i (and its lse, D rows) into ring slot buf
    fetch_rows<HD>(sQ + buf * BM * LD, qp, p.qt, i * BM, p.Tq, BM);
    fetch_rows<HD>(sG + buf * BM * LD, gp, p.gt, i * BM, p.Tq, BM);
    if (threadIdx.x < BM / 2) {  // 16 chunks of lse, 16 of D
      const int c = threadIdx.x & 15, which = threadIdx.x >> 4;
      sk::cp_async16((which ? sD : sL) + buf * BM + 4 * c, work + (which * nq + i) * BM + 4 * c, 16);
    }
  };
  fetch_rows<HD>(sK, static_cast<const float*>(p.k) + b * p.kb + h * p.kh, p.kt, k0, p.Tk, BN);
  fetch_rows<HD>(sV, static_cast<const float*>(p.v) + b * p.vb + h * p.vh, p.vt, k0, p.Tk, BN);
  fetch(0, 0);
  sk::cp_async_commit();

  float dk[RA][CE], dv[RA][CE];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int e = 0; e < CE; ++e) dk[a][e] = dv[a][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    const int buf = i & 1;
    if (i + 1 < nq) fetch(i + 1, buf ^ 1);  // its slot was last read in tile i - 1
    sk::cp_async_commit();
    sk::cp_async_wait<1>();
    __syncthreads();
    float* Q = sQ + buf * BM * LD;
    const float* G = sG + buf * BM * LD;
    const float* L = sL + buf * BM;
    const float* D = sD + buf * BM;

    float s[RA][4], dp[RA][4];
    tile_abt<HD, RA>(s, sK, Q, ty, tx);   // S^T: keys x queries
    tile_abt<HD, RA>(dp, sV, G, ty, tx);  // dP^T = V dO^T
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = tx + 16 * bb;
        const float pr = k0 + ty + 16 * a < p.Tk ? exp2f(fmaf(s[a][bb], p.scale_log2, -L[c])) : 0.f;
        sP[(ty + 16 * a) * LDP + c] = pr;
        dp[a][bb] = pr * (dp[a][bb] - D[c]);  // dS^T
      }
    __syncthreads();
    tile_acc<HD, RA>(dv, sP, G, ty, tx);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) sP[(ty + 16 * a) * LDP + tx + 16 * bb] = dp[a][bb];
    __syncthreads();
    tile_acc<HD, RA>(dk, sP, Q, ty, tx);  // dK += dS^T Q

    // the tile's dQ partial dS K: query rows 4ty + a, columns 4tx + 64m + x
    float dq[4][CE];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < CE; ++e) dq[a][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BN; ++kk) {
      const float4 w = ld4(sP + kk * LDP + 4 * ty);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float4 x = ld4(sK + kk * LD + 4 * tx + 64 * m);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          dq[a][4 * m] = fmaf(wv[a], x.x, dq[a][4 * m]);
          dq[a][4 * m + 1] = fmaf(wv[a], x.y, dq[a][4 * m + 1]);
          dq[a][4 * m + 2] = fmaf(wv[a], x.z, dq[a][4 * m + 2]);
          dq[a][4 * m + 3] = fmaf(wv[a], x.w, dq[a][4 * m + 3]);
        }
      }
    }

    // in key order into the workspace: the first and middle key tiles through
    // this tile's Q slot (read by now) as staging, one bulk store / reduce-add
    // by thread 0; the last one adds the sum and writes dQ
    int* ctr = dq_counters(work, nq, HD) + i;
    float* tile = work + 2 * nq * BM + static_cast<long long>(i) * BM * HD;
    if (j == last) {
      if (j > 0) {
        if (threadIdx.x == 0) dq_spin(p, ctr);
        __syncthreads();
      }
      float4 y[4][NM];  // every load issued before the first store
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < NM; ++m)
          y[a][m] = j > 0 ? __ldcg(reinterpret_cast<const float4*>(tile + (4 * ty + a) * HD + 4 * tx + 64 * m))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = i * BM + 4 * ty + a;
        if (row >= p.Tq) continue;
#pragma unroll
        for (int m = 0; m < NM; ++m)
          *reinterpret_cast<float4*>(out_q + row * p.dqt + 4 * tx + 64 * m) = make_float4(
              (dq[a][4 * m] + y[a][m].x) * p.scale2, (dq[a][4 * m + 1] + y[a][m].y) * p.scale2,
              (dq[a][4 * m + 2] + y[a][m].z) * p.scale2, (dq[a][4 * m + 3] + y[a][m].w) * p.scale2);
      }
    } else {
      __syncthreads();  // every dK read of Q is done
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < NM; ++m)
          *reinterpret_cast<float4*>(Q + (4 * ty + a) * HD + 4 * tx + 64 * m) =
              make_float4(dq[a][4 * m], dq[a][4 * m + 1], dq[a][4 * m + 2], dq[a][4 * m + 3]);
      sk::fence_proxy_async();
      __syncthreads();
      if (threadIdx.x == 0) {
        if (j > 0) {
          dq_spin(p, ctr);
          sk::bulk_reduce_add(tile, Q, BM * HD * 4);
        } else {
          sk::bulk_store(tile, Q, BM * HD * 4);
        }
        sk::bulk_commit();
        sk::bulk_wait();
        sk::fence_proxy_async_global();
        sk::st_release(ctr, j + 1);
      }
    }
    __syncthreads();  // sP and this ring slot are free for the next tile
  }
  float* out_k = static_cast<float*>(p.dk) + b * p.dkb + h * p.dkh;
  float* out_v = static_cast<float*>(p.dv) + b * p.dvb + h * p.dvh;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = k0 + ty + 16 * a;
    if (r >= p.Tk) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float* k4 = dk[a] + 4 * m;
      const float* v4 = dv[a] + 4 * m;
      *reinterpret_cast<float4*>(out_k + r * p.dkt + 4 * tx + 64 * m) =
          make_float4(k4[0] * p.scale2, k4[1] * p.scale2, k4[2] * p.scale2, k4[3] * p.scale2);
      *reinterpret_cast<float4*>(out_v + r * p.dvt + 4 * tx + 64 * m) = make_float4(v4[0], v4[1], v4[2], v4[3]);
    }
  }
}

// ---- bf16: tensor cores (wgmma + TMA) --------------------------------------

constexpr int BN_TC = 128;          // keys per CTA: two consumer warpgroups of 64
constexpr int SUB_Q = BM * 128;     // bytes of one 64-column (128-byte row) sub-tile of a Q or dO tile
constexpr int SUB_K = BN_TC * 128;  // ... of a K or V tile, and of a dS^T buffer
// named barriers: the dS^T buffer of a parity is free / ready (+ parity);
// one consumer warpgroup's own (+ consumer)
constexpr int BAR_FREE = 1, BAR_READY = 3, BAR_WG = 5;

template <int HD>
__host__ __device__ constexpr int tc_stages() {
  return HD == 64 ? 3 : 2;
}

template <int HD>
struct alignas(1024) TcTiles {
  static constexpr int S = tc_stages<HD>();
  bf16 k[HD / 64][BN_TC * 64];
  bf16 v[HD / 64][BN_TC * 64];
  bf16 q[S][HD / 64][BM * 64];
  bf16 g[S][HD / 64][BM * 64];  // dO
  bf16 ds[2][BN_TC * 64];       // dS^T [128 keys][64 queries], one per query-tile parity
  float dqs[2][BM * HD];        // the dQ partial on its way to the workspace, one per parity
  float lse[S][BM], dd[S][BM];
  uint64_t kv_full, full[S], empty[S], dq_full[2], dq_empty[2];
};

template <int HD>
constexpr int tc_smem_bytes() {
  return static_cast<int>(sizeof(TcTiles<HD>)) + 1024;  // + slack to align the base to 1024 bytes
}

// dV / dK (64 keys x HD) += A (registers, 64 keys x 16 queries) * B (16 queries x HD, MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_kv(float (&acc)[HD / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_kv<64>(float (&acc)[32], const uint32_t (&a)[4], uint64_t db) {
  sk::wgmma_rs_m64n64k16_tb(acc, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_kv<128>(float (&acc)[64], const uint32_t (&a)[4], uint64_t db) {
  sk::wgmma_rs_m64n128k16_tb(acc, a, db, 1);
}

// dQ partial (64 queries x HD) (+)= dS (MN-major, 64 x 16 keys) * K (16 keys x HD, MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_q(float (&acc)[HD / 2], uint64_t da, uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_q<64>(float (&acc)[32], uint64_t da, uint64_t db, int accumulate) {
  sk::wgmma_ss_m64n64k16<1, 1>(acc, da, db, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_q<128>(float (&acc)[64], uint64_t da, uint64_t db, int accumulate) {
  sk::wgmma_ss_m64n128k16<1, 1>(acc, da, db, accumulate);
}

// A fragments (4 k-steps of 16 queries) of a 64 x 64 accumulator, rounded to
// bf16: columns 16kk.. of rows g / g + 8 are the accumulators of n-tiles 2kk
// and 2kk + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = sk::pack_bf16(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = sk::pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = sk::pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = sk::pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(384, 1) flash_bwd_tc(const __grid_constant__ CUtensorMap tq,
                                                       const __grid_constant__ CUtensorMap tk,
                                                       const __grid_constant__ CUtensorMap tv,
                                                       const __grid_constant__ CUtensorMap tg, const Args p) {
  constexpr int NSUB = HD / 64, S = tc_stages<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (sk::smem_addr(smem_raw) & 1023u)) & 1023u;
  TcTiles<HD>& sm = *reinterpret_cast<TcTiles<HD>*>(smem_raw + pad);

  const int wg = threadIdx.x >> 7;  // 0: producer, 1..2: consumers
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, nq = p.nq;
  const int k0 = blockIdx.x * BN_TC;
  float* work = p.work + bh * work_floats(nq, HD);

  if (threadIdx.x == 0) {
    sk::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sk::mbar_init(&sm.full[s], 1);
      sk::mbar_init(&sm.empty[s], 256);
    }
    for (int s = 0; s < 2; ++s) {
      sk::mbar_init(&sm.dq_full[s], 128);
      sk::mbar_init(&sm.dq_empty[s], 1);
    }
    sk::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight --------------
    sk::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      sk::tma_prefetch(&tq);
      sk::tma_prefetch(&tk);
      sk::tma_prefetch(&tv);
      sk::tma_prefetch(&tg);
      sk::mbar_expect_tx(&sm.kv_full, 2 * BN_TC * HD * 2);
      for (int j = 0; j < NSUB; ++j) {
        sk::tma_load_4d(sm.k[j], &tk, &sm.kv_full, j * 64, k0, h, b);
        sk::tma_load_4d(sm.v[j], &tv, &sm.kv_full, j * 64, k0, h, b);
      }
      for (int i = 0; i < nq; ++i) {
        const int s = i % S;
        sk::mbar_wait(&sm.empty[s], ((i / S) & 1) ^ 1);  // the first round passes at once
        sk::mbar_expect_tx(&sm.full[s], 2 * BM * HD * 2 + 2 * BM * 4);
        for (int j = 0; j < NSUB; ++j) {
          sk::tma_load_4d(sm.q[s][j], &tq, &sm.full[s], j * 64, i * BM, h, b);
          sk::tma_load_4d(sm.g[s][j], &tg, &sm.full[s], j * 64, i * BM, h, b);
        }
        sk::bulk_load(sm.lse[s], work + i * BM, BM * 4, &sm.full[s]);
        sk::bulk_load(sm.dd[s], work + (nq + i) * BM, BM * 4, &sm.full[s]);
      }
    } else if ((threadIdx.x == 32 || threadIdx.x == 64) && blockIdx.x + 1 < gridDim.x) {
      // ---- the dQ writers, one thread for each parity of query tiles: the
      // ordered add of the first and middle key tiles (the last key tile's
      // consumers write dQ themselves) ------------------------------------
      const int j = blockIdx.x;
      for (int i = threadIdx.x / 32 - 1; i < nq; i += 2) {
        const int par = i & 1;
        float* tile = work + 2 * nq * BM + static_cast<long long>(i) * BM * HD;
        int* ctr = dq_counters(work, nq, HD) + i;
        sk::mbar_wait(&sm.dq_full[par], (i >> 1) & 1);
        if (j > 0) {
          dq_spin(p, ctr);
          sk::bulk_reduce_add(tile, sm.dqs[par], BM * HD * 4);
        } else {
          sk::bulk_store(tile, sm.dqs[par], BM * HD * 4);
        }
        sk::bulk_commit();
        sk::bulk_wait_read();
        sk::mbar_arrive(&sm.dq_empty[par]);  // the staging buffer may be rewritten
        sk::bulk_wait();
        sk::fence_proxy_async_global();
        sk::st_release(ctr, j + 1);
      }
    }
  } else {
    // ---- consumers: 64 keys each -------------------------------------------
    sk::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int kr = k0 + 64 * c + 16 * warp + g;  // this thread's key rows: kr and kr + 8
    const bool in0 = kr < p.Tk, in1 = kr + 8 < p.Tk;
    const uint32_t k_base = sk::smem_addr(&sm.k[0][0]), v_base = sk::smem_addr(&sm.v[0][0]);

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dk[x] = dv[x] = 0.f;

    sk::mbar_wait(&sm.kv_full, 0);
    for (int i = 0; i < nq; ++i) {
      const int s = i % S;
      const uint32_t q_base = sk::smem_addr(&sm.q[s][0][0]), g_base = sk::smem_addr(&sm.g[s][0][0]);

      // S^T = K Q^T and dP^T = V dO^T: this consumer's 64 keys x 64 queries,
      // d in steps of 16 (32 bytes inside a 128-byte swizzled row; the next
      // 64 columns are the next sub-tile)
      float sc[32], dp[32];
      sk::mbar_wait(&sm.full[s], (i / S) & 1);
      sk::fence_regs(sc);
      sk::fence_regs(dp);
      sk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t ka = (kk / 4) * SUB_K + c * 64 * 128 + (kk % 4) * 32, qa = (kk / 4) * SUB_Q + (kk % 4) * 32;
        sk::wgmma_ss_m64n64k16<0, 0>(sc, sk::wgmma_desc(k_base + ka, 16, 1024), sk::wgmma_desc(q_base + qa, 16, 1024),
                                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t ka = (kk / 4) * SUB_K + c * 64 * 128 + (kk % 4) * 32, qa = (kk / 4) * SUB_Q + (kk % 4) * 32;
        sk::wgmma_ss_m64n64k16<0, 0>(dp, sk::wgmma_desc(v_base + ka, 16, 1024), sk::wgmma_desc(g_base + qa, 16, 1024),
                                     kk > 0);
      }
      sk::wgmma_commit();
      sk::wgmma_wait<0>();
      sk::fence_regs(sc);
      sk::fence_regs(dp);

      // P^T and dS^T: element 4n + 2e + x is key row kr + 8e, query column
      // 8n + 2t4 + x; key rows past Tk give P = 0 (query rows past Tq have
      // lse = +inf in the workspace)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(&sm.lse[s][8 * n + 2 * t4]);
        const float2 d = *reinterpret_cast<const float2*>(&sm.dd[s][8 * n + 2 * t4]);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int idx = 4 * n + 2 * e + x;
            const float pr = (e ? in1 : in0) ? sk::exp2_approx(fmaf(sc[idx], p.scale_log2, -(x ? l.y : l.x))) : 0.f;
            sc[idx] = pr;
            dp[idx] = pr * (dp[idx] - (x ? d.y : d.x));
          }
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, sc);
      pack_a(da, dp);

      // dV += P^T dO and dK += dS^T Q: 16 query rows (2048 bytes) per k-step;
      // dO and Q are MN-major (d contiguous), 64-column blocks one sub-tile apart
      sk::fence_regs(dv);
      sk::fence_regs(dk);
      sk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_kv<HD>(dv, pa[kk], sk::wgmma_desc(g_base + kk * 2048, SUB_Q, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_kv<HD>(dk, da[kk], sk::wgmma_desc(q_base + kk * 2048, SUB_Q, 1024));
      sk::wgmma_commit();

      // dS^T (bf16, as the dK operand rounds it) into this parity's buffer:
      // rows 64c + 16 warp + g and + 8, 16-byte chunk n at n ^ (row % 8)
      const int par = i & 1;
      const bool owner = par == c;
      if (!owner && i >= 2) sk::bar_sync(BAR_FREE + par, 256);  // the owner's dQ of tile i - 2 has read it
      unsigned char* dsb = reinterpret_cast<unsigned char*>(sm.ds[par]) + (64 * c + 16 * warp + g) * 128 + 4 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<uint32_t*>(dsb + ((n ^ g) << 4)) = da[n / 2][2 * (n % 2)];
        *reinterpret_cast<uint32_t*>(dsb + 8 * 128 + ((n ^ g) << 4)) = da[n / 2][2 * (n % 2) + 1];
      }
      sk::fence_proxy_async();
      if (owner) {
        sk::bar_sync(BAR_READY + par, 256);
      } else {
        sk::bar_arrive(BAR_READY + par, 256);
      }
      sk::wgmma_wait<0>();
      sk::fence_regs(dv);
      sk::fence_regs(dk);
      sk::mbar_arrive(&sm.empty[s]);  // Q, dO, lse and D of this stage are read
      if (!owner) continue;

      // the tile's dQ partial dS K over all 128 keys: dS^T read MN-major as
      // A (16 keys = 2048 bytes per k-step), K MN-major as B
      float acc[HD / 2];
      const uint32_t ds_base = sk::smem_addr(sm.ds[par]);
      sk::fence_regs(acc);
      sk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN_TC / 16; ++kk)
        wgmma_q<HD>(acc, sk::wgmma_desc(ds_base + kk * 2048, SUB_K, 1024),
                    sk::wgmma_desc(k_base + kk * 2048, SUB_K, 1024), kk > 0);
      sk::wgmma_commit();
      sk::wgmma_wait<0>();
      sk::fence_regs(acc);
      if (i + 2 < nq) sk::bar_arrive(BAR_FREE + par, 256);

      // 16-byte chunk c of a tile row r lies at c ^ (r % 8) in the staging
      // buffer and the workspace (the 8 rows a warp stores at once fall on
      // distinct banks); this thread's float pairs (r, 8n + 2t4)
      const int j = blockIdx.x;
      if (j + 1 == static_cast<int>(gridDim.x)) {  // the last key tile: dQ = s^2 (sum + own)
        float* tile = work + 2 * nq * BM + static_cast<long long>(i) * BM * HD;
        if (j > 0) {
          if (tid == 0) dq_spin(p, dq_counters(work, nq, HD) + i);
          sk::bar_sync(BAR_WG + c, 128);
        }
        bf16* out = static_cast<bf16*>(p.dq) + b * p.dqb + h * p.dqh;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // each row's loads all issued before its stores
          const int r = 16 * warp + g + 8 * e, row = i * BM + r;
          float2 y[HD / 8];
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
            y[n] = j > 0 ? __ldcg(reinterpret_cast<const float2*>(tile + r * HD + (((2 * n + (t4 >> 1)) ^ g) << 2) +
                                                                  2 * (t4 & 1)))
                         : make_float2(0.f, 0.f);
          if (row >= p.Tq) continue;
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
            *reinterpret_cast<uint32_t*>(out + row * p.dqt + 8 * n + 2 * t4) = sk::pack_bf16(
                (acc[4 * n + 2 * e] + y[n].x) * p.scale2, (acc[4 * n + 2 * e + 1] + y[n].y) * p.scale2);
        }
        continue;
      }
      // the first and middle key tiles: to the writer of this parity
      sk::mbar_wait(&sm.dq_empty[par], ((i >> 1) & 1) ^ 1);  // the first use passes at once
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * warp + g + 8 * e;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(&sm.dqs[par][r * HD + (((2 * n + (t4 >> 1)) ^ g) << 2) + 2 * (t4 & 1)]) =
              make_float2(acc[4 * n + 2 * e], acc[4 * n + 2 * e + 1]);
      }
      sk::fence_proxy_async();
      sk::mbar_arrive(&sm.dq_full[par]);
    }

    bf16* out_k = static_cast<bf16*>(p.dk) + b * p.dkb + h * p.dkh;
    bf16* out_v = static_cast<bf16*>(p.dv) + b * p.dvb + h * p.dvh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (in0) {
        *reinterpret_cast<uint32_t*>(out_k + kr * p.dkt + col) = sk::pack_bf16(dk[4 * n] * p.scale2, dk[4 * n + 1] * p.scale2);
        *reinterpret_cast<uint32_t*>(out_v + kr * p.dvt + col) = sk::pack_bf16(dv[4 * n], dv[4 * n + 1]);
      }
      if (in1) {
        *reinterpret_cast<uint32_t*>(out_k + (kr + 8) * p.dkt + col) =
            sk::pack_bf16(dk[4 * n + 2] * p.scale2, dk[4 * n + 3] * p.scale2);
        *reinterpret_cast<uint32_t*>(out_v + (kr + 8) * p.dvt + col) = sk::pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch_prep(int dtype, const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(a.nq, B * a.H);
  if (dtype == 0) {
    flash_bwd_prep<float, HD><<<grid, 256, 0, stream>>>(a);
  } else {
    flash_bwd_prep<bf16, HD><<<grid, 256, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_main(int dtype, const Args& a, int B, cudaStream_t stream) {
  // the shared-memory limits are set once per process (one card)
  if (dtype == 0) {
    constexpr int smem = f32_smem_bytes<HD>();
    static const int attr = set_smem(flash_bwd_f32<HD>, smem);
    if (attr) return attr;
    const dim3 grid((a.Tk + f32_bn<HD>() - 1) / f32_bn<HD>(), B * a.H);
    flash_bwd_f32<HD><<<grid, NT, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const sk::EncodeTiled fn = sk::tensor_map_encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap mq, mk, mv, mg;
  if (!sk::encode_heads(fn, &mq, a.q, HD, a.Tq, a.H, B, a.qb, a.qh, a.qt, BM) ||
      !sk::encode_heads(fn, &mk, a.k, HD, a.Tk, a.H, B, a.kb, a.kh, a.kt, BN_TC) ||
      !sk::encode_heads(fn, &mv, a.v, HD, a.Tk, a.H, B, a.vb, a.vh, a.vt, BN_TC) ||
      !sk::encode_heads(fn, &mg, a.g, HD, a.Tq, a.H, B, a.gb, a.gh, a.gt, BM))
    return ERR_ENCODE;
  constexpr int smem = tc_smem_bytes<HD>();
  static const int attr = set_smem(flash_bwd_tc<HD>, smem);
  if (attr) return attr;
  const dim3 grid((a.Tk + BN_TC - 1) / BN_TC, B * a.H);  // key tiles fastest: see the header
  flash_bwd_tc<HD><<<grid, 384, smem, stream>>>(mq, mk, mv, mg, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// which: 0 = the preprocess (reads o, g = dO and lse; writes the workspace),
// 1 = the main kernel (reads q, k, v, g and the workspace; writes dq, dk,
// dv); launch 0, then 1, on the same stream. dtype: 0 = float32, 1 =
// bfloat16, for q, k, v, o, g and dq, dk, dv alike (bf16: q, k, v and g are
// read by TMA, so the wrapper has checked 16-byte aligned bases and strides;
// strides of dims of size 1 may be any TMA accepts). `lse` is a contiguous
// [B, H, Tq] f32; `work` a [B*H, work_stride] f32 workspace with work_stride
// = work_floats(ceil(Tq / 64), hd) (any contents). Strides are in elements,
// as (batch, head, time) for each of q, k, v, o, g, dq, dk, dv; head_dim is
// contiguous. `spin`: null, or a device counter that the main kernel adds the
// cycles its CTAs wait on dQ counters to. Returns 0 on success, else the
// cudaError_t of the launch or one of the negative codes above
// (sk_bwd_error_string names each).
int sk_flash_attention_bwd(int which, int dtype, const void* q, const void* k, const void* v, const void* o,
                           const void* g, const float* lse, float* work, long long work_stride, void* dq, void* dk,
                           void* dv, int B, int H, int Tq, int Tk, int hd, const long long* strides,
                           float scale_log2, float scale2, unsigned long long* spin, void* stream) {
  const long long* s = strides;
  const int nq = (Tq + BM - 1) / BM;
  const Args a{q, k, v, o, g, lse, work, dq, dk, dv, spin, H, Tq, Tk, nq,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14],
               s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
               scale_log2, scale2};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1) || (hd != 64 && hd != 128) ||
      work_stride != work_floats(nq, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  if (which == 0) return hd == 64 ? launch_prep<64>(dtype, a, B, cs) : launch_prep<128>(dtype, a, B, cs);
  return hd == 64 ? launch_main<64>(dtype, a, B, cs) : launch_main<128>(dtype, a, B, cs);
}

const char* sk_bwd_error_string(int err) {
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled is not available";
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a q/k/v/dO geometry";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
