// SPDX-License-Identifier: Apache-2.0
//
// Backward of the non-causal flash attention in csrc/flash_attention.cu
// (K1), written for Hopper (sm_90a). Built with nvcc into a shared library
// with a plain C entry point and loaded through ctypes
// (streamkit_tpu_torch/ops/attention.py, `flash_attention_backward`).
//
// Replaces the backward of the library kernel that
// streamkit_tpu/ops/attention.py `_lib_flash` calls
// (jax.experimental.pallas.ops.tpu.flash_attention):
//   _flash_attention_bwd_dkv  (pl.pallas_call :1121)  -> flash_bwd_dkv
//   _flash_attention_bwd_dq   (pl.pallas_call :1456)  -> flash_bwd_dq
// The same function: with s = d**-0.25 applied to q and k as in the forward,
// and lse the forward's base-2 row statistic (flash_attention.cu's header),
//   D  = rowsum(dO * O)
//   P  = 2^(S * s^2 * log2(e) - lse),  S = Q K^T, columns past Tk masked
//   dV = P^T dO
//   dS = P * (dO V^T - D)
//   dQ = s^2 dS K,   dK = s^2 dS^T Q
// with f32 accumulation and the results in the input dtype. The split is
// FlashAttention-2's (and the library's): one kernel over query tiles for dQ,
// which also computes D for its rows in its prologue and stores it, run
// first; one over key tiles for dK and dV, which reads D. No atomics: each
// block owns its output rows.
//
// Bound on an H100 SXM: per call 10*B*H*Tq*Tk*d FLOPs (five products of
// 2*Tq*Tk*d) against the bytes of q, k, v, O, dO read once and dq, dk, dv
// written once. At the large-v3 encoder's [2, 20, 1500, 64] that is
// 57.6 GFLOP: 58 us at bf16's 989 TFLOP/s, 0.86 ms at the CUDA cores' 67
// TFLOP/s for f32; the bytes (18 us bf16, 37 us f32 at 3.35 TB/s) bound
// neither.
//
// f32 design (CUDA cores; the tensor cores have no full-f32 mode): a block
// of 256 threads owns 64 rows; it keeps its own tiles (Q and dO, or K and V)
// and loops over 64-row tiles of the other side, staged through shared
// memory (rows padded by one float, so neither the row-wise nor the
// column-wise reads conflict on a bank). Each thread computes a 4 x 4
// register block of every 64 x 64 score tile (rows ty + 16a, columns
// tx + 16b) and a 4 x d/16 block of the 64 x d accumulators, so every
// shared load feeds several FMAs.
//
// bf16 design (tensor cores, mma.sync m16n8k16 as K3 uses it; wgmma and TMA
// are a later step): a block of 4 warps owns 64 rows, 16 a warp, and loops
// over 64-row tiles of the other side, loaded by 16-byte cp.async into
// shared memory rows padded by 16 bytes (ldmatrix rows on distinct banks).
// S and dO V^T (dQ kernel), or S^T and V dO^T (dK/dV kernel), come from
// ldmatrix fragments of both row-major tiles; their C fragments become P
// and dS in f32 and then, rounded to bf16, the A fragments of the next
// products (P^T dO, dS K, dS^T Q), whose B operand is the row-major tile
// read by ldmatrix.trans. P and dS are rounded to bf16 there, as
// FlashAttention-2 rounds them; the plain version rounds at the same places.
//
// Both designs recompute S and dO V^T in each kernel (seven products of
// 2*Tq*Tk*d in all, not five) and load synchronously (a tile is loaded,
// then used); enough blocks in flight hide the loads at the encoder's shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BR = 64;   // rows a block owns (queries for dQ, keys for dK/dV)
constexpr int BC = 64;   // rows of the tiles it loops over
constexpr int NT = 256;  // f32 threads: a 16 x 16 grid of 4 x 4 blocks over a 64 x 64 tile
constexpr int TC = 128;  // bf16 threads: 4 warps of 16 rows

struct Args {
  const void *q, *k, *v, *o, *g;  // g = dO
  const float* lse;               // [B, H, Tq]
  float* delta;                   // [B, H, Tq]: D, written by the dQ kernel
  void *dq, *dk, *dv;
  int H, Tq, Tk;
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot, gb, gh, gt;
  long long dqb, dqh, dqt, dkb, dkh, dkt, dvb, dvh, dvt;
  float scale_log2;  // s^2 * log2(e): the forward's exponent scale
  float scale2;      // s^2
};

// ---- f32: CUDA cores ----------------------------------------------------------

// rows r0 .. r0 + 63 of a [T, HD] matrix (row stride rs, unit column
// stride) into a [64][HD + 1] tile; rows past T are zero
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long rs, int r0, int rows) {
  for (int idx = threadIdx.x; idx < BC * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    dst[r * (HD + 1) + c] = r0 + r < rows ? src[static_cast<long long>(r0 + r) * rs + c] : 0.f;
  }
}

// acc[a][b] = sum_d A[ty + 16a][d] * B[tx + 16b][d] (A, B: [64][HD + 1])
template <int HD>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A, const float* B, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * (HD + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(tx + 16 * b) * (HD + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// acc[a][e] += sum_j W[ty + 16a][j] * X[j][tx + 16e] (W: [64][65], X: [64][HD + 1])
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16], const float* W, const float* X, int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < BC; ++j) {
    float w[4], x[HD / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) w[a] = W[(ty + 16 * a) * (BC + 1) + j];
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) x[e] = X[j * (HD + 1) + tx + 16 * e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < HD / 16; ++e) acc[a][e] = fmaf(w[a], x[e], acc[a][e]);
  }
}

// the [64, HD] accumulator block of rows r0.. into out (row stride rs), times f
template <int HD>
__device__ __forceinline__ void store_rows(float* out, long long rs, const float (&acc)[4][HD / 16], int r0, int rows,
                                           float f, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= rows) continue;
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) out[static_cast<long long>(r) * rs + tx + 16 * e] = acc[a][e] * f;
  }
}

template <int HD>
constexpr int f32_smem_bytes() {
  return (4 * BC * (HD + 1) + BC * (BC + 1) + 2 * BC) * 4;
}

// dQ (and D) over query tiles
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq(Args p) {
  extern __shared__ float sm[];
  float* sQ = sm;                       // [64][HD + 1]
  float* sG = sQ + BC * (HD + 1);       // dO
  float* sK = sG + BC * (HD + 1);
  float* sV = sK + BC * (HD + 1);
  float* sS = sV + BC * (HD + 1);       // dS [64][65]
  float* sL = sS + BC * (BC + 1);       // lse of the block's rows
  float* sD = sL + BC;                  // D of the block's rows

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qp = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kp = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vp = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const float* op = static_cast<const float*>(p.o) + b * p.ob + h * p.oh;
  const float* gp = static_cast<const float*>(p.g) + b * p.gb + h * p.gh;

  load_tile<HD>(sQ, qp, p.qt, q0, p.Tq);
  load_tile<HD>(sG, gp, p.gt, q0, p.Tq);
  load_tile<HD>(sK, op, p.ot, q0, p.Tq);  // O, for D only
  if (threadIdx.x < BR) {
    const int r = q0 + threadIdx.x;
    sL[threadIdx.x] = r < p.Tq ? p.lse[static_cast<long long>(bh) * p.Tq + r] : INFINITY;
  }
  __syncthreads();
  {  // D = rowsum(dO * O): four threads a row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float s = 0.f;
#pragma unroll 4
    for (int c = part; c < HD; c += 4) s = fmaf(sG[r * (HD + 1) + c], sK[r * (HD + 1) + c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) {
      sD[r] = s;
      if (q0 + r < p.Tq) p.delta[static_cast<long long>(bh) * p.Tq + q0 + r] = s;
    }
  }

  float acc[4][HD / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) acc[a][e] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BC) {
    __syncthreads();  // the last tile's readers (and D's) are done
    load_tile<HD>(sK, kp, p.kt, k0, p.Tk);
    load_tile<HD>(sV, vp, p.vt, k0, p.Tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<HD>(s, sQ, sK, ty, tx);
    tile_abt<HD>(dp, sG, sV, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = tx + 16 * bb;
        const float pr = k0 + c < p.Tk ? exp2f(fmaf(s[a][bb], p.scale_log2, -sL[r])) : 0.f;
        sS[r * (BC + 1) + c] = pr * (dp[a][bb] - sD[r]);
      }
    }
    __syncthreads();
    tile_acc<HD>(acc, sS, sK, ty, tx);
  }
  store_rows<HD>(static_cast<float*>(p.dq) + b * p.dqb + h * p.dqh, p.dqt, acc, q0, p.Tq, p.scale2, ty, tx);
}

// dK and dV over key tiles
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(Args p) {
  extern __shared__ float sm[];
  float* sK = sm;                       // [64][HD + 1]
  float* sV = sK + BC * (HD + 1);
  float* sQ = sV + BC * (HD + 1);
  float* sG = sQ + BC * (HD + 1);       // dO
  float* sP = sG + BC * (HD + 1);       // P^T, then dS^T [64 keys][65]
  float* sL = sP + BC * (BC + 1);       // lse of the query tile
  float* sD = sL + BC;                  // D of the query tile

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qp = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kp = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vp = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const float* gp = static_cast<const float*>(p.g) + b * p.gb + h * p.gh;

  load_tile<HD>(sK, kp, p.kt, k0, p.Tk);
  load_tile<HD>(sV, vp, p.vt, k0, p.Tk);

  float dk[4][HD / 16], dv[4][HD / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) dk[a][e] = dv[a][e] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += BC) {
    __syncthreads();  // the last tile's readers are done
    load_tile<HD>(sQ, qp, p.qt, q0, p.Tq);
    load_tile<HD>(sG, gp, p.gt, q0, p.Tq);
    if (threadIdx.x < BC) {  // rows past Tq: P = 2^-inf = 0, D = 0
      const int r = q0 + threadIdx.x;
      const bool in = r < p.Tq;
      sL[threadIdx.x] = in ? p.lse[static_cast<long long>(bh) * p.Tq + r] : INFINITY;
      sD[threadIdx.x] = in ? p.delta[static_cast<long long>(bh) * p.Tq + r] : 0.f;
    }
    __syncthreads();
    // S^T (keys x queries) and dP^T = V dO^T
    float s[4][4], dp[4][4];
    tile_abt<HD>(s, sK, sQ, ty, tx);
    tile_abt<HD>(dp, sV, sG, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = tx + 16 * bb;
        s[a][bb] = exp2f(fmaf(s[a][bb], p.scale_log2, -sL[c]));  // P^T
        sP[(ty + 16 * a) * (BC + 1) + c] = s[a][bb];
      }
    __syncthreads();
    tile_acc<HD>(dv, sP, sG, ty, tx);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = tx + 16 * bb;
        sP[(ty + 16 * a) * (BC + 1) + c] = s[a][bb] * (dp[a][bb] - sD[c]);  // dS^T
      }
    __syncthreads();
    tile_acc<HD>(dk, sP, sQ, ty, tx);  // dK += dS^T Q
  }
  store_rows<HD>(static_cast<float*>(p.dk) + b * p.dkb + h * p.dkh, p.dkt, dk, k0, p.Tk, p.scale2, ty, tx);
  store_rows<HD>(static_cast<float*>(p.dv) + b * p.dvb + h * p.dvh, p.dvt, dv, k0, p.Tk, 1.f, ty, tx);
}

// ---- bf16: tensor cores -----------------------------------------------------

using bf16 = __nv_bfloat16;

// four 8x8 b16 matrices; lane i addresses row (i % 8) of matrix (i / 8)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sk::smem_addr(ptr)));
}

// rows r0 .. r0 + 63 of a [T, HD] bf16 matrix into a [64][HD + 8] tile by
// 16-byte cp.async (the wrapper checked 16-byte aligned rows); rows past T
// are zero-filled
template <int HD>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src, long long rs, int r0, int rows) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < BC * CH; c += TC) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = r0 + r < rows;
    sk::cp_async16(dst + r * (HD + 8) + col, in ? src + static_cast<long long>(r0 + r) * rs + col : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void tc_wait() {
  sk::cp_async_commit();
  sk::cp_async_wait<0>();
  __syncthreads();
}

// acc (16 x 64: C fragments of 8 n-tiles) = A[16 rows, :HD] B[64 rows, :HD]^T,
// A the warp's rows of a tile, B a whole tile (both row-major, [.][HD + 8])
template <int HD>
__device__ __forceinline__ void tc_abt(float (&acc)[8][4], const bf16* A, const bf16* B, int lane) {
  constexpr int LD = HD + 8;
  const int j = lane >> 3, i8 = lane & 7;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + ((j & 1) * 8 + i8) * LD + kk * 16 + (j >> 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + (j >> 1) * 8 + i8) * LD + kk * 16 + (j & 1) * 8);
      sk::mma_16816(acc[2 * np], a, b[0], b[1]);
      sk::mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A fragments (4 k-steps of 16) of a 16 x 64 C-fragment tile, rounded to bf16
__device__ __forceinline__ void tc_pack(uint32_t (&pa)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = sk::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    pa[kk][1] = sk::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    pa[kk][2] = sk::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pa[kk][3] = sk::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc (16 x HD) += P (16 x 64, A fragments) X (64 rows x HD, row-major tile)
template <int HD>
__device__ __forceinline__ void tc_pv(float (&acc)[HD / 8][4], const uint32_t (&pa)[4][4], const bf16* X, int lane) {
  constexpr int LD = HD + 8;
  const int j = lane >> 3, i8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      sk::ldsm_x4_trans(b, X + (kk * 16 + (j & 1) * 8 + i8) * LD + np * 16 + (j >> 1) * 8);
      sk::mma_16816(acc[2 * np], pa[kk], b[0], b[1]);
      sk::mma_16816(acc[2 * np + 1], pa[kk], b[2], b[3]);
    }
}

// a warp's 16 x HD accumulator (rows r0 + g, r0 + g + 8) into out, times f
template <int HD>
__device__ __forceinline__ void tc_store(bf16* out, long long rs, const float (&acc)[HD / 8][4], int r0, int rows,
                                         float f, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + g + 8 * e;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r) * rs + n * 8 + 2 * t4) =
          sk::pack_bf16(acc[n][2 * e] * f, acc[n][2 * e + 1] * f);
  }
}

template <int HD>
constexpr int tc_smem_bytes() {
  return 4 * BC * (HD + 8) * 2 + 2 * BC * 4;
}

// dQ (and D) over query tiles
template <int HD>
__global__ void __launch_bounds__(TC) flash_bwd_dq_tc(Args p) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char tc_sm[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_sm);  // [64][HD + 8]
  bf16* sG = sQ + BC * LD;                      // dO
  bf16* sK = sG + BC * LD;
  bf16* sV = sK + BC * LD;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.kb + h * p.kh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.vb + h * p.vh;
  const bf16* op = static_cast<const bf16*>(p.o) + b * p.ob + h * p.oh;
  const bf16* gp = static_cast<const bf16*>(p.g) + b * p.gb + h * p.gh;

  tc_load<HD>(sQ, qp, p.qt, q0, p.Tq);
  tc_load<HD>(sG, gp, p.gt, q0, p.Tq);
  tc_load<HD>(sK, op, p.ot, q0, p.Tq);  // O, for D only
  tc_wait();
  // D and lse of rows g and g + 8 of this warp's 16; the four t4 lanes
  // split the columns
  float dd[2], ll[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = warp * 16 + g + 8 * e;
    float s = 0.f;
#pragma unroll
    for (int c = 2 * t4; c < HD; c += 8) {
      const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sG + r * LD + c));
      const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sK + r * LD + c));
      s = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, s));
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dd[e] = s;
    const bool in = q0 + r < p.Tq;
    ll[e] = in ? p.lse[static_cast<long long>(bh) * p.Tq + q0 + r] : INFINITY;
    if (in && t4 == 0) p.delta[static_cast<long long>(bh) * p.Tq + q0 + r] = s;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BC) {
    __syncthreads();  // the last tile's readers (and D's) are done
    tc_load<HD>(sK, kp, p.kt, k0, p.Tk);
    tc_load<HD>(sV, vp, p.vt, k0, p.Tk);
    tc_wait();
    float s[8][4], dp[8][4];
    tc_abt<HD>(s, sQ + warp * 16 * LD, sK, lane);
    tc_abt<HD>(dp, sG + warp * 16 * LD, sV, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // element e: row g + 8 (e / 2), column n * 8 + 2 t4 + e % 2
        const float pr = k0 + n * 8 + 2 * t4 + (e & 1) < p.Tk ? exp2f(fmaf(s[n][e], p.scale_log2, -ll[e >> 1])) : 0.f;
        s[n][e] = pr * (dp[n][e] - dd[e >> 1]);  // dS
      }
    uint32_t pa[4][4];
    tc_pack(pa, s);
    tc_pv<HD>(acc, pa, sK, lane);  // dQ += dS K
  }
  tc_store<HD>(static_cast<bf16*>(p.dq) + b * p.dqb + h * p.dqh, p.dqt, acc, q0 + warp * 16, p.Tq, p.scale2, lane);
}

// dK and dV over key tiles
template <int HD>
__global__ void __launch_bounds__(TC) flash_bwd_dkv_tc(Args p) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char tc_sm[];
  bf16* sK = reinterpret_cast<bf16*>(tc_sm);  // [64][HD + 8]
  bf16* sV = sK + BC * LD;
  bf16* sQ = sV + BC * LD;
  bf16* sG = sQ + BC * LD;                      // dO
  float* sL = reinterpret_cast<float*>(sG + BC * LD);  // lse of the query tile
  float* sD = sL + BC;                                 // D of the query tile

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.kb + h * p.kh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.vb + h * p.vh;
  const bf16* gp = static_cast<const bf16*>(p.g) + b * p.gb + h * p.gh;

  tc_load<HD>(sK, kp, p.kt, k0, p.Tk);
  tc_load<HD>(sV, vp, p.vt, k0, p.Tk);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += BC) {
    __syncthreads();  // the last tile's readers are done
    tc_load<HD>(sQ, qp, p.qt, q0, p.Tq);
    tc_load<HD>(sG, gp, p.gt, q0, p.Tq);
    if (threadIdx.x < BC) {  // rows past Tq: P = 2^-inf = 0, D = 0
      const int r = q0 + threadIdx.x;
      const bool in = r < p.Tq;
      sL[threadIdx.x] = in ? p.lse[static_cast<long long>(bh) * p.Tq + r] : INFINITY;
      sD[threadIdx.x] = in ? p.delta[static_cast<long long>(bh) * p.Tq + r] : 0.f;
    }
    tc_wait();
    float s[8][4], dp[8][4];
    uint32_t pa[4][4];
    tc_abt<HD>(s, sK + warp * 16 * LD, sQ, lane);  // S^T: this warp's 16 keys x 64 queries
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = exp2f(fmaf(s[n][e], p.scale_log2, -sL[n * 8 + 2 * t4 + (e & 1)]));
    tc_pack(pa, s);
    tc_pv<HD>(dv, pa, sG, lane);                     // dV += P^T dO
    tc_abt<HD>(dp, sV + warp * 16 * LD, sG, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - sD[n * 8 + 2 * t4 + (e & 1)];  // dS^T
    tc_pack(pa, s);
    tc_pv<HD>(dk, pa, sQ, lane);  // dK += dS^T Q
  }
  tc_store<HD>(static_cast<bf16*>(p.dk) + b * p.dkb + h * p.dkh, p.dkt, dk, k0 + warp * 16, p.Tk, p.scale2, lane);
  tc_store<HD>(static_cast<bf16*>(p.dv) + b * p.dvb + h * p.dvh, p.dvt, dv, k0 + warp * 16, p.Tk, 1.f, lane);
}

// ---- launch -----------------------------------------------------------------

template <typename K>
int launch_kernel(K kernel, int threads, int smem, int rows, int B, const Args& a, cudaStream_t stream) {
  dim3 grid((rows + BR - 1) / BR, B * a.H);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch(int which, int dtype, const Args& a, int B, cudaStream_t stream) {
  // the shared-memory limits are set once per process (one card)
  if (dtype == 0) {
    constexpr int smem = f32_smem_bytes<HD>();
    if (which == 0) {
      static const int attr = set_smem(flash_bwd_dq<HD>, smem);
      return attr ? attr : launch_kernel(flash_bwd_dq<HD>, NT, smem, a.Tq, B, a, stream);
    }
    static const int attr = set_smem(flash_bwd_dkv<HD>, smem);
    return attr ? attr : launch_kernel(flash_bwd_dkv<HD>, NT, smem, a.Tk, B, a, stream);
  }
  constexpr int smem = tc_smem_bytes<HD>();
  if (which == 0) {
    static const int attr = set_smem(flash_bwd_dq_tc<HD>, smem);
    return attr ? attr : launch_kernel(flash_bwd_dq_tc<HD>, TC, smem, a.Tq, B, a, stream);
  }
  static const int attr = set_smem(flash_bwd_dkv_tc<HD>, smem);
  return attr ? attr : launch_kernel(flash_bwd_dkv_tc<HD>, TC, smem, a.Tk, B, a, stream);
}

}  // namespace

extern "C" {

// which: 0 = the dQ kernel (also writes `delta`), 1 = the dK/dV kernel
// (reads it; launch it after the dQ kernel on the same stream). dtype: 0 =
// float32, 1 = bfloat16, for q, k, v, o, g (= dO) and dq, dk, dv alike
// (bf16: 16-byte aligned bases and row strides, checked by the wrapper).
// `lse` and `delta` are contiguous [B, H, Tq] f32. Strides are in elements,
// as (batch, head, time) for each of q, k, v, o, g, dq, dk, dv; head_dim is
// contiguous. Returns 0 on success, else the cudaError_t of the launch.
int sk_flash_attention_bwd(int which, int dtype, const void* q, const void* k, const void* v, const void* o,
                           const void* g, const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
                           int H, int Tq, int Tk, int hd, const long long* strides, float scale_log2,
                           float scale2, void* stream) {
  const long long* s = strides;
  const Args a{q, k, v, o, g, lse, delta, dq, dk, dv, H, Tq, Tk,
               s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14],
               s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
               scale_log2, scale2};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return launch<64>(which, dtype, a, B, cs);
    case 128:
      return launch<128>(which, dtype, a, B, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sk_bwd_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
