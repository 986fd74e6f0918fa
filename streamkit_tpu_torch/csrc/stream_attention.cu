// SPDX-License-Identifier: Apache-2.0
//
// Streaming-encoder attention over an int8 K/V history, written for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C entry point
// and loaded through ctypes (streamkit_tpu_torch/ops/stream_attention.py).
//
// Replaces the TPU kernel of streamkit_tpu/ops/stream_attention.py:
//   history_attention -> _kernel   (pl.pallas_call :147)
// Per batch row b and head h, for the c query rows of this call:
//   history scores   (qs . (k8 * op)) * ks[t]     masked by t < pos[b]
//   candidate scores (qs . (ck8 * op)) * cks[j2]  masked by j2 < (j/8+1)*8
//   one softmax over the T + c columns (f32)
//   out = sum_t round(p*vs[t]) v8[:, t] + sum_j2 round(pc*cvs[j2]) cv8[:, j2]
// with f32 output. "round" is the model dtype's rounding (bf16 or none), at
// the two places the reference rounds: k8 * op is rounded to the model dtype
// before the dot (op itself is the dtype-rounded scale), and the
// probabilities are rounded after the column scale is folded in. Rounding
// anywhere else would move the bf16 result by more than its tolerance.
//
// Bound on an H100 SXM: bytes. Per call the valid int8 history is
// 2*H*hd*sum(pos) bytes plus 8*H*sum(pos) of f32 scales, against
// 4*H*c*hd*(sum(pos) + B*c) operations; at the live path's shape
// [8, 20, 16, 64, 512] with pos = linspace(0, 512, 8) that is 6.9 MB (2.06 us
// at 3.35 TB/s) against 0.35 GFLOP (0.35 us at 989 TFLOP/s bf16).
//
// bf16 design (tensor cores):
//   * mma.sync m16n8k16 (bf16 in, f32 accumulate), not wgmma: a call has
//     c = 16 query rows and a wgmma needs 64, so three quarters of every
//     wgmma would be padding. The 16 rows are one m16 tile; c % 16 = 8 pads
//     the last tile with rows that are masked and not stored.
//   * One CTA of 8 warps per (b, h, 16-row tile), two CTAs per SM, the rows
//     with the most history first (each CTA ranks pos[] itself). The
//     kernel is latency-bound (a few KB per CTA, a serial chain of tiles),
//     so everything is copied asynchronously up front: this call's
//     candidate columns and scales first, then the valid history columns
//     (t < pos[b] only: masked history is never read) as int8 tiles of 128
//     columns with their column scales, by 16-byte cp.async copies into a
//     ring of 4 stages (8 at hd = 32, 2 at hd = 128): K tiles first, then V
//     tiles, so the V loads run under the score pass and the softmax.
//   * Scores: each K tile is dequantised once, round_bf16(k8 * op), into a
//     bf16 shared-memory tile; k8 [hd, T] is the row-major B of q.K, read by
//     ldmatrix.trans. Warp w owns columns 16w..16w+15 of every tile. int8
//     becomes f32 by a byte permute and an add (not the quarter-rate I2F).
//   * Exact two-pass softmax: the reference rounds the *normalised*
//     probability times vs[t] to bf16, so p must be formed from the final
//     row max and sum. The scores of the 16 rows stay in shared memory (each
//     thread keeps its own columns there); each thread keeps a running max
//     and sum of its columns in pass 1, and pass 2 only reduces those across
//     the threads and warps.
//   * P.V^T: each thread forms round_bf16(p * vs[t]) for its own columns as
//     A fragments; v8 [hd, T] is the column-major B, read straight from the
//     int8 tile as byte pairs (int8 is exact in bf16). The warps' partial
//     outputs are summed through shared memory.
// f32 queries: the CUDA-core kernel (one block per (b*h, 8 query rows)); the
// tensor cores have no full-f32 mode and f32 serves the parity runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int TT = 128;            // history columns per tile: 16 per warp
constexpr int WARPS = 8;
constexpr int TC_THREADS = 32 * WARPS;
constexpr int RING_ROW = TT + 16;  // bytes per int8 tile row: 16-byte aligned, 8 rows on distinct banks
constexpr int KB_ROW = TT + 8;     // bf16 elements per dequantised K row (ldmatrix rows on distinct banks)
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int ring_stages() {
  return HD == 128 ? 2 : (HD == 64 ? 4 : 8);
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// one ring stage: an int8 tile [hd][RING_ROW] and its TT column scales
__host__ __device__ constexpr int stage_bytes(int hd) { return hd * RING_ROW + TT * 4; }

// the bf16 kernel's shared memory, in this order (wrapper: _smem_bytes)
struct Layout {
  int ring, kb, cand, sp, stats, cs, total, c_row, sp_row, t_round, c_pad;
  __host__ __device__ Layout(int hd, int T, int c, int stages) {
    t_round = round_up(T, TT);
    c_pad = round_up(c, 16);
    c_row = c_pad + 4;  // bytes per candidate int8 row
    sp_row = t_round + c_pad + 8;
    ring = 0;
    kb = ring + stages * stage_bytes(hd);
    cand = kb + hd * KB_ROW * 2;  // candidate K, then candidate V, int8
    sp = cand + round_up(2 * hd * c_row, 16);
    stats = sp + 16 * sp_row * 4;
    cs = stats + 2 * WARPS * 16 * 4;
    total = cs + 2 * c_pad * 4;
  }
};

// byte k of w ^ 0x80808080 (an int8 x, flipped to x + 128) as a float,
// exactly: (2^23 + x + 128) - (2^23 + 128), one PRMT and one FADD instead of
// a quarter-rate I2F
template <int K>
__device__ __forceinline__ float i8_to_f32(uint32_t flipped) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | K)) - 8388736.f;
}

// two int8 (low byte first) as a bf16 pair: exact
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t u16) {
  const uint32_t f = u16 ^ 0x8080u;
  return sk::pack_bf16(i8_to_f32<0>(f), i8_to_f32<1>(f));
}

// VEC: bytes per copy of the int8 history (16 or 4 by cp.async, 1 by plain
// loads), the largest that its row stride T and the bases allow
template <int HD, int VEC>
__global__ void __launch_bounds__(TC_THREADS, 2) history_attention_tc(
    const __nv_bfloat16* __restrict__ qs, const int8_t* __restrict__ k8, const float* __restrict__ ks,
    const int8_t* __restrict__ v8, const float* __restrict__ vs, const int8_t* __restrict__ ck8,
    const float* __restrict__ cks, const int8_t* __restrict__ cv8, const float* __restrict__ cvs,
    const int* __restrict__ pos, float* __restrict__ out, int H, int c, int T, float op) {
  constexpr int NST = ring_stages<HD>();
  constexpr int NK = HD / 16;  // k-steps of q.K
  constexpr int ND = HD / 8;   // n-tiles of P.V^T
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(HD, T, c, NST);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(smem + L.kb);
  int8_t* ckt = reinterpret_cast<int8_t*>(smem + L.cand);  // [HD][c_row]
  int8_t* cvt = ckt + HD * L.c_row;
  float* sp = reinterpret_cast<float*>(smem + L.sp);
  float* smax = reinterpret_cast<float*>(smem + L.stats);  // [WARPS][16 rows]
  float* ssum = smax + WARPS * 16;
  float* ccs = reinterpret_cast<float*>(smem + L.cs);  // [c_pad] cks, then [c_pad] cvs

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // longest first: CTA x*H + h takes head h of the batch row with the x-th
  // most history, so the rows that load the most start (and queue their
  // copies) first
  __shared__ int row_of_rank;
  {
    const int x = static_cast<int>(blockIdx.x / H), B = gridDim.x / H;
    for (int r = tid; r < B; r += TC_THREADS) {
      const int pr = pos[r];
      int rank = 0;
      for (int o = 0; o < B; ++o) {
        const int po = pos[o];
        rank += po > pr || (po == pr && o < r);
      }
      if (rank == x) row_of_rank = r;
    }
    __syncthreads();
  }
  const int b = row_of_rank;
  const long long bh = static_cast<long long>(b) * H + blockIdx.x % H;
  const int m0 = blockIdx.y * 16;  // first query row of this tile
  int hist = pos[b];
  hist = hist < 0 ? 0 : (hist > T ? T : hist);
  const int n = (hist + TT - 1) / TT;  // history tiles
  const int8_t* kg = k8 + bh * HD * T;
  const int8_t* vg = v8 + bh * HD * T;
  const float* ksg = ks + bh * T;
  const float* vsg = vs + bh * T;
  auto stage = [&](int item) { return ring + (item % NST) * stage_bytes(HD); };
  auto stage_scales = [&](int item) { return reinterpret_cast<const float*>(stage(item) + HD * RING_ROW); };

  // queries as A fragments (rows past c are zero)
  uint32_t qa[NK][4];
  {
    const __nv_bfloat16* qb = qs + (bh * c + m0) * HD;
    const bool in0 = m0 + g < c, in1 = m0 + g + 8 < c;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int col = kk * 16 + 2 * t4;
      qa[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(qb + g * HD + col) : 0u;
      qa[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(qb + (g + 8) * HD + col) : 0u;
      qa[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(qb + g * HD + col + 8) : 0u;
      qa[kk][3] = in1 ? *reinterpret_cast<const uint32_t*>(qb + (g + 8) * HD + col + 8) : 0u;
    }
  }

  // group 0: this call's candidate columns and their scales
  {
    const int8_t* ckg = ck8 + bh * HD * c;
    const int8_t* cvg = cv8 + bh * HD * c;
    for (int i = tid; i < HD * (L.c_pad / 4); i += TC_THREADS) {
      const int d = i / (L.c_pad / 4), j2 = (i % (L.c_pad / 4)) * 4;
      const int bytes = j2 < c ? 4 : 0;  // c % 8 == 0
      if constexpr (VEC >= 4) {
        sk::cp_async4(ckt + d * L.c_row + j2, ckg + d * c + (bytes ? j2 : 0), bytes);
        sk::cp_async4(cvt + d * L.c_row + j2, cvg + d * c + (bytes ? j2 : 0), bytes);
      } else {
        for (int e = 0; e < 4; ++e) {
          ckt[d * L.c_row + j2 + e] = bytes ? ckg[d * c + j2 + e] : 0;
          cvt[d * L.c_row + j2 + e] = bytes ? cvg[d * c + j2 + e] : 0;
        }
      }
    }
    for (int j2 = tid; j2 < L.c_pad; j2 += TC_THREADS) {
      const int in = j2 < c ? 4 : 0;
      sk::cp_async4(ccs + j2, cks + bh * c + (in ? j2 : 0), in);
      sk::cp_async4(ccs + L.c_pad + j2, cvs + bh * c + (in ? j2 : 0), in);
    }
    sk::cp_async_commit();
  }

  // ring item i < n: K tile i and ks; n <= i < 2n: V tile i - n and vs.
  // Only columns below hist are read; the rest of a tile is zero-filled.
  auto issue = [&](int item) {
    if (item < 2 * n) {
      const int8_t* src = item < n ? kg : vg;
      const float* scale = item < n ? ksg : vsg;
      const int col0 = (item < n ? item : item - n) * TT;
      int8_t* dst = stage(item);
      if constexpr (VEC == 16) {  // scales too by 16-byte copies
        if (tid < TT / 4) {
          const int col = col0 + 4 * tid, bytes = min(max(4 * (hist - col), 0), 16);
          sk::cp_async16(dst + HD * RING_ROW + 16 * tid, scale + (bytes > 0 ? col : 0), bytes);
        }
      } else if (tid < TT) {
        const int col = col0 + tid;
        sk::cp_async4(dst + HD * RING_ROW + 4 * tid, scale + (col < hist ? col : 0), col < hist ? 4 : 0);
      }
      for (int idx = tid; idx < HD * (TT / VEC); idx += TC_THREADS) {
        const int d = idx / (TT / VEC), cc = (idx % (TT / VEC)) * VEC;
        const int col = col0 + cc;
        const int bytes = min(max(hist - col, 0), VEC);
        const int8_t* s = src + static_cast<long long>(d) * T + (bytes > 0 ? col : 0);
        int8_t* o = dst + d * RING_ROW + cc;
        if constexpr (VEC == 16) {
          sk::cp_async16(o, s, bytes);
        } else if constexpr (VEC == 4) {
          sk::cp_async4(o, s, bytes);
        } else {
          *o = bytes > 0 ? *s : 0;
        }
      }
    }
    sk::cp_async_commit();  // one group per item, empty or not: the waits count items
  };
#pragma unroll
  for (int i = 0; i < NST; ++i) issue(i);

  // ---- pass 1: scores ---------------------------------------------------
  // this thread's running max and sum of exp(s - max) over its columns of
  // rows g and g + 8 (the sum is combined in pass 2; p itself is formed
  // from the final max in pass 3, as the two-pass reference forms it)
  float mx0 = -INFINITY, mx1 = -INFINITY, sm0 = 0.f, sm1 = 0.f;
  auto online = [](float& m, float& l, float2 v) {
    const float mn = fmaxf(m, fmaxf(v.x, v.y));
    if (mn != -INFINITY) {
      l = l * sk::exp2_approx((m - mn) * LOG2E) + sk::exp2_approx((v.x - mn) * LOG2E) +
          sk::exp2_approx((v.y - mn) * LOG2E);
      m = mn;
    }
  };
  // round_bf16(k8 * op) into kb: the products are exact in f32 and rounded
  // once. Four int8 of a word become two bf16 pairs.
  auto dq4 = [&](uint32_t w, uint32_t& lo, uint32_t& hi) {
    const uint32_t f = w ^ 0x80808080u;
    lo = sk::pack_bf16(i8_to_f32<0>(f) * op, i8_to_f32<1>(f) * op);
    hi = sk::pack_bf16(i8_to_f32<2>(f) * op, i8_to_f32<3>(f) * op);
  };
  // a ring tile, 16 columns per thread and step (16-byte loads and stores)
  auto dequant_tile = [&](const int8_t* src) {
#pragma unroll
    for (int r = 0; r < HD * (TT / 16) / TC_THREADS; ++r) {
      const int chunk = tid + r * TC_THREADS, d = chunk / (TT / 16), cc = (chunk % (TT / 16)) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(src + d * RING_ROW + cc);
      uint4 a, b;
      dq4(w.x, a.x, a.y);
      dq4(w.y, a.z, a.w);
      dq4(w.z, b.x, b.y);
      dq4(w.w, b.z, b.w);
      *reinterpret_cast<uint4*>(kb + d * KB_ROW + cc) = a;
      *reinterpret_cast<uint4*>(kb + d * KB_ROW + cc + 8) = b;
    }
  };
  // the candidate tile (rows of c_row bytes), 4 columns per thread and step
  auto dequant_cand = [&](const int8_t* src, int cols) {
    for (int idx = tid; idx < HD * (cols / 4); idx += TC_THREADS) {
      const int d = idx / (cols / 4), cc = (idx % (cols / 4)) * 4;
      uint2 pk;
      dq4(*reinterpret_cast<const uint32_t*>(src + d * L.c_row + cc), pk.x, pk.y);
      *reinterpret_cast<uint2*>(kb + d * KB_ROW + cc) = pk;
    }
  };
  // S[16 x 16] for this warp's columns of the dequantised tile in kb
  auto score_tile = [&](float s[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t bk[4];
      sk::ldsm_x4_trans(bk, kb + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * KB_ROW + 16 * warp + (mi >> 1) * 8);
      sk::mma_16816(s[0], qa[kk], bk[0], bk[1]);
      sk::mma_16816(s[1], qa[kk], bk[2], bk[3]);
    }
  };
  // candidate columns, TT at a time: rows in chunk j/8 see j2 < (j/8+1)*8
  sk::cp_async_wait<NST>();  // group 0 (the ring items are newer)
  const int vis0 = ((m0 + g) / 8 + 1) * 8, vis1 = ((m0 + g + 8) / 8 + 1) * 8;
  for (int c0 = 0; c0 < c; c0 += TT) {
    __syncthreads();  // every warp is done with kb; the candidates landed
    dequant_cand(ckt + c0, min(TT, L.c_pad - c0));
    __syncthreads();
    if (c0 + 16 * warp < c) {
      float s[2][4];
      score_tile(s);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j2 = c0 + 16 * warp + 8 * nt + 2 * t4;
        const float cs0 = ccs[j2], cs1 = ccs[j2 + 1];
        const float2 r0 = make_float2(j2 < c && j2 < vis0 ? s[nt][0] * cs0 : -INFINITY,
                                      j2 + 1 < c && j2 + 1 < vis0 ? s[nt][1] * cs1 : -INFINITY);
        const float2 r1 = make_float2(j2 < c && j2 < vis1 ? s[nt][2] * cs0 : -INFINITY,
                                      j2 + 1 < c && j2 + 1 < vis1 ? s[nt][3] * cs1 : -INFINITY);
        *reinterpret_cast<float2*>(sp + g * L.sp_row + L.t_round + j2) = r0;
        *reinterpret_cast<float2*>(sp + (g + 8) * L.sp_row + L.t_round + j2) = r1;
        online(mx0, sm0, r0);
        online(mx1, sm1, r1);
      }
    }
  }

  for (int i = 0; i < n; ++i) {
    sk::cp_async_wait<NST - 1>();
    __syncthreads();  // tile i landed for every thread; kb is free
    // this thread's column scales, read before the stage is reloaded
    const float2 ksa = *reinterpret_cast<const float2*>(stage_scales(i) + 16 * warp + 2 * t4);
    const float2 ksb = *reinterpret_cast<const float2*>(stage_scales(i) + 16 * warp + 8 + 2 * t4);
    dequant_tile(stage(i));
    __syncthreads();  // kb written; ring stage free
    issue(i + NST);
    float s[2][4];
    score_tile(s);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = i * TT + 16 * warp + 8 * nt + 2 * t4;
      const float ks0 = nt ? ksb.x : ksa.x, ks1 = nt ? ksb.y : ksa.y;
      const float2 r0 = make_float2(t < hist ? s[nt][0] * ks0 : -INFINITY, t + 1 < hist ? s[nt][1] * ks1 : -INFINITY);
      const float2 r1 = make_float2(t < hist ? s[nt][2] * ks0 : -INFINITY, t + 1 < hist ? s[nt][3] * ks1 : -INFINITY);
      *reinterpret_cast<float2*>(sp + g * L.sp_row + t) = r0;
      *reinterpret_cast<float2*>(sp + (g + 8) * L.sp_row + t) = r1;
      online(mx0, sm0, r0);
      online(mx1, sm1, r1);
    }
  }
  // ---- pass 2: row max and sum over the threads and warps ----------------
  float qm0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  qm0 = fmaxf(qm0, __shfl_xor_sync(0xffffffffu, qm0, 2));
  float qm1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  qm1 = fmaxf(qm1, __shfl_xor_sync(0xffffffffu, qm1, 2));
  if (t4 == 0) {
    smax[warp * 16 + g] = qm0;
    smax[warp * 16 + g + 8] = qm1;
  }
  __syncthreads();
  float rm0 = -INFINITY, rm1 = -INFINITY;  // finite: every row sees a candidate
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    rm0 = fmaxf(rm0, smax[w * 16 + g]);
    rm1 = fmaxf(rm1, smax[w * 16 + g + 8]);
  }
  float l0 = sm0 * sk::exp2_approx((mx0 - rm0) * LOG2E), l1 = sm1 * sk::exp2_approx((mx1 - rm1) * LOG2E);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t4 == 0) {
    ssum[warp * 16 + g] = l0;
    ssum[warp * 16 + g + 8] = l1;
  }
  __syncthreads();
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    sum0 += ssum[w * 16 + g];
    sum1 += ssum[w * 16 + g + 8];
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  const float rm0l = rm0 * LOG2E, rm1l = rm1 * LOG2E;

  // ---- pass 3: out += round(p * vs) v8^T over this warp's columns --------
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // A fragment of round(p * scale), p = exp(s - max) / sum, for columns
  // col..col+15 of the 16 rows (row g, g + 8; pairs 2t4 and 2t4 + 8)
  auto prob_frag = [&](uint32_t pa[4], const float* row0, const float* row1, int col, float s0, float s1, float s8,
                       float s9) {
    const float2 a = *reinterpret_cast<const float2*>(row0 + col), b = *reinterpret_cast<const float2*>(row1 + col);
    const float2 c2 = *reinterpret_cast<const float2*>(row0 + col + 8);
    const float2 d2 = *reinterpret_cast<const float2*>(row1 + col + 8);
    auto e0 = [&](float x) { return sk::exp2_approx(fmaf(x, LOG2E, -rm0l)) * inv0; };
    auto e1 = [&](float x) { return sk::exp2_approx(fmaf(x, LOG2E, -rm1l)) * inv1; };
    pa[0] = sk::pack_bf16(e0(a.x) * s0, e0(a.y) * s1);
    pa[1] = sk::pack_bf16(e1(b.x) * s0, e1(b.y) * s1);
    pa[2] = sk::pack_bf16(e0(c2.x) * s8, e0(c2.y) * s9);
    pa[3] = sk::pack_bf16(e1(d2.x) * s8, e1(d2.y) * s9);
  };
  // B fragments straight from an int8 [hd][row] tile at this warp's columns
  auto attend = [&](const uint32_t pa[4], const int8_t* tile, int row_bytes, int col) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int8_t* r = tile + (8 * j + g) * row_bytes + col;
      const uint32_t b0 = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(r));
      const uint32_t b1 = i8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(r + 8));
      sk::mma_16816(acc[j], pa, b0, b1);
    }
  };
  for (int c0 = 0; c0 < c; c0 += TT) {
    if (c0 + 16 * warp < c) {
      const int j2 = c0 + 16 * warp + 2 * t4;
      const float* cv_s = ccs + L.c_pad;
      uint32_t pa[4];
      prob_frag(pa, sp + g * L.sp_row + L.t_round, sp + (g + 8) * L.sp_row + L.t_round, j2, cv_s[j2], cv_s[j2 + 1],
                cv_s[j2 + 8], cv_s[j2 + 9]);
      attend(pa, cvt, L.c_row, j2);
    }
  }

  for (int i = 0; i < n; ++i) {
    sk::cp_async_wait<NST - 1>();
    __syncthreads();  // V tile i landed for every thread
    const int t = i * TT + 16 * warp + 2 * t4;
    const float2 vsa = *reinterpret_cast<const float2*>(stage_scales(n + i) + 16 * warp + 2 * t4);
    const float2 vsb = *reinterpret_cast<const float2*>(stage_scales(n + i) + 16 * warp + 8 + 2 * t4);
    uint32_t pa[4];
    prob_frag(pa, sp + g * L.sp_row, sp + (g + 8) * L.sp_row, t, vsa.x, vsa.y, vsb.x, vsb.y);
    attend(pa, stage(n + i), RING_ROW, 16 * warp + 2 * t4);
    __syncthreads();  // every warp is done with the stage
    issue(n + i + NST);
  }
  // ---- the warps' partial outputs, summed through the ring and kb --------
  __syncthreads();  // no warp reads the ring or kb any more
  float* red = reinterpret_cast<float*>(ring);  // [WARPS][16][HD]
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(red + (warp * 16 + g) * HD + d) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(red + (warp * 16 + g + 8) * HD + d) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  float* ob = out + (bh * c + m0) * HD;
#pragma unroll
  for (int r = 0; r < 16 * HD / TC_THREADS; ++r) {
    const int i = tid + r * TC_THREADS;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w * 16 * HD + i];
    if (m0 + i / HD < c) ob[i] = sum;
  }
}

// ---- f32: CUDA cores ---------------------------------------------------------

constexpr int ROWS = 8;       // query rows per block (one chunk)
constexpr int THREADS = 256;
constexpr int VT = 64;        // V columns per shared-memory tile
constexpr int VPAD = VT + 4;  // padded tile row (bytes)

// One block of 256 threads per (row*head, chunk of 8 query rows). The 8
// query rows sit in shared memory; each thread scores whole history columns
// (8 rows at once), reading the int8 K column straight from global memory.
// All T + c scores of the 8 rows stay in shared memory (exact two-pass
// softmax, one warp per row); the attend streams 64-column int8 V tiles
// through shared memory and gives each thread hd/32 outputs.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    history_attention_f32(const float* __restrict__ qs, const int8_t* __restrict__ k8,
                          const float* __restrict__ ks, const int8_t* __restrict__ v8,
                          const float* __restrict__ vs, const int8_t* __restrict__ ck8,
                          const float* __restrict__ cks, const int8_t* __restrict__ cv8,
                          const float* __restrict__ cvs, const int* __restrict__ pos,
                          float* __restrict__ out, int H, int c, int T, float op) {
  extern __shared__ float smem_f[];
  const int W = T + c;
  float* sq = smem_f;                   // [ROWS][HD]
  float* sp = sq + ROWS * HD;           // [ROWS][W] scores, then p*scale
  int8_t* sv = reinterpret_cast<int8_t*>(sp + ROWS * W);  // [HD][VPAD]

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int b = (int)(bh / H);
  const int j0 = blockIdx.y * ROWS;
  int hist = pos[b];
  hist = hist < 0 ? 0 : (hist > T ? T : hist);

  const float* qb = qs + (bh * c + j0) * HD;
  for (int i = tid; i < ROWS * HD; i += THREADS) sq[i] = qb[i];
  __syncthreads();

  // history scores: one column per thread, 8 rows at once
  const int8_t* kb = k8 + bh * HD * T;
  const float* ksb = ks + bh * T;
  for (int t = tid; t < T; t += THREADS) {
    if (t < hist) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float kd = (float)kb[(long long)d * T + t] * op;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sq[r * HD + d], kd, acc[r]);
      }
      const float s = ksb[t];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sp[r * W + t] = acc[r] * s;
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sp[r * W + t] = -INFINITY;
    }
  }
  // candidate scores: these rows see the candidates of their own and the
  // earlier chunks of this call
  const int visible = j0 + ROWS;
  const int8_t* ckb = ck8 + bh * HD * c;
  const float* cksb = cks + bh * c;
  for (int i = tid; i < ROWS * c; i += THREADS) {
    const int r = i / c, j2 = i % c;
    float v = -INFINITY;
    if (j2 < visible) {
      float acc = 0.f;
      for (int d = 0; d < HD; ++d) acc = fmaf(sq[r * HD + d], (float)ckb[d * c + j2] * op, acc);
      v = acc * cksb[j2];
    }
    sp[r * W + T + j2] = v;
  }
  __syncthreads();

  // softmax over T + c per row (one warp per row), then p * scale
  const int warp = tid / 32, lane = tid % 32;
  if (warp < ROWS) {
    float* row = sp + warp * W;
    float m = -INFINITY;
    for (int t = lane; t < W; t += 32) m = fmaxf(m, row[t]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int t = lane; t < W; t += 32) l += expf(row[t] - m);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    const float* vsb = vs + bh * T;
    for (int t = lane; t < hist; t += 32) row[t] = expf(row[t] - m) / l * vsb[t];
    const float* cvsb = cvs + bh * c;
    for (int j2 = lane; j2 < c; j2 += 32) row[T + j2] = expf(row[T + j2] - m) / l * cvsb[j2];
  }

  // attend: thread -> head-dim lane d and NO rows r0 + k*RP
  constexpr int RP = THREADS / HD;
  constexpr int NO = ROWS / RP;
  const int d = tid % HD, r0 = tid / HD;
  float acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0.f;
  const int8_t* vb = v8 + bh * HD * T;
  for (int t0 = 0; t0 < hist; t0 += VT) {
    const int n = min(VT, hist - t0);
    __syncthreads();  // scores finished / previous tile consumed
    for (int i = tid; i < HD * VT; i += THREADS) {
      const int dd = i / VT, tt = i % VT;
      sv[dd * VPAD + tt] = tt < n ? vb[(long long)dd * T + t0 + tt] : 0;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float v = (float)sv[d * VPAD + tt];
#pragma unroll
      for (int k = 0; k < NO; ++k) acc[k] = fmaf(sp[(r0 + k * RP) * W + t0 + tt], v, acc[k]);
    }
  }
  __syncthreads();  // the softmax pass is complete even when hist == 0
  const int8_t* cvb = cv8 + bh * HD * c;
  float accc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) accc[k] = 0.f;
  for (int j2 = 0; j2 < c; ++j2) {
    const float v = (float)cvb[d * c + j2];
#pragma unroll
    for (int k = 0; k < NO; ++k) accc[k] = fmaf(sp[(r0 + k * RP) * W + T + j2], v, accc[k]);
  }
#pragma unroll
  for (int k = 0; k < NO; ++k) out[(bh * c + j0 + r0 + k * RP) * HD + d] = acc[k] + accc[k];
}

struct Args {
  const void *qs, *k8;
  const float* ks;
  const void* v8;
  const float* vs;
  const void* ck8;
  const float* cks;
  const void* cv8;
  const float* cvs;
  const int* pos;
  float* out;
  int B, H, c, T;
  float op;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

template <int HD, int VEC>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout(HD, a.T, a.c, ring_stages<HD>()).total;
  auto kernel = history_attention_tc<HD, VEC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.c + 15) / 16));
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.qs), static_cast<const int8_t*>(a.k8), a.ks,
      static_cast<const int8_t*>(a.v8), a.vs, static_cast<const int8_t*>(a.ck8), a.cks,
      static_cast<const int8_t*>(a.cv8), a.cvs, a.pos, a.out, a.H, a.c, a.T, a.op);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(ROWS * HD + ROWS * (a.T + a.c)) * sizeof(float) + (size_t)HD * VPAD;
  auto kernel = history_attention_f32<HD>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(a.B * a.H), (unsigned)(a.c / ROWS));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.qs), static_cast<const int8_t*>(a.k8), a.ks, static_cast<const int8_t*>(a.v8),
      a.vs, static_cast<const int8_t*>(a.ck8), a.cks, static_cast<const int8_t*>(a.cv8), a.cvs, a.pos, a.out, a.H,
      a.c, a.T, a.op);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<HD>(a, stream);
  // widest copy that every int8 row start allows (candidates: 4 bytes)
  const uintptr_t hist = reinterpret_cast<uintptr_t>(a.k8) | reinterpret_cast<uintptr_t>(a.v8) |
                         reinterpret_cast<uintptr_t>(a.ks) | reinterpret_cast<uintptr_t>(a.vs);
  const uintptr_t cand = reinterpret_cast<uintptr_t>(a.ck8) | reinterpret_cast<uintptr_t>(a.cv8);
  if (a.T % 16 == 0 && hist % 16 == 0 && cand % 4 == 0) return launch_tc<HD, 16>(a, stream);
  if (a.T % 4 == 0 && (hist | cand) % 4 == 0) return launch_tc<HD, 4>(a, stream);
  return launch_tc<HD, 1>(a, stream);
}

}  // namespace

extern "C" {

// dtype of qs: 0 = float32, 1 = bfloat16. All tensors contiguous:
// qs [B,H,c,hd]; k8/v8 [B,H,hd,T] int8; ks/vs [B,H,T] f32; ck8/cv8
// [B,H,hd,c] int8; cks/cvs [B,H,c] f32; pos [B] int32; out [B,H,c,hd] f32.
// Requires c % 8 == 0 and hd in {32, 64, 128}; `op` is the operand scale
// already rounded to qs's dtype. Returns the cudaError_t of the launch.
int sk_history_attention(int dtype, const void* qs, const void* k8, const float* ks, const void* v8,
                         const float* vs, const void* ck8, const float* cks, const void* cv8, const float* cvs,
                         const int* pos, float* out, int B, int H, int c, int hd, int T, float op,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % ROWS != 0 || c <= 0 || T < 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const Args a{qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, out, B, H, c, T, op};
  switch (hd) {
    case 32: return dispatch<32>(dtype, a, st);
    case 64: return dispatch<64>(dtype, a, st);
    case 128: return dispatch<128>(dtype, a, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* sk_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
