// SPDX-License-Identifier: Apache-2.0
//
// Non-causal flash attention for the Whisper encoder, written for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C entry point
// and loaded through ctypes (streamkit_tpu_torch/ops/attention.py).
//
// Replaces the TPU kernels of streamkit_tpu/ops/attention.py:
//   flash_attention -> _flash_call -> _flash_kernel   (pl.pallas_call :115)
//   _lib_flash -> jax.experimental.pallas.ops.tpu.flash_attention
// Both compute softmax((q*s)(k*s)^T) v with s = d**-0.25, f32 statistics and
// the output in q's dtype. One kernel here serves both.
//
// Bound on an H100 SXM: per call 4*B*H*Tq*Tk*d FLOPs against 4*B*H*T*d*2
// bytes. At the batched ring decode's shape [4, 20, 1500, 64] that is
// 46.1 GFLOP (46.6 us at 989 TFLOP/s bf16) against 61 MB (18 us at
// 3.35 TB/s): the tensor cores bound it. The softmax needs B*H*Tq*Tk =
// 180 M exponentials per call; at the SFU's 16 per clock per SM that is
// about as long as the products at the tensor cores' peak, so a kernel that
// runs the two in series cannot beat twice its bound.
//
// bf16 design (the usual Hopper shape):
//   * One CTA per (batch*head, query tile) of a producer warpgroup and
//     three consumer warpgroups of 64 query rows each (two where a grid of
//     192-row tiles would leave more of its last wave idle, e.g. B = 1 at
//     T = 1500). One producer thread issues TMA loads: Q once, then K and
//     V tiles of 128 rows into a ring of 4 stages (2 or 3 at d = 128)
//     guarded by mbarriers (full: TMA bytes landed; empty: every consumer
//     done with the K or the V of a stage, so K is reloaded while P V still
//     runs).
//   * wgmma, not mma.sync: a warpgroup's m64nNk16 product is the only way to
//     the tensor cores' full rate. S = Q K^T reads both operands from shared
//     memory (Q [rows, d] and K [cols, d] are both K-major); O += P V takes P
//     from registers (the S accumulator converted to bf16 A fragments) and
//     V [cols, d] as an MN-major operand through the transpose bit.
//   * Tensor maps describe the head-split views [B, H, T, d] of the
//     encoder's [B, T, H*d] projections in place (4-d: d, T, H, B; time
//     stride H*d): no copy. 128-byte swizzle (d = 64 bf16 is one 128-byte
//     row), matching the wgmma descriptors' layout; d = 128 is two 64-column
//     sub-tiles. TMA zero-fills rows past T; score columns past Tk are set to
//     -inf and query rows past Tq are not stored.
//   * What sets the pace is each warpgroup's own chain per tile (S, its
//     softmax, P V), not the tensor cores or the SFU, so the CTA runs three
//     independent consumer chains where the grid allows. Two consumers that
//     take turns on named barriers (one's softmax under the other's
//     products), also in the FlashAttention-3 order (S of tile i issued with
//     P V of tile i - 1), ran slower on the card (PERF.md).
//   * Softmax in base 2 with log2(e) folded into the score scale; the scale
//     is applied in f32 after the product, fused into the exponent's FFMA
//     (the Pallas body rounds q*scale^2*log2e in the input dtype instead).
//     The row max is taken on the raw scores (the wrapper requires scale >
//     0); max and sum run as independent partial chains.
//   * setmaxnreg hands the producer's registers to the consumers (24 / 160
//     with three consumers, 40 / 232 with two).
// f32: one thread per query row on the CUDA cores (the tensor cores have no
// full-f32 mode), 32-column K/V tiles in shared memory, the same online
// softmax. It serves f32 models and the parity runs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 128;             // K/V rows per tile
constexpr int SUB_KV = BN * 128;    // bytes of one 64-column (128-byte row) sub-tile of K or V
constexpr int BQ_F32 = 64;          // query rows per block (f32: one per thread)
constexpr int BK_F32 = 32;          // K/V columns per tile (f32)
constexpr float NEG_BIG = -1e30f;

// error codes beside cudaError_t (sk_error_string)
constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // it refused a q/k/v geometry

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

// D (64 x 128 f32) (+)= A (64 x 16, K-major, smem) * B (16 x 128, K-major, smem)
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64 f32) (+)= A (64 x 16 bf16, registers) * B (16 x 64, MN-major, smem)
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128 f32) (+)= A (64 x 16 bf16, registers) * B (16 x 128, MN-major, smem)
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// K/V ring depth: as deep as shared memory allows (one CTA per SM)
template <int HD, int NC>
__host__ __device__ constexpr int stages() {
  return HD == 64 ? 4 : (NC == 2 ? 3 : 2);
}

// NC consumer warpgroups of 64 query rows each
template <int HD, int NC>
struct alignas(1024) Tiles {
  static constexpr int S = stages<HD, NC>();
  __nv_bfloat16 q[HD / 64][64 * NC * 64];
  __nv_bfloat16 k[S][HD / 64][BN * 64];
  __nv_bfloat16 v[S][HD / 64][BN * 64];
  uint64_t q_full, k_full[S], v_full[S], k_empty[S], v_empty[S];
};

template <int HD, int NC>
constexpr int bf16_smem_bytes() {
  return static_cast<int>(sizeof(Tiles<HD, NC>)) + 1024;  // + slack to align the base to 1024 bytes
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64k16_tb(acc, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128k16_tb(acc, a, db, 1);
}

template <int HD, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1) flash_fwd_bf16(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H, int Tq, int Tk,
    long long ob, long long oh, long long ot, float scale_log2) {
  constexpr int NSUB = HD / 64;
  constexpr int STAGES = stages<HD, NC>();
  constexpr int BM = 64 * NC;        // query rows per CTA
  constexpr int SUB_Q = BM * 128;    // bytes of one 64-column (128-byte row) sub-tile of Q
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (sk::smem_addr(smem_raw) & 1023u)) & 1023u;
  Tiles<HD, NC>& sm = *reinterpret_cast<Tiles<HD, NC>*>(smem_raw + pad);

  const int wg = threadIdx.x >> 7;  // 0: producer, 1..NC: consumers
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (Tk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    sk::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sk::mbar_init(&sm.k_full[s], 1);
      sk::mbar_init(&sm.v_full[s], 1);
      sk::mbar_init(&sm.k_empty[s], NC * 128);
      sk::mbar_init(&sm.v_empty[s], NC * 128);
    }
    sk::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight --------------
    sk::setmaxnreg_dec<NC == 2 ? 40 : 24>();
    if (threadIdx.x == 0) {
      sk::tma_prefetch(&tq);
      sk::tma_prefetch(&tk);
      sk::tma_prefetch(&tv);
      sk::mbar_expect_tx(&sm.q_full, BM * HD * 2);
      for (int j = 0; j < NSUB; ++j) sk::tma_load_4d(sm.q[j], &tq, &sm.q_full, j * 64, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        sk::mbar_wait(&sm.k_empty[s], phase ^ 1);  // the first round passes at once
        sk::mbar_expect_tx(&sm.k_full[s], BN * HD * 2);
        for (int j = 0; j < NSUB; ++j) sk::tma_load_4d(sm.k[s][j], &tk, &sm.k_full[s], j * 64, it * BN, h, b);
        sk::mbar_wait(&sm.v_empty[s], phase ^ 1);
        sk::mbar_expect_tx(&sm.v_full[s], BN * HD * 2);
        for (int j = 0; j < NSUB; ++j) sk::tma_load_4d(sm.v[s][j], &tv, &sm.v_full[s], j * 64, it * BN, h, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    sk::setmaxnreg_inc<NC == 2 ? 232 : 160>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;

    const uint32_t q_base = sk::smem_addr(&sm.q[0][0]) + cw * 64 * 128;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_BIG, m1 = NEG_BIG;  // running max of the raw scores of rows g and g + 8
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums

    sk::mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      const uint32_t k_base = sk::smem_addr(&sm.k[s][0][0]);
      const uint32_t v_base = sk::smem_addr(&sm.v[s][0][0]);

      // S = Q K^T: 64 rows x 128 columns, d in steps of 16 (32 bytes inside
      // a 128-byte swizzled row; the next 64 columns are the next sub-tile)
      float sc[64];
      sk::mbar_wait(&sm.k_full[s], phase);
      sk::fence_regs(sc);
      sk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * SUB_Q + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * SUB_KV + (kk % 4) * 32;
        wgmma_ss_m64n128k16(sc, sk::wgmma_desc(q_base + off, 16, 1024), sk::wgmma_desc(k_base + koff, 16, 1024),
                            kk > 0);
      }
      sk::wgmma_commit();
      sk::wgmma_wait<0>();
      sk::fence_regs(sc);
      sk::mbar_arrive(&sm.k_empty[s]);  // K of this stage may be reloaded

      // online softmax on the raw scores (scale > 0, so the max commutes
      // with it): p = 2^(s*scale - max*scale), one FFMA and one ex2 per
      // element. sc[4j..4j+3] hold columns 8j + 2t4 + {0, 1} of rows g
      // (first two) and g + 8 (last two). Max and sum run as four
      // independent chains each: the softmax is the kernel's critical path.
      if (it * BN + BN > Tk) {
        const int c0 = it * BN + 2 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (c0 + 8 * j >= Tk) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
          if (c0 + 8 * j + 1 >= Tk) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
        }
      }
      float mxa[4] = {m0, m0, m0, m0}, mxb[4] = {m1, m1, m1, m1};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mxa[j & 3] = fmaxf(mxa[j & 3], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mxb[j & 3] = fmaxf(mxb[j & 3], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float mx0 = fmaxf(fmaxf(mxa[0], mxa[1]), fmaxf(mxa[2], mxa[3]));
      float mx1 = fmaxf(fmaxf(mxb[0], mxb[1]), fmaxf(mxb[2], mxb[3]));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = sk::exp2_approx((m0 - mx0) * scale_log2), corr1 = sk::exp2_approx((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
      float la[4] = {0.f, 0.f, 0.f, 0.f}, lb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = sk::exp2_approx(fmaf(sc[4 * j], scale_log2, -ms0));
        sc[4 * j + 1] = sk::exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -ms0));
        sc[4 * j + 2] = sk::exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -ms1));
        sc[4 * j + 3] = sk::exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -ms1));
        la[j & 3] += sc[4 * j] + sc[4 * j + 1];
        lb[j & 3] += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * corr0 + ((la[0] + la[1]) + (la[2] + la[3]));
      l1 = l1 * corr1 + ((lb[0] + lb[1]) + (lb[2] + lb[3]));
      // P as bf16 A fragments: columns 16kk.. of rows g / g + 8 are the
      // accumulators of n-tiles 2kk and 2kk + 1
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = sk::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = sk::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = sk::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = sk::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }

      // O += P V: 16 V rows (2048 bytes) per k-step; V is MN-major (d
      // contiguous): 8-row groups 1024 bytes apart, 64-column blocks one
      // sub-tile apart
      sk::mbar_wait(&sm.v_full[s], phase);
      sk::fence_regs(acc);
      sk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv<HD>(acc, pa[kk], sk::wgmma_desc(v_base + kk * 2048, SUB_KV, 1024));
      sk::wgmma_commit();
      sk::wgmma_wait<0>();
      sk::fence_regs(acc);
      sk::mbar_arrive(&sm.v_empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;
    __nv_bfloat16* op = o + b * ob + h * oh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (r0 < Tq) *reinterpret_cast<uint32_t*>(op + r0 * ot + c) = sk::pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r1 < Tq)
        *reinterpret_cast<uint32_t*>(op + r1 * ot + c) = sk::pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(BQ_F32) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int H, int Tq, int Tk, Strides st, float scale_log2) {
  __shared__ float Ks[BK_F32][HD];
  __shared__ float Vs[BK_F32][HD];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int r = blockIdx.x * BQ_F32 + threadIdx.x;
  const bool valid = r < Tq;
  const float* qp = q + b * st.qb + h * st.qh + (valid ? r : 0) * st.qt;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = valid ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_BIG, l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK_F32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK_F32 * HD; idx += blockDim.x) {
      const int row = idx / HD, col = idx % HD;
      const bool in = k0 + row < Tk;
      Ks[row][col] = in ? kp[(k0 + row) * st.kt + col] : 0.f;
      Vs[row][col] = in ? vp[(k0 + row) * st.vt + col] : 0.f;
    }
    __syncthreads();
    const int n = min(BK_F32, Tk - k0);
    float s[BK_F32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK_F32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      s[j] = j < n ? dot * scale_log2 : NEG_BIG;
      mx = fmaxf(mx, s[j]);
    }
    const float c = exp2f(m - mx);
    m = mx;
    l *= c;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= c;
#pragma unroll
    for (int j = 0; j < BK_F32; ++j) {
      const float p = exp2f(s[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
  }
  if (valid) {
    float* out = o + b * st.ob + h * st.oh + r * st.ot;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < HD; ++d) out[d] = acc[d] * inv;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// 4-d map over a [B, H, T, hd] bf16 view (element strides b, h, t; unit hd
// stride): dims innermost first (hd, T, H, B), boxes of 64 columns x 128
// rows, 128-byte swizzle, zero fill past T. The wrapper has checked what
// TMA needs: a 16-byte aligned base and strides that are multiples of 16
// bytes below 2^40.
int encode(EncodeTiled fn, CUtensorMap* map, const void* base, int hd, int T, int H, int B, long long sb,
           long long sh, long long st, int rows = 128) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

template <int HD, int NC>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Tq, int Tk,
                const Strides& st, float scale_log2, cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap mq, mk, mv;
  int err = encode(fn, &mq, q, HD, Tq, H, B, st.qb, st.qh, st.qt, BM);
  if (!err) err = encode(fn, &mk, k, HD, Tk, H, B, st.kb, st.kh, st.kt);
  if (!err) err = encode(fn, &mv, v, HD, Tk, H, B, st.vb, st.vh, st.vt);
  if (err) return err;
  constexpr int smem = bf16_smem_bytes<HD, NC>();
  static const cudaError_t attr =  // once per process (one card)
      cudaFuncSetAttribute(flash_fwd_bf16<HD, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_fwd_bf16<HD, NC><<<grid, 128 * (NC + 1), smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, Tq,
                                                                  Tk, st.ob, st.oh, st.ot, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Three consumer chains per SM unless the grid then leaves more of a last,
// partial wave idle than two do: a CTA of three takes about 1.25 times as
// long as one of two (tuned on the H100 at the ring decode's and
// transcribe_window's shapes, chip_smoke.py).
int consumers(int B, int H, int Tq) {
  const int sms = sm_count();
  const long long n3 = static_cast<long long>(B) * H * ((Tq + 191) / 192);
  const long long n2 = static_cast<long long>(B) * H * ((Tq + 127) / 128);
  return 5 * ((n3 + sms - 1) / sms) < 4 * ((n2 + sms - 1) / sms) ? 3 : 2;
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H, int Tq, int Tk,
           const Strides& st, float scale_log2, cudaStream_t stream) {
  if (dtype == 1) {
    if (consumers(B, H, Tq) == 3) return launch_bf16<HD, 3>(q, k, v, o, B, H, Tq, Tk, st, scale_log2, stream);
    return launch_bf16<HD, 2>(q, k, v, o, B, H, Tq, Tk, st, scale_log2, stream);
  }
  dim3 grid((Tq + BQ_F32 - 1) / BQ_F32, B * H);
  flash_fwd_f32<HD><<<grid, BQ_F32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Tq, Tk, st, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; head_dim is
// contiguous. Returns 0 on success, else a cudaError_t of the launch or one
// of the negative codes above (sk_error_string names each).
int sk_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Tq, int Tk, int hd, long long qsb, long long qsh, long long qst, long long ksb,
                       long long ksh, long long kst, long long vsb, long long vsh, long long vst,
                       long long osb, long long osh, long long ost, float scale_log2, void* stream) {
  const Strides st{qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, o, B, H, Tq, Tk, st, scale_log2, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, H, Tq, Tk, st, scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sk_error_string(int err) {
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled is not available";
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a q/k/v geometry";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
