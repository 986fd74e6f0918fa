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
// bytes. At the large-v3 encoder shape (B=1, H=20, T=1500, d=64) that is
// 11.5 GFLOP (11.6 us at 989 TFLOP/s bf16) against 15.4 MB (4.6 us at
// 3.35 TB/s): compute-bound. With d=64 the B*H*T^2 = 45 M exponentials per
// call load the SFU about as much as the products load the tensor cores, so
// the softmax runs in base 2 (exp2) with log2(e) folded into the score scale.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   * bf16: one block of 4 warps per (batch*head, 64-query tile); each warp
//     owns 16 query rows held as mma.sync A fragments in registers. K/V
//     stream through shared memory in 64-column tiles, double-buffered with
//     cp.async so the next tile loads while this one is computed; B
//     fragments come from ldmatrix (.trans for V, kept row-major). Scores
//     and the P*V product run on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 accumulate); the online softmax keeps running max and sum in
//     f32.
//     The score scale is applied in f32 after the product (the Pallas body
//     rounds q*scale^2*log2e in the input dtype instead).
//   * f32: one thread per query row on the CUDA cores (the tensor cores have
//     no full-f32 mode), 32-column K/V tiles in shared memory, same online
//     softmax. Serves f32 models and the parity runs.
//   * The query tail and the KV tail (T=1500 is not a multiple of 64) are
//     masked inside the kernel: no padded copies.
//   * q, k, v and o are addressed through (batch, head, time) strides with a
//     unit head_dim stride, so the [B, T, H*d] projections are read in place
//     and the output is written merged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block (bf16: 4 warps x 16)
constexpr int BK = 64;        // K/V columns per shared-memory tile (bf16)
constexpr int BQ_F32 = 64;    // query rows per block (f32: one per thread)
constexpr int BK_F32 = 32;    // K/V columns per tile (f32)
constexpr float NEG_BIG = -1e30f;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane i addresses row (i % 8) of matrix (i / 8)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <int HD>
constexpr int bf16_smem_bytes() {
  return 2 /*stages*/ * 2 /*K, V*/ * BK * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int Tq, int Tk, Strides st, float scale_log2) {
  constexpr int S = HD + 8;  // smem row stride (elements): 8 ldmatrix rows hit distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BK][S]
  __nv_bfloat16* Vs = Ks + 2 * BK * S;                              // [2][BK][S]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh;
  __nv_bfloat16* op = o + b * st.ob + h * st.oh;

  // K/V tile -> stage, 16-byte chunks; rows past Tk are zero-filled (zero V
  // rows: 0 * garbage could be NaN)
  auto load_tile = [&](int k0, int stage) {
    __nv_bfloat16* kd = Ks + stage * BK * S;
    __nv_bfloat16* vd = Vs + stage * BK * S;
    for (int idx = threadIdx.x; idx < BK * HD / 8; idx += blockDim.x) {
      const int row = idx / (HD / 8), col = (idx % (HD / 8)) * 8;
      const bool in = k0 + row < Tk;
      cp_async16(kd + row * S + col, in ? kp + (k0 + row) * st.kt + col : kp, in);
      cp_async16(vd + row * S + col, in ? vp + (k0 + row) * st.vt + col : vp, in);
    }
  };

  const int ntiles = (Tk + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();

  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;

  // Q as A fragments (row-major 16x16 per k-step), zero past the query tail
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < Tq ? ld32(qp + r0 * st.qt + c) : 0u;
    qf[kk][1] = r1 < Tq ? ld32(qp + r1 * st.qt + c) : 0u;
    qf[kk][2] = r0 < Tq ? ld32(qp + r0 * st.qt + c + 8) : 0u;
    qf[kk][3] = r1 < Tq ? ld32(qp + r1 * st.qt + c + 8) : 0u;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG;  // running max (base-2 units), rows r0/r1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sum

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    // the next tile streams in while this one is computed
    if (it + 1 < ntiles) {
      load_tile(k0 + BK, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = Ks + (it & 1) * BK * S;
    const __nv_bfloat16* vt = Vs + (it & 1) * BK * S;

    // S = Q K^T for this warp's 16 rows x 64 columns (8 n-tiles of 8); one
    // ldmatrix.x4 brings the B fragments of two k-steps
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (j * 8 + (lane & 7)) * S + kk * 32 + (lane >> 3) * 8);
        mma_16816(s[j], qf[2 * kk], bk[0], bk[1]);
        mma_16816(s[j], qf[2 * kk + 1], bk[2], bk[3]);
      }
    }
    const bool tail = k0 + BK > Tk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        if (tail && k0 + j * 8 + 2 * t + (e & 1) >= Tk) s[j][e] = NEG_BIG;
      }
    }

    // online softmax: row max over the quad that shares a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk; ldmatrix.trans of row-major V gives the B fragments of
    // two head_dim n-tiles at once
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mi = lane >> 3;
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + (kk * 16 + (lane & 7) + (mi & 1) * 8) * S + j * 16 + (mi >> 1) * 8);
        mma_16816(acc[2 * j], pa, bv[0], bv[1]);
        mma_16816(acc[2 * j + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration's load overwrites the other stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < Tq) *reinterpret_cast<uint32_t*>(op + r0 * st.ot + c) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < Tq) *reinterpret_cast<uint32_t*>(op + r1 * st.ot + c) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
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

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
                   int Tk, const Strides& st, float scale_log2, cudaStream_t stream) {
  if (dtype == 1) {
    constexpr int smem = bf16_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BQ - 1) / BQ, B * H);
    flash_fwd_bf16<HD><<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Tq, Tk, st, scale_log2);
  } else {
    dim3 grid((Tq + BQ_F32 - 1) / BQ_F32, B * H);
    flash_fwd_f32<HD><<<grid, BQ_F32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), H, Tq, Tk, st, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; head_dim is
// contiguous. Returns the cudaError_t of the launch (0 = success).
int sk_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Tq, int Tk, int hd, long long qsb, long long qsh, long long qst, long long ksb,
                       long long ksh, long long kst, long long vsb, long long vsh, long long vst,
                       long long osb, long long osh, long long ost, float scale_log2, void* stream) {
  const Strides st{qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return static_cast<int>(launch<64>(dtype, q, k, v, o, B, H, Tq, Tk, st, scale_log2, s));
    case 128:
      return static_cast<int>(launch<128>(dtype, q, k, v, o, B, H, Tq, Tk, st, scale_log2, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* sk_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
