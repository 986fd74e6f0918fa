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
// Bound on an H100 SXM: bytes. Per call the int8 history is 2*B*H*hd*T
// bytes (plus 8*B*H*T of f32 scales) against 4*B*H*c*hd*(T+c) operations;
// at the large-v3 streaming shape (H=20, c=16, hd=64, T=512) that is
// 1.4 MB and 42 MFLOP per row: 0.42 us of bytes, 0.04 us of bf16 tensor-core
// time. The operations run on the CUDA cores in f32 here (67 TFLOP/s, so
// 0.6 us per row), which a later tensor-core version can remove.
//
// Design (simple first): one block of 256 threads per (row*head, chunk of 8
// query rows). The 8 query rows sit in shared memory as f32; each thread
// scores whole history columns (8 rows at once), reading the int8 K column
// straight from global memory (consecutive threads, consecutive columns:
// coalesced). All T + c scores of the 8 rows stay in shared memory, so the
// softmax is exact two-pass: one warp per row takes the max and the sum,
// then writes round(p * scale) in place. The attend streams 64-column int8
// V tiles through shared memory (rows padded by 4 bytes: no bank conflicts)
// and gives each thread hd/32 outputs. Masked history columns are never
// read, so a pos = 0 row cannot see stale cache contents.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;       // query rows per block (one chunk)
constexpr int THREADS = 256;
constexpr int VT = 64;        // V columns per shared-memory tile
constexpr int VPAD = VT + 4;  // padded tile row (bytes)

template <typename Q>
__device__ __forceinline__ float round_q(float x);
template <>
__device__ __forceinline__ float round_q<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_q<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename Q, int HD>
__global__ void __launch_bounds__(THREADS)
    history_attention_kernel(const Q* __restrict__ qs, const int8_t* __restrict__ k8,
                             const float* __restrict__ ks, const int8_t* __restrict__ v8,
                             const float* __restrict__ vs, const int8_t* __restrict__ ck8,
                             const float* __restrict__ cks, const int8_t* __restrict__ cv8,
                             const float* __restrict__ cvs, const int* __restrict__ pos,
                             float* __restrict__ out, int H, int c, int T, float op) {
  extern __shared__ float smem[];
  const int W = T + c;
  float* sq = smem;                     // [ROWS][HD]
  float* sp = sq + ROWS * HD;           // [ROWS][W] scores, then rounded p*scale
  int8_t* sv = reinterpret_cast<int8_t*>(sp + ROWS * W);  // [HD][VPAD]

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int b = (int)(bh / H);
  const int j0 = blockIdx.y * ROWS;
  int hist = pos[b];
  hist = hist < 0 ? 0 : (hist > T ? T : hist);

  const Q* qb = qs + (bh * c + j0) * HD;
  for (int i = tid; i < ROWS * HD; i += THREADS) sq[i] = to_f32(qb[i]);
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
        const float kd = round_q<Q>((float)kb[(long long)d * T + t] * op);
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
      for (int d = 0; d < HD; ++d) acc = fmaf(sq[r * HD + d], round_q<Q>((float)ckb[d * c + j2] * op), acc);
      v = acc * cksb[j2];
    }
    sp[r * W + T + j2] = v;
  }
  __syncthreads();

  // softmax over T + c per row (one warp per row), then round(p * scale)
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
    for (int t = lane; t < hist; t += 32) row[t] = round_q<Q>(expf(row[t] - m) / l * vsb[t]);
    const float* cvsb = cvs + bh * c;
    for (int j2 = lane; j2 < c; j2 += 32) row[T + j2] = round_q<Q>(expf(row[T + j2] - m) / l * cvsb[j2]);
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

template <typename Q, int HD>
cudaError_t launch(const void* qs, const void* k8, const float* ks, const void* v8, const float* vs,
                   const void* ck8, const float* cks, const void* cv8, const float* cvs, const int* pos,
                   float* out, int B, int H, int c, int T, float op, cudaStream_t stream) {
  const size_t smem = (size_t)(ROWS * HD + ROWS * (T + c)) * sizeof(float) + (size_t)HD * VPAD;
  auto kernel = history_attention_kernel<Q, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)(B * H), (unsigned)(c / ROWS));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const Q*>(qs), static_cast<const int8_t*>(k8), ks, static_cast<const int8_t*>(v8), vs,
      static_cast<const int8_t*>(ck8), cks, static_cast<const int8_t*>(cv8), cvs, pos, out, H, c, T, op);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t dispatch_hd(int hd, const void* qs, const void* k8, const float* ks, const void* v8,
                        const float* vs, const void* ck8, const float* cks, const void* cv8, const float* cvs,
                        const int* pos, float* out, int B, int H, int c, int T, float op, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<Q, 32>(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, out, B, H, c, T, op, st);
    case 64: return launch<Q, 64>(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, out, B, H, c, T, op, st);
    case 128: return launch<Q, 128>(qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, out, B, H, c, T, op, st);
    default: return cudaErrorInvalidValue;
  }
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
  if (c % ROWS != 0 || c <= 0 || T < 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(hd, qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, out, B, H, c, T, op, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, qs, k8, ks, v8, vs, ck8, cks, cv8, cvs, pos, out, B, H, c, T, op,
                                      st);
  return cudaErrorInvalidValue;
}

const char* sk_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
