// SPDX-License-Identifier: Apache-2.0
//
// K4: the decoder's cross-attention in the streaming decode continuation, over
// the int8 cross caches, written for Hopper (sm_90a). Built with nvcc into a
// shared library with a plain C entry point and loaded through ctypes
// (streamkit_tpu_torch/ops/decode_attention.py).
//
// Replaces no TPU kernel. The reference writes this attention as a plain
// expression (streamkit_tpu/models/whisper/streaming.py, _decode_core:
// _scores_rows, softmax, _attend_rows), and XLA fuses the int8 operands'
// dequantisation into the dots. Eager PyTorch writes every cast of that
// expression to device memory: int8 -> bf16 -> f32 copies of K and V and a
// bf16 multiply before two f32 batched gemvs, about 1.26 GB of traffic per
// layer and decode step at large-v3's [64, 20, 64, 512] to use 84 MB of int8.
//
// Per batch row b and head h, one query row:
//   n      = min(max(ep[b], 1), T)                 visible columns t < n
//   s[t]   = (sum_d float(qs[d]) * round(float(k8[d, t]) * op)) * ks[t]
//   p[t]   = round(softmax_{t < n}(s)[t] * vs[t])  (f32 softmax)
//   out[d] = sum_{t < n} p[t] * float(v8[d, t])    (f32)
// "round" is the model dtype's rounding (bf16, or none for f32) at the two
// places the plain version rounds; op is the operand scale already rounded to
// the model dtype. Columns at or above n enter no sum and are not read, but
// for the rest of the last vector (up to 15 columns) they share.
//
// Bound on an H100 SXM: bytes. A (b, h) pair does 4*hd*n operations on
// 2*hd*n int8 bytes and 8*n bytes of scales, about 1.9 operations a byte
// against the card's 295. At large-v3's [64, 20, 64, 512] with every column
// visible that is 89 MB, 26.6 us at 3.35 TB/s; at live horizons (n of about
// 100-210) 35 MB or less, 10 us or less.
//
// Design (CUDA cores: one query row would leave the tensor cores idle):
//   * One block of 8 warps per (b, h): 1280 blocks at large-v3, 1024 at
//     medium, a few waves over 132 SMs.
//   * K pass: k8 is [hd, T], time minor. Warp w owns hd/8 rows of K; lane l
//     owns the 16-byte column vectors l, l + 32, ... below n. A lane starts
//     the loads of all its rows at once, dequantises in registers and keeps 16
//     partial scores; the 8 warps' partials meet in shared memory (8*T f32).
//   * Scores, row max, row sum and probabilities stay in shared memory and
//     registers; nothing intermediate goes to device memory.
//   * V pass: the same ownership. Warp w reduces its hd/8 rows of V along the
//     contiguous time axis with 16-byte loads and a shuffle reduction.
//   * A block is a chain of dependent steps, and at live horizons its time is
//     latency more than bandwidth: more blocks in flight is what helps. Three
//     blocks an SM (80 registers a thread at hd = 64, no spills). The column
//     scales of a thread's first two columns load beside the K pass's loads,
//     so the chain waits on device memory three times (the horizon, K, V),
//     not five. At [64, 20, 64, 512], mean horizon 109 (H100 80GB HBM3 at
//     700 W): 26.6-26.8 us; loading the scales where they are used, 28.5 us;
//     also holding a lane's first V vectors in registers across the K pass,
//     127 registers, two blocks an SM, 29.5-31.3 us.
//   * int8 becomes f32 by a byte permute and an add, not the quarter-rate I2F.
//   * Where T or a base breaks 16-byte alignment, 4-byte or 1-byte vectors
//     (the template VEC).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PRE_COLS = 2;  // column scales a thread loads up front: T <= 512 needs no more

// byte k of w ^ 0x80808080 (an int8 x, flipped to x + 128) as a float,
// exactly: (2^23 + x + 128) - (2^23 + 128)
template <int K>
__device__ __forceinline__ float i8_to_f32(uint32_t flipped) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | K)) - 8388736.f;
}

// VEC int8 values of one row, as loaded
template <int VEC> struct Raw;
template <> struct Raw<16> { uint4 w; };
template <> struct Raw<4> { uint32_t w; };
template <> struct Raw<1> { int8_t w; };

template <int VEC>
__device__ __forceinline__ Raw<VEC> load_raw(const int8_t* p) {
  Raw<VEC> r;
  if constexpr (VEC == 16) {
    r.w = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (VEC == 4) {
    r.w = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.w = __ldg(reinterpret_cast<const signed char*>(p));
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void unpack(const Raw<VEC>& r, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = (float)r.w;
  } else {
    uint32_t w[VEC / 4];
    if constexpr (VEC == 16) {
      w[0] = r.w.x, w[1] = r.w.y, w[2] = r.w.z, w[3] = r.w.w;
    } else {
      w[0] = r.w;
    }
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;  // byte 0 is the lowest column
      f[4 * i + 0] = i8_to_f32<0>(x);
      f[4 * i + 1] = i8_to_f32<1>(x);
      f[4 * i + 2] = i8_to_f32<2>(x);
      f[4 * i + 3] = i8_to_f32<3>(x);
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the model dtype's rounding of an f32 value
template <typename QT>
__device__ __forceinline__ float round_q(float x) {
  if constexpr (std::is_same_v<QT, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC f32 of shared memory at p (16-byte aligned where VEC >= 4)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = x.x, f[4 * i + 1] = x.y, f[4 * i + 2] = x.z, f[4 * i + 3] = x.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  }
}

template <typename QT, int HD, int VEC>
__global__ void __launch_bounds__(THREADS, 3) decode_cross_attention_kernel(
    const QT* __restrict__ qs, const int8_t* __restrict__ k8, const float* __restrict__ ks,
    const int8_t* __restrict__ v8, const float* __restrict__ vs, const int* __restrict__ ep,
    float* __restrict__ out, int H, int T, float op) {
  constexpr int RW = HD / WARPS;  // rows of K and of V per warp
  extern __shared__ __align__(16) float part[];  // [WARPS][T] partial scores; row 0: scores, then p
  __shared__ float red_max[WARPS], red_sum[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = blockIdx.x;
  const int n = min(max(ep[bh / H], 1), T);
  const int nv = (n + VEC - 1) / VEC;
  const int d0 = warp * RW;
  const int8_t* kb = k8 + (bh * HD + d0) * T;
  const int8_t* vb = v8 + (bh * HD + d0) * T;
  const float* ksb = ks + bh * T;
  const float* vsb = vs + bh * T;

  // this thread's first column scales, loaded beside the K pass's loads
  float ksr[PRE_COLS], vsr[PRE_COLS];
#pragma unroll
  for (int i = 0; i < PRE_COLS; ++i) {
    const int t = tid + i * THREADS;
    ksr[i] = t < n ? ksb[t] : 0.f;
    vsr[i] = t < n ? vsb[t] : 0.f;
  }

  // K pass: this warp's rows, this lane's column vectors
  float q[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) q[r] = to_f32(qs[bh * HD + d0 + r]);
  for (int cv = lane; cv < nv; cv += 32) {
    Raw<VEC> kr[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) kr[r] = load_raw<VEC>(kb + (long long)r * T + cv * VEC);
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float f[VEC];
      unpack<VEC>(kr[r], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(q[r], round_q<QT>(f[j] * op), acc[j]);
    }
    store_f32<VEC>(part + warp * T + cv * VEC, acc);
  }
  __syncthreads();

  // scores (each thread owns its columns of row 0), then the row max
  float mx = -INFINITY;
  auto score = [&](int t, float scale) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w * T + t];
    s *= scale;
    part[t] = s;
    mx = fmaxf(mx, s);
  };
#pragma unroll
  for (int i = 0; i < PRE_COLS; ++i)
    if (tid + i * THREADS < n) score(tid + i * THREADS, ksr[i]);
  for (int t = tid + PRE_COLS * THREADS; t < n; t += THREADS) score(t, ksb[t]);
  mx = warp_max(mx);
  if (lane == 0) red_max[warp] = mx;
  __syncthreads();
  mx = red_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red_max[w]);

  float sum = 0.f;
  for (int t = tid; t < n; t += THREADS) {
    const float e = expf(part[t] - mx);
    part[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();
  sum = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) sum += red_sum[w];

  // p = round(prob * vs); 0 past n, to the end of the last vector
#pragma unroll
  for (int i = 0; i < PRE_COLS; ++i) {
    const int t = tid + i * THREADS;
    if (t < nv * VEC) part[t] = t < n ? round_q<QT>(part[t] / sum * vsr[i]) : 0.f;
  }
  for (int t = tid + PRE_COLS * THREADS; t < nv * VEC; t += THREADS)
    part[t] = t < n ? round_q<QT>(part[t] / sum * vsb[t]) : 0.f;
  __syncthreads();

  // V pass: this warp's rows along time
  float acc[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    Raw<VEC> vr[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) vr[r] = load_raw<VEC>(vb + (long long)r * T + cv * VEC);
    float p[VEC];
    load_f32<VEC>(part + cv * VEC, p);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float f[VEC];
      unpack<VEC>(vr[r], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r] = fmaf(p[j], f[j], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == r) out[bh * HD + d0 + r] = v;
  }
}

struct Args {
  const void *qs, *k8;
  const float* ks;
  const void* v8;
  const float* vs;
  const int* ep;
  float* out;
  int B, H, T;
  float op;
};

template <typename QT, int HD, int VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * a.T * sizeof(float);
  auto kernel = decode_cross_attention_kernel<QT, HD, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)(a.B * a.H), THREADS, smem, stream>>>(
      static_cast<const QT*>(a.qs), static_cast<const int8_t*>(a.k8), a.ks, static_cast<const int8_t*>(a.v8),
      a.vs, a.ep, a.out, a.H, a.T, a.op);
  return cudaGetLastError();
}

template <typename QT, int HD>
cudaError_t dispatch_vec(const Args& a, cudaStream_t stream) {
  // the widest vector that the row stride T and both bases allow
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.k8) | reinterpret_cast<uintptr_t>(a.v8);
  if (a.T % 16 == 0 && base % 16 == 0) return launch<QT, HD, 16>(a, stream);
  if (a.T % 4 == 0 && base % 4 == 0) return launch<QT, HD, 4>(a, stream);
  return launch<QT, HD, 1>(a, stream);
}

template <typename QT>
cudaError_t dispatch(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_vec<QT, 32>(a, stream);
    case 64: return dispatch_vec<QT, 64>(a, stream);
    case 128: return dispatch_vec<QT, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of qs: 0 = float32, 1 = bfloat16. All tensors contiguous: qs
// [B,H,1,hd]; k8/v8 [B,H,hd,T] int8; ks/vs [B,H,T] f32; ep [B] int32; out
// [B,H,1,hd] f32. Requires hd in {32, 64, 128} and 8*T f32 of shared memory;
// `op` is the operand scale already rounded to qs's dtype. Returns the
// cudaError_t of the launch.
int sk_decode_cross_attention(int dtype, const void* qs, const void* k8, const float* ks, const void* v8,
                              const float* vs, const int* ep, float* out, int B, int H, int hd, int T, float op,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  const Args a{qs, k8, ks, v8, vs, ep, out, B, H, T, op};
  if (dtype == 0) return dispatch<float>(hd, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, a, st);
  return cudaErrorInvalidValue;
}

const char* sk_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
