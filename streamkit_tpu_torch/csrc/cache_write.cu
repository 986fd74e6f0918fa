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
//   cache[g, s, f, (pos[s] + i) % T] = upd[g, s, f, i]   for i < lim[s],
// and leave every other column (and every lim = 0 row) untouched. The first
// is the second with G = 1, so one kernel serves both.
//
// Bound on an H100 SXM: bytes. The write moves 2 * G * F * sum_s(lim[s]) *
// itemsize bytes (each written column read once from upd, written once into
// the cache) and computes nothing. At the streaming table's int8 encoder
// caches (G = 32 layers, F = 20 heads x 64, lim = 16 columns per slot) that
// is 1.3 MB per slot, 0.4 us at 3.35 TB/s.
//
// Design (simple first): the TPU kernel reads and rewrites two whole
// 128-column blocks per row because Mosaic slices the lane dimension in
// multiples of 128; a GPU thread can address any column, so this kernel
// touches exactly the lim[s] written columns. One thread per (row, column
// i < c): consecutive threads read consecutive upd elements (coalesced) and
// write consecutive cache columns of one row; the ring wrap is a
// conditional subtract. The copy is of raw bits (1, 2, 4 or 8 bytes per
// element), so it is exact for every dtype. A grid-stride loop keeps the
// grid bounded for any G * S * F.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// I: the index type. 32-bit division is a few instructions, 64-bit a long
// software routine, so launches whose element count fits take I = unsigned.
template <typename E, typename I>
__global__ void windowed_write_kernel(E* __restrict__ cache, const E* __restrict__ upd,
                                      const int* __restrict__ pos, const int* __restrict__ lim,
                                      I rows, int S, int F, int T, int c) {
  const I total = rows * (I)c;
  const I step = (I)gridDim.x * blockDim.x;
  for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    const I row = idx / (I)c;  // (g, s, f) flattened
    const int i = (int)(idx - row * (I)c);
    const int s = (int)((row / (I)F) % (I)S);
    if (i >= lim[s]) continue;
    int col = pos[s] % T;
    if (col < 0) col += T;
    col += i;
    if (col >= T) col -= T;  // i < c <= T: one wrap at most
    cache[(long long)row * T + col] = upd[idx];
  }
}

template <typename E>
cudaError_t launch(void* cache, const void* upd, const int* pos, const int* lim, int G, int S, int F,
                   int T, int c, cudaStream_t stream) {
  const long long rows = (long long)G * S * F;
  const long long total = rows * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  if (total < (1LL << 31)) {
    windowed_write_kernel<E, unsigned><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<E*>(cache), static_cast<const E*>(upd), pos, lim, (unsigned)rows, S, F, T, c);
  } else {
    windowed_write_kernel<E, long long><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<E*>(cache), static_cast<const E*>(upd), pos, lim, rows, S, F, T, c);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cache [G, S, F, T] and upd [G, S, F, c] contiguous, elements of
// `elem_bytes` bytes; pos and lim [S] int32 on the device. Requires
// 0 < c <= T. Returns the cudaError_t of the launch (0 = success).
int sk_windowed_write(int elem_bytes, void* cache, const void* upd, const int* pos, const int* lim, int G,
                      int S, int F, int T, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(cache, upd, pos, lim, G, S, F, T, c, st);
    case 2: return launch<uint16_t>(cache, upd, pos, lim, G, S, F, T, c, st);
    case 4: return launch<uint32_t>(cache, upd, pos, lim, G, S, F, T, c, st);
    case 8: return launch<uint64_t>(cache, upd, pos, lim, G, S, F, T, c, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* sk_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
