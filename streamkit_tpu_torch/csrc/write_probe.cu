// SPDX-License-Identifier: Apache-2.0
//
// Measurement probe, not a kernel of any path: what the card charges for
// writing a few bytes into each row of a row-major byte array, the access
// pattern of the windowed cache write (csrc/cache_write.cu) into the
// time-minor streaming caches. Driven by streamkit_tpu_torch/tools/k2_probe.py.
//
// Row r gets `lanes` 16-byte accesses at bytes [off + 16 k, off + 16 k + 16),
// k < lanes, one lane each, side by side in a warp (so one instruction
// carries a row's accesses). mode 0: 16-byte stores of a constant; mode 1:
// read-modify-write (16-byte load, xor, 16-byte store); mode 2: each lane's
// 16 bytes as two 8-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void write_probe_kernel(char* base, long long rows, int pitch, int off, int lanes_log2, int mode) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t >> lanes_log2;
  if (row >= rows) return;
  char* p = base + row * pitch + off + 16 * (int)(t & ((1 << lanes_log2) - 1));
  if (mode == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(1u, 2u, 3u, (unsigned)row);
  } else if (mode == 1) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    v.x ^= 1u;
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(1u, (unsigned)row);
    *reinterpret_cast<uint2*>(p + 8) = make_uint2(3u, 4u);
  }
}

}  // namespace

extern "C" {

// base: rows * pitch bytes on the device, 16-byte aligned; off and pitch
// multiples of 16 with off + 16 * 2^lanes_log2 <= pitch.
int sk_write_probe(void* base, long long rows, int pitch, int off, int lanes_log2, int mode, void* stream) {
  const long long threads = rows << lanes_log2;
  if (rows <= 0 || (threads + 255) / 256 > 0x7fffffffLL) return cudaErrorInvalidValue;
  write_probe_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(base), rows, pitch, off, lanes_log2, mode);
  return cudaGetLastError();
}

}  // extern "C"
