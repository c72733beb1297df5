// The ring-slot prototype for Hopper (sm_90a): one step of
//   y[:, i*TW:(i+1)*TW] = 2 * ring[rslot, i] + x[:, i*TW:(i+1)*TW]   for every tile i
//   ring[wslot, i] = x[:, i*TW:(i+1)*TW]                            (in place)
// with rslot = (n + 1) mod M and wslot = n mod M read from the device.
//
// Replaces the TPU kernel `kernel` of tools/proto_ring_kernel.py (driven by
// `step`, the pl.pallas_call at proto_ring_kernel.py:57), K4 in ROADMAP.md.
// That kernel proves the mechanics the fused stack kernel builds on: slot
// indices computed in-jit from a traced n and prefetched as scalars, a DMA
// read of one ring slot, and an in-place DMA write of another slot of the
// aliased ring, leaving every other slot as it was. Here the same things
// are: n read by every thread from device memory (no host sync), plain
// loads and stores on the ring's own storage (no copy of the ring, no
// output ring), and only wslot's elements are stored.
//
// Design: a 2-D grid, blockIdx.y the tile i, blockIdx.x a stretch of
// 256 elements of the tile's (C, TW) chunk. Each thread owns one element:
// it reads ring[rslot, i, c, t] and x[c, i*TW + t], writes y, and only then
// writes x to ring[wslot, i, c, t]. The read must come before the write,
// even though rslot != wslot for M > 1: y is made from the ring as it was
// before this step, and with M = 1 the two slots are one and the same. No
// other thread touches that element, so no barrier is needed. 2 * a is
// exact, so y has one rounding whether or not nvcc contracts it into an
// FMA: the result equals the plain version to 0.0.
// What bounds it on an H100: bytes, 4 * C * NT * TW floats (read a slot and
// x, write y and a slot), 524,288 B at the tool's shapes, 0.16 us at
// 3.35 TB/s; a launch costs more than that, so launch latency sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    proto_ring_kernel(float* __restrict__ ring, const float* __restrict__ x, float* __restrict__ y,
                      const int32_t* __restrict__ n_ptr, int M, int NT, int C, int TW) {
  const int i = blockIdx.y;  // tile
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int chunk = C * TW;
  if (e >= chunk) return;
  const int n = *n_ptr;
  // Floor remainder: for n >= 0 (the tool's use) the same as lax.rem.
  const int rslot = ((n + 1) % M + M) % M;
  const int wslot = (n % M + M) % M;
  const int c = e / TW, t = e % TW;
  const long long xi = (long long)c * NT * TW + (long long)i * TW + t;
  const long long tile = (long long)i * chunk + e;
  const float a = ring[(long long)rslot * NT * chunk + tile];  // read before the write below
  const float xv = x[xi];
  y[xi] = 2.0f * a + xv;
  ring[(long long)wslot * NT * chunk + tile] = xv;
}

}  // namespace

extern "C" {

// Launch one step. ring (M, NT, C, TW), x and y (C, NT * TW) float32 and n a
// device int32 are device pointers; ring is updated in place; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success). Does
// not synchronise and allocates nothing.
int nam_proto_ring_step(void* ring, const void* x, void* y, const void* n, int M, int NT, int C, int TW,
                        void* stream) {
  if (M < 1 || NT < 1 || C < 1 || TW < 1 || NT > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((C * TW + THREADS - 1) / THREADS, NT);
  proto_ring_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(ring), static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const int32_t*>(n), M, NT, C, TW);
  return (int)cudaGetLastError();
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
