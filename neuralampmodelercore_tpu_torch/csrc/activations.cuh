// Activation device code shared by the port's kernels (stack.cu, convnet.cu,
// lstm.cu). float32 throughout: tanhf and expf, no fast-math intrinsics.
//
// The codes match ACT_CODES in ops/cuda/stack.py and ops/cuda/convnet.py;
// the formulas match ops/activations.py (reference: NAM/activations.h).

#pragma once

#include <cuda_runtime.h>

namespace {

enum Act {
  ACT_IDENTITY = 0,
  ACT_TANH = 1,
  ACT_RELU = 2,
  ACT_SIGMOID = 3,
  ACT_HARDTANH = 4,
  ACT_LEAKY_RELU = 5,
  ACT_SILU = 6,
  ACT_SOFTSIGN = 7,
  ACT_HARDSWISH = 8,
  ACT_FASTTANH = 9,
  ACT_LEAKY_HARDTANH = 10,
};

__device__ __forceinline__ float fast_tanh(float x) {
  // Rational approximation (reference: NAM/activations.h:91-98).
  const float ax = fabsf(x);
  const float x2 = x * x;
  const float num =
      x * (2.45550750702956f + 2.45550750702956f * ax + (0.893229853513558f + 0.821226666969744f * ax) * x2);
  const float den = 2.44506634652299f + (2.44506634652299f + x2) * fabsf(x + 0.814642734961073f * x * ax);
  return num / den;
}

// (reference: NAM/activations.h:100-103)
__device__ __forceinline__ float fast_sigmoid(float x) { return 0.5f * (fast_tanh(x * 0.5f) + 1.0f); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int CP>
__device__ __forceinline__ void apply_act(float* z, int code, const float* prm) {
  switch (code) {
    case ACT_TANH:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = tanhf(z[o]);
      break;
    case ACT_RELU:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = z[o] > 0.f ? z[o] : 0.f;
      break;
    case ACT_SIGMOID:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = 1.f / (1.f + expf(-z[o]));
      break;
    case ACT_HARDTANH:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = fminf(fmaxf(z[o], -1.f), 1.f);
      break;
    case ACT_LEAKY_RELU: {
      const float ns = prm[0];
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = z[o] > 0.f ? z[o] : ns * z[o];
      break;
    }
    case ACT_SILU:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = z[o] * (1.f / (1.f + expf(-z[o])));
      break;
    case ACT_SOFTSIGN:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = z[o] / (1.f + fabsf(z[o]));
      break;
    case ACT_HARDSWISH:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = z[o] * fminf(fmaxf(z[o] + 3.f, 0.f), 6.f) * (1.f / 6.f);
      break;
    case ACT_FASTTANH:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = fast_tanh(z[o]);
      break;
    case ACT_LEAKY_HARDTANH: {
      const float lo = prm[0], hi = prm[1], slo = prm[2], shi = prm[3];
#pragma unroll
      for (int o = 0; o < CP; ++o) {
        const float v = z[o];
        z[o] = v < lo ? (v - lo) * slo + lo : (v > hi ? (v - hi) * shi + hi : v);
      }
      break;
    }
    default:  // ACT_IDENTITY
      break;
  }
}

// Cooperative copy of a weight segment (a multiple of 4 floats, 16-byte
// aligned on both sides) into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = __ldg(s4 + i);
}

}  // namespace
