// Activation device code shared by the port's kernels (stack.cu,
// stack_wf.cu, stack_wide.cu, convnet.cu, convnet_wide.cu, lstm.cu,
// lstm_wide.cu). float32 throughout: tanhf and expf, no
// fast-math intrinsics.
//
// The codes and parameters are those ops/activations.py `kernel_code` gives
// (KERNEL_CODES, LUT_CODES; code 11 is the per-channel PReLU of `activate`); the
// formulas match ops/activations.py (reference: NAM/activations.h). The
// global fast-tanh and LUT modes are resolved on the host: fast-tanh turns
// Tanh into ACT_FASTTANH, a LUT turns Tanh, Sigmoid or SiLU into its
// ACT_LUT_* code.

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
  ACT_PRELU_CHANNELS = 11,  // a slope per channel (ops/cuda/stack.py ACT_PRELU_CHANNELS)
  ACT_LUT_TANH = 12,
  ACT_LUT_SIGMOID = 13,
  ACT_LUT_SILU = 14,
};

__device__ __forceinline__ float fast_tanh(float x) {
  // Rational approximation (reference: NAM/activations.h:91-98). Every
  // product and sum is rounded on its own, in the order of ops/activations.py
  // `fast_tanh` (no contraction into FMAs), so the kernels give the plain
  // versions' values: the flagship's state, near 20 in magnitude, otherwise
  // drifts 2.7e-5 from them in 6 blocks (tests/test_torch_cuda.py).
  const float ax = fabsf(x);
  const float x2 = __fmul_rn(x, x);
  const float lo = __fadd_rn(2.45550750702956f, __fmul_rn(2.45550750702956f, ax));
  const float hi = __fmul_rn(__fadd_rn(0.893229853513558f, __fmul_rn(0.821226666969744f, ax)), x2);
  const float num = __fmul_rn(x, __fadd_rn(lo, hi));
  const float inner = fabsf(__fadd_rn(x, __fmul_rn(__fmul_rn(0.814642734961073f, x), ax)));
  const float den = __fadd_rn(2.44506634652299f, __fmul_rn(__fadd_rn(2.44506634652299f, x2), inner));
  return num / den;
}

// (reference: NAM/activations.h:100-103)
__device__ __forceinline__ float fast_sigmoid(float x) { return 0.5f * (fast_tanh(x * 0.5f) + 1.0f); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The base function of a LUT.
template <int CODE>
__device__ __forceinline__ float lut_base(float x) {
  if (CODE == ACT_LUT_TANH) return tanhf(x);
  if (CODE == ACT_LUT_SIGMOID) return sigmoid(x);
  return x * sigmoid(x);
}

// A LUT activation as ops/activations.py `_lut_apply` computes it
// (reference: FastLUTActivation::apply, NAM/activations.h:393-410): the table
// entries are the base function at the two bracketing grid points, recomputed
// here. prm = {min_x, max_x, 1/step, step, n - 1}, the float32 constants the
// torch version uses; every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no contraction into an FMA), so the bracket index
// and the interpolation round as they do in torch. Inlined: unrolled over
// every register tile it takes stack.cu's build to about 200 s, but an
// out-of-line call made the flagship's exact-tanh path 4% slower (the call's
// register convention; kernel_ab, PERF.md).
template <int CODE>
__device__ __forceinline__ float lut(float x, const float* prm) {
  const float min_x = prm[0], max_x = prm[1], inv_step = prm[2], step = prm[3], n1 = prm[4];
  const float xc = fminf(fmaxf(x, min_x), max_x);
  const float f_idx = __fmul_rn(__fsub_rn(xc, min_x), inv_step);
  if (f_idx >= n1) return lut_base<CODE>(max_x);  // edge case at max (NAM/activations.h:403-405)
  const int i = min(max((int)f_idx, 0), (int)n1 - 1);
  const float fi = (float)i;
  const float g0 = __fadd_rn(min_x, __fmul_rn(fi, step));
  const float y0 = lut_base<CODE>(g0);
  const float y1 = lut_base<CODE>(__fadd_rn(g0, step));
  return __fadd_rn(y0, __fmul_rn(__fsub_rn(y1, y0), __fsub_rn(f_idx, fi)));
}

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
    case ACT_LUT_TANH:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = lut<ACT_LUT_TANH>(z[o], prm);
      break;
    case ACT_LUT_SIGMOID:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = lut<ACT_LUT_SIGMOID>(z[o], prm);
      break;
    case ACT_LUT_SILU:
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = lut<ACT_LUT_SILU>(z[o], prm);
      break;
    default:  // ACT_IDENTITY
      break;
  }
}

// An activation of apply_act, or PReLU with a slope per channel: prm[o] is
// row o's (ACT_PRELU_CHANNELS, stack.cu and the wide kernels).
template <int N>
__device__ __forceinline__ void activate(float* z, int code, const float* prm) {
  if (code == ACT_PRELU_CHANNELS) {
#pragma unroll
    for (int o = 0; o < N; ++o) z[o] = z[o] > 0.f ? z[o] : prm[o] * z[o];
  } else {
    apply_act<N>(z, code, prm);
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
