// Fused ConvNet block step for Hopper (sm_90a): one launch runs every conv
// block and the head of one T-frame block, for every stream.
//
// Replaces the TPU kernel `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/convnet.py (driven by `step`, the
// pl.pallas_call at convnet.py:458). What it computes, per block layer
// (reference: ConvNet::process, NAM/convnet.cpp:206-278):
//   z  = sum_k W_k . h(t - (K-1-k) d)          (K = 2, dilation d)
//   z  = z * mul + add                          (folded BatchNorm scale/loc,
//                                                or mul = 1, add = conv bias)
//   h' = act(z)
//   ring[n mod M] <- h                          (the layer's input)
// and at the end y = head_W . h + head_b.
//
// State: one ring of M = rf // T + 2 whole blocks per layer, (M, cin, T, B),
// streams innermost, as in stack.cu. A tap at lookback a reads frame
// s = t - a; s < 0 lies m = ceil(-s / T) blocks back, in slot (n - m) mod M
// at frame s + m T. So a dilation that is not a multiple of T needs no
// splice, where the TPU kernel refused it.
//
// What bounds it on an H100: the amp ConvNet (16 channels, dilations
// 1..512, batchnorm, Tanh) needs 4,656 MACs per sample and, at T = 64, about
// 41 KB of state and I/O per stream and block (each tap's past frames read
// once, each layer's new history written once), so bytes and operations
// come out about even, bytes slightly ahead (about 25 us against 18 us at
// B = 2,048). The kernel writes whole T-frame chunks for every layer (no
// tails for shallow layers), about 1.4x those bytes.
//
// Design (first version: right and simple; the design of stack.cu):
//   - one CTA per tile of BS streams, one thread per (frame, stream), the
//     layer loop inside the CTA, __syncthreads() between layers;
//   - the layer input of the tile lives in shared memory, double-buffered,
//     so the taps of neighbouring frames read it there; a thread keeps its
//     own frame's input and activations in registers;
//   - each layer's weights are staged into shared memory one layer ahead and
//     read as float4 broadcasts;
//   - the affine uses __fmul_rn / __fadd_rn, so it rounds as the plain torch
//     version does; float32 FMA only, tanhf, no fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "convnet.cuh"  // plan layout; activations.cuh: Act codes, apply_act, stage

namespace {

template <int CP>
__global__ void __launch_bounds__(512) convnet_step_kernel(const float* __restrict__ x, float* __restrict__ y,
                                                           float* __restrict__ state, const float* __restrict__ w,
                                                           const long long* __restrict__ plan, int T, int B, int n,
                                                           int BS) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int seg_max = (int)plan[P_SEG_MAX];
  float* wsm0 = smem;
  float* wsm1 = smem + seg_max;
  float* cur = smem + 2 * seg_max;  // [2][CP][T][BS]

  const int bl = threadIdx.x % BS;
  const int t = threadIdx.x / BS;
  const int b = blockIdx.x * BS + bl;
  const bool valid = b < B;
  const int TB = T * BS;

  const int L = (int)plan[P_N_LAYERS];
  const int Cin = (int)plan[P_CIN];
  const int C = (int)plan[P_C];
  const int act = (int)plan[P_ACT];
  const float* prm = w + plan[P_ACT_PRM];
  const long long* layers = plan + P_HEADER;

  // This thread's frame of the layer input, in registers; layer 0 reads x.
  float xr[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) xr[c] = (c < Cin && valid) ? x[((long long)c * T + t) * B + b] : 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c)
    if (c < Cin) cur[(c * T + t) * BS + bl] = xr[c];
  if (L > 0) stage(wsm0, w + layers[L_SEG], (int)layers[L_SEG_LEN]);
  __syncthreads();

  for (int li = 0; li < L; ++li) {
    const long long* lp = layers + (long long)li * LF;
    const int K = (int)lp[L_K];
    const int d = (int)lp[L_D];
    const int M = (int)lp[L_M];
    const long long ring = lp[L_RING];
    const int cin = (int)lp[L_CIN];
    const int p = li & 1;
    float* ws = p ? wsm1 : wsm0;

    // Stage the next layer's weights one layer ahead; its buffer was last
    // read by layer li - 1, which every thread finished before the last sync.
    if (li + 1 < L) {
      const long long* nx = lp + LF;
      stage(p ? wsm0 : wsm1, w + nx[L_SEG], (int)nx[L_SEG_LEN]);
    }

    // Segment layout (see _build_layout): conv (K*cin, CP), mul (CP), add (CP).
    const float* w_conv = ws;
    const float* w_mul = w_conv + K * cin * CP;
    const float* w_add = w_mul + CP;

    float z[CP];
#pragma unroll
    for (int o = 0; o < CP; ++o) z[o] = 0.f;

    const float* cur_p = cur + p * CP * TB;
    const int nM = M > 0 ? n % M : 0;
    for (int k = 0; k < K; ++k) {
      const int s = t - (K - 1 - k) * d;
      const float* src;
      long long stride;
      bool live = true;
      if (s >= 0) {
        src = cur_p + s * BS + bl;
        stride = TB;
      } else {
        const int m = (T - 1 - s) / T;  // blocks back: ceil(-s / T), <= M - 1
        const int pos = s + m * T;
        const int slot = (nM - m + M) % M;
        src = state + ring + ((long long)slot * cin * T + pos) * B + b;
        stride = (long long)T * B;
        live = valid;
      }
      const float4* wk = reinterpret_cast<const float4*>(w_conv + k * cin * CP);
      for (int c = 0; c < cin; ++c) {
        const float v = live ? src[c * stride] : 0.f;
#pragma unroll
        for (int o4 = 0; o4 < CP / 4; ++o4) {
          const float4 wv = wk[c * (CP / 4) + o4];
          z[4 * o4 + 0] += wv.x * v;
          z[4 * o4 + 1] += wv.y * v;
          z[4 * o4 + 2] += wv.z * v;
          z[4 * o4 + 3] += wv.w * v;
        }
      }
    }
#pragma unroll
    for (int o = 0; o < CP; ++o) z[o] = __fadd_rn(__fmul_rn(z[o], w_mul[o]), w_add[o]);
    apply_act<CP>(z, act, prm);

    // The layer's input becomes history: ring slot n mod M.
    if (M > 0 && valid) {
      float* dst = state + ring + ((long long)nM * cin * T + t) * B + b;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < cin) dst[(long long)c * T * B] = xr[c];
    }

    // The activations are the next layer's input: publish them; the sync
    // also retires this layer's reads of cur[p] and of its weight buffer.
    float* cur_n = cur + (p ^ 1) * CP * TB;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      xr[c] = c < C ? z[c] : 0.f;
      if (c < C) cur_n[(c * T + t) * BS + bl] = xr[c];
    }
    __syncthreads();
  }

  // Linear head: y = head_W . h + head_b, head_W (Cout, C).
  if (valid) {
    const int Cout = (int)plan[P_COUT];
    const float* hw = w + plan[P_HEAD_W];
    const float* hb = w + plan[P_HEAD_B];
    for (int o = 0; o < Cout; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < C) acc += __ldg(hw + o * C + c) * xr[c];
      y[((long long)o * T + t) * B + b] = acc + __ldg(hb + o);
    }
  }
}

template <int CP>
cudaError_t launch(const float* x, float* y, float* state, const float* w, const long long* plan, int T, int B,
                   int n, int BS, int smem_bytes, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(convnet_step_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = (B + BS - 1) / BS;
  convnet_step_kernel<CP><<<grid, T * BS, smem_bytes, stream>>>(x, y, state, w, plan, T, B, n, BS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers; the state's rings
// are updated in place; `stream` is a cudaStream_t. Returns the cudaError_t
// of the launch (0 on success). Does not synchronise and allocates nothing.
int nam_convnet_step(const void* x, void* y, void* state, const void* w, const void* plan, int T, int B, int n,
                     int BS, int c_max, int smem_bytes, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  const float* wf = static_cast<const float*>(w);
  const long long* pl = static_cast<const long long*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_max) {
    case 4:
      return (int)launch<4>(xf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    case 8:
      return (int)launch<8>(xf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    case 16:
      return (int)launch<16>(xf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    case 32:
      return (int)launch<32>(xf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
