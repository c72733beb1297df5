// Fused WaveNet stack step for Hopper (sm_90a): one launch runs every layer
// array and every layer of one block, for every stream.
//
// Replaces the TPU kernel `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/stack.py (driven by `step`, the
// pl.pallas_call at stack.py:1769), on its plain path: no gating, no FiLM, no
// head1x1, a 1x1 head rechannel, no post-stack head, no condition DSP.
//
// What it computes, per layer array (reference graph: Layer::Process,
// NAM/wavenet/model.cpp:166-376):
//   h    = rechannel(layer_out)                    (1x1, no bias)
//   per layer:
//     z  = b + W . [h(t - (K-1-k) d)]_k + mixin . cond   (tap-stacked conv)
//     a  = act(z)
//     ring[n mod M] <- h                             (the layer's input)
//     h  = h + (L1 . a + b1)                         (if layer1x1 is active)
//     head_acc += a
//   head_out = Whr . head_acc (+ bhr)               (1x1 head rechannel)
// The next array's head accumulator starts from head_out
// (models/wavenet.py engine_step); y = head_scale * head_out of the last array.
//
// State: one ring of M = rf // T + 2 whole blocks per layer with rf > 0, in
// the (M, C, T, B) layout of ops/ring.py: streams innermost. A tap at
// lookback a reads frame s = t - a; s < 0 lies m = ceil(-s / T) blocks back,
// in slot (n - m) mod M at frame s + m T, so a window that straddles two past
// blocks (lookback not a multiple of T) needs no splice.
//
// Design (first version: right and simple):
//   - one CTA per tile of BS streams, one thread per (frame, stream), the
//     layer loop inside the CTA, __syncthreads() between layers;
//   - the layer input of the tile lives in shared memory, double-buffered, so
//     neighbouring frames' taps read it there; a thread keeps its own
//     residual, head accumulator and activations in registers;
//   - each layer's weights (a few KB) are staged into shared memory one layer
//     ahead and read as float4 broadcasts;
//   - float32 FMA only. Tensor cores would mean TF32, the analog of the
//     single-pass dot the JAX package rejected at 4.5e-2 error
//     (stack.py:442-457). tanh is tanhf: no fast-math.
//
// What bounds it on an H100: the flagship (16 then 8 channels, dilations
// 1..512, T = 64) needs about 13.3k MACs and about 98 KB of state traffic per
// stream and block, so at 3.35 TB/s and 67 TFLOP/s the bytes bound it
// (~120 us vs ~104 us at B = 4096). This kernel writes whole T-frame chunks
// for every layer (no tails for shallow layers yet), about 1.3x those bytes,
// and issues one shared-memory load for every four FMAs; it keeps every
// intermediate of the stack out of device memory, which is what the TPU
// kernel was built for. Tails, wider per-thread tiles and register-blocked
// weights are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"  // Act codes, fast_tanh, apply_act, stage

namespace {

// Plan layout (int64), written by ops/cuda/stack.py `_pack_plan`.
constexpr int P_N_ARRAYS = 0;
constexpr int P_CIN = 1;
constexpr int P_COUT = 2;
constexpr int P_HEAD_SCALE = 3;
constexpr int P_SEG_MAX = 4;
constexpr int P_N_LAYERS = 5;
constexpr int P_C_MAX = 6;
constexpr int P_HEADER = 8;
constexpr int AF = 10;  // fields per array
constexpr int A_C = 0, A_CP = 1, A_I = 2, A_HS = 3, A_RECH = 4, A_HR = 5, A_HR_B = 6,
              A_FIRST = 7, A_NL = 8;
constexpr int LF = 10;  // fields per layer
constexpr int L_K = 0, L_D = 1, L_M = 2, L_RING = 3, L_SEG = 4, L_SEG_LEN = 5, L_ACT = 6,
              L_L1 = 7;

constexpr int SMAX = 4;  // largest condition / input channel count

struct Tile {
  int t, bl, b, BS, T, B, n;
  bool valid;
};

// One layer array, its channel count padded to CP (a multiple of 4). `xr`
// holds this thread's layer input on entry to each layer (the rechannel
// output on entry to the array) and the array's output on exit; `hacc` the
// head accumulator.
template <int CP, int CM>
__device__ __forceinline__ void run_array(const long long* plan, const long long* ap, const float* __restrict__ w,
                                          float* __restrict__ state, float* wsm0, float* wsm1, float* cur,
                                          const float* cond, int S, float* xr, float* hacc, const Tile& tl,
                                          int n_layers_total) {
  const int C = (int)ap[A_C];
  const int I = (int)ap[A_I];
  const int HS = (int)ap[A_HS];
  const int first = (int)ap[A_FIRST];
  const int NL = (int)ap[A_NL];
  const int TB = tl.T * tl.BS;
  const long long* layers = plan + P_HEADER + plan[P_N_ARRAYS] * AF;

  // Rechannel (1x1, no bias) into the layer-0 input, then publish it.
  {
    const float* wr = w + ap[A_RECH];  // (C, I) row-major
    float h[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      float acc = 0.f;
      if (c < C) {
#pragma unroll
        for (int i = 0; i < CM; ++i)
          if (i < I) acc += __ldg(wr + c * I + i) * xr[i];
      }
      h[c] = acc;
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) xr[c] = c < CP ? h[c] : 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      if (c < C) cur[(c * tl.T + tl.t) * tl.BS + tl.bl] = xr[c];
  }
  __syncthreads();

  for (int li = 0; li < NL; ++li) {
    const int g = first + li;
    const long long* lp = layers + (long long)g * LF;
    const int K = (int)lp[L_K];
    const int d = (int)lp[L_D];
    const int M = (int)lp[L_M];
    const long long ring = lp[L_RING];
    const int act = (int)lp[L_ACT];
    const bool l1 = lp[L_L1] != 0;
    const int p = li & 1;
    float* ws = (g & 1) ? wsm1 : wsm0;

    // Stage the next layer's weights one layer ahead; its buffer was last
    // read by layer g - 1, which every thread finished before the last sync.
    if (g + 1 < n_layers_total) {
      const long long* nx = lp + LF;
      stage((g & 1) ? wsm0 : wsm1, w + nx[L_SEG], (int)nx[L_SEG_LEN]);
    }

    // Segment layout (see _pack_plan): conv (K*C, CP), conv bias (CP),
    // mixin (S, CP), [layer1x1 (CP, CP), layer1x1 bias (CP)], act params (4).
    const float* w_conv = ws;
    const float* w_b = w_conv + K * C * CP;
    const float* w_mix = w_b + CP;
    const float* w_l1 = w_mix + S * CP;
    const float* w_l1b = w_l1 + CP * CP;
    const float* w_prm = l1 ? w_l1b + CP : w_l1;

    float z[CP];
#pragma unroll
    for (int o = 0; o < CP; ++o) z[o] = 0.f;

    // Tap-stacked dilated conv. Tap k reads lookback (K-1-k)*d.
    const float* cur_p = cur + p * C * TB;
    const int nM = M > 0 ? tl.n % M : 0;
    for (int k = 0; k < K; ++k) {
      const int s = tl.t - (K - 1 - k) * d;
      const float* src;
      long long stride;
      bool live = true;
      if (s >= 0) {
        src = cur_p + s * tl.BS + tl.bl;
        stride = TB;
      } else {
        const int m = (tl.T - 1 - s) / tl.T;  // blocks back: ceil(-s / T), <= M - 1
        const int pos = s + m * tl.T;
        const int slot = (nM - m + M) % M;
        src = state + ring + ((long long)slot * C * tl.T + pos) * tl.B + tl.b;
        stride = (long long)tl.T * tl.B;
        live = tl.valid;
      }
      const float4* wk = reinterpret_cast<const float4*>(w_conv + k * C * CP);
      for (int c = 0; c < C; ++c) {
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
    // Bias, then the input mixin on the condition: z = (conv + b) + mixin.
#pragma unroll
    for (int o = 0; o < CP; ++o) {
      float m = 0.f;
#pragma unroll
      for (int si = 0; si < SMAX; ++si)
        if (si < S) m += w_mix[si * CP + o] * cond[si];
      z[o] = (z[o] + w_b[o]) + m;
    }

    apply_act<CP>(z, act, w_prm);

    // The layer's input becomes history: ring slot n mod M.
    if (M > 0 && tl.valid) {
      float* dst = state + ring + ((long long)nM * C * tl.T + tl.t) * tl.B + tl.b;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < C) dst[(long long)c * tl.T * tl.B] = xr[c];
    }

#pragma unroll
    for (int o = 0; o < CP; ++o) hacc[o] += z[o];

    if (l1) {
      float l[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) l[c] = 0.f;
#pragma unroll
      for (int o = 0; o < CP; ++o) {
        const float4* wo = reinterpret_cast<const float4*>(w_l1 + o * CP);
#pragma unroll
        for (int c4 = 0; c4 < CP / 4; ++c4) {
          const float4 wv = wo[c4];
          l[4 * c4 + 0] += wv.x * z[o];
          l[4 * c4 + 1] += wv.y * z[o];
          l[4 * c4 + 2] += wv.z * z[o];
          l[4 * c4 + 3] += wv.w * z[o];
        }
      }
#pragma unroll
      for (int c = 0; c < CP; ++c) xr[c] = xr[c] + (l[c] + w_l1b[c]);
    }

    // Publish the next layer's input; the sync also retires this layer's
    // reads of cur[p] and of this layer's weight buffer.
    float* cur_n = cur + (p ^ 1) * C * TB;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      if (c < C) cur_n[(c * tl.T + tl.t) * tl.BS + tl.bl] = xr[c];
    __syncthreads();
  }

  // 1x1 head rechannel: head_out = Whr . head_acc (+ bhr), Whr (HS, C).
  {
    const float* whr = w + ap[A_HR];
    const long long hb = ap[A_HR_B];
    float ho[CM];
#pragma unroll
    for (int o = 0; o < CM; ++o) {
      float acc = 0.f;
      if (o < HS) {
#pragma unroll
        for (int c = 0; c < CP; ++c)
          if (c < C) acc += __ldg(whr + o * C + c) * hacc[c];
        if (hb >= 0) acc = acc + __ldg(w + hb + o);
      }
      ho[o] = acc;
    }
#pragma unroll
    for (int o = 0; o < CM; ++o) hacc[o] = ho[o];
  }
}

template <int CM>
__global__ void __launch_bounds__(512) stack_step_kernel(const float* __restrict__ x, float* __restrict__ y,
                                                         float* __restrict__ state, const float* __restrict__ w,
                                                         const long long* __restrict__ plan, int T, int B, int n,
                                                         int BS) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int seg_max = (int)plan[P_SEG_MAX];
  float* wsm0 = smem;
  float* wsm1 = smem + seg_max;
  float* cur = smem + 2 * seg_max;  // [2][C][T][BS]

  Tile tl;
  tl.T = T;
  tl.B = B;
  tl.BS = BS;
  tl.n = n;
  tl.bl = threadIdx.x % BS;
  tl.t = threadIdx.x / BS;
  tl.b = blockIdx.x * BS + tl.bl;
  tl.valid = tl.b < B;

  const int S = (int)plan[P_CIN];
  const int n_arrays = (int)plan[P_N_ARRAYS];
  const int n_layers = (int)plan[P_N_LAYERS];

  float cond[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s)
    cond[s] = (s < S && tl.valid) ? x[((long long)s * T + tl.t) * B + tl.b] : 0.f;

  // The first array's rechannel reads the input from xr.
  static_assert(CM >= SMAX, "register tile narrower than the input");
  float xr[CM], hacc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    xr[c] = c < SMAX ? cond[c % SMAX] : 0.f;
    hacc[c] = 0.f;
  }

  if (n_layers > 0) {
    const long long* l0 = plan + P_HEADER + n_arrays * AF;
    stage(wsm0, w + l0[L_SEG], (int)l0[L_SEG_LEN]);
  }

  for (int a = 0; a < n_arrays; ++a) {
    const long long* ap = plan + P_HEADER + a * AF;
    switch ((int)ap[A_CP]) {
      case 4:
        run_array<4, CM>(plan, ap, w, state, wsm0, wsm1, cur, cond, S, xr, hacc, tl, n_layers);
        break;
      case 8:
        if constexpr (CM >= 8) run_array<8, CM>(plan, ap, w, state, wsm0, wsm1, cur, cond, S, xr, hacc, tl, n_layers);
        break;
      case 16:
        if constexpr (CM >= 16) run_array<16, CM>(plan, ap, w, state, wsm0, wsm1, cur, cond, S, xr, hacc, tl, n_layers);
        break;
      case 32:
        if constexpr (CM >= 32) run_array<32, CM>(plan, ap, w, state, wsm0, wsm1, cur, cond, S, xr, hacc, tl, n_layers);
        break;
      default:
        break;
    }
  }

  if (tl.valid) {
    const int Cout = (int)plan[P_COUT];
    const float hs = __ldg(w + plan[P_HEAD_SCALE]);
#pragma unroll
    for (int o = 0; o < CM; ++o)
      if (o < Cout) y[((long long)o * T + tl.t) * B + tl.b] = hs * hacc[o];
  }
}

template <int CM>
cudaError_t launch(const float* x, float* y, float* state, const float* w, const long long* plan, int T, int B,
                   int n, int BS, int smem_bytes, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(stack_step_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = (B + BS - 1) / BS;
  stack_step_kernel<CM><<<grid, T * BS, smem_bytes, stream>>>(x, y, state, w, plan, T, B, n, BS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success). Does not
// synchronise and allocates nothing.
int nam_stack_step(const void* x, void* y, void* state, const void* w, const void* plan, int T, int B, int n,
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
