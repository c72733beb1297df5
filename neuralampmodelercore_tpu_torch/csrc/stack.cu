// Fused WaveNet stack step for Hopper (sm_90a): one launch runs every net,
// every layer array and every layer of one block, for every stream.
//
// Replaces the TPU kernel `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/stack.py (driven by `step`, the
// pl.pallas_call at stack.py:1769) with the features of K1a-K1e: gating and
// blending with a secondary activation, bottleneck != channels, layer1x1 and
// head1x1, per-channel PReLU slopes, FiLM at all 8 sites, a head rechannel
// conv of any kernel size and dilation with rf <= T (the A2 family's k=16
// head), the post-stack head, and a chain of WaveNet condition DSPs run as
// prelude nets, with every activation under the fast-tanh and LUT modes
// (K1f: resolved to codes on the host, csrc/activations.cuh). A condition DSP
// that is not a WaveNet runs before the launch (ops/cuda/stack.py `step`); its
// output comes in as `cond_in`. The wavefront-scheduled path (K1g) is its own
// kernel, csrc/stack_wf.cu, on the same state and the same plan; the device
// code both run is in csrc/stack.cuh.
//
// What it computes, per net (the condition nets, deepest first, then the
// model; each reads the raw input x; the first one's condition is x or
// cond_in, each later one's the previous net's output), per layer array
// (reference graph: Layer::Process, NAM/wavenet/model.cpp:166-376; stage order
// of the JAX kernel, stack.py:1551-1641):
//   h    = rechannel(layer_out)                          (1x1, no bias)
//   per layer:
//     hf = film_conv_pre(h)                                 (history sees hf)
//     c  = film_conv_post(b + W . [hf(t - (K-1-k) d)]_k)    (conv_out rows)
//     m  = film_mixin_post(mixin . film_mixin_pre(cond))
//     z  = film_act_pre(c + m)
//     a  = act1(z) | act1(top) * act2(bot) | alpha act1(top) + (1 - alpha) top,
//          alpha = act2(bot)                               (gated / blended)
//     a  = film_act_post(a)
//     ring[n mod M] <- hf
//     h  = h + l,  l = L1 . a + b1, film_l1_post(l) only when blended
//          (the reference's quirk, model.cpp:262-270)      (if layer1x1)
//     head_acc += film_h1_post(H1 . a + bh) or a
//   head_out = Whr . [head_acc(t - (K-1-k) d)]_k (+ bhr)    (head rechannel)
// The next array's head accumulator starts from head_out; after the last
// array, work = head_scale * head_out, then per post-head conv
// work = conv(act(work)) with carried history.
// FiLM: v * (Wsc . cond + bsc) (+ (Wsh . cond + bsh)), a 1x1 of the
// condition, which each thread holds in registers.
//
// State: one ring of M = rf // T + 2 whole blocks per conv with rf > 0 (the
// layers, and the head rechannels and post-head convs with K > 1), in the
// (M, rows, T, B) layout of ops/ring.py: streams innermost. A tap at lookback
// a reads frame s = t - a; s < 0 lies m = ceil(-s / T) blocks back, in slot
// (n - m) mod M at frame s + m T.
//
// Design (right and simple first; speed is for later):
//   - one CTA per tile of BS streams, one thread per (frame, stream), the
//     net, array and layer loops inside the CTA, __syncthreads() between
//     layers;
//   - the layer input of the tile lives in shared memory, double-buffered, so
//     neighbouring frames' taps read it there; a thread keeps its own
//     residual, head accumulator and activations in registers;
//   - conv_pre_film: neighbouring frames' taps and the ring must see the
//     FILMED input, the residual the raw one. The raw input is published at
//     the end of the previous layer (the film weights are staged with this
//     layer, not visible before that sync); a layer with conv_pre_film films
//     its own column of the shared buffer in place, then syncs once more. The
//     ring takes the thread's column of the shared buffer, so it gets what
//     the taps read. The residual stays in the register array xr;
//   - a gated or blended layer's conv rows are packed as [top | bottom] at
//     [0, CP/2) and [CP/2, CP): CP >= 2 bottleneck, so the split is a
//     compile-time index and z stays in registers;
//   - a conv outside the layer loop (head rechannel, post-head conv; any K)
//     publishes its input to the shared buffer behind a sync, reads its taps
//     there and from its ring, writes its ring slot and syncs again;
//   - gating mode, FiLM sites, tail convs and the net count are runtime plan
//     fields: the instances are only the register tiles, 4/8/16/32 for the
//     widest row count (CM) and for each array (CP <= CM), 10 in all;
//   - each layer's weights (conv, mixin, layer1x1, head1x1, FiLM, activation
//     parameters) are staged into shared memory one layer ahead and read as
//     float4 or scalar broadcasts;
//   - float32 FMA only. Tensor cores would mean TF32, the analog of the
//     single-pass dot the JAX package rejected at 4.5e-2 error
//     (stack.py:442-457). tanh is tanhf, sigmoid 1 / (1 + expf(-x)): no
//     fast-math. A LUT activation recomputes the base function at the two
//     grid points around x, as the JAX kernel does.
//
// What bounds it on an H100: the flagship (16 then 8 channels, dilations
// 1..512, T = 64) needs about 13.3k MACs and about 98 KB of state traffic per
// stream and block, so at 3.35 TB/s and 67 TFLOP/s the bytes bound it
// (~60 us at B = 2048); the everything-on model (gated, FiLM, k=16 head,
// post head) about 16.8k MACs. This kernel writes whole T-frame chunks for
// every conv with history, about 1.3x those bytes, issues one shared-memory
// load for every four FMAs, and runs one CTA per SM at 512 threads.
// Where trouble is likely on Hopper:
//   - registers: K1a already sat at 128 registers (512 threads) with spills
//     in one instance; a gated layer adds a second half of z, FiLM and
//     head1x1 add temporaries, so the CM = 32 instances spill more
//     (chip_smoke prints ptxas's report per instance);
//   - build time: one source, 4 kernel instances and 10 array instances;
//     everything unrolled over a register tile is inlined into each, so the
//     tail convs run from the kernel, with only their output loop unrolled
//     (inlined per array, with a register path for K = 1, they doubled the
//     build); chip_smoke prints the nvcc time;
//   - latency: one CTA per SM, 16 warps, and a deep layer's two past taps
//     come from device memory; the conv issues four channels' loads before
//     their FMAs, which made the flagship faster than K1a was (PERF.md);
//   - exact arithmetic: the plain version (ops/cuda/stack.py step_plain)
//     follows the same order; sums differ from torch's only in their order.

#include "stack.cuh"  // plan layout, Tile, Ctx, tap_src, film, matvec, tail_conv, conv_taps, ...

namespace {

// One layer array's layers, its rows padded to CP (a multiple of 4). `xr`
// holds this thread's layer input on entry to each layer (the array's input
// on entry) and the array's output on exit; `hacc` the head accumulator.
// `cond` is the net's condition (S channels).
template <int CP, int CM>
__device__ __forceinline__ void run_array(const Ctx& cx, const long long* ap, int S, const float* cond, float* xr,
                                          float* hacc) {
  constexpr int H = CP / 2;  // a gated / blended layer's bottom half starts here
  const Tile& tl = cx.tl;
  const int C = (int)ap[A_C];
  const int first = (int)ap[A_FIRST];
  const int NL = (int)ap[A_NL];
  const int TB = tl.T * tl.BS;

  rechannel<CP, CM>(cx, ap, xr, cx.cur);
  __syncthreads();

  for (int li = 0; li < NL; ++li) {
    const int g = first + li;
    const long long* lp = cx.layers + (long long)g * LF;
    const int M = (int)lp[L_M];
    const int gating = (int)lp[L_GATING];
    const long long* fo = lp + L_FILM;   // FiLM weights' offsets in the segment, -1: inactive
    const long long* fsh = lp + L_SHIFT;  // FiLM shift flags
    const int p = li & 1;
    const float* ws = (g & 1) ? cx.wsm1 : cx.wsm0;

    // Stage the next layer's weights one layer ahead; its buffer was last
    // read by layer g - 1, which every thread finished before the last sync.
    if (g + 1 < cx.n_layers) {
      const long long* nx = lp + LF;
      stage((g & 1) ? cx.wsm0 : cx.wsm1, cx.w + nx[L_SEG], (int)nx[L_SEG_LEN]);
    }

    float* cur_p = cx.cur + p * C * TB;
    if (fo[CONV_PRE] >= 0) {
      // The taps and the ring see the filmed input; xr keeps the raw one.
      float f[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) f[c] = xr[c];
      film<CP>(f, ws + fo[CONV_PRE], fsh[CONV_PRE] != 0, S, cond);
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < C) cur_p[c * TB + tl.own] = f[c];
      __syncthreads();
    }

    float z[CP];
    conv_taps<CP>(cx, lp, ws, cur_p, C, z);

    const float* w_b = ws + lp[L_B];
    const float* w_mix = ws + lp[L_MIX];  // (S, CP)
    if (lp[L_FEAT] == 0) {
      // A layer with no gating, FiLM or head1x1 (K1a's) takes its own short
      // branch, so the feature code's temporaries are not live around it
      // (7% on the flagship, PERF.md).
      plain_layer_rest<CP>(cx, lp, ws, cur_p, cx.cur + (p ^ 1) * C * TB, C, S, cond, z, xr, hacc);
      __syncthreads();
      continue;
    }

    // z = film(film(conv + b) + film(mixin . film(cond))).
#pragma unroll
    for (int o = 0; o < CP; ++o) z[o] = z[o] + w_b[o];
    if (fo[CONV_POST] >= 0) film<CP>(z, ws + fo[CONV_POST], fsh[CONV_POST] != 0, S, cond);
    {
      float mi[SMAX];
#pragma unroll
      for (int s = 0; s < SMAX; ++s) mi[s] = cond[s];
      if (fo[MIXIN_PRE] >= 0) film<SMAX>(mi, ws + fo[MIXIN_PRE], fsh[MIXIN_PRE] != 0, S, cond);
      float m[CP];
#pragma unroll
      for (int o = 0; o < CP; ++o) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < SMAX; ++s)
          if (s < S) acc += w_mix[s * CP + o] * mi[s];
        m[o] = acc;
      }
      if (fo[MIXIN_POST] >= 0) film<CP>(m, ws + fo[MIXIN_POST], fsh[MIXIN_POST] != 0, S, cond);
#pragma unroll
      for (int o = 0; o < CP; ++o) z[o] = z[o] + m[o];
    }
    if (fo[ACT_PRE] >= 0) film<CP>(z, ws + fo[ACT_PRE], fsh[ACT_PRE] != 0, S, cond);

    // The activation, or the gated / blended pair: a lands in z[0, bn).
    const float* prm1 = ws + lp[L_PRM1];
    if (gating == 0) {
      activate<CP>(z, (int)lp[L_ACT1], prm1);
    } else {
      float top[H], gate[H];
#pragma unroll
      for (int o = 0; o < H; ++o) {
        top[o] = z[o];
        gate[o] = z[H + o];
      }
      activate<H>(top, (int)lp[L_ACT1], prm1);
      activate<H>(gate, (int)lp[L_ACT2], ws + lp[L_PRM2]);
#pragma unroll
      for (int o = 0; o < H; ++o) {
        z[o] = gating == GATED ? top[o] * gate[o] : gate[o] * top[o] + (1.f - gate[o]) * z[o];
        z[H + o] = 0.f;
      }
    }
    if (fo[ACT_POST] >= 0) film<CP>(z, ws + fo[ACT_POST], fsh[ACT_POST] != 0, S, cond);

    // The layer's (filmed) input becomes history: ring slot n mod M.
    if (M > 0 && tl.valid) {
      float* dst = cx.state + lp[L_RING] + ((long long)(tl.n % M) * C * tl.T + tl.t) * tl.B + tl.b;
      for (int c = 0; c < C; ++c) dst[(long long)c * tl.T * tl.B] = cur_p[c * TB + tl.own];
    }

    if (lp[L_L1] >= 0) {
      float l[CP];
      matvec<CP>(ws + lp[L_L1], ws + lp[L_L1B], z, l);
      if (gating == BLENDED && fo[L1_POST] >= 0) film<CP>(l, ws + fo[L1_POST], fsh[L1_POST] != 0, S, cond);
#pragma unroll
      for (int c = 0; c < CP; ++c) xr[c] = xr[c] + l[c];
    }
    if (lp[L_H1] >= 0) {
      float hd[CP];
      matvec<CP>(ws + lp[L_H1], ws + lp[L_H1B], z, hd);
      if (fo[H1_POST] >= 0) film<CP>(hd, ws + fo[H1_POST], fsh[H1_POST] != 0, S, cond);
#pragma unroll
      for (int o = 0; o < CP; ++o) hacc[o] += hd[o];
    } else {
#pragma unroll
      for (int o = 0; o < CP; ++o) hacc[o] += z[o];
    }

    // Publish the next layer's (raw) input; the sync also retires this
    // layer's reads of cur[p] and of this layer's weight buffer.
    float* cur_n = cx.cur + (p ^ 1) * C * TB;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      if (c < C) cur_n[c * TB + tl.own] = xr[c];
    __syncthreads();
  }
}

// The array runner of this kernel: one layer after another.
struct Unpacked {
  template <int CP, int CM>
  __device__ static __forceinline__ void run(const Ctx& cx, const long long* ap, int, int S, const float* cond,
                                             float* xr, float* hacc) {
    run_array<CP, CM>(cx, ap, S, cond, xr, hacc);
  }
};

template <int CM>
__global__ void __launch_bounds__(512)
    stack_step_kernel(const float* __restrict__ x, const float* __restrict__ cond_in, float* __restrict__ y,
                      float* __restrict__ state, const float* __restrict__ w, const long long* __restrict__ plan,
                      int T, int B, int n, int BS) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Ctx cx = make_ctx(state, w, plan, T, B, n, BS);
  cx.wsm0 = smem;
  cx.wsm1 = smem + cx.seg_max;
  cx.cur = smem + 2 * cx.seg_max;
  stack_step_body<CM, Unpacked>(cx, x, cond_in, y, plan);
}

template <int CM>
cudaError_t launch(const float* x, const float* cond, float* y, float* state, const float* w, const long long* plan,
                   int T, int B, int n, int BS, int smem_bytes, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(stack_step_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = (B + BS - 1) / BS;
  stack_step_kernel<CM><<<grid, T * BS, smem_bytes, stream>>>(x, cond, y, state, w, plan, T, B, n, BS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers (`cond` may be
// null: no pre-pass condition); `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise and
// allocates nothing.
int nam_stack_step(const void* x, const void* cond, void* y, void* state, const void* w, const void* plan, int T,
                   int B, int n, int BS, int c_max, int smem_bytes, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(cond);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  const float* wf = static_cast<const float*>(w);
  const long long* pl = static_cast<const long long*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_max) {
    case 4:
      return (int)launch<4>(xf, cf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    case 8:
      return (int)launch<8>(xf, cf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    case 16:
      return (int)launch<16>(xf, cf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    case 32:
      return (int)launch<32>(xf, cf, yf, sf, wf, pl, T, B, n, BS, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
