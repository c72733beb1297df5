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
// prelude nets. A condition DSP that is not a WaveNet runs before the launch
// (ops/cuda/stack.py `step`); its output comes in as `cond_in`. Not here: the
// fast-tanh and LUT modes (K1f) and the wavefront packing (K1g).
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
//     fast-math.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"  // Act codes, apply_act, stage

namespace {

// Plan layout (int64), written by ops/cuda/stack.py `_pack_plan`: header,
// nets, arrays, tail convs, layers.
constexpr int P_N_NETS = 0, P_N_ARRAYS = 1, P_N_TAILS = 2, P_N_LAYERS = 3, P_CIN = 4, P_COUT = 5,
              P_SEG_MAX = 6, P_S_EXT = 7;
constexpr int P_HEADER = 8;
constexpr int NF = 8;  // fields per net
constexpr int N_FIRST_ARRAY = 0, N_ARRAYS = 1, N_S = 2, N_HEAD_SCALE = 4, N_FIRST_PHEAD = 5, N_PHEADS = 6;
constexpr int AF = 10;  // fields per array
constexpr int A_C = 0, A_CP = 1, A_I = 2, A_RECH = 5, A_FIRST = 6, A_NL = 7, A_HR = 8;
constexpr int TF = 10;  // fields per tail conv
constexpr int T_K = 0, T_D = 1, T_CIN = 2, T_COUT = 3, T_W = 4, T_B = 5, T_M = 6, T_RING = 7, T_ACT = 8,
              T_PRM = 9;
constexpr int LF = 34;  // fields per layer; offsets L_B.. are inside the layer's weight segment
constexpr int L_K = 0, L_D = 1, L_M = 2, L_RING = 3, L_SEG = 4, L_SEG_LEN = 5, L_ACT1 = 6, L_ACT2 = 7,
              L_GATING = 8, L_B = 9, L_MIX = 10, L_L1 = 11, L_L1B = 12, L_H1 = 13, L_H1B = 14, L_PRM1 = 15,
              L_PRM2 = 16, L_FILM = 17, L_SHIFT = 25, L_FEAT = 33;
// FiLM sites, in FILM_SITES order (models/wavenet.py).
enum Film { CONV_PRE = 0, CONV_POST, MIXIN_PRE, MIXIN_POST, ACT_PRE, ACT_POST, L1_POST, H1_POST };
constexpr int GATED = 1, BLENDED = 2;

constexpr int SMAX = 4;  // largest condition / input channel count
constexpr int ACT_PRELU_CHANNELS = 11;  // PReLU, one slope per channel in prm[o] (stack.py)

// An activation of activations.cuh, or PReLU with a slope per channel.
template <int N>
__device__ __forceinline__ void activate(float* z, int code, const float* prm) {
  if (code == ACT_PRELU_CHANNELS) {
#pragma unroll
    for (int o = 0; o < N; ++o) z[o] = z[o] > 0.f ? z[o] : prm[o] * z[o];
  } else {
    apply_act<N>(z, code, prm);
  }
}

struct Tile {
  int t, bl, b, BS, T, B, n, own;  // own: this thread's column of a (rows, T, BS) shared buffer
  bool valid;
};

struct Ctx {
  const float* w;
  float* state;
  float* wsm0;
  float* wsm1;
  float* cur;  // [2][rows][T][BS]
  const long long* arrays;
  const long long* tails;
  const long long* layers;
  int n_layers;
  Tile tl;
};

// Where the tap at lookback `a` of a conv reads channel 0: frame t - a of
// this block in the shared buffer `buf` ([rows][T][BS]), or of a past block in
// the conv's ring, and the stride between channels.
struct Src {
  const float* p;
  long long stride;
  bool live;
};

__device__ __forceinline__ Src tap_src(const float* buf, const float* state, long long ring, int M, int rows, int a,
                                       const Tile& tl) {
  const int s = tl.t - a;
  if (s >= 0) return {buf + s * tl.BS + tl.bl, (long long)tl.T * tl.BS, true};
  const int m = (tl.T - 1 - s) / tl.T;  // blocks back: ceil(-s / T), <= M - 1
  const int pos = s + m * tl.T;
  const int slot = (tl.n % M - m + M) % M;
  return {state + ring + ((long long)slot * rows * tl.T + pos) * tl.B + tl.b, (long long)tl.T * tl.B, tl.valid};
}

// FiLM on W rows: v *= (Wsc . cond + bsc) [+= (Wsh . cond + bsh)]; f holds
// Wsc (S, W), bsc (W) and, with shift, Wsh (S, W), bsh (W).
template <int W>
__device__ __forceinline__ void film(float* v, const float* f, bool shift, int S, const float* cond) {
  const float* g = f + S * W + W;
#pragma unroll
  for (int o = 0; o < W; ++o) {
    float sc = 0.f;
#pragma unroll
    for (int s = 0; s < SMAX; ++s)
      if (s < S) sc += f[s * W + o] * cond[s];
    sc = sc + f[S * W + o];
    if (shift) {
      float sh = 0.f;
#pragma unroll
      for (int s = 0; s < SMAX; ++s)
        if (s < S) sh += g[s * W + o] * cond[s];
      sh = sh + g[S * W + o];
      v[o] = v[o] * sc + sh;
    } else {
      v[o] = v[o] * sc;
    }
  }
}

// y[c] = b[c] + sum_i w[i * N + c] x[i] for c < N; w (N, N) and b 16-byte
// aligned in shared memory, zero outside the real rows and columns.
template <int N>
__device__ __forceinline__ void matvec(const float* w, const float* b, const float* x, float* y) {
#pragma unroll
  for (int c = 0; c < N; ++c) y[c] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4* wi = reinterpret_cast<const float4*>(w + i * N);
#pragma unroll
    for (int c4 = 0; c4 < N / 4; ++c4) {
      const float4 wv = wi[c4];
      y[4 * c4 + 0] += wv.x * x[i];
      y[4 * c4 + 1] += wv.y * x[i];
      y[4 * c4 + 2] += wv.z * x[i];
      y[4 * c4 + 3] += wv.w * x[i];
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) y[c] = y[c] + b[c];
}

// A conv with carried history outside the layer loop (head rechannel,
// post-head conv): out = W . [in(t - (K-1-k) d)]_k (+ b), (K cin, cout)
// weights in device memory, cin and cout <= N. The input is published to the
// shared buffer behind a sync (neighbouring frames' taps read it there) and,
// with K > 1, written to ring slot n mod M; a second sync retires the taps
// before the buffer's next use. Only the output loop is unrolled: this runs
// once per array, not per layer.
template <int N>
__device__ __forceinline__ void tail_conv(const Ctx& cx, const long long* tc, const float* in, float* out) {
  const Tile& tl = cx.tl;
  const int K = (int)tc[T_K];
  const int d = (int)tc[T_D];
  const int cin = (int)tc[T_CIN];
  const int cout = (int)tc[T_COUT];
  const int M = (int)tc[T_M];
  const long long ring = tc[T_RING];
  const float* w = cx.w + tc[T_W];
  const int TB = tl.T * tl.BS;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < cin) cx.cur[c * TB + tl.own] = in[c];
  __syncthreads();
  float acc[N];
#pragma unroll
  for (int o = 0; o < N; ++o) acc[o] = 0.f;
  for (int k = 0; k < K; ++k) {
    const Src src = tap_src(cx.cur, cx.state, ring, M, cin, (K - 1 - k) * d, tl);
    const float* wk = w + (long long)k * cin * cout;
    for (int c = 0; c < cin; ++c) {
      const float v = src.live ? src.p[c * src.stride] : 0.f;
#pragma unroll
      for (int o = 0; o < N; ++o)
        if (o < cout) acc[o] += __ldg(wk + c * cout + o) * v;
    }
  }
  if (M > 0 && tl.valid) {
    float* dst = cx.state + ring + ((long long)(tl.n % M) * cin * tl.T + tl.t) * tl.B + tl.b;
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < cin) dst[(long long)c * tl.T * tl.B] = in[c];
  }
  __syncthreads();
  const long long bo = tc[T_B];
#pragma unroll
  for (int o = 0; o < N; ++o) out[o] = o < cout ? (bo >= 0 ? acc[o] + __ldg(cx.w + bo + o) : acc[o]) : 0.f;
}

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
  const int I = (int)ap[A_I];
  const int first = (int)ap[A_FIRST];
  const int NL = (int)ap[A_NL];
  const int TB = tl.T * tl.BS;

  // Rechannel (1x1, no bias) into the layer-0 input, then publish it.
  {
    const float* wr = cx.w + ap[A_RECH];  // (C, I) row-major
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
      if (c < C) cx.cur[c * TB + tl.own] = xr[c];
  }
  __syncthreads();

  for (int li = 0; li < NL; ++li) {
    const int g = first + li;
    const long long* lp = cx.layers + (long long)g * LF;
    const int K = (int)lp[L_K];
    const int d = (int)lp[L_D];
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

    // Tap-stacked dilated conv into conv_out rows. Tap k reads lookback
    // (K-1-k)*d. Weights (K*C, CP), row k*C + c.
    float z[CP];
#pragma unroll
    for (int o = 0; o < CP; ++o) z[o] = 0.f;
    for (int k = 0; k < K; ++k) {
      const Src src = tap_src(cur_p, cx.state, lp[L_RING], M, C, (K - 1 - k) * d, tl);
      const float4* wk = reinterpret_cast<const float4*>(ws + k * C * CP);
      // Four channels' loads are issued before their FMAs, so a ring tap's
      // device-memory latency is paid once per four channels, not per channel.
      const float* q = src.p;
      for (int c0 = 0; c0 < C; c0 += 4) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (src.live && c0 + j < C) ? *q : 0.f;
          q += src.stride;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + j < C) {
#pragma unroll
            for (int o4 = 0; o4 < CP / 4; ++o4) {
              const float4 wv = wk[(c0 + j) * (CP / 4) + o4];
              z[4 * o4 + 0] += wv.x * v[j];
              z[4 * o4 + 1] += wv.y * v[j];
              z[4 * o4 + 2] += wv.z * v[j];
              z[4 * o4 + 3] += wv.w * v[j];
            }
          }
        }
      }
    }

    const float* w_b = ws + lp[L_B];
    const float* w_mix = ws + lp[L_MIX];  // (S, CP)
    if (lp[L_FEAT] == 0) {
      // A layer with no gating, FiLM or head1x1 (K1a's) takes its own short
      // branch, so the feature code's temporaries are not live around it
      // (7% on the flagship, PERF.md). z = (conv + b) + mixin . cond.
#pragma unroll
      for (int o = 0; o < CP; ++o) {
        float m = 0.f;
#pragma unroll
        for (int s = 0; s < SMAX; ++s)
          if (s < S) m += w_mix[s * CP + o] * cond[s];
        z[o] = (z[o] + w_b[o]) + m;
      }
      activate<CP>(z, (int)lp[L_ACT1], ws + lp[L_PRM1]);
      if (M > 0 && tl.valid) {
        float* dst = cx.state + lp[L_RING] + ((long long)(tl.n % M) * C * tl.T + tl.t) * tl.B + tl.b;
        for (int c = 0; c < C; ++c) dst[(long long)c * tl.T * tl.B] = cur_p[c * TB + tl.own];
      }
      if (lp[L_L1] >= 0) {
        float l[CP];
        matvec<CP>(ws + lp[L_L1], ws + lp[L_L1B], z, l);
#pragma unroll
        for (int c = 0; c < CP; ++c) xr[c] = xr[c] + l[c];
      }
#pragma unroll
      for (int o = 0; o < CP; ++o) hacc[o] += z[o];
      float* cur_n = cx.cur + (p ^ 1) * C * TB;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < C) cur_n[c * TB + tl.own] = xr[c];
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

template <int CM>
__global__ void __launch_bounds__(512)
    stack_step_kernel(const float* __restrict__ x, const float* __restrict__ cond_in, float* __restrict__ y,
                      float* __restrict__ state, const float* __restrict__ w, const long long* __restrict__ plan,
                      int T, int B, int n, int BS) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int seg_max = (int)plan[P_SEG_MAX];
  const long long* nets = plan + P_HEADER;

  Ctx cx;
  cx.w = w;
  cx.state = state;
  cx.wsm0 = smem;
  cx.wsm1 = smem + seg_max;
  cx.cur = smem + 2 * seg_max;
  cx.arrays = nets + plan[P_N_NETS] * NF;
  cx.tails = cx.arrays + plan[P_N_ARRAYS] * AF;
  cx.layers = cx.tails + plan[P_N_TAILS] * TF;
  cx.n_layers = (int)plan[P_N_LAYERS];
  Tile& tl = cx.tl;
  tl.T = T;
  tl.B = B;
  tl.BS = BS;
  tl.n = n;
  tl.bl = threadIdx.x % BS;
  tl.t = threadIdx.x / BS;
  tl.own = tl.t * BS + tl.bl;
  tl.b = blockIdx.x * BS + tl.bl;
  tl.valid = tl.b < B;

  const int Cin = (int)plan[P_CIN];
  const int S_ext = (int)plan[P_S_EXT];
  const int n_nets = (int)plan[P_N_NETS];

  // The first net's condition: the pre-pass output, else the raw input.
  float cond[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    float v = 0.f;
    if (tl.valid) {
      if (S_ext > 0) {
        if (s < S_ext) v = cond_in[((long long)s * T + tl.t) * B + tl.b];
      } else if (s < Cin) {
        v = x[((long long)s * T + tl.t) * B + tl.b];
      }
    }
    cond[s] = v;
  }

  if (cx.n_layers > 0) stage(cx.wsm0, w + cx.layers[L_SEG], (int)cx.layers[L_SEG_LEN]);

  static_assert(CM >= SMAX, "register tile narrower than the input");
  float xr[CM], hacc[CM];
  for (int ni = 0; ni < n_nets; ++ni) {
    const long long* np = nets + ni * NF;
    const int S = (int)np[N_S];
    // Every net reads the raw input; its head accumulator starts at 0.
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      xr[c] = (c < SMAX && c < Cin && tl.valid) ? x[((long long)c * T + tl.t) * B + tl.b] : 0.f;
      hacc[c] = 0.f;
    }
    const int a0 = (int)np[N_FIRST_ARRAY];
    for (int a = a0; a < a0 + (int)np[N_ARRAYS]; ++a) {
      const long long* ap = cx.arrays + a * AF;
      switch ((int)ap[A_CP]) {
        case 4:
          run_array<4, CM>(cx, ap, S, cond, xr, hacc);
          break;
        case 8:
          if constexpr (CM >= 8) run_array<8, CM>(cx, ap, S, cond, xr, hacc);
          break;
        case 16:
          if constexpr (CM >= 16) run_array<16, CM>(cx, ap, S, cond, xr, hacc);
          break;
        case 32:
          if constexpr (CM >= 32) run_array<32, CM>(cx, ap, S, cond, xr, hacc);
          break;
        default:
          break;
      }
      // Head rechannel: head_out = Whr . [head_acc taps] (+ bhr).
      float ho[CM];
      tail_conv<CM>(cx, cx.tails + ap[A_HR] * TF, hacc, ho);
#pragma unroll
      for (int o = 0; o < CM; ++o) hacc[o] = ho[o];
    }

    // head_scale, then the post-stack head: repeated (activation -> conv).
    const float hs = __ldg(w + np[N_HEAD_SCALE]);
#pragma unroll
    for (int o = 0; o < CM; ++o) hacc[o] = hs * hacc[o];
    for (int ph = 0; ph < (int)np[N_PHEADS]; ++ph) {
      const long long* tc = cx.tails + (np[N_FIRST_PHEAD] + ph) * TF;
      if (tc[T_ACT] >= 0) activate<CM>(hacc, (int)tc[T_ACT], w + tc[T_PRM]);
      float o2[CM];
      tail_conv<CM>(cx, tc, hacc, o2);
#pragma unroll
      for (int o = 0; o < CM; ++o) hacc[o] = o2[o];
    }
    // A condition net's output is the next net's condition.
    if (ni + 1 < n_nets) {
#pragma unroll
      for (int s = 0; s < SMAX; ++s) cond[s] = hacc[s];
    }
  }

  if (tl.valid) {
    const int Cout = (int)plan[P_COUT];
#pragma unroll
    for (int o = 0; o < CM; ++o)
      if (o < Cout) y[((long long)o * T + tl.t) * B + tl.b] = hacc[o];
  }
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
