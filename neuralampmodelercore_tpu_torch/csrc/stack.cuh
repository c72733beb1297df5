// Device code shared by the fused WaveNet stack kernels: csrc/stack.cu (the
// unpacked layer loop, K1a-K1f) and csrc/stack_wf.cu (shallow-layer runs in
// wavefront micro-steps, K1g); csrc/stack_wide.cu takes the plan layout, the
// tile and the tap source. What a step computes, the state layout and the
// design are described in stack.cu's header; this file holds the plan
// layout, the per-thread tile, the tap source, FiLM, the 1x1 products, the
// tail convs, the parts of a layer both kernels run, and the kernel body
// around the array loop, which each kernel gives its own array runner.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"  // Act codes, activate, stage

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

struct Tile {
  int t, bl, b, BS, T, B, n, own;  // own: this thread's column of a (rows, T, BS) shared buffer
  bool valid;
};

struct Ctx {
  const float* w;
  float* state;
  float* wsm0;  // weight buffers: stack.cu two (wsm0, wsm1), stack_wf.cu G + 1 from wsm0 on
  float* wsm1;
  float* cur;  // layer inputs: stack.cu [2][rows][T][BS], stack_wf.cu [D][rows][T][BS]
  const long long* arrays;
  const long long* tails;
  const long long* layers;
  const long long* sched;  // stack_wf.cu's micro-step schedule
  int n_layers;
  int seg_max;
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

// The layer's dilated conv into z (its conv_out rows, no bias): tap k reads
// lookback (K-1-k) d of the layer input, this block's frames from `cur_p`
// ([C][T][BS] in shared memory), earlier ones from the layer's ring.
// Weights (K*C, CP) in shared memory, row k*C + c.
template <int CP>
__device__ __forceinline__ void conv_taps(const Ctx& cx, const long long* lp, const float* ws, const float* cur_p,
                                          int C, float* z) {
  const Tile& tl = cx.tl;
  const int K = (int)lp[L_K];
  const int d = (int)lp[L_D];
  const int M = (int)lp[L_M];
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
}

// The rest of a layer with no gating, FiLM or head1x1 (K1a's), after
// conv_taps: z = (conv + b) + mixin . cond, the activation, the layer input
// (this thread's column of `cur_p`) into ring slot n mod M, the residual
// through layer1x1 and the head accumulator; then this thread's next layer
// input goes to `cur_n`. No sync.
template <int CP>
__device__ __forceinline__ void plain_layer_rest(const Ctx& cx, const long long* lp, const float* ws,
                                                 const float* cur_p, float* cur_n, int C, int S, const float* cond,
                                                 float* z, float* xr, float* hacc) {
  const Tile& tl = cx.tl;
  const int TB = tl.T * tl.BS;
  const int M = (int)lp[L_M];
  const float* w_b = ws + lp[L_B];
  const float* w_mix = ws + lp[L_MIX];  // (S, CP)
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
#pragma unroll
  for (int c = 0; c < CP; ++c)
    if (c < C) cur_n[c * TB + tl.own] = xr[c];
}

// Rechannel (1x1, no bias) of this thread's array input xr into the layer-0
// input: xr becomes it, and it is published to `cur` ([C][T][BS]). No sync.
template <int CP, int CM>
__device__ __forceinline__ void rechannel(const Ctx& cx, const long long* ap, float* xr, float* cur) {
  const Tile& tl = cx.tl;
  const int C = (int)ap[A_C];
  const int I = (int)ap[A_I];
  const int TB = tl.T * tl.BS;
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
    if (c < C) cur[c * TB + tl.own] = xr[c];
}

// The plan's pointers and this thread's tile: one thread per (frame t,
// stream b) of a CTA's BS streams. The caller lays out the shared memory.
__device__ __forceinline__ Ctx make_ctx(float* state, const float* w, const long long* plan, int T, int B, int n,
                                        int BS) {
  Ctx cx;
  cx.w = w;
  cx.state = state;
  cx.sched = nullptr;
  cx.seg_max = (int)plan[P_SEG_MAX];
  cx.arrays = plan + P_HEADER + plan[P_N_NETS] * NF;
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
  return cx;
}

// Every net of one block for this thread's (frame, stream): the condition,
// the nets in order (each array through ARRAYS::run<CP, CM>(cx, ap, a, S,
// cond, xr, hacc), then its head rechannel), head_scale, the post-stack head,
// the output. Layer 0's weights are staged into cx.wsm0 here.
template <int CM, class ARRAYS>
__device__ __forceinline__ void stack_step_body(Ctx& cx, const float* __restrict__ x,
                                                const float* __restrict__ cond_in, float* __restrict__ y,
                                                const long long* __restrict__ plan) {
  const Tile& tl = cx.tl;
  const int T = tl.T, B = tl.B;
  const long long* nets = plan + P_HEADER;
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

  if (cx.n_layers > 0) stage(cx.wsm0, cx.w + cx.layers[L_SEG], (int)cx.layers[L_SEG_LEN]);

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
          ARRAYS::template run<4, CM>(cx, ap, a, S, cond, xr, hacc);
          break;
        case 8:
          if constexpr (CM >= 8) ARRAYS::template run<8, CM>(cx, ap, a, S, cond, xr, hacc);
          break;
        case 16:
          if constexpr (CM >= 16) ARRAYS::template run<16, CM>(cx, ap, a, S, cond, xr, hacc);
          break;
        case 32:
          if constexpr (CM >= 32) ARRAYS::template run<32, CM>(cx, ap, a, S, cond, xr, hacc);
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
    const float hs = __ldg(cx.w + np[N_HEAD_SCALE]);
#pragma unroll
    for (int o = 0; o < CM; ++o) hacc[o] = hs * hacc[o];
    for (int ph = 0; ph < (int)np[N_PHEADS]; ++ph) {
      const long long* tc = cx.tails + (np[N_FIRST_PHEAD] + ph) * TF;
      if (tc[T_ACT] >= 0) activate<CM>(hacc, (int)tc[T_ACT], cx.w + tc[T_PRM]);
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

}  // namespace
