// Fused WaveNet stack step for Hopper (sm_90a), for what csrc/stack.cu's
// register tile cannot hold: layers, heads and post-heads of up to 128 rows
// (a gated layer's conv counts 2 * bottleneck rows), blocks of up to 1,024
// frames, and up to 8 input and condition channels.
//
// Replaces the same TPU kernel as stack.cu: `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/stack.py (driven by `step`, the
// pl.pallas_call at stack.py:1769), whose gate has no channel limit, only its
// VMEM budget. It computes what stack.cu computes (every feature of K1a-K1f:
// gating and blending, bottleneck, layer1x1, head1x1, FiLM at the 8 sites,
// per-channel PReLU, the head rechannel of any kernel size, the post-stack
// head, a fused chain of WaveNet condition nets, the fast-tanh and LUT
// modes), on the same plan, the same packed weights (padded to a tile of
// WIDE_RW rows, not to a power of two) and the same state layout
// (ops/ring.py), so a stream's state is the same whichever kernel runs it.
// ops/cuda/stack.py sends a model here only when stack.cu cannot run it.
//
// Design (right and simple first):
//   - one CTA per tile of BS streams over all T frames; its threads loop
//     over items, an item being one (frame, stream, slice of RW rows). A
//     thread may run several frames (T * BS * slices > threads), so nothing
//     an item owns outlives a phase in registers;
//   - everything a row of another slice or another frame reads lives in
//     shared memory, [rows][T][BS] like stack.cu's layer input: the layer
//     input (which is also the residual), the activations, the head
//     accumulator and the condition; a layer is two phases behind one sync
//     each (three with conv_pre_film):
//       A: the dilated conv of the item's rows (taps from the shared layer
//          input and the rings), bias, mixin, FiLM, the activation or the
//          gated pair -> the activations buffer; the layer input's rows ->
//          the ring;
//       B: layer1x1 and head1x1 of the item's rows over every activation
//          row -> the residual, in place, and the head accumulator;
//   - a gated layer's slice r computes rows [r RW/2, (r+1) RW/2) of both
//     halves (top at [0, CP/2), gate at [CP/2, CP) of the conv's columns),
//     so every slice does the same work;
//   - a layer's weight segment (66 KB at 64 rows) is staged into shared
//     memory behind a sync, where it fits beside the buffers (else it is
//     read from device memory); consecutive threads take consecutive frames
//     of one slice, so a warp's weight loads are one broadcast; ring taps are
//     loaded through L2 only (__ldcg), so streaming the rings does not evict
//     what L1 holds;
//   - float32 FMA only, tanhf, no fast-math; every sum in the order of
//     stack.cu and of the plain version (ops/cuda/stack.py step_plain).
//
// What bounds it on an H100: the LARGE preset (64 then 32 channels, 11 + 11
// layers, dilations 1..1024) needs about 230k MACs per sample against about
// 400 KB of state traffic per stream and block at T = 64, so float32
// operations bind it (about 0.9 ms at B = 2048 at 67 TFLOP/s, ops/cuda/
// stack.py `work`). This kernel issues one load of weights (L1 or L2) for
// every four FMAs and a shared-memory load for every RW FMAs of the conv.
// The flagship at T = 1,024 runs one stream per CTA (the three buffers of
// 16 rows and 1,024 frames take 192 KB), so its ring taps are not coalesced
// across streams.

#include "stack.cuh"  // plan layout, Tile, Src, tap_src, activate

namespace {

constexpr int RW = 16;      // rows of one item's slice (ops/cuda/stack.py WIDE_RW)
constexpr int HW = RW / 2;  // a gated layer's slice: HW top and HW gate rows
constexpr int SW = 8;       // largest input / condition channel count (WIDE_MAX_IN)
constexpr int NT = 512;     // most threads of a CTA
constexpr int A_HI = 3;     // plan fields stack.cuh does not name: an array's head accumulator rows,
constexpr int N_COUT = 3;   // a net's output channels

struct Wide {
  const float* w;
  float* wsm;  // the layer's weight segment in shared memory (null: read from device memory)
  float* state;
  const long long* arrays;
  const long long* tails;
  const long long* layers;
  float* cur;    // [rows][TBS] the layer input, which is also the residual
  float* spare;  // [rows][TBS] activations; rechannel and tail outputs
  float* hacc;   // [rows][TBS] the head accumulator
  float* fbuf;   // [rows][TBS] conv_pre_film's filmed layer input (null: no layer has it)
  float* cbuf;   // [srows][TBS] the net's condition
  int T, B, BS, TBS, n, rows, srows;
};

__device__ __forceinline__ Tile item_tile(const Wide& wd, int col) {
  Tile tl;
  tl.T = wd.T;
  tl.B = wd.B;
  tl.BS = wd.BS;
  tl.n = wd.n;
  tl.t = col / wd.BS;
  tl.bl = col % wd.BS;
  tl.own = col;
  tl.b = blockIdx.x * wd.BS + tl.bl;
  tl.valid = tl.b < wd.B;
  return tl;
}

__device__ __forceinline__ void swap_bufs(float*& a, float*& b) {
  float* t = a;
  a = b;
  b = t;
}

// A ring tap: through L2 only, so that streaming the rings does not evict
// the layer's weights from L1 where they are read from device memory.
__device__ __forceinline__ float ring_load(const float* p) { return __ldcg(p); }

// Column of value j of an N-value slice: the first half from cA, the second
// from cB (cB = cA + N/2 for a contiguous slice).
template <int N>
__device__ __forceinline__ int col_of(int j, int cA, int cB) {
  return j < N / 2 ? cA + j : cB + j - N / 2;
}

__device__ __forceinline__ void load_cond(const Wide& wd, int col, int S, float* cond) {
#pragma unroll
  for (int s = 0; s < SW; ++s) cond[s] = s < S ? wd.cbuf[s * wd.TBS + col] : 0.f;
}

// FiLM on the N values of a slice, W columns: v *= (Wsc . cond + bsc)
// [+= (Wsh . cond + bsh)], as stack.cuh `film`.
template <int N>
__device__ __forceinline__ void film_cols(float* v, const float* f, bool shift, int S, int W, const float* cond,
                                          int cA, int cB) {
  const float* g = f + S * W + W;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int o = col_of<N>(j, cA, cB);
    float sc = 0.f;
#pragma unroll
    for (int s = 0; s < SW; ++s)
      if (s < S) sc += f[s * W + o] * cond[s];
    sc = sc + f[S * W + o];
    if (shift) {
      float sh = 0.f;
#pragma unroll
      for (int s = 0; s < SW; ++s)
        if (s < S) sh += g[s * W + o] * cond[s];
      sh = sh + g[S * W + o];
      v[j] = v[j] * sc + sh;
    } else {
      v[j] = v[j] * sc;
    }
  }
}

// acc[j] += w[col_j] * v for the RW columns of a slice of one weight row of
// the layer's segment (in shared or device memory).
__device__ __forceinline__ void fma_row(float* acc, const float* row, int cA, int cB, float v) {
  const float4* wa = reinterpret_cast<const float4*>(row + cA);
  const float4* wb = reinterpret_cast<const float4*>(row + cB);
#pragma unroll
  for (int o4 = 0; o4 < HW / 4; ++o4) {
    const float4 wv = wa[o4];
    acc[4 * o4 + 0] += wv.x * v;
    acc[4 * o4 + 1] += wv.y * v;
    acc[4 * o4 + 2] += wv.z * v;
    acc[4 * o4 + 3] += wv.w * v;
  }
#pragma unroll
  for (int o4 = 0; o4 < HW / 4; ++o4) {
    const float4 wv = wb[o4];
    acc[HW + 4 * o4 + 0] += wv.x * v;
    acc[HW + 4 * o4 + 1] += wv.y * v;
    acc[HW + 4 * o4 + 2] += wv.z * v;
    acc[HW + 4 * o4 + 3] += wv.w * v;
  }
}

// Rechannel (1x1, no bias) of the array input -- x for a net's first array,
// else the previous array's output in `cur` -- into `spare`; then the
// buffers swap, so `cur` holds the layer-0 input.
__device__ void rechannel(Wide& wd, const long long* ap, bool first, const float* __restrict__ x) {
  const int C = (int)ap[A_C];
  const int I = (int)ap[A_I];
  const int R = (int)ap[A_CP] / RW;
  const float* wr = wd.w + ap[A_RECH];  // (C, I) row-major
  for (int it = threadIdx.x; it < wd.TBS * R; it += blockDim.x) {
    const int col = it % wd.TBS, j0 = (it / wd.TBS) * RW;
    const Tile tl = item_tile(wd, col);
    float acc[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) acc[j] = 0.f;
    for (int i = 0; i < I; ++i) {
      float v;
      if (first)
        v = tl.valid ? x[((long long)i * wd.T + tl.t) * wd.B + tl.b] : 0.f;
      else
        v = wd.cur[i * wd.TBS + col];
#pragma unroll
      for (int j = 0; j < RW; ++j)
        if (j0 + j < C) acc[j] += __ldg(wr + (j0 + j) * I + i) * v;
    }
#pragma unroll
    for (int j = 0; j < RW; ++j)
      if (j0 + j < C) wd.spare[(j0 + j) * wd.TBS + col] = acc[j];
  }
  __syncthreads();
  swap_bufs(wd.cur, wd.spare);
}

// One layer: [F] conv_pre_film, A, B (see the header), a sync after each.
__device__ void layer(Wide& wd, const long long* ap, const long long* lp, int S) {
  const int C = (int)ap[A_C];
  const int CP = (int)ap[A_CP];
  const int HI = (int)ap[A_HI];
  const int R = CP / RW;
  const int K = (int)lp[L_K];
  const int d = (int)lp[L_D];
  const int M = (int)lp[L_M];
  const int gating = (int)lp[L_GATING];
  const long long* fo = lp + L_FILM;
  const long long* fsh = lp + L_SHIFT;
  const int TBS = wd.TBS;
  const int n_items = TBS * R;
  // The segment is staged into shared memory behind a sync (the previous
  // layer's last sync retired its reads), unless it does not fit there.
  const float* ws = wd.w + lp[L_SEG];
  if (wd.wsm) {
    stage(wd.wsm, ws, (int)lp[L_SEG_LEN]);
    __syncthreads();
    ws = wd.wsm;
  }

  // F: the taps and the ring see the filmed input; the residual keeps the raw one.
  const float* tapbuf = wd.cur;
  if (fo[CONV_PRE] >= 0) {
    for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
      const int col = it % TBS, j0 = (it / TBS) * RW;
      float cond[SW], f[RW];
      load_cond(wd, col, S, cond);
#pragma unroll
      for (int j = 0; j < RW; ++j) f[j] = j0 + j < C ? wd.cur[(j0 + j) * TBS + col] : 0.f;
      film_cols<RW>(f, ws + fo[CONV_PRE], fsh[CONV_PRE] != 0, S, CP, cond, j0, j0 + HW);
#pragma unroll
      for (int j = 0; j < RW; ++j)
        if (j0 + j < C) wd.fbuf[(j0 + j) * TBS + col] = f[j];
    }
    __syncthreads();
    tapbuf = wd.fbuf;
  }

  // A: conv, bias, mixin, FiLM, activation -> spare; the layer input -> ring.
  const float* w_mix = ws + lp[L_MIX];  // (S, CP)
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    const int col = it % TBS, r = it / TBS;
    const Tile tl = item_tile(wd, col);
    const int cA = gating ? r * HW : r * RW;
    const int cB = gating ? CP / 2 + r * HW : r * RW + HW;
    float cond[SW];
    load_cond(wd, col, S, cond);

    float z[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) z[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const Src src = tap_src(tapbuf, wd.state, lp[L_RING], M, C, (K - 1 - k) * d, tl);
      const bool in_ring = tl.t < (K - 1 - k) * d;
      const float* wk = ws + k * C * CP;
      // Four channels' loads are issued before their FMAs (as stack.cuh).
      const float* q = src.p;
      for (int c0 = 0; c0 < C; c0 += 4) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (src.live && c0 + j < C) ? (in_ring ? ring_load(q) : *q) : 0.f;
          q += src.stride;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < C) fma_row(z, wk + (c0 + j) * CP, cA, cB, v[j]);
      }
    }
    if (lp[L_FEAT] == 0) {
      // A layer with no gating, FiLM or head1x1 takes its own short branch,
      // so the feature code's temporaries are not live around it (as
      // stack.cu's plain_layer_rest): z = (conv + b) + mixin . cond.
      const int o0 = r * RW;
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        float m = 0.f;
#pragma unroll
        for (int s = 0; s < SW; ++s)
          if (s < S) m += w_mix[s * CP + o0 + j] * cond[s];
        z[j] = (z[j] + ws[lp[L_B] + o0 + j]) + m;
      }
      const int act1 = (int)lp[L_ACT1];
      const float* prm1 = ws + lp[L_PRM1];
      activate<RW>(z, act1, act1 == ACT_PRELU_CHANNELS ? prm1 + o0 : prm1);
#pragma unroll
      for (int j = 0; j < RW; ++j) wd.spare[(o0 + j) * TBS + col] = z[j];
      if (M > 0 && tl.valid) {
        float* dst = wd.state + lp[L_RING] + ((long long)(tl.n % M) * C * tl.T + tl.t) * tl.B + tl.b;
#pragma unroll
        for (int j = 0; j < RW; ++j)
          if (o0 + j < C) dst[(long long)(o0 + j) * tl.T * tl.B] = tapbuf[(o0 + j) * TBS + col];
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) z[j] = z[j] + ws[lp[L_B] + col_of<RW>(j, cA, cB)];
    if (fo[CONV_POST] >= 0) film_cols<RW>(z, ws + fo[CONV_POST], fsh[CONV_POST] != 0, S, CP, cond, cA, cB);
    {
      float mi[SW];
#pragma unroll
      for (int s = 0; s < SW; ++s) mi[s] = cond[s];
      if (fo[MIXIN_PRE] >= 0) film_cols<SW>(mi, ws + fo[MIXIN_PRE], fsh[MIXIN_PRE] != 0, S, SW, cond, 0, SW / 2);
      float m[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int o = col_of<RW>(j, cA, cB);
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < SW; ++s)
          if (s < S) acc += w_mix[s * CP + o] * mi[s];
        m[j] = acc;
      }
      if (fo[MIXIN_POST] >= 0) film_cols<RW>(m, ws + fo[MIXIN_POST], fsh[MIXIN_POST] != 0, S, CP, cond, cA, cB);
#pragma unroll
      for (int j = 0; j < RW; ++j) z[j] = z[j] + m[j];
    }
    if (fo[ACT_PRE] >= 0) film_cols<RW>(z, ws + fo[ACT_PRE], fsh[ACT_PRE] != 0, S, CP, cond, cA, cB);

    const int act1 = (int)lp[L_ACT1];
    const float* prm1 = ws + lp[L_PRM1];
    if (gating == 0) {
      // Per-channel slopes are indexed by row; the other codes' parameters are shared.
      activate<RW>(z, act1, act1 == ACT_PRELU_CHANNELS ? prm1 + cA : prm1);
      if (fo[ACT_POST] >= 0) film_cols<RW>(z, ws + fo[ACT_POST], fsh[ACT_POST] != 0, S, CP, cond, cA, cB);
#pragma unroll
      for (int j = 0; j < RW; ++j) wd.spare[col_of<RW>(j, cA, cB) * TBS + col] = z[j];
    } else {
      const int act2 = (int)lp[L_ACT2];
      const float* prm2 = ws + lp[L_PRM2];
      const int a0 = r * HW;  // rows of the activations this slice computes
      float top[HW], gate[HW];
#pragma unroll
      for (int j = 0; j < HW; ++j) {
        top[j] = z[j];
        gate[j] = z[HW + j];
      }
      activate<HW>(top, act1, act1 == ACT_PRELU_CHANNELS ? prm1 + a0 : prm1);
      activate<HW>(gate, act2, act2 == ACT_PRELU_CHANNELS ? prm2 + a0 : prm2);
#pragma unroll
      for (int j = 0; j < HW; ++j)
        top[j] = gating == GATED ? top[j] * gate[j] : gate[j] * top[j] + (1.f - gate[j]) * z[j];
      if (fo[ACT_POST] >= 0) film_cols<HW>(top, ws + fo[ACT_POST], fsh[ACT_POST] != 0, S, CP, cond, a0, a0 + HW / 2);
#pragma unroll
      for (int j = 0; j < HW; ++j) wd.spare[(a0 + j) * TBS + col] = top[j];
    }

    // The layer's (filmed) input becomes history: ring slot n mod M.
    if (M > 0 && tl.valid) {
      const int j0 = r * RW;
      float* dst = wd.state + lp[L_RING] + ((long long)(tl.n % M) * C * tl.T + tl.t) * tl.B + tl.b;
#pragma unroll
      for (int j = 0; j < RW; ++j)
        if (j0 + j < C) dst[(long long)(j0 + j) * tl.T * tl.B] = tapbuf[(j0 + j) * TBS + col];
    }
  }
  __syncthreads();

  // B: layer1x1 -> the residual, head1x1 (or the activations) -> the head accumulator.
  const int AR = gating ? CP / 2 : CP;  // activation rows written in A
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    const int col = it % TBS, j0 = (it / TBS) * RW;
    float cond[SW];
    load_cond(wd, col, S, cond);
    if (lp[L_L1] >= 0) {
      float l[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) l[j] = 0.f;
      for (int i = 0; i < AR; ++i) fma_row(l, ws + lp[L_L1] + i * CP, j0, j0 + HW, wd.spare[i * TBS + col]);
#pragma unroll
      for (int j = 0; j < RW; ++j) l[j] = l[j] + ws[lp[L_L1B] + j0 + j];
      if (gating == BLENDED && fo[L1_POST] >= 0)
        film_cols<RW>(l, ws + fo[L1_POST], fsh[L1_POST] != 0, S, CP, cond, j0, j0 + HW);
#pragma unroll
      for (int j = 0; j < RW; ++j)
        if (j0 + j < C) wd.cur[(j0 + j) * TBS + col] = wd.cur[(j0 + j) * TBS + col] + l[j];
    }
    float hd[RW];
    if (lp[L_H1] >= 0) {
#pragma unroll
      for (int j = 0; j < RW; ++j) hd[j] = 0.f;
      for (int i = 0; i < AR; ++i) fma_row(hd, ws + lp[L_H1] + i * CP, j0, j0 + HW, wd.spare[i * TBS + col]);
#pragma unroll
      for (int j = 0; j < RW; ++j) hd[j] = hd[j] + ws[lp[L_H1B] + j0 + j];
      if (fo[H1_POST] >= 0) film_cols<RW>(hd, ws + fo[H1_POST], fsh[H1_POST] != 0, S, CP, cond, j0, j0 + HW);
    } else {
#pragma unroll
      for (int j = 0; j < RW; ++j) hd[j] = j0 + j < AR ? wd.spare[(j0 + j) * TBS + col] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RW; ++j)
      if (j0 + j < HI) wd.hacc[(j0 + j) * TBS + col] += hd[j];
  }
  __syncthreads();
}

// A conv with carried history outside the layer loop (head rechannel,
// post-head conv): out = W . [hacc(t - (K-1-k) d)]_k (+ b), (K cin, cout)
// weights; hacc's rows -> the ring; then the output becomes hacc.
__device__ void tail_conv(Wide& wd, const long long* tc) {
  const int K = (int)tc[T_K];
  const int d = (int)tc[T_D];
  const int cin = (int)tc[T_CIN];
  const int cout = (int)tc[T_COUT];
  const int M = (int)tc[T_M];
  const long long ring = tc[T_RING];
  const long long bo = tc[T_B];
  const float* w = wd.w + tc[T_W];
  const int R = (max(cin, cout) + RW - 1) / RW;
  for (int it = threadIdx.x; it < wd.TBS * R; it += blockDim.x) {
    const int col = it % wd.TBS, j0 = (it / wd.TBS) * RW;
    const Tile tl = item_tile(wd, col);
    float acc[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const Src src = tap_src(wd.hacc, wd.state, ring, M, cin, (K - 1 - k) * d, tl);
      const float* wk = w + (long long)k * cin * cout;
      for (int c = 0; c < cin; ++c) {
        const float* q = src.p + c * src.stride;
        const float v = src.live ? (tl.t < (K - 1 - k) * d ? ring_load(q) : *q) : 0.f;
#pragma unroll
        for (int j = 0; j < RW; ++j)
          if (j0 + j < cout) acc[j] += __ldg(wk + c * cout + j0 + j) * v;
      }
    }
    if (M > 0 && tl.valid) {
      float* dst = wd.state + ring + ((long long)(tl.n % M) * cin * tl.T + tl.t) * tl.B + tl.b;
#pragma unroll
      for (int j = 0; j < RW; ++j)
        if (j0 + j < cin) dst[(long long)(j0 + j) * tl.T * tl.B] = wd.hacc[(j0 + j) * wd.TBS + col];
    }
#pragma unroll
    for (int j = 0; j < RW; ++j)
      if (j0 + j < cout) wd.spare[(j0 + j) * wd.TBS + col] = bo >= 0 ? acc[j] + __ldg(wd.w + bo + j0 + j) : acc[j];
  }
  __syncthreads();
  swap_bufs(wd.hacc, wd.spare);
}

// Every row of the head accumulator: hacc = hs * hacc (head_scale), or the
// post-head activation (code >= 0) with its parameters.
__device__ void hacc_pass(Wide& wd, float hs, int code, const float* prm) {
  const int R = wd.rows / RW;
  for (int it = threadIdx.x; it < wd.TBS * R; it += blockDim.x) {
    const int col = it % wd.TBS, j0 = (it / wd.TBS) * RW;
    float v[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) v[j] = wd.hacc[(j0 + j) * wd.TBS + col];
    if (code < 0) {
#pragma unroll
      for (int j = 0; j < RW; ++j) v[j] = hs * v[j];
    } else {
      activate<RW>(v, code, code == ACT_PRELU_CHANNELS ? prm + j0 : prm);
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) wd.hacc[(j0 + j) * wd.TBS + col] = v[j];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
    stack_wide_kernel(const float* __restrict__ x, const float* __restrict__ cond_in, float* __restrict__ y,
                      float* __restrict__ state, const float* __restrict__ w, const long long* __restrict__ plan,
                      int T, int B, int n, int BS, int rows, int srows, int film_pre, int seg_max) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Wide wd;
  wd.w = w;
  wd.state = state;
  wd.arrays = plan + P_HEADER + plan[P_N_NETS] * NF;
  wd.tails = wd.arrays + plan[P_N_ARRAYS] * AF;
  wd.layers = wd.tails + plan[P_N_TAILS] * TF;
  wd.T = T;
  wd.B = B;
  wd.BS = BS;
  wd.TBS = T * BS;
  wd.n = n;
  wd.rows = rows;
  wd.srows = srows;
  const int TBS = wd.TBS;
  // [seg_max] the weight segment (seg_max 0: not staged), then the buffers.
  wd.wsm = seg_max > 0 ? smem : nullptr;
  smem += seg_max;
  wd.cur = smem;
  wd.spare = smem + rows * TBS;
  wd.hacc = smem + 2 * rows * TBS;
  wd.cbuf = smem + 3 * rows * TBS;
  wd.fbuf = film_pre ? wd.cbuf + srows * TBS : nullptr;

  const long long* nets = plan + P_HEADER;
  const int Cin = (int)plan[P_CIN];
  const int Cout = (int)plan[P_COUT];
  const int S_ext = (int)plan[P_S_EXT];
  const int n_nets = (int)plan[P_N_NETS];

  // The first net's condition: the pre-pass output, else the raw input.
  for (int it = threadIdx.x; it < TBS * srows; it += blockDim.x) {
    const int col = it % TBS, s = it / TBS;
    const Tile tl = item_tile(wd, col);
    float v = 0.f;
    if (tl.valid) {
      if (S_ext > 0) {
        if (s < S_ext) v = cond_in[((long long)s * T + tl.t) * B + tl.b];
      } else if (s < Cin) {
        v = x[((long long)s * T + tl.t) * B + tl.b];
      }
    }
    wd.cbuf[s * TBS + col] = v;
  }

  for (int ni = 0; ni < n_nets; ++ni) {
    const long long* np = nets + ni * NF;
    const int S = (int)np[N_S];
    // The head accumulator starts at 0 (the rechannel's sync orders this
    // before its first use).
    for (int i = threadIdx.x; i < rows * TBS; i += blockDim.x) wd.hacc[i] = 0.f;
    const int a0 = (int)np[N_FIRST_ARRAY];
    for (int a = a0; a < a0 + (int)np[N_ARRAYS]; ++a) {
      const long long* ap = wd.arrays + a * AF;
      rechannel(wd, ap, a == a0, x);  // every net reads the raw input
      const int first = (int)ap[A_FIRST];
      for (int li = 0; li < (int)ap[A_NL]; ++li) layer(wd, ap, wd.layers + (long long)(first + li) * LF, S);
      tail_conv(wd, wd.tails + ap[A_HR] * TF);  // head rechannel
    }
    // head_scale, then the post-stack head: repeated (activation -> conv).
    hacc_pass(wd, __ldg(w + np[N_HEAD_SCALE]), -1, nullptr);
    for (int ph = 0; ph < (int)np[N_PHEADS]; ++ph) {
      const long long* tc = wd.tails + (np[N_FIRST_PHEAD] + ph) * TF;
      if (tc[T_ACT] >= 0) hacc_pass(wd, 0.f, (int)tc[T_ACT], w + tc[T_PRM]);
      tail_conv(wd, tc);
    }
    // A condition net's output is the next net's condition; the last net's is y.
    const int out_rows = ni + 1 < n_nets ? min((int)np[N_COUT], srows) : Cout;
    for (int it = threadIdx.x; it < TBS * out_rows; it += blockDim.x) {
      const int col = it % TBS, o = it / TBS;
      const float v = wd.hacc[o * TBS + col];
      if (ni + 1 < n_nets) {
        wd.cbuf[o * TBS + col] = v;
      } else {
        const Tile tl = item_tile(wd, col);
        if (tl.valid) y[((long long)o * T + tl.t) * B + tl.b] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers (`cond` may be
// null: no pre-pass condition); `stream` is a cudaStream_t. `rows` and
// `srows` size the shared buffers (ops/cuda/stack.py `_wide_smem_bytes`),
// `film_pre` adds the conv_pre_film buffer, `seg_max` > 0 stages each
// layer's weight segment into shared memory, `threads` <= 512. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise and
// allocates nothing.
int nam_stack_wide_step(const void* x, const void* cond, void* y, void* state, const void* w, const void* plan,
                        int T, int B, int n, int BS, int rows, int srows, int film_pre, int seg_max, int threads,
                        int smem_bytes, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(stack_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (threads < 1 || threads > NT) return (int)cudaErrorInvalidValue;
  const int grid = (B + BS - 1) / BS;
  stack_wide_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cond), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<const float*>(w), static_cast<const long long*>(plan), T, B, n, BS,
      rows, srows, film_pre, seg_max);
  return (int)cudaGetLastError();
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
