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
// Design:
//   - one CTA per tile of BS streams over all T frames, its columns (frame,
//     stream); everything a row of another slice or another frame reads
//     lives in shared memory, [rows][T][BS]: the layer input (which is also
//     the residual), the activations, the head accumulator and the
//     condition; a layer is three phases behind one sync each (four with
//     conv_pre_film):
//       F: conv_pre_film's filmed layer input;
//       A: the dilated conv -> its sums in the activations buffer;
//       A's end: bias, mixin, FiLM, the activation or the gated pair -> the
//          activations, in place; the layer input's rows -> the ring;
//       B: layer1x1 and head1x1 over every activation row -> the residual,
//          in place, and the head accumulator;
//   - in A and B a thread holds a register tile of RT rows x FT columns (a
//     template instance each, picked by the wrapper): per weight row it
//     loads its RT weights once (RT/4 16-byte loads, one broadcast for the
//     warp, which takes one slice) and its FT inputs (lane + 32 f: one
//     conflict-free wavefront each), and issues RT * FT FMAs; four rows'
//     loads go before their FMAs. A's conv leaves its sums in the
//     activations buffer, and a pass of one column and RT rows an item ends
//     them there (bias, mixin, FiLM, activation, ring), so that code is not
//     repeated FT times nor called out of line (a call's stack frame does
//     not fit the L1 that the shared memory leaves);
//   - where they fit beside the buffers, A first stages the layer's taps of
//     lookback > 0 into shared memory ([K-1][C][T][BS]), so a ring tap is
//     read once a CTA and not once a slice, and the conv reads only shared
//     memory; else (the flagship at T = 1,024) each tap is read where it
//     lies, by one generic load for shared memory and the ring alike;
//   - each phase computes only the rows it produces: A the slices of the
//     conv's real rows (a gated slice takes RT/2 rows of each half, top at
//     [0, CP/2), gate at [CP/2, CP)) and of the layer input's rows for the
//     ring, B the slices of max(channels, head rows), and both sum over the
//     bottleneck's activation rows only (the padded rows' weights are zero);
//   - the threads loop over items (`it += blockDim.x`): nothing an item owns
//     outlives a phase in registers. The element-wise passes (rechannel,
//     tail convs, head passes) keep items of one column and RW rows;
//   - a layer's weight segment (66 KB at 64 rows) is staged into shared
//     memory by cp.async behind a sync, where it fits beside the buffers
//     (else it is read through the read-only cache);
//   - float32 FMA only, tanhf, no fast-math; every output's sum runs over
//     taps and channels in the order of stack.cu and of the plain version
//     (ops/cuda/stack.py step_plain), so a column tile changes no sum.
//
// What bounds it on an H100: the LARGE preset (64 then 32 channels, 11 + 11
// layers, dilations 1..1024) needs about 230k MACs per sample against about
// 400 KB of state traffic per stream and block at T = 64, so float32
// operations bind it (about 0.9 ms at B = 2048 at 67 TFLOP/s, ops/cuda/
// stack.py `work`). A warp's 16-byte shared load costs the SM's shared port
// 4 cycles even as a broadcast, so a tile of 8 x 4 spends 12 port cycles
// (two weight loads, four taps) on 32 FMAs a lane, against 17 on 16 with one
// column a thread. The flagship at T = 1,024 runs one stream per CTA (the
// three buffers of 16 rows and 1,024 frames take 192 KB), so its ring taps
// are not coalesced across streams.

#include <cuda_pipeline.h>

#include "stack.cuh"  // plan layout, Tile, Src, tap_src, activate

namespace {

constexpr int RW = 16;      // rows of an element-wise pass's item (ops/cuda/stack.py WIDE_RW)
constexpr int SW = 8;       // largest input / condition channel count (WIDE_MAX_IN)
constexpr int A_HI = 3;     // plan fields stack.cuh does not name: an array's head accumulator rows,
constexpr int A_BN = 9;     // its bottleneck (the activation rows of every layer),
constexpr int N_COUT = 3;   // a net's output channels

struct Wide {
  const float* w;
  float* wsm;  // the layer's weight segment in shared memory, where `staged`
  float* state;
  const long long* arrays;
  const long long* tails;
  const long long* layers;
  float* cur;    // [rows][TBS] the layer input, which is also the residual
  float* spare;  // [rows][TBS] activations; rechannel and tail outputs
  float* hacc;   // [rows][TBS] the head accumulator
  float* fbuf;   // [rows][TBS] conv_pre_film's filmed layer input (null: no layer has it)
  float* cbuf;   // [srows][TBS] the net's condition
  float* tbuf;   // [K-1][C][TBS] a layer's taps of lookback > 0 (null: not staged, read where they lie)
  int T, B, BS, TBS, n, rows, srows;
  bool staged;  // the weight segment is staged (else it is read from device memory)
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

// ---- the register tile of phases F, A and B ---------------------------------

// How a phase's items map to threads: the phase computes n_slices slices of
// RT rows over TBS columns; warp w takes slice w mod n_slices and lane l of
// it columns g 32 FT + l + 32 f, f < FT, g = w / n_slices: a warp's weight
// loads are one broadcast and its loads and stores of a row of the shared
// buffers one conflict-free wavefront. A column past TBS is loaded as
// column TBS - 1 and not written.
struct Map {
  int n_slices, n_items;
};

template <int FT>
__device__ __forceinline__ Map phase_map(int n_slices, int TBS) {
  return {n_slices, (TBS + 32 * FT - 1) / (32 * FT) * n_slices * 32};
}

template <int FT>
__device__ __forceinline__ void item_of(const Map& m, int it, int& s, int& col0) {
  const int w = it >> 5;
  s = w % m.n_slices;
  col0 = w / m.n_slices * 32 * FT + (it & 31);
}

// A weight row's four columns from cA + 4 o: from shared memory (SHW) or
// through the read-only cache.
template <bool SHW>
__device__ __forceinline__ float4 load4(const float* p) {
  return SHW ? *reinterpret_cast<const float4*>(p) : __ldg(reinterpret_cast<const float4*>(p));
}

// acc[f][j] += w[r][col_j] * v[r][f] for NR weight rows r in order (row r at
// w + r * ld; RT columns of a slice, RT/2 from cA and RT/2 from cB, 16-byte
// aligned) and FT inputs each: every row's weights are loaded before the
// first FMA.
template <int RT, int FT, int NR, bool SHW>
__device__ __forceinline__ void mac(float (&acc)[FT][RT], const float* w, int ld, int cA, int cB,
                                    const float (&v)[NR][FT]) {
  constexpr int H = RT / 2;
  float4 wa[NR][H / 4], wb[NR][H / 4];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
      wa[r][o4] = load4<SHW>(w + r * ld + cA + 4 * o4);
      wb[r][o4] = load4<SHW>(w + r * ld + cB + 4 * o4);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        acc[f][4 * o4 + 0] += wa[r][o4].x * v[r][f];
        acc[f][4 * o4 + 1] += wa[r][o4].y * v[r][f];
        acc[f][4 * o4 + 2] += wa[r][o4].z * v[r][f];
        acc[f][4 * o4 + 3] += wa[r][o4].w * v[r][f];
      }
    }
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        acc[f][H + 4 * o4 + 0] += wb[r][o4].x * v[r][f];
        acc[f][H + 4 * o4 + 1] += wb[r][o4].y * v[r][f];
        acc[f][H + 4 * o4 + 2] += wb[r][o4].z * v[r][f];
        acc[f][H + 4 * o4 + 3] += wb[r][o4].w * v[r][f];
      }
    }
  }
}

// The per-column ends of the phases. F's and A's run in passes of their
// own, one column and RT rows an item, so their activation code is not
// repeated FT times; B's per column of a tile.

// F for the RT rows from j0 of column col: the filmed layer input -> fbuf.
template <int RT>
__device__ __forceinline__ void f_col(const Wide& wd, const long long* lp, const float* ws, int C, int CP, int S,
                                      int j0, int col) {
  const int TBS = wd.TBS;
  float cond[SW], f[RT];
  load_cond(wd, col, S, cond);
#pragma unroll
  for (int j = 0; j < RT; ++j) f[j] = j0 + j < C ? wd.cur[(j0 + j) * TBS + col] : 0.f;
  film_cols<RT>(f, ws + lp[L_FILM + CONV_PRE], lp[L_SHIFT + CONV_PRE] != 0, S, CP, cond, j0, j0 + RT / 2);
#pragma unroll
  for (int j = 0; j < RT; ++j)
    if (j0 + j < C) wd.fbuf[(j0 + j) * TBS + col] = f[j];
}

// A after the conv, for slice s of column col (z: its conv sums): bias,
// mixin, FiLM, the activation or the gated pair -> the activations; the
// layer's (filmed) input rows [s RT, (s+1) RT) -> ring slot n mod M.
template <int RT>
__device__ __forceinline__ void a_col(const Wide& wd, const long long* lp, const float* ws, const float* tapbuf,
                                      int C, int CP, int S, int s, int cA, int cB, int col, float* z) {
  constexpr int H = RT / 2;
  const int TBS = wd.TBS;
  const int M = (int)lp[L_M];
  const int gating = (int)lp[L_GATING];
  const long long* fo = lp + L_FILM;
  const long long* fsh = lp + L_SHIFT;
  const Tile tl = item_tile(wd, col);
  const float* w_mix = ws + lp[L_MIX];  // (S, CP)
  float cond[SW];
  load_cond(wd, col, S, cond);
  const int act1 = (int)lp[L_ACT1];
  const float* prm1 = ws + lp[L_PRM1];
  if (lp[L_FEAT] == 0) {
    // A layer with no gating, FiLM or head1x1 takes its own short branch,
    // so the feature code's temporaries are not live around it (as
    // stack.cu's plain_layer_rest): z = (conv + b) + mixin . cond.
    const int o0 = s * RT;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      float m = 0.f;
#pragma unroll
      for (int q = 0; q < SW; ++q)
        if (q < S) m += w_mix[q * CP + o0 + j] * cond[q];
      z[j] = (z[j] + ws[lp[L_B] + o0 + j]) + m;
    }
    activate<RT>(z, act1, act1 == ACT_PRELU_CHANNELS ? prm1 + o0 : prm1);
#pragma unroll
    for (int j = 0; j < RT; ++j) wd.spare[(o0 + j) * TBS + col] = z[j];
  } else {
#pragma unroll
    for (int j = 0; j < RT; ++j) z[j] = z[j] + ws[lp[L_B] + col_of<RT>(j, cA, cB)];
    if (fo[CONV_POST] >= 0) film_cols<RT>(z, ws + fo[CONV_POST], fsh[CONV_POST] != 0, S, CP, cond, cA, cB);
    {
      float mi[SW];
#pragma unroll
      for (int q = 0; q < SW; ++q) mi[q] = cond[q];
      if (fo[MIXIN_PRE] >= 0) film_cols<SW>(mi, ws + fo[MIXIN_PRE], fsh[MIXIN_PRE] != 0, S, SW, cond, 0, SW / 2);
      float m[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int o = col_of<RT>(j, cA, cB);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < SW; ++q)
          if (q < S) acc += w_mix[q * CP + o] * mi[q];
        m[j] = acc;
      }
      if (fo[MIXIN_POST] >= 0) film_cols<RT>(m, ws + fo[MIXIN_POST], fsh[MIXIN_POST] != 0, S, CP, cond, cA, cB);
#pragma unroll
      for (int j = 0; j < RT; ++j) z[j] = z[j] + m[j];
    }
    if (fo[ACT_PRE] >= 0) film_cols<RT>(z, ws + fo[ACT_PRE], fsh[ACT_PRE] != 0, S, CP, cond, cA, cB);
    if (gating == 0) {
      // Per-channel slopes are indexed by row; the other codes' parameters are shared.
      activate<RT>(z, act1, act1 == ACT_PRELU_CHANNELS ? prm1 + cA : prm1);
      if (fo[ACT_POST] >= 0) film_cols<RT>(z, ws + fo[ACT_POST], fsh[ACT_POST] != 0, S, CP, cond, cA, cB);
#pragma unroll
      for (int j = 0; j < RT; ++j) wd.spare[col_of<RT>(j, cA, cB) * TBS + col] = z[j];
    } else {
      const int act2 = (int)lp[L_ACT2];
      const float* prm2 = ws + lp[L_PRM2];
      const int a0 = s * H;  // rows of the activations this slice computes
      float top[H], gate[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        top[j] = z[j];
        gate[j] = z[H + j];
      }
      activate<H>(top, act1, act1 == ACT_PRELU_CHANNELS ? prm1 + a0 : prm1);
      activate<H>(gate, act2, act2 == ACT_PRELU_CHANNELS ? prm2 + a0 : prm2);
#pragma unroll
      for (int j = 0; j < H; ++j)
        top[j] = gating == GATED ? top[j] * gate[j] : gate[j] * top[j] + (1.f - gate[j]) * z[j];
      if (fo[ACT_POST] >= 0) film_cols<H>(top, ws + fo[ACT_POST], fsh[ACT_POST] != 0, S, CP, cond, a0, a0 + H / 2);
#pragma unroll
      for (int j = 0; j < H; ++j) wd.spare[(a0 + j) * TBS + col] = top[j];
    }
  }
  // The layer's (filmed) input becomes history: ring slot n mod M.
  if (M > 0 && tl.valid) {
    const int j0 = s * RT;
    float* dst = wd.state + lp[L_RING] + ((long long)(tl.n % M) * C * tl.T + tl.t) * tl.B + tl.b;
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (j0 + j < C) dst[(long long)(j0 + j) * tl.T * tl.B] = tapbuf[(j0 + j) * TBS + col];
  }
}

// B's ends for the RT rows from j0 of column col: layer1x1's (v: its sums)
// + bias [, FiLM] -> the residual; head1x1's + bias [, FiLM] -> the head
// accumulator.
template <int RT>
__device__ __forceinline__ void l1_col(const Wide& wd, const long long* lp, const float* ws, int C, int CP, int S,
                                       int j0, int col, float* v) {
  const int TBS = wd.TBS;
#pragma unroll
  for (int j = 0; j < RT; ++j) v[j] = v[j] + ws[lp[L_L1B] + j0 + j];
  if (lp[L_GATING] == BLENDED && lp[L_FILM + L1_POST] >= 0) {
    float cond[SW];
    load_cond(wd, col, S, cond);
    film_cols<RT>(v, ws + lp[L_FILM + L1_POST], lp[L_SHIFT + L1_POST] != 0, S, CP, cond, j0, j0 + RT / 2);
  }
#pragma unroll
  for (int j = 0; j < RT; ++j)
    if (j0 + j < C) wd.cur[(j0 + j) * TBS + col] = wd.cur[(j0 + j) * TBS + col] + v[j];
}

template <int RT>
__device__ __forceinline__ void h1_col(const Wide& wd, const long long* lp, const float* ws, int HI, int CP, int S,
                                       int j0, int col, float* v) {
  const int TBS = wd.TBS;
#pragma unroll
  for (int j = 0; j < RT; ++j) v[j] = v[j] + ws[lp[L_H1B] + j0 + j];
  if (lp[L_FILM + H1_POST] >= 0) {
    float cond[SW];
    load_cond(wd, col, S, cond);
    film_cols<RT>(v, ws + lp[L_FILM + H1_POST], lp[L_SHIFT + H1_POST] != 0, S, CP, cond, j0, j0 + RT / 2);
  }
#pragma unroll
  for (int j = 0; j < RT; ++j)
    if (j0 + j < HI) wd.hacc[(j0 + j) * TBS + col] += v[j];
}

// The layer's taps of lookback (K-1-k) d > 0, k < K-1, staged for phase A:
// tbuf[(k C + c) TBS + col] is frame t - (K-1-k) d of channel c at column
// col, this block's from `tapbuf`, earlier ones from the ring. So the conv
// reads every tap from shared memory, and a ring tap once a CTA, not once a
// slice. A thread takes one (tap, column) and 16 channels; ring taps are
// copied by cp.async, all of a thread's in flight at once; the wait also
// covers the layer's weights, whose copies `layer` issued.
__device__ void stage_taps(const Wide& wd, const long long* lp, const float* tapbuf, int C) {
  constexpr int U = 16;
  const int K = (int)lp[L_K];
  const int d = (int)lp[L_D];
  const int M = (int)lp[L_M];
  const int TBS = wd.TBS;
  const int CG = (C + U - 1) / U;
  for (int it = threadIdx.x; it < (K - 1) * CG * TBS; it += blockDim.x) {
    const int col = it % TBS, kg = it / TBS;
    const int k = kg / CG, c0 = kg % CG * U;
    const Tile tl = item_tile(wd, col);
    const int a = (K - 1 - k) * d;
    const Src src = tap_src(tapbuf, wd.state, lp[L_RING], M, C, a, tl);
    float* dst = wd.tbuf + ((long long)k * C + c0) * TBS + col;
    if (src.live && tl.t < a) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + u < C) __pipeline_memcpy_async(dst + u * TBS, src.p + (c0 + u) * src.stride, 4);
    } else {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = (src.live && c0 + u < C) ? src.p[(c0 + u) * src.stride] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + u < C) dst[u * TBS] = v[u];
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// F: conv_pre_film over the layer input's slices, one column an item.
template <int RT>
__device__ void phase_f(const Wide& wd, const long long* lp, const float* ws, int C, int CP, int S, int n_slices) {
  for (int it = threadIdx.x; it < n_slices * wd.TBS; it += blockDim.x)
    f_col<RT>(wd, lp, ws, C, CP, S, it / wd.TBS * RT, it % wd.TBS);
}

// A: the conv of slice s's rows for FT columns. Tap k reads lookback
// (K-1-k) d: from the staged taps (the last tap, lookback 0, from
// `tapbuf`), or where they lie: this block's frames from `tapbuf`, earlier
// ones from the ring. Four channels' loads are issued before their FMAs (as
// stack.cuh).
template <int RT, int FT, bool SHW>
__device__ void phase_a(const Wide& wd, const long long* lp, const float* ws, const float* tapbuf, int C, int CP,
                        int S, int n_slices) {
  constexpr int H = RT / 2;
  const int K = (int)lp[L_K];
  const int d = (int)lp[L_D];
  const int M = (int)lp[L_M];
  const int gating = (int)lp[L_GATING];
  const int TBS = wd.TBS;
  if (wd.tbuf) {
    stage_taps(wd, lp, tapbuf, C);
    __syncthreads();
  }
  const Map m = phase_map<FT>(n_slices, TBS);
  for (int it = threadIdx.x; it < m.n_items; it += blockDim.x) {
    int s, col0;
    item_of<FT>(m, it, s, col0);
    const int cA = gating ? s * H : s * RT;
    const int cB = gating ? CP / 2 + s * H : s * RT + H;
    float z[FT][RT];
#pragma unroll
    for (int f = 0; f < FT; ++f)
#pragma unroll
      for (int j = 0; j < RT; ++j) z[f][j] = 0.f;
    if (wd.tbuf) {
      int col[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) col[f] = min(col0 + 32 * f, TBS - 1);
      for (int k = 0; k < K; ++k) {
        const float* src = k < K - 1 ? wd.tbuf + k * C * TBS : tapbuf;
        const float* wk = ws + k * C * CP;
        int c0 = 0;
        for (; c0 + 4 <= C; c0 += 4) {
          float v[4][FT];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int f = 0; f < FT; ++f) v[j][f] = src[(c0 + j) * TBS + col[f]];
          mac<RT, FT, 4, SHW>(z, wk + c0 * CP, CP, cA, cB, v);
        }
        for (; c0 < C; ++c0) {
          float v[1][FT];
#pragma unroll
          for (int f = 0; f < FT; ++f) v[0][f] = src[c0 * TBS + col[f]];
          mac<RT, FT, 1, SHW>(z, wk + c0 * CP, CP, cA, cB, v);
        }
      }
    } else {
      // Each tap where it lies: one generic load serves the shared layer
      // input and the ring alike, so the loads of a group need no branch.
      Tile tl[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) tl[f] = item_tile(wd, min(col0 + 32 * f, TBS - 1));
      for (int k = 0; k < K; ++k) {
        const int a = (K - 1 - k) * d;
        const float* q[FT];
        long long stride[FT];
        bool live[FT];
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const Src src = tap_src(tapbuf, wd.state, lp[L_RING], M, C, a, tl[f]);
          q[f] = src.p;
          stride[f] = src.stride;
          live[f] = src.live;
        }
        const float* wk = ws + k * C * CP;
        int c0 = 0;
        for (; c0 + 4 <= C; c0 += 4) {
          float v[4][FT];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int f = 0; f < FT; ++f) {
              v[j][f] = live[f] ? *q[f] : 0.f;
              q[f] += stride[f];
            }
          }
          mac<RT, FT, 4, SHW>(z, wk + c0 * CP, CP, cA, cB, v);
        }
        for (; c0 < C; ++c0) {
          float v[1][FT];
#pragma unroll
          for (int f = 0; f < FT; ++f) {
            v[0][f] = live[f] ? *q[f] : 0.f;
            q[f] += stride[f];
          }
          mac<RT, FT, 1, SHW>(z, wk + c0 * CP, CP, cA, cB, v);
        }
      }
    }
    // The conv's sums go to their rows of the activations buffer (which A
    // does not read); the pass after the next sync ends them there.
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (col0 + 32 * f < TBS) {
#pragma unroll
        for (int j = 0; j < RT; ++j) wd.spare[col_of<RT>(j, cA, cB) * TBS + col0 + 32 * f] = z[f][j];
      }
    }
  }
}

// A's end, one column and slice an item: its conv sums from the activations
// buffer through a_col, which writes the slice's activations over them (a
// gated slice's activation rows are its top half's).
template <int RT>
__device__ void phase_a_end(const Wide& wd, const long long* lp, const float* ws, const float* tapbuf, int C, int CP,
                            int S, int n_slices) {
  constexpr int H = RT / 2;
  const int gating = (int)lp[L_GATING];
  for (int it = threadIdx.x; it < n_slices * wd.TBS; it += blockDim.x) {
    const int col = it % wd.TBS, s = it / wd.TBS;
    const int cA = gating ? s * H : s * RT;
    const int cB = gating ? CP / 2 + s * H : s * RT + H;
    float z[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) z[j] = wd.spare[col_of<RT>(j, cA, cB) * wd.TBS + col];
    a_col<RT>(wd, lp, ws, tapbuf, C, CP, S, s, cA, cB, col, z);
  }
}

// B: layer1x1 (slices below C) and head1x1 or the activations (slices below
// HI) of slice s's rows for FT columns, each a sum over the BN activation rows.
template <int RT, int FT, bool SHW>
__device__ void phase_b(const Wide& wd, const long long* lp, const float* ws, int C, int CP, int HI, int BN, int S,
                        int n_slices) {
  constexpr int H = RT / 2;
  const int TBS = wd.TBS;
  const Map m = phase_map<FT>(n_slices, TBS);
  for (int it = threadIdx.x; it < m.n_items; it += blockDim.x) {
    int s, col0;
    item_of<FT>(m, it, s, col0);
    const int j0 = s * RT;
    int col[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) col[f] = min(col0 + 32 * f, TBS - 1);
    for (int pass = 0; pass < 2; ++pass) {
      const long long wo = lp[pass == 0 ? L_L1 : L_H1];
      if (pass == 1 && j0 < HI && wo < 0) {
        // No head1x1: the activations themselves go to the head accumulator.
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          if (col0 + 32 * f < TBS) {
#pragma unroll
            for (int j = 0; j < RT; ++j)
              if (j0 + j < HI) wd.hacc[(j0 + j) * TBS + col[f]] += wd.spare[(j0 + j) * TBS + col[f]];
          }
        }
      }
      if (wo < 0 || j0 >= (pass == 0 ? C : HI)) continue;
      float acc[FT][RT];
#pragma unroll
      for (int f = 0; f < FT; ++f)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[f][j] = 0.f;
      int i0 = 0;
      for (; i0 + 4 <= BN; i0 += 4) {
        float v[4][FT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int f = 0; f < FT; ++f) v[i][f] = wd.spare[(i0 + i) * TBS + col[f]];
        mac<RT, FT, 4, SHW>(acc, ws + wo + i0 * CP, CP, j0, j0 + H, v);
      }
      for (; i0 < BN; ++i0) {
        float v[1][FT];
#pragma unroll
        for (int f = 0; f < FT; ++f) v[0][f] = wd.spare[i0 * TBS + col[f]];
        mac<RT, FT, 1, SHW>(acc, ws + wo + i0 * CP, CP, j0, j0 + H, v);
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        if (col0 + 32 * f < TBS) {
          float vf[RT];
#pragma unroll
          for (int j = 0; j < RT; ++j) vf[j] = acc[f][j];
          if (pass == 0)
            l1_col<RT>(wd, lp, ws, C, CP, S, j0, col[f], vf);
          else
            h1_col<RT>(wd, lp, ws, HI, CP, S, j0, col[f], vf);
        }
      }
    }
  }
}

// A layer's phases F, A, A's end and B (see the header), a sync after each;
// SHW: its weight segment `ws` is in shared memory.
template <int RT, int FT, bool SHW>
__device__ __forceinline__ void phases(const Wide& wd, const long long* ap, const long long* lp, const float* ws,
                                       int S) {
  constexpr int H = RT / 2;
  const int C = (int)ap[A_C];
  const int CP = (int)ap[A_CP];
  const int HI = (int)ap[A_HI];
  const int BN = (int)ap[A_BN];
  const int gating = (int)lp[L_GATING];
  // The weights' copies are in flight: A's tap staging waits for both at
  // once; F, or A without staged taps, waits for them first.
  if (lp[L_FILM + CONV_PRE] >= 0 || !wd.tbuf) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  // The taps and the ring see the filmed input; the residual keeps the raw one.
  const int n_c = (C + RT - 1) / RT;  // slices of the layer input's rows
  const float* tapbuf = wd.cur;
  if (lp[L_FILM + CONV_PRE] >= 0) {
    phase_f<RT>(wd, lp, ws, C, CP, S, n_c);
    __syncthreads();
    tapbuf = wd.fbuf;
  }
  const int n_a = max(gating ? (BN + H - 1) / H : (BN + RT - 1) / RT, n_c);
  phase_a<RT, FT, SHW>(wd, lp, ws, tapbuf, C, CP, S, n_a);
  __syncthreads();
  phase_a_end<RT>(wd, lp, ws, tapbuf, C, CP, S, n_a);
  __syncthreads();
  phase_b<RT, FT, SHW>(wd, lp, ws, C, CP, HI, BN, S, (max(lp[L_L1] >= 0 ? C : 0, HI) + RT - 1) / RT);
  __syncthreads();
}

// One layer: its weight segment copied into shared memory by cp.async
// where it fits (the previous layer's last sync retired its reads; the
// phases wait for the copies), then its phases.
template <int RT, int FT>
__device__ void layer(Wide& wd, const long long* ap, const long long* lp, int S) {
  const float* ws = wd.w + lp[L_SEG];
  if (wd.staged) {
    for (int i = threadIdx.x; i < (int)lp[L_SEG_LEN] / 4; i += blockDim.x)
      __pipeline_memcpy_async(wd.wsm + 4 * i, ws + 4 * i, 16);
    __pipeline_commit();
    phases<RT, FT, true>(wd, ap, lp, wd.wsm, S);
  } else {
    phases<RT, FT, false>(wd, ap, lp, ws, S);
  }
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

// The kernel, one instance per register tile: RT rows x FT columns a thread
// in phases F, A and B, at most NT threads.
template <int RT, int FT, int NT>
__global__ void __launch_bounds__(NT)
    stack_wide_kernel(const float* __restrict__ x, const float* __restrict__ cond_in, float* __restrict__ y,
                      float* __restrict__ state, const float* __restrict__ w, const long long* __restrict__ plan,
                      int T, int B, int n, int BS, int rows, int srows, int film_pre, int seg_max, int tap_max) {
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
  wd.wsm = smem;
  wd.staged = seg_max > 0;
  smem += seg_max;
  wd.cur = smem;
  wd.spare = smem + rows * TBS;
  wd.hacc = smem + 2 * rows * TBS;
  wd.cbuf = smem + 3 * rows * TBS;
  wd.fbuf = film_pre ? wd.cbuf + srows * TBS : nullptr;
  wd.tbuf = tap_max > 0 ? wd.cbuf + (srows + (film_pre ? rows : 0)) * TBS : nullptr;

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
      for (int li = 0; li < (int)ap[A_NL]; ++li) layer<RT, FT>(wd, ap, wd.layers + (long long)(first + li) * LF, S);
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

// An instance with its shared-memory limit raised (once).
template <int RT, int FT, int NT>
cudaError_t ready() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(stack_wide_kernel<RT, FT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaSuccess;
}

// The runtime's count of an instance's CTAs one SM holds at once (0 on an error).
template <int RT, int FT, int NT>
int ctas_per_sm(int threads, int smem_bytes) {
  int n = 0;
  if (ready<RT, FT, NT>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stack_wide_kernel<RT, FT, NT>, threads, smem_bytes) !=
          cudaSuccess)
    return 0;
  return n;
}

// One instance's launch.
template <int RT, int FT, int NT>
int launch(const void* x, const void* cond, void* y, void* state, const void* w, const void* plan, int T, int B, int n,
           int BS, int rows, int srows, int film_pre, int seg_max, int tap_max, int threads, int smem_bytes,
           void* stream) {
  const cudaError_t e = ready<RT, FT, NT>();
  if (e != cudaSuccess) return (int)e;
  if (threads < 1 || threads > NT) return (int)cudaErrorInvalidValue;
  const int grid = (B + BS - 1) / BS;
  stack_wide_kernel<RT, FT, NT><<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cond), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<const float*>(w), static_cast<const long long*>(plan), T, B, n, BS,
      rows, srows, film_pre, seg_max, tap_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers (`cond` may be
// null: no pre-pass condition); `stream` is a cudaStream_t. `rows` and
// `srows` size the shared buffers (ops/cuda/stack.py `_wide_smem_bytes`),
// `film_pre` adds the conv_pre_film buffer, `seg_max` > 0 stages each
// layer's weight segment into shared memory, `tap_max` > 0 (floats: the most
// (K-1) C T BS of a layer) stages each layer's taps, (rt, ft) names the register
// tile (ops/cuda/stack.py WIDE_TILES) and `threads` is at most its
// instance's. Returns the cudaError_t of the launch (0 on success; an
// unknown tile or too many threads: cudaErrorInvalidValue). Does not
// synchronise and allocates nothing.
int nam_stack_wide_step(const void* x, const void* cond, void* y, void* state, const void* w, const void* plan,
                        int T, int B, int n, int BS, int rows, int srows, int film_pre, int seg_max, int tap_max,
                        int threads, int smem_bytes, int rt, int ft, void* stream) {
  if (rt == 8 && ft == 2)
    return launch<8, 2, 512>(x, cond, y, state, w, plan, T, B, n, BS, rows, srows, film_pre, seg_max, tap_max,
                             threads, smem_bytes, stream);
  if (rt == 8 && ft == 4)
    return launch<8, 4, 256>(x, cond, y, state, w, plan, T, B, n, BS, rows, srows, film_pre, seg_max, tap_max,
                             threads, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the (rt, ft) instance one SM holds at `threads` threads and
// `smem_bytes` of shared memory, as the CUDA runtime counts them (0: an
// unknown tile or an error); ops/cuda/stack.py `wide_ctas_per_sm` mirrors it.
int nam_stack_wide_ctas_per_sm(int rt, int ft, int threads, int smem_bytes) {
  if (rt == 8 && ft == 2) return ctas_per_sm<8, 2, 512>(threads, smem_bytes);
  if (rt == 8 && ft == 4) return ctas_per_sm<8, 4, 256>(threads, smem_bytes);
  return 0;
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
