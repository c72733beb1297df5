// Fused LSTM block step for Hopper (sm_90a), for what csrc/lstm.cu's
// registers cannot hold: hidden sizes up to 64 (ops/cuda/lstm.py
// WIDE_MAX_HIDDEN; the loops here have no limit of their own), up to 8
// layers and up to 8 input channels.
//
// Replaces the same TPU kernel as lstm.cu: `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/lstm.py (driven by `step`, the
// pl.pallas_call at lstm.py:208), whose gate has no hidden-size or layer
// limit. It computes what lstm.cu computes, per frame t and layer l:
//   ifgo = W_l . [x_l; h_l] + b_l         gate order i, f, g, o
//   c_l' = sig(f) c_l + sig(i) tanh(g)
//   h_l' = sig(o) tanh(c_l')               x_{l+1} = h_l'
//   y(t) = head_W . h_{L-1}' + head_b
// with fast_sigmoid / fast_tanh under the global fast-tanh mode, on the same
// state layout, (L, H, B) with streams innermost. ops/cuda/lstm.py
// `_is_wide` says which models come here.
//
// Two kernels, both on the packed weights of ops/cuda/lstm.py `_pack_wide`
// and the state above; the wrapper picks one per model and batch
// (ops/cuda/lstm.py `_tile`) and names it in its Layout.
//
// The tile kernel (lstm_tile_kernel, nam_lstm_tile_step): the TPU kernel's
// own shape -- every layer's weights resident for a whole tile of streams
// (lstm.py:154-192 keeps them in VMEM for `w` streams). A CTA runs S
// streams:
//   - it copies the packed weights into shared memory once, with 16-byte
//     loads (113,092 bytes at 48 x 2), and keeps h and c of every layer and
//     the frame's input there for its S streams, streams innermost;
//   - a thread owns one unit j and SPT streams (SPT a template parameter,
//     1, 2 or 4); its 4 x SPT gate sums cost, per row k of the
//     (1 + I + H)-deep product, one shared float4 of (i, f, g, o) weights
//     and one shared vector of SPT inputs for 4 x SPT FMAs, in chunks of
//     16 / SPT rows whose loads go out together. Threads are numbered
//     stream-group fastest, so a warp's lanes read a few consecutive weight
//     float4s and their inputs as one contiguous run, free of bank conflicts;
//   - the thread applies the gates and the c/h update to the values it
//     owns; the new h goes to the other half of a ping-pong buffer of the
//     layer, so each (frame, layer) costs one __syncthreads();
//   - the next frame's input is loaded into a register while layer 0 runs
//     and stored into the other half of a double buffer after it;
//   - the head runs per frame, one thread per (output, stream).
// Every gate sum, the head's sum and the state update take the group
// kernel's order and rounding (the input rows, then the h rows, then the
// bias, each product fused into its sum), so the two kernels agree bit for
// bit. What bounds it on an H100: not the FMAs but shared memory. A warp's
// 16-byte load takes four of shared memory's 128-byte cycles even where its
// lanes share addresses, so a row costs a warp 4 + SPT cycles of it for
// SPT cycles of FMAs (on four sub-partitions): at 48 x 2, B = 2,048 (S = 16,
// SPT = 2, 12 warps an SM) the gate sums take about 75 cycles a row against
// 72 of shared memory, and the gate nonlinearities a fifth of the time
// (PERF.md). More streams a thread read fewer bytes a FMA but leave fewer
// warps to hide the loads' latency: the wrapper picks S and SPT from H and
// B by a rule fitted to a sweep of every tile (`_tile`,
// tools/lstm_tiles.py).
//
// The group kernel (lstm_wide_kernel, nam_lstm_wide_step) runs what the
// tile kernel's shared memory cannot hold (64 x 8: 992 KB of weights). Right
// and simple first: a group of G threads (8, 16 or 32 as the hidden size
// needs) runs one stream, lane g owning units g, g + G, ...; a CTA runs SPC
// = threads / G streams. Every phase is a loop over (stream, lane) items
// behind a __syncthreads():
//   - per frame and layer, each unit's four gate sums read the layer input
//     (x or the layer below's new h) and the layer's old h from the stream's
//     shared memory (one broadcast to the group), and the (i, f, g, o)
//     float4 of their weights from device memory through the read-only
//     cache: the weights are packed input-major (ops/cuda/lstm.py
//     `_pack_wide`), so a group's lanes read consecutive float4s;
//   - a unit's new c goes to shared memory (only its lane reads it), its new
//     h to a staging row that replaces the layer's h once every unit has
//     read the old one;
//   - the state update uses __fmul_rn / __fadd_rn, sigmoid is
//     1 / (1 + expf(-z)), tanh is tanhf: the rounding of lstm.cu and of the
//     plain torch version. No fast-math.
// What bounds both on an H100: the recurrence is sequential in t; inside a
// step the 4H gate rows of a stream are the parallelism. At 48 x 2 it needs
// 28.2k MACs per sample, so float32 operations bind it (about 110 us at
// B = 2,048, T = 64, at 67 TFLOP/s, against about 2 us of bytes). In the
// group kernel each MAC costs a quarter of a weight load from the read-only
// cache, and every frame and layer two syncs: it runs at a tenth of the
// float32 rate (PERF.md), which is what the tile kernel answers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"  // sigmoid, fast_sigmoid, fast_tanh

namespace {

constexpr int MAX_THREADS = 128;  // threads of a CTA (ops/cuda/lstm.py WIDE_THREADS)
constexpr int XW = 8;             // most input channels (ops/cuda/lstm.py WIDE_MAX_IN)

__device__ __forceinline__ float gate_sig(float z, bool fast) { return fast ? fast_sigmoid(z) : sigmoid(z); }
__device__ __forceinline__ float gate_tanh(float z, bool fast) { return fast ? fast_tanh(z) : tanhf(z); }

// Packed weights (ops/cuda/lstm.py `_pack_wide`), in float4 units: per
// layer, (1 + I_l + H) rows of H float4s, row 0 the bias, then W_x (I_l =
// Cin for layer 0, else H), then W_h; each float4 = (i, f, g, o) of unit j.
// Then, in floats: head W (O, H) and head b (O).
//
// Shared memory per stream: h (L*H), c (L*H), the new h of a layer (H), the
// frame's input (XW).
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_wide_kernel(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ hs,
                     float* __restrict__ cs, const float* __restrict__ w, int T, int B, int Cin, int H, int L, int O,
                     int G, int SPC, int fast_i) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int LH = L * H;
  const int per = 2 * LH + H + XW;  // floats per stream
  const bool fast = fast_i != 0;
  const int b0 = blockIdx.x * SPC;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float* hw = w + 4 * (long long)H * ((1 + Cin + H) + (L - 1) * (1 + 2 * H));
  const float* hb = hw + O * H;

  // h and c of every layer: (L, H, B) -> the stream's rows.
  for (int i = threadIdx.x; i < SPC * LH; i += blockDim.x) {
    const int s = i / LH, r = i % LH, b = b0 + s;
    float* st = sm + s * per;
    st[r] = b < B ? hs[(long long)r * B + b] : 0.f;
    st[LH + r] = b < B ? cs[(long long)r * B + b] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < SPC * XW; i += blockDim.x) {
      const int s = i / XW, k = i % XW, b = b0 + s;
      sm[s * per + 2 * LH + H + k] = (k < Cin && b < B) ? x[((long long)k * T + t) * B + b] : 0.f;
    }
    __syncthreads();
    long long off = 0;  // this layer's first float4
    for (int l = 0; l < L; ++l) {
      const int iw = l == 0 ? Cin : H;
      for (int i = threadIdx.x; i < SPC * G; i += blockDim.x) {
        const int s = i / G, lane = i % G;
        float* st = sm + s * per;
        const float* in = l == 0 ? st + 2 * LH + H : st + (l - 1) * H;  // the layer below's new h
        const float* hl = st + l * H;
        for (int j = lane; j < H; j += G) {
          const float4* col = w4 + off + j;
          float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f;
          for (int k = 0; k < iw; ++k) {
            const float4 wv = __ldg(col + (long long)(1 + k) * H);
            const float v = in[k];
            zi += wv.x * v;
            zf += wv.y * v;
            zg += wv.z * v;
            zo += wv.w * v;
          }
          for (int k = 0; k < H; ++k) {
            const float4 wv = __ldg(col + (long long)(1 + iw + k) * H);
            const float v = hl[k];
            zi += wv.x * v;
            zf += wv.y * v;
            zg += wv.z * v;
            zo += wv.w * v;
          }
          const float4 bv = __ldg(col);
          const float gi = gate_sig(zi + bv.x, fast);
          const float gf = gate_sig(zf + bv.y, fast);
          const float gg = gate_tanh(zg + bv.z, fast);
          const float go = gate_sig(zo + bv.w, fast);
          float* cp = st + LH + l * H + j;
          const float cn = __fadd_rn(__fmul_rn(gf, *cp), __fmul_rn(gi, gg));
          *cp = cn;
          st[2 * LH + j] = __fmul_rn(go, gate_tanh(cn, fast));
        }
      }
      __syncthreads();  // every unit has read the layer's old h
      for (int i = threadIdx.x; i < SPC * H; i += blockDim.x) {
        float* st = sm + (i / H) * per;
        st[l * H + i % H] = st[2 * LH + i % H];
      }
      __syncthreads();
      off += (long long)(1 + iw + H) * H;
    }
    for (int i = threadIdx.x; i < SPC * O; i += blockDim.x) {
      const int s = i / O, o = i % O, b = b0 + s;
      const float* top = sm + s * per + (L - 1) * H;
      float acc = 0.f;
      for (int j = 0; j < H; ++j) acc += __ldg(hw + o * H + j) * top[j];
      if (b < B) y[((long long)o * T + t) * B + b] = acc + __ldg(hb + o);
    }
    // The next frame's first write to shared memory (its input) is read only
    // after that frame's first sync; the head reads h, which is next written
    // after two more.
  }

  for (int i = threadIdx.x; i < SPC * LH; i += blockDim.x) {
    const int s = i / LH, r = i % LH, b = b0 + s;
    const float* st = sm + s * per;
    if (b < B) {
      hs[(long long)r * B + b] = st[r];
      cs[(long long)r * B + b] = st[LH + r];
    }
  }
}


// ---------------------------------------------------------------------------
// The tile kernel.

constexpr int TILE_MAX_THREADS = 512;  // ops/cuda/lstm.py TILE_MAX_THREADS

// SPT consecutive floats of shared memory, as float4s, a float2 or a float.
template <int SPT>
__device__ __forceinline__ void lds(float (&v)[SPT], const float* p) {
  if constexpr (SPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < SPT / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else if constexpr (SPT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    v[0] = p[0];
  }
}

template <int SPT>
__device__ __forceinline__ void sts(float* p, const float (&v)[SPT]) {
  if constexpr (SPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < SPT / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (SPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The FMAs of one row: z[gate][s] += w.gate * v[s].
template <int SPT>
__device__ __forceinline__ void fma_row(float (&z)[4][SPT], const float4& w, const float (&v)[SPT]) {
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    z[0][s] = __fmaf_rn(w.x, v[s], z[0][s]);
    z[1][s] = __fmaf_rn(w.y, v[s], z[1][s]);
    z[2][s] = __fmaf_rn(w.z, v[s], z[2][s]);
    z[3][s] = __fmaf_rn(w.w, v[s], z[3][s]);
  }
}

// z[gate][s] += sum over n rows k of w[k].gate * src[k][s], in order of k:
// w steps by H float4s a row, src by S floats. Rows go in chunks of U =
// 16 / SPT: a chunk's loads are issued together before its
// FMAs, and the loop is unrolled twice so that the compiler can overlap one
// chunk's loads with the other's FMAs (faster than a hand-written prefetch
// of the next chunk on 48 x 2, PERF.md); the rows after the last whole chunk
// go one by one.
template <int SPT>
__device__ __forceinline__ void gate_rows(float (&z)[4][SPT], const float4* w, int H, const float* src, int S,
                                          int n) {
  constexpr int U = 16 / SPT;
  int k = 0;
#pragma unroll 2
  for (; k + U <= n; k += U) {
    float4 wc[U];
    float vc[U][SPT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wc[u] = w[u * H];
      lds<SPT>(vc[u], src + u * S);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) fma_row<SPT>(z, wc[u], vc[u]);
    w += U * H;
    src += U * S;
  }
  for (; k < n; ++k) {
    float v[SPT];
    lds<SPT>(v, src);
    fma_row<SPT>(z, *w, v);
    w += H;
    src += S;
  }
}

// S streams per CTA, SPT per thread; NW floats of packed weights.
// Shared memory, in floats: the weights (NW rounded up to a multiple of 4),
// h (2, L, H, S) -- frame t reads half t & 1 and writes the other --, c
// (L, H, S), and the input (2, Cin, S), double-buffered the same way.
template <int SPT>
__global__ void __launch_bounds__(TILE_MAX_THREADS)
    lstm_tile_kernel(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ hs,
                     float* __restrict__ cs, const float* __restrict__ w, int T, int B, int Cin, int H, int L, int O,
                     int NW, int S, int fast_i) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int LHS = L * H * S;
  float* hbuf = ws + ((NW + 3) & ~3);
  float* cbuf = hbuf + 2 * LHS;
  float* xbuf = cbuf + LHS;
  const bool fast = fast_i != 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NG = S / SPT, items = H * NG, CS = Cin * S;
  const int b0 = blockIdx.x * S;
  const float* hw = ws + 4 * H * ((1 + Cin + H) + (L - 1) * (1 + 2 * H));  // head W (O, H), then b (O)

  // The weights, once.
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int i = tid; i < NW / 4; i += nt) smem4[i] = __ldg(w4 + i);
  for (int i = (NW & ~3) + tid; i < NW; i += nt) ws[i] = __ldg(w + i);
  // h (into half 0) and c of every layer: (L, H, B) -> (L, H, S).
  for (int i = tid; i < LHS; i += nt) {
    const int r = i / S, b = b0 + i % S;
    hbuf[i] = b < B ? hs[(long long)r * B + b] : 0.f;
    cbuf[i] = b < B ? cs[(long long)r * B + b] : 0.f;
  }
  // Frame 0's input (into half 0).
  for (int i = tid; i < CS; i += nt) {
    const int k = i / S, b = b0 + i % S;
    xbuf[i] = b < B ? x[(long long)k * T * B + b] : 0.f;
  }
  __syncthreads();

  const bool direct = CS <= nt;  // one input value a thread
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    const float* hold = hbuf + p * LHS;
    float* hnew = hbuf + (p ^ 1) * LHS;
    const bool more = t + 1 < T;
    float xr = 0.f;  // the next frame's input, loaded while layer 0 runs
    if (more && direct && tid < CS) {
      const int b = b0 + tid % S;
      if (b < B) xr = x[((long long)(tid / S) * T + t + 1) * B + b];
    }
    int off = 0;  // this layer's first float4
    for (int l = 0; l < L; ++l) {
      const int iw = l == 0 ? Cin : H;
      const float* in = l == 0 ? xbuf + p * CS : hnew + (l - 1) * H * S;
      const float* hl = hold + l * H * S;
      for (int it = tid; it < items; it += nt) {
        const int j = it / NG, s0 = (it % NG) * SPT;
        const float4* col = smem4 + off + j;
        float z[4][SPT];
#pragma unroll
        for (int s = 0; s < SPT; ++s) z[0][s] = z[1][s] = z[2][s] = z[3][s] = 0.f;
        gate_rows<SPT>(z, col + H, H, in + s0, S, iw);
        gate_rows<SPT>(z, col + (1 + iw) * H, H, hl + s0, S, H);
        const float4 bv = col[0];
        float* cp = cbuf + (l * H + j) * S + s0;
        float c[SPT], hn[SPT];
        lds<SPT>(c, cp);
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
          const float gi = gate_sig(z[0][s] + bv.x, fast);
          const float gf = gate_sig(z[1][s] + bv.y, fast);
          const float gg = gate_tanh(z[2][s] + bv.z, fast);
          const float go = gate_sig(z[3][s] + bv.w, fast);
          c[s] = __fadd_rn(__fmul_rn(gf, c[s]), __fmul_rn(gi, gg));
          hn[s] = __fmul_rn(go, gate_tanh(c[s], fast));
        }
        sts<SPT>(cp, c);
        sts<SPT>(hnew + (l * H + j) * S + s0, hn);
      }
      if (l == 0 && more) {  // the next frame's input, into the other half
        float* xn = xbuf + (p ^ 1) * CS;
        if (direct) {
          if (tid < CS) xn[tid] = xr;
        } else {
          for (int i = tid; i < CS; i += nt) {
            const int b = b0 + i % S;
            xn[i] = b < B ? x[((long long)(i / S) * T + t + 1) * B + b] : 0.f;
          }
        }
      }
      __syncthreads();  // the layer's new h is complete; the next layer reads it
      off += (1 + iw + H) * H;
    }
    // The head, per frame. Its h half is next written two frames on.
    const float* top = hnew + (L - 1) * H * S;
    for (int i = tid; i < O * S; i += nt) {
      const int o = i / S, s = i % S, b = b0 + s;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < H; ++j) acc = __fmaf_rn(hw[o * H + j], top[j * S + s], acc);
      if (b < B) y[((long long)o * T + t) * B + b] = acc + hw[O * H + o];
    }
  }

  const float* hfin = hbuf + (T & 1) * LHS;  // the last frame's half
  for (int i = tid; i < LHS; i += nt) {
    const int r = i / S, b = b0 + i % S;
    if (b < B) {
      hs[(long long)r * B + b] = hfin[i];
      cs[(long long)r * B + b] = cbuf[i];
    }
  }
}

template <int SPT>
int launch_tile(const void* x, void* y, void* h, void* c, const void* w, int T, int B, int Cin, int H, int L, int O,
                int NW, int S, int fast, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(lstm_tile_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int threads = H * (S / SPT);
  if (S < SPT || S % SPT || threads > TILE_MAX_THREADS || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + S - 1) / S;
  const int smem = (((NW + 3) & ~3) + S * (3 * L * H + 2 * Cin)) * (int)sizeof(float);
  lstm_tile_kernel<SPT><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(h), static_cast<float*>(c),
      static_cast<const float*>(w), T, B, Cin, H, L, O, NW, S, fast);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers; h and c are
// (L, H, B) and are updated in place; `stream` is a cudaStream_t. G threads
// run a stream, `threads` (a multiple of G, <= 128) a CTA. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise and
// allocates nothing.
int nam_lstm_wide_step(const void* x, void* y, void* h, void* c, const void* w, int T, int B, int Cin, int H, int L,
                       int O, int G, int threads, int fast, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(lstm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (G < 1 || threads < G || threads > MAX_THREADS || threads % G || Cin > XW) return (int)cudaErrorInvalidValue;
  const int spc = threads / G;
  const int grid = (B + spc - 1) / spc;
  const int smem = spc * (2 * L * H + H + XW) * (int)sizeof(float);
  lstm_wide_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(h), static_cast<float*>(c),
      static_cast<const float*>(w), T, B, Cin, H, L, O, G, spc, fast);
  return (int)cudaGetLastError();
}

// Launch one block step on the tile kernel: S streams a CTA (a multiple of
// SPT, 1, 2 or 4), H * S / SPT threads (<= 512), NW floats of packed
// weights (16-byte aligned), the rest as nam_lstm_wide_step. The shared
// memory it asks for is ops/cuda/lstm.py `_tile_smem_bytes`.
int nam_lstm_tile_step(const void* x, void* y, void* h, void* c, const void* w, int T, int B, int Cin, int H, int L,
                       int O, int NW, int S, int spt, int fast, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (spt) {
    case 1: return launch_tile<1>(x, y, h, c, w, T, B, Cin, H, L, O, NW, S, fast, st);
    case 2: return launch_tile<2>(x, y, h, c, w, T, B, Cin, H, L, O, NW, S, fast, st);
    case 4: return launch_tile<4>(x, y, h, c, w, T, B, Cin, H, L, O, NW, S, fast, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
