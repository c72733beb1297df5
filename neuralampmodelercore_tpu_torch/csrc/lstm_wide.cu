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
// state layout, (L, H, B) with streams innermost. ops/cuda/lstm.py sends a
// model here only when lstm.cu cannot run it.
//
// Design (right and simple first): a group of G threads (8, 16 or 32 as the
// hidden size needs) runs one stream, lane g owning units g, g + G, ...; a
// CTA runs SPC = threads / G streams. Every phase is a loop over (stream, lane)
// items behind a __syncthreads():
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
// What bounds it on an H100: the recurrence is sequential in t; inside a
// step the 4H gate rows of a stream are the parallelism. At 48 x 2 it needs
// 28.2k MACs per sample, so float32 operations bind it (about 110 us at
// B = 2,048, T = 64, at 67 TFLOP/s, against about 2 us of bytes); each MAC
// here costs a quarter of a weight load, and every frame and layer two
// syncs.

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

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
