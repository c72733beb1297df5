// Fused LSTM block step for Hopper (sm_90a): one launch runs the whole
// T-frame recurrence of every layer, and the head, for every stream.
//
// Replaces the TPU kernel `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/lstm.py (driven by `step`, the
// pl.pallas_call at lstm.py:208). What it computes, per frame t and layer l
// (reference: NAM/lstm.cpp:31-68, 103-125):
//   ifgo = W_l . [x_l; h_l] + b_l         gate order i, f, g, o
//   c_l' = sig(f) c_l + sig(i) tanh(g)
//   h_l' = sig(o) tanh(c_l')               x_{l+1} = h_l'
//   y(t) = head_W . h_{L-1}' + head_b
// with fast_sigmoid / fast_tanh when the launch's `fast` flag is set (global
// fast-tanh mode, reference: NAM/lstm.cpp:48-58).
//
// What bounds it on an H100: the recurrence is sequential in t, so the only
// parallelism is over streams and, inside a step, over the 4H gate rows. At
// 2 layers x H = 16 it needs 3,152 MACs per sample against 8 bytes of input
// and output per sample and 512 bytes of h and c per stream and block, so
// float32 arithmetic bounds it (about 197 us at B = 32,768, T = 64, at
// 67 TFLOP/s, against about 10 us of bytes).
//
// Design (first version: right and simple):
//   - one thread per stream, looping over t, the layers and the H units;
//     h of every layer stays in registers for the whole block (template on
//     the padded width HP and the layer count L, so every index into h is a
//     compile-time constant); c and the layer's new h live in the thread's
//     own column of shared memory, so the unit loop need not be unrolled; a
//     layer's old h is kept until all its units are updated;
//   - the weights (a few KB) are staged once into shared memory, packed so
//     that one float4 holds the i, f, g, o weights of one (unit, input) pair:
//     every thread reads the same address (a broadcast), and one load feeds
//     four FMAs;
//   - x and y in the (C, T, B) layout and the state in (L, H, B), streams
//     innermost: the warp's loads and stores are coalesced;
//   - the state update uses __fmul_rn / __fadd_rn, so it rounds as the plain
//     torch version does (no FMA contraction); sigmoid is 1 / (1 + expf(-z))
//     and tanh is tanhf, as torch's on the card. No fast-math.
// With one thread per stream, B = 2,048 is 64 warps on 132 SMs: a small
// batch leaves most of the card idle, and a warp's own dependency chain sets
// the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"  // sigmoid, fast_sigmoid, fast_tanh, stage

namespace {

constexpr int THREADS = 64;  // streams per CTA
constexpr int MAX_IN = 4;    // largest input channel count (ops/cuda/lstm.py MAX_IN)

__device__ __forceinline__ float gate_sig(float z, bool fast) { return fast ? fast_sigmoid(z) : sigmoid(z); }
__device__ __forceinline__ float gate_tanh(float z, bool fast) { return fast ? fast_tanh(z) : tanhf(z); }

// Packed weights (ops/cuda/lstm.py `_pack`), in float4 units:
//   layer 0:     HP rows of (1 + Cin + HP): [b][W_x k < Cin][W_h k < HP]
//   layer l > 0: HP rows of (1 + 2 HP):     [b][W_x k < HP][W_h k < HP]
//   each float4 = (i, f, g, o) of one unit j; rows j >= H are zero;
// then, in floats: head W (O, HP), head b (O, padded to 4).
//
// Shared memory: the weights (nw floats), then per thread c (L*HP) and the
// layer's new h (HP), stored [index][thread] so a warp's accesses fall in
// distinct banks.
template <int HP, int L>
__global__ void __launch_bounds__(THREADS) lstm_step_kernel(const float* __restrict__ x, float* __restrict__ y,
                                                            float* __restrict__ hs, float* __restrict__ cs,
                                                            const float* __restrict__ w, int T, int B, int Cin,
                                                            int H, int O, int nw, int fast_i) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* c_s = ws + nw;                  // [L * HP][THREADS]
  float* hn_s = c_s + L * HP * THREADS;  // [HP][THREADS]
  stage(ws, w, nw);
  __syncthreads();

  const int tid = threadIdx.x;
  const int b = blockIdx.x * THREADS + tid;
  if (b >= B) return;
  const bool fast = fast_i != 0;

  // h of every layer in registers (every index a compile-time constant after
  // unrolling); c in this thread's shared-memory column.
  float h[L][HP];
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int j = 0; j < HP; ++j) h[l][j] = j < H ? hs[((long long)l * H + j) * B + b] : 0.f;
    for (int j = 0; j < H; ++j) c_s[(l * HP + j) * THREADS + tid] = cs[((long long)l * H + j) * B + b];
  }

  const int r0 = 1 + Cin + HP;  // layer-0 row length
  constexpr int RL = 1 + 2 * HP;  // row length of the other layers
  const float4* w0 = smem4;
  const float4* wl = w0 + HP * r0;
  const float* hw = reinterpret_cast<const float*>(wl + (L - 1) * HP * RL);
  const float* hb = hw + O * HP;

  for (int t = 0; t < T; ++t) {
    float xin[MAX_IN];
#pragma unroll
    for (int k = 0; k < MAX_IN; ++k) xin[k] = k < Cin ? x[((long long)k * T + t) * B + b] : 0.f;

#pragma unroll
    for (int l = 0; l < L; ++l) {
      // Every unit reads the layer's old h (registers) and writes its new h
      // to shared memory; h is replaced once all H units are done.
      for (int j = 0; j < H; ++j) {
        float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f;
        float4 bv;
        if (l == 0) {
          const float4* row = w0 + j * r0;
          bv = row[0];
#pragma unroll
          for (int k = 0; k < MAX_IN; ++k) {
            if (k < Cin) {
              const float4 wv = row[1 + k];
              zi += wv.x * xin[k];
              zf += wv.y * xin[k];
              zg += wv.z * xin[k];
              zo += wv.w * xin[k];
            }
          }
          row += 1 + Cin;
#pragma unroll
          for (int k = 0; k < HP; ++k) {
            const float4 wv = row[k];
            zi += wv.x * h[0][k];
            zf += wv.y * h[0][k];
            zg += wv.z * h[0][k];
            zo += wv.w * h[0][k];
          }
        } else {
          // Input: layer l-1's new h (already replaced this frame).
          const int lp = l > 0 ? l - 1 : 0;  // a constant once the layer loop is unrolled
          const float4* row = wl + ((l - 1) * HP + j) * RL;
          bv = row[0];
#pragma unroll
          for (int k = 0; k < HP; ++k) {
            const float4 wv = row[1 + k];
            zi += wv.x * h[lp][k];
            zf += wv.y * h[lp][k];
            zg += wv.z * h[lp][k];
            zo += wv.w * h[lp][k];
          }
#pragma unroll
          for (int k = 0; k < HP; ++k) {
            const float4 wv = row[1 + HP + k];
            zi += wv.x * h[l][k];
            zf += wv.y * h[l][k];
            zg += wv.z * h[l][k];
            zo += wv.w * h[l][k];
          }
        }
        const float gi = gate_sig(zi + bv.x, fast);
        const float gf = gate_sig(zf + bv.y, fast);
        const float gg = gate_tanh(zg + bv.z, fast);
        const float go = gate_sig(zo + bv.w, fast);
        float* cp = c_s + (l * HP + j) * THREADS + tid;
        const float cn = __fadd_rn(__fmul_rn(gf, *cp), __fmul_rn(gi, gg));
        *cp = cn;
        hn_s[j * THREADS + tid] = __fmul_rn(go, gate_tanh(cn, fast));
      }
#pragma unroll
      for (int j = 0; j < HP; ++j) h[l][j] = j < H ? hn_s[j * THREADS + tid] : 0.f;
    }

    for (int o = 0; o < O; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < HP; ++j) acc += hw[o * HP + j] * h[L - 1][j];
      y[((long long)o * T + t) * B + b] = acc + hb[o];
    }
  }

#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int j = 0; j < HP; ++j)
      if (j < H) hs[((long long)l * H + j) * B + b] = h[l][j];
    for (int j = 0; j < H; ++j) cs[((long long)l * H + j) * B + b] = c_s[(l * HP + j) * THREADS + tid];
  }
}

template <int HP, int L>
cudaError_t launch(const float* x, float* y, float* h, float* c, const float* w, int T, int B, int Cin, int H, int O,
                   int nw, int fast, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(lstm_step_kernel<HP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = (B + THREADS - 1) / THREADS;
  const int smem = (nw + (L + 1) * HP * THREADS) * (int)sizeof(float);
  lstm_step_kernel<HP, L><<<grid, THREADS, smem, stream>>>(x, y, h, c, w, T, B, Cin, H, O, nw, fast);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers; h and c are
// (L, H, B) and are updated in place; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise and
// allocates nothing. (HP, L) must be one of the instances below: HP_TILES x
// 1..MAX_LAYERS in ops/cuda/lstm.py.
int nam_lstm_step(const void* x, void* y, void* h, void* c, const void* w, int T, int B, int Cin, int H, int O,
                  int nw, int HP, int L, int fast, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  float* cf = static_cast<float*>(c);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NAM_LSTM_CASE(hp, l) \
  if (HP == hp && L == l) return (int)launch<hp, l>(xf, yf, hf, cf, wf, T, B, Cin, H, O, nw, fast, st);
  NAM_LSTM_CASE(4, 1) NAM_LSTM_CASE(4, 2) NAM_LSTM_CASE(4, 3) NAM_LSTM_CASE(4, 4)
  NAM_LSTM_CASE(8, 1) NAM_LSTM_CASE(8, 2) NAM_LSTM_CASE(8, 3) NAM_LSTM_CASE(8, 4)
  NAM_LSTM_CASE(16, 1) NAM_LSTM_CASE(16, 2) NAM_LSTM_CASE(16, 3) NAM_LSTM_CASE(16, 4)
  NAM_LSTM_CASE(32, 1) NAM_LSTM_CASE(32, 2) NAM_LSTM_CASE(32, 3) NAM_LSTM_CASE(32, 4)
#undef NAM_LSTM_CASE
  return (int)cudaErrorInvalidValue;
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
