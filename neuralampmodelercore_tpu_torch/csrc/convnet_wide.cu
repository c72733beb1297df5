// Fused ConvNet block step for Hopper (sm_90a), for what csrc/convnet.cu's
// register tile cannot hold: up to 128 channels, blocks of up to 1,024
// frames, and PReLU with a slope per channel.
//
// Replaces the same TPU kernel as convnet.cu: `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/convnet.py (driven by `step`, the
// pl.pallas_call at convnet.py:458), whose gate has no channel limit and
// takes any activation. It computes what convnet.cu computes, per layer
//   z  = sum_k W_k . h(t - (K-1-k) d);  z = z * mul + add;  h' = act(z)
//   ring[n mod M] <- h
// and y = head_W . h + head_b, on the same plan, the same packed weights
// (padded to a multiple of WIDE_RW rows) and the same state; the activation
// may be PReLU with one slope per channel (`activate`, activations.cuh).
// ops/cuda/convnet.py sends a model here only when convnet.cu cannot run it.
//
// Design (right and simple first; the design of csrc/stack_wide.cu): one CTA
// per tile of BS streams over all T frames; its threads loop over items of
// one (frame, stream, slice of RW output rows), so a thread may run several
// frames; the layer input and the layer output live in shared memory,
// [rows][T][BS], one sync per layer; a layer's weights are staged into
// shared memory where they fit (else read from device memory), a warp's
// loads one broadcast; ring taps go through L2 only. float32 FMA only, the
// affine rounded as the plain version rounds it (__fmul_rn, __fadd_rn),
// tanhf, no fast-math.
//
// What bounds it on an H100: at 64 channels and T = 64 a ConvNet of 10
// layers needs about 82k MACs per sample against about 165 KB of state and
// I/O per stream and block, so float32 operations bind it. The amp ConvNet
// at T = 1,024 (16 channels) runs one stream per CTA: its two buffers take
// 128 KB, and its ring taps are not coalesced across streams.

#include "convnet.cuh"  // plan layout; activations.cuh: activate

namespace {

constexpr int RW = 16;   // rows of one item's slice (ops/cuda/convnet.py WIDE_RW)
constexpr int NT = 512;  // most threads of a CTA

__global__ void __launch_bounds__(NT)
    convnet_wide_kernel(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ state,
                        const float* __restrict__ w, const long long* __restrict__ plan, int T, int B, int n, int BS,
                        int rows, int CP, int seg_max) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);  // [seg_max] the layer's weights (seg_max 0: not staged)
  float* cur = wsm + seg_max;                     // [rows][T][BS] the layer input
  float* nxt = cur + rows * T * BS;               // [rows][T][BS] its output
  const int TBS = T * BS;
  const int L = (int)plan[P_N_LAYERS];
  const int Cin = (int)plan[P_CIN];
  const int C = (int)plan[P_C];
  const int Cout = (int)plan[P_COUT];
  const int act = (int)plan[P_ACT];
  const float* prm = w + plan[P_ACT_PRM];
  const long long* layers = plan + P_HEADER;

  // Layer 0 reads x.
  for (int it = threadIdx.x; it < TBS * Cin; it += blockDim.x) {
    const int col = it % TBS, c = it / TBS;
    const int t = col / BS, b = blockIdx.x * BS + col % BS;
    cur[c * TBS + col] = b < B ? x[((long long)c * T + t) * B + b] : 0.f;
  }
  __syncthreads();

  for (int li = 0; li < L; ++li) {
    const long long* lp = layers + (long long)li * LF;
    const int K = (int)lp[L_K];
    const int d = (int)lp[L_D];
    const int M = (int)lp[L_M];
    const long long ring = lp[L_RING];
    const int cin = (int)lp[L_CIN];
    // Segment layout (ops/cuda/convnet.py _build_layout): conv (K*cin, CP), mul (CP), add (CP),
    // staged into shared memory behind a sync where it fits (the last sync
    // retired the previous layer's reads).
    const float* w_conv = w + lp[L_SEG];
    if (seg_max > 0) {
      stage(wsm, w_conv, (int)lp[L_SEG_LEN]);
      __syncthreads();
      w_conv = wsm;
    }
    const float* w_mul = w_conv + K * cin * CP;
    const float* w_add = w_mul + CP;
    const int nM = M > 0 ? n % M : 0;
    const int R = (max(cin, C) + RW - 1) / RW;
    for (int it = threadIdx.x; it < TBS * R; it += blockDim.x) {
      const int col = it % TBS, j0 = (it / TBS) * RW;
      const int t = col / BS, bl = col % BS;
      const int b = blockIdx.x * BS + bl;
      const bool valid = b < B;
      float z[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) z[j] = 0.f;
      for (int k = 0; k < K; ++k) {
        const int s = t - (K - 1 - k) * d;
        const float* src;
        long long stride;
        bool live = true;
        if (s >= 0) {
          src = cur + s * BS + bl;
          stride = TBS;
        } else {
          const int m = (T - 1 - s) / T;  // blocks back: ceil(-s / T), <= M - 1
          const int pos = s + m * T;
          const int slot = (nM - m + M) % M;
          src = state + ring + ((long long)slot * cin * T + pos) * B + b;
          stride = (long long)T * B;
          live = valid;
        }
        const float* wk = w_conv + k * cin * CP + j0;
        // Four channels' loads are issued before their FMAs (as stack.cuh).
        for (int c0 = 0; c0 < cin; c0 += 4) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // A ring tap goes through L2 only: streaming the rings must not evict L1.
            const float* p = src + (c0 + q) * stride;
            v[q] = (live && c0 + q < cin) ? (s < 0 ? __ldcg(p) : *p) : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c0 + q < cin) {
              const float4* wr = reinterpret_cast<const float4*>(wk + (c0 + q) * CP);
#pragma unroll
              for (int o4 = 0; o4 < RW / 4; ++o4) {
                const float4 wv = wr[o4];
                z[4 * o4 + 0] += wv.x * v[q];
                z[4 * o4 + 1] += wv.y * v[q];
                z[4 * o4 + 2] += wv.z * v[q];
                z[4 * o4 + 3] += wv.w * v[q];
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RW; ++j) z[j] = __fadd_rn(__fmul_rn(z[j], w_mul[j0 + j]), w_add[j0 + j]);
      activate<RW>(z, act, act == ACT_PRELU_CHANNELS ? prm + j0 : prm);

      // The layer's input becomes history: ring slot n mod M.
      if (M > 0 && valid) {
        float* dst = state + ring + ((long long)nM * cin * T + t) * B + b;
#pragma unroll
        for (int j = 0; j < RW; ++j)
          if (j0 + j < cin) dst[(long long)(j0 + j) * T * B] = cur[(j0 + j) * TBS + col];
      }
#pragma unroll
      for (int j = 0; j < RW; ++j)
        if (j0 + j < C) nxt[(j0 + j) * TBS + col] = z[j];
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // Linear head: y = head_W . h + head_b, head_W (Cout, C).
  const float* hw = w + plan[P_HEAD_W];
  const float* hb = w + plan[P_HEAD_B];
  for (int it = threadIdx.x; it < TBS * Cout; it += blockDim.x) {
    const int col = it % TBS, o = it / TBS;
    const int t = col / BS, b = blockIdx.x * BS + col % BS;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += __ldg(hw + o * C + c) * cur[c * TBS + col];
    if (b < B) y[((long long)o * T + t) * B + b] = acc + __ldg(hb + o);
  }
}

}  // namespace

extern "C" {

// Launch one block step. All pointers are device pointers; the state's rings
// are updated in place; `stream` is a cudaStream_t. `rows` sizes the two
// shared buffers (ops/cuda/convnet.py `_wide_smem_bytes`), CP is the padded
// row count of the packed weights, `seg_max` > 0 stages each layer's weights
// into shared memory, `threads` <= 512. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise and
// allocates nothing.
int nam_convnet_wide_step(const void* x, void* y, void* state, const void* w, const void* plan, int T, int B, int n,
                          int BS, int rows, int CP, int seg_max, int threads, int smem_bytes, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(convnet_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (threads < 1 || threads > NT) return (int)cudaErrorInvalidValue;
  const int grid = (B + BS - 1) / BS;
  convnet_wide_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(state), static_cast<const float*>(w),
      static_cast<const long long*>(plan), T, B, n, BS, rows, CP, seg_max);
  return (int)cudaGetLastError();
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
