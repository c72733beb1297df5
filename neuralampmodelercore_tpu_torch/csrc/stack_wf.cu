// Fused WaveNet stack step, wavefront-scheduled, for Hopper (sm_90a): the
// step of csrc/stack.cu with each run of shallow layers scheduled in
// (layer, sub-tile) micro-steps.
//
// Replaces the wavefront path of the TPU kernel `_make_kernel` of
// neuralampmodelercore_tpu/ops/pallas/stack.py: `wf_array` (stack.py:1053),
// taken when `WAVEFRONT` (stack.py:430) is on and `_wavefront_reason` passes
// (K1g). The models it runs: one net, one input and condition channel,
// bottleneck == channels, layer1x1 on, no head1x1, gating, FiLM or condition
// DSP, and a run of >= 2 consecutive layers with rf = (K-1) d <= T (the
// flagship family). It computes what the unpacked kernel computes, on the
// same plan and the same state: one ring per conv with history, written in
// place, so a stream may switch between the two kernels at any block.
//
// Schedule (ops/cuda/stack.py `_wf_micros`, packed by `_pack_wf`): the T
// frames of a block split into G sub-tiles of T / G frames. Inside a run,
// layer l runs on sub-tile tau at micro-step l + tau; a deep layer (rf > T)
// runs on every sub-tile in one micro-step, as the unpacked kernel runs it.
// A shallow layer on sub-tile tau reads its input on sub-tiles <= tau (or in
// the ring, for the previous block): those were written by layer l - 1 at
// micro-steps <= l + tau - 1, so one __syncthreads() per micro-step orders
// every dependency.
//
// Design: the TPU version packs the G active layers' weights block-
// diagonally into one MXU dot; on Hopper's FMA pipes that would multiply
// zeros. Here a thread keeps owning one (frame, stream): its sub-tile's
// warps run their own layer's conv, mixin, activation and layer1x1 from that
// layer's staged weights (the unpacked kernel's code, stack.cuh), so up to G
// layers are in flight in one CTA. A run of L layers takes L + G - 1
// micro-steps of one sync each where the unpacked kernel takes L layer steps.
//   - layer inputs: D = G + 1 slots of [rows][T][BS] in shared memory; layer
//     l (array-local) reads slot l mod D and writes slot (l + 1) mod D on its
//     own sub-tile's frames. In one micro-step the active layers are G
//     consecutive ones, so a slot written there is read there only on other
//     frames, and the slot it overwrites was last read a micro-step earlier
//     (the host asserts this per micro-step, `_wf_rows`). The JAX plan's
//     D = G + 2 covers a DMA still in flight, which a sync retires here;
//   - weights: G + 1 segment buffers; layer g's segment goes to buffer
//     g mod (G + 1), staged one micro-step before its first use (the
//     schedule's last column names it);
//   - residual and head accumulator stay in the thread's registers, as in
//     the unpacked kernel;
//   - shared memory: 5 slots of 16 channels at T = 64 and 8 streams are
//     160 KB; where the slots and segments do not fit in 227 KB, the wrapper
//     takes fewer streams per CTA.
//
// What bounds it on an H100: the same work and bytes as the unpacked kernel
// (ops/cuda/stack.py `work`), with more syncs and with sub-tiles idle in the
// first and last G - 1 micro-steps of each run.

#include "stack.cuh"  // plan layout, Tile, Ctx, conv_taps, plain_layer_rest, rechannel, stack_step_body

namespace {

// Schedule layout (int64), written by ops/cuda/stack.py `_pack_wf`.
constexpr int S_G = 0, S_D = 1, S_ROWS = 2, S_N_ARRAYS = 3, S_HEADER = 4;

// The array runner of this kernel: the array's micro-steps. Array `a`'s
// rows of the schedule hold, per micro-step, the global layer of each
// sub-tile (-1: idle) and the layer to stage for the next micro-step.
struct Wavefront {
  template <int CP, int CM>
  __device__ static __forceinline__ void run(const Ctx& cx, const long long* ap, int a, int S, const float* cond,
                                             float* xr, float* hacc) {
    const Tile& tl = cx.tl;
    const long long* sc = cx.sched;
    const int G = (int)sc[S_G];
    const int D = (int)sc[S_D];
    const int slot = (int)sc[S_ROWS] * tl.T * tl.BS;  // floats per layer-input slot
    const long long* rows = sc + S_HEADER + 2 * sc[S_N_ARRAYS];
    const int r0 = (int)sc[S_HEADER + 2 * a];
    const int nr = (int)sc[S_HEADER + 2 * a + 1];
    const int tau = tl.t / (tl.T / G);
    const int C = (int)ap[A_C];
    const int first = (int)ap[A_FIRST];

    rechannel<CP, CM>(cx, ap, xr, cx.cur);  // layer 0's input: slot 0
    __syncthreads();

    for (int r = r0; r < r0 + nr; ++r) {
      const long long* row = rows + (long long)r * (G + 1);
      const int st = (int)row[G];
      if (st >= 0) {
        const long long* sl = cx.layers + (long long)st * LF;
        stage(cx.wsm0 + (st % (G + 1)) * cx.seg_max, cx.w + sl[L_SEG], (int)sl[L_SEG_LEN]);
      }
      const int g = (int)row[tau];
      if (g >= 0) {
        const long long* lp = cx.layers + (long long)g * LF;
        const float* ws = cx.wsm0 + (g % (G + 1)) * cx.seg_max;
        const int li = g - first;
        const float* cur_p = cx.cur + (li % D) * slot;
        float z[CP];
        conv_taps<CP>(cx, lp, ws, cur_p, C, z);
        plain_layer_rest<CP>(cx, lp, ws, cur_p, cx.cur + ((li + 1) % D) * slot, C, S, cond, z, xr, hacc);
      }
      __syncthreads();
    }
  }
};

template <int CM>
__global__ void __launch_bounds__(512)
    stack_wf_step_kernel(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ state,
                         const float* __restrict__ w, const long long* __restrict__ plan,
                         const long long* __restrict__ sched, int T, int B, int n, int BS) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Ctx cx = make_ctx(state, w, plan, T, B, n, BS);
  cx.sched = sched;
  cx.wsm0 = smem;  // G + 1 weight segments
  cx.wsm1 = nullptr;
  cx.cur = smem + (sched[S_G] + 1) * cx.seg_max;  // D layer-input slots
  stack_step_body<CM, Wavefront>(cx, x, nullptr, y, plan);
}

template <int CM>
cudaError_t launch(const float* x, float* y, float* state, const float* w, const long long* plan,
                   const long long* sched, int T, int B, int n, int BS, int smem_bytes, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(stack_wf_step_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         232448);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = (B + BS - 1) / BS;
  stack_wf_step_kernel<CM><<<grid, T * BS, smem_bytes, stream>>>(x, y, state, w, plan, sched, T, B, n, BS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one wavefront-scheduled block step. All pointers are device
// pointers; `sched` is the schedule of ops/cuda/stack.py `_pack_wf`; the
// state's rings are updated in place; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise and
// allocates nothing.
int nam_stack_wf_step(const void* x, void* y, void* state, const void* w, const void* plan, const void* sched, int T,
                      int B, int n, int BS, int c_max, int smem_bytes, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  const float* wf = static_cast<const float*>(w);
  const long long* pl = static_cast<const long long*>(plan);
  const long long* sc = static_cast<const long long*>(sched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_max) {
    case 4:
      return (int)launch<4>(xf, yf, sf, wf, pl, sc, T, B, n, BS, smem_bytes, st);
    case 8:
      return (int)launch<8>(xf, yf, sf, wf, pl, sc, T, B, n, BS, smem_bytes, st);
    case 16:
      return (int)launch<16>(xf, yf, sf, wf, pl, sc, T, B, n, BS, smem_bytes, st);
    case 32:
      return (int)launch<32>(xf, yf, sf, wf, pl, sc, T, B, n, BS, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
