// The dot-chain microbenchmark for Hopper (sm_90a): S steps of
//   y = tanh(w_s . x),   x <- [y; y; y]
// with w_s (R, 3R), x (3R, N) float32; the output is the last x, (3R, N).
//
// Replaces two TPU kernels of tools/microbench_pallas_dots.py, K5 and K6 in
// ROADMAP.md: `chain_kernel` (driven by `make_chain.run`, the pl.pallas_call
// at :77; R = 16, S = 20) and `packed_kernel` (driven by `make_packed.run`,
// :115; R = 16 G, S = 20 // G, G = 4 or 8). The tool's packed weights are
// dense, so the two compute one function at different shapes. The TPU
// kernels keep every operand in VMEM for the whole chain; here the whole
// chain is one launch and the intermediate x never leaves the SM: a CTA
// owns a stripe of NC columns, keeps its (3R, NC) operand in shared memory
// and runs all S steps on it. Each step does the full 3R-deep product on
// the tiled operand (the row tile is not folded into the weights, which
// would change the rounding and a third of the work), and the last step
// writes all three copies of y.
//
// Two variants, one entry point:
//   - f32 (variant 0): exact float32, scalar fmaf in k order, tanhf; no
//     TF32 and no fast-math (the H100 has no exact-float32 tensor-core
//     path). A thread computes a 4-row x 4-column tile; a step's weights
//     are staged in shared memory 16 k at a time, transposed, so both
//     operands of a k come as one float4 each (a whole step's weights, 196.6
//     KB at R = 128, would not fit beside the operand); the next slab is
//     read into registers while the current one is used.
//   - bf16 (variant 1): the weights and each step's operand rounded to
//     bf16 (round to nearest even, as .astype(bfloat16)), products summed in
//     float32 by the tensor cores, one pass of
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 x 8 x 16 piece; tanh
//     and the output stay float32. In bf16 a whole step's weights fit (100 KB
//     at R = 128), so each step stages them at once.
// What bounds it on an H100, at N = 65,536: the f32 variant operations
// (2 S R 3R N FLOPs at 67 TFLOP/s: 30 us for K5, 120 us for K6 at G = 4),
// the bf16 variant bytes (x read once and the output written once: 7.5 us
// for K5, against 2 us of tensor-core work at 989 TFLOP/s). R is a template
// parameter (16, 64 or 128: K5's and K6's), so every staging loop has a
// fixed trip count and its loads are issued together. N must be a multiple
// of 4 (float4 loads of the operand). Right and simple first: one
// slab of weights in shared memory, no wgmma, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int TR = 4, TC = 4;  // f32: a thread's tile of rows x columns
constexpr int KS = 16;         // f32: depth of a staged weight slab
constexpr int NPW = 8;         // bf16: 8-column n-tiles per warp

// f32 columns per CTA: THREADS threads, R / TR row groups.
__host__ __device__ constexpr int f32_cols(int R) { return THREADS / (R / TR) * TC; }
// bf16 columns per CTA: R / 16 row tiles, the 8 warps split over them.
__host__ __device__ constexpr int bf16_cols(int R) { return 8 * NPW * (THREADS / 32) / (R / 16); }

// x (K, N) -> a CTA's columns [col0, col0 + NC), zero past N, each value
// through put(k, c, v), in float4 loads (N is a multiple of 4).
template <int K, int NC, typename Put>
__device__ __forceinline__ void load_operand(const float* __restrict__ x, int N, int col0, Put put) {
#pragma unroll 4
  for (int i = threadIdx.x; i < K * NC / 4; i += THREADS) {
    const int k = i / (NC / 4), c = (i % (NC / 4)) * 4;
    const float4 v = col0 + c < N ? __ldg(reinterpret_cast<const float4*>(x + (long long)k * N + col0 + c))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    put(k, c, v.x);
    put(k, c + 1, v.y);
    put(k, c + 2, v.z);
    put(k, c + 3, v.w);
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS)
    chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int S,
                     int N) {
  constexpr int K = 3 * R, NC = f32_cols(R), NCG = NC / TC;
  constexpr int WP = R + 4;            // row stride of the slab (padded: fewer bank conflicts on its stores)
  constexpr int PER = KS * R / THREADS;  // slab values a thread stages
  static_assert(PER >= 1 && KS * R % THREADS == 0, "R must be 16, 64 or 128");
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (K, NC): the operand
  float* ws = xs + K * NC;                      // (KS, WP): a slab of w_s, transposed
  const int col0 = blockIdx.x * NC;
  const int rg = threadIdx.x / NCG, cg = threadIdx.x % NCG;

  load_operand<K, NC>(x, N, col0, [&](int k, int c, float v) { xs[k * NC + c] = v; });
  // Slabs in order (step s, depth k0); the next one is loaded into
  // registers while the current one is used. A thread stages rows
  // i / KS of 16 consecutive k: a warp reads two 64-byte runs.
  const int slabs = S * (K / KS);
  float pre[PER];
  auto fetch = [&](int q) {
    const float* src = w + (long long)(q / (K / KS)) * R * K + (q % (K / KS)) * KS;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      pre[j] = __ldg(src + (i / KS) * K + i % KS);
    }
  };
  fetch(0);
  float acc[TR][TC];
  for (int q = 0; q < slabs; ++q) {
    const int k0 = (q % (K / KS)) * KS;
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();  // the operand is written; the previous slab is consumed
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      ws[(i % KS) * WP + i / KS] = pre[j];
    }
    __syncthreads();
    if (q + 1 < slabs) fetch(q + 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ws + kk * WP + rg * TR);
      const float4 b = *reinterpret_cast<const float4*>(xs + (k0 + kk) * NC + cg * TC);
      const float av[TR] = {a.x, a.y, a.z, a.w};
      const float bv[TC] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (k0 + KS < K) continue;
    // The step is done: y = tanh(acc) is the next operand, [y; y; y].
    __syncthreads();  // every thread has read the operand
    const bool last = q + 1 == slabs;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = rg * TR + i;
      const float4 v = make_float4(tanhf(acc[i][0]), tanhf(acc[i][1]), tanhf(acc[i][2]), tanhf(acc[i][3]));
#pragma unroll
      for (int copy = 0; copy < 3; ++copy) {
        const int row = r + copy * R;
        if (!last) {
          *reinterpret_cast<float4*>(xs + row * NC + cg * TC) = v;
        } else {
          const float vv[TC] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int col = col0 + cg * TC + j;
            if (col < N) out[(long long)row * N + col] = vv[j];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// D = A . B + D on one 16 x 8 x 16 piece: A (16 x 16, row) and B (16 x 8,
// col) in bf16, D in float32 (PTX ISA, mma.m16n8k16 fragment layouts).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int R>
__global__ void __launch_bounds__(THREADS)
    chain_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int S,
                      int N) {
  // Rows of both buffers are KP bf16 long: k contiguous, padded by 8 so that
  // a fragment's 8 rows fall in distinct banks.
  constexpr int K = 3 * R, KP = K + 8, NC = bf16_cols(R), MT = R / 16;
  static_assert(MT >= 1 && 8 % MT == 0, "R must be 16, 64 or 128");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem4);  // (R, KP): w_s, row-major
  __nv_bfloat16* xs = ws + R * KP;                              // (NC, KP): the operand, a column per row
  const int col0 = blockIdx.x * NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = (warp % MT) * 16;       // the warp's row tile
  const int n0 = (warp / MT) * NPW * 8;  // the warp's first column

  load_operand<K, NC>(x, N, col0, [&](int k, int c, float v) { xs[c * KP + k] = __float2bfloat16_rn(v); });
  for (int s = 0; s < S; ++s) {
    const float4* wg = reinterpret_cast<const float4*>(w + (long long)s * R * K);
    __syncthreads();  // the previous step's weights are consumed
#pragma unroll 8
    for (int i = threadIdx.x; i < R * K / 4; i += THREADS) {
      const float4 v = __ldg(wg + i);
      __nv_bfloat16* d = ws + (i / (K / 4)) * KP + (i % (K / 4)) * 4;
      d[0] = __float2bfloat16_rn(v.x);
      d[1] = __float2bfloat16_rn(v.y);
      d[2] = __float2bfloat16_rn(v.z);
      d[3] = __float2bfloat16_rn(v.w);
    }
    __syncthreads();  // the weights and the operand are written
    float acc[NPW][4];
#pragma unroll
    for (int j = 0; j < NPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 16) {
      const __nv_bfloat16* wa = ws + (r0 + g) * KP + k0 + 2 * t;
      const uint32_t a0 = ld32(wa), a1 = ld32(wa + 8 * KP), a2 = ld32(wa + 8), a3 = ld32(wa + 8 * KP + 8);
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const __nv_bfloat16* xb = xs + (n0 + j * 8 + g) * KP + k0 + 2 * t;
        mma_bf16(acc[j], a0, a1, a2, a3, ld32(xb), ld32(xb + 8));
      }
    }
    __syncthreads();  // every warp has read the operand
    const bool last = s + 1 == S;
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8, c = n0 + j * 8 + 2 * t + (e & 1);
        const float v = tanhf(acc[j][e]);
#pragma unroll
        for (int copy = 0; copy < 3; ++copy) {
          if (!last) {
            xs[c * KP + r + copy * R] = __float2bfloat16_rn(v);
          } else if (col0 + c < N) {
            out[(long long)(r + copy * R) * N + col0 + c] = v;
          }
        }
      }
    }
  }
}

int smem_bytes(int R, int variant) {
  return variant == 0 ? (3 * R * f32_cols(R) + KS * (R + 4)) * (int)sizeof(float)
                      : (R + bf16_cols(R)) * (3 * R + 8) * (int)sizeof(__nv_bfloat16);
}

using Kernel = void (*)(const float*, const float*, float*, int, int);

template <int R>
Kernel pick(int variant) {
  return variant == 0 ? chain_f32_kernel<R> : chain_bf16_kernel<R>;
}

}  // namespace

extern "C" {

// Launch the whole chain. x (3R, N), w (S, R, 3R) and out (3R, N) are
// float32 device pointers; variant 0 is f32, 1 bf16; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success). Does
// not synchronise and allocates nothing.
int nam_dot_chain(const void* x, const void* w, void* out, int S, int R, int N, int variant, void* stream) {
  if (S < 1 || N < 1 || N % 4 || (variant != 0 && variant != 1)) return (int)cudaErrorInvalidValue;
  Kernel kernel;
  int which;
  switch (R) {
    case 16: kernel = pick<16>(variant), which = 0; break;
    case 64: kernel = pick<64>(variant), which = 1; break;
    case 128: kernel = pick<128>(variant), which = 2; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(R, variant);
  static bool attr_set[2][3] = {};
  if (!attr_set[variant][which]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set[variant][which] = true;
  }
  const int nc = variant == 0 ? f32_cols(R) : bf16_cols(R);
  kernel<<<(N + nc - 1) / nc, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), S, N);
  return (int)cudaGetLastError();
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
