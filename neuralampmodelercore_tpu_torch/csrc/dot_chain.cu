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
// owns a stripe of columns and runs all S steps on it. Each step does the
// full 3R-deep product on the tiled operand (the row tile is not folded into
// the weights, which would change the rounding and a third of the work),
// and the last step writes all three copies of y.
//
// Two variants, one entry point:
//   - f32 (variant 0): exact float32, scalar fmaf in k order from 0.f, then
//     tanhf; no TF32 and no fast-math (the H100 has no exact-float32
//     tensor-core path). What bounds it is the FMA issue rate (67 TFLOP/s:
//     30 us for K5, 120 us for K6 at G = 4, 192 us at G = 8, N = 65,536),
//     and shared memory has to feed it: a warp's 16-byte load costs the SM's
//     shared-memory port 4 cycles, so a thread must do 16 FMAs a 16-byte
//     load to keep the two in step. So a thread computes an 8 x 8 tile (two
//     float4 of weights and two of the operand, 64 FMAs, a k), and a CTA of
//     256 threads an R x f32_cols(R) tile (128 columns at R = 128: 512 CTAs
//     at N = 65,536, two an SM). Only y is kept on chip: from step 1 on,
//     operand row k is y[k mod R], so the CTA holds y (R x NC) and the sum
//     still runs over all 3R k in order. Step 0's operand and every step's
//     weights come in slabs of KS k, copied asynchronously (cp.async) into a
//     double buffer, slab q + 1 while slab q is used; the weights' slab is
//     transposed, [k][r], by the copies' addresses. Step 0's two operand
//     slabs lie in y's space, which step 0 does not write until its end.
//     This R x NC tile runs R = 64 and 128 (K6). K5's R = 16 keeps the
//     4 x 4-tile kernel below (chain_f32_k5_kernel): at R = 16 the 8 x 8
//     tile makes 1,024-column CTAs, 64 of them for 132 SMs.
//   - bf16 (variant 1): the weights and each step's operand rounded to
//     bf16 (round to nearest even, as .astype(bfloat16)), products summed in
//     float32 by the tensor cores, one pass of
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 x 8 x 16 piece; tanh
//     and the output stay float32. In bf16 a whole step's weights fit (100 KB
//     at R = 128), so each step stages them at once. What bounds it is bytes
//     (x read once and the output written once: 7.5 us for K5, against 2 us
//     of tensor-core work at 989 TFLOP/s).
// R is a template parameter (16, 64 or 128: K5's and K6's), so every
// staging loop has a fixed trip count and its loads are issued together. N
// must be a multiple of 4 (16-byte loads and stores of the operand); a
// ragged last CTA reads zeros past N and writes nothing there.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int TM = 8;          // f32 at R = 64, 128: a thread's tile, TM rows x TM columns
constexpr int K5_T = 4;        // f32 at R = 16 (K5): a thread's tile, 4 x 4
constexpr int KS = 16;         // f32: depth of a staged slab of k
constexpr int NPW = 8;         // bf16: 8-column n-tiles per warp

// f32 columns per CTA: THREADS threads of TM x TM over R rows, or of
// K5_T x K5_T at R = 16.
__host__ __device__ constexpr int f32_cols(int R) {
  return R == 16 ? THREADS / (R / K5_T) * K5_T : THREADS * TM * TM / R;
}
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
__global__ void __launch_bounds__(THREADS, 2)
    chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int S,
                     int N) {
  constexpr int K = 3 * R, NC = f32_cols(R), QS = K / KS;  // QS: slabs a step
  constexpr int WP = R + 4;                    // row stride of a weight slab (16-byte rows)
  constexpr int WC = TM * TM;                  // a warp's tile: 32 rows x WC (64) columns
  constexpr int LC = WC / 2 / 4;               // lanes along a warp's columns: two float4 runs each
  constexpr int WPER = KS * R / THREADS;       // weight values a thread copies a slab
  constexpr int XPER = KS * NC / 4 / THREADS;  // step 0: operand float4s a thread copies a slab
  static_assert((R == 64 || R == 128) && NC % WC == 0 && WPER * THREADS == KS * R && XPER * THREADS * 4 == KS * NC,
                "the R x NC tile runs R = 64 and 128");
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // (R, NC): y; in step 0 its first 2 KS NC floats hold x's slabs
  float* ws = ys + R * NC;                      // (2, KS, WP): slabs of w_s, transposed
  const int col0 = blockIdx.x * NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The thread's rows r0 .. r0 + 7 and columns c0 .. c0 + 3, c0 + WC / 2 ..
  // + 3: the 8 lanes of a quarter-warp read one 128-byte run of a row of
  // the operand, and all of them the same 8 weights.
  const int r0 = (warp % (R / 32)) * 32 + (lane / LC) * TM;
  const int c0 = (warp / (R / 32)) * WC + (lane % LC) * 4;

  // Slab q = (step q / QS, depth k0 = (q % QS) KS) into buffer q & 1: the
  // weights transposed, one 4-byte copy a value (a warp reads two 64-byte
  // runs); in step 0 also the operand's KS rows, zero past N. A thread's
  // copies are THREADS / KS weight rows and THREADS / (NC / 4) operand rows
  // apart, so it keeps one source and one destination offset of each.
  const int wk = threadIdx.x % KS, wr = threadIdx.x / KS;
  const float* wsrc = w + wr * K + wk;
  const int wdst = wk * WP + wr;
  const int xk = threadIdx.x / (NC / 4), xc = (threadIdx.x % (NC / 4)) * 4;
  const bool xin = col0 + xc < N;
  const float* xsrc = x + (xin ? (long long)xk * N + col0 + xc : 0);
  auto issue = [&](int q) {
    const int s = q / QS, k0 = (q % QS) * KS;
    const float* src = wsrc + (long long)s * R * K + k0;
    float* dst = ws + (q & 1) * KS * WP + wdst;
#pragma unroll
    for (int j = 0; j < WPER; ++j)
      __pipeline_memcpy_async(dst + j * (THREADS / KS), src + j * (THREADS / KS) * K, 4);
    if (s == 0) {
      float* xd = ys + (q & 1) * KS * NC + xk * NC + xc;
#pragma unroll
      for (int j = 0; j < XPER; ++j)
        __pipeline_memcpy_async(xd + j * (THREADS / (NC / 4)) * NC,
                                xsrc + (xin ? (long long)(k0 + j * (THREADS / (NC / 4))) * N : 0), 16, xin ? 0 : 16);
    }
    __pipeline_commit();
  };

  const int slabs = S * QS;
  issue(0);
  float acc[TM][TM];
  for (int q = 0; q < slabs; ++q) {
    const int k0 = (q % QS) * KS;
    __pipeline_wait_prior(0);
    __syncthreads();  // slab q is in for every thread; every thread is done with slab q - 1's buffers
    if (q + 1 < slabs) issue(q + 1);
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
    }
    const float* wq = ws + (q & 1) * KS * WP + r0;
    const float* bq = (q < QS ? ys + (q & 1) * KS * NC : ys + (k0 % R) * NC) + c0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(wq + kk * WP);
      const float4 a1 = *reinterpret_cast<const float4*>(wq + kk * WP + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bq + kk * NC);
      const float4 b1 = *reinterpret_cast<const float4*>(bq + kk * NC + WC / 2);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (k0 + KS < K) continue;
    // The step is done: y = tanh(acc), the next step's operand.
    const bool last = q + 1 == slabs;
    if (!last) __syncthreads();  // every thread has read y (in step 0: the operand's slabs in its space)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + h * (WC / 2);
        const float4 v = make_float4(tanhf(acc[i][4 * h]), tanhf(acc[i][4 * h + 1]), tanhf(acc[i][4 * h + 2]),
                                     tanhf(acc[i][4 * h + 3]));
        if (!last) {
          *reinterpret_cast<float4*>(ys + (r0 + i) * NC + c) = v;
        } else if (col0 + c < N) {
#pragma unroll
          for (int copy = 0; copy < 3; ++copy)
            *reinterpret_cast<float4*>(out + (long long)(r0 + i + copy * R) * N + col0 + c) = v;
        }
      }
    }
  }
}

// K5 (R = 16): a thread computes a 4 x 4 tile, the CTA keeps the whole
// (3R, NC) operand; a step's weights are staged 16 k at a time, transposed,
// the next slab read into registers while the current one is used.
template <int R>
__global__ void __launch_bounds__(THREADS)
    chain_f32_k5_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int S,
                        int N) {
  constexpr int TR = K5_T, TC = K5_T;
  constexpr int K = 3 * R, NC = f32_cols(R), NCG = NC / TC;
  constexpr int WP = R + 4;            // row stride of the slab (padded: fewer bank conflicts on its stores)
  constexpr int PER = KS * R / THREADS;  // slab values a thread stages
  static_assert(R == 16 && PER >= 1 && KS * R % THREADS == 0, "the 4 x 4-tile kernel runs R = 16");
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

// Dynamic shared memory of a CTA: f32 at R = 64, 128: y (R, NC) and two
// weight slabs (KS, R + 4); f32 at R = 16: the operand (3R, NC) and one
// slab; bf16: the weights and the operand, rows of 3R + 8 bf16.
int smem_bytes(int R, int variant) {
  if (variant == 1) return (R + bf16_cols(R)) * (3 * R + 8) * (int)sizeof(__nv_bfloat16);
  return (R == 16 ? 3 * R * f32_cols(R) + KS * (R + 4) : R * f32_cols(R) + 2 * KS * (R + 4)) * (int)sizeof(float);
}

using Kernel = void (*)(const float*, const float*, float*, int, int);

template <int R>
Kernel pick(int variant) {
  if (variant == 1) return chain_bf16_kernel<R>;
  if constexpr (R == 16) return chain_f32_k5_kernel<R>;
  else return chain_f32_kernel<R>;
}

// The kernel for (R, variant) with its shared memory allowed; nullptr for
// an R it does not take.
Kernel ready(int R, int variant, cudaError_t* err) {
  Kernel kernel;
  int which;
  switch (R) {
    case 16: kernel = pick<16>(variant), which = 0; break;
    case 64: kernel = pick<64>(variant), which = 1; break;
    case 128: kernel = pick<128>(variant), which = 2; break;
    default: *err = cudaErrorInvalidValue; return nullptr;
  }
  static bool attr_set[2][3] = {};
  *err = cudaSuccess;
  if (!attr_set[variant][which]) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(R, variant));
    if (*err == cudaSuccess)
      *err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared);
    if (*err != cudaSuccess) return nullptr;
    attr_set[variant][which] = true;
  }
  return kernel;
}

}  // namespace

extern "C" {

// Launch the whole chain. x (3R, N), w (S, R, 3R) and out (3R, N) are
// float32 device pointers; variant 0 is f32, 1 bf16; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success). Does
// not synchronise and allocates nothing.
int nam_dot_chain(const void* x, const void* w, void* out, int S, int R, int N, int variant, void* stream) {
  if (S < 1 || N < 1 || N % 4 || (variant != 0 && variant != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const Kernel kernel = ready(R, variant, &err);
  if (kernel == nullptr) return (int)err;
  const int nc = variant == 0 ? f32_cols(R) : bf16_cols(R);
  kernel<<<(N + nc - 1) / nc, THREADS, smem_bytes(R, variant), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), S, N);
  return (int)cudaGetLastError();
}

// The CTAs of the f32 kernel for R that one SM holds at once, as the CUDA
// runtime computes it for the launch above (0 on an error).
int nam_dot_chain_ctas_per_sm(int R) {
  cudaError_t err;
  const Kernel kernel = ready(R, 0, &err);
  int n = 0;
  if (kernel == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem_bytes(R, 0)) != cudaSuccess)
    return 0;
  return n;
}

const char* nam_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
