// GEGLU feed-forward: y = (h * gelu_tanh(g)) W_out^T + b_out, where
// [h | g] = x W_in^T + b_in; h is the first F columns and g the last F.
//
// Replaces: news_recommendation_project_v2_tpu/ops/pallas_geglu.py,
// `_geglu_kernel` (launched by `fused_geglu`; oracle `reference_geglu`). Same
// function: x [C, D]; float32 products, bias and gate; the gated product is
// rounded to x's type before W_out, as the flax module rounds it; output
// float32 [C, D]. The [C, 2F] intermediate never reaches device memory.
// Weights come in nn.Linear layout: W_in [2F, D], W_out [D, F].
//
// What bounds it on an H100: 6*C*D*F operations against the 3*D*F weights
// (48 MB in float32) read once, i.e. C/2 operations per byte in float32. The
// float32 balance of the CUDA cores is 67 TFLOP/s over 3.35 TB/s = 20, so a
// single request (C of a few dozen rows) is bound by reading the weights and
// a batch of requests (C in the hundreds or more) by the arithmetic.
//
// Design, simple first:
//   * A block owns 16 tokens and the WHOLE output row (D <= 1024): its
//     [16, 1024] float32 accumulator lives in registers, 64 per thread, so no
//     h/g slab is ever recomputed for another output tile. Tensor cores,
//     wgmma and TMA are later work; both types run on CUDA cores in float32.
//   * There is no sequential grid to carry the accumulator (the Pallas
//     kernel's `o_ref`): the block loops over F inside itself, 128 columns of
//     h and g at a time. Phase 1 streams W_in in 32-deep tiles through shared
//     memory to form h and g for the chunk; the gate runs in shared memory;
//     phase 2 streams W_out in 8-deep tiles and adds into the accumulator.
//   * Few tokens (a single request) would leave most SMs idle, so the F loop
//     may be split over gridDim.y blocks; each writes its partial sum to a
//     scratch buffer the wrapper allocates, and a second kernel adds the
//     partials in a fixed order (deterministic) and the bias.
//   * The C tail is masked (the Pallas kernel asserted C % block_c == 0).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;    // tokens per block
constexpr int kCols = 128;   // columns of h (and of g) per F chunk
constexpr int kK = 32;       // depth of a W_in tile in phase 1
constexpr int kF = 8;        // depth of a W_out tile in phase 2
constexpr int kMaxD = 1024;  // widest output row a block holds
constexpr int kOut = kMaxD / kThreads;  // output columns per thread
constexpr int kWsStride = 2 * kCols + 1;
constexpr int kWoStride = kMaxD + 4;
constexpr int kBig = (kK * kWsStride > kF * kWoStride) ? kK * kWsStride : kF * kWoStride;
static_assert(kRows * 2 * kCols <= kBig, "h/g slab must fit the shared tile region");

__device__ __forceinline__ float gelu_tanh(float g) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
geglu_kernel(const T* __restrict__ x, const T* __restrict__ w_in, const T* __restrict__ b_in,
             const T* __restrict__ w_out, const T* __restrict__ b_out, float* __restrict__ y,
             float* __restrict__ partial, int C, int D, int F, int chunks_per_split) {
  __shared__ __align__(16) float xs[kK * kRows];    // x tile, depth-major
  __shared__ __align__(16) float us[kCols * kRows];  // gated chunk, column-major
  __shared__ __align__(16) float big[kBig];          // W_in tile | h/g slab | W_out tile
  float* ws = big;
  float* hs = big;
  float* wo = big;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, C - row0);
  const int nchunks = (F + kCols - 1) / kCols;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(nchunks, c_begin + chunks_per_split);

  float acc[kRows][kOut] = {};

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int f0 = chunk * kCols;

    // Phase 1: thread tid owns column tid of [h | g] for the chunk, i.e.
    // W_in row f0 + tid (h) or F + f0 + tid - kCols (g), for all 16 tokens.
    float acc1[kRows] = {};
    for (int k0 = 0; k0 < D; k0 += kK) {
      __syncthreads();
      for (int i = tid; i < kRows * kK; i += kThreads) {
        const int r = i / kK, kk = i % kK;
        xs[kk * kRows + r] =
            (r < rows && k0 + kk < D) ? to_float(x[static_cast<long long>(row0 + r) * D + k0 + kk])
                                      : 0.f;
      }
      for (int i = tid; i < 2 * kCols * kK; i += kThreads) {
        const int n = i / kK, kk = i % kK;
        const int f = f0 + n % kCols;
        const long long wrow = (n < kCols ? 0 : F) + f;
        ws[kk * kWsStride + n] =
            (f < F && k0 + kk < D) ? to_float(w_in[wrow * D + k0 + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const float w = ws[kk * kWsStride + tid];
        const float4* a4 = reinterpret_cast<const float4*>(xs + kk * kRows);
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 a = a4[r4];
          acc1[4 * r4 + 0] += a.x * w;
          acc1[4 * r4 + 1] += a.y * w;
          acc1[4 * r4 + 2] += a.z * w;
          acc1[4 * r4 + 3] += a.w * w;
        }
      }
    }
    __syncthreads();  // the W_in tile is dead; the slab takes its place
#pragma unroll
    for (int r = 0; r < kRows; ++r) hs[r * 2 * kCols + tid] = acc1[r];
    __syncthreads();

    // Gate, in float32, then rounded to T before W_out.
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, fl = i % kCols, f = f0 + fl;
      float u = 0.f;
      if (f < F) {
        const float hv = hs[r * 2 * kCols + fl] + to_float(b_in[f]);
        const float gv = hs[r * 2 * kCols + kCols + fl] + to_float(b_in[F + f]);
        u = round_to<T>(hv * gelu_tanh(gv));
      }
      us[fl * kRows + r] = u;
    }

    // Phase 2: thread tid owns output columns tid + 256 j for all 16 tokens.
    for (int fc = 0; fc < kCols; fc += kF) {
      __syncthreads();
      for (int i = tid; i < kMaxD * kF; i += kThreads) {
        const int d = i / kF, ff = i % kF;
        const int f = f0 + fc + ff;
        wo[ff * kWoStride + d] =
            (d < D && f < F) ? to_float(w_out[static_cast<long long>(d) * F + f]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ff = 0; ff < kF; ++ff) {
        float w[kOut];
#pragma unroll
        for (int j = 0; j < kOut; ++j) w[j] = wo[ff * kWoStride + tid + kThreads * j];
        const float4* a4 = reinterpret_cast<const float4*>(us + (fc + ff) * kRows);
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 a = a4[r4];
#pragma unroll
          for (int j = 0; j < kOut; ++j) {
            acc[4 * r4 + 0][j] += a.x * w[j];
            acc[4 * r4 + 1][j] += a.y * w[j];
            acc[4 * r4 + 2][j] += a.z * w[j];
            acc[4 * r4 + 3][j] += a.w * w[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int d = tid + kThreads * j;
      if (d >= D) continue;
      if (gridDim.y == 1) {
        y[static_cast<long long>(row0 + r) * D + d] = acc[r][j] + to_float(b_out[d]);
      } else {
        partial[(static_cast<long long>(blockIdx.y) * C + row0 + r) * D + d] = acc[r][j];
      }
    }
  }
}

// y = sum over splits of the partials, in split order, plus the bias.
template <typename T>
__global__ void geglu_reduce_kernel(const float* __restrict__ partial, const T* __restrict__ b_out,
                                    float* __restrict__ y, int splits, long long size, int D) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < size;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * size + i];
    y[i] = s + to_float(b_out[i % D]);
  }
}

template <typename T>
int launch(const void* x, const void* w_in, const void* b_in, const void* w_out,
           const void* b_out, void* y, void* partial, int C, int D, int F, int splits,
           int device, void* stream) {
  if (D > kMaxD || splits < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nchunks = (F + kCols - 1) / kCols;
  const int per = (nchunks + splits - 1) / splits;
  if ((nchunks + per - 1) / per != splits) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kRows - 1) / kRows, splits);
  geglu_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), static_cast<const T*>(b_in),
      static_cast<const T*>(w_out), static_cast<const T*>(b_out), static_cast<float*>(y),
      static_cast<float*>(partial), C, D, F, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long size = static_cast<long long>(C) * D;
  const int blocks = static_cast<int>((size + kThreads - 1) / kThreads < 4096
                                          ? (size + kThreads - 1) / kThreads
                                          : 4096);
  geglu_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const T*>(b_out), static_cast<float*>(y),
      splits, size, D);
  return cudaGetLastError();
}

}  // namespace

NR_EXPORT int geglu_f32(const void* x, const void* w_in, const void* b_in, const void* w_out,
                        const void* b_out, void* y, void* partial, int C, int D, int F,
                        int splits, int device, void* stream) {
  return launch<float>(x, w_in, b_in, w_out, b_out, y, partial, C, D, F, splits, device, stream);
}

NR_EXPORT int geglu_bf16(const void* x, const void* w_in, const void* b_in, const void* w_out,
                         const void* b_out, void* y, void* partial, int C, int D, int F,
                         int splits, int device, void* stream) {
  return launch<__nv_bfloat16>(x, w_in, b_in, w_out, b_out, y, partial, C, D, F, splits, device,
                               stream);
}
