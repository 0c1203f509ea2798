// GEGLU feed-forward: y = (h * gelu_tanh(g)) W_out^T + b_out, where
// [h | g] = x W_in^T + b_in; h is the first F columns and g the last F.
//
// Replaces: news_recommendation_project_v2_tpu/ops/pallas_geglu.py:29,
// `_geglu_kernel` (launched by `fused_geglu`; oracle `reference_geglu`). Same
// function: x [C, D] for any D >= 1, in float32, bfloat16 or float16 (the
// Pallas kernel takes any float type); float32 products, bias and gate; the
// gated product rounded to x's type before W_out, as the flax module rounds
// it; output float32 [C, D]. Weights come in nn.Linear layout: W_in [2F, D],
// W_out [D, F]. Both products are then "TN": x and W_in are contiguous along
// D, u and W_out along F, which is the layout mma.sync takes without
// transposes.
//
// What bounds it on an H100: 6*C*D*F operations against 3*D*F weights read
// once (48 MB in float32 at D=1024, F=4096). float32 runs as 3xTF32 on the
// tensor cores (495 / 3 = 165 TFLOP/s of float32-accurate products), so its
// balance against 3.35 TB/s is 49 operations per byte; the work does C/2 per
// weight byte. Below about 100 rows (a single request) reading the weights
// bounds it, above that the products. In bf16 (989 TFLOP/s, C operations per
// weight byte) the line lies near 300 rows.
//
// Two passes, on either of two tensor-core routes:
//   pass A  u = round_T(h * gelu_tanh(g)): a tile of rows times a block of
//           gate columns of h and the same of g (W_in rows f0.. and F+f0..)
//           over K = D; the gate in registers; u in x's type to a scratch;
//   pass B  y = u W_out^T + b_out over [C, D]. Where the output has few
//           tiles, the F sum splits; each split writes a float32 partial and
//           geglu_reduce_kernel adds them in split order with the bias:
//           deterministic, no atomics.
// The Pallas kernel kept [h | g] in VMEM. Here u goes through L2 and device
// memory: C*F*sizeof(T) bytes written and read once more. The wrapper walks C
// in row chunks so u and the partials never pass 64 MB; with no full-row
// accumulator, D is unlimited. The wrapper's planner (ops/geglu.py) picks the
// route, the chunks, the tiles and the splits.
//
// float32 keeps its products float32-accurate as 3xTF32: each operand splits
// into big = tf32(a) (to nearest, ties away) and small = tf32(a - big), and
// small*big + big*small + big*big accumulate in float32, small terms first
// (plain TF32 would break the port's true-float32 contract). The tensor
// cores' own sums round toward zero, which over a K=4096 chain drifts by
// about 1e-4 relative; so they only sum a run of at most 32 of K into a
// fresh partial, and partials add into the accumulator by FADD, rounding to
// nearest.
//
// The warpgroup route (float32 from 192 rows, D and F multiples of 4,
// 16-byte aligned operands). geglu_split_weights_kernel writes both weights'
// big and small halves once per call (6*D*F floats). Each pass then runs
// persistent blocks, one an SM, that walk 128 x 128 output tiles (pass A: 64
// gate columns of h beside the same 64 of g): one thread keeps TMA loads of
// A (x or u) and of B's two halves in flight through a 4-stage ring of
// 128-byte-swizzled 32-float stages (mbarriers full and empty); two consumer
// warpgroups (setmaxnreg: 232 registers against the producer's 40) each take
// 64 rows of A from shared memory into registers, split them, and issue the
// stage's 12 wgmma.m64n128k8 TF32 products with B from shared memory into a
// fresh partial. h and g of a gate column land in the same thread's
// accumulators. Measured (H100 80GB HBM3; PERF.md, Findings): 112 TFLOP/s of
// float32-accurate work at C=262,144, D=1,024 (68% of 165) and 116 at the
// NV-Embed tower (D=4,096); the plain library call runs 47. What limits it
// now: each warpgroup waits for its stage's products before adding the
// partial and splitting the next A, and the two warpgroups do so together;
// a second partial to pipeline across stages has no registers left at N=128.
//
// The mma.sync route (bf16 and f16; float32 below 192 rows or with ragged
// widths or unaligned rows): tiles of one block each through a 4-stage
// cp.async ring, 16 bytes per thread, 64 bytes of K a stage; rows padded to
// 80 bytes, so neither the hand-read 32-bit fragments nor ldmatrix meet a
// bank conflict. bf16 and f16: mma.m16n8k16 from ldmatrix (f16 takes bf16's
// tiles and plans); float32: 3xTF32 on mma.m16n8k8, split in registers, the
// partial over one stage (16 of K). Rows that are not 16-byte aligned and the
// ragged C, D and F edges take a masked scalar path inside the kernel (zeros
// past the edge). Two tile shapes: Large (128 x 128 with 8 warps in bf16,
// 128 x 64 with 4 warps in float32) and Small (64 x 32, 4 warps); pass A's
// must also make a block per SM, and pass B's F sum splits to reach about
// two blocks per SM. At C=37, D=1024, F=4096 each pass runs 256 blocks, so
// the weight reads spread over all 132 SMs. mma.sync issues TF32 at 120-150
// TFLOP/s, a quarter of the tensor cores' rate: the reason for the
// warpgroup route. At a few rows, pass A's fixed cost per stage (barrier,
// zero-filled rows) and not the weight bytes sets its time.
// Launches on the caller's stream, allocates nothing, returns the first CUDA
// error.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kStages = 4;                  // depth of the cp.async ring
constexpr int kRowBytes = 64;               // K bytes of one tile row per stage
constexpr int kRowStride = kRowBytes + 16;  // padded row: no bank conflicts
constexpr int kChunk = 16;                  // bytes per cp.async

// A block's tile (BM x BN), its warps' tiles (WM x WN) and the blocks an SM
// should hold (the register budget). Large and Small per type are TILES in
// ops/geglu.py, by index 0 and 1.
template <int BM_, int BN_, int WM_, int WN_, int kMinBlocks_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, kMinBlocks = kMinBlocks_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
  static constexpr int kSmem = kStages * (BM + BN) * kRowStride;
  static_assert(WN % 16 == 0, "pass A pairs n8 tiles: h in even, g in odd");
};
// float32 holds a per-stage partial beside its accumulator (mma_stage), so
// its Large tile is 128 x 64 with 4 warps and 3 blocks per SM; bf16 keeps
// 128 x 128 with 8 warps and 2 blocks, and so does f16. Either way a warp owns a 64 x 32
// tile. Small serves few rows: more, smaller blocks spread the weight reads.
template <typename T>
using Large = typename std::conditional<std::is_same<T, float>::value, Shape<128, 64, 64, 32, 3>,
                                        Shape<128, 128, 64, 32, 2>>::type;
using Small = Shape<64, 32, 32, 16, 4>;

__device__ __forceinline__ float gelu_tanh(float g) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

// One operand of a product: row r starts at p + r * ld, contiguous along K.
// vec: every row start is 16-byte aligned, so whole chunks go by cp.async.
template <typename T>
struct Operand {
  const T* p;
  long long ld;
  bool vec;
};

// Stage K columns [k0, k0 + kRowBytes / sizeof(T)) of a kRows-row tile into
// dst. Tile row r is operand row row_of(r); columns at or past k_end are
// zeros. A row with row_of(r) < 0 (past C, F or D) is left as it is: it
// feeds only the products of its own output row or column, which are never
// stored.
template <typename T, int kRows, int kThreads, class RowOf>
__device__ __forceinline__ void load_tile(unsigned char* dst, const Operand<T>& op, RowOf row_of,
                                          int k0, int k_end) {
  constexpr int E = kChunk / sizeof(T);
  constexpr int kChunks = kRowBytes / kChunk;
  static_assert(kRows * kChunks % kThreads == 0, "every thread copies whole chunks");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const long long row = row_of(r);
    if (row < 0) continue;
    unsigned char* d = dst + r * kRowStride + c * kChunk;
    const int k = k0 + c * E;
    if (op.vec && k + E <= k_end) {
      cp_async16(d, op.p + row * op.ld + k);
    } else {
      T* dt = reinterpret_cast<T*>(d);
#pragma unroll
      for (int e = 0; e < E; ++e)
        dt[e] = k + e < k_end ? op.p[row * op.ld + k + e] : from_float<T>(0.f);
    }
  }
}

// The products of one stage into the warp's accumulators: A rows are the
// block's BM tile rows, B rows its BN tile columns, both K-contiguous. They
// sum in a fresh partial that is added to acc by FADD (the tensor cores'
// sums round toward zero). Each k step issues the warp's MT x NT
// independent mmas back to back, so no mma waits on the one before.
template <typename T, class S>
__device__ __forceinline__ void mma_stage(float (&acc)[S::MT][S::NT][4], const unsigned char* st) {
  static_assert(kRowBytes == 64, "a stage is two k steps of 32 bytes (bf16) or 8 floats");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / S::kWarpsN) * S::WM, wn = (warp % S::kWarpsN) * S::WN;
  float part[S::MT][S::NT][4] = {};
  if constexpr (std::is_same<T, float>::value) {
    constexpr int L = kRowStride / 4;  // floats per padded row
    const float* as = reinterpret_cast<const float*>(st);
    const float* bs = reinterpret_cast<const float*>(st + S::BM * kRowStride);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < 16; ks += 8) {  // two k8 steps
      unsigned a_big[S::MT][4], a_small[S::MT][4], b_big[S::NT][2], b_small[S::NT][2];
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        const float* p = as + (wm + i * 16 + g) * L + ks + t;
        split_tf32(p[0], a_big[i][0], a_small[i][0]);
        split_tf32(p[8 * L], a_big[i][1], a_small[i][1]);
        split_tf32(p[4], a_big[i][2], a_small[i][2]);
        split_tf32(p[8 * L + 4], a_big[i][3], a_small[i][3]);
      }
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        const float* p = bs + (wn + j * 8 + g) * L + ks + t;
        split_tf32(p[0], b_big[j][0], b_small[j][0]);
        split_tf32(p[4], b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(part[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(part[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(part[i][j], a_big[i], b_big[j]);
    }
  } else {
    const unsigned a_base = smem_addr(st), b_base = a_base + S::BM * kRowStride;
#pragma unroll
    for (int ks = 0; ks < 64; ks += 32) {  // two k16 steps of 32 bytes
      unsigned a[S::MT][4], b[S::NT][2];
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
        ldmatrix_x4(a[i][0], a[i][1], a[i][2], a[i][3],
                    a_base + (wm + i * 16 + (lane & 15)) * kRowStride + ks + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        const int n = wn + j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
                    b_base + n * kRowStride + ks + ((lane >> 3) & 1) * 16);
      }
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_k16<T>(part[i][j], a[i], b[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
}

// acc += A[rows] . B[rows]^T over K columns [k_begin, k_end), through the
// cp.async ring: stage t + kStages - 1 loads while stage t is multiplied.
template <typename T, class S, class RowA, class RowB>
__device__ __forceinline__ void mainloop(float (&acc)[S::MT][S::NT][4], unsigned char* smem,
                                         const Operand<T>& a, RowA row_a, const Operand<T>& b,
                                         RowB row_b, int k_begin, int k_end) {
  constexpr int BK = kRowBytes / sizeof(T);
  const int nk = (k_end - k_begin + BK - 1) / BK;
  auto load = [&](int t) {
    if (t < nk) {
      unsigned char* st = smem + (t % kStages) * (S::BM + S::BN) * kRowStride;
      const int k0 = k_begin + t * BK;
      load_tile<T, S::BM, S::kThreads>(st, a, row_a, k0, k_end);
      load_tile<T, S::BN, S::kThreads>(st + S::BM * kRowStride, b, row_b, k0, k_end);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // stage t has landed ...
    __syncthreads();                // ... for every thread, and stage t-1 is free
    load(t + kStages - 1);
    mma_stage<T, S>(acc, smem + (t % kStages) * (S::BM + S::BN) * kRowStride);
  }
}

// Pass A. Block (bx, by) owns rows bx*BM.. of the chunk and gate columns
// f0 = by*BN/2 .. f0 + BN/2. Tile column n = 16q + s is W_in row f0 + 8q + s
// (h) for s < 8 and F + f0 + 8q + s - 8 (g) for s >= 8, so a warp's n8 tiles
// 2p and 2p+1 hold h and g of the same columns in the same registers.
template <typename T, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
geglu_gate_kernel(Operand<T> x, Operand<T> w_in, const T* __restrict__ b_in, T* __restrict__ u,
                  int rows, int D, int F, int ldu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * S::BM, f0 = blockIdx.y * (S::BN / 2);
  float acc[S::MT][S::NT][4] = {};
  mainloop<T, S>(
      acc, smem, x, [&](int r) -> long long { return m0 + r < rows ? m0 + r : -1; }, w_in,
      [&](int r) -> long long {
        const int f = f0 + 8 * (r >> 4) + (r & 7);
        return f >= F ? -1 : (r & 8) ? F + f : f;
      },
      0, D);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / S::kWarpsN) * S::WM, wn = (warp % S::kWarpsN) * S::WN;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int p = 0; p < S::NT / 2; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + (lane >> 2) + (r >> 1) * 8;
        const int f = f0 + wn / 2 + p * 8 + 2 * (lane & 3) + (r & 1);
        if (m < rows && f < F) {
          const float hv = acc[i][2 * p][r] + to_float(b_in[f]);
          const float gv = acc[i][2 * p + 1][r] + to_float(b_in[F + f]);
          u[static_cast<long long>(m) * ldu + f] = from_float<T>(hv * gelu_tanh(gv));
        }
      }
}

// Pass B. Block (bx, by, s) owns rows bx*BM.., output columns by*BN.. and
// the F columns [s*split_k, (s+1)*split_k) of the sum. One split writes y
// with the bias; several write partials for geglu_reduce_kernel.
template <typename T, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
geglu_out_kernel(Operand<T> u, Operand<T> w_out, const T* __restrict__ b_out, float* __restrict__ y,
                 float* __restrict__ partial, int rows, int D, int F, int split_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * S::BM, n0 = blockIdx.y * S::BN, s = blockIdx.z;
  const int k_begin = s * split_k, k_end = min(F, k_begin + split_k);
  float acc[S::MT][S::NT][4] = {};
  mainloop<T, S>(
      acc, smem, u, [&](int r) -> long long { return m0 + r < rows ? m0 + r : -1; }, w_out,
      [&](int r) -> long long { return n0 + r < D ? n0 + r : -1; }, k_begin, k_end);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / S::kWarpsN) * S::WM, wn = (warp % S::kWarpsN) * S::WN;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + (lane >> 2) + (r >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * (lane & 3) + (r & 1);
        if (m >= rows || n >= D) continue;
        const long long at = static_cast<long long>(m) * D + n;
        if (gridDim.z == 1) {
          y[at] = acc[i][j][r] + to_float(b_out[n]);
        } else {
          partial[static_cast<long long>(s) * rows * D + at] = acc[i][j][r];
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
Operand<T> operand(const void* p, long long ld) {
  const bool aligned = reinterpret_cast<std::uintptr_t>(p) % kChunk == 0;
  return Operand<T>{static_cast<const T*>(p), ld, aligned && ld % (kChunk / sizeof(T)) == 0};
}

// Let `kernel` take `bytes` of dynamic shared memory; above 48 KB it must ask.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, class S>
cudaError_t gate(Operand<T> x, Operand<T> w_in, const T* b_in, T* u, int rows, int D, int F,
                 int ldu, cudaStream_t stream) {
  const cudaError_t err = allow_smem(geglu_gate_kernel<T, S>, S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + S::BM - 1) / S::BM, (F + S::BN / 2 - 1) / (S::BN / 2));
  geglu_gate_kernel<T, S><<<grid, S::kThreads, S::kSmem, stream>>>(x, w_in, b_in, u, rows, D, F, ldu);
  return cudaGetLastError();
}

template <typename T, class S>
cudaError_t out(Operand<T> u, Operand<T> w_out, const T* b_out, float* y, float* partial, int rows,
                int D, int F, int splits, int split_k, cudaStream_t stream) {
  const cudaError_t err = allow_smem(geglu_out_kernel<T, S>, S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + S::BM - 1) / S::BM, (D + S::BN - 1) / S::BN, splits);
  geglu_out_kernel<T, S><<<grid, S::kThreads, S::kSmem, stream>>>(u, w_out, b_out, y, partial, rows,
                                                                   D, F, split_k);
  return cudaGetLastError();
}

// The whole GEGLU over C rows, chunk_rows at a time through the u scratch
// [chunk_rows, ldu]; tile_a and tile_b pick Large (0) or Small (1) per pass.
template <typename T>
int launch(const void* x, const void* w_in, const void* b_in, const void* w_out, const void* b_out,
           void* y, void* u, void* partial, int C, int D, int F, int chunk_rows, int ldu, int tile_a,
           int tile_b, int splits, int split_k, int device, void* stream) {
  constexpr int BK = kRowBytes / sizeof(T);
  if (C < 1 || D < 1 || F < 1 || chunk_rows < 1 || ldu < F || ldu % 8 != 0 || split_k < 1 ||
      split_k % BK != 0 || splits != (F + split_k - 1) / split_k || (splits > 1 && !partial) ||
      tile_a < 0 || tile_a > 1 || tile_b < 0 || tile_b > 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* bi = static_cast<const T*>(b_in);
  const T* bo = static_cast<const T*>(b_out);
  T* ut = static_cast<T*>(u);
  const Operand<T> wi = operand<T>(w_in, D), wo = operand<T>(w_out, F), uo = operand<T>(u, ldu);
  for (long long r0 = 0; r0 < C; r0 += chunk_rows) {
    const int rows = static_cast<int>(C - r0 < chunk_rows ? C - r0 : chunk_rows);
    const Operand<T> xo = operand<T>(static_cast<const T*>(x) + r0 * D, D);
    float* yc = static_cast<float*>(y) + r0 * D;
    float* pc = static_cast<float*>(partial);
    err = tile_a == 0 ? gate<T, Large<T>>(xo, wi, bi, ut, rows, D, F, ldu, s)
                      : gate<T, Small>(xo, wi, bi, ut, rows, D, F, ldu, s);
    if (err != cudaSuccess) return err;
    err = tile_b == 0 ? out<T, Large<T>>(uo, wo, bo, yc, pc, rows, D, F, splits, split_k, s)
                      : out<T, Small>(uo, wo, bo, yc, pc, rows, D, F, splits, split_k, s);
    if (err != cudaSuccess) return err;
    if (splits == 1) continue;
    const long long size = static_cast<long long>(rows) * D;
    const long long want = (size + 255) / 256;
    geglu_reduce_kernel<T><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, s>>>(pc, bo, yc,
                                                                                      splits, size, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- float32 on warpgroup MMA: wgmma fed by TMA ----
namespace wg {

constexpr int kBM = 128;           // tile rows: two consumer warpgroups of 64
constexpr int kBN = 128;           // tile columns (pass A: 64 of h, then the same 64 of g)
constexpr int kBK = 32;            // K floats a stage: one 128-byte swizzled row
constexpr int kStages = 4;         // depth of the TMA ring
constexpr int kTile = 128 * 128;   // bytes of a 128-row operand tile, one stage deep
constexpr int kStage = 3 * kTile;  // A as stored; B's big and small TF32 halves
constexpr int kThreads = 384;      // a producer warpgroup, two consumer warpgroups
constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;

struct Args {
  int rows, D, F, ldu;               // chunk rows, widths, u's row stride
  int row_tiles, col_tiles, units;  // output tiles; pass B's units are tiles x splits
  int splits, split_k;              // pass B: splits of the F sum, F columns each
};

// A block's unit of work: the output tile at (m0, n0) over stages [0, nk) of
// K from k0. Pass A's n0 is the first gate column f0 (B rows f0.. and F + f0..).
struct Unit {
  int m0, n0, k0, nk, split;
};

template <bool kGate>
__device__ __forceinline__ Unit unit_at(int u, const Args& p) {
  Unit t;
  const int rest = u / p.row_tiles;
  t.m0 = (u % p.row_tiles) * kBM;
  if (kGate) {
    t.n0 = rest * (kBN / 2);
    t.k0 = 0;
    t.nk = (p.D + kBK - 1) / kBK;
    t.split = 0;
  } else {
    t.n0 = (rest % p.col_tiles) * kBN;
    t.split = rest / p.col_tiles;
    t.k0 = t.split * p.split_k;
    t.nk = (min(p.F, t.k0 + p.split_k) - t.k0 + kBK - 1) / kBK;
  }
  return t;
}

// Pass A's epilogue: u = (h + b_h) * gelu_tanh(g + b_g); h of gate column f
// is acc column f - f0 and g column 64 + f - f0, in the same thread.
__device__ __forceinline__ void store_gate(const float (&acc)[64], const Unit& t, int r, int t4,
                                           const float* __restrict__ b_in, float* __restrict__ u,
                                           const Args& p) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = t.m0 + r + 8 * h;
    if (m >= p.rows) continue;
    float* row = u + static_cast<long long>(m) * p.ldu;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = t.n0 + 8 * j + 2 * t4;
      if (f >= p.F) continue;  // F is even: f + 1 < F too
      float2 v;
      v.x = (acc[4 * j + 2 * h] + b_in[f]) * gelu_tanh(acc[4 * (j + 8) + 2 * h] + b_in[p.F + f]);
      v.y = (acc[4 * j + 2 * h + 1] + b_in[f + 1]) *
            gelu_tanh(acc[4 * (j + 8) + 2 * h + 1] + b_in[p.F + f + 1]);
      *reinterpret_cast<float2*>(row + f) = v;
    }
  }
}

// Pass B's epilogue: y with the bias where the F sum is whole, else the
// split's partial for geglu_reduce_kernel.
__device__ __forceinline__ void store_out(const float (&acc)[64], const Unit& t, int r, int t4,
                                          const float* __restrict__ b_out, float* __restrict__ y,
                                          float* __restrict__ partial, const Args& p) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = t.m0 + r + 8 * h;
    if (m >= p.rows) continue;
    const long long row = static_cast<long long>(m) * p.D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = t.n0 + 8 * j + 2 * t4;
      if (n >= p.D) continue;  // D is even: n + 1 < D too
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (p.splits == 1) {
        v.x += b_out[n];
        v.y += b_out[n + 1];
        *reinterpret_cast<float2*>(y + row + n) = v;
      } else {
        *reinterpret_cast<float2*>(partial + static_cast<long long>(t.split) * p.rows * p.D + row + n) = v;
      }
    }
  }
}

// One persistent block: it walks units blockIdx.x, + gridDim.x, ... One
// thread keeps TMA loads in flight through a ring of kStages stages: A (x or
// u) as stored, and B's big and small TF32 halves, split once per call by
// geglu_split_weights_kernel (full: the bytes landed). Each consumer
// warpgroup takes its 64 rows of A from shared memory into registers, splits
// them, and runs the stage's 12 wgmmas (small.big, big.small, big.big for
// each of 4 k8 steps) into a fresh partial; FADD adds the partial to the
// accumulator, and the stage is freed (empty).
template <bool kGate>
__device__ __forceinline__ void run(const CUtensorMap* a_map, const CUtensorMap* big_map,
                                    const CUtensorMap* small_map, const float* __restrict__ bias,
                                    float* __restrict__ out, float* __restrict__ partial,
                                    const Args& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(a_map);
    tma_prefetch_map(big_map);
    tma_prefetch_map(small_map);
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit t = unit_at<kGate>(u, p);
      for (int kt = 0; kt < t.nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStage;
        const int k = t.k0 + kt * kBK;
        mbar_arrive_expect_tx(&full[s], kStage);
        tma_load_2d(st, a_map, &full[s], k, t.m0);
        if (kGate) {
          tma_load_2d(st + kTile, big_map, &full[s], k, t.n0);
          tma_load_2d(st + kTile + kTile / 2, big_map, &full[s], k, p.F + t.n0);
          tma_load_2d(st + 2 * kTile, small_map, &full[s], k, t.n0);
          tma_load_2d(st + 2 * kTile + kTile / 2, small_map, &full[s], k, p.F + t.n0);
        } else {
          tma_load_2d(st + kTile, big_map, &full[s], k, t.n0);
          tma_load_2d(st + 2 * kTile, small_map, &full[s], k, t.n0);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    // Row r of the tile, r % 8 == g: the thread's A rows are r and r + 8.
    const int g = lane >> 2, t4 = lane & 3;
    const int r = ((warp >> 2) - 1) * 64 + (warp & 3) * 16 + g;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit t = unit_at<kGate>(u, p);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < t.nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        __syncwarp();
        const unsigned char* st = smem + s * kStage;
        // Row r's 16-byte chunk c lies at chunk c ^ (r % 8) (128-byte swizzle).
        const float* a0 = reinterpret_cast<const float*>(st + r * 128);
        const float* a1 = a0 + 8 * 32;
        unsigned a_big[4][4], a_small[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c0 = ((2 * j) ^ g) * 4 + t4, c1 = ((2 * j + 1) ^ g) * 4 + t4;
          split_tf32_bits(a0[c0], a_big[j][0], a_small[j][0]);
          split_tf32_bits(a1[c0], a_big[j][1], a_small[j][1]);
          split_tf32_bits(a0[c1], a_big[j][2], a_small[j][2]);
          split_tf32_bits(a1[c1], a_big[j][3], a_small[j][3]);
        }
        const uint64_t d_big = sw128_desc(st + kTile), d_small = sw128_desc(st + 2 * kTile);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wgmma_m64n128k8_tf32(part, a_small[j], d_big + 2 * j, j);
          wgmma_m64n128k8_tf32(part, a_big[j], d_small + 2 * j, 1);
          wgmma_m64n128k8_tf32(part, a_big[j], d_big + 2 * j, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (kGate) {
        store_gate(acc, t, r, t4, bias, out, p);
      } else {
        store_out(acc, t, r, t4, bias, out, partial, p);
      }
    }
  }
}

}  // namespace wg

__global__ void __launch_bounds__(wg::kThreads, 1)
geglu_gate_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap big_map,
                        const __grid_constant__ CUtensorMap small_map, const float* __restrict__ b_in,
                        float* __restrict__ u, wg::Args p) {
  wg::run<true>(&x_map, &big_map, &small_map, b_in, u, nullptr, p);
}

__global__ void __launch_bounds__(wg::kThreads, 1)
geglu_out_wgmma_kernel(const __grid_constant__ CUtensorMap u_map,
                       const __grid_constant__ CUtensorMap big_map,
                       const __grid_constant__ CUtensorMap small_map, const float* __restrict__ b_out,
                       float* __restrict__ y, float* __restrict__ partial, wg::Args p) {
  wg::run<false>(&u_map, &big_map, &small_map, b_out, y, partial, p);
}

// The weights' TF32 halves, once per call: big = tf32(w), small =
// tf32(w - big), each in w's layout; n4 is the count of 16-byte groups.
__global__ void geglu_split_weights_kernel(const float4* __restrict__ w, uint4* __restrict__ big,
                                           uint4* __restrict__ small, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = w[i];
    uint4 b, s;
    split_tf32_bits(v.x, b.x, s.x);
    split_tf32_bits(v.y, b.y, s.y);
    split_tf32_bits(v.z, b.z, s.z);
    split_tf32_bits(v.w, b.w, s.w);
    big[i] = b;
    small[i] = s;
  }
}

cudaError_t split_weights(const float* w, float* big, float* small, long long n, int sms,
                          cudaStream_t s) {
  const long long n4 = n / 4, want = (n4 + 255) / 256;
  geglu_split_weights_kernel<<<static_cast<int>(want < 8LL * sms ? want : 8LL * sms), 256, 0, s>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<uint4*>(big),
      reinterpret_cast<uint4*>(small), n4);
  return cudaGetLastError();
}

// A row-major float32 matrix [rows, cols] with rows ld floats apart, read in
// boxes of 32 columns by box_rows rows, 128-byte swizzled; zeros past its
// edges.
cudaError_t tile_map(CUtensorMap* map, const float* base, int rows, int cols, long long ld,
                     int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {wg::kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                              strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// The float32 GEGLU over C rows on the warpgroup route: the weights split
// into w_split (W_in's big and small halves, then W_out's: 6 * D * F floats),
// then C walked chunk_rows at a time through the u scratch [chunk_rows, ldu],
// pass B's F sum in `splits` of split_k columns. Each pass launches one
// persistent block per SM (or per unit, where fewer).
int launch_wgmma(const float* x, const float* w_in, const float* b_in, const float* w_out,
                 const float* b_out, float* y, float* u, float* partial, float* w_split, int C,
                 int D, int F, int chunk_rows, int ldu, int splits, int split_k, int device,
                 cudaStream_t s) {
  if (C < 1 || D < 4 || F < 4 || D % 4 != 0 || F % 4 != 0 || chunk_rows < 1 || ldu < F ||
      ldu % 8 != 0 || split_k < 1 || split_k % wg::kBK != 0 || splits != (F + split_k - 1) / split_k ||
      (splits > 1 && !partial) || !aligned16(x) || !aligned16(w_in) || !aligned16(w_out) ||
      !aligned16(u) || !aligned16(w_split))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = allow_smem(geglu_gate_wgmma_kernel, wg::kSmem);
  if (err == cudaSuccess) err = allow_smem(geglu_out_wgmma_kernel, wg::kSmem);
  if (err != cudaSuccess) return err;
  const long long in_n = 2LL * F * D, out_n = static_cast<long long>(D) * F;
  float* in_big = w_split;
  float* in_small = in_big + in_n;
  float* out_big = in_small + in_n;
  float* out_small = out_big + out_n;
  err = split_weights(w_in, in_big, in_small, in_n, sms, s);
  if (err == cudaSuccess) err = split_weights(w_out, out_big, out_small, out_n, sms, s);
  if (err != cudaSuccess) return err;
  CUtensorMap in_big_map, in_small_map, out_big_map, out_small_map;
  err = tile_map(&in_big_map, in_big, 2 * F, D, D, wg::kBN / 2);
  if (err == cudaSuccess) err = tile_map(&in_small_map, in_small, 2 * F, D, D, wg::kBN / 2);
  if (err == cudaSuccess) err = tile_map(&out_big_map, out_big, D, F, F, wg::kBN);
  if (err == cudaSuccess) err = tile_map(&out_small_map, out_small, D, F, F, wg::kBN);
  if (err != cudaSuccess) return err;
  for (long long r0 = 0; r0 < C; r0 += chunk_rows) {
    const int rows = static_cast<int>(C - r0 < chunk_rows ? C - r0 : chunk_rows);
    CUtensorMap x_map, u_map;
    err = tile_map(&x_map, x + r0 * D, rows, D, D, wg::kBM);
    if (err == cudaSuccess) err = tile_map(&u_map, u, rows, F, ldu, wg::kBM);
    if (err != cudaSuccess) return err;
    const int row_tiles = (rows + wg::kBM - 1) / wg::kBM;
    wg::Args a{rows, D, F, ldu, row_tiles, (F + wg::kBN / 2 - 1) / (wg::kBN / 2), 0, 1, 0};
    a.units = row_tiles * a.col_tiles;
    geglu_gate_wgmma_kernel<<<a.units < sms ? a.units : sms, wg::kThreads, wg::kSmem, s>>>(
        x_map, in_big_map, in_small_map, b_in, u, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wg::Args b{rows, D, F, ldu, row_tiles, (D + wg::kBN - 1) / wg::kBN, 0, splits, split_k};
    b.units = row_tiles * b.col_tiles * splits;
    float* yc = y + r0 * D;
    geglu_out_wgmma_kernel<<<b.units < sms ? b.units : sms, wg::kThreads, wg::kSmem, s>>>(
        u_map, out_big_map, out_small_map, b_out, yc, partial, b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (splits == 1) continue;
    const long long size = static_cast<long long>(rows) * D;
    const long long want = (size + 255) / 256;
    geglu_reduce_kernel<float><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, s>>>(
        partial, b_out, yc, splits, size, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

NR_EXPORT int geglu_f32(const void* x, const void* w_in, const void* b_in, const void* w_out,
                        const void* b_out, void* y, void* u, void* partial, int C, int D, int F,
                        int chunk_rows, int ldu, int tile_a, int tile_b, int splits, int split_k,
                        int device, void* stream) {
  return launch<float>(x, w_in, b_in, w_out, b_out, y, u, partial, C, D, F, chunk_rows, ldu, tile_a,
                       tile_b, splits, split_k, device, stream);
}

NR_EXPORT int geglu_f32_wgmma(const void* x, const void* w_in, const void* b_in, const void* w_out,
                              const void* b_out, void* y, void* u, void* partial, void* w_split,
                              int C, int D, int F, int chunk_rows, int ldu, int splits, int split_k,
                              int device, void* stream) {
  return launch_wgmma(static_cast<const float*>(x), static_cast<const float*>(w_in),
                      static_cast<const float*>(b_in), static_cast<const float*>(w_out),
                      static_cast<const float*>(b_out), static_cast<float*>(y), static_cast<float*>(u),
                      static_cast<float*>(partial), static_cast<float*>(w_split), C, D, F, chunk_rows,
                      ldu, splits, split_k, device, static_cast<cudaStream_t>(stream));
}

NR_EXPORT int geglu_bf16(const void* x, const void* w_in, const void* b_in, const void* w_out,
                         const void* b_out, void* y, void* u, void* partial, int C, int D, int F,
                         int chunk_rows, int ldu, int tile_a, int tile_b, int splits, int split_k,
                         int device, void* stream) {
  return launch<__nv_bfloat16>(x, w_in, b_in, w_out, b_out, y, u, partial, C, D, F, chunk_rows, ldu,
                               tile_a, tile_b, splits, split_k, device, stream);
}

NR_EXPORT int geglu_f16(const void* x, const void* w_in, const void* b_in, const void* w_out,
                        const void* b_out, void* y, void* u, void* partial, int C, int D, int F,
                        int chunk_rows, int ldu, int tile_a, int tile_b, int splits, int split_k,
                        int device, void* stream) {
  return launch<__half>(x, w_in, b_in, w_out, b_out, y, u, partial, C, D, F, chunk_rows, ldu, tile_a,
                        tile_b, splits, split_k, device, stream);
}
