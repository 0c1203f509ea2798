// The routed experts of a mixture-of-experts layer (DeepSeek-V3's, as
// Moonlight-16B-A3B runs it) as two grouped GEMMs in bf16:
//
//   gate-up  h = round(silu(round(x W_g^T)) * round(x W_u^T)) per row under
//            its expert's [2I, D] weights (gate rows, then up rows): one
//            launch, the SwiGLU in its epilogue, h in bf16 [M, I];
//   down     y = round(h W_d^T) * w_row per row under its expert's [D, I]
//            weights, scaled by the row's routing weight: one launch, y in
//            float32 [M, D].
//
// The rows come sorted by expert; offsets [E + 1] (int32, device memory)
// give each expert's first row and M last. The host never reads them: each
// block works the experts' row tiles out of them in shared memory, and the
// grid is sized for the most tiles M rows can make (M / 128 + E row tiles).
// The rounding follows torch's bf16 ops (a product rounds to bf16, silu
// and the gating product too), so the plain version (ops/moe.py) differs only
// in the order of the float32 sums.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts layer.
// It was added because no kernel the port has multiplies groups of rows
// whose sizes live on the device, and a loop over experts on the host would
// wait for the device in every layer.
//
// What bounds it on an H100: at an encode batch of N tokens, 6N rows go
// through 64 experts, ~6N / 64 rows an expert (~12,000 at N = 131,072), so
// the products far outweigh the experts' weights (369 MB gate-up, 185 MB
// down, read once a launch): compute-bound, at 989 TFLOP/s of bf16.
//
// Design: persistent blocks, one an SM, walk 128 x 128 output tiles (gate-up:
// 64 gate columns beside the same 64 up columns, so a thread holds g and u of
// its output columns), tiles of one row tile next to each other, so the
// blocks in flight share A rows and one expert's weights in L2. One producer
// thread keeps TMA loads of A and B in flight through a 5-stage ring of
// 128-byte-swizzled 64-wide bf16 stages (mbarriers full and empty); two
// consumer warpgroups (setmaxnreg: 232 registers against the producer's 40)
// each run four wgmma.m64n128k16 a stage on 64 rows, both operands from
// shared memory, and free a stage as soon as the next stage's products are
// under way. Rows past an expert's last, read by a tile that crosses into the
// next expert, are computed and not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;              // tile rows: two consumer warpgroups of 64
constexpr int kBN = 128;              // tile columns (gate-up: 64 of gate, then the same 64 of up)
constexpr int kBK = 64;               // K bf16 a stage: one 128-byte swizzled row
constexpr int kStages = 5;            // depth of the TMA ring
constexpr int kTile = kBM * kBK * 2;  // bytes of a 128-row operand tile, one stage deep
constexpr int kStage = 2 * kTile;     // A, then B
constexpr int kThreads = 384;         // a producer warpgroup, two consumer warpgroups
constexpr int kMaxExperts = 256;
constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8 + 2 * (kMaxExperts + 1) * 4;

struct Args {
  int rows;       // M: rows in expert order
  int experts;    // E
  int K;          // the sum: D (gate-up) or I (down)
  int N;          // output columns: I (gate-up) or D (down)
  int col_tiles;  // output column tiles
  int b_rows;     // rows of one expert's B: 2I (gate-up) or D (down)
};

// A block's unit: rows [m0, m_end) of the tile that starts at m0 (m_end the
// expert's last row + 1), output columns from n0, the expert's B rows from b0.
struct Unit {
  int m0, m_end, n0, b0;
};

template <bool kGateUp>
__device__ __forceinline__ Unit unit_at(int u, const Args& p, const int* first_row,
                                        const int* first_tile) {
  const int rt = u / p.col_tiles, ct = u % p.col_tiles;
  int lo = 0, hi = p.experts;  // the last expert whose first row tile is at or before rt
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first_tile[mid] <= rt) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  Unit t;
  t.m0 = first_row[lo] + (rt - first_tile[lo]) * kBM;
  t.m_end = min(first_row[lo + 1], p.rows);
  t.n0 = ct * (kGateUp ? kBN / 2 : kBN);
  t.b0 = lo * p.b_rows + t.n0;
  return t;
}

__device__ __forceinline__ float silu_gate(float g, float u) {
  const float gr = round_to<__nv_bfloat16>(g);
  const float s = round_to<__nv_bfloat16>(gr / (1.f + expf(-gr)));
  return s * round_to<__nv_bfloat16>(u);
}

// Gate-up's epilogue: h of gate column f is acc column f - n0 (g) beside
// column 64 + f - n0 (u), in the same thread.
__device__ __forceinline__ void store_gate_up(const float (&acc)[64], const Unit& t, int r, int t4,
                                              __nv_bfloat16* __restrict__ h, const Args& p) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = t.m0 + r + 8 * hh;
    if (m >= t.m_end) continue;
    __nv_bfloat16* row = h + static_cast<long long>(m) * p.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = t.n0 + 8 * j + 2 * t4;
      if (f >= p.N) continue;  // N is even: f + 1 < N too
      const float a = silu_gate(acc[4 * j + 2 * hh], acc[4 * (j + 8) + 2 * hh]);
      const float b = silu_gate(acc[4 * j + 2 * hh + 1], acc[4 * (j + 8) + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(row + f) = __floats2bfloat162_rn(a, b);
    }
  }
}

// Down's epilogue: the expert's output rounded to bf16, times the row's
// routing weight, in float32.
__device__ __forceinline__ void store_down(const float (&acc)[64], const Unit& t, int r, int t4,
                                           const float* __restrict__ pair_w, float* __restrict__ y,
                                           const Args& p) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = t.m0 + r + 8 * hh;
    if (m >= t.m_end) continue;
    const float w = pair_w[m];
    float* row = y + static_cast<long long>(m) * p.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = t.n0 + 8 * j + 2 * t4;
      if (n >= p.N) continue;
      *reinterpret_cast<float2*>(row + n) =
          make_float2(round_to<__nv_bfloat16>(acc[4 * j + 2 * hh]) * w,
                      round_to<__nv_bfloat16>(acc[4 * j + 2 * hh + 1]) * w);
    }
  }
}

template <bool kGateUp>
__device__ __forceinline__ void run(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                    const int* __restrict__ offsets, const float* __restrict__ pair_w,
                                    void* __restrict__ out, const Args& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  int* first_row = reinterpret_cast<int*>(empty + kStages);
  int* first_tile = first_row + kMaxExperts + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
    int tiles = 0;
    for (int e = 0; e < p.experts; ++e) {
      first_row[e] = offsets[e];
      first_tile[e] = tiles;
      tiles += (offsets[e + 1] - offsets[e] + kBM - 1) / kBM;
    }
    first_row[p.experts] = offsets[p.experts];
    first_tile[p.experts] = tiles;
  }
  __syncthreads();
  const int units = first_tile[p.experts] * p.col_tiles;
  const int nk = (p.K + kBK - 1) / kBK;

  if (warp < 4) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(a_map);
    tma_prefetch_map(b_map);
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_at<kGateUp>(u, p, first_row, first_tile);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStage;
        const int k = kt * kBK;
        mbar_arrive_expect_tx(&full[s], kStage);
        tma_load_2d(st, a_map, &full[s], k, t.m0);
        if (kGateUp) {
          tma_load_2d(st + kTile, b_map, &full[s], k, t.b0);
          tma_load_2d(st + kTile + kTile / 2, b_map, &full[s], k, t.b0 + p.N);
        } else {
          tma_load_2d(st + kTile, b_map, &full[s], k, t.b0);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int g = lane >> 2, t4 = lane & 3;
    const int wg = (warp >> 2) - 1;
    const int r = wg * 64 + (warp & 3) * 16 + g;
    float acc[64];
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_at<kGateUp>(u, p, first_row, first_tile);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        __syncwarp();
        const unsigned char* st = smem + s * kStage;
        const uint64_t da = sw128_desc(st + wg * (kTile / 2)), db = sw128_desc(st + kTile);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_m64n128k16_bf16(acc, da + 2 * j, db + 2 * j, kt > 0 || j > 0);
        wgmma_commit();
        // The stage before this one has its products done: free it.
        wgmma_wait<1>();
        __syncwarp();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      if (kGateUp) {
        store_gate_up(acc, t, r, t4, static_cast<__nv_bfloat16*>(out), p);
      } else {
        store_down(acc, t, r, t4, pair_w, static_cast<float*>(out), p);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
moe_experts_gate_up_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map, const int* __restrict__ offsets,
                           __nv_bfloat16* __restrict__ h, Args p) {
  run<true>(&x_map, &w_map, offsets, nullptr, h, p);
}

__global__ void __launch_bounds__(kThreads, 1)
moe_experts_down_kernel(const __grid_constant__ CUtensorMap h_map,
                        const __grid_constant__ CUtensorMap w_map, const int* __restrict__ offsets,
                        const float* __restrict__ pair_w, float* __restrict__ y, Args p) {
  run<false>(&h_map, &w_map, offsets, pair_w, y, p);
}

// A row-major bf16 matrix [rows, cols], read in boxes of 64 columns by
// box_rows rows, 128-byte swizzled; zeros past its edges.
cudaError_t tile_map(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                              strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// One grouped launch over M rows: gate-up (a = x [M, D], w [E, 2I, D], out
// h [M, I] bf16) or down (a = h [M, I], w [E, D, I], pair_w [M], out y
// [M, D] float32); one persistent block an SM, or one a unit where M rows
// can make fewer units.
int launch(bool gate_up, const void* a, const void* w, const void* offsets, const void* pair_w,
           void* out, int M, int E, int D, int I, int device, cudaStream_t s) {
  if (M < 1 || E < 1 || E > kMaxExperts || D < kBK || I < kBK || D % kBK != 0 || I % kBK != 0 ||
      !aligned16(a) || !aligned16(w) || !aligned16(out) || offsets == nullptr ||
      (!gate_up && pair_w == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int K = gate_up ? D : I, N = gate_up ? I : D;
  const int col_tiles = gate_up ? (I + kBN / 2 - 1) / (kBN / 2) : (D + kBN - 1) / kBN;
  const Args p{M, E, K, N, col_tiles, gate_up ? 2 * I : D};
  CUtensorMap a_map, w_map;
  err = tile_map(&a_map, a, M, K, kBM);
  if (err == cudaSuccess)
    err = tile_map(&w_map, w, static_cast<long long>(E) * p.b_rows, K, gate_up ? kBN / 2 : kBN);
  if (err != cudaSuccess) return err;
  const long long most = (static_cast<long long>(M + kBM - 1) / kBM + E) * col_tiles;
  const int grid = static_cast<int>(most < sms ? most : sms);
  const int* off = static_cast<const int*>(offsets);
  if (gate_up) {
    err = cudaFuncSetAttribute(moe_experts_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    moe_experts_gate_up_kernel<<<grid, kThreads, kSmem, s>>>(a_map, w_map, off,
                                                             static_cast<__nv_bfloat16*>(out), p);
  } else {
    err = cudaFuncSetAttribute(moe_experts_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    moe_experts_down_kernel<<<grid, kThreads, kSmem, s>>>(
        a_map, w_map, off, static_cast<const float*>(pair_w), static_cast<float*>(out), p);
  }
  return cudaGetLastError();
}

}  // namespace

NR_EXPORT int moe_experts_gate_up_bf16(const void* x, const void* w_gate_up, const void* offsets,
                                       void* h, int M, int E, int D, int I, int device, void* stream) {
  return launch(true, x, w_gate_up, offsets, nullptr, h, M, E, D, I, device,
                static_cast<cudaStream_t>(stream));
}

NR_EXPORT int moe_experts_down_bf16(const void* h, const void* w_down, const void* offsets,
                                    const void* pair_w, void* y, int M, int E, int D, int I, int device,
                                    void* stream) {
  return launch(false, h, w_down, offsets, pair_w, y, M, E, D, I, device,
                static_cast<cudaStream_t>(stream));
}
