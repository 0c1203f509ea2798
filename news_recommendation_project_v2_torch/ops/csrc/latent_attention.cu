// Latent cross-attention: o = softmax(q k^T / sqrt(dh)) v, softmax over the
// N shared latents.
//
// Replaces: news_recommendation_project_v2_tpu/ops/pallas_attention.py,
// `_attn_kernel` (launched by `_fused_forward`, exposed as
// `fused_latent_attention`). Same function: q [B, H, L, dh]; k, v [H, N, dh],
// shared by every batch row; float32 logits, softmax and products; the output
// in q's type. No mask: pad tokens are zero rows that are dropped at the pool.
//
// What bounds it on an H100: at the tower's width (H=8, N=64, dh=512) one
// query row does 4*N*dh = 131k operations for 2*dh elements of q in and o out,
// i.e. 32 operations per byte in float32: above the float32 CUDA-core balance
// (67 TFLOP/s over 3.35 TB/s = 20), so the arithmetic bounds it once B*L is
// in the hundreds; below that, reading K and V (256 KB per head in float32)
// does. Every block reads its head's K and V again, from L2.
//
// Design, simple first:
//   * The grid is (ceil(L / 16), H, B): a block owns 16 query rows of one
//     (row, head). Blocks run in any order and share nothing. The ragged L
//     tail is masked. The flat path's [1, H, 131072, dh] maps onto the same
//     grid (8192 x 8 x 1).
//   * float32 K and V for one head (256 KB) exceed the 227 KB a block may use,
//     so K streams through shared memory in 64 x 64 chunks: logits [16, N]
//     accumulate over the dh-chunks of K in registers, then the float32
//     softmax runs in shared memory (one warp per row), then P.V is summed
//     with each thread owning output columns and reading V straight from
//     L2 (coalesced along dh).
//   * CUDA cores in float32 for both types: bfloat16 inputs are widened on
//     load. Tensor cores (wgmma) and TMA are later work.
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;   // query rows per block
constexpr int kChunk = 64;  // latents x head dims per shared-memory K chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
latent_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int L,
                        int N, int dh, int dh_pad, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                         // [kRows][dh_pad]
  float* k_s = q_s + kRows * dh_pad;         // [kChunk][kChunk + 1]
  float* p_s = k_s + kChunk * (kChunk + 1);  // [kRows][N]

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const long long bh = static_cast<long long>(blockIdx.z) * H + h;
  const T* q_bh = q + bh * L * dh;
  T* o_bh = o + bh * L * dh;
  const T* k_h = k + static_cast<long long>(h) * N * dh;
  const T* v_h = v + static_cast<long long>(h) * N * dh;
  const int rows = min(kRows, L - l0);

  for (int i = tid; i < kRows * dh_pad; i += kThreads) {
    const int r = i / dh_pad, d = i % dh_pad;
    q_s[i] = (r < rows && d < dh) ? to_float(q_bh[static_cast<long long>(l0 + r) * dh + d]) : 0.f;
  }

  // Logits: thread (nn, r0) owns latent nn of the chunk for rows r0 + 4i.
  // A warp shares r0, so its q_s reads are broadcasts; k_s rows are padded
  // to kChunk + 1 so the 32 lanes' latents fall in 32 banks.
  const int nn = tid % kChunk;
  const int r0 = tid / kChunk;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    float acc[kRows / 4] = {};
    for (int d0 = 0; d0 < dh_pad; d0 += kChunk) {
      __syncthreads();
      for (int i = tid; i < kChunk * kChunk; i += kThreads) {
        const int n = i / kChunk, d = i % kChunk;
        k_s[n * (kChunk + 1) + d] =
            (n0 + n < N && d0 + d < dh)
                ? to_float(k_h[static_cast<long long>(n0 + n) * dh + d0 + d])
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) {
        const float kv = k_s[nn * (kChunk + 1) + d];
#pragma unroll
        for (int i = 0; i < kRows / 4; ++i) acc[i] += q_s[(r0 + 4 * i) * dh_pad + d0 + d] * kv;
      }
    }
    if (n0 + nn < N) {
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) p_s[(r0 + 4 * i) * N + n0 + nn] = acc[i] * scale;
    }
  }
  __syncthreads();

  // float32 softmax over the latents, one warp per row.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* row = p_s + r * N;
    float m = -INFINITY;
    for (int n = lane; n < N; n += 32) m = fmaxf(m, row[n]);
    m = warp_max(m);
    float s = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float e = expf(row[n] - m);
      row[n] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int n = lane; n < N; n += 32) row[n] = row[n] / s;
  }
  __syncthreads();

  // o = P V: each thread owns output column c for all 16 rows.
  for (int c = tid; c < dh; c += kThreads) {
    float acc[kRows] = {};
    for (int n = 0; n < N; ++n) {
      const float vv = to_float(v_h[static_cast<long long>(n) * dh + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += p_s[r * N + n] * vv;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) o_bh[static_cast<long long>(l0 + r) * dh + c] = from_float<T>(acc[r]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int L,
           int N, int dh, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int dh_pad = (dh + kChunk - 1) / kChunk * kChunk;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kRows * dh_pad + kChunk * (kChunk + 1) + kRows * N);
  err = cudaFuncSetAttribute(latent_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  latent_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, L, N, dh, dh_pad,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

}  // namespace

NR_EXPORT int latent_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int L, int N, int dh, int device,
                                   void* stream) {
  return launch<float>(q, k, v, o, B, H, L, N, dh, device, stream);
}

NR_EXPORT int latent_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int L, int N, int dh, int device,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, L, N, dh, device, stream);
}
