// Latent cross-attention: o = softmax(q k^T / sqrt(dh)) v, softmax over the
// N shared latents.
//
// Replaces: news_recommendation_project_v2_tpu/ops/pallas_attention.py,
// `_attn_kernel` (launched by `_fused_forward`, exposed as
// `fused_latent_attention`). Same function: q [B, H, L, dh]; k, v [H, N, dh],
// shared by every batch row, in float32, bfloat16 or float16 (the Pallas
// kernel takes any float type); float32 logits, softmax and products; the
// output in q's type. No mask: pad tokens are zero rows that are dropped at the pool.
// Any N <= kMaxN and dh <= kMaxDh, ragged edges included. Nothing in a block
// is sized by dh: q, k and V stream through the ring, so dh only sets the
// number of stages, and element offsets are 64-bit.
//
// What bounds it on an H100: one query row does 4*N*dh operations for 2*dh
// elements of q in and o out. At the tower's width (N=64, dh=512) that is 32
// operations per byte in float32 and 64 in bfloat16, against a balance of 49
// (float32 as 3xTF32: 165 TFLOP/s over 3.35 TB/s) and 295 (bfloat16). So
// the bytes of q and o bound it, with the float32 products close behind; K
// and V (256 KB a head in float32) are read again by every block, from L2.
//
// Design:
//   * Folded rows. For head h the B*L query rows form one M dimension; row m
//     is (b, l) = (m / L, m % L). A block owns a [BM, slice] output tile of
//     one head: BM folded rows and one of S slices of dh. The grid is
//     (ceil(M / BM), H, S). No tile is wasted on a ragged per-batch L, and a
//     large BM cuts the per-block re-reads of K and V. Slices write disjoint
//     columns: no atomics, and the result is the same on every launch.
//   * Logits [BM, N] = Q K^T on the tensor cores, a TN product over dh: q
//     rows and k rows stream through a 4-stage cp.async ring, 64 bytes of dh
//     per row per stage, as in geglu.cu. float32 runs 3xTF32 on
//     mma.m16n8k8 (small*big + big*small + big*big); bfloat16 and float16
//     run mma.m16n8k16 with ldmatrix, whose products are exact in float32. The
//     tensor cores' own sums round toward zero, so they sum one stage into a
//     fresh partial that FADD adds to the accumulator. Logits are scaled and
//     kept in shared memory, N latents 64 at a time.
//   * The softmax runs in float32 in shared memory, 8 lanes a row, while the
//     first stages of V already stream into the ring.
//   * O = P V on the tensor cores, P kept in float32: V's [N, slice] columns
//     stream through the same ring in 16- or 32-latent stages, and the B
//     fragments are read by hand from a padded stride (no bank conflicts).
//     float32 runs 3xTF32. bfloat16 and float16 V are exact in TF32, so P V takes two
//     TF32 products, P split into big and small parts; P is never rounded
//     to bfloat16 (the Pallas kernel computes probs @ v in float32).
//   * o leaves through shared memory: each warp stages 8 rows of its tile and
//     writes them in 16-byte pieces. Storing the mma fragments straight to
//     o, 4 or 2 bytes a lane, took most of the kernel's time at many rows.
//   * Four block shapes. Large (128 rows) and Medium (64): 4 warps split the
//     rows, each computing 32 or 16 rows x 64 latents over a whole stage.
//     Pair (32 rows, 8 warps) and Small (16 rows, 4 warps): 4 warps split
//     each stage's dh, 256 bytes a row, add their logits in shared memory,
//     and take 64 columns each of a 256-column P.V tile, so a few rows pass
//     dh = 512 in 8 stages instead of 32. The planner in
//     ops/latent_attention.py picks the shape and S by rules measured on an
//     H100; each slice recomputes its tile's logits.
//   * Rows that are not 16-byte aligned, and ragged edges, take a masked
//     scalar path inside the kernel. Columns of q and k past dh and rows of V
//     past N are zeros; rows past M and latents past N are never stored.
// What limits it now (H100; PERF.md, Findings): at a few rows, one block's
// serial chain of stages, barriers and epilogues; a launch of 3 blocks takes
// nearly as long as one of 128 (ops/plan_sweep.py), and the deeper rings and
// wider stages tried did not shorten it. At many rows, moving q and o and
// re-reading K and V from L2 take most of the time, and the 3xTF32 products
// overlap them little.
// Launches on the caller's stream, allocates nothing, returns the first CUDA
// error.

#include "common.cuh"
#include "mma.cuh"

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kStages = 4;          // depth of the cp.async ring
constexpr int kChunk = 16;          // bytes per cp.async
constexpr int kTileN = 64;          // latents of a logits tile; columns of a warp's P.V tile
constexpr int kSliceCols = 16;      // a slice of dh is a whole number of these
constexpr int kMaxN = 1024, kMaxDh = 4096;  // dh: NV-Embed's pooling head
constexpr int kPadN = 32;           // N is padded to this in shared memory (the deepest P.V stage)
constexpr int kOutStride = kTileN + 8;  // floats per staged output row: no bank conflicts
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

// A block shape: BM rows. kWarpsM warps split the rows (WM each); kWarpsK
// warps split each logits stage's dh (then add their logits through shared
// memory) and each P.V stage's columns. Every warp computes WM rows x 64
// latents or columns, so it has 8 x MT independent mma tiles. Large and
// Medium (kWarpsK = 1) suit many rows; Pair and Small (kWarpsK = 4) keep a
// few rows to 8 logits stages at dh = 512 instead of 32. BM values are ROWS
// in ops/latent_attention.py, the rest its SHAPES.
template <int BM_, int WM_, int kWarpsK_, int kDepthV_, int kMinBlocks_>
struct Shape {
  static constexpr int BM = BM_, WM = WM_, kWarpsK = kWarpsK_, kDepthV = kDepthV_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kWarpsM = BM / WM, kWarps = kWarpsM * kWarpsK, kThreads = 32 * kWarps;
  static constexpr int MT = WM / 16, NT = kTileN / 8;  // mma tiles per warp
  static constexpr int kRowBytes = 64 * kWarpsK;     // dh bytes of a q or k row per stage
  static constexpr int kRowStride = kRowBytes + 16;   // padded row: no bank conflicts
  static constexpr int kCols = kTileN * kWarpsK;      // columns of a P.V stage
  static_assert(BM % (kThreads / 8) == 0 && kPadN % kDepthV == 0, "shape");
};
using Large = Shape<128, 32, 1, 32, 2>;
using Medium = Shape<64, 16, 1, 32, 3>;
using Pair = Shape<32, 16, 4, 16, 1>;
using Small = Shape<16, 16, 4, 16, 2>;

// Bytes of a V stage row of S::kCols columns, padded so that the 32 lanes'
// B-fragment reads (row t, column g) fall in distinct banks.
template <typename T, class S>
__host__ __device__ constexpr int v_stride() {
  return S::kCols * static_cast<int>(sizeof(T)) + (sizeof(T) == 4 ? 32 : 16);
}

// One ring slot: a logits stage (BM q rows and kTileN k rows) or a P.V stage
// (kDepthV rows of V), whichever is larger.
template <typename T, class S>
__host__ __device__ constexpr int slot_bytes() {
  return (S::BM + kTileN) * S::kRowStride > S::kDepthV * v_stride<T, S>()
             ? (S::BM + kTileN) * S::kRowStride
             : S::kDepthV * v_stride<T, S>();
}

// Row stride, in floats, of the logits and probabilities in shared memory:
// N padded, plus 4 so that A-fragment reads (row g, column t) fall in
// distinct banks.
__host__ __device__ inline int p_stride(int N) { return (N + kPadN - 1) / kPadN * kPadN + 4; }

// Floats of the scratch area: the warps' partial logits [kWarpsK][BM][kTileN]
// where kWarpsK > 1, and later each warp's 8 staged output rows.
template <class S>
__host__ __device__ constexpr int scratch_floats() {
  return S::kWarpsK > 1 && S::kWarpsK * S::BM * kTileN > S::kWarps * 8 * kOutStride
             ? S::kWarpsK * S::BM * kTileN
             : S::kWarps * 8 * kOutStride;
}

// The ring, the logits and probabilities [BM][p_stride], the scratch area,
// and the element offsets of the block's BM output rows.
template <typename T, class S>
int smem_bytes(int N) {
  return kStages * slot_bytes<T, S>() +
         (S::BM * p_stride(N) + scratch_floats<S>()) * static_cast<int>(sizeof(float)) +
         S::BM * static_cast<int>(sizeof(long long));
}

// Stage the 16 bytes of a row from column k into d; columns at or past k_end
// are zeros. vec: rows are 16-byte aligned, so whole chunks go by cp.async.
template <typename T>
__device__ __forceinline__ void load_chunk(unsigned char* d, const T* row, int k, int k_end, bool vec) {
  constexpr int E = kChunk / sizeof(T);
  if (vec && k + E <= k_end) {
    cp_async16(d, row + k);
  } else {
    T* dt = reinterpret_cast<T*>(d);
#pragma unroll
    for (int e = 0; e < E; ++e) dt[e] = k + e < k_end ? row[k + e] : from_float<T>(0.f);
  }
}

// The ring: issue(t) starts stage t's copies into slot t % kStages and
// commits a group (an empty one past the last stage keeps the count).
// The prologue may run well before the loop; work between them overlaps the
// first copies.
template <class Issue>
__device__ __forceinline__ void ring_prologue(Issue issue) {
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
}

template <class Issue, class Compute>
__device__ __forceinline__ void ring_loop(int count, Issue issue, Compute compute) {
  for (int t = 0; t < count; ++t) {
    cp_async_wait<kStages - 2>();  // stage t has landed ...
    __syncthreads();                // ... for every thread, and stage t-1 is free
    issue(t + kStages - 1);
    compute(t);
  }
}

// The logits of a warp's 64 bytes of one stage (bytes 64*wk..) into its
// accumulators: A rows are the block's q rows wm.., B rows the tile's 64 k
// rows, both contiguous along dh. As geglu.cu's mma_stage: a fresh partial
// per stage, added by FADD (the tensor cores' sums round toward zero).
template <typename T, class S>
__device__ __forceinline__ void logits_stage(float (&acc)[S::MT][S::NT][4], const unsigned char* st,
                                             int wm, int wk) {
  const int lane = threadIdx.x & 31;
  float part[S::MT][S::NT][4] = {};
  if constexpr (std::is_same<T, float>::value) {
    constexpr int L = S::kRowStride / 4;  // floats per padded row
    const float* as = reinterpret_cast<const float*>(st) + wk * 16;
    const float* bs = reinterpret_cast<const float*>(st + S::BM * S::kRowStride) + wk * 16;
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
        const float* p = bs + (j * 8 + g) * L + ks + t;
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
    const unsigned a_base = smem_addr(st) + wk * 64, b_base = a_base + S::BM * S::kRowStride;
#pragma unroll
    for (int ks = 0; ks < 64; ks += 32) {  // two k16 steps of 32 bytes
      unsigned a[S::MT][4], b[S::NT][2];
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
        ldmatrix_x4(a[i][0], a[i][1], a[i][2], a[i][3],
                    a_base + (wm + i * 16 + (lane & 15)) * S::kRowStride + ks + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        const int n = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
                    b_base + n * S::kRowStride + ks + ((lane >> 3) & 1) * 16);
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

// A V element as a TF32 operand: float32 is split in two; bfloat16's 8
// significant bits already fit TF32's 11, so its bits are the operand.
// float16's 11 significant bits fit TF32 exactly too, but its exponent and
// mantissa lie elsewhere: converted to float32, the value is its big part
// alone.
__device__ __forceinline__ void v_operand(float x, unsigned& big, unsigned& small) {
  split_tf32(x, big, small);
}
__device__ __forceinline__ void v_operand(__nv_bfloat16 x, unsigned& big, unsigned&) {
  big = static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16;
}
__device__ __forceinline__ void v_operand(__half x, unsigned& big, unsigned&) {
  big = __float_as_uint(__half2float(x));
}

// P.V of one stage (kDepthV latents from column kp of P) into the warp's
// accumulators: rows wm.., columns 64*wk.. of the stage. A = P, float32 in
// shared memory, split big + small; B = the staged V rows. float32 V takes
// three TF32 products, bfloat16 and float16 V two (the small part is zero).
template <typename T, class S>
__device__ __forceinline__ void pv_stage(float (&acc)[S::MT][S::NT][4], const float* p_s, int ps,
                                         int kp, const unsigned char* st, int wm, int wk) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int VS = v_stride<T, S>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float part[S::MT][S::NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < S::kDepthV; ks += 8) {
    unsigned a_big[S::MT][4], a_small[S::MT][4], b_big[S::NT][2], b_small[S::NT][2];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      const float* p = p_s + (wm + i * 16 + g) * ps + kp + ks + t;
      split_tf32(p[0], a_big[i][0], a_small[i][0]);
      split_tf32(p[8 * ps], a_big[i][1], a_small[i][1]);
      split_tf32(p[4], a_big[i][2], a_small[i][2]);
      split_tf32(p[8 * ps + 4], a_big[i][3], a_small[i][3]);
    }
    const T* v0 = reinterpret_cast<const T*>(st + (ks + t) * VS) + wk * kTileN + g;
    const T* v1 = reinterpret_cast<const T*>(st + (ks + t + 4) * VS) + wk * kTileN + g;
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      v_operand(v0[j * 8], b_big[j][0], b_small[j][0]);
      v_operand(v1[j * 8], b_big[j][1], b_small[j][1]);
    }
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j) mma_tf32(part[i][j], a_small[i], b_big[j]);
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(part[i][j], a_big[i], b_small[j]);
    }
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j) mma_tf32(part[i][j], a_big[i], b_big[j]);
  }
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
}

// Write 8 staged rows of 64 float32 values (row stride kOutStride) to o,
// converted to T: 16 bytes a lane where the row is aligned and whole, else
// element by element. Row r goes to o + row_at[r] + c (-1: past M); columns
// at or past c_end are not written.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ o, const float* staged,
                                           const long long* row_at, int c, int c_end, bool vec) {
  constexpr int E = kChunk / sizeof(T);        // elements a lane stores
  constexpr int kLanesPerRow = kTileN / E;     // 16 (float) or 8 (16-bit types)
  constexpr int kRowsPerPass = 32 / kLanesPerRow;
  const int lane = threadIdx.x & 31;
  const int col = (lane % kLanesPerRow) * E;
#pragma unroll
  for (int pass = 0; pass < 8 / kRowsPerPass; ++pass) {
    const int r = pass * kRowsPerPass + lane / kLanesPerRow;
    const long long at = row_at[r];
    if (at < 0 || c + col >= c_end) continue;
    const float* src = staged + r * kOutStride + col;
    T* dst = o + at + c + col;
    if (vec && c + col + E <= c_end) {
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else if constexpr (std::is_same<T, __half>::value) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        alignas(16) __half2 packed[4] = {__floats2half2_rn(a.x, a.y), __floats2half2_rn(a.z, a.w),
                                         __floats2half2_rn(b.x, b.y), __floats2half2_rn(b.z, b.w)};
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        alignas(16) __nv_bfloat162 packed[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                                    __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
      }
    } else {
      for (int e = 0; e < E && c + col + e < c_end; ++e) dst[e] = from_float<T>(src[e]);
    }
  }
}

// Element offset of folded row m of head h in q and o.
__device__ __forceinline__ long long row_offset(int m, int h, int H, int L, int dh) {
  const int b = m / L;
  return ((static_cast<long long>(b) * H + h) * L + (m - b * L)) * dh;
}

// Block (bx, h, s) owns folded rows bx*BM.. of head h and output columns
// [s*slice_cols, min(dh, (s+1)*slice_cols)).
template <typename T, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
latent_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ o, int M, int H, int L, int N, int dh, int slice_cols,
                        bool vec, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSlot = slot_bytes<T, S>();
  constexpr int E = kChunk / sizeof(T);  // elements per chunk
  constexpr int kChunks = S::kRowBytes / kChunk;
  const int ps = p_stride(N);
  float* p_s = reinterpret_cast<float*>(smem + kStages * kSlot);  // [BM][ps]
  float* partials = p_s + S::BM * ps;  // scratch: [kWarpsK][BM][kTileN], where kWarpsK > 1
  long long* row_at = reinterpret_cast<long long*>(partials + scratch_floats<S>());  // [BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp % S::kWarpsM) * S::WM, wk = warp / S::kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * S::BM, h = blockIdx.y;
  const int c0 = blockIdx.z * slice_cols, c_end = min(dh, c0 + slice_cols);
  const T* k_h = k + static_cast<long long>(h) * N * dh;
  const T* v_h = v + static_cast<long long>(h) * N * dh;

  // Where each output row starts (-1: past M); first read after a barrier.
  for (int r = tid; r < S::BM; r += S::kThreads)
    row_at[r] = m0 + r < M ? row_offset(m0 + r, h, H, L, dh) : -1;

  // The q rows this thread stages, fixed for every stage (-1: past M).
  constexpr int kQ = S::BM * kChunks;
  constexpr int kQIters = (kQ + S::kThreads - 1) / S::kThreads;
  long long q_off[kQIters];
#pragma unroll
  for (int it = 0; it < kQIters; ++it) {
    const int i = it * S::kThreads + tid, m = m0 + i / kChunks;
    q_off[it] = i < kQ && m < M ? row_offset(m, h, H, L, dh) : -1;
  }

  // Logits, N latents kTileN at a time: stage t is dh columns
  // (t % nk)*BK.. of latent tile t / nk.
  constexpr int BK = S::kRowBytes / sizeof(T);
  const int nk = (dh + BK - 1) / BK;
  const int n_qk = nk * ((N + kTileN - 1) / kTileN);
  auto issue_qk = [&](int t) {
    if (t < n_qk) {
      unsigned char* st = smem + (t % kStages) * kSlot;
      const int n0 = (t / nk) * kTileN, d0 = (t % nk) * BK;
#pragma unroll
      for (int it = 0; it < kQIters; ++it) {
        const int i = it * S::kThreads + tid;
        if (q_off[it] >= 0)
          load_chunk(st + (i / kChunks) * S::kRowStride + (i % kChunks) * kChunk, q + q_off[it],
                     d0 + (i % kChunks) * E, dh, vec);
      }
#pragma unroll
      for (int it = 0; it < kTileN * kChunks / S::kThreads; ++it) {
        const int i = it * S::kThreads + tid, r = i / kChunks, c = i % kChunks;
        if (n0 + r < N)
          load_chunk(st + (S::BM + r) * S::kRowStride + c * kChunk,
                     k_h + static_cast<long long>(n0 + r) * dh, d0 + c * E, dh, vec);
      }
    }
    cp_async_commit();
  };

  float acc[S::MT][S::NT][4] = {};
  ring_prologue(issue_qk);
  ring_loop(n_qk, issue_qk, [&](int t) {
    logits_stage<T, S>(acc, smem + (t % kStages) * kSlot, wm, wk);
    if (t % nk != nk - 1) return;
    const int n0 = (t / nk) * kTileN;
    float* dst = S::kWarpsK > 1 ? partials + wk * S::BM * kTileN : p_s;
    const int ld = S::kWarpsK > 1 ? kTileN : ps;
    const int col0 = S::kWarpsK > 1 ? 0 : n0;
    const float to_p = S::kWarpsK > 1 ? 1.f : scale;  // partials are scaled once added
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = j * 8 + 2 * t4 + (r & 1);
          if (n0 + n < N) dst[(wm + i * 16 + g + (r >> 1) * 8) * ld + col0 + n] = acc[i][j][r] * to_p;
          acc[i][j][r] = 0.f;
        }
    if constexpr (S::kWarpsK > 1) {
      // The warps' logits over their parts of dh, added in warp order.
      __syncthreads();
      for (int i = tid; i < S::BM * kTileN; i += S::kThreads) {
        const int r = i / kTileN, n = i % kTileN;
        if (n0 + n >= N) continue;
        float sum = partials[i];
#pragma unroll
        for (int w = 1; w < S::kWarpsK; ++w) sum += partials[w * S::BM * kTileN + i];
        p_s[r * ps + n0 + n] = sum * scale;
      }
    }
  });
  __syncthreads();  // every logit is in p_s, and the ring is free

  // P.V: stage t is latents (t % nv)*kDepthV.. of column tile t / nv of the
  // slice, S::kCols columns wide. Its first stages load during the softmax.
  constexpr int VS = v_stride<T, S>();
  constexpr int kVChunks = S::kCols * static_cast<int>(sizeof(T)) / kChunk;
  const int nv = (N + S::kDepthV - 1) / S::kDepthV;
  const int n_pv = nv * ((c_end - c0 + S::kCols - 1) / S::kCols);
  auto issue_v = [&](int t) {
    if (t < n_pv) {
      unsigned char* st = smem + (t % kStages) * kSlot;
      const int n0 = (t % nv) * S::kDepthV, cc = c0 + (t / nv) * S::kCols;
#pragma unroll
      for (int it = 0; it < S::kDepthV * kVChunks / S::kThreads; ++it) {
        const int i = it * S::kThreads + tid, r = i / kVChunks, c = i % kVChunks;
        if (cc + c * E >= c_end) continue;  // past the slice: feeds only columns never stored
        const int n = n0 + r;  // V rows past N are zeros: P is 0 there, and 0 * stale may be NaN
        load_chunk(st + r * VS + c * kChunk, v_h + static_cast<long long>(n < N ? n : 0) * dh,
                   cc + c * E, n < N ? c_end : 0, vec);
      }
    }
    cp_async_commit();
  };
  ring_prologue(issue_v);

  // float32 softmax over the latents, 8 lanes a row and 4 rows a warp at a
  // time; P is zero past N. Rows past M are computed too (their values are
  // never stored), so that every lane takes part in every shuffle.
  const int sub = lane & 7;
  for (int r = warp * 4 + (lane >> 3); r < S::BM; r += S::kThreads / 8) {
    float* row = p_s + r * ps;
    float mx = -INFINITY;
    for (int n = sub; n < N; n += 8) mx = fmaxf(mx, row[n]);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int n = sub; n < N; n += 8) {
      const float e = expf(row[n] - mx);
      row[n] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int n = sub; n < ps - 4; n += 8) row[n] = n < N ? row[n] / sum : 0.f;
  }

  // A warp's output tile goes out 8 rows at a time through its staging rows
  // in the scratch area, so that o is written in whole 16-byte pieces.
  float* staged = partials + warp * 8 * kOutStride;
  const bool vec_o = vec && reinterpret_cast<std::uintptr_t>(o) % kChunk == 0;

  ring_loop(n_pv, issue_v, [&](int t) {
    pv_stage<T, S>(acc, p_s, ps, (t % nv) * S::kDepthV, smem + (t % kStages) * kSlot, wm, wk);
    if (t % nv != nv - 1) return;
    const int cc = c0 + (t / nv) * S::kCols + wk * kTileN;
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < S::NT; ++j) {
          *reinterpret_cast<float2*>(staged + g * kOutStride + j * 8 + 2 * t4) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
          acc[i][j][2 * half] = acc[i][j][2 * half + 1] = 0.f;
        }
        __syncwarp();
        store_rows(o, staged, row_at + wm + i * 16 + half * 8, cc, c_end, vec_o);
        __syncwarp();
      }
  });
}

template <typename T, class S>
cudaError_t run(const T* q, const T* k, const T* v, T* o, int M, int H, int L, int N, int dh,
                int slices, int slice_cols, cudaStream_t stream) {
  const int smem = smem_bytes<T, S>(N);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  // Ask for the shared memory once per device and size, not on every launch:
  // a serving call is short enough for host costs to show.
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > allowed[device]) {
    err = cudaFuncSetAttribute(latent_attention_kernel<T, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) allowed[device] = smem;
  }
  auto aligned = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % kChunk == 0; };
  const bool vec = aligned(q) && aligned(k) && aligned(v) && dh * sizeof(T) % kChunk == 0;
  const dim3 grid((M + S::BM - 1) / S::BM, H, slices);
  latent_attention_kernel<T, S><<<grid, S::kThreads, smem, stream>>>(
      q, k, v, o, M, H, L, N, dh, slice_cols, vec,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

// The plan (rows a block, slices of dh and their width) comes from
// ops/latent_attention.py::plan_attention; it is checked here again.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int L, int N, int dh,
           int rows, int slices, int slice_cols, int device, void* stream) {
  const long long M = static_cast<long long>(B) * L;
  if (B < 1 || L < 1 || H < 1 || H > 65535 || N < 1 || N > kMaxN || dh < 1 || dh > kMaxDh ||
      M > INT_MAX || slice_cols < kSliceCols || slice_cols % kSliceCols != 0 ||
      slices != (dh + slice_cols - 1) / slice_cols)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M);
  switch (rows) {
    case Large::BM: return run<T, Large>(qt, kt, vt, ot, m, H, L, N, dh, slices, slice_cols, s);
    case Medium::BM: return run<T, Medium>(qt, kt, vt, ot, m, H, L, N, dh, slices, slice_cols, s);
    case Pair::BM: return run<T, Pair>(qt, kt, vt, ot, m, H, L, N, dh, slices, slice_cols, s);
    case Small::BM: return run<T, Small>(qt, kt, vt, ot, m, H, L, N, dh, slices, slice_cols, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

NR_EXPORT int latent_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int L, int N, int dh, int rows, int slices,
                                   int slice_cols, int device, void* stream) {
  return launch<float>(q, k, v, o, B, H, L, N, dh, rows, slices, slice_cols, device, stream);
}

// Shared memory of a block of `rows` rows at N latents for elements of
// `element_bytes` (4: float32; 2: bfloat16 or float16, laid out alike), or
// -1 where no such shape or size exists, for ops/latent_attention.py's
// planner to be checked against.
template <class S>
int smem_of(int N, int element_bytes) {
  return element_bytes == 4 ? smem_bytes<float, S>(N)
         : element_bytes == 2 ? smem_bytes<__half, S>(N)
                              : -1;
}

NR_EXPORT int latent_attention_smem(int rows, int N, int element_bytes) {
  switch (rows) {
    case Large::BM: return smem_of<Large>(N, element_bytes);
    case Medium::BM: return smem_of<Medium>(N, element_bytes);
    case Pair::BM: return smem_of<Pair>(N, element_bytes);
    case Small::BM: return smem_of<Small>(N, element_bytes);
    default: return -1;
  }
}

NR_EXPORT int latent_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int L, int N, int dh, int rows, int slices,
                                    int slice_cols, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, L, N, dh, rows, slices, slice_cols, device,
                               stream);
}

NR_EXPORT int latent_attention_f16(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int L, int N, int dh, int rows, int slices,
                                   int slice_cols, int device, void* stream) {
  return launch<__half>(q, k, v, o, B, H, L, N, dh, rows, slices, slice_cols, device, stream);
}
