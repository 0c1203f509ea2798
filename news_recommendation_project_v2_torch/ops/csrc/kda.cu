// Kimi Delta Attention's recurrence (the Kimi Linear report, arXiv:2510.26692)
// in chunks of 16 tokens, forward only: per row and head, S_0 = 0,
//
//   S_t = (I - b_t k_t k_t^T) Diag(a_t) S_{t-1} + b_t k_t v_t^T,   o_t = S_t^T q_t,
//
// q, k, v bf16 [B, T, H, 128] (q and k L2-normalised, q scaled), log a
// float32 [B, T, H, 128], b float32 [B, T, H], lens int32 [B] or null; o bf16
// [B, T, H, 128], 0 past a row's length. The chunked form is ops/kda.py's
// plain version, step for step:
//
//   A[t][j] = b_t sum_c k_t k_j exp(G_t - G_j) (j < t),  P[t][j] = sum_c q_t k_j exp(G_t - G_j) (j <= t)
//   (I + A) W_k = b exp(G) K,  (I + A) W_v = b V         (forward substitution)
//   U = W_v - W_k S,  O = exp(G) Q S + P U,  S <- exp(G_last) S + (exp(G_last - G) K)^T U
//
// with G the cumulative log-decay inside the chunk. Each exponent is a decay
// from a later token back to an earlier one (at most 0), computed per channel
// and per pair, so a chunk whose log-decays reach -1,000 underflows to 0
// where the true factor does and never overflows.
//
// Replaces no TPU kernel: the JAX package has no linear-attention layer. It
// was added because no kernel of the port computes a delta rule, and a plain
// loop over tokens launches tens of kernels a token.
//
// Design: one block of 128 threads a (row, head), walking the row's chunks in
// order; chunks past the row's length are not computed (their o written 0).
// A chunk's inputs arrive by cp.async one chunk ahead (double buffered). The
// dk side of a chunk (A, P, W_k, the decayed q and k) is shared by the four
// warps: a thread a channel for the cumulative decays and the substitution,
// a thread a (t, j) pair for A and P. The state lies in registers, S^T split
// by value columns: warp w holds rows 32w..32w+31 of S^T (32 x 128 float32,
// 128 a thread) as mma.sync m16n8k8 TF32 accumulators, and computes its
// columns of U, O and the new state with the accumulators fed back as A
// fragments (the k index permuted (t4, t4 + 4) -> (2 t4, 2 t4 + 1) on both
// operands, which leaves the sums unchanged). Products take TF32 operands and
// sum in float32; the state stays float32.
//
// What bounds it on an H100: the chain of dependent steps inside a chunk
// (four block-wide barriers, then three rounds of mma.sync per warp) and the
// 34,816 exponentials a chunk; two blocks an SM (110 KB of shared memory, 128
// threads at up to 255 registers each).
//
// Two elementwise kernels of the KDA layer sit beside it, each a warp a
// (token, head) with 4 channels a lane, float32 inside, one rounding out:
// kda_prep (the causal depthwise convs of width 4 and SiLU of q, k and v, the
// L2 norms of q and k and q's scale, log a = -exp(A_log[h]) softplus(f +
// dt_bias)) and kda_gated_norm (o's per-head RMSNorm times its weight times
// sigmoid(gate)). Both are bound by bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kC = 16;          // chunk tokens
constexpr int kD = 128;         // head dim (dk = dv)
constexpr int kThreads = 128;   // a thread a channel
constexpr int kRaw = kD + 1;    // pair-loop rows: a row a bank offset
constexpr int kF2 = kD + 8;     // rows read as float2 B fragments along dk
constexpr int kCol = kD + 4;    // rows read as scalar B fragments along tokens
constexpr int kPS = kC + 8;

struct Smem {
  __nv_bfloat16 q[2][kC][kD], k[2][kC][kD], v[2][kC][kD];
  float a[2][kC][kD];
  float beta[2][kC];
  float kr[kC][kRaw], qr[kC][kRaw], gr[kC][kRaw];
  float A[kC][kPS], P[kC][kPS];
  float qt[kC][kF2], wk[kC][kF2];
  float khat[kC][kCol], wv[kC][kCol], o[kC][kCol];
  float gamma[kD];
};

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The chunk starting at token t0 into buffer s: q, k, v, log a by cp.async
// (zeros past T), b by plain loads.
__device__ __forceinline__ void load_chunk(Smem& sm, int s, const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, const float* la, const float* beta,
                                           long long row0, int t0, int T, int H) {
  const int tid = threadIdx.x;
  // bf16 rows: 16 tokens x 256 bytes = 256 pieces of 16 bytes each.
  for (int p = tid; p < kC * kD / 8; p += kThreads) {
    const int t = p / (kD / 8), c = (p % (kD / 8)) * 8;
    const long long g = ((row0 + t0 + t) * H) * kD + c;
    if (t0 + t < T) {
      cp_async16(&sm.q[s][t][c], q + g);
      cp_async16(&sm.k[s][t][c], k + g);
      cp_async16(&sm.v[s][t][c], v + g);
    } else {
      *reinterpret_cast<uint4*>(&sm.q[s][t][c]) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&sm.k[s][t][c]) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&sm.v[s][t][c]) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int p = tid; p < kC * kD / 4; p += kThreads) {
    const int t = p / (kD / 4), c = (p % (kD / 4)) * 4;
    if (t0 + t < T) {
      cp_async16(&sm.a[s][t][c], la + ((row0 + t0 + t) * H) * kD + c);
    } else {
      *reinterpret_cast<float4*>(&sm.a[s][t][c]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (tid < kC) sm.beta[s][tid] = t0 + tid < T ? beta[(row0 + t0 + tid) * H] : 0.f;
}

__global__ void __launch_bounds__(kThreads, 2)
kda_chunked_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ log_alpha,
                   const float* __restrict__ beta, const int* __restrict__ lens, __nv_bfloat16* __restrict__ o,
                   int T, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long row0 = static_cast<long long>(b) * T;
  // Offsets of this head in [B, T, H, *]: token t of the row at (row0 + t) * H.
  const __nv_bfloat16* qh = q + static_cast<long long>(h) * kD;
  const __nv_bfloat16* kh = k + static_cast<long long>(h) * kD;
  const __nv_bfloat16* vh = v + static_cast<long long>(h) * kD;
  const float* lah = log_alpha + static_cast<long long>(h) * kD;
  const float* bh = beta + h;
  __nv_bfloat16* oh = o + static_cast<long long>(h) * kD;

  int len = lens == nullptr ? T : lens[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const int chunks = (len + kC - 1) / kC;

  // This thread's (t, j) pair, and its share of the pairs past the 128th.
  int pi = 0;
  while ((pi + 1) * (pi + 2) / 2 <= tid) ++pi;
  const int pj = tid - pi * (pi + 1) / 2;
  const int xp = kThreads + tid / 16;  // 128 + (0..7): t = 15, j = 8..15
  const int xi = kC - 1, xj = xp - (kC - 1) * kC / 2;
  const int xc = (tid % 16) * 8;
  for (int p = tid; p < kC * kPS; p += kThreads) {
    (&sm.P[0][0])[p] = 0.f;  // j > t stays 0
    (&sm.A[0][0])[p] = 0.f;
  }

  float st[2][16][4];  // S^T rows 32 warp + 16 mt + (g, g + 8), columns 8 nt + 2 t4 (+1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.f;

  if (chunks > 0) load_chunk(sm, 0, qh, kh, vh, lah, bh, row0, 0, T, H);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1, t0 = c * kC;
    if (c + 1 < chunks) {
      load_chunk(sm, s ^ 1, qh, kh, vh, lah, bh, row0, t0 + kC, T, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 1. A thread a channel: cumulative decays, the decayed q and k.
    float kk[kC], vv[kC], gg[kC];
    {
      const int ch = tid;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        acc += sm.a[s][t][ch];
        gg[t] = acc;
        kk[t] = __bfloat162float(sm.k[s][t][ch]);
        vv[t] = __bfloat162float(sm.v[s][t][ch]);
        const float qq = __bfloat162float(sm.q[s][t][ch]);
        sm.kr[t][ch] = kk[t];
        sm.qr[t][ch] = qq;
        sm.gr[t][ch] = acc;
        sm.qt[t][ch] = qq * __expf(acc);
      }
      sm.gamma[ch] = __expf(acc);
#pragma unroll
      for (int t = 0; t < kC; ++t) sm.khat[t][ch] = kk[t] * __expf(acc - gg[t]);
    }
    __syncthreads();

    // 2. A thread a pair: A and P, then the 8 pairs past the 128th split 16 ways.
    {
      float sa = 0.f, sp = 0.f;
#pragma unroll 8
      for (int ch = 0; ch < kD; ++ch) {
        const float e = __expf(sm.gr[pi][ch] - sm.gr[pj][ch]);
        const float kj = sm.kr[pj][ch] * e;
        sa = fmaf(sm.kr[pi][ch], kj, sa);
        sp = fmaf(sm.qr[pi][ch], kj, sp);
      }
      if (pj < pi) sm.A[pi][pj] = sm.beta[s][pi] * sa;
      sm.P[pi][pj] = sp;
      float xa = 0.f, xq = 0.f;
#pragma unroll
      for (int ch = xc; ch < xc + 8; ++ch) {
        const float e = __expf(sm.gr[xi][ch] - sm.gr[xj][ch]);
        const float kj = sm.kr[xj][ch] * e;
        xa = fmaf(sm.kr[xi][ch], kj, xa);
        xq = fmaf(sm.qr[xi][ch], kj, xq);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        xa += __shfl_xor_sync(0xffffffffu, xa, off);
        xq += __shfl_xor_sync(0xffffffffu, xq, off);
      }
      if ((tid & 15) == 0) {
        if (xj < xi) sm.A[xi][xj] = sm.beta[s][xi] * xa;
        sm.P[xi][xj] = xq;
      }
    }
    __syncthreads();

    // 3. A thread a channel: (I + A) W = b [exp(G) K | V] by forward substitution.
    {
      const int ch = tid;
      float wk[kC], wv[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float bt = sm.beta[s][t];
        float xk = bt * kk[t] * __expf(gg[t]), xv = bt * vv[t];
#pragma unroll
        for (int j = 0; j < t; ++j) {
          const float a = sm.A[t][j];
          xk = fmaf(-a, wk[j], xk);
          xv = fmaf(-a, wv[j], xv);
        }
        wk[t] = xk;
        wv[t] = xv;
        sm.wk[t][ch] = xk;
        sm.wv[t][ch] = xv;
      }
    }
    __syncthreads();

    // 4. A warp its 32 value columns: U^T = W_v^T - S^T W_k^T, O^T = S^T Q~^T + U^T P^T,
    //    S^T <- S^T Diag(exp(G_last)) + U^T K^.
    {
      const int r0 = 32 * warp;
      float u[2][2][4], ot[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = r0 + 16 * mt + g, tok = 8 * nt + 2 * t4;
          u[mt][nt][0] = sm.wv[tok][col];
          u[mt][nt][1] = sm.wv[tok + 1][col];
          u[mt][nt][2] = sm.wv[tok][col + 8];
          u[mt][nt][3] = sm.wv[tok + 1][col + 8];
#pragma unroll
          for (int e = 0; e < 4; ++e) ot[mt][nt][e] = 0.f;
        }
#pragma unroll
      for (int kt = 0; kt < 16; ++kt) {
        unsigned bw[2][2], bq[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 w2 = *reinterpret_cast<const float2*>(&sm.wk[8 * nt + g][8 * kt + 2 * t4]);
          const float2 q2 = *reinterpret_cast<const float2*>(&sm.qt[8 * nt + g][8 * kt + 2 * t4]);
          bw[nt][0] = tf32(-w2.x);
          bw[nt][1] = tf32(-w2.y);
          bq[nt][0] = tf32(q2.x);
          bq[nt][1] = tf32(q2.y);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned a[4] = {tf32(st[mt][kt][0]), tf32(st[mt][kt][2]), tf32(st[mt][kt][1]),
                                 tf32(st[mt][kt][3])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_tf32(u[mt][nt], a, bw[nt]);
            mma_tf32(ot[mt][nt], a, bq[nt]);
          }
        }
      }
      unsigned ua[2][2][4];  // U^T as A fragments, by token block
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          ua[mt][kt][0] = tf32(u[mt][kt][0]);
          ua[mt][kt][1] = tf32(u[mt][kt][2]);
          ua[mt][kt][2] = tf32(u[mt][kt][1]);
          ua[mt][kt][3] = tf32(u[mt][kt][3]);
        }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 p2 = *reinterpret_cast<const float2*>(&sm.P[8 * nt + g][8 * kt + 2 * t4]);
          const unsigned bp[2] = {tf32(p2.x), tf32(p2.y)};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(ot[mt][nt], ua[mt][kt], bp);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = r0 + 16 * mt + g, tok = 8 * nt + 2 * t4;
          sm.o[tok][col] = ot[mt][nt][0];
          sm.o[tok + 1][col] = ot[mt][nt][1];
          sm.o[tok][col + 8] = ot[mt][nt][2];
          sm.o[tok + 1][col + 8] = ot[mt][nt][3];
        }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const float g0 = sm.gamma[8 * nt + 2 * t4], g1 = sm.gamma[8 * nt + 2 * t4 + 1];
        unsigned bk[2][2];
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          bk[kt][0] = tf32(sm.khat[8 * kt + 2 * t4][8 * nt + g]);
          bk[kt][1] = tf32(sm.khat[8 * kt + 2 * t4 + 1][8 * nt + g]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          st[mt][nt][0] *= g0;
          st[mt][nt][1] *= g1;
          st[mt][nt][2] *= g0;
          st[mt][nt][3] *= g1;
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) mma_tf32(st[mt][nt], ua[mt][kt], bk[kt]);
        }
      }
    }
    __syncthreads();

    // 5. A thread a channel: the chunk's o, 0 past the row's length.
    {
      const int ch = tid;
#pragma unroll 4
      for (int t = 0; t < kC; ++t) {
        const int tok = t0 + t;
        if (tok >= T) break;
        oh[(row0 + tok) * H * kD + ch] = __float2bfloat16(tok < len ? sm.o[t][ch] : 0.f);
      }
    }
  }
  // Chunks past the row's length: o is 0.
  for (int tok = chunks * kC; tok < T; ++tok) oh[(row0 + tok) * H * kD + tid] = __float2bfloat16(0.f);
}

constexpr int kPrepRun = 64;  // tokens a warp walks in kda_prep

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(a);
  x[1] = __high2float(a);
  x[2] = __low2float(b);
  x[3] = __high2float(b);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

// Grid (H / 4, ceil(T / kPrepRun), B), 4 warps a block: warp w takes head
// 4 blockIdx.x + w over a run of tokens of row blockIdx.z, lane l channels
// 4l..4l+3 of the head. conv [inner, 4] float32 weights (tap 3 on the token
// itself).
__global__ void __launch_bounds__(128)
kda_prep_kernel(const __nv_bfloat16* __restrict__ q_lin, const __nv_bfloat16* __restrict__ k_lin,
                const __nv_bfloat16* __restrict__ v_lin, const __nv_bfloat16* __restrict__ f,
                const float* __restrict__ wq, const float* __restrict__ wk, const float* __restrict__ wv,
                const float* __restrict__ a_log, const float* __restrict__ dt_bias, __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ v, float* __restrict__ log_alpha, int T,
                int H, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * 4 + warp;
  if (h >= H) return;
  const int inner = H * kD, c0 = h * kD + 4 * lane;
  const long long row = static_cast<long long>(blockIdx.z) * T;
  const int t0 = blockIdx.y * kPrepRun, t1 = min(T, t0 + kPrepRun);
  const __nv_bfloat16* src[3] = {q_lin, k_lin, v_lin};
  const float* wts[3] = {wq, wk, wv};
  float w[3][4][4];    // [tensor][channel][tap]
  float win[3][3][4];  // [tensor][x_{t-3}, x_{t-2}, x_{t-1}][channel]
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 wc = *reinterpret_cast<const float4*>(wts[m] + (c0 + c) * 4);
      w[m][c][0] = wc.x;
      w[m][c][1] = wc.y;
      w[m][c][2] = wc.z;
      w[m][c][3] = wc.w;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int t = t0 - 3 + s;
      if (t >= 0) {
        load4(src[m] + (row + t) * inner + c0, win[m][s]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) win[m][s][c] = 0.f;
      }
    }
  }
  const float neg_a = -expf(a_log[h]);
  const float4 bias = *reinterpret_cast<const float4*>(dt_bias + c0);
  for (int t = t0; t < t1; ++t) {
    const long long at = (row + t) * inner + c0;
    float y[3][4];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float x[4];
      load4(src[m] + at, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = x[c] * w[m][c][3];
        acc += win[m][2][c] * w[m][c][2];
        acc += win[m][1][c] * w[m][c][1];
        acc += win[m][0][c] * w[m][c][0];
        y[m][c] = silu(acc);
        win[m][0][c] = win[m][1][c];
        win[m][1][c] = win[m][2][c];
        win[m][2][c] = x[c];
      }
    }
    float sq = 0.f, sk = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sq += y[0][c] * y[0][c];
      sk += y[1][c] * y[1][c];
    }
    sq = warp_sum(sq);
    sk = warp_sum(sk);
    const float rq = rsqrtf(sq + 1e-6f) * scale, rk = rsqrtf(sk + 1e-6f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[0][c] *= rq;
      y[1][c] *= rk;
    }
    store4(q + at, y[0]);
    store4(k + at, y[1]);
    store4(v + at, y[2]);
    float fx[4];
    load4(f + at, fx);
    const float4 la = make_float4(neg_a * softplus(fx[0] + bias.x), neg_a * softplus(fx[1] + bias.y),
                                  neg_a * softplus(fx[2] + bias.z), neg_a * softplus(fx[3] + bias.w));
    *reinterpret_cast<float4*>(log_alpha + at) = la;
  }
}

// A warp a (token, head): out = bf16(o rsqrt(mean(o^2) + eps) w sigmoid(g)).
__global__ void __launch_bounds__(128)
kda_gated_norm_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ gate,
                      const float* __restrict__ weight, __nv_bfloat16* __restrict__ out, long long units, float eps) {
  const long long u = static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (u >= units) return;
  const int lane = threadIdx.x & 31;
  const long long at = u * kD + 4 * lane;
  float x[4], g[4];
  load4(o + at, x);
  load4(gate + at, g);
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) ss += x[c] * x[c];
  const float r = rsqrtf(warp_sum(ss) / kD + eps);
  const float4 wc = *reinterpret_cast<const float4*>(weight + 4 * lane);
  const float ww[4] = {wc.x, wc.y, wc.z, wc.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = x[c] * r * ww[c] * (1.f / (1.f + expf(-g[c])));
  store4(out + at, x);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

NR_EXPORT int kda_chunked_bf16(const void* q, const void* k, const void* v, const void* log_alpha,
                               const void* beta, const void* lens, void* o, int B, int T, int H, int device,
                               void* stream) {
  if (B < 1 || T < 1 || H < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(log_alpha) ||
      beta == nullptr || o == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(Smem));
  err = cudaFuncSetAttribute(kda_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kda_chunked_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(log_alpha),
      static_cast<const float*>(beta), static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(o), T, H);
  return cudaGetLastError();
}

NR_EXPORT int kda_prep_bf16(const void* q_lin, const void* k_lin, const void* v_lin, const void* f, const void* wq,
                            const void* wk, const void* wv, const void* a_log, const void* dt_bias, void* q, void* k,
                            void* v, void* log_alpha, int B, int T, int H, float scale, int device, void* stream) {
  if (B < 1 || T < 1 || H < 1 || !aligned16(q_lin) || !aligned16(k_lin) || !aligned16(v_lin) || !aligned16(f) ||
      !aligned16(wq) || !aligned16(wk) || !aligned16(wv) || !aligned16(dt_bias) || !aligned16(log_alpha))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + 3) / 4, (T + kPrepRun - 1) / kPrepRun, B);
  kda_prep_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q_lin), static_cast<const __nv_bfloat16*>(k_lin),
      static_cast<const __nv_bfloat16*>(v_lin), static_cast<const __nv_bfloat16*>(f), static_cast<const float*>(wq),
      static_cast<const float*>(wk), static_cast<const float*>(wv), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(v), static_cast<float*>(log_alpha), T, H, scale);
  return cudaGetLastError();
}

NR_EXPORT int kda_gated_norm_bf16(const void* o, const void* gate, const void* weight, void* out, int tokens, int H,
                                  float eps, int device, void* stream) {
  if (tokens < 1 || H < 1 || !aligned16(weight)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>(tokens) * H;
  kda_gated_norm_kernel<<<static_cast<unsigned>((units + 3) / 4), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(gate),
      static_cast<const float*>(weight), static_cast<__nv_bfloat16*>(out), units, eps);
  return cudaGetLastError();
}
