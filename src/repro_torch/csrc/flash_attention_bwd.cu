// flash_attention_bwd — the gradient of causal (or full) softmax attention
// (K7): given q (BH, Sq, D), k (BH/group, Sk, D), v (BH/group, Sk, Dv), the
// forward's output o and per-row logsumexp lse (BH, Sq) f32 (K6 with an lse
// pointer), and the output's gradient do (BH, Sq, Dv), computes dq, dk, dv
// in the inputs' dtype (f32 or bf16), all arithmetic in f32.
//
// Replaces: no Pallas kernel. The reference's backward is pure JAX under
//   jax.custom_vjp (src/repro/models/attention.py, _flash_core_bwd): it
//   recomputes p per (q chunk, kv chunk) from the saved lse, so no (Sq, Sk)
//   tensor outlives a chunk pair. This kernel does the same per tile pair:
//     Dsum = rowsum(do * o),  p = exp(s * scale - lse),  dv = p^T do,
//     dp = do v^T,  ds = p * (dp - Dsum) * scale,  dq = ds k,  dk = ds^T q,
//   with dk and dv summed over the `group` query heads of each kv head.
//
// Bound on this card: operations. The five products S, dP, dV, dK and dQ
// are 2 * (2 D + 2 Dv + D) flops per (query, key) pair the mask keeps; at
// the training shape (BH = 128, Sq = Sk = 1024, D = Dv = 64, causal) that
// is 4.29e10 flops, 43.4 us at the bf16 tensor-core rate. This first
// version runs f32 FMAs on the CUDA cores (67 TFLOP/s at best) and
// recomputes S and dP in both passes below, so it is far above the bound;
// tensor cores (wgmma) and TMA are later work.
//
// Three kernels, one C entry, no float atomics: every output element is
// summed by one thread in a fixed order, so a run repeats bit for bit.
//   (a) attn_bwd_dsum_kernel: one warp per query row, Dsum = sum do * o.
//   (b) attn_bwd_dkdv_kernel: one block of 256 threads per (kv head, 64-row
//       key tile), heaviest tiles first. K and V tiles stay in shared
//       memory (f32, rows padded by one word); the block walks the group's
//       query heads and, under the causal mask, only the query tiles whose
//       rows reach its keys. Per query tile it stages q, do, lse and Dsum,
//       computes the transposed score and dP tiles (each thread 4 keys x 4
//       queries), writes p and ds to shared memory, then accumulates dk and
//       dv for its 4 keys x D/16 and Dv/16 columns in registers.
//   (c) attn_bwd_dq_kernel: one block per (q head, 64-row query tile),
//       heaviest first; it walks the key tiles up to the diagonal,
//       recomputes S and dP, writes ds to shared memory and accumulates dq
//       for its 4 query rows x D/16 columns in registers.
// Masked (query, key) pairs (keys >= Sk, rows >= Sq, and keys past the
// row under the top-left causal mask) get p = 0, as exp(-1e30 - lse) is in
// the reference.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per tile
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 4;        // tile rows per thread: ty * 4 + i
constexpr int kCols = 4;        // tile columns per thread: tx + 16 * j
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [row0, row0 + n) of a (rows, width) matrix into shared memory with
// row stride `stride`, as f32; rows past `rows` are zero.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int row0, int rows,
                          int n, int width, int stride) {
  const int total = n * width;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / width, c = i - r * width;
    const int gr = row0 + r;
    dst[r * stride + c] =
        gr < rows ? to_f32(src[static_cast<long long>(gr) * width + c]) : 0.f;
  }
}

// n values of a row vector from `src` at [row0, row0 + n), zero past `rows`
__device__ void load_vec(float* dst, const float* src, int row0, int rows,
                         int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
}

// (a) Dsum over `rows` rows of Dv values, one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dsum, long long rows, int Dv) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;              // whole warps leave together
  const T* a = o + row * Dv;
  const T* b = dout + row * Dv;
  float acc = 0.f;
  for (int e = lane; e < Dv; e += 32)
    acc = fmaf(to_f32(b[e]), to_f32(a[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// p and ds of one thread's 4 x 4 (row, column) cells of a tile pair, from
// its raw scores s and dP; live(i, j) says whether the mask keeps the cell
template <typename Live>
__device__ __forceinline__ void p_and_ds(float (&s)[kRows][kCols],
                                         float (&dp)[kRows][kCols],
                                         const float (&lse)[kRows][kCols],
                                         const float (&dsum)[kRows][kCols],
                                         float scale, Live live) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = live(i, j) ? expf(s[i][j] * scale - lse[i][j]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dsum[i][j]) * scale;
    }
}

// (b) dk, dv: one block per (kv head, key tile)
template <typename T, int DC, int DVC>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int BHkv, int group, int Sq, int Sk,
                     int D, int Dv, float scale, int causal) {
  extern __shared__ float smem[];
  const int sd = D + 1, sv = Dv + 1, sp = kBQ + 1;
  float* ks = smem;                   // (kBK, D + 1)
  float* vs = ks + kBK * sd;          // (kBK, Dv + 1)
  float* qs = vs + kBK * sv;          // (kBQ, D + 1)
  float* dos = qs + kBQ * sd;         // (kBQ, Dv + 1)
  float* ps = dos + kBQ * sv;         // (kBK, kBQ + 1): p, keys x queries
  float* dss = ps + kBK * sp;         // (kBK, kBQ + 1): ds
  float* ls = dss + kBK * sp;         // (kBQ): lse of the query tile
  float* dl = ls + kBQ;               // (kBQ): Dsum of the query tile

  const int kvh = blockIdx.x % BHkv;
  const int k0 = static_cast<int>(blockIdx.x / BHkv) * kBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = ty * kRows;        // this thread's keys: k0 + row0 + i

  load_tile(ks, k + static_cast<long long>(kvh) * Sk * D, k0, Sk, kBK, D, sd);
  load_tile(vs, v + static_cast<long long>(kvh) * Sk * Dv, k0, Sk, kBK, Dv,
            sv);

  float adk[kRows][DC], adv[kRows][DVC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c) adv[i][c] = 0.f;
  }

  const int nq = (Sq + kBQ - 1) / kBQ;
  // causal: query tiles before k0's hold only rows < k0, which see none of
  // this tile's keys
  const int qt0 = causal ? k0 / kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const long long bh = static_cast<long long>(kvh) * group + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();    // the last tile's readers are done
      load_tile(qs, q + bh * Sq * D, q0, Sq, kBQ, D, sd);
      load_tile(dos, dout + bh * Sq * Dv, q0, Sq, kBQ, Dv, sv);
      load_vec(ls, lse + bh * Sq, q0, Sq, kBQ);
      load_vec(dl, dsum + bh * Sq, q0, Sq, kBQ);
      __syncthreads();

      // transposed tiles: cell (i, j) is key k0 + row0 + i, query
      // q0 + tx + 16 j
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[kRows], b[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) a[i] = ks[(row0 + i) * sd + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) b[j] = qs[(tx + 16 * j) * sd + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
#pragma unroll 4
      for (int e = 0; e < Dv; ++e) {
        float a[kRows], b[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) a[i] = vs[(row0 + i) * sv + e];
#pragma unroll
        for (int j = 0; j < kCols; ++j) b[j] = dos[(tx + 16 * j) * sv + e];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
      }
      float lr[kRows][kCols], dr[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          lr[i][j] = ls[tx + 16 * j];
          dr[i][j] = dl[tx + 16 * j];
        }
      p_and_ds(s, dp, lr, dr, scale, [&](int i, int j) {
        const int kp = k0 + row0 + i, qp = q0 + tx + 16 * j;
        return kp < Sk && qp < Sq && !(causal && kp > qp);
      });
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          ps[(row0 + i) * sp + tx + 16 * j] = s[i][j];
          dss[(row0 + i) * sp + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dv[key][c] += sum_q p[key][q] do[q][c]; dk[key][c] += ds q
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float bo[DVC], bq[DC];
#pragma unroll
        for (int jj = 0; jj < DVC; ++jj) {
          const int col = tx + 16 * jj;
          bo[jj] = col < Dv ? dos[c * sv + col] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          const int col = tx + 16 * jj;
          bq[jj] = col < D ? qs[c * sd + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = ps[(row0 + i) * sp + c];
          const float ds = dss[(row0 + i) * sp + c];
#pragma unroll
          for (int jj = 0; jj < DVC; ++jj)
            adv[i][jj] = fmaf(p, bo[jj], adv[i][jj]);
#pragma unroll
          for (int jj = 0; jj < DC; ++jj)
            adk[i][jj] = fmaf(ds, bq[jj], adk[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + row0 + i;
    if (kp >= Sk) continue;
    const long long r = static_cast<long long>(kvh) * Sk + kp;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = tx + 16 * jj;
      if (col < D) dk[r * D + col] = from_f32<T>(adk[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < DVC; ++jj) {
      const int col = tx + 16 * jj;
      if (col < Dv) dv[r * Dv + col] = from_f32<T>(adv[i][jj]);
    }
  }
}

// (c) dq: one block per (q head, query tile)
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dq, int BH,
                   int group, int Sq, int Sk, int D, int Dv, float scale,
                   int causal, int nq) {
  extern __shared__ float smem[];
  const int sd = D + 1, sv = Dv + 1, sp = kBK + 1;
  float* qs = smem;                   // (kBQ, D + 1)
  float* dos = qs + kBQ * sd;         // (kBQ, Dv + 1)
  float* ks = dos + kBQ * sv;         // (kBK, D + 1)
  float* vs = ks + kBK * sd;          // (kBK, Dv + 1)
  float* dss = vs + kBK * sv;         // (kBQ, kBK + 1): ds
  float* ls = dss + kBQ * sp;         // (kBQ)
  float* dl = ls + kBQ;               // (kBQ)

  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = ty * kRows;        // this thread's queries: q0 + row0 + i
  const long long kvh = bh / group;

  load_tile(qs, q + static_cast<long long>(bh) * Sq * D, q0, Sq, kBQ, D, sd);
  load_tile(dos, dout + static_cast<long long>(bh) * Sq * Dv, q0, Sq, kBQ,
            Dv, sv);
  load_vec(ls, lse + static_cast<long long>(bh) * Sq, q0, Sq, kBQ);
  load_vec(dl, dsum + static_cast<long long>(bh) * Sq, q0, Sq, kBQ);
  const T* kb = k + kvh * Sk * D;
  const T* vb = v + kvh * Sk * Dv;

  float adq[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adq[i][c] = 0.f;

  const int last_q = min(q0 + kBQ, Sq) - 1;
  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, last_q / kBK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();      // the last tile's readers are done
    load_tile(ks, kb, k0, Sk, kBK, D, sd);
    load_tile(vs, vb, k0, Sk, kBK, Dv, sv);
    __syncthreads();

    // cell (i, j) is query q0 + row0 + i, key k0 + tx + 16 j
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(row0 + i) * sd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ks[(tx + 16 * j) * sd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll 4
    for (int e = 0; e < Dv; ++e) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = dos[(row0 + i) * sv + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = vs[(tx + 16 * j) * sv + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
    }
    float lr[kRows][kCols], dr[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        lr[i][j] = ls[row0 + i];
        dr[i][j] = dl[row0 + i];
      }
    p_and_ds(s, dp, lr, dr, scale, [&](int i, int j) {
      const int qp = q0 + row0 + i, kp = k0 + tx + 16 * j;
      return kp < Sk && qp < Sq && !(causal && kp > qp);
    });
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dss[(row0 + i) * sp + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dq[query][c] += sum_key ds[query][key] k[key][c]
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float bk[DC];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int col = tx + 16 * jj;
        bk[jj] = col < D ? ks[c * sd + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ds = dss[(row0 + i) * sp + c];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) adq[i][jj] = fmaf(ds, bk[jj], adq[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= Sq) continue;
    T* out = dq + (static_cast<long long>(bh) * Sq + qp) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = tx + 16 * jj;
      if (col < D) out[col] = from_f32<T>(adq[i][jj]);
    }
  }
}

size_t dkdv_smem(int D, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBK + kBQ) * (D + 1 + Dv + 1) +
          2 * static_cast<size_t>(kBK) * (kBQ + 1) + 2 * kBQ);
}

size_t dq_smem(int D, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBK + kBQ) * (D + 1 + Dv + 1) +
          static_cast<size_t>(kBQ) * (kBK + 1) + 2 * kBQ);
}

template <typename T, int DC, int DVC>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int BH, int group, int Sq, int Sk, int D,
           int Dv, float scale, int causal, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(BH) * Sq;
  const long long dsum_blocks = (rows * 32 + kThreads - 1) / kThreads;
  attn_bwd_dsum_kernel<T><<<static_cast<unsigned>(dsum_blocks), kThreads, 0,
                            stream>>>(static_cast<const T*>(o), tdo, dsum,
                                      rows, Dv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int BHkv = BH / group;
  const int nk = (Sk + kBK - 1) / kBK, nq = (Sq + kBQ - 1) / kBQ;
  const size_t s1 = dkdv_smem(D, Dv);
  e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, DC, DVC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s1));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<T, DC, DVC><<<nk * BHkv, kThreads, s1, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      BHkv, group, Sq, Sk, D, Dv, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t s2 = dq_smem(D, Dv);
  e = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dq_kernel<T, DC><<<nq * BH, kThreads, s2, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dq), BH, group, Sq, Sk, D,
      Dv, scale, causal, nq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dims(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dsum, void* dq,
                void* dk, void* dv, int BH, int group, int Sq, int Sk, int D,
                int Dv, float scale, int causal, cudaStream_t s) {
  if (D <= 64 && Dv <= 64)
    return launch<T, 4, 4>(q, k, v, o, dout, lse, dsum, dq, dk, dv, BH, group,
                           Sq, Sk, D, Dv, scale, causal, s);
  if (D <= 64)
    return launch<T, 4, 8>(q, k, v, o, dout, lse, dsum, dq, dk, dv, BH, group,
                           Sq, Sk, D, Dv, scale, causal, s);
  if (Dv <= 64)
    return launch<T, 8, 4>(q, k, v, o, dout, lse, dsum, dq, dk, dv, BH, group,
                           Sq, Sk, D, Dv, scale, causal, s);
  return launch<T, 8, 8>(q, k, v, o, dout, lse, dsum, dq, dk, dv, BH, group,
                         Sq, Sk, D, Dv, scale, causal, s);
}

}  // namespace

// q, o, do, dq: (BH, Sq, D|Dv); k, v, dk, dv: (BH / group, Sk, D|Dv); lse
// and the Dsum scratch dsum: (BH, Sq) f32. dtype: 0 = float32, 1 =
// bfloat16 (every tensor but lse and dsum). Launches (a), (b), (c) in
// order on `stream`; returns 0 or the first cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dsum, void* dq, void* dk, void* dv,
                                   int BH, int group, int Sq, int Sk, int D,
                                   int Dv, float scale, int causal, int dtype,
                                   void* stream) {
  if (BH < 1 || group < 1 || BH % group || Sq < 1 || Sk < 1 || D < 1 ||
      D > kMaxHeadDim || Dv < 1 || Dv > kMaxHeadDim ||
      (dtype != 0 && dtype != 1) ||
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * BH > INT_MAX ||
      static_cast<long long>((Sk + kBK - 1) / kBK) * (BH / group) > INT_MAX ||
      static_cast<long long>(BH) * Sq * 32 / kThreads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return launch_dims<float>(q, k, v, o, dout, l, ds, dq, dk, dv, BH, group,
                              Sq, Sk, D, Dv, scale, causal, s);
  return launch_dims<__nv_bfloat16>(q, k, v, o, dout, l, ds, dq, dk, dv, BH,
                                    group, Sq, Sk, D, Dv, scale, causal, s);
}
