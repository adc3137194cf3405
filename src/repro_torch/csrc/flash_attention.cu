// flash_attention — causal (or full) softmax attention forward (K6):
// q (BH, Sq, D), k (BH/group, Sk, D), v (BH/group, Sk, Dv) -> (BH, Sq, Dv),
// f32 or bf16 in and out, scores and accumulation in f32.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_pallas (_kernel). The TPU kernel walks the KV axis as
//   the innermost, sequential grid dimension with the online-softmax state
//   (m, l, acc) in VMEM scratch, and maps query head bh to kv head
//   bh // group in its BlockSpec; it needs Sq and Sk to be tile multiples.
//
// Bound on this card: operations. Causal attention at the serving shape
// (BH = 128, Sq = Sk = 1024, D = 64) is 4*BH*Sq*Sk*D/2 = 17.2 GFLOP against
// 42 MB of q/k/v/o: 17.4 us at the bf16 tensor-core rate, 12.5 us for the
// bytes. Only wgmma reaches that rate; this kernel is the simple SIMT
// version (f32 FMAs on the CUDA cores, 67 TFLOP/s at best), so it stays
// well above the bound.
//
// Design: one block of 256 threads per (bh, 64-row query tile). The query
// tile and each 64-row K and V tile are staged in shared memory as f32
// (rows padded by one word so column walks hit distinct banks); the
// scores of a tile never leave the SM. Each thread owns 4 query rows x 4
// score columns and 4 rows x Dv/16 output columns, so the online-softmax
// state (m, l, acc) stays in registers; a row's max and sum are reduced
// across the 16 lanes that share it with shuffles. p is rounded to the
// value type before p·v and l sums the unrounded p, as the TPU kernel
// does. Query head bh reads kv row bh / group. Under the causal mask
// (top-left: query i sees keys 0..i) key tiles past the tile's last query
// row are skipped, which is exact: their terms are exp(-1e30 - m) = 0.
// Ragged Sq and Sk are masked here, so any length is taken. Blocks run
// the heaviest query tiles first.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 4;        // query rows per thread: ty * 4 + i
constexpr int kCols = 4;        // score columns per thread: tx + 16 * j
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

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

// max / sum over the 16 lanes that share a query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DVC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int BH,
                       int group, int Sq, int Sk, int D, int Dv, float scale,
                       int causal, int nq) {
  extern __shared__ float smem[];
  const int ds = D + 1;
  float* qs = smem;                   // (kBQ, D + 1)
  float* ks = qs + kBQ * ds;          // (kBK, D + 1)
  float* vs = ks + kBK * ds;          // (kBK, Dv)
  float* ps = vs + kBK * Dv;          // (kBQ, kBK + 1), p rounded to T

  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = ty * kRows;

  const long long kv = bh / group;
  load_tile(qs, q + static_cast<long long>(bh) * Sq * D, q0, Sq, kBQ, D, ds);
  const T* kb = k + kv * Sk * D;
  const T* vb = v + kv * Sk * Dv;

  float m[kRows], l[kRows], acc[kRows][DVC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c) acc[i][c] = 0.f;
  }

  const int last_q = min(q0 + kBQ, Sq) - 1;
  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, last_q / kBK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();      // the last tile's readers are done
    load_tile(ks, kb, k0, Sk, kBK, D, ds);
    load_tile(vs, vb, k0, Sk, kBK, Dv, Dv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(row0 + i) * ds + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ks[(tx + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + row0 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= Sk || (causal && kp > qp)) x = kNegInf;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(row0 + i) * (kBK + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DVC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float b[DVC];
#pragma unroll
      for (int jj = 0; jj < DVC; ++jj) {
        const int col = tx + 16 * jj;
        b[jj] = col < Dv ? vs[c * Dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(row0 + i) * (kBK + 1) + c];
#pragma unroll
        for (int jj = 0; jj < DVC; ++jj) acc[i][jj] = fmaf(p, b[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<long long>(bh) * Sq + qp) * Dv;
#pragma unroll
    for (int jj = 0; jj < DVC; ++jj) {
      const int col = tx + 16 * jj;
      if (col < Dv) o[col] = from_f32<T>(acc[i][jj] / den);
    }
  }
}

template <typename T, int DVC>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int group, int Sq, int Sk, int D, int Dv, float scale, int causal,
           cudaStream_t stream) {
  const int nq = (Sq + kBQ - 1) / kBQ;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (D + 1) +
                       static_cast<size_t>(kBK) * Dv + kBQ * (kBK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, DVC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_kernel<T, DVC><<<nq * BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH, group, Sq, Sk, D,
      Dv, scale, causal, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike)
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int group, int Sq, int Sk,
                               int D, int Dv, float scale, int causal,
                               int dtype, void* stream) {
  if (BH < 1 || group < 1 || BH % group || Sq < 1 || Sk < 1 || D < 1 ||
      D > kMaxHeadDim || Dv < 1 || Dv > kMaxHeadDim ||
      (dtype != 0 && dtype != 1) ||
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * BH > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return Dv <= 64 ? launch<float, 4>(q, k, v, out, BH, group, Sq, Sk, D, Dv,
                                       scale, causal, s)
                    : launch<float, 8>(q, k, v, out, BH, group, Sq, Sk, D, Dv,
                                       scale, causal, s);
  return Dv <= 64 ? launch<__nv_bfloat16, 4>(q, k, v, out, BH, group, Sq, Sk,
                                             D, Dv, scale, causal, s)
                  : launch<__nv_bfloat16, 8>(q, k, v, out, BH, group, Sq, Sk,
                                             D, Dv, scale, causal, s);
}
