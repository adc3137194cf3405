// flash_attention_bwd — the gradient of causal (or full) softmax attention
// (K7): given q (BH, Sq, D), k (BH/group, Sk, D), v (BH/group, Sk, Dv), the
// forward's output o and per-row logsumexp lse (BH, Sq) f32 (K6 with an lse
// pointer), and the output's gradient do (BH, Sq, Dv), computes dq, dk, dv
// in the inputs' dtype (f32 or bf16).
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
// is 4.29e10 flops, 43.4 us at the bf16 tensor-core rate; at MLA's (BH =
// 512, Sq = Sk = 1024, D = 192, Dv = 128) 4.47e11 flops, 452 us.
//
// Three designs behind one C entry, chosen by the caller
// (kernels/flash_attention/bwd_kernel.py variant(), on K6's rule,
// kernel.py variant()): "fused" for bf16 with (D, Dv) in {(64, 64),
// (128, 128)}, "wgmma" for bf16 at (80, 80) (zamba2's) and (192, 128)
// (MLA's), "simt" for everything else (f32, whose 2e-5 contract TF32
// tensor cores would break, and bf16 at other head dims). The entry
// refuses a tensor-core launch that breaks the rule. None uses float
// atomics in a free order: every output element is summed in a fixed
// order, so a run repeats bit for bit.
//
// simt: all arithmetic in f32 FMAs on the CUDA cores (67 TFLOP/s at
// best), S and dP recomputed in both passes; the f32 path, every head dim
// up to 256 (D != Dv too), and the yardstick the wgmma variant is timed
// against.
//   (a) attn_bwd_dsum_kernel: one warp per query row, Dsum = sum do * o.
//   (b) attn_bwd_dkdv_kernel: one block of 256 threads per (kv head, 64-row
//       key tile), heaviest tiles first. K and V tiles stay in shared
//       memory (f32, rows padded by one word); the block walks the group's
//       query heads and, under the causal mask, only the query tiles whose
//       rows reach its keys. Per query tile (16 NC rows) it stages q, do,
//       lse and Dsum, computes the transposed score and dP tiles (each
//       thread 4 keys x NC queries), writes p and ds to shared memory, then
//       accumulates dk and dv for its 4 keys x D/16 and Dv/16 columns in
//       registers.
//   (c) attn_bwd_dq_kernel: one block per (q head, 64-row query tile),
//       heaviest first; it walks the key tiles (16 NC rows) up to the
//       diagonal, recomputes S and dP, writes ds to shared memory and
//       accumulates dq for its 4 query rows x D/16 columns in registers.
//   launch_dims picks the instance: NC = 4 up to (D, Dv) = (192, 128),
//   whose tiles take 194 KB of shared memory in (b); NC = 2 past it, where
//   64-row tiles at (256, 256) would take 290 KB.
//
// wgmma: every product on the tensor cores (wgmma m64nNk16, bf16 in, f32
// accumulators in registers), tiles fed by TMA (hopper.cuh, shared with
// K6), three kernels per call, templated on (D, Dv). Widths D and Dv are
// 64-column swizzled blocks (D = 192: three), so a product over D or Dv
// is D / 16 or Dv / 16 k16 steps, and dK (dQ) at D = 192 is one m64n192
// product per step. D = 80 (zamba2) is two blocks, as in K6: the tensor
// maps zero-fill columns 80..127 of the second, a product over D takes 5
// k16 steps, and dV, dK and dQ (N = 80) are each an n64 product over the
// first block plus an n16 over the second (hopper.cuh), so a consumer's
// dK and dV take 40 + 40 registers.
//   (a) attn_bwd_prep_kernel: Dv / 8 lanes (16-byte loads) per query row,
//       rounded up to a power of two (16 at Dv = 80, six of them idle),
//       of a head padded to kRowPad rows: Dsum = sum do * o (0 past Sq) and
//       lse * log2 e (+inf past Sq, so p = 0 there) into one scratch (2,
//       BH, Sp), whose 64-row slices a TMA bulk copy can fetch whole.
//   (b) attn_bwd_dkdv_wgmma_kernel: one block per (kv head, 128-row key
//       tile), lowest (causally heaviest) key tiles first, of three
//       warpgroups. Warpgroup 0 is the producer: it lowers its registers
//       with setmaxnreg and one thread issues the TMA loads, the block's K
//       and V tiles once, then each query tile's Q and dO (64 rows; 32 at
//       D = 192, where a consumer's dK and dV take 160 of its 240
//       registers and 64-row S^T and dP^T would spill; 128-byte swizzle)
//       and its lse and Dsum slices into a 2-stage ring guarded by
//       full (TMA bytes) and empty (consumer release) mbarriers, over the
//       `group` query heads of the kv head and, under the causal mask, only
//       the query tiles that reach the block's keys. Warpgroups 1 and 2 own
//       64 keys each and raise their registers to 240 (the launch's 168 x
//       384 register file regrouped as 24 / 240 / 240; the entry refuses a
//       build whose kernel does not start at 168, since setmaxnreg.inc
//       would then wait for registers forever). Per query tile a consumer
//       runs S^T = K Q^T and dP^T = V dO^T (both operands from shared
//       memory, K-major), then p and ds in registers in one pass, then
//       dV += P^T dO (P^T from registers, dO MN-major through the
//       transpose bit) and dK += dS^T Q, each as two products, hi then lo.
//       The same shared tile of Q (of dO) is the K-major B of S^T (dP^T)
//       and the MN-major B of dK (dV), through two descriptors. The
//       accumulator of S^T has keys as rows and queries as columns, so lse
//       and Dsum are read from shared memory per fragment column. dK and
//       dV stay in registers across the whole walk and are stored once, in
//       bf16. A consumer skips a query tile that lies wholly before its
//       keys (it only releases it); only tiles that cross the diagonal or
//       the end of Sq or Sk are masked.
//   (c) attn_bwd_dq_wgmma_kernel: one block per (q head, 128-row query
//       tile), heaviest first: K6's warpgroups with the Q and dO tiles
//       loaded once and a 2-stage ring of K and V tiles (128 rows; 64 at
//       D = 192, where 128-row tiles would take 241 KB of shared memory)
//       up to the diagonal. Each consumer owns 64 query rows and runs S =
//       Q K^T and dP = dO V^T (both from shared memory) and dQ += dS K (dS
//       from registers, K MN-major), dS again as hi then lo. S and dP are
//       committed apart, so p is computed while dP runs.
//   Operation count: 10 products against the 5 the bound counts: (b) runs
//   4 + 2 (dV's and dK's lo), (c) 3 + 1 (dQ's lo), and (c) reloads Q, dO,
//   K and V to recompute S and dP.
//
// fused: (a), then (d) and (e) in place of (b) and (c), at (D, Dv) = (64,
// 64) and (128, 128), the head dims of granite, whisper, llama4-scout and
// llava. (80, 80) keeps the three kernels, its products already split n64
// + n16, and so does (192, 128), whose consumers' dK and dV take 160 of
// their 240 registers.
//   (d) attn_bwd_fused_wgmma_kernel: (b)'s block, warpgroups, ring and
//       products, with dQ summed inside. Per query tile (64 rows) each
//       consumer also writes its dS^T fragments (hi and lo) to its 64 key
//       rows of a shared tile, 128-byte swizzled, and after a barrier of
//       its own four warps (the two consumers keep their own pace, so one
//       computes p and ds while the other's products run) computes the
//       tile's dQ partial over its 64 keys: dS (MN-major A from shared
//       memory) times its rows of the K tile the block holds (MN-major B
//       through a second descriptor), hi then lo, 4 k16 steps each of N =
//       64 per 64-column block of K, once dV and dK have freed their
//       registers (a third 64-register accumulator beside theirs spilled
//       at D = 128 and ran 2.5x slower; two of 32, committed apart, let
//       block 0 be staged while block 1's product runs). The partial (64 x
//       D f32) goes to a staging tile in shared memory in the registers'
//       order; lane 0 of producer warp 1 + cw adds it into the f32
//       accumulator acc (one 64 D-float tile per (q head, 64-row query
//       tile)) with one bulk copy of the TMA engine, while the consumer
//       goes on to the next tile. An earlier build split dQ's columns
//       between the consumers over all 128 keys (half the adds), but the
//       barrier between the two consumers each step held them in step,
//       and it ran slower than (b) + (c) (PERF.md §6).
//       Operation count: 8 products against the bound's 5 (dV's, dK's and
//       dQ's lo), and Q, dO, K and V are read once.
//   Determinism: the f32 additions into each acc tile happen in a fixed
//       order, turn kConsumers * kt + cw for consumer cw of the block of
//       key tile kt, from 0 up (both masks). One int32 counter per acc
//       tile, zeroed by (a), orders them: a reducer spins (ld.acquire)
//       until the counter reads its turn, stores its partial (turn 0, so
//       acc needs no memset) or adds it (cp.reduce.async.bulk.add.f32),
//       waits for the bulk operation to complete, and adds one to the
//       counter (red.release); a consumer whose keys all lie past the
//       tile (causal) has no partial and only takes its turn. Each spin
//       traps after ~2^34 cycles, as the barrier waits do. dK and dV sum
//       over query tiles in the walk's fixed order.
//   No deadlock: a block takes its work item from a ticket (atomicAdd on a
//       counter that (a) zeroes) in the order blocks actually start, not
//       from blockIdx: ticket = kt * BHkv + kvh, lowest key tiles (the
//       causally heaviest) first. A reducer waits only for the one before
//       it in its tile's order: consumer 0 of its own block, or consumer 1
//       of key tile kt - 1 of its kv head, whose ticket is lower. Either
//       started before it and is running or done, and the lowest-ticket
//       running block never waits on another block. No residency or
//       launch order is assumed.
//   The walk: query tiles from the last down to the first that reaches
//       the block's keys, the group's heads inside each, so every block of
//       a kv head meets query tile i of head g at the same step (nq - 1 -
//       i) group + g. Under the causal mask a key tile's block only walks
//       fewer steps; block kt meets each tile when block kt - 1 does and
//       adds right after it, not a walk later (blocks in later waves of the
//       grid start later and find their turn come). The same walk without
//       the mask: a rotated walk would make a block wait on a later ticket.
//   (e) attn_bwd_dq_convert_kernel: acc to bf16 dq, rounded once.
//   Shared memory at (128, 128): 225 KB of tiles (FusedLayout).
//
// Rounding points (wgmma and fused): S and dP accumulate in f32 from bf16
// inputs; p = 2^(s * scale * log2 e - lse * log2 e) in f32 with
// ex2.approx.ftz as in K6; ds = p * (dp - Dsum) * scale in f32; p (as dV's
// A operand) and ds (as dK's and dQ's) are each entered as a pair hi =
// bf16(x), lo = bf16(x - hi), so their products see 16 of x's mantissa
// bits; dk, dv and dq are rounded to bf16 once (fused: dq after the f32
// sum over key tiles). A single bf16 rounding is not enough: rounded once,
// ds can put dq, and p can put dv, more than 1.5x further from the f32
// gradient than the plain bf16 gradient (dv when one p dominates a key's
// sum, as in the full softmax with group 1); tests/test_torch_flash_bwd.py
// models the roundings. The lo products are the price of holding the x1.5
// rule. Ragged Sq and Sk: the 3-D tensor maps (D, S, BH) zero-fill rows
// past S, and keys >= Sk and rows >= Sq are masked to p = 0. A barrier
// wait that exceeds ~2^34 cycles traps instead of hanging the card.
//
// Masked (query, key) pairs (keys >= Sk, rows >= Sq, and under the causal
// mask keys past the row's position q_offset + i, K6's mask) get p = 0, as
// exp(-1e30 - lse) is in the reference. The offset moves only the
// positions the masks, the tile ranges and the skipped tiles compare: the
// first query tile a key tile reaches is the one holding row max(k0 -
// q_offset, 0) (clamped before the division, so no quotient is
// negative), and a query tile's last key tile the one holding key
// q_offset + its last row. The tensor-core kernels are built twice
// (template flag kOff): for q_offset = 0 the offset is a compile-time 0
// and the skip tests keep their offset-free form, so these instances
// compile to the offset-free kernels' SASS (held by `cuobjdump -sass`;
// a helper function in their place changed the fused kernel's predicate
// allocation and cost it 1.5 % at head dim 64); the SIMT kernels take the
// offset at run time.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 4;        // tile rows per thread: ty * 4 + i
constexpr int kTileRows = 16 * kRows;  // a block's own rows: 64 keys in
                                       // (b), 64 queries in (c)
constexpr int kMaxHeadDim = 256;

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

// p and ds of one thread's 4 x NC (row, column) cells of a tile pair, from
// its raw scores s and dP; live(i, j) says whether the mask keeps the cell
template <int NC, typename Live>
__device__ __forceinline__ void p_and_ds(float (&s)[kRows][NC],
                                         float (&dp)[kRows][NC],
                                         const float (&lse)[kRows][NC],
                                         const float (&dsum)[kRows][NC],
                                         float scale, Live live) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = live(i, j) ? expf(s[i][j] * scale - lse[i][j]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dsum[i][j]) * scale;
    }
}

// (b) dk, dv: one block per (kv head, 64-row key tile), query tiles of
// 16 NC rows (each thread NC of them)
template <typename T, int DC, int DVC, int NC>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int BHkv, int group, int Sq, int Sk,
                     int D, int Dv, float scale, int causal, int qoff) {
  constexpr int kBK = kTileRows, kBQ = 16 * NC;
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
  // causal: query tiles before row k0 - qoff's hold only positions < k0,
  // which see none of this tile's keys
  const int qt0 = causal ? max(k0 - qoff, 0) / kBQ : 0;
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
      float s[kRows][NC], dp[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[kRows], b[NC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) a[i] = ks[(row0 + i) * sd + d];
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = qs[(tx + 16 * j) * sd + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
#pragma unroll 4
      for (int e = 0; e < Dv; ++e) {
        float a[kRows], b[NC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) a[i] = vs[(row0 + i) * sv + e];
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = dos[(tx + 16 * j) * sv + e];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j)
            dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
      }
      float lr[kRows][NC], dr[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          lr[i][j] = ls[tx + 16 * j];
          dr[i][j] = dl[tx + 16 * j];
        }
      p_and_ds(s, dp, lr, dr, scale, [&](int i, int j) {
        const int kp = k0 + row0 + i, qp = q0 + tx + 16 * j;
        return kp < Sk && qp < Sq && !(causal && kp > qp + qoff);
      });
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
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

// (c) dq: one block per (q head, 64-row query tile), key tiles of 16 NC
// rows (each thread NC of them)
template <typename T, int DC, int NC>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dq, int BH,
                   int group, int Sq, int Sk, int D, int Dv, float scale,
                   int causal, int qoff, int nq) {
  constexpr int kBQ = kTileRows, kBK = 16 * NC;
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
  if (causal) nk = min(nk, (last_q + qoff) / kBK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();      // the last tile's readers are done
    load_tile(ks, kb, k0, Sk, kBK, D, sd);
    load_tile(vs, vb, k0, Sk, kBK, Dv, sv);
    __syncthreads();

    // cell (i, j) is query q0 + row0 + i, key k0 + tx + 16 j
    float s[kRows][NC], dp[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(row0 + i) * sd + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = ks[(tx + 16 * j) * sd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll 4
    for (int e = 0; e < Dv; ++e) {
      float a[kRows], b[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = dos[(row0 + i) * sv + e];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = vs[(tx + 16 * j) * sv + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dp[i][j] = fmaf(a[i], b[j], dp[i][j]);
    }
    float lr[kRows][NC], dr[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        lr[i][j] = ls[row0 + i];
        dr[i][j] = dl[row0 + i];
      }
    p_and_ds(s, dp, lr, dr, scale, [&](int i, int j) {
      const int qp = q0 + row0 + i, kp = k0 + tx + 16 * j;
      return kp < Sk && qp < Sq && !(causal && kp > qp + qoff);
    });
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j)
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

// shared memory of (b) with `bq`-row query tiles and of (c) with `bk`-row
// key tiles: at (D, Dv) = (192, 128) and 64-row tiles 198,656 and 182,016
// bytes; at (256, 256) 64-row tiles would take 296,960, over a block's
// 232,448, so that instance runs 32-row ones (214,528 and 206,336)
size_t dkdv_smem(int D, int Dv, int bq) {
  return sizeof(float) *
         (static_cast<size_t>(kTileRows + bq) * (D + 1 + Dv + 1) +
          2 * static_cast<size_t>(kTileRows) * (bq + 1) + 2 * bq);
}

size_t dq_smem(int D, int Dv, int bk) {
  return sizeof(float) *
         (static_cast<size_t>(bk + kTileRows) * (D + 1 + Dv + 1) +
          static_cast<size_t>(kTileRows) * (bk + 1) + 2 * kTileRows);
}

template <typename T, int DC, int DVC, int NC>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int BH, int group, int Sq, int Sk, int D,
           int Dv, float scale, int causal, int qoff, cudaStream_t stream) {
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
  const int nk = (Sk + kTileRows - 1) / kTileRows;
  const int nq = (Sq + kTileRows - 1) / kTileRows;
  const size_t s1 = dkdv_smem(D, Dv, 16 * NC);
  e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, DC, DVC, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s1));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<T, DC, DVC, NC><<<nk * BHkv, kThreads, s1, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      BHkv, group, Sq, Sk, D, Dv, scale, causal, qoff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t s2 = dq_smem(D, Dv, 16 * NC);
  e = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DC, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s2));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dq_kernel<T, DC, NC><<<nq * BH, kThreads, s2, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dq), BH, group, Sq, Sk, D,
      Dv, scale, causal, qoff, nq);
  return static_cast<int>(cudaGetLastError());
}

// The instance for (D, Dv): DC = D / 16 and DVC = Dv / 16 columns per
// thread rounded up to one of the built widths, 64-row tiles up to
// MLA's (192, 128); past that every head dim up to 256 runs the widest
// instance on 32-row query (b) and key (c) tiles, to fit shared memory.
template <typename T>
int launch_dims(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dsum, void* dq,
                void* dk, void* dv, int BH, int group, int Sq, int Sk, int D,
                int Dv, float scale, int causal, int qoff, cudaStream_t s) {
#define K7_LAUNCH(DC, DVC, NC)                                               \
  return launch<T, DC, DVC, NC>(q, k, v, o, dout, lse, dsum, dq, dk, dv, BH, \
                                group, Sq, Sk, D, Dv, scale, causal, qoff, s)
  if (D <= 64 && Dv <= 64) K7_LAUNCH(4, 4, 4);
  if (D <= 64 && Dv <= 128) K7_LAUNCH(4, 8, 4);
  if (D <= 128 && Dv <= 64) K7_LAUNCH(8, 4, 4);
  if (D <= 128 && Dv <= 128) K7_LAUNCH(8, 8, 4);
  if (D <= 192 && Dv <= 128) K7_LAUNCH(12, 8, 4);
  K7_LAUNCH(16, 16, 2);
#undef K7_LAUNCH
}

// ---------------------------------------------------------------------------
// The tensor-core variant (bf16, (D, Dv) in {(64, 64), (80, 80), (128,
// 128), (192, 128)})

constexpr int kRowPad = 128;      // the prep scratch's rows per head: Sq up
                                  // to a multiple of this (kernels/flash_
                                  // attention/bwd_kernel.py ROW_PAD)
constexpr int kConsumers = 2;     // consumer warpgroups of 64 rows each
constexpr int kStages = 2;        // ring depth
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr int kDkdvBK = 128;      // keys per dK, dV block (64 per consumer)
constexpr int kDkdvBQ = 64;       // query rows per dK, dV ring tile
constexpr int kDkdvBQWide = 32;   // the same at D = 192 (DkdvLayout)
constexpr int kDqBQ = 128;        // query rows per dQ block (64 per consumer)
constexpr int kDqBK = 128;        // keys per dQ ring tile
constexpr int kDqBKWide = 64;     // the same at D = 192 (DqLayout)
constexpr float kMasked = -1e30f; // a masked raw score: p = 2^(-huge) = 0

// (a)'s lanes per row: Dv / 8 (16 bytes each) rounded up to a power of
// two, so a row's lanes reduce by shuffles inside one warp
template <int Dv>
__host__ __device__ constexpr int prep_lanes() {
  int n = 1;
  while (n < Dv / 8) n *= 2;
  return n;
}

// (a) Dsum and lse * log2 e of every query row, each head padded to Sp rows
// (Dsum 0 and lse * log2 e = +inf past Sq): prep_lanes lanes per row, each
// of the first Dv / 8 loading 16 bytes of o and of do. Sp is a multiple of
// kRowPad, so every warp is whole. The first `nzero` threads also zero
// zero[] (the fused design's counters and ticket; none for the others).
template <int Dv>
__global__ void __launch_bounds__(kThreads)
attn_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ dsum, int* __restrict__ zero,
                     int nzero, int BH, int Sq, int Sp) {
  constexpr int kLanes = prep_lanes<Dv>();
  const long long gid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid < nzero) zero[gid] = 0;
  const long long row = gid / kLanes;
  const int part = threadIdx.x % kLanes;
  if (row >= static_cast<long long>(BH) * Sp) return;  // whole warps
  const int bh = static_cast<int>(row / Sp);
  const int i = static_cast<int>(row - static_cast<long long>(bh) * Sp);
  const long long r = static_cast<long long>(bh) * Sq + i;
  float acc = 0.f;
  if (i < Sq && part < Dv / 8) {
    const uint4 a = reinterpret_cast<const uint4*>(o + r * Dv)[part];
    const uint4 b = reinterpret_cast<const uint4*>(dout + r * Dv)[part];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]);
      const float2 y = __bfloat1622float2(b2[e]);
      acc = fmaf(y.x, x.x, acc);
      acc = fmaf(y.y, x.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    lse2[row] = i < Sq ? lse[r] * kLog2e : INFINITY;
    dsum[row] = acc;
  }
}

// x0, x1 as bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// The two register passes of a tile, on the f32 accumulators of S (raw
// scores) and dP element for element (4j + e, hopper.cuh's layout); the
// A fragments they fill take, at k16 step kk, the columns 16kk..16kk+15:
// the accumulator's n-blocks 2kk and 2kk + 1.
//
// p_tile: sc[i] = p = 2^(s * scale * log2 e + nl), nl = -lse * log2 e of
// the element's query (stats(j, e)), 0 where masked(j, e) (asked only
// when `edge`)
template <int N, typename Masked, typename Stats>
__device__ __forceinline__ void p_tile(float (&sc)[N], bool edge,
                                       Masked masked, Stats stats,
                                       float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = edge && masked(j, e) ? kMasked : sc[4 * j + e];
      sc[4 * j + e] = ex2(fmaf(s, scale_log2, stats(j, e)));
    }
}

// ds_tile: ds = p * (dp - Dsum) * scale (Dsum of the element's query:
// dsum(j, e)) into the hi and lo A fragments dh and dl
template <int N, typename Dsum>
__device__ __forceinline__ void ds_tile(const float (&p)[N],
                                        const float (&dp)[N],
                                        uint32_t (&dh)[N / 8][4],
                                        uint32_t (&dl)[N / 8][4], Dsum dsum,
                                        float scale) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds[e] = p[4 * j + e] * (dp[4 * j + e] - dsum(j, e)) * scale;
    const int kk = j / 2, r = (j % 2) * 2;
    split_bf16(ds[0], ds[1], dh[kk][r], dl[kk][r]);
    split_bf16(ds[2], ds[3], dh[kk][r + 1], dl[kk][r + 1]);
  }
}

// p_tile and ds_tile in one pass, element by element, once both products
// are done: the dK, dV kernel's way (its S^T and dP^T registers die as its
// fragments fill), with p entered as hi and lo too (ph, pl). On the card
// the two passes made that kernel slower and the dQ kernel faster, so each
// keeps its own.
template <int N, typename Masked, typename Stats, typename Dsum>
__device__ __forceinline__ void p_ds_tile(
    const float (&sc)[N], const float (&dp)[N], uint32_t (&ph)[N / 8][4],
    uint32_t (&pl)[N / 8][4], uint32_t (&dh)[N / 8][4],
    uint32_t (&dl)[N / 8][4], bool edge, Masked masked, Stats stats,
    Dsum dsum, float scale_log2, float scale) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = edge && masked(j, e) ? kMasked : sc[4 * j + e];
      p[e] = ex2(fmaf(s, scale_log2, stats(j, e)));
      ds[e] = p[e] * (dp[4 * j + e] - dsum(j, e)) * scale;
    }
    const int kk = j / 2, r = (j % 2) * 2;
    split_bf16(p[0], p[1], ph[kk][r], pl[kk][r]);
    split_bf16(p[2], p[3], ph[kk][r + 1], pl[kk][r + 1]);
    split_bf16(ds[0], ds[1], dh[kk][r], dl[kk][r]);
    split_bf16(ds[2], ds[3], dh[kk][r + 1], dl[kk][r + 1]);
  }
}

// the first 1024-byte boundary of dynamic shared memory (128-byte swizzle)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Shared memory of (b). The query rows of a ring tile are 64, or 32 at
// (192, 128): there a consumer's dK (96 registers) and dV (64) leave no
// room under its 240 for 64-row S^T and dP^T (32 each) beside the p and ds
// fragments, and 32-row tiles halve all four.
template <int D, int Dv>
struct DkdvLayout {
  static constexpr int kBQ = D > 128 ? kDkdvBQWide : kDkdvBQ;
  static constexpr int kBlocks = (D + 63) / 64;         // 64-column blocks
  static constexpr int kVBlocks = (Dv + 63) / 64;       // of V and dO
  static constexpr int kKBlock = kDkdvBK * kRowBytes;   // one block of K, V
  static constexpr int kKBytes = kKBlock * kBlocks;
  static constexpr int kVBytes = kKBlock * kVBlocks;
  static constexpr int kQBlock = kBQ * kRowBytes;       // one of Q or dO
  static constexpr int kQBytes = kQBlock * kBlocks;     // one stage of Q
  static constexpr int kDoBytes = kQBlock * kVBlocks;   // one stage of dO
  static constexpr int kVecBytes = kBQ * 4;             // a tile's lse2, Dsum
  // K, V, the Q ring, the dO ring, the (lse2, Dsum) ring, then the
  // mbarriers full_kv, full[], empty[]; plus 1024 bytes of alignment
  static constexpr int kQOff = kKBytes + kVBytes;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kVecOff = kDoOff + kStages * kDoBytes;
  static constexpr int kBarOffset = kVecOff + kStages * 2 * kVecBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= kMaxSmem, "K7 (b)'s tiles exceed shared memory");
  static_assert(kRowPad % kBQ == 0, "a tile's lse2 / Dsum leave the head");
};

// (b) dK, dV: one block per (kv head, 128-row key tile)
template <int D, int Dv, bool kOff>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse2,
                           const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int BHkv,
                           int group, int Sq, int Sk, int Sp, float scale,
                           float scale_log2, int causal, int q_offset) {
  using L = DkdvLayout<D, Dv>;
  const int qoff = kOff ? q_offset : 0;
  constexpr int BQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sk = aligned_smem(smem_raw);
  uint8_t* const sv = sk + L::kKBytes;
  uint8_t* const sq = sk + L::kQOff;                   // [kStages][kQBytes]
  uint8_t* const sdo = sk + L::kDoOff;                 // [kStages][kDoBytes]
  float* const svec =                                  // [kStages][2][BQ]
      reinterpret_cast<float*>(sk + L::kVecOff);
  uint64_t* const full_kv = reinterpret_cast<uint64_t*>(sk + L::kBarOffset);
  uint64_t* const full = full_kv + 1;
  uint64_t* const empty = full + kStages;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // blocks take the lowest key tiles first: under the causal mask they
  // meet the most query tiles
  const int kvh = blockIdx.x % BHkv;
  const int k0 = static_cast<int>(blockIdx.x / BHkv) * kDkdvBK;
  const int nq = (Sq + BQ - 1) / BQ;
  // causal: query tiles before row k0 - qoff's hold only positions < k0,
  // which see none of the block's keys; tiles are walked head by head, the
  // ring running on
  int qt0;
  if constexpr (kOff)
    qt0 = causal ? min(max(k0 - qoff, 0) / BQ, nq) : 0;
  else
    qt0 = causal ? min(k0 / BQ, nq) : 0;
  const int per_head = nq - qt0;
  const int n_tiles = group * per_head;

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, L::kKBytes + L::kVBytes);
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b)
        tma_load(sk + b * L::kKBlock, &tk, full_kv, 64 * b, k0, kvh);
#pragma unroll
      for (int b = 0; b < L::kVBlocks; ++b)
        tma_load(sv + b * L::kKBlock, &tv, full_kv, 64 * b, k0, kvh);
      for (int it = 0; it < n_tiles; ++it) {
        const int bh = kvh * group + it / per_head;
        const int q0 = (qt0 + it % per_head) * BQ;
        const int s = it % kStages;
        // the stage's tile before last released (passes at once at first)
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s,
                       L::kQBytes + L::kDoBytes + 2 * L::kVecBytes);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b)
          tma_load(sq + s * L::kQBytes + b * L::kQBlock, &tq, full + s,
                   64 * b, q0, bh);
#pragma unroll
        for (int b = 0; b < L::kVBlocks; ++b)
          tma_load(sdo + s * L::kDoBytes + b * L::kQBlock, &tdo, full + s,
                   64 * b, q0, bh);
        const long long row = static_cast<long long>(bh) * Sp + q0;
        bulk_load(svec + s * 2 * BQ, lse2 + row, L::kVecBytes, full + s);
        bulk_load(svec + s * 2 * BQ + BQ, dsum + row, L::kVecBytes,
                  full + s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroups: cw owns keys kb .. kb + 63
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = k0 + 64 * cw;
  const int key0 = kb + 16 * warp + g, key1 = key0 + 8;  // this thread's keys
  // K, V rows of this warpgroup as K-major A; Q, dO as the K-major B of
  // S^T, dP^T and as the MN-major B of dK, dV
  const uint64_t dka = make_desc(sk + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dva = make_desc(sv + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dqk = make_desc(sq, 16, 1024);
  const uint64_t dok = make_desc(sdo, 16, 1024);
  const uint64_t dqm = make_desc(sq, L::kQBlock, 1024);
  const uint64_t dom = make_desc(sdo, L::kQBlock, 1024);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float adk[D / 2], adv[Dv / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Dv / 2; ++i) adv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4];
  uint32_t dh[BQ / 16][4], dl[BQ / 16][4];

  mbar_wait(full_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (qt0 + it % per_head) * BQ;
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    // causal: a tile whose rows (those < Sq) all lie before this
    // warpgroup's keys adds nothing (with no offset its rows' end and the
    // keys' start are multiples of 32, so its rows past Sq need no test)
    bool skip;
    if constexpr (kOff)
      skip = causal && min(q0 + BQ, Sq) + qoff <= kb;
    else
      skip = causal && q0 + BQ <= kb;
    if (!skip) {
      // S^T = K Q^T (D/16 steps of k16) and dP^T = V dO^T (Dv/16): a step
      // advances 32 bytes inside a 128-byte swizzled row, or moves to the
      // next 64-column block
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        const uint32_t oa = (kk / 4) * L::kKBlock + in_row;
        const uint32_t ob = s * L::kQBytes + (kk / 4) * L::kQBlock + in_row;
        wgmma_ss(st, dka + (oa >> 4), dqk + (ob >> 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < Dv / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        const uint32_t oa = (kk / 4) * L::kKBlock + in_row;
        const uint32_t ob = s * L::kDoBytes + (kk / 4) * L::kQBlock + in_row;
        wgmma_ss(dpt, dva + (oa >> 4), dok + (ob >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(st);
      keep(dpt);

      // rows are keys, columns queries: lse and Dsum per column
      const float* const vec = svec + s * 2 * BQ;
      const bool edge =
          (causal && q0 + qoff < kb + 63) || kb + 64 > Sk || q0 + BQ > Sq;
      p_ds_tile(
          st, dpt, ph, pl, dh, dl, edge,
          [&](int j, int e) {
            const int key = e < 2 ? key0 : key1;
            const int qp = q0 + 8 * j + 2 * t + (e & 1);
            return key >= Sk || qp >= Sq || (causal && key > qp + qoff);
          },
          [&](int j, int e) { return -vec[8 * j + 2 * t + (e & 1)]; },
          [&](int j, int e) { return vec[BQ + 8 * j + 2 * t + (e & 1)]; },
          scale_log2, scale);

      // dV += P^T dO, dK += dS^T Q (each hi, then lo): dO and Q are the
      // MN-major B operands; a k16 step is 16 query rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adv, ph[kk],
                 dom + ((s * L::kDoBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adv, pl[kk],
                 dom + ((s * L::kDoBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adk, dh[kk],
                 dqm + ((s * L::kQBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adk, dl[kk],
                 dqm + ((s * L::kQBytes + kk * 16 * kRowBytes) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      keep(adv);
      keep(adk);
      keep(ph);
      keep(pl);
      keep(dh);
      keep(dl);
    }
    release(empty + s);
  }

  // dK (D wide) and dV (Dv wide), rounded to bf16 once
  const long long base = static_cast<long long>(kvh) * Sk;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (key0 < Sk)
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + key0) * D + col) =
          __floats2bfloat162_rn(adk[4 * j], adk[4 * j + 1]);
    if (key1 < Sk)
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + key1) * D + col) =
          __floats2bfloat162_rn(adk[4 * j + 2], adk[4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < Dv / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (key0 < Sk)
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + key0) * Dv + col) =
          __floats2bfloat162_rn(adv[4 * j], adv[4 * j + 1]);
    if (key1 < Sk)
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + key1) * Dv + col) =
          __floats2bfloat162_rn(adv[4 * j + 2], adv[4 * j + 3]);
  }
}

// Shared memory of (c). The key rows of a ring tile are 128, or 64 at
// (192, 128): there Q (48 KB), dO (32 KB) and a 2-stage ring of 128-row K
// and V tiles (160 KB) would take 241 KB, over the 227 KB a block may
// have; 64-row tiles take 161 KB.
template <int D, int Dv>
struct DqLayout {
  static constexpr int kBK = D > 128 ? kDqBKWide : kDqBK;
  static constexpr int kBlocks = (D + 63) / 64;         // 64-column blocks
  static constexpr int kVBlocks = (Dv + 63) / 64;       // of V and dO
  static constexpr int kQBlock = kDqBQ * kRowBytes;     // one block of Q, dO
  static constexpr int kQBytes = kQBlock * kBlocks;
  static constexpr int kDoBytes = kQBlock * kVBlocks;
  static constexpr int kKBlock = kBK * kRowBytes;       // one of K or V
  static constexpr int kKBytes = kKBlock * kBlocks;     // one stage of K
  static constexpr int kVBytes = kKBlock * kVBlocks;    // one stage of V
  // Q, dO, the K ring, the V ring, then the mbarriers full_q, full_k[],
  // full_v[], empty[]; plus 1024 bytes of alignment
  static constexpr int kKOff = kQBytes + kDoBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOffset = kVOff + kStages * kVBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 3 * kStages);
  static_assert(kSmem <= kMaxSmem, "K7 (c)'s tiles exceed shared memory");
};

// (c) dQ: one block per (q head, 128-row query tile)
template <int D, int Dv, bool kOff>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse2,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dq, int BH, int group,
                         int Sq, int Sk, int Sp, float scale,
                         float scale_log2, int causal, int nq,
                         int q_offset) {
  using L = DqLayout<D, Dv>;
  const int qoff = kOff ? q_offset : 0;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sq = aligned_smem(smem_raw);
  uint8_t* const sdo = sq + L::kQBytes;
  uint8_t* const sk = sq + L::kKOff;                   // [kStages][kKBytes]
  uint8_t* const sv = sq + L::kVOff;                   // [kStages][kVBytes]
  uint64_t* const full_q = reinterpret_cast<uint64_t*>(sq + L::kBarOffset);
  uint64_t* const full_k = full_q + 1;
  uint64_t* const full_v = full_k + kStages;
  uint64_t* const empty = full_v + kStages;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4 * kConsumers);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // heaviest (last) query tiles first
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * kDqBQ;
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + kDqBQ, Sq) - 1 + qoff) / BK + 1);

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = bh / group;
      mbar_expect_tx(full_q, L::kQBytes + L::kDoBytes);
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b)
        tma_load(sq + b * L::kQBlock, &tq, full_q, 64 * b, q0, bh);
#pragma unroll
      for (int b = 0; b < L::kVBlocks; ++b)
        tma_load(sdo + b * L::kQBlock, &tdo, full_q, 64 * b, q0, bh);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + s, L::kKBytes);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b)
          tma_load(sk + s * L::kKBytes + b * L::kKBlock, &tk, full_k + s,
                   64 * b, kt * BK, kvh);
        mbar_expect_tx(full_v + s, L::kVBytes);
#pragma unroll
        for (int b = 0; b < L::kVBlocks; ++b)
          tma_load(sv + s * L::kVBytes + b * L::kKBlock, &tv, full_v + s,
                   64 * b, kt * BK, kvh);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroups: cw owns query rows ra .. ra + 63
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + 64 * cw;
  const int r0 = ra + 16 * warp + g, r1 = r0 + 8;    // this thread's rows
  // tiles past nk_wg lie wholly above this warpgroup's rows (causal): they
  // are only released
  const int nk_wg = causal ? min(nk, (ra + 63 + qoff) / BK + 1) : nk;
  // the padded scratch holds rows up to Sp >= q0 + 128
  const long long srow = static_cast<long long>(bh) * Sp;
  const float nl0 = -lse2[srow + r0], nl1 = -lse2[srow + r1];
  const float ds0 = dsum[srow + r0], ds1 = dsum[srow + r1];
  // Q, dO rows of this warpgroup as K-major A; K, V as the K-major B of S,
  // dP; K as the MN-major B of dQ
  const uint64_t dqa = make_desc(sq + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t doa = make_desc(sdo + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dkb = make_desc(sk, 16, 1024);
  const uint64_t dvb = make_desc(sv, 16, 1024);
  const uint64_t dkm = make_desc(sk, L::kKBlock, 1024);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float adq[D / 2], sc[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t dh[BK / 16][4], dl[BK / 16][4];

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < nk_wg; ++kt) {
    const int s = kt % kStages;
    const uint32_t ph = (kt / kStages) & 1;
    const int k0 = kt * BK;
    mbar_wait(full_k + s, ph);
    mbar_wait(full_v + s, ph);

    // S = Q K^T (D/16 steps) and dP = dO V^T (Dv/16); p while dP runs
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_row = (kk % 4) * 32;
      const uint32_t oa = (kk / 4) * L::kQBlock + in_row;
      const uint32_t ob = s * L::kKBytes + (kk / 4) * L::kKBlock + in_row;
      wgmma_ss(sc, dqa + (oa >> 4), dkb + (ob >> 4), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < Dv / 16; ++kk) {
      const uint32_t in_row = (kk % 4) * 32;
      const uint32_t oa = (kk / 4) * L::kQBlock + in_row;
      const uint32_t ob = s * L::kVBytes + (kk / 4) * L::kKBlock + in_row;
      wgmma_ss(dp, doa + (oa >> 4), dvb + (ob >> 4), kk > 0);
    }
    wgmma_commit();

    // rows are queries, columns keys: lse and Dsum per row
    const bool edge =
        k0 + BK > Sk || (causal && k0 + BK - 1 > ra + qoff) || ra + 64 > Sq;
    wgmma_wait<1>();
    keep(sc);
    p_tile(
        sc, edge,
        [&](int j, int e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          return kp >= Sk || row >= Sq || (causal && kp > row + qoff);
        },
        [&](int, int e) { return e < 2 ? nl0 : nl1; }, scale_log2);
    wgmma_wait<0>();
    keep(dp);
    ds_tile(sc, dp, dh, dl, [&](int, int e) { return e < 2 ? ds0 : ds1; },
            scale);

    // dQ += dS K (hi, then lo): K is the MN-major B operand; a k16 step is
    // 16 key rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(adq, dh[kk],
               dkm + ((s * L::kKBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(adq, dl[kk],
               dkm + ((s * L::kKBytes + kk * 16 * kRowBytes) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    keep(adq);
    keep(dh);
    keep(dl);
    release(empty + s);
  }
  for (int kt = nk_wg; kt < nk; ++kt) {
    const int s = kt % kStages;
    const uint32_t ph = (kt / kStages) & 1;
    mbar_wait(full_k + s, ph);
    mbar_wait(full_v + s, ph);
    release(empty + s);
  }

  __nv_bfloat16* const ob = dq + static_cast<long long>(bh) * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<long long>(r0) * D + col) =
          __floats2bfloat162_rn(adq[4 * j], adq[4 * j + 1]);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<long long>(r1) * D + col) =
          __floats2bfloat162_rn(adq[4 * j + 2], adq[4 * j + 3]);
  }
}

// Shared memory of (d), the fused design at (D, D) = (64, 64) and (128,
// 128): (b)'s K, V and 2-stage rings of 64-row Q and dO tiles, then dS^T of
// the block's 128 keys x 64 queries as bf16 hi and lo (keys as rows,
// 128-byte swizzled: the MN-major A of dQ; each consumer its 64 rows), one
// f32 staging tile per consumer (its 64 x D dQ partial, in its registers'
// order), the (lse2, Dsum) ring, the mbarriers full_kv, full[], empty[],
// dq_full[], dq_empty[] and the block's ticket; plus 1024 bytes of
// alignment. At D = 128: 225 KB of tiles, of the 227 KB a block may have.
template <int D>
struct FusedLayout {
  static_assert(D == 64 || D == 128, "the fused design takes D = 64, 128");
  static constexpr int kBQ = kDkdvBQ;                   // query rows a step
  static constexpr int kBlocks = D / 64;                // 64-column blocks
  static constexpr int kKBlock = kDkdvBK * kRowBytes;   // one block of K, V
  static constexpr int kKBytes = kKBlock * kBlocks;
  static constexpr int kQBlock = kBQ * kRowBytes;       // one of Q or dO
  static constexpr int kQBytes = kQBlock * kBlocks;     // one stage
  static constexpr int kDsBytes = kDkdvBK * kRowBytes;  // dS^T hi (or lo)
  static constexpr int kStageBytes = kBQ * D * 4;      // a consumer's dQ
  static constexpr int kVecBytes = kBQ * 4;
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kDsOff = kDoOff + kStages * kQBytes;
  static constexpr int kStageOff = kDsOff + 2 * kDsBytes;
  static constexpr int kVecOff = kStageOff + kConsumers * kStageBytes;
  static constexpr int kBarOffset = kVecOff + kStages * 2 * kVecBytes;
  static constexpr int kBars = 1 + 2 * kStages + 2 * kConsumers;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * kBars + 16;
  static_assert(kSmem <= kMaxSmem, "K7 (d)'s tiles exceed shared memory");
  static_assert(kRowPad % kBQ == 0, "a tile's lse2 / Dsum leave the head");
};

// (d) dK, dV and dQ: one block per (kv head, 128-row key tile), (b)'s
// warpgroups and tiles, with each consumer's dQ partial over its 64 keys
// summed into acc in a fixed order (the design note at the top of this
// file)
template <int D, bool kOff>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse2,
                            const float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ acc, int* __restrict__ count,
                            int* __restrict__ ticket, int BHkv, int group,
                            int Sq, int Sk, int Sp, float scale,
                            float scale_log2, int causal, int q_offset) {
  using L = FusedLayout<D>;
  const int qoff = kOff ? q_offset : 0;
  constexpr int BQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sk = aligned_smem(smem_raw);
  uint8_t* const sv = sk + L::kKBytes;
  uint8_t* const sq = sk + L::kQOff;                   // [kStages][kQBytes]
  uint8_t* const sdo = sk + L::kDoOff;                 // [kStages][kQBytes]
  uint8_t* const sds = sk + L::kDsOff;                 // hi, lo
  uint8_t* const sstage = sk + L::kStageOff;           // [kConsumers]
  float* const svec =                                  // [kStages][2][BQ]
      reinterpret_cast<float*>(sk + L::kVecOff);
  uint64_t* const full_kv = reinterpret_cast<uint64_t*>(sk + L::kBarOffset);
  uint64_t* const full = full_kv + 1;
  uint64_t* const empty = full + kStages;
  uint64_t* const dq_full = empty + kStages;
  uint64_t* const dq_empty = dq_full + kConsumers;
  int* const sticket = reinterpret_cast<int*>(dq_empty + kConsumers);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);   // lane 0 of each consumer warp
    }
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(dq_full + c, 4);              // lane 0 of the consumer's warps
      mbar_init(dq_empty + c, 1);             // its reducer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the work item in the order blocks start: lowest key tiles (under
    // the causal mask the heaviest) first
    *sticket = atomicAdd(ticket, 1);
  }
  __syncthreads();

  const int item = *sticket;
  const int kvh = item % BHkv;
  const int kt = item / BHkv;                 // the key tile, and this
  const int k0 = kt * kDkdvBK;                // block's place in dQ's order
  const int nq = (Sq + BQ - 1) / BQ;
  // query tiles from the last down to the first that reaches the block's
  // keys (causal) or to 0, the group's heads inside each: step it is query
  // tile nq - 1 - it / group of head kvh * group + it % group, the same
  // step in every block of the kv head. Key tile 0 reaches every query
  // tile (key 0 is every row's), and qt0 does not fall as kt grows, so
  // the blocks that reach a tile are key tiles 0, 1, ..., and its turns
  // 0, 1, ... are all taken, whatever the offset
  int qt0;
  if constexpr (kOff)
    qt0 = causal ? min(max(k0 - qoff, 0) / BQ, nq) : 0;
  else
    qt0 = causal ? min(k0 / BQ, nq) : 0;
  const int n_tiles = (nq - qt0) * group;
  const int nq_acc = Sp / BQ;                 // acc's query tiles per head

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 loads, lane 0 of warps 1 and 2 add the
    // two consumers' dQ partials into acc
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * L::kKBytes);
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b) {
        tma_load(sk + b * L::kKBlock, &tk, full_kv, 64 * b, k0, kvh);
        tma_load(sv + b * L::kKBlock, &tv, full_kv, 64 * b, k0, kvh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int bh = kvh * group + it % group;
        const int q0 = (nq - 1 - it / group) * BQ;
        const int s = it % kStages;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::kQBytes + 2 * L::kVecBytes);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b) {
          tma_load(sq + s * L::kQBytes + b * L::kQBlock, &tq, full + s,
                   64 * b, q0, bh);
          tma_load(sdo + s * L::kQBytes + b * L::kQBlock, &tdo, full + s,
                   64 * b, q0, bh);
        }
        const long long row = static_cast<long long>(bh) * Sp + q0;
        bulk_load(svec + s * 2 * BQ, lse2 + row, L::kVecBytes, full + s);
        bulk_load(svec + s * 2 * BQ + BQ, dsum + row, L::kVecBytes,
                  full + s);
      }
    } else if ((threadIdx.x & 31) == 0 && threadIdx.x < 32 * (1 + kConsumers)) {
      // consumer cw's partial of each step goes to acc tile (bh, query
      // tile) in its turn, kConsumers * kt + cw, once the (key tile,
      // consumer) pairs before it have added theirs: the first stores it,
      // the others add it; a consumer whose keys all lie past the tile
      // (causal) has no partial and only takes its turn
      const int cw = threadIdx.x / 32 - 1;
      const int turn = kConsumers * kt + cw;
      const uint8_t* const stage = sstage + cw * L::kStageBytes;
      for (int it = 0; it < n_tiles; ++it) {
        const int qt = nq - 1 - it / group;
        const long long tile =
            static_cast<long long>(kvh * group + it % group) * nq_acc + qt;
        mbar_wait(dq_full + cw, it & 1);
        wait_count(count + tile, turn);
        bool none;
        if constexpr (kOff)
          none = causal && min((qt + 1) * BQ, Sq) + qoff <= k0 + 64 * cw;
        else
          none = causal && (qt + 1) * BQ <= k0 + 64 * cw;
        if (!none) {
          fence_async_global();
          float* const dst = acc + tile * (L::kStageBytes / 4);
          if (turn == 0)
            bulk_store(dst, stage, L::kStageBytes);
          else
            bulk_add_f32(dst, stage, L::kStageBytes);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(dq_empty + cw);         // the stage may be refilled
          bulk_wait();
          fence_async_global();
        } else {
          mbar_arrive(dq_empty + cw);
        }
        release_count(count + tile);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroups: cw owns keys kb .. kb + 63
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = k0 + 64 * cw;
  const int key0 = kb + 16 * warp + g, key1 = key0 + 8;  // this thread's keys
  const uint64_t dka = make_desc(sk + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dva = make_desc(sv + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dqk = make_desc(sq, 16, 1024);
  const uint64_t dok = make_desc(sdo, 16, 1024);
  const uint64_t dqm = make_desc(sq, L::kQBlock, 1024);
  const uint64_t dom = make_desc(sdo, L::kQBlock, 1024);
  // dQ's partial = dS K over this warpgroup's keys: its rows of dS^T
  // (keys as rows) as the MN-major A, its rows of the K tile as the
  // MN-major B (64 columns at a time)
  const uint64_t dsa = make_desc(sds + cw * 64 * kRowBytes, L::kDsBytes,
                                 1024);
  const uint64_t dkq = make_desc(sk + cw * 64 * kRowBytes, L::kKBlock, 1024);
  // this thread's two key rows of dS^T (local rows r and r + 8, r & 7 = g)
  uint8_t* const ds_row = sds + (64 * cw + 16 * warp + g) * kRowBytes;
  float2* const stage =
      reinterpret_cast<float2*>(sstage + cw * L::kStageBytes) + tid;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float adk[D / 2], adv[D / 2], adq[L::kBlocks][32], st[BQ / 2],
      dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4];
  uint32_t dh[BQ / 16][4], dl[BQ / 16][4];

  mbar_wait(full_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (nq - 1 - it / group) * BQ;
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    // causal: a tile whose rows (those < Sq) all lie before this
    // warpgroup's keys adds nothing (the reducer's test above)
    bool mine;
    if constexpr (kOff)
      mine = !(causal && min(q0 + BQ, Sq) + qoff <= kb);
    else
      mine = !(causal && q0 + BQ <= kb);
    if (mine) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        const uint32_t oa = (kk / 4) * L::kKBlock + in_row;
        const uint32_t ob = s * L::kQBytes + (kk / 4) * L::kQBlock + in_row;
        wgmma_ss(st, dka + (oa >> 4), dqk + (ob >> 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        const uint32_t oa = (kk / 4) * L::kKBlock + in_row;
        const uint32_t ob = s * L::kQBytes + (kk / 4) * L::kQBlock + in_row;
        wgmma_ss(dpt, dva + (oa >> 4), dok + (ob >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(st);
      keep(dpt);
      const float* const vec = svec + s * 2 * BQ;
      const bool edge =
          (causal && q0 + qoff < kb + 63) || kb + 64 > Sk || q0 + BQ > Sq;
      p_ds_tile(
          st, dpt, ph, pl, dh, dl, edge,
          [&](int j, int e) {
            const int key = e < 2 ? key0 : key1;
            const int qp = q0 + 8 * j + 2 * t + (e & 1);
            return key >= Sk || qp >= Sq || (causal && key > qp + qoff);
          },
          [&](int j, int e) { return -vec[8 * j + 2 * t + (e & 1)]; },
          [&](int j, int e) { return vec[BQ + 8 * j + 2 * t + (e & 1)]; },
          scale_log2, scale);
      // dS^T rows key0 (fragment registers 0, 2) and key1 (1, 3); queries
      // 16kk + 2t (0, 1) and + 8 (2, 3): a 4-byte word in 16-byte chunk c
      // of the 128-byte swizzled row, at chunk c ^ (row & 7) = c ^ g. The
      // last step's dQ product, which read these rows, is done.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int off = (r & 1) * 8 * kRowBytes +
                          (((2 * kk + (r >> 1)) ^ g) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(ds_row + off) = dh[kk][r];
          *reinterpret_cast<uint32_t*>(ds_row + L::kDsBytes + off) =
              dl[kk][r];
        }
      fence_async_smem();
      // dV += P^T dO, dK += dS^T Q (each hi, then lo), as in (b)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adv, ph[kk],
                 dom + ((s * L::kQBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adv, pl[kk],
                 dom + ((s * L::kQBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adk, dh[kk],
                 dqm + ((s * L::kQBytes + kk * 16 * kRowBytes) >> 4));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adk, dl[kk],
                 dqm + ((s * L::kQBytes + kk * 16 * kRowBytes) >> 4));
      wgmma_commit();
      // this warpgroup's dS^T rows are written (its own barrier: the
      // other consumer goes its own pace)
      named_sync(1 + cw, 128);
      wgmma_wait<0>();
      keep(adv);
      keep(adk);
      keep(ph);
      keep(pl);
      keep(dh);
      keep(dl);
    }
    release(empty + s);                       // Q, dO, lse2, Dsum read
    // dQ's partial = dS K over this warpgroup's 64 keys (4 k16 steps), hi
    // then lo, once dV and dK have freed their registers: one N = 64
    // product per 64-column block of K, each into its own 32 registers and
    // committed apart (at D = 128 one 64-register accumulator beside dK's
    // and dV's spilled), so block 0 is staged while block 1's runs. The
    // staging tile holds pair i of thread tid at i * 128 + tid (the layout
    // of one m64nD accumulator) and is refilled once the reducer has read
    // the last partial; then it is handed over (a tile before this
    // warpgroup's keys hands over nothing).
    mbar_wait(dq_empty + cw, (it & 1) ^ 1);
    if (mine) {
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < L::kBlocks; ++b) {
        const uint32_t ob = b * L::kKBlock;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_tt(adq[b], dsa + ((kk * 16 * kRowBytes) >> 4),
                      dkq + ((ob + kk * 16 * kRowBytes) >> 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_tt(adq[b],
                      dsa + ((L::kDsBytes + kk * 16 * kRowBytes) >> 4),
                      dkq + ((ob + kk * 16 * kRowBytes) >> 4), 1);
        wgmma_commit();
      }
      wgmma_wait<L::kBlocks - 1>();
      keep(adq[0]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        stage[i * 128] = make_float2(adq[0][2 * i], adq[0][2 * i + 1]);
      if (L::kBlocks == 2) {
        constexpr int b = L::kBlocks - 1;
        wgmma_wait<0>();
        keep(adq[b]);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          stage[(16 * b + i) * 128] =
              make_float2(adq[b][2 * i], adq[b][2 * i + 1]);
      }
      fence_async_smem();
    }
    release(dq_full + cw);
  }

  // dK and dV (D wide), rounded to bf16 once
  const long long base = static_cast<long long>(kvh) * Sk;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (key0 < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + key0) * D + col) =
          __floats2bfloat162_rn(adk[4 * j], adk[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + key0) * D + col) =
          __floats2bfloat162_rn(adv[4 * j], adv[4 * j + 1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (base + key1) * D + col) =
          __floats2bfloat162_rn(adk[4 * j + 2], adk[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (base + key1) * D + col) =
          __floats2bfloat162_rn(adv[4 * j + 2], adv[4 * j + 3]);
    }
  }
}

// (e) dq from acc, rounded to bf16 once: one thread per float pair of a
// staged partial, whose place in the staging tile (pair i of consumer
// thread tid) names its two elements: row 16 w + g + 8 (i & 1) of the
// query tile and columns 8 (i >> 1) + 2t, + 1 (the accumulator layout of
// hopper.cuh)
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_convert_kernel(const float* __restrict__ acc,
                           __nv_bfloat16* __restrict__ dq, int BH, int Sq,
                           int nq, int nq_acc) {
  constexpr int kPairs = D / 4;
  const long long gid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int tid = static_cast<int>(gid % 128);
  long long rest = gid / 128;
  const int i = static_cast<int>(rest % kPairs);
  rest /= kPairs;
  const int qt = static_cast<int>(rest % nq);
  const long long bh = rest / nq;
  const int w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const int row = qt * kDkdvBQ + 16 * w + g + 8 * (i & 1);
  if (bh >= BH || row >= Sq) return;
  const int col = 8 * (i >> 1) + 2 * t;
  const long long tile = bh * nq_acc + qt;
  const float2 x = reinterpret_cast<const float2*>(
      acc + tile * (kDkdvBQ * D))[i * 128 + tid];
  *reinterpret_cast<__nv_bfloat162*>(dq + (bh * Sq + row) * D + col) =
      __floats2bfloat162_rn(x.x, x.y);
}

template <int D, int Dv, bool kOff>
int launch_wgmma_inst(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* scratch, void* dq, void* dk, void* dv, int BH,
                      int group, int Sq, int Sk, float scale, int causal,
                      int qoff, cudaStream_t stream) {
  using A = DkdvLayout<D, Dv>;
  using C = DqLayout<D, Dv>;
  const int BHkv = BH / group;
  const int Sp = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  float* const lse2 = scratch;
  float* const dsum = scratch + static_cast<long long>(BH) * Sp;
  // prep_lanes per padded row
  const long long lanes = static_cast<long long>(BH) * Sp * prep_lanes<Dv>();
  attn_bwd_prep_kernel<Dv><<<static_cast<unsigned>(lanes / kThreads),
                             kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, dsum, nullptr, 0,
      BH, Sq, Sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  EncodeTiled enc;
  const int rc = get_encoder(&enc);
  if (rc != 0) return rc;
  // (b)'s maps: Q and dO in A::kBQ-row tiles, K and V in kDkdvBK; (c)'s: Q
  // and dO in kDqBQ, K and V in C::kBK
  CUtensorMap q_b, do_b, k_b, v_b, q_c, do_c, k_c, v_c;
  CUresult r = encode(enc, &q_b, q, BH, Sq, D, A::kBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &do_b, dout, BH, Sq, Dv, A::kBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &k_b, k, BHkv, Sk, D, kDkdvBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &v_b, v, BHkv, Sk, Dv, kDkdvBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &q_c, q, BH, Sq, D, kDqBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &do_c, dout, BH, Sq, Dv, kDqBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &k_c, k, BHkv, Sk, D, C::kBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &v_c, v, BHkv, Sk, Dv, C::kBK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  static int regs_dkdv = -1, regs_dq = -1;
  auto dkdv_kernel = attn_bwd_dkdv_wgmma_kernel<D, Dv, kOff>;
  auto dq_kernel = attn_bwd_dq_wgmma_kernel<D, Dv, kOff>;
  e = check_regs(dkdv_kernel, &regs_dkdv);
  if (e == cudaSuccess) e = check_regs(dq_kernel, &regs_dq);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             A::kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);

  const float scale_log2 = scale * kLog2e;
  const int nkt = (Sk + kDkdvBK - 1) / kDkdvBK;
  dkdv_kernel<<<nkt * BHkv, kWgThreads, A::kSmem, stream>>>(
      q_b, k_b, v_b, do_b, lse2, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), BHkv, group, Sq, Sk, Sp, scale,
      scale_log2, causal, qoff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (Sq + kDqBQ - 1) / kDqBQ;
  dq_kernel<<<nq * BH, kWgThreads, C::kSmem, stream>>>(
      q_c, k_c, v_c, do_c, lse2, dsum, static_cast<__nv_bfloat16*>(dq),
      BH, group, Sq, Sk, Sp, scale, scale_log2, causal, nq, qoff);
  return static_cast<int>(cudaGetLastError());
}

// The fused design at (D, D): (a) zeroing dQ's counters and the ticket,
// (d), then (e). scratch: lse2 and Dsum (2, BH, Sp), acc (BH, Sp / 64,
// 64 D) f32, count (BH, Sp / 64) int32, then the ticket.
template <int D, bool kOff>
int launch_fused_inst(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* scratch, void* dq, void* dk, void* dv, int BH,
                      int group, int Sq, int Sk, float scale, int causal,
                      int qoff, cudaStream_t stream) {
  using F = FusedLayout<D>;
  const int BHkv = BH / group;
  const int Sp = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  const int nq_acc = Sp / kDkdvBQ;
  float* const lse2 = scratch;
  float* const dsum = scratch + static_cast<long long>(BH) * Sp;
  float* const acc = scratch + 2LL * BH * Sp;
  int* const count = reinterpret_cast<int*>(acc + static_cast<long long>(BH) *
                                                      Sp * D);
  const int n_count = BH * nq_acc;
  int* const ticket = count + n_count;
  const long long lanes = static_cast<long long>(BH) * Sp * prep_lanes<D>();
  attn_bwd_prep_kernel<D><<<static_cast<unsigned>(lanes / kThreads),
                            kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, dsum, count,
      n_count + 1, BH, Sq, Sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  EncodeTiled enc;
  const int rc = get_encoder(&enc);
  if (rc != 0) return rc;
  CUtensorMap mq, mdo, mk, mv;
  CUresult r = encode(enc, &mq, q, BH, Sq, D, F::kBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &mdo, dout, BH, Sq, D, F::kBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &mk, k, BHkv, Sk, D, kDkdvBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &mv, v, BHkv, Sk, D, kDkdvBK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  static int regs = -1;
  auto kernel = attn_bwd_fused_wgmma_kernel<D, kOff>;
  e = check_regs(kernel, &regs);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nkt = (Sk + kDkdvBK - 1) / kDkdvBK;
  kernel<<<nkt * BHkv, kWgThreads, F::kSmem, stream>>>(
      mq, mk, mv, mdo, lse2, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), acc, count, ticket, BHkv, group, Sq,
      Sk, Sp, scale, scale * kLog2e, causal, qoff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (Sq + kDkdvBQ - 1) / kDkdvBQ;
  // BH * nq * (D / 4) * 128 float pairs, kThreads to a block
  attn_bwd_dq_convert_kernel<D><<<BH * nq * (D / 8), kThreads, 0, stream>>>(
      acc, static_cast<__nv_bfloat16*>(dq), BH, Sq, nq, nq_acc);
  return static_cast<int>(cudaGetLastError());
}

// launch_wgmma_inst's and launch_fused_inst's instance for the offset:
// kOff = false at q_offset = 0
template <int D, int Dv>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* scratch,
                 void* dq, void* dk, void* dv, int BH, int group, int Sq,
                 int Sk, float scale, int causal, int qoff,
                 cudaStream_t stream) {
  return qoff > 0 ? launch_wgmma_inst<D, Dv, true>(
                        q, k, v, o, dout, lse, scratch, dq, dk, dv, BH, group,
                        Sq, Sk, scale, causal, qoff, stream)
                  : launch_wgmma_inst<D, Dv, false>(
                        q, k, v, o, dout, lse, scratch, dq, dk, dv, BH, group,
                        Sq, Sk, scale, causal, qoff, stream);
}

template <int D>
int launch_fused(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* scratch,
                 void* dq, void* dk, void* dv, int BH, int group, int Sq,
                 int Sk, float scale, int causal, int qoff,
                 cudaStream_t stream) {
  return qoff > 0 ? launch_fused_inst<D, true>(
                        q, k, v, o, dout, lse, scratch, dq, dk, dv, BH, group,
                        Sq, Sk, scale, causal, qoff, stream)
                  : launch_fused_inst<D, false>(
                        q, k, v, o, dout, lse, scratch, dq, dk, dv, BH, group,
                        Sq, Sk, scale, causal, qoff, stream);
}

}  // namespace

// q_offset: K6's (0 <= q_offset <= Sk), the position of query row 0.
// q, dq: (BH, Sq, D); o, do: (BH, Sq, Dv); k, dk: (BH / group, Sk, D); v,
// dv: (BH / group, Sk, Dv); lse (BH, Sq) f32. scratch: f32, (BH, Sq) for
// simt (Dsum); (2, BH, Sp) for wgmma (lse * log2 e and Dsum), Sp = Sq
// rounded up to a multiple of kRowPad; for fused that, then dQ's f32
// accumulator (BH, Sp, D) and BH * Sp / kDkdvBQ + 1 int32 (bwd_kernel.py
// scratch_numel). dtype: 0 = float32, 1 = bfloat16 (every
// tensor but lse and scratch). variant: 0 = simt (any dtype and head dims
// up to 256), 1 = wgmma (the three kernels; bf16 with (D, Dv) in {(64,
// 64), (80, 80), (128, 128), (192, 128)} only: the rule of kernel.py
// variant()), 2 = fused (bf16 with (D, Dv) in {(64, 64), (128, 128)}
// only: bwd_kernel.py variant(), which names the variant). Launches (a),
// (b), (c), or (a), (d), (e), in order on `stream`; returns 0, the first
// cudaError_t (cudaErrorInvalidKernelImage when a wgmma kernel was not
// built with the 168 registers its setmaxnreg regrouping needs), or
// -CUresult when a tensor map cannot be made.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* scratch, void* dq, void* dk,
                                   void* dv, int BH, int group, int Sq,
                                   int Sk, int D, int Dv, float scale,
                                   int causal, int q_offset, int dtype,
                                   int variant, void* stream) {
  if (BH < 1 || group < 1 || BH % group || Sq < 1 || Sk < 1 || D < 1 ||
      D > kMaxHeadDim || Dv < 1 || Dv > kMaxHeadDim || q_offset < 0 ||
      q_offset > Sk || (dtype != 0 && dtype != 1) ||
      static_cast<long long>((Sq + kTileRows - 1) / kTileRows) * BH >
          INT_MAX ||
      static_cast<long long>((Sk + kTileRows - 1) / kTileRows) *
              (BH / group) > INT_MAX ||
      static_cast<long long>(BH) * ((Sq + kRowPad - 1) / kRowPad) * kRowPad *
              32 / kThreads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(scratch);
  // the rule of kernel.py variant() (tests/test_torch_flash.py reads it)
  const bool tensor_cores =
      dtype == 1 && ((D == 64 && Dv == 64) || (D == 80 && Dv == 80) ||
                     (D == 128 && Dv == 128) || (D == 192 && Dv == 128));
  if (variant == 2) {
    // the rule of bwd_kernel.py variant()
    const bool fused = tensor_cores && D == Dv && (D == 64 || D == 128);
    if (!fused) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64)
      return launch_fused<64>(q, k, v, o, dout, l, ds, dq, dk, dv, BH,
                                 group, Sq, Sk, scale, causal, q_offset, s);
    return launch_fused<128>(q, k, v, o, dout, l, ds, dq, dk, dv, BH,
                                group, Sq, Sk, scale, causal, q_offset, s);
  }
  if (variant == 1) {
    if (!tensor_cores) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64)
      return launch_wgmma<64, 64>(q, k, v, o, dout, l, ds, dq, dk, dv,
                                     BH, group, Sq, Sk, scale, causal,
                                     q_offset, s);
    if (D == 80)
      return launch_wgmma<80, 80>(q, k, v, o, dout, l, ds, dq, dk, dv,
                                     BH, group, Sq, Sk, scale, causal,
                                     q_offset, s);
    if (D == 128)
      return launch_wgmma<128, 128>(q, k, v, o, dout, l, ds, dq, dk, dv,
                                       BH, group, Sq, Sk, scale, causal,
                                       q_offset, s);
    return launch_wgmma<192, 128>(q, k, v, o, dout, l, ds, dq, dk, dv,
                                     BH, group, Sq, Sk, scale, causal,
                                     q_offset, s);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dims<float>(q, k, v, o, dout, l, ds, dq, dk, dv, BH, group,
                              Sq, Sk, D, Dv, scale, causal, q_offset, s);
  return launch_dims<__nv_bfloat16>(q, k, v, o, dout, l, ds, dq, dk, dv, BH,
                                    group, Sq, Sk, D, Dv, scale, causal,
                                    q_offset, s);
}
