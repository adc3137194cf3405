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
// bytes. At MLA's prefill shape (BH = 512, D = 192, Dv = 128) it is 172
// GFLOP, 174 us, against 671 MB, 200 us: bytes there. Only wgmma reaches
// either.
//
// Three kernels, one C entry. The caller names the variant; the entry
// checks it against the same rule as kernels/flash_attention/kernel.py
// variant(): "pingpong" for bf16 with (D, Dv) in {(64, 64), (128, 128)}
// (granite's, whisper's; the qwen, llama4 and llava configs), "wgmma" for
// bf16 at (80, 80) (zamba2's) and (192, 128) (MLA's), "simt" for
// everything else (f32, whose 2e-5 contract TF32 tensor cores would break,
// and bf16 at other head dims). The wgmma kernel takes (64, 64) and (128,
// 128) too when the caller forces it, to be timed beside the ping-pong one.
//
// pingpong (flash_attention_pingpong_kernel): the wgmma kernel's block of
// three warpgroups, one per SM, its tiles, tensor maps, products and
// softmax arithmetic (below), rebuilt around what held it back: each
// consumer ran S = Q K^T, waited, ran its softmax, then P V and waited
// again, and nothing ordered the two consumers, so the softmax (as long as
// the products at D = 64, half as long at D = 128) stalled the tensor
// cores; and whole (head, query tile) items dealt round robin left whisper's
// 288 equal items on 132 SMs at 36 key-tile steps for the longest block
// against a mean of 26.2.
//   * Registers 24 / 240 / 240: the producer lowers its registers with
//     setmaxnreg.dec, the consumers raise theirs with setmaxnreg.inc, from
//     the 168 of __launch_bounds__(384, 1); the entry refuses a build that
//     does not start at 168 (check_regs: setmaxnreg.inc would wait forever).
//   * Turns (FA3's ping-pong): a consumer issues its products between
//     named_sync(its barrier) and named_arrive(the other's), so the two
//     alternate on the tensor cores and one's softmax runs under the
//     other's products. Inside a consumer, turn j issues S_j and
//     P_{j-1} V_{j-1}; S_j's softmax runs while P_{j-1} V_{j-1} does, its
//     p stays in the score registers in f32 until that product is done,
//     then rescales o and is packed to bf16 (o 64 + scores 64 + P 32 at
//     D = 128, no spills). A part takes nt + 1 turns (the first only S,
//     the last only P V). Issuing S_{j+1} under tile j's softmax instead
//     (a second score fragment) spilled 192 bytes at D = 128 and ran
//     18-45 % slower at both head dims; without the turns the kernel runs
//     2-7 % slower (tools/k6_variants.py).
//   * K and V in rings of their own, V loaded a tile behind K: K_j's slot
//     is freed once S_j has landed, V_j's once P_j V_j has, so the next
//     tile's K loads under this tile's work (a shared slot freed after
//     the late P V left llava's tiles waiting: 1,190 against the wgmma
//     kernel's 1,039 us, tools/attention_ab.py). The consumers wait for
//     their tiles by polling (hopper.cuh mbar_poll): the tiles have
//     nearly always landed.
//   * The output: o / l in bf16 goes to a swizzled shared tile per
//     consumer and out by one TMA store (rows past Sq clipped by the map),
//     the tile rewritten only after the store has read it; the quotient
//     is one reciprocal a row and one Markstein step an element, the
//     correctly rounded a / b of the TPU kernel's division, bit for bit
//     the wgmma kernel's output. Scattered 4-byte stores and IEEE
//     divisions had cost 1,750 cycles a part at granite's shape
//     (tools/k6_trace.py).
//   * The plan (kernel.py plan(), made on the host, cached per shape and
//     card, passed as int32: each part (bh, q0, kt0, kt1, part, parts,
//     first partial, counter), then each block's first part): whole items,
//     heaviest first, each to the block with the least work (key tiles +
//     a part's cost), which balances the causal shapes within 1 % (llava
//     481 steps against a mean of 481.0; round robin gave 496); where equal
//     items leave a tail (whisper), the whole rounds go round robin and
//     the last round is laid end to end over the blocks in pieces of at
//     least MIN_PIECE key tiles, cutting an item where a block's share
//     ends (whisper: 28 against 26.2, items in 3 parts).
//   * A cut item: each part stores its unnormalised f32 o, its m and its
//     threads' l (the registers' order, float4 per thread) to scratch,
//     then one thread counts the part in with an acq_rel atomicAdd on the
//     item's counter (zeroed by the caller each call); the block that
//     counts the last part in merges the parts in part order, each
//     rescaled once by 2^((m_i - m) scale log2 e), and finishes the item as
//     a whole one. Nothing waits on another block: a part is counted in
//     and its block goes on, so no residency or launch order matters; the
//     merge order is fixed, so runs repeat bit for bit.
//   * Barrier counts: both consumers walk the same parts and tiles, so
//     they take the same turns, meet the cut-item barrier the same times
//     and each output barrier is its own; consumer 1 arrives once more
//     than consumer 0 waits (the first turn), which consumer 0 takes at
//     the end. A consumer whose rows all lie past Sq (llava's last tile)
//     still runs its products on the zero-filled rows and stores nothing.
//
// wgmma (flash_attention_wgmma_kernel): persistent blocks of three
// warpgroups, one block per SM (its 384 threads x 168 registers fill the
// register file), each walking (bh, 128-row query tile) work items,
// heaviest query tiles first, blockIdx.x + k * gridDim.x.
//   * Warpgroup 0 is the producer: it lowers its registers with
//     setmaxnreg, and one thread issues TMA loads of each item's Q tile
//     into one of two Q buffers (one at (192, 128), where two would not
//     fit beside the rings: 209 KB with one) and of each 128-row K and V
//     tile into a 2-stage shared-memory ring, guarded by full (TMA bytes)
//     and empty (consumer release) mbarriers. Ring and Q buffers run on
//     across items, so the next item's loads overlap this one's last
//     tiles and its epilogue; with one Q buffer a consumer releases it
//     right after its last S = Q K^T, with two after the item (releasing
//     early there measured ~3 % slower at the granite serve shape with
//     tools/attention_ab.py). The consumers keep the launch allocation (168
//     registers under __launch_bounds__(384, 1), no spills); asking for
//     more with setmaxnreg.inc would hang if ptxas allocated fewer.
//   * Warpgroups 1 and 2 each own 64 query rows. S = Q K^T is
//     wgmma m64n128k16 with Q and K both read from shared memory, K-major
//     with the 128-byte swizzle (a row of 64 bf16 is exactly 128 bytes;
//     D = 128 is two such column blocks, 192 three: 12 k16 steps). The
//     tensor maps and the wgmma descriptors name the same swizzle.
//   * D = 80 (zamba2) is two column blocks too: the tensor map keeps the
//     true width, so the box at column 64 reads 16 columns and zero-fills
//     the other 48 (as it zero-fills rows past S). S = Q K^T takes 5 k16
//     steps (none over the zeros), and O += P V, N = 80, is an n64 product
//     over V's first block plus an n16 over its second (hopper.cuh's
//     wgmma_rs for 40 accumulator registers): each stays inside one
//     swizzle atom. o is 40 registers, the stores and lse cover the 80
//     real columns.
//   * The online softmax runs on the f32 accumulator fragment in
//     registers: each thread holds 2 rows x 32 scores, and a row's max is
//     reduced over the 4 threads that share it with __shfl_xor_sync.
//   * P is converted in registers into the bf16 A fragment of
//     wgmma m64nDvk16 (the accumulator's layout maps onto the A operand's
//     pairwise), and V is read from shared memory as a transposed
//     (MN-major) B operand. A consumer holds o (Dv / 2 = 64 registers at
//     Dv = 128), the scores (64) and P's fragment (32) at either D.
//   * Rounding points of the TPU kernel (kernel.py:40-60): S from bf16
//     inputs accumulated in f32, scaled in f32; masked scores -1e30; m
//     and l in f32; p = exp(s - m) in f32, l sums the unrounded p; p is
//     rounded to bf16 only as the A operand of P V; acc in f32, the
//     output acc / max(l, 1e-30) rounded to bf16. log2(e) is folded into
//     the scale: the row max is taken over the raw scores (scale > 0 keeps
//     their order) and p = 2^(s * scale * log2 e - m * scale * log2 e),
//     one fmaf and one ex2.approx.ftz (what exp2f compiles to, without
//     its denormal fix-up: a p below 2^-126 is 0).
//   * Causal: KV tiles past the query tile's last position are not
//     loaded; a warpgroup skips a tile that lies wholly above its own
//     rows' positions (it only releases it); only tiles that cross the
//     diagonal (shifted by q_offset) or the end of Sk are masked. Ragged
//     Sq and Sk: the 3-D tensor maps (D, S, BH) zero-fill rows past S,
//     keys >= Sk are masked and rows >= Sq are not stored.
//   * Tensor maps are encoded on the host per call with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ kernel parameters. The
//     entry returns -CUresult when the encoder is missing or refuses.
//   * A barrier wait that exceeds ~2^34 cycles traps instead of hanging
//     the card.
//   * Against a first version with 64-row K/V tiles, m64n64k16, expf-style
//     softmax and one block per work item, the largest gains came, in
//     order, from the fmaf + ex2 softmax, the 128-row tiles and the
//     persistent blocks. A third consumer warpgroup (192-row tiles at 128
//     registers), a deeper ring, and issuing the next tile's S before this
//     tile's P V at 168 registers gained little or lost time.
//
// simt (flash_attention_kernel): one block of 256 threads per (bh,
// 64-row query tile). The query tile and each 64-row K and V tile are
// staged in shared memory as f32 (rows padded by one word so column walks
// hit distinct banks); the scores of a tile never leave the SM. Each
// thread owns 4 query rows x 4 score columns and 4 rows x DVC output
// columns (DVC = 4, 8 or 16 for Dv up to 64, 128 or 256), so the
// online-softmax state (m, l, acc) stays in registers; a
// row's max and sum are reduced across the 16 lanes that share it with
// shuffles. p is rounded to the value type before p·v and l sums the
// unrounded p, as the TPU kernel does. It runs f32 FMAs on the CUDA
// cores (67 TFLOP/s at best), far above the bound. Under the causal mask
// key tiles past the tile's last query position are skipped, which is
// exact: their terms are exp(-1e30 - m) = 0.
// Ragged Sq and Sk are masked here, so any length is taken. Blocks run
// the heaviest query tiles first. Head dims run to 256, D != Dv (MLA's
// prefill is D = 192, Dv = 128): shared memory is (64 + 64)(D + 1) +
// 64 Dv + 64 * 65 floats, 148 KB at (192, 128) and 214 KB at (256, 256),
// under the 227 KB a block may opt into, so at those widths one block
// fits on an SM.
//
// All three: query head bh reads kv row bh / group. The causal mask keeps
// key j for query row i when j <= q_offset + i: query row i sits at
// position q_offset + i of the keys' sequence (q_offset >= 0; 0 is the
// top-left mask, and an offset >= Sk - 1 keeps every key). The offset
// moves only the positions the masks, the tile counts and the skipped
// tiles compare: each row still sees key 0, so a whole item's first tile
// holds an unmasked key and m is finite from there on (a cut item's later
// part may hold none of a row's keys: the ping-pong kernel stores that
// row's partial as 0). Given a non-null lse pointer (the training
// forward), they also store each query row's logsumexp m + log l in
// natural-log units (the tensor-core kernels' max is a raw score,
// converted by scale * log2 e * ln 2); with null they store nothing and
// run as before.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 4;        // query rows per thread: ty * 4 + i
constexpr int kCols = 4;        // score columns per thread: tx + 16 * j
constexpr int kMaxHeadDim = 256;
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

// Blocks per SM the register allocation is made for: 2 caps a thread at
// 128 registers. The DVC = 16 instance (Dv > 128) spilled under that cap
// (80 bytes of spill stores; acc alone is 64 registers), so it is built
// for 1 block: at Dv > 128 its shared memory, at least 2 x 64 x (D + 1)
// + 64 x 129 + 64 x 65 floats, leaves room for a second block only while
// D <= 134, and no config in the repo has such a head dim.
template <int DVC>
constexpr int simt_min_blocks() { return DVC > 8 ? 1 : 2; }

template <typename T, int DVC>
__global__ void __launch_bounds__(kThreads, simt_min_blocks<DVC>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int BH,
                       int group, int Sq, int Sk, int D, int Dv, float scale,
                       int causal, int qoff, int nq) {
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
  if (causal) nk = min(nk, (last_q + qoff) / kBK + 1);

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
        if (kp >= Sk || (causal && kp > qp + qoff)) x = kNegInf;
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
    if (lse != nullptr && tx == 0)
      lse[static_cast<long long>(bh) * Sq + qp] = m[i] + logf(den);
    T* o = out + (static_cast<long long>(bh) * Sq + qp) * Dv;
#pragma unroll
    for (int jj = 0; jj < DVC; ++jj) {
      const int col = tx + 16 * jj;
      if (col < Dv) o[col] = from_f32<T>(acc[i][jj] / den);
    }
  }
}

template <typename T, int DVC>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* lse, int BH, int group, int Sq, int Sk, int D, int Dv,
                float scale, int causal, int qoff, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, BH, group, Sq, Sk,
      D, Dv, scale, causal, qoff, nq);
  return static_cast<int>(cudaGetLastError());
}


// the SIMT instance whose DVC output columns per thread cover Dv
template <typename T>
int launch_simt_dv(const void* q, const void* k, const void* v, void* out,
                   float* lse, int BH, int group, int Sq, int Sk, int D,
                   int Dv, float scale, int causal, int qoff,
                   cudaStream_t stream) {
  if (Dv <= 64)
    return launch_simt<T, 4>(q, k, v, out, lse, BH, group, Sq, Sk, D, Dv,
                             scale, causal, qoff, stream);
  if (Dv <= 128)
    return launch_simt<T, 8>(q, k, v, out, lse, BH, group, Sq, Sk, D, Dv,
                             scale, causal, qoff, stream);
  return launch_simt<T, 16>(q, k, v, out, lse, BH, group, Sq, Sk, D, Dv,
                            scale, causal, qoff, stream);
}


// ---------------------------------------------------------------------------
// The tensor-core variant (bf16, (D, Dv) in {(64, 64), (80, 80), (128,
// 128), (192, 128)})

constexpr float kLn2 = 0.6931471805599453f;

// One block: kConsumers warpgroups of 64 query rows (kBQ), a kStages-deep
// ring of kWgBK-row K and V tiles, kQBufs Q buffers.
constexpr int kWgBK = 128;
constexpr int kConsumers = 2;
constexpr int kStages = 2;
constexpr int kWgThreads = 128 * (kConsumers + 1);

template <int D, int Dv>
struct WgLayout {
  static constexpr int kBQ = 64 * kConsumers;         // query rows
  static constexpr int kBlocks = (D + 63) / 64;       // 64-column blocks
  static constexpr int kVBlocks = (Dv + 63) / 64;     // of V
  static constexpr int kQBlock = kBQ * kRowBytes;     // one block of Q
  static constexpr int kKBlock = kWgBK * kRowBytes;   // one of K or V
  static constexpr int kQBytes = kQBlock * kBlocks;   // one Q buffer
  static constexpr int kKBytes = kKBlock * kBlocks;   // one stage of K
  static constexpr int kVBytes = kKBlock * kVBlocks;  // one stage of V
  static constexpr int kRings = kStages * (kKBytes + kVBytes);
  // Two Q buffers where they fit beside the rings. At (192, 128) two (96
  // KB) and the rings (160 KB) would take 256 KB, so the next item's Q
  // waits for this item's last S = Q K^T (209 KB with one).
  static constexpr int kQBufs =
      1024 + 2 * kQBytes + kRings + 8 * (4 + 3 * kStages) <= kMaxSmem ? 2
                                                                       : 1;
  // the Q buffers, the K ring, the V ring, then the mbarriers:
  // full_q[kQBufs], empty_q[kQBufs], full_k[], full_v[], empty[]; plus 1024
  // bytes to align the tiles for the 128-byte swizzle
  static constexpr int kBarOffset = kQBufs * kQBytes + kRings;
  static constexpr int kSmem =
      1024 + kBarOffset + 8 * (2 * kQBufs + 3 * kStages);
  static_assert(kSmem <= kMaxSmem, "K6's tiles exceed shared memory");
};

// The online softmax of one tile's raw scores, in registers. sc[4j + e] is
// row r0 (e < 2) or r1, key k0 + 8j + 2t + (e & 1); N = keys / 2; the
// caller passes each row's position (its index plus the query offset).
// Masks keys >= Sk and (causal) keys past the position to -1e30 when `edge`,
// updates the row max m (of the raw scores: scale > 0 keeps the order)
// and the row sum l (of the unrounded p, partial: this thread's columns),
// returns the factors c that rescale the accumulator, and rounds
// p = 2^(s * scale * log2 e - m * scale * log2 e) to bf16 into the A
// fragment: k16 step kk takes keys 16kk..16kk+15, which are the
// accumulator's n-blocks 2kk and 2kk+1, register for register.
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[N], uint32_t (&pa)[N / 8][4], float& m0, float& m1,
    float& l0, float& l1, float& c0, float& c1, bool edge, int k0, int Sk,
    int causal, int r0, int r1, int t, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        if (kp >= Sk || (causal && kp > (e < 2 ? r0 : r1)))
          sc[4 * j + e] = kNegInf;
      }
  }
  // four independent max chains
  float a0 = sc[0], b0 = sc[1], a1 = sc[2], b1 = sc[3];
#pragma unroll
  for (int j = 1; j < N / 4; ++j) {
    a0 = fmaxf(a0, sc[4 * j]);
    b0 = fmaxf(b0, sc[4 * j + 1]);
    a1 = fmaxf(a1, sc[4 * j + 2]);
    b1 = fmaxf(b1, sc[4 * j + 3]);
  }
  const float mx0 = fmaxf(m0, quad_max(fmaxf(a0, b0)));
  const float mx1 = fmaxf(m1, quad_max(fmaxf(a1, b1)));
  c0 = ex2((m0 - mx0) * scale_log2);
  c1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  // m is finite from the first tile on: every row's first tile holds key
  // 0, which no mask hides
  const float n0 = -mx0 * scale_log2, n1 = -mx1 * scale_log2;
  float s0a = 0.f, s0b = 0.f, s1a = 0.f, s1b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float p0 = ex2(fmaf(sc[4 * j], scale_log2, n0));
    const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, n0));
    const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, n1));
    const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, n1));
    s0a += p0;
    s0b += p1;
    s1a += p2;
    s1b += p3;
    pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * c0 + (s0a + s0b);
  l1 = l1 * c1 + (s1a + s1b);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float c0, float c1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= c0;
    o[4 * j + 1] *= c0;
    o[4 * j + 2] *= c1;
    o[4 * j + 3] *= c1;
  }
}

template <int D, int Dv>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int BH,
                             int group, int Sq, int Sk, float scale_log2,
                             int causal, int qoff, int nq) {
  using L = WgLayout<D, Dv>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sq =                               // [kQBufs][kQBytes]
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sk = sq + L::kQBufs * L::kQBytes;  // [kStages][kKBytes]
  uint8_t* const sv = sk + kStages * L::kKBytes;    // [kStages][kVBytes]
  uint64_t* const full_q = reinterpret_cast<uint64_t*>(sq + L::kBarOffset);
  uint64_t* const empty_q = full_q + L::kQBufs;
  uint64_t* const full_k = empty_q + L::kQBufs;
  uint64_t* const full_v = full_k + kStages;
  uint64_t* const empty = full_v + kStages;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < L::kQBufs; ++b) {
      mbar_init(full_q + b, 1);
      mbar_init(empty_q + b, 4 * kConsumers);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4 * kConsumers);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work items are (bh, query tile) pairs, heaviest query tiles first; the
  // block takes items blockIdx.x, + gridDim.x, ... The K/V ring and the Q
  // buffers run on across items, so the next item's loads overlap this
  // one's last tiles and its epilogue.
  const int n_items = nq * BH;
  auto item_q0 = [&](int item) {
    return (nq - 1 - item / BH) * L::kBQ;
  };
  auto item_tiles = [&](int q0) {
    const int nk = (Sk + kWgBK - 1) / kWgBK;
    return causal ? min(nk, (min(q0 + L::kBQ, Sq) - 1 + qoff) / kWgBK + 1)
                  : nk;
  };

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                       // ring tiles issued so far
      int n = 0;                        // items taken so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const int bh = item % BH, q0 = item_q0(item), kvh = bh / group;
        const int nk = item_tiles(q0);
        const int qb = n % L::kQBufs;
        // the buffer's previous item released (passes at once at first)
        mbar_wait(empty_q + qb, ((n / L::kQBufs) & 1) ^ 1);
        mbar_expect_tx(full_q + qb, L::kQBytes);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b)
          tma_load(sq + qb * L::kQBytes + b * L::kQBlock, &tq, full_q + qb,
                   64 * b, q0, bh);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full_k + s, L::kKBytes);
#pragma unroll
          for (int b = 0; b < L::kBlocks; ++b)
            tma_load(sk + s * L::kKBytes + b * L::kKBlock, &tk, full_k + s,
                     64 * b, kt * kWgBK, kvh);
          mbar_expect_tx(full_v + s, L::kVBytes);
#pragma unroll
          for (int b = 0; b < L::kVBlocks; ++b)
            tma_load(sv + s * L::kVBytes + b * L::kKBlock, &tv, full_v + s,
                     64 * b, kt * kWgBK, kvh);
        }
      }
    }
    return;
  }

  // consumer warpgroups: cw owns query rows q0 + 64*cw .. + 63 of an item
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint64_t dq = make_desc(sq + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dk = make_desc(sk, 16, 1024);
  const uint64_t dv = make_desc(sv, L::kKBlock, 1024);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int it = 0;                           // ring tiles consumed so far
  int n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const int bh = item % BH, q0 = item_q0(item);
    const int nk = item_tiles(q0);
    const int qb = n % L::kQBufs;
    const int row_a = q0 + 64 * cw;
    const int r0 = row_a + 16 * warp + g, r1 = r0 + 8;  // this thread's rows
    // tiles past nk_wg lie wholly above this warpgroup's rows (causal):
    // exp(-1e30 - m) = 0 for all their keys, so they are only released
    const int nk_wg = causal ? min(nk, (row_a + 63 + qoff) / kWgBK + 1) : nk;
    const uint64_t dqb = dq + ((qb * L::kQBytes) >> 4);

    float o[Dv / 2], sc[kWgBK / 2];
#pragma unroll
    for (int i = 0; i < Dv / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) sc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, c0, c1;
    uint32_t pa[kWgBK / 16][4];

    mbar_wait(full_q + qb, (n / L::kQBufs) & 1);
    for (int kt = 0; kt < nk_wg; ++kt) {
      const int s = (it + kt) % kStages;
      const uint32_t ph = ((it + kt) / kStages) & 1;
      const int k0 = kt * kWgBK;
      mbar_wait(full_k + s, ph);

      // S = Q K^T: D/16 steps of k16; a step advances 32 bytes inside a
      // 128-byte swizzled row, or moves to the next 64-column block
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        const uint32_t oq = (kk / 4) * L::kQBlock + in_row;
        const uint32_t ok = s * L::kKBytes + (kk / 4) * L::kKBlock + in_row;
        wgmma_ss_m64n128(sc, dqb + (oq >> 4), dk + (ok >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      // one Q buffer: the item's last S has read it, so the next item's Q
      // may load under this item's last P V and epilogue
      if constexpr (L::kQBufs == 1) {
        if (kt == nk_wg - 1) release(empty_q + qb);
      }

      const bool edge =
          k0 + kWgBK > Sk || (causal && k0 + kWgBK - 1 > row_a + qoff);
      softmax_tile(sc, pa, m0, m1, l0, l1, c0, c1, edge, k0, Sk, causal,
                   r0 + qoff, r1 + qoff, t, scale_log2);
      rescale(o, c0, c1);

      // O += P V: V is the MN-major B operand; a k16 step is 16 key rows
      mbar_wait(full_v + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_rs(o, pa[kk],
                 dv + ((s * L::kVBytes + kk * 16 * kRowBytes) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      keep(o);
      keep(pa);
      release(empty + s);
    }
    if constexpr (L::kQBufs == 2) release(empty_q + qb);
    for (int kt = nk_wg; kt < nk; ++kt) {
      mbar_wait(full_k + (it + kt) % kStages, ((it + kt) / kStages) & 1);
      release(empty + (it + kt) % kStages);
    }
    it += nk;

    // each thread summed its own columns of a row
    const float den0 = fmaxf(quad_sum(l0), 1e-30f);
    const float den1 = fmaxf(quad_sum(l1), 1e-30f);
    if (lse != nullptr && t == 0) {
      // m is the raw score max: m * scale = m * scale_log2 * ln 2
      float* const lb = lse + static_cast<long long>(bh) * Sq;
      if (r0 < Sq) lb[r0] = m0 * scale_log2 * kLn2 + logf(den0);
      if (r1 < Sq) lb[r1] = m1 * scale_log2 * kLn2 + logf(den1);
    }
    __nv_bfloat16* const ob = out + static_cast<long long>(bh) * Sq * Dv;
#pragma unroll
    for (int j = 0; j < Dv / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<long long>(r0) * Dv + col) =
            __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<long long>(r1) * Dv + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
  }
}

// ---------------------------------------------------------------------------
// The ping-pong variant (bf16, (D, Dv) in {(64, 64), (128, 128)}): the
// wgmma kernel's block, layout and products, its consumers at 240
// registers taking turns on the tensor cores, each tile's softmax under
// the previous tile's P V, and a work plan made on the host.

constexpr int kPartFields = 8;  // int32 per part of a plan (kernel.py
                                // PART_FIELDS)
constexpr int kTurnBar = 1;     // named barriers 1 + cw: consumer cw's turn
constexpr int kEpiBar = 3;      // both consumers: a cut item's epilogue
constexpr int kOutBar = 4;      // 4 + cw: consumer cw's output tile
constexpr int kConsumerThreads = 128 * kConsumers;

// one part's partial: the consumers' unnormalised o (Dv / 8 float4 per
// thread, in the registers' order) and each thread's (m0, m1, l0, l1)
// (kernel.py partial_numel)
template <int Dv>
constexpr int kPartialFloats = 128 * Dv + kConsumerThreads * 4;

// One ping-pong block: WgLayout's tiles, with K and V in rings of their
// own (V is freed a turn after K), Q buffers (three at D = 64, so the next
// part's Q loads while this part's first tiles do; two at D = 128, where
// a third measured ~2 % slower, tools/k6_variants.py, and the output
// tiles take its room) and
// each consumer's output tile. 129 KB at D = 64, 225 KB at D = 128.
template <int D, int Dv>
struct PpLayout {
  using W = WgLayout<D, Dv>;
  static constexpr int kQBufs = D == 64 ? 3 : 2;
  static constexpr int kKStages = 2;
  static constexpr int kVStages = 2;
  // the Q buffers, the K ring, the V ring, the output tiles (each
  // consumer's 64 rows in bf16: 64-column blocks of 64 128-byte rows,
  // swizzled as the output's tensor map), then the mbarriers full_q[],
  // empty_q[], full_k[], empty_k[], full_v[], empty_v[] and the int that
  // broadcasts a cut item's ticket; plus 1024 bytes of alignment
  static constexpr int kKRing = kQBufs * W::kQBytes;
  static constexpr int kVRing = kKRing + kKStages * W::kKBytes;
  static constexpr int kOBlock = 64 * kRowBytes;
  static constexpr int kORing = kVRing + kVStages * W::kVBytes;
  static constexpr int kBarOffset =
      kORing + kConsumers * W::kVBlocks * kOBlock;
  static constexpr int kSmem =
      1024 + kBarOffset + 8 * (2 * kQBufs + 2 * kKStages + 2 * kVStages) +
      16;
  static_assert(kSmem <= kMaxSmem,
                "K6's ping-pong tiles exceed shared memory");
};

struct Part {
  int bh, q0, kt0, kt1, part, nparts, first, counter;
};

__device__ __forceinline__ Part load_part(const int* plan, int i) {
  const int4* const p = reinterpret_cast<const int4*>(plan) + 2 * i;
  const int4 a = __ldg(p), b = __ldg(p + 1);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}
// the fields the producer needs: (bh, q0, kt0, kt1)
__device__ __forceinline__ int4 load_tiles(const int* plan, int i) {
  return __ldg(reinterpret_cast<const int4*>(plan) + 2 * i);
}

// softmax_tile without the packing: p stays in sc in f32, since the A
// fragment still feeds the previous tile's P V; pack_p rounds it after
template <int N>
__device__ __forceinline__ void softmax_exp(
    float (&sc)[N], float& m0, float& m1, float& l0, float& l1, float& c0,
    float& c1, bool edge, int k0, int Sk, int causal, int r0, int r1, int t,
    float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        if (kp >= Sk || (causal && kp > (e < 2 ? r0 : r1)))
          sc[4 * j + e] = kNegInf;
      }
  }
  float a0 = sc[0], b0 = sc[1], a1 = sc[2], b1 = sc[3];
#pragma unroll
  for (int j = 1; j < N / 4; ++j) {
    a0 = fmaxf(a0, sc[4 * j]);
    b0 = fmaxf(b0, sc[4 * j + 1]);
    a1 = fmaxf(a1, sc[4 * j + 2]);
    b1 = fmaxf(b1, sc[4 * j + 3]);
  }
  const float mx0 = fmaxf(m0, quad_max(fmaxf(a0, b0)));
  const float mx1 = fmaxf(m1, quad_max(fmaxf(a1, b1)));
  c0 = ex2((m0 - mx0) * scale_log2);
  c1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float n0 = -mx0 * scale_log2, n1 = -mx1 * scale_log2;
  float s0a = 0.f, s0b = 0.f, s1a = 0.f, s1b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, n0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, n0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, n1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, n1));
    s0a += sc[4 * j];
    s0b += sc[4 * j + 1];
    s1a += sc[4 * j + 2];
    s1b += sc[4 * j + 3];
  }
  l0 = l0 * c0 + (s0a + s0b);
  l1 = l1 * c1 + (s1a + s1b);
}

// add one to the int at `p` (device memory) and return what it held:
// acq_rel at GPU scope, so the adder's earlier stores (and those its block
// ordered before it) are visible to whoever reads the count after, and
// the stores of those who added before are visible to it
__device__ __forceinline__ int count_in(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(reinterpret_cast<uint64_t>(p))
               : "memory");
  return old;
}

// a / b rounded to nearest, from y = 1 / b rounded to nearest (b > 0):
// q = a y, then one step with the exact remainder a - b q (Markstein), the
// correctly rounded quotient wherever a / b is a normal float or 0: the
// division of the TPU kernel's finish at one reciprocal a row
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int D, int Dv>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_pingpong_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap to,
                                float* __restrict__ lse,
                                const int* __restrict__ plan, int n_parts,
                                float* __restrict__ partials,
                                int* __restrict__ counters, int group,
                                int Sq, int Sk, float scale_log2,
                                int causal, int qoff) {
  using L = WgLayout<D, Dv>;
  using P = PpLayout<D, Dv>;
  constexpr int QB = P::kQBufs, KS = P::kKStages, VS = P::kVStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sq =                               // [QB][kQBytes]
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sk = sq + P::kKRing;               // [KS][kKBytes]
  uint8_t* const sv = sq + P::kVRing;               // [VS][kVBytes]
  uint64_t* const full_q = reinterpret_cast<uint64_t*>(sq + P::kBarOffset);
  uint64_t* const empty_q = full_q + QB;
  uint64_t* const full_k = empty_q + QB;
  uint64_t* const empty_k = full_k + KS;
  uint64_t* const full_v = empty_k + KS;
  uint64_t* const empty_v = full_v + VS;
  volatile int* const ticket = reinterpret_cast<int*>(empty_v + VS);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      mbar_init(full_q + b, 1);
      mbar_init(empty_q + b, 4 * kConsumers);
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(empty_k + s, 4 * kConsumers);
    }
#pragma unroll
    for (int s = 0; s < VS; ++s) {
      mbar_init(full_v + s, 1);
      mbar_init(empty_v + s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's parts: plan[p_begin .. p_end), in order
  const int* const offsets = plan + kPartFields * n_parts;
  const int p_begin = offsets[blockIdx.x], p_end = offsets[blockIdx.x + 1];
  if (p_begin >= p_end) return;         // no part (the planner makes none)

  if (threadIdx.x < 128) {
    // producer warpgroup: 24 registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // ring tile t: K slot t % KS, V slot t % VS
      auto load_k = [&](int t, int kt, int kvh) {
        const int s = t % KS;
        mbar_wait(empty_k + s, ((t / KS) & 1) ^ 1);
        mbar_expect_tx(full_k + s, L::kKBytes);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b)
          tma_load(sk + s * L::kKBytes + b * L::kKBlock, &tk, full_k + s,
                   64 * b, kt * kWgBK, kvh);
      };
      auto load_v = [&](int t, int kt, int kvh) {
        const int s = t % VS;
        mbar_wait(empty_v + s, ((t / VS) & 1) ^ 1);
        mbar_expect_tx(full_v + s, L::kVBytes);
#pragma unroll
        for (int b = 0; b < L::kVBlocks; ++b)
          tma_load(sv + s * L::kVBytes + b * L::kKBlock, &tv, full_v + s,
                   64 * b, kt * kWgBK, kvh);
      };
      // the block's n-th part's Q into buffer n % QB
      auto load_q = [&](int n, int4 w) {  // (bh, q0, kt0, kt1)
        const int qb = n % QB;
        mbar_wait(empty_q + qb, ((n / QB) & 1) ^ 1);
        mbar_expect_tx(full_q + qb, L::kQBytes);
#pragma unroll
        for (int b = 0; b < L::kBlocks; ++b)
          tma_load(sq + qb * L::kQBytes + b * L::kQBlock, &tq, full_q + qb,
                   64 * b, w.y, w.x);
      };
      int it = 0;                       // ring tiles issued so far
      int4 w = load_tiles(plan, p_begin);
      load_q(0, w);
      for (int i = p_begin, n = 0; i < p_end; ++i, ++n) {
        const bool more = i + 1 < p_end;
        const int4 next = more ? load_tiles(plan, i + 1) : w;
        const int kvh = w.x / group, nt = w.w - w.z;
        // in the order the consumers' turns take them: K_j beside V_{j-1};
        // the next part's Q right after this part's first K
        load_k(it, w.z, kvh);
        if (more) load_q(n + 1, next);
        for (int j = 1; j < nt; ++j) {
          load_k(it + j, w.z + j, kvh);
          load_v(it + j - 1, w.z + j - 1, kvh);
        }
        load_v(it + nt - 1, w.w - 1, kvh);
        it += nt;
        w = next;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroups: cw owns query rows q0 + 64 cw .. + 63 of a part
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint64_t dq = make_desc(sq + cw * 64 * kRowBytes, 16, 1024);
  const uint64_t dk = make_desc(sk, 16, 1024);
  const uint64_t dv = make_desc(sv, L::kKBlock, 1024);
  uint8_t* const so = sq + P::kORing + cw * L::kVBlocks * P::kOBlock;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Turns: consumer cw issues its products between named_sync(its own
  // barrier) and named_arrive(the other's), so the two alternate on the
  // tensor cores; consumer 0 takes the first turn. Both walk the same
  // parts and the same tiles, so they take the same number of turns.
  const int my_turn = kTurnBar + cw, other_turn = kTurnBar + 1 - cw;
  if (cw == 1) named_arrive(kTurnBar, kConsumerThreads);

  float o[Dv / 2], sc[kWgBK / 2];
  uint32_t pa[kWgBK / 16][4];
  float m0, m1, l0, l1, c0, c1;
  int it = 0;                           // ring tiles consumed so far
  Part w = load_part(plan, p_begin), next = w;
  for (int i = p_begin, n = 0; i < p_end; ++i, ++n, w = next) {
    if (i + 1 < p_end) next = load_part(plan, i + 1);  // ahead of its use
    const int qb = n % QB;
    const int row_a = w.q0 + 64 * cw;
    const int r0 = row_a + 16 * warp + g, r1 = r0 + 8;  // this thread's rows
    const int nt = w.kt1 - w.kt0;
    const uint64_t dqb = dq + ((qb * L::kQBytes) >> 4);
    auto issue_s = [&](int j) {         // S_j = Q K_j^T, into sc
      const int s = (it + j) % KS;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        const uint32_t oq = (kk / 4) * L::kQBlock + in_row;
        const uint32_t ok = s * L::kKBytes + (kk / 4) * L::kKBlock + in_row;
        wgmma_ss_m64n128(sc, dqb + (oq >> 4), dk + (ok >> 4), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {        // O += P_j V_j, P_j from pa
      const int s = (it + j) % VS;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_rs(o, pa[kk],
                 dv + ((s * L::kVBytes + kk * 16 * kRowBytes) >> 4));
      wgmma_commit();
    };
    auto wait_k = [&](int j) {
      mbar_poll(full_k + (it + j) % KS, ((it + j) / KS) & 1);
    };
    auto wait_v = [&](int j) {
      mbar_poll(full_v + (it + j) % VS, ((it + j) / VS) & 1);
    };
    auto softmax = [&](int j) {
      const int k0 = (w.kt0 + j) * kWgBK;
      const bool edge =
          k0 + kWgBK > Sk || (causal && k0 + kWgBK - 1 > row_a + qoff);
      softmax_exp(sc, m0, m1, l0, l1, c0, c1, edge, k0, Sk, causal,
                  r0 + qoff, r1 + qoff, t, scale_log2);
    };

#pragma unroll
    for (int x = 0; x < Dv / 2; ++x) o[x] = 0.f;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
    mbar_wait(full_q + qb, (n / QB) & 1);

    // turn 0: S_0 alone
    wait_k(0);
    named_sync(my_turn, kConsumerThreads);
    wgmma_fence();
    issue_s(0);
    named_arrive(other_turn, kConsumerThreads);
    wgmma_wait<0>();
    keep(sc);
    release(empty_k + it % KS);
    if (nt == 1) release(empty_q + qb);  // the part's last S has read Q
    softmax(0);                         // o is 0: nothing to rescale
    pack_p(sc, pa);
    // turn j: S_j and P_{j-1} V_{j-1}; tile j's softmax runs while
    // P_{j-1} V_{j-1} does, and the other consumer's products after both
    for (int j = 1; j < nt; ++j) {
      wait_k(j);
      wait_v(j - 1);
      named_sync(my_turn, kConsumerThreads);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      named_arrive(other_turn, kConsumerThreads);
      wgmma_wait<1>();                  // S_j (committed first) is done
      keep(sc);
      release(empty_k + (it + j) % KS);
      if (j == nt - 1) release(empty_q + qb);
      softmax(j);
      wgmma_wait<0>();
      keep(o);
      keep(pa);
      release(empty_v + (it + j - 1) % VS);
      rescale(o, c0, c1);
      pack_p(sc, pa);
    }
    // the last turn: P V of the last tile
    wait_v(nt - 1);
    named_sync(my_turn, kConsumerThreads);
    wgmma_fence();
    issue_pv(nt - 1);
    named_arrive(other_turn, kConsumerThreads);
    wgmma_wait<0>();
    keep(o);
    keep(pa);
    release(empty_v + (it + nt - 1) % VS);
    it += nt;

    if (w.nparts > 1) {
      // a cut item: store this part's partial (f32 o, m, and this
      // thread's columns' l), then count the part in; the block that
      // counts the last part in merges all of them in part order
      float* const pp =
          partials + static_cast<long long>(w.first + w.part) *
                         kPartialFloats<Dv>;
      float4* const po =
          reinterpret_cast<float4*>(pp) + cw * (Dv / 8) * 128 + tid;
      // a row that keeps no key of this part (with a query offset,
      // consumer 0's rows can end before the part's tiles) kept m = -1e30,
      // and its p = 2^(fmaf(-1e30, sl, 1e30 sl rounded)) may be inf: it
      // adds nothing to the item, so its o and l are stored as 0
      const bool none0 = m0 == kNegInf, none1 = m1 == kNegInf;
      if (none0) l0 = 0.f;
      if (none1) l1 = 0.f;
#pragma unroll
      for (int x = 0; x < Dv / 8; ++x)
        __stcg(po + x * 128,
               make_float4(none0 ? 0.f : o[4 * x], none0 ? 0.f : o[4 * x + 1],
                           none1 ? 0.f : o[4 * x + 2],
                           none1 ? 0.f : o[4 * x + 3]));
      __stcg(reinterpret_cast<float4*>(pp + 128 * Dv) + cw * 128 + tid,
             make_float4(m0, m1, l0, l1));
      // one thread counts the part in for both consumers: its acq_rel
      // add releases their stores (ordered before it by the barrier) and,
      // for the last part, acquires the other parts' stores, which the
      // second barrier orders before every thread's loads below
      named_sync(kEpiBar, kConsumerThreads);
      if (cw == 0 && tid == 0) *ticket = count_in(counters + w.counter);
      named_sync(kEpiBar, kConsumerThreads);
      if (*ticket != w.nparts - 1) continue;
      const float* const first =
          partials + static_cast<long long>(w.first) * kPartialFloats<Dv>;
      auto ml_of = [&](int p) {
        return __ldcg(reinterpret_cast<const float4*>(
                          first + static_cast<long long>(p) *
                                      kPartialFloats<Dv> + 128 * Dv) +
                      cw * 128 + tid);
      };
      float mm0 = kNegInf, mm1 = kNegInf;
#pragma unroll 4
      for (int p = 0; p < w.nparts; ++p) {
        const float4 ml = ml_of(p);
        mm0 = fmaxf(mm0, ml.x);
        mm1 = fmaxf(mm1, ml.y);
      }
#pragma unroll
      for (int x = 0; x < Dv / 2; ++x) o[x] = 0.f;
      l0 = l1 = 0.f;
#pragma unroll 2
      for (int p = 0; p < w.nparts; ++p) {
        const float4 ml = ml_of(p);
        const float e0 = ex2((ml.x - mm0) * scale_log2);
        const float e1 = ex2((ml.y - mm1) * scale_log2);
        l0 += ml.z * e0;
        l1 += ml.w * e1;
        const float4* const src =
            reinterpret_cast<const float4*>(
                first + static_cast<long long>(p) * kPartialFloats<Dv>) +
            cw * (Dv / 8) * 128 + tid;
#pragma unroll
        for (int x = 0; x < Dv / 8; ++x) {
          const float4 y = __ldcg(src + x * 128);
          o[4 * x] += y.x * e0;
          o[4 * x + 1] += y.y * e0;
          o[4 * x + 2] += y.z * e1;
          o[4 * x + 3] += y.w * e1;
        }
      }
      m0 = mm0;
      m1 = mm1;
    }

    // each thread summed its own columns of a row
    const float den0 = fmaxf(quad_sum(l0), 1e-30f);
    const float den1 = fmaxf(quad_sum(l1), 1e-30f);
    if (lse != nullptr && t == 0) {
      float* const lb = lse + static_cast<long long>(w.bh) * Sq;
      if (r0 < Sq) lb[r0] = m0 * scale_log2 * kLn2 + logf(den0);
      if (r1 < Sq) lb[r1] = m1 * scale_log2 * kLn2 + logf(den1);
    }
    const float y0 = __frcp_rn(den0), y1 = __frcp_rn(den1);
    // o / den in bf16 into this consumer's output tile, then one TMA store
    // of its rows (the map clips rows past Sq); the tile is rewritten only
    // after the last store has read it
    if (tid == 0) bulk_wait_read();
    named_sync(kOutBar + cw, 128);
    const int rl = 16 * warp + g;       // r0's row in the tile; r1 is rl + 8
#pragma unroll
    for (int x = 0; x < Dv / 8; ++x) {
      uint8_t* const blk = so + (x / 8) * P::kOBlock + 4 * t;
      *reinterpret_cast<uint32_t*>(blk + rl * kRowBytes +
                                   (((x % 8) ^ (rl % 8)) << 4)) =
          pack_bf16(div_rn(o[4 * x], den0, y0),
                    div_rn(o[4 * x + 1], den0, y0));
      *reinterpret_cast<uint32_t*>(blk + (rl + 8) * kRowBytes +
                                   (((x % 8) ^ (rl % 8)) << 4)) =
          pack_bf16(div_rn(o[4 * x + 2], den1, y1),
                    div_rn(o[4 * x + 3], den1, y1));
    }
    fence_async_smem();
    named_sync(kOutBar + cw, 128);
    if (tid == 0 && row_a < Sq) {
#pragma unroll
      for (int b = 0; b < L::kVBlocks; ++b)
        tma_store(&to, so + b * P::kOBlock, 64 * b, row_a, w.bh);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();            // the tile is read before exit
  // consumer 1 arrived once more than consumer 0 waited (the first turn)
  if (cw == 0) named_sync(kTurnBar, kConsumerThreads);
}

// SMs of the current device, looked up once
cudaError_t num_sms(int* n) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *n = cached;
  return cudaSuccess;
}

template <int D, int Dv>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int BH, int group, int Sq, int Sk, float scale,
                 int causal, int qoff, cudaStream_t stream) {
  using L = WgLayout<D, Dv>;
  EncodeTiled enc;
  const int rc = get_encoder(&enc);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(enc, &tq, q, BH, Sq, D, L::kBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &tk, k, BH / group, Sk, D, kWgBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &tv, v, BH / group, Sk, Dv, kWgBK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const int nq = (Sq + L::kBQ - 1) / L::kBQ;
  int sms = 0;
  cudaError_t e = num_sms(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = flash_attention_wgmma_kernel<D, Dv>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one block per SM (registers allow no more), each walking its items
  kernel<<<min(nq * BH, sms), kWgThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, BH, group, Sq, Sk,
      scale * kLog2e, causal, qoff, nq);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int Dv>
int launch_pingpong(const void* q, const void* k, const void* v, void* out,
                    float* lse, const int* plan, int n_parts, int n_blocks,
                    float* partials, int* counters, int BH, int group, int Sq,
                    int Sk, float scale, int causal, int qoff,
                    cudaStream_t stream) {
  using L = WgLayout<D, Dv>;
  EncodeTiled enc;
  const int rc = get_encoder(&enc);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv, to;
  CUresult r = encode(enc, &tq, q, BH, Sq, D, L::kBQ);
  if (r == CUDA_SUCCESS) r = encode(enc, &tk, k, BH / group, Sk, D, kWgBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &tv, v, BH / group, Sk, Dv, kWgBK);
  if (r == CUDA_SUCCESS) r = encode(enc, &to, out, BH, Sq, Dv, 64);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static int regs = -1;
  constexpr int smem = PpLayout<D, Dv>::kSmem;
  auto kernel = flash_attention_pingpong_kernel<D, Dv>;
  cudaError_t e = check_regs(kernel, &regs);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one block per SM at most (registers allow no more), each walking the
  // plan's parts for it
  kernel<<<n_blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, to, lse, plan, n_parts,
      partials, counters, group, Sq, Sk, scale * kLog2e, causal, qoff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_offset: the position of query row 0 (0 <= q_offset <= Sk; any offset
// >= Sk - 1 keeps every key): under the causal mask row i keeps keys j <=
// q_offset + i, keys counting from 0, as the reference's chunked_attention.
// lse: null, or a (BH, Sq) f32 buffer that receives each query row's
// logsumexp of the scaled scores (natural log, m + log l), which the
// backward (flash_attention_bwd.cu) recomputes p from.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). variant: 0 =
// simt (any dtype and head dims up to 256), 1 = wgmma (bf16 with (D, Dv)
// in {(64, 64), (80, 80), (128, 128), (192, 128)} only), 2 = pingpong
// (bf16 with (D, Dv) in {(64, 64), (128, 128)} only): the rule of
// kernel.py variant(), which names the variant. pingpong only: plan, the
// n_parts parts (kPartFields int32 each) of n_blocks blocks and the
// blocks' n_blocks + 1 offsets (kernel.py plan_array); partials and
// counters, the cut items' scratch (kPartialFloats<Dv> f32 per part)
// and their counters, zeroed (both null when the plan cuts no item).
// Returns 0, a cudaError_t (cudaErrorInvalidKernelImage when the
// pingpong kernel was not built with the 168 registers its setmaxnreg
// regrouping needs), or -CUresult when a tensor map cannot be made.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse_ptr, int BH, int group,
                               int Sq, int Sk, int D, int Dv, float scale,
                               int causal, int q_offset, int dtype,
                               int variant, const void* plan, int n_parts,
                               int n_blocks,
                               void* partials, void* counters,
                               void* stream) {
  if (BH < 1 || group < 1 || BH % group || Sq < 1 || Sk < 1 || D < 1 ||
      D > kMaxHeadDim || Dv < 1 || Dv > kMaxHeadDim || q_offset < 0 ||
      q_offset > Sk || (dtype != 0 && dtype != 1) ||
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * BH > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  float* const lse = static_cast<float*>(lse_ptr);
  // the rule of kernel.py variant() (tests/test_torch_flash.py reads it)
  const bool tensor_cores =
      dtype == 1 && ((D == 64 && Dv == 64) || (D == 80 && Dv == 80) ||
                     (D == 128 && Dv == 128) || (D == 192 && Dv == 128));
  const bool pingpong =
      dtype == 1 && ((D == 64 && Dv == 64) || (D == 128 && Dv == 128));
  if (variant == 2) {
    if (!pingpong || plan == nullptr || n_blocks < 1 || n_parts < n_blocks)
      return static_cast<int>(cudaErrorInvalidValue);
    const int* const p = static_cast<const int*>(plan);
    float* const part = static_cast<float*>(partials);
    int* const cnt = static_cast<int*>(counters);
    if (D == 64)
      return launch_pingpong<64, 64>(q, k, v, out, lse, p, n_parts,
                                     n_blocks, part, cnt, BH, group, Sq, Sk,
                                     scale, causal, q_offset, s);
    return launch_pingpong<128, 128>(q, k, v, out, lse, p, n_parts,
                                     n_blocks, part, cnt, BH, group, Sq, Sk,
                                     scale, causal, q_offset, s);
  }
  if (variant == 1) {
    if (!tensor_cores) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64)
      return launch_wgmma<64, 64>(q, k, v, out, lse, BH, group, Sq, Sk,
                                  scale, causal, q_offset, s);
    if (D == 80)
      return launch_wgmma<80, 80>(q, k, v, out, lse, BH, group, Sq, Sk,
                                  scale, causal, q_offset, s);
    if (D == 128)
      return launch_wgmma<128, 128>(q, k, v, out, lse, BH, group, Sq, Sk,
                                    scale, causal, q_offset, s);
    return launch_wgmma<192, 128>(q, k, v, out, lse, BH, group, Sq, Sk,
                                  scale, causal, q_offset, s);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0
             ? launch_simt_dv<float>(q, k, v, out, lse, BH, group, Sq, Sk, D,
                                     Dv, scale, causal, q_offset, s)
             : launch_simt_dv<__nv_bfloat16>(q, k, v, out, lse, BH, group, Sq,
                                             Sk, D, Dv, scale, causal,
                                             q_offset, s);
}

