// ingest_segment_sums — per-tile run-prefix sums of the seven Table-I
// deltas over the slot-sorted event stream (reporter ingest, K1).
//
// Replaces: src/repro/kernels/ingest_update/kernel.py
//   segment_sums_pallas (_block_kernel -> _tile_sums) and
//   segment_sums_hbm_pallas (_hbm_kernel). The TPU needed two variants
//   only because of its VMEM budget; on Hopper one kernel serves both.
//
// Contract (the TPU kernels' own): inputs are the sorted stream of
// stream_prep — slot (i32, F = sentinel), ts, ps, base_ts (u32), first
// (i32) — padded to a multiple of `tile`, plus the log*/exp* LUTs. Row r
// of the (Ep, 8) u32 output holds the sum, mod 2^32, of its slot run's
// deltas from the run's first row inside r's tile through r; column 7 is
// zero. The caller scatter-adds the rows at run tails and tile cuts.
//
// Bound on this card: memory. Per event it reads 20 B and writes 32 B;
// the log*/exp* arithmetic is a few dozen integer ops per event, far
// below the H100's integer rate.
//
// Design: one block per event tile (tile <= 256 threads, so tile cuts
// match the TPU kernels bit for bit). Each thread forms its event's seven
// deltas inline (__clz for the log* exponent, the reference's
// round-on-downshift and saturation), then the block runs a segmented
// inclusive Hillis-Steele scan in uint32_t, keyed on slot equality:
// native u32 wraparound makes it exact, so the TPU's u16-half matmul
// trick is not needed. The LUTs (2^bits entries each) sit in shared
// memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 16;          // Q16 fixed-point log values
constexpr int kRegPad = 8;      // output row: 7 deltas + a zero column
constexpr int kMaxTile = 256;

__device__ __forceinline__ uint32_t log2_star(uint32_t x, int bits,
                                              const uint32_t* lut) {
  if (x == 0u) return 0u;
  const int nbits = 32 - __clz(static_cast<int>(x));
  const uint32_t e = static_cast<uint32_t>(nbits - 1);
  const int shift = max(nbits - 1 - bits, 0);
  const uint32_t fmask = (1u << bits) - 1u;
  uint32_t frac = (x >> shift) & fmask;
  const int up = max(bits - (nbits - 1), 0);
  frac = (frac << up) & fmask;
  return (e << kQ) + lut[frac];
}

__device__ __forceinline__ uint32_t exp2_star(uint32_t l, int bits,
                                              const uint32_t* lut) {
  if (l == 0u) return 1u;
  const int e = static_cast<int>(l >> kQ);
  if (e >= 32) return 0xFFFFFFFFu;
  const uint32_t frac = (l >> (kQ - bits)) & ((1u << bits) - 1u);
  const uint32_t mant = (1u << bits) + lut[frac];
  const int sh = min(max(e - bits, -(bits + 32)), 31);
  if (sh >= 0) return mant << sh;              // u32 shift truncates
  const int down = min(max(-sh, 1), 31);
  return (mant + (1u << (down - 1))) >> down;  // round on the down-shift
}

__device__ __forceinline__ uint32_t approx_pow(uint32_t x, uint32_t n,
                                               int bits,
                                               const uint32_t* log_lut,
                                               const uint32_t* exp_lut) {
  if (x == 0u) return 0u;
  const uint32_t ln = log2_star(x, bits, log_lut) * n;
  if ((ln >> kQ) >= 32u) return 0xFFFFFFFFu;
  return exp2_star(ln, bits, exp_lut);
}

__global__ void segment_sums_kernel(const int32_t* __restrict__ slot,
                                    const uint32_t* __restrict__ ts,
                                    const uint32_t* __restrict__ ps,
                                    const uint32_t* __restrict__ base,
                                    const int32_t* __restrict__ first,
                                    const uint32_t* __restrict__ log_lut_g,
                                    const uint32_t* __restrict__ exp_lut_g,
                                    uint32_t* __restrict__ out, int bits) {
  extern __shared__ uint32_t smem[];
  const int tile = blockDim.x;
  const int n_lut = 1 << bits;
  uint32_t* log_lut = smem;
  uint32_t* exp_lut = smem + n_lut;
  uint32_t* acc = exp_lut + n_lut;                  // [7][tile]
  int32_t* slots = reinterpret_cast<int32_t*>(acc + 7 * tile);
  for (int i = threadIdx.x; i < n_lut; i += tile) {
    log_lut[i] = log_lut_g[i];
    exp_lut[i] = exp_lut_g[i];
  }
  const int t = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * tile + t;
  const int32_t s = slot[row];
  const uint32_t p = ps[row];
  const uint32_t iat = first[row] ? 0u : ts[row] - base[row];
  slots[t] = s;
  __syncthreads();                                  // LUTs + slots ready

  uint32_t d[7];
  d[0] = 1u;
  d[1] = iat;
  d[2] = approx_pow(iat, 2u, bits, log_lut, exp_lut);
  d[3] = approx_pow(iat, 3u, bits, log_lut, exp_lut);
  d[4] = p;
  d[5] = approx_pow(p, 2u, bits, log_lut, exp_lut);
  d[6] = approx_pow(p, 3u, bits, log_lut, exp_lut);

  // Segmented inclusive scan: after the step with offset `off`, d holds
  // the sum over (t - 2*off, t] restricted to t's run. Slots are sorted,
  // so equal slots at t - off and t mean the whole range between is one
  // run.
  for (int off = 1; off < tile; off <<= 1) {
#pragma unroll
    for (int c = 0; c < 7; ++c) acc[c * tile + t] = d[c];
    __syncthreads();
    if (t >= off && slots[t - off] == s) {
#pragma unroll
      for (int c = 0; c < 7; ++c) d[c] += acc[c * tile + t - off];
    }
    __syncthreads();
  }
  uint4* o = reinterpret_cast<uint4*>(out + row * kRegPad);
  o[0] = make_uint4(d[0], d[1], d[2], d[3]);
  o[1] = make_uint4(d[4], d[5], d[6], 0u);
}

}  // namespace

extern "C" int ingest_segment_sums(const void* slot, const void* ts,
                                   const void* ps, const void* base,
                                   const void* first, const void* log_lut,
                                   const void* exp_lut, void* out,
                                   int n_rows, int tile, int bits,
                                   void* stream) {
  // bits <= 12 keeps both LUTs plus the scan within 48 KB of shared memory
  if (tile < 1 || tile > kMaxTile || n_rows % tile != 0 || bits < 1 ||
      bits > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const size_t smem =
      (2 * (static_cast<size_t>(1) << bits) + 8 * static_cast<size_t>(tile)) *
      sizeof(uint32_t);
  segment_sums_kernel<<<n_rows / tile, tile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot), static_cast<const uint32_t*>(ts),
      static_cast<const uint32_t*>(ps), static_cast<const uint32_t*>(base),
      static_cast<const int32_t*>(first),
      static_cast<const uint32_t*>(log_lut),
      static_cast<const uint32_t*>(exp_lut), static_cast<uint32_t*>(out),
      bits);
  return static_cast<int>(cudaGetLastError());
}
