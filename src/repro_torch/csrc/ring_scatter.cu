// ring_scatter — verbatim 64 B payload placement into the (F, H, 16) u32
// collector ring, last write wins in report order, in place (K2).
//
// Replaces: src/repro/kernels/ring_scatter/kernel.py ring_scatter_pallas
//   (_kernel), and the jnp entry_valid update of
//   src/repro/kernels/ring_scatter/ops.py ring_scatter_collector.
//
// Bound on this card: bytes — each row's 64 B payload, int64 flow and
// hist and mask byte read once, each winning cell's 64 B entry and
// validity byte written once: ~0.6 MB at the main path's R = 4096, well
// under a microsecond at 3.35 TB/s. At that size one launch's own device
// time is the floor, so the design is one launch with no global scratch.
// What sets its time above that floor is that every block reads every
// row's coordinates (17 B a row); kBlocks, kThreads and kMaxRound come
// from a sweep on the card at R = 4096 (fewer blocks place more cells
// each, more blocks read the coordinates more often).
//
// Design: the TPU gets "last write wins" from a sequential fori_loop over
// the reports. Here kBlocks blocks split the cells between them: block b
// owns the cells whose multiplicative hash maps to b, so no two blocks
// ever write one cell and neighbouring flows spread over all blocks.
// Every block walks all rows in ascending order, in rounds of up to
// kMaxRound rows; in each round it
//   1. loads the round's coordinates (all loads in flight at once) and,
//      while they arrive, clears a shared open-addressing table of 2x the
//      round's rows, each entry a {cell, row} pair (so it is at most half
//      full, whatever the input),
//   2. inserts the masked, in-ring rows it owns: atomicCAS on the key
//      (a new key also appends its table slot to a shared list), then
//      atomicMax on the row,
//   3. after a barrier, copies each listed cell's winning row — the
//      highest row index — as four 16-byte stores over four lanes, and
//      sets its entry_valid byte,
//   4. waits at a barrier before the next round clears the table.
// A later round writes after an earlier one inside the one block that
// owns the cell, which keeps last-write-wins across rounds with no reset
// pass and no F*H scratch. Coordinates are read as the int64 values the
// collector hands over; rows whose flow or hist lies outside the ring are
// skipped, as the TPU kernel skips them. The wrapper refuses rings with
// F*H >= 2^31 (cells are int32 keys) and unaligned payloads or ring
// (16-byte accesses).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 96;       // cell partitions, one block each
constexpr int kThreads = 1024;
constexpr int kMaxRound = 4096;   // rows per round (a power of two)
constexpr int kBatch = kMaxRound / kThreads;   // rows per thread per round
constexpr int kEmpty = -1;

// rows per round for a batch of R rows: the power of two >= R, capped
inline int round_rows(int R) {
  int c = 1;
  while (c < R && c < kMaxRound) c <<= 1;
  return c;
}

// shared memory of one block: the table's {cell, row} pairs (2 per round
// row), the list of occupied slots (1 per round row), the list's length
inline size_t shared_bytes(int cap) {
  return static_cast<size_t>(cap) * (2 * sizeof(int2) + sizeof(int)) +
         sizeof(int4);
}

__device__ __forceinline__ int owner(uint32_t cell, int G) {
  return static_cast<int>(__umulhi(cell * 0x9E3779B1u, G));
}

__global__ void __launch_bounds__(kThreads)
ring_scatter_kernel(const uint4* __restrict__ payloads,
                    const int64_t* __restrict__ flow,
                    const int64_t* __restrict__ hist,
                    const uint8_t* __restrict__ mask,
                    uint4* __restrict__ memory,
                    uint8_t* __restrict__ entry_valid, int R, int F, int H,
                    int cap) {
  extern __shared__ int4 smem[];
  const int size = 2 * cap;                 // table entries, a power of two
  const int bits = 31 - __clz(size);
  int2* table = reinterpret_cast<int2*>(smem);    // {cell, row}
  int* list = reinterpret_cast<int*>(table + size);
  int* count = list + cap;
  const int me = blockIdx.x;
  const int G = gridDim.x;
  for (int base = 0; base < R; base += cap) {
    const int end = R - base < cap ? R : base + cap;
    // the round's coordinates: every load is issued before any is used
    // (a branch on a loaded value between them would serialise the
    // round trips), and the table is cleared while they are in flight
    uint8_t m[kBatch];
    int64_t f[kBatch], h[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = base + k * kThreads + threadIdx.x;
      m[k] = 0;
      f[k] = h[k] = -1;
      if (r < end) {
        m[k] = mask[r];
        f[k] = flow[r];
        h[k] = hist[r];
      }
    }
    for (int i = threadIdx.x; i < cap; i += kThreads)
      smem[i] = make_int4(kEmpty, -1, kEmpty, -1);
    if (threadIdx.x == 0) *count = 0;
    // the cells this block places; -1 for the others
    int cell[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      cell[k] = kEmpty;
      if (m[k] && f[k] >= 0 && f[k] < F && h[k] >= 0 && h[k] < H) {
        const int c = static_cast<int>(f[k] * H + h[k]);
        if (owner(static_cast<uint32_t>(c), G) == me) cell[k] = c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (cell[k] == kEmpty) continue;
      const int r = base + k * kThreads + threadIdx.x;
      uint32_t slot = (static_cast<uint32_t>(cell[k]) * 0x85EBCA6Bu) >>
                      (32 - bits);
      while (true) {
        const int prev = atomicCAS(&table[slot].x, kEmpty, cell[k]);
        if (prev == kEmpty) list[atomicAdd(count, 1)] = static_cast<int>(slot);
        if (prev == kEmpty || prev == cell[k]) {
          atomicMax(&table[slot].y, r);
          break;
        }
        slot = (slot + 1) & (size - 1);
      }
    }
    __syncthreads();
    const int n = *count;
    for (int i = threadIdx.x; i < 4 * n; i += kThreads) {
      const int2 e = table[list[i >> 2]];
      const int q = i & 3;
      memory[static_cast<long long>(e.x) * 4 + q] =
          payloads[static_cast<long long>(e.y) * 4 + q];
      if (q == 0) entry_valid[e.x] = 1;
    }
    __syncthreads();                        // before the next round's clear
  }
}

__global__ void empty_kernel() {}

// dynamic shared memory above the 48 KB default needs an opt-in, made on
// every call: it holds for the current card only
cudaError_t allow_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int ring_scatter(void* memory, void* entry_valid,
                            const void* payloads, const void* flow,
                            const void* hist, const void* mask, int R, int F,
                            int H, void* stream) {
  if (R == 0) return 0;
  const int cap = round_rows(R);
  const cudaError_t attr = allow_shared(
      reinterpret_cast<const void*>(ring_scatter_kernel), shared_bytes(cap));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ring_scatter_kernel<<<kBlocks, kThreads, shared_bytes(cap),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(payloads), static_cast<const int64_t*>(flow),
      static_cast<const int64_t*>(hist), static_cast<const uint8_t*>(mask),
      static_cast<uint4*>(memory), static_cast<uint8_t*>(entry_valid), R, F,
      H, cap);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched with ring_scatter's grid, block and shared
// memory for R rows: the device time of one such launch is the floor
// under ring_scatter's own.
extern "C" int ring_scatter_floor(int R, void* stream) {
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = shared_bytes(round_rows(R));
  const cudaError_t attr =
      allow_shared(reinterpret_cast<const void*>(empty_kernel), bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  empty_kernel<<<kBlocks, kThreads, bytes,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The most rows one round takes (kMaxRound): a batch of more rows is
// placed over several rounds.
extern "C" int ring_scatter_round_rows() { return kMaxRound; }
