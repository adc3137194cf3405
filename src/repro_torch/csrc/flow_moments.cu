// flow_moments — per-flow Table-I register accumulation (K4):
//   regs[slot[e], c] += deltas[e, c]   (mod 2^32) for every valid event e.
//
// Replaces: src/repro/kernels/flow_moments/kernel.py flow_moments_pallas
//   (_kernel). The TPU has no scatter, so it turned the update into a
//   one-hot (flow_tile x 256-event) MXU matmul on u16 halves of the
//   deltas, keeping every f32 partial sum below 2^24 and exact.
//
// Bound on this card: bytes — the (E, 7) u32 deltas, the (E,) int64 slots
// and the (E,) validity bytes read once, the (F, 7) registers read and
// written once (about 46 MB at E = 2^20, F = 2^17: ~14 us at 3.35 TB/s).
// The adds themselves are negligible.
//
// Design: none of the TPU's trick is needed. One thread per (event,
// register) issues one 32-bit atomicAdd into the registers, which the
// wrapper cloned from the input once, so the output is updated in place.
// Integer addition mod 2^32 is associative and commutative, so the result
// is bit for bit the same whatever order the atomics land in: the kernel
// is deterministic although the atomics are not ordered. Slots are read
// as the int64 values reporter.hash_slot produces (no narrowing pass);
// invalid events and slots outside [0, F) are skipped, as the Pallas
// kernel drops them. Deltas arrive as int32 bit patterns and are read as
// uint32_t; a zero delta (IAT terms of a flow's first packet) issues no
// atomic. Heavy flows of the Pareto-rate traffic put thousands of events
// on one slot: that contends on one address but stays exact.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegs = 7;

__global__ void flow_moments_kernel(uint32_t* __restrict__ regs,
                                    const int64_t* __restrict__ slots,
                                    const uint32_t* __restrict__ deltas,
                                    const uint8_t* __restrict__ valid,
                                    long long n, int F) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long e = i / kRegs;
  const int c = static_cast<int>(i - e * kRegs);
  if (!valid[e]) return;
  const int64_t s = slots[e];
  if (s < 0 || s >= F) return;
  const uint32_t d = deltas[i];             // deltas[e * 7 + c]
  if (d != 0u) atomicAdd(regs + s * kRegs + c, d);
}

}  // namespace

extern "C" int flow_moments(void* regs, const void* slots, const void* deltas,
                            const void* valid, int E, int F, void* stream) {
  if (E < 0 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const long long n = static_cast<long long>(E) * kRegs;
  flow_moments_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(regs), static_cast<const int64_t*>(slots),
      static_cast<const uint32_t*>(deltas),
      static_cast<const uint8_t*>(valid), n, F);
  return static_cast<int>(cudaGetLastError());
}
