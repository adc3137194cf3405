// flow_moments — per-flow Table-I register accumulation (K4):
//   regs[slot[e], c] += deltas[e, c]   (mod 2^32) for every valid event e
//   with 0 <= slot[e] < F, c = 0..6.
//
// Replaces: src/repro/kernels/flow_moments/kernel.py flow_moments_pallas
//   (_kernel). The TPU has no scatter, so it turned the update into a
//   one-hot (flow_tile x 256-event) MXU matmul on u16 halves of the
//   deltas, keeping every f32 partial sum below 2^24 and exact.
//
// Bound on this card: bytes — the (E, 7) u32 deltas, the (E,) int64 slots
// and the (E,) validity bytes read once, the (F, 7) registers read and
// written once (about 46 MB at E = 2^20, F = 2^17: ~14 us at 3.35 TB/s).
// The registers (3.7 MB) stay in L2, ~96 % of the (event, register)
// deltas are non-zero, and events arrive in time order, so the 32 events
// of a warp almost always touch 32 different slots: merging same-slot
// updates in a warp or block would remove almost nothing. Measured on the
// card: a plain store in place of each atomic was no faster than the
// atomic, a constant in place of each delta load saved a quarter, 64-bit
// atomics on pairs of registers (4 per event instead of 7) were slower
// than 32-bit ones on these rows, and a thread per event (7 atomic
// instructions per event) took ~3x the time of lanes on one event's row
// (1 instruction per event). So what costs time besides the atomics is a
// chain of dependent loads (valid, then slot, then delta) in front of each
// atomic, which this kernel does not have; why one instruction over a
// row costs less than seven over seven rows (L2 requests per 32-byte
// sector?) is a guess no profiler counter has confirmed.
//
// Design: a warp takes 4 whole events, lane l < 28 the (event l / 7,
// register l % 7) item, lanes 28-31 idle: each event's 7 atomics leave in
// one warp instruction, so no row is split between two warps' requests.
// The validity byte, the slot and the delta are loaded together, with
// streaming (evict-first) hints so the inputs that pass once do not push
// the registers out of L2, and then one 32-bit atomicAdd whose result is
// unused (RED) adds each non-zero delta. Addition mod 2^32 is associative
// and commutative, so the result is bit for bit the same whatever order
// the atomics land in. Slots are read as the int64 values
// reporter.hash_slot produces; invalid events and slots outside [0, F)
// are skipped, as the Pallas kernel drops them. The wrapper clones the
// registers once; the kernel updates the copy in place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegs = 7;
constexpr int kEventsPerWarp = 4;         // 4 x 7 = 28 lanes
constexpr int kEventsPerBlock = kThreads / 32 * kEventsPerWarp;

__device__ __forceinline__ uint8_t load_streaming(const uint8_t* p) {
  unsigned short v;
  asm volatile("ld.global.cs.u8 %0, [%1];" : "=h"(v) : "l"(p));
  return static_cast<uint8_t>(v);
}

__global__ void __launch_bounds__(kThreads)
flow_moments_kernel(uint32_t* __restrict__ regs,
                    const int64_t* __restrict__ slots,
                    const uint32_t* __restrict__ deltas,
                    const uint8_t* __restrict__ valid, int E, int F) {
  const int lane = threadIdx.x & 31;
  if (lane >= kEventsPerWarp * kRegs) return;
  const long long e = static_cast<long long>(blockIdx.x) * kEventsPerBlock +
                      (threadIdx.x >> 5) * kEventsPerWarp + lane / kRegs;
  const int c = lane % kRegs;
  if (e >= E) return;
  const uint8_t v = load_streaming(valid + e);
  const int64_t s = __ldcs(reinterpret_cast<const long long*>(slots) + e);
  const uint32_t d = __ldcs(deltas + e * kRegs + c);
  if (v && s >= 0 && s < F && d != 0u) atomicAdd(regs + s * kRegs + c, d);
}

}  // namespace

extern "C" int flow_moments(void* regs, const void* slots, const void* deltas,
                            const void* valid, int E, int F, void* stream) {
  if (E < 0 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  const long long blocks = (E + kEventsPerBlock - 1LL) / kEventsPerBlock;
  flow_moments_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(regs), static_cast<const int64_t*>(slots),
      static_cast<const uint32_t*>(deltas),
      static_cast<const uint8_t*>(valid), E, F);
  return static_cast<int>(cudaGetLastError());
}
