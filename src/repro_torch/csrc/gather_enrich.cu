// gather_enrich — fused history gather + feature derivation (K3).
//
// Replaces: src/repro/kernels/gather_enrich/kernel.py gather_enrich_pallas
//   (_full_kernel) and gather_enrich_hbm_pallas (_hbm_kernel). The TPU
//   split the ring into a VMEM-resident and an HBM-resident variant; the
//   card reads the ring from device memory in both cases, so one kernel
//   serves both.
//
// For each routed flow r (id local_flow[r] clamped to [0, F)) it reads
// the flow's H 64-byte ring entries and H validity bytes and writes one
// (D,) f32 output row through dfa::derive_rows (derive_block.cuh). The
// (R, H, 16) gather never exists in device memory.
//
// Bound on this card: bytes — R*H*64 B of ring rows and R*H validity
// bytes read, R*D*4 B written (about 4.3 MB, 1.26 us at 3.35 TB/s, at
// R = 4096, H = 10, D = 96). At that size the kernel is latency-bound:
// the bytes are too few to fill the card.
//
// Design: warp-cooperative (derive_block.cuh): a warp takes P routed
// flows, one lane per (flow, entry) for the loads and the 18 entry
// features, one lane per (flow, feature column) for the window sums out
// of shared memory. At R = 4096 the plan gives P = 2: 2048 warps on 132
// SMs (the thread-per-flow design it replaces had 128 one-warp blocks).
#include <cstdint>
#include <cuda_runtime.h>

#include "derive_block.cuh"

namespace {

__global__ void gather_enrich_kernel(const uint4* __restrict__ memory,
                                     const uint8_t* __restrict__ entry_valid,
                                     const int32_t* __restrict__ local_flow,
                                     float* __restrict__ out, int R, int F,
                                     int H, int D, int P, dfa::HistField hf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const long long gw =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (gw * P >= R) return;                 // whole warp, before any sync
  const auto cell0 = [=](int r) {
    return static_cast<long long>(min(max(local_flow[r], 0), F - 1)) * H;
  };
  dfa::derive_rows(memory, entry_valid, cell0, static_cast<int>(gw * P), R, P,
                   H, hf, out, D, smem + warp * dfa::warp_shared(P, H));
}

}  // namespace

extern "C" int gather_enrich(const void* memory, const void* entry_valid,
                             const void* local_flow, void* out, int R, int F,
                             int H, int D, int hist_word, int hist_shift,
                             int hist_mask, void* stream) {
  if (R < 0 || F < 1 || H < 1 || H > dfa::kMaxHistory || D < 1 ||
      (hist_word != 13 && hist_word != 15) ||
      reinterpret_cast<uintptr_t>(memory) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const dfa::HistField hf{hist_word, hist_shift,
                          static_cast<uint32_t>(hist_mask)};
  const dfa::Plan pl = dfa::plan(R, H);
  if (!dfa::allow_shared(gather_enrich_kernel, pl.shared))
    return static_cast<int>(cudaErrorInvalidValue);
  gather_enrich_kernel<<<pl.blocks, 32 * pl.warps_per_block, pl.shared,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(memory),
      static_cast<const uint8_t*>(entry_valid),
      static_cast<const int32_t*>(local_flow), static_cast<float*>(out), R, F,
      H, D, pl.flows_per_warp, hf);
  return static_cast<int>(cudaGetLastError());
}
