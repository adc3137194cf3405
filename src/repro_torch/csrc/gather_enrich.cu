// gather_enrich — fused history gather + feature derivation (K3).
//
// Replaces: src/repro/kernels/gather_enrich/kernel.py gather_enrich_pallas
//   (_full_kernel) and gather_enrich_hbm_pallas (_hbm_kernel). The TPU
//   split the ring into a VMEM-resident and an HBM-resident variant; the
//   card reads the ring from device memory in both cases, so one kernel
//   serves both.
//
// For each routed flow (id clamped to [0, F)) it reads the flow's H
// 64-byte ring entries with 16-byte loads and the H validity bytes, and
// runs dfa::derive_block (derive_block.cuh) into one (D,) f32 output row.
// The (R, H, 16) gather never exists in device memory.
//
// Bound on this card: bytes — R*H*64 B of ring rows and R*H validity
// bytes read, R*D*4 B written (about 4.3 MB at R = 4096, H = 10,
// D = 96); the feature math is a few thousand f32 ops per flow.
//
// Design: one thread per routed flow, 32 threads per block so R = 4096
// spreads over 128 blocks. Each thread streams its flow's entries twice
// (window mean, then the two-pass variance; the second read hits cache)
// plus once more for the newest entry, holding 18-wide accumulators in
// registers.
#include <cstdint>
#include <cuda_runtime.h>

#include "derive_block.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void gather_enrich_kernel(const uint4* __restrict__ memory,
                                     const uint8_t* __restrict__ entry_valid,
                                     const int32_t* __restrict__ local_flow,
                                     float* __restrict__ out, int R, int F,
                                     int H, int D, dfa::HistField hf) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int f = min(max(local_flow[r], 0), F - 1);
  const long long cell0 = static_cast<long long>(f) * H;
  dfa::derive_block(memory + cell0 * 4, entry_valid + cell0, H, hf,
                    out + static_cast<long long>(r) * D, D);
}

}  // namespace

extern "C" int gather_enrich(const void* memory, const void* entry_valid,
                             const void* local_flow, void* out, int R, int F,
                             int H, int D, int hist_word, int hist_shift,
                             int hist_mask, void* stream) {
  if (R < 0 || F < 1 || H < 1 || D < 1 ||
      (hist_word != 13 && hist_word != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const dfa::HistField hf{hist_word, hist_shift,
                          static_cast<uint32_t>(hist_mask)};
  gather_enrich_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(memory),
      static_cast<const uint8_t*>(entry_valid),
      static_cast<const int32_t*>(local_flow), static_cast<float*>(out), R, F,
      H, D, hf);
  return static_cast<int>(cudaGetLastError());
}
