// derived_features — standalone feature derivation over flow histories
// (K5): (N, H, 16) u32 entries + (N, H) validity -> (N, D) f32.
//
// Replaces: src/repro/kernels/derived_features/kernel.py
//   derived_features_pallas (_kernel). The TPU kernel tiled the flows
//   (flow_tile rows per grid step, N % flow_tile == 0) and selected the
//   newest entry with an iota one-hot, since it has no gathers.
//
// Bound on this card: bytes — N*H*64 B of entries and N*H validity bytes
// read, N*D*4 B written: ~136 MB for the whole PAPER ring (N = 2^17,
// H = 10, D = 96), ~40 us at 3.35 TB/s; 4.2 MB (~1.3 us) for the
// (4096, 10, 16) history the unfused path gathers, where the kernel is
// latency-bound.
//
// Design: the warp-cooperative dfa::derive_rows (derive_block.cuh, shared
// with the fused gather_enrich kernel) on the rows' own entries, so there
// is no index gather and no tile: any N is taken. A warp's P rows are
// contiguous, so its loads walk one contiguous P*H*64 B span. On the whole
// ring the plan gives P = 6 (60 entries per warp); on the gathered
// history P = 2. Validity is PyTorch's bool, one byte per entry. Both
// wire formats work through HistField (hist_idx in word 13 or 15).
#include <cstdint>
#include <cuda_runtime.h>

#include "derive_block.cuh"

namespace {

__global__ void derived_features_kernel(const uint4* __restrict__ entries,
                                        const uint8_t* __restrict__ valid,
                                        float* __restrict__ out, int N, int H,
                                        int D, int P, dfa::HistField hf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const long long gw =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (gw * P >= N) return;                 // whole warp, before any sync
  const auto cell0 = [=](int n) { return static_cast<long long>(n) * H; };
  dfa::derive_rows(entries, valid, cell0, static_cast<int>(gw * P), N, P, H,
                   hf, out, D, smem + warp * dfa::warp_shared(P, H));
}

}  // namespace

extern "C" int derived_features(const void* entries, const void* valid,
                                void* out, int N, int H, int D, int hist_word,
                                int hist_shift, int hist_mask, void* stream) {
  if (N < 0 || H < 1 || H > dfa::kMaxHistory || D < 1 ||
      (hist_word != 13 && hist_word != 15) ||
      reinterpret_cast<uintptr_t>(entries) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const dfa::HistField hf{hist_word, hist_shift,
                          static_cast<uint32_t>(hist_mask)};
  const dfa::Plan pl = dfa::plan(N, H);
  if (!dfa::allow_shared(derived_features_kernel, pl.shared))
    return static_cast<int>(cudaErrorInvalidValue);
  derived_features_kernel<<<pl.blocks, 32 * pl.warps_per_block, pl.shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(entries), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), N, H, D, pl.flows_per_warp, hf);
  return static_cast<int>(cudaGetLastError());
}
