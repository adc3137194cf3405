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
// (4096, 10, 16) history the unfused path gathers. The feature math is
// about a thousand f32 operations per flow.
//
// Design: one thread per flow row runs dfa::derive_block
// (derive_block.cuh, shared with the fused gather_enrich kernel) on the
// row's own H entries, so there is no index gather and no tile: any N is
// taken. Validity is PyTorch's bool, one byte per entry. Both wire
// formats work through HistField (hist_idx in word 13 or 15).
#include <cstdint>
#include <cuda_runtime.h>

#include "derive_block.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void derived_features_kernel(const uint4* __restrict__ entries,
                                        const uint8_t* __restrict__ valid,
                                        float* __restrict__ out, int N, int H,
                                        int D, dfa::HistField hf) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long cell0 = static_cast<long long>(n) * H;
  dfa::derive_block(entries + cell0 * 4, valid + cell0, H, hf,
                    out + static_cast<long long>(n) * D, D);
}

}  // namespace

extern "C" int derived_features(const void* entries, const void* valid,
                                void* out, int N, int H, int D, int hist_word,
                                int hist_shift, int hist_mask, void* stream) {
  if (N < 0 || H < 1 || D < 1 || (hist_word != 13 && hist_word != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const dfa::HistField hf{hist_word, hist_shift,
                          static_cast<uint32_t>(hist_mask)};
  derived_features_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(entries), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), N, H, D, hf);
  return static_cast<int>(cudaGetLastError());
}
