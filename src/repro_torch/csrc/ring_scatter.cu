// ring_scatter — verbatim 64 B payload placement into the (F, H, 16) u32
// collector ring, last write wins in report order, in place (K2).
//
// Replaces: src/repro/kernels/ring_scatter/kernel.py ring_scatter_pallas
//   (_kernel), and the jnp entry_valid update of
//   src/repro/kernels/ring_scatter/ops.py ring_scatter_collector.
//
// Bound on this card: bytes, and at the main path's R = 4096 reports the
// bytes are ~0.6 MB, well under a microsecond at 3.35 TB/s — so in
// practice the three launches (a few microseconds each) bound it.
//
// Design: the TPU gets "last write wins" from a sequential fori_loop over
// the reports. Here the rows are written in parallel, so each touched
// (flow, hist) cell first elects its winner — the highest masked row
// index — in an F*H int32 scratch:
//   pass 1 resets only the cells this batch touches (the scratch is never
//          cleared as a whole),
//   pass 2 atomicMax(row) per masked row,
//   pass 3 the winner copies its 16 words as four 16-byte stores and sets
//          entry_valid.
// Separate launches on one stream order the passes. Rows whose flow or
// hist lies outside the ring are skipped, as the TPU kernel skips them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long cell_of(const int32_t* flow,
                                             const int32_t* hist,
                                             const uint8_t* mask, int r, int F,
                                             int H) {
  if (!mask[r]) return -1;
  const int f = flow[r];
  const int h = hist[r];
  if (f < 0 || f >= F || h < 0 || h >= H) return -1;
  return static_cast<long long>(f) * H + h;
}

__global__ void reset_kernel(const int32_t* __restrict__ flow,
                             const int32_t* __restrict__ hist,
                             const uint8_t* __restrict__ mask,
                             int32_t* __restrict__ winner, int R, int F,
                             int H) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long c = cell_of(flow, hist, mask, r, F, H);
  if (c >= 0) winner[c] = -1;
}

__global__ void claim_kernel(const int32_t* __restrict__ flow,
                             const int32_t* __restrict__ hist,
                             const uint8_t* __restrict__ mask,
                             int32_t* __restrict__ winner, int R, int F,
                             int H) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long c = cell_of(flow, hist, mask, r, F, H);
  if (c >= 0) atomicMax(winner + c, r);
}

// four threads per report row, one 16-byte quarter each
__global__ void write_kernel(const uint4* __restrict__ payloads,
                             const int32_t* __restrict__ flow,
                             const int32_t* __restrict__ hist,
                             const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ winner,
                             uint4* __restrict__ memory,
                             uint8_t* __restrict__ entry_valid, int R, int F,
                             int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i >> 2;
  const int q = i & 3;
  if (r >= R) return;
  const long long c = cell_of(flow, hist, mask, r, F, H);
  if (c < 0 || winner[c] != r) return;
  memory[c * 4 + q] = payloads[static_cast<long long>(r) * 4 + q];
  if (q == 0) entry_valid[c] = 1;
}

}  // namespace

extern "C" int ring_scatter(void* memory, void* entry_valid,
                            const void* payloads, const void* flow,
                            const void* hist, const void* mask, void* winner,
                            int R, int F, int H, void* stream) {
  if (R < 0 || F < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fl = static_cast<const int32_t*>(flow);
  const auto* hi = static_cast<const int32_t*>(hist);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* win = static_cast<int32_t*>(winner);
  const int blocks = (R + kThreads - 1) / kThreads;
  reset_kernel<<<blocks, kThreads, 0, s>>>(fl, hi, mk, win, R, F, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  claim_kernel<<<blocks, kThreads, 0, s>>>(fl, hi, mk, win, R, F, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_kernel<<<(4 * R + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const uint4*>(payloads), fl, hi, mk, win,
      static_cast<uint4*>(memory), static_cast<uint8_t*>(entry_valid), R, F,
      H);
  return static_cast<int>(cudaGetLastError());
}
