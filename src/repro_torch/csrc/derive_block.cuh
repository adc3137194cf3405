// derive_block — the per-flow feature derivation shared by the fused
// gather_enrich kernel (K3) and the standalone derived_features kernel
// (K5).
//
// Port of src/repro/kernels/derived_features/kernel.py derive_block and
// src/repro/core/enrich.py entry_features: from one flow's H ring entries
// (16 u32 words each: Table-I stats in words 1-7, hist_idx in a schema
// field) and their validity bytes, write
//   [newest entry's 18 features | window mean (18) | window std (18) |
//    newest - mean (18) | nvalid | max hist_idx | zero pad]
// into the flow's (D,) output row. The newest entry is the first index of
// the largest valid packet count (jnp.argmax semantics: invalid entries
// count 0, so entry 0 wins when no valid count is above 0). The std is
// two-pass, as in the reference. All float math is IEEE f32 with no
// contraction (the build passes -fmad=false and never --use_fast_math).
//
// Bound on this card: bytes. Each entry (64 B + its validity byte) is read
// once and each output row (4D B) written once; the feature math, a few
// hundred f32 operations per entry, takes well under the byte time at
// 67 TFLOP/s, but at ~200 warp instructions per flow their time is
// the same order as the byte time on a large batch.
//
// Design: warp-cooperative, through shared memory. A warp takes P
// consecutive output rows (P flows) and works in three phases separated
// by __syncwarp:
//   A. entries: lane i derives entries i, i + 32, ... of the warp's P*H
//      (flow, entry) pairs — lanes on consecutive entries, so the loads of
//      a flow's contiguous H*64 B are coalesced, each entry is loaded once
//      (three 16-byte loads) and its 18 features are computed once. The
//      features, masked by validity as the reference masks them, go to
//      shared memory beside the validity, the selection count and
//      hist_idx;
//   B. flows: lane p < P scans flow p's H counts in order for the newest
//      entry, the valid count and the largest hist_idx;
//   C. columns: lane t < 18*P owns (flow t / 18, feature t % 18) and sums
//      that feature column over the flow's H entries in entry order (the
//      reference's order) from shared memory: window mean, then the
//      two-pass variance from the same shared copy (no entry is read from
//      device memory twice), the newest entry's value and the delta. Lanes
//      on consecutive (flow, feature) pairs write consecutive columns.
// There are no shuffles: phases meet in shared memory. A warp whose rows
// all lie past the end returns as a whole; otherwise every lane reaches
// both __syncwarp calls, and lanes with no (flow, entry) or column left
// only skip the work. P adapts to the call: up to 64 entries per warp on
// a large batch (P = 6 at H = 10: 60 entries in two rounds of phase A, 108
// columns in four rounds of phase C; more flows per warp take more shared memory
// per warp and so fewer warps per SM, and fewer leave lanes idle), and
// fewer flows per warp when the batch alone would not give the card ~16
// warps per SM (P = 2 at R = 4096). The shared copy takes 84 B per entry,
// so H is limited to kMaxHistory (one flow per warp, one warp per block).
#pragma once
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace dfa {

constexpr int kPerEntry = 18;
constexpr int kFeatures = 4 * kPerEntry + 2;  // 74
constexpr float kEps = 1e-6f;
// shared row of one entry: 18 masked features + validity as 0/1; odd, so
// lanes on consecutive entries hit distinct banks
constexpr int kRow = kPerEntry + 1;
// bytes of shared memory per (flow, entry) pair: the row, count, hist_idx
constexpr int kEntryBytes = (kRow + 2) * 4;
constexpr int kEntriesPerWarp = 64;    // phase A: 2 rounds of 32 lanes
constexpr int kWarpsPerBlock = 4;
constexpr int kTargetWarps = 2048;     // ~16 warps per SM on 132 SMs
constexpr size_t kMaxShared = 232448;  // per block, with the opt-in
constexpr int kMaxHistory =
    static_cast<int>((kMaxShared - 8) / kEntryBytes);  // 2767

struct HistField {
  int word;       // 13 (V1) or 15 (V2)
  int shift;
  uint32_t mask;
};

__device__ __forceinline__ void moments(float s1, float s2, float s3, float n,
                                        float* f) {
  const float mean = s1 / n;
  const float var = fmaxf(s2 / n - mean * mean, 0.0f);
  const float std = sqrtf(var);
  const float cov = std / fmaxf(mean, kEps);
  const float m3 = s3 / n - 3.0f * mean * var - mean * mean * mean;
  const float skew = m3 / fmaxf(std * std * std, kEps);
  f[0] = mean;
  f[1] = var;
  f[2] = std;
  f[3] = cov;
  f[4] = skew;
}

// stats: the 7 Table-I registers of one entry -> 18 features
__device__ __forceinline__ void entry_features(const uint32_t* stats,
                                               float* f) {
  const float n = fmaxf(static_cast<float>(stats[0]), 1.0f);
  const float iat1 = static_cast<float>(stats[1]);
  const float ps1 = static_cast<float>(stats[4]);
  f[0] = n;
  moments(iat1, static_cast<float>(stats[2]), static_cast<float>(stats[3]), n,
          f + 1);
  moments(ps1, static_cast<float>(stats[5]), static_cast<float>(stats[6]), n,
          f + 6);
  const float duration = fmaxf(iat1, 1.0f);
  const float volume = ps1;
  const float rate_bps = volume * 8.0f / (duration / 1e6f + kEps);
  const float pps = n / (duration / 1e6f + kEps);
  f[11] = volume;
  f[12] = rate_bps;
  f[13] = pps;
  f[14] = duration;
  f[15] = log1pf(volume);
  f[16] = log1pf(rate_bps);
  f[17] = log1pf(n);
}

// one 64 B entry (three of its four 16-byte quarters) -> stats and hist_idx
__device__ __forceinline__ void load_entry(const uint4* e, HistField hf,
                                           uint32_t* stats, uint32_t* hist) {
  const uint4 q0 = e[0];
  const uint4 q1 = e[1];
  const uint4 q3 = e[3];
  stats[0] = q0.y;
  stats[1] = q0.z;
  stats[2] = q0.w;
  stats[3] = q1.x;
  stats[4] = q1.y;
  stats[5] = q1.z;
  stats[6] = q1.w;
  const uint32_t w = (hf.word == 13) ? q3.y : q3.w;
  *hist = (w >> hf.shift) & hf.mask;
}

// How a launch is cut: P flows per warp, warps per block, shared bytes.
struct Plan {
  int flows_per_warp;
  int warps_per_block;
  int blocks;
  size_t shared;
};

__host__ __device__ inline size_t warp_shared(int P, int H) {
  return static_cast<size_t>(P) * H * kEntryBytes +
         static_cast<size_t>(P) * 8;
}

inline Plan plan(int rows, int H) {
  int P = kEntriesPerWarp / H;
  const int spread = (rows + kTargetWarps - 1) / kTargetWarps;
  if (spread < P) P = spread;
  if (P > 32) P = 32;
  if (P < 1) P = 1;
  const size_t per_warp = warp_shared(P, H);
  int W = kWarpsPerBlock;
  while (W > 1 && per_warp * W > kMaxShared) --W;
  const long long warps = (static_cast<long long>(rows) + P - 1) / P;
  return {P, W, static_cast<int>((warps + W - 1) / W), per_warp * W};
}

// Allow `kernel` the plan's dynamic shared memory; false if it cannot.
template <class Kernel>
inline bool allow_shared(Kernel kernel, size_t shared) {
  if (shared > kMaxShared) return false;
  if (shared <= 48 * 1024) return true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shared)) == cudaSuccess;
}

// The warp's P rows [row0, row0 + P) of `rows`; row r's entries are
// entries[cell0(r) .. cell0(r) + H), its validity bytes valid[the same].
// `smem` is this warp's warp_shared(P, H) bytes. Called by every lane.
template <class Cell0>
__device__ __forceinline__ void derive_rows(
    const uint4* __restrict__ entries, const uint8_t* __restrict__ valid,
    Cell0 cell0, int row0, int rows, int P, int H, HistField hf,
    float* __restrict__ out, int D, unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int n = min(P, rows - row0);     // rows of this warp (warp-uniform)
  if (n <= 0) return;
  const int ne = n * H;
  float* feats = reinterpret_cast<float*>(smem);
  uint32_t* count = reinterpret_cast<uint32_t*>(feats + P * H * kRow);
  uint32_t* hist = count + P * H;
  int* newest = reinterpret_cast<int*>(hist + P * H);
  float* nvalid = reinterpret_cast<float*>(newest + P);

  // A. one lane per (flow, entry)
  for (int e = lane; e < ne; e += 32) {
    const int p = e / H;
    const long long c = cell0(row0 + p) + (e - p * H);
    const bool v = valid[c] != 0;
    uint32_t stats[7];
    uint32_t hi;
    load_entry(entries + 4 * c, hf, stats, &hi);
    float f[kPerEntry];
    entry_features(stats, f);
    const float vm = v ? 1.0f : 0.0f;
    float* s = feats + e * kRow;
#pragma unroll
    for (int k = 0; k < kPerEntry; ++k) s[k] = f[k] * vm;  // feats * vmask
    s[kPerEntry] = vm;
    count[e] = v ? stats[0] : 0u;
    hist[e] = v ? hi : 0u;
  }
  __syncwarp();

  // B. one lane per flow: newest entry, valid count, largest hist_idx
  for (int p = lane; p < n; p += 32) {
    const int base = p * H;
    uint32_t best = count[base];
    int nw = 0;
    int nv = 0;
    float mh = 0.0f;
    for (int h = 0; h < H; ++h) {
      const uint32_t cnt = count[base + h];
      if (cnt > best) {            // unsigned; the first maximum wins
        best = cnt;
        nw = h;
      }
      if (feats[(base + h) * kRow + kPerEntry] != 0.0f) {
        ++nv;
        mh = fmaxf(mh, static_cast<float>(hist[base + h]));
      }
    }
    const float nvf = static_cast<float>(max(nv, 1));
    newest[p] = nw;
    nvalid[p] = nvf;
    float* o = out + static_cast<long long>(row0 + p) * D;
    if (4 * kPerEntry < D) o[4 * kPerEntry] = nvf;
    if (4 * kPerEntry + 1 < D) o[4 * kPerEntry + 1] = mh;
  }
  __syncwarp();

  // C. one lane per (flow, feature column)
  for (int t = lane; t < n * kPerEntry; t += 32) {
    const int p = t / kPerEntry;
    const int k = t - p * kPerEntry;
    const float* col = feats + p * H * kRow + k;
    const float* vm = feats + p * H * kRow + kPerEntry;
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += col[h * kRow];
    const float nvf = nvalid[p];
    const float mean = s / nvf;
    float q = 0.0f;
    for (int h = 0; h < H; ++h) {
      const float dv = (col[h * kRow] - mean) * vm[h * kRow];
      q += dv * dv;
    }
    const float nf = col[newest[p] * kRow];
    float* o = out + static_cast<long long>(row0 + p) * D;
    if (k < D) o[k] = nf;
    if (kPerEntry + k < D) o[kPerEntry + k] = mean;
    if (2 * kPerEntry + k < D) o[2 * kPerEntry + k] = sqrtf(q / nvf);
    if (3 * kPerEntry + k < D) o[3 * kPerEntry + k] = nf - mean;
  }

  // zero pad, lanes on consecutive columns
  for (int p = 0; p < n; ++p) {
    float* o = out + static_cast<long long>(row0 + p) * D;
    for (int c = kFeatures + lane; c < D; c += 32) o[c] = 0.0f;
  }
}

}  // namespace dfa
