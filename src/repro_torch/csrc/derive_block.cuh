// derive_block — the per-flow feature derivation shared by the fused
// gather_enrich kernel and the later standalone derived_features kernel.
//
// Port of src/repro/kernels/derived_features/kernel.py derive_block and
// src/repro/core/enrich.py entry_features: from one flow's H ring entries
// (16 u32 words each: Table-I stats in words 1-7, hist_idx in a schema
// field) and their validity bytes, write
//   [newest entry's 18 features | window mean (18) | window std (18) |
//    newest - mean (18) | nvalid | max hist_idx | zero pad]
// into out[0, D). The newest entry is the first index of the largest
// valid packet count (jnp.argmax semantics). The std is two-pass, as in
// the reference. All float math is IEEE f32 with no contraction (the
// build passes -fmad=false and never --use_fast_math).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace dfa {

constexpr int kPerEntry = 18;
constexpr int kFeatures = 4 * kPerEntry + 2;  // 74
constexpr float kEps = 1e-6f;

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

// one 64 B entry (four 16-byte loads) -> stats words and hist_idx
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

// entries: H rows of 4 uint4; valid: H bytes; out: D floats
__device__ inline void derive_block(const uint4* __restrict__ entries,
                                    const uint8_t* __restrict__ valid, int H,
                                    HistField hf, float* __restrict__ out,
                                    int D) {
  float mean[kPerEntry];
  float f[kPerEntry];
  uint32_t stats[7];
  uint32_t hist;
#pragma unroll
  for (int k = 0; k < kPerEntry; ++k) mean[k] = 0.0f;
  int nv = 0;
  int newest = 0;
  uint32_t best = 0u;
  float maxhist = 0.0f;
  for (int h = 0; h < H; ++h) {
    const bool v = valid[h] != 0;
    load_entry(entries + 4 * h, hf, stats, &hist);
    const uint32_t cnt = v ? stats[0] : 0u;
    if (h == 0 || cnt > best) {
      best = cnt;
      newest = h;
    }
    if (!v) continue;
    ++nv;
    maxhist = fmaxf(maxhist, static_cast<float>(hist));
    entry_features(stats, f);
#pragma unroll
    for (int k = 0; k < kPerEntry; ++k) mean[k] += f[k];
  }
  const float nvalid = static_cast<float>(max(nv, 1));
#pragma unroll
  for (int k = 0; k < kPerEntry; ++k) mean[k] = mean[k] / nvalid;

  float var[kPerEntry];
#pragma unroll
  for (int k = 0; k < kPerEntry; ++k) var[k] = 0.0f;
  for (int h = 0; h < H; ++h) {
    if (valid[h] == 0) continue;
    load_entry(entries + 4 * h, hf, stats, &hist);
    entry_features(stats, f);
#pragma unroll
    for (int k = 0; k < kPerEntry; ++k) {
      const float dv = f[k] - mean[k];
      var[k] += dv * dv;
    }
  }

  if (valid[newest] != 0) {
    load_entry(entries + 4 * newest, hf, stats, &hist);
    entry_features(stats, f);
  } else {
#pragma unroll
    for (int k = 0; k < kPerEntry; ++k) f[k] = 0.0f;
  }
  float row[kFeatures];
#pragma unroll
  for (int k = 0; k < kPerEntry; ++k) {
    row[k] = f[k];
    row[kPerEntry + k] = mean[k];
    row[2 * kPerEntry + k] = sqrtf(var[k] / nvalid);
    row[3 * kPerEntry + k] = f[k] - mean[k];
  }
  row[4 * kPerEntry] = nvalid;
  row[4 * kPerEntry + 1] = maxhist;
#pragma unroll
  for (int c = 0; c < kFeatures; ++c)
    if (c < D) out[c] = row[c];
  for (int c = kFeatures; c < D; ++c) out[c] = 0.0f;
}

}  // namespace dfa
