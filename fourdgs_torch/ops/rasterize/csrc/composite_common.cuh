// Shared per-pair arithmetic of the tile compositor's forward and backward
// kernels (composite_fwd.cu, composite_bwd.cu).
//
// Both kernels are compiled with -fmad=false and evaluate every expression
// in the order the plain torch versions in compositor.py write it (same pair
// order, no contracted multiply-adds, IEEE division), so they repeat their
// plain versions' arithmetic operation for operation, and a pair is valid in
// the backward exactly when it was valid in the forward.
#pragma once

#include <cuda_runtime.h>

namespace fourdgs {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per block: one pixel each
constexpr int NF = 10;              // fields per Gaussian row
constexpr int NOUT = 5;             // per-pixel outputs: r, g, b, depth, T_final
constexpr int BATCH = NPIX;         // pairs staged in shared memory at once
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// field order of a Gaussian row: geometry first, then appearance
enum { F_MX, F_MY, F_CA, F_CB, F_CC, F_DEPTH, F_OP, F_R, F_G, F_B };

// power = -1/2 (ca dx^2 + cc dy^2) - cb dx dy, alpha = min(0.99, op e^power).
// Returns whether the pair is valid at this pixel: power <= 0 and
// alpha >= 1/255 (written so that a NaN fails both tests, as in torch).
__device__ __forceinline__ bool pair_alpha(const float* f, float px, float py,
                                           float& dx, float& dy, float& raw,
                                           float& alpha) {
  dx = f[F_MX] - px;
  dy = f[F_MY] - py;
  const float power =
      -0.5f * (f[F_CA] * dx * dx + f[F_CC] * dy * dy) - f[F_CB] * dx * dy;
  raw = f[F_OP] * expf(power);
  alpha = raw > ALPHA_MAX ? ALPHA_MAX : raw;
  return power <= 0.0f && alpha >= ALPHA_MIN;
}

// 1 / max(1 - alpha, 1e-6): turns T after a pair into T before it
__device__ __forceinline__ float inv_one_minus(float alpha) {
  return 1.0f / fmaxf(1.0f - alpha, 1e-6f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

}  // namespace fourdgs
