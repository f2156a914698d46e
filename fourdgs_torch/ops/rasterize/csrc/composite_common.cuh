// Shared per-pair arithmetic of the tile compositor's forward and backward
// kernels (composite_fwd.cu, composite_bwd.cu).
//
// Both kernels are compiled with -fmad=false and evaluate every expression
// in the order the plain torch versions in compositor.py write it (same pair
// order, no contracted multiply-adds, IEEE division), so they repeat their
// plain versions' arithmetic operation for operation, and a pair is valid in
// the backward exactly when it was valid in the forward. Only the
// backward's gradient arithmetic, after that decision, fuses explicitly.
//
// Both kernels give each warp an 8x4 block of the 16x16 tile. When a pair
// is staged, its conservative extent (pair_extent) becomes a bit mask of
// the warps whose block it meets (warp_mask), and each warp walks only the
// pairs with its bit set, found 32 at a time with a ballot: the skipped
// (pixel, pair) combinations are all invalid, so no output changes.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace fourdgs {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per block: one pixel each
constexpr int NF = 10;              // fields per Gaussian row
constexpr int NOUT = 5;             // per-pixel outputs: r, g, b, depth, T_final
constexpr int BATCH = NPIX;         // pairs staged in shared memory at once
constexpr int WARP_W = 8;           // each warp's pixel block: 8 wide, 4 high
constexpr int WARP_H = 4;
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

// ---- the cull ----------------------------------------------------------
//
// A pixel is valid only where op e^power >= 1/255, i.e. where
// q = ca dx^2 + 2 cb dx dy + cc dy^2 <= tau = 2 ln(op / (1/255)). That
// ellipse lies in the box |dx| <= sqrt(tau cc / det), |dy| <= sqrt(tau ca
// / det), det = ca cc - cb^2. pair_extent computes the box in float32 once
// per staged pair, with margins that make it conservative:
//   * pair_alpha's float32 power has a rounding error of at most about
//     14 u cond of q/2 (u = 2^-24, cond = ca cc / det, the conic's
//     condition number), so tau is divided by shrink = 1 - EXTENT_COND
//     cond (EXTENT_COND = 64 u), and a pair with shrink < 1/2 is not culled;
//   * det is taken EXTENT_DET ca cc below its float32 value, which bounds
//     the rounding of ca cc - cb^2 (and so cond from above);
//   * EXTENT_LOG in log space covers expf's, logf's and the products'
//     rounding, the half-widths grow by EXTENT_REL and one pixel, and the
//     bounds round outward.
// No cull (the whole plane) where a field is not finite or the conic is not
// positive definite; an empty box where op < 1/255, since then
// op e^power < 1/255 for every power <= 0. compositor.pair_extent is the
// same computation in torch, and tests/test_torch_cull.py holds it against
// the validity test on adversarial conics.
constexpr float EXTENT_COND = 64.0f / 16777216.0f;
constexpr float EXTENT_DET = 8.0f / 16777216.0f;
constexpr float EXTENT_LOG = 1e-5f;
constexpr float EXTENT_REL = 1e-5f;

// (x_lo, x_hi, y_lo, y_hi) in pixel coordinates; valid pixels lie inside
__device__ __forceinline__ float4 pair_extent(const float* f) {
  const float mx = f[F_MX], my = f[F_MY], ca = f[F_CA], cb = f[F_CB];
  const float cc = f[F_CC], op = f[F_OP];
  const float4 all = make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F);
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc) &&
        isfinite(op)))
    return all;
  if (op * (1.0f + EXTENT_REL) < ALPHA_MIN)
    return make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
  if (!(ca > 0.0f && cc > 0.0f)) return all;
  const float cacc = ca * cc;
  const float det = (cacc - cb * cb) - EXTENT_DET * cacc;
  if (!(det > 0.0f)) return all;
  const float shrink = 1.0f - EXTENT_COND * (cacc / det);
  if (!(shrink >= 0.5f)) return all;
  const float tau = 2.0f * (fmaxf(logf(op / ALPHA_MIN), 0.0f) + EXTENT_LOG) / shrink;
  const float hx = sqrtf(tau * cc / det) * (1.0f + EXTENT_REL) + 1.0f;
  const float hy = sqrtf(tau * ca / det) * (1.0f + EXTENT_REL) + 1.0f;
  return make_float4(__fsub_rd(mx, hx), __fadd_ru(mx, hx), __fsub_rd(my, hy),
                     __fadd_ru(my, hy));
}

constexpr int NWARP = NPIX / 32;

// Bit w set where extent `box` meets warp w's 8x4 pixel block of the tile
// whose first pixel is (tile_x0, tile_y0). Warp w covers tile columns
// (w & 1) * 8 .. + 7 and rows (w >> 1) * 4 .. + 3.
__device__ __forceinline__ unsigned warp_mask(float4 box, float tile_x0, float tile_y0) {
  unsigned cols = 0, rows = 0;
#pragma unroll
  for (int c = 0; c < TILE / WARP_W; ++c) {
    const float x0 = tile_x0 + c * WARP_W;
    cols |= (box.y >= x0 && box.x <= x0 + (WARP_W - 1)) ? 1u << c : 0u;
  }
#pragma unroll
  for (int r = 0; r < TILE / WARP_H; ++r) {
    const float y0 = tile_y0 + r * WARP_H;
    rows |= (box.w >= y0 && box.z <= y0 + (WARP_H - 1)) ? 1u << r : 0u;
  }
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) m |= ((cols >> (w & 1)) & (rows >> (w >> 1)) & 1u) << w;
  return m;
}

// thread tid's pixel within the tile: its warp's 8x4 block, row-major lanes
__device__ __forceinline__ void warp_pixel(int tid, int& lx, int& ly) {
  const int w = tid >> 5, lane = tid & 31;
  lx = (w & 1) * WARP_W + (lane & (WARP_W - 1));
  ly = (w >> 1) * WARP_H + lane / WARP_W;
}

// ---- staging -------------------------------------------------------------

// A field row in shared memory, padded to 12 floats so that a pixel reads it
// with three 16-byte broadcast loads: (mx, my, ca, cb), (cc, depth, op, r),
// (g, b, -, -).
struct Row {
  float4 a, b, c;
};

// Loads Gaussian row `src` (40 bytes, 8-byte aligned) into a Row.
__device__ __forceinline__ Row load_row(const float* __restrict__ src) {
  const float2* s = reinterpret_cast<const float2*>(src);
  const float2 p0 = s[0], p1 = s[1], p2 = s[2], p3 = s[3], p4 = s[4];
  return {make_float4(p0.x, p0.y, p1.x, p1.y), make_float4(p2.x, p2.y, p3.x, p3.y),
          make_float4(p4.x, p4.y, 0.0f, 0.0f)};
}

// Unpacks a Row into the field order (constant indices: stays in registers).
__device__ __forceinline__ void unpack_row(const Row& r, float (&f)[NF]) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  f[8] = r.c.x; f[9] = r.c.y;
}

// ---- the backward's per-pair reduction ---------------------------------
//
// Sums ten values over the warp as a reduce-scatter: at each halving step a
// lane sends the half of its partial sums that its partner keeps and keeps
// the other half, so the ten sums take 5 + 3 + 2 + 1 + 1 = 12 shuffles
// instead of ten 5-shuffle butterflies. Returns the total of field
// scatter_field(lane); every lane of the group that holds a field's total
// returns it, and scatter_owner(lane) picks one lane per field.
__device__ __forceinline__ float warp_sum10_scatter(const float (&v)[NF], int lane) {
  // 10 -> 5 over lane ^ 16: lanes 0-15 keep fields 0-4, lanes 16-31 fields 5-9
  const bool h16 = lane & 16;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float keep = h16 ? v[i + 5] : v[i];
    const float send = h16 ? v[i] : v[i + 5];
    a[i] = keep + __shfl_xor_sync(FULL_MASK, send, 16);
  }
  // 5 -> 3 or 2 over lane ^ 8: bit 3 clear keeps a[0..2], set keeps a[3..4]
  const bool h8 = lane & 8;
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = i < 2 ? a[i + 3] : 0.0f;
    const float keep = h8 ? hi : a[i];
    const float send = h8 ? a[i] : hi;
    b[i] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
  }
  // 3 -> 2 + 1 (bit 3 clear) or 2 -> 1 + 1 (bit 3 set) over lane ^ 4
  const bool h4 = lane & 4;
  const float other = h8 ? b[1] : b[2];
  const float c0 = (h4 ? other : b[0]) + __shfl_xor_sync(FULL_MASK, h4 ? b[0] : other, 4);
  const float c1 = b[1] + __shfl_xor_sync(FULL_MASK, b[1], 4);  // used where two are held
  // 2 -> 1 + 1 over lane ^ 2 where two are held (bits 3 and 2 clear), else a sum
  const bool two = !h8 && !h4;
  const bool h2 = lane & 2;
  const float keep = (two && h2) ? c1 : c0;
  const float send = (two && !h2) ? c1 : c0;
  float d = keep + __shfl_xor_sync(FULL_MASK, send, 2);
  d += __shfl_xor_sync(FULL_MASK, d, 1);
  return d;
}

// the field whose total warp_sum10_scatter leaves in `lane`: lanes 0-1 field
// 0, 2-3 field 1, 4-7 field 2, 8-11 field 3, 12-15 field 4, then 5-9 alike
__device__ __forceinline__ int scatter_field(int lane) {
  const int base = (lane & 16) ? 5 : 0;
  if (lane & 8) return base + 3 + ((lane >> 2) & 1);
  if (lane & 4) return base + 2;
  return base + ((lane >> 1) & 1);
}

// whether `lane` is the first lane holding its field's total
__device__ __forceinline__ bool scatter_owner(int lane) {
  return (lane & ((lane & 12) ? 3 : 1)) == 0;
}

}  // namespace fourdgs
