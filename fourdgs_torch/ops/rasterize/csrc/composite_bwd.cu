// Backward tile compositor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel_csr` with `_bwd_chunk`
// (fourdgs/ops/rasterize/tile_kernel.py, launched by `_csr_bwd_impl`), the
// VJP of `composite_csr` and `composite_csr_multi`, together with the
// per-Gaussian reduction `reduce_aligned_by_gaussian` that follows it.
//
// What it computes: walking each pixel's applied pairs back to front from
// the last one, with the suffix seeded by g_Tfinal T_final,
//   dalpha = u T_before - suffix / (1 - alpha),  u = sum_c g_c c + g_d depth,
// zero where alpha was clamped at 0.99; dpower = raw dalpha; the gradients
// of the 10 fields [mx, my, ca, cb, cc, depth, op, r, g, b] of each pair,
// with d op = (sum over pixels of dpower) / op where op > 1e-12. They are
// summed per Gaussian into (V, n1, 10).
//
// What bounds it on an H100: by count, operations (~65 flops per applied
// pixel-pair), but what it runs into is instruction issue: per (warp, pair)
// that reaches the warp's pixels, the pixel arithmetic, then a 10-value
// warp reduction and the shared accumulation, at ~30 pairs a tile. The
// earlier design spent 50 shuffles, 50 adds and 10 serial shared atomics
// per (warp, pair) on the reduction alone, and the arithmetic of every warp
// on every pair of its tile.
//
// Design: one block per (view, tile), 256 threads, one pixel each, each
// warp an 8x4 pixel block. T is recovered back to front from T_final by
// T_before = T / (1 - alpha), so nothing per pair is saved by the forward
// beyond each pixel's last applied index. Pairs are staged in shared
// memory in batches of 256 from the end, each with a bit mask of the warps
// whose block its conservative extent meets (composite_common.cuh). Each
// warp starts at its own last applied pair and walks back only the pairs
// with its bit set, 32 candidates per ballot; for each it reduces its 10
// values with a 12-shuffle reduce-scatter, and the 10 lanes that hold the
// sums add them into the per-batch shared accumulator in one instruction.
// After the batch one thread per pair divides the op term by op and adds
// the sums into the per-Gaussian gradient with five float2 atomics. The
// validity decision repeats the forward's unfused arithmetic; the
// gradient arithmetic after it uses explicit __fmaf_rn (-fmad=false only
// stops the compiler from contracting on its own).
// __launch_bounds__ asks for 6 blocks per SM (40 registers, 8 bytes of
// spill); 8 blocks (32 registers) measured the same.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, compositor_ab.py on
// chip_smoke.py's 640x480 inputs): 0.286 ms at 10 views and 0.040 ms at 1
// view, against 0.813 and 0.113 ms for the earlier design; the explicit
// fused multiply-adds then took 0.288 to 0.284 ms and 0.0401 to 0.0396 ms
// in one call. The reduce-scatter alone took it to 0.348 and 0.047 ms; the
// cull, each warp's own last pair, the float2 atomics and the register cap
// gave the rest (PERF.md). Two pixels per thread, which halves the
// reductions, was 9% faster at 10 views but 5% slower at 1 view, the
// shape of most launches, so it was not kept.
//
// Hopper features that do not apply: the tensor cores (no product of the
// size wgmma takes; the TPU's triangular matmuls were its way of doing the
// running log-T sum, which a per-pixel register loop does directly), and
// TMA or cp.async pipelining (a tile's ~30 pairs fit one batch, and the
// gather is indirect through pair_gid). What the card gives this design:
// warp-uniform control, shuffles, vector shared loads, vector global
// atomics (sm_90), registers and occupancy.
#include "composite_common.cuh"

namespace fourdgs {

constexpr int BWD_MIN_BLOCKS = 6;  // blocks per SM: caps registers at 40

__global__ void __launch_bounds__(NPIX, BWD_MIN_BLOCKS) composite_bwd_kernel(
    const float* __restrict__ fields,     // (V, n1, NF)
    const int* __restrict__ pair_gid,     // (P,)
    const int* __restrict__ tile_start,   // (V*T,)
    const int* __restrict__ tile_count,   // (V*T,)
    int tiles_per_view, int tx_n, int n1,
    const float* __restrict__ out,        // (V*T, NOUT, NPIX) forward outputs
    const int* __restrict__ n_contrib,    // (V*T, NPIX)
    const float* __restrict__ grad_out,   // (V*T, NOUT, NPIX)
    float* __restrict__ dfields) {        // (V, n1, NF), zeroed by the caller
  __shared__ Row s_row[BATCH];
  __shared__ unsigned s_mask[BATCH];  // warps whose block the pair's extent meets
  __shared__ float s_g[BATCH][NF];
  __shared__ int s_gid[BATCH];
  __shared__ int s_last;

  const int vt = blockIdx.x;
  const int v = vt / tiles_per_view;
  const int t = vt - v * tiles_per_view;
  const int ty = t / tx_n;
  const int tx = t - ty * tx_n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int lx, ly;
  warp_pixel(tid, lx, ly);
  const int pix = ly * TILE + lx;
  const float px = static_cast<float>(tx * TILE + lx);
  const float py = static_cast<float>(ty * TILE + ly);
  const int start = tile_start[vt];
  const float* vfields = fields + static_cast<size_t>(v) * n1 * NF;
  float* vdf = dfields + static_cast<size_t>(v) * n1 * NF;
  const int my_field = scatter_field(lane);
  const bool owner = scatter_owner(lane);

  const size_t o = static_cast<size_t>(vt) * NOUT * NPIX + pix;
  const float g_r = grad_out[o + 0 * NPIX];
  const float g_g = grad_out[o + 1 * NPIX];
  const float g_b = grad_out[o + 2 * NPIX];
  const float g_d = grad_out[o + 3 * NPIX];
  const float g_tf = grad_out[o + 4 * NPIX];
  const float t_final = out[o + 4 * NPIX];
  const int last = n_contrib[static_cast<size_t>(vt) * NPIX + pix];

  float T = t_final;             // T after the pair being visited
  float suffix = g_tf * t_final; // sum over later applied pairs of w u, + g_Tf T_final

  const int warp_last = __reduce_max_sync(FULL_MASK, last);
  if (tid == 0) s_last = 0;
  __syncthreads();
  if (lane == 0 && warp_last > 0) atomicMax(&s_last, warp_last);
  __syncthreads();
  const int block_last = s_last;

  for (int end = block_last; end > 0; end -= BATCH) {
    const int base = max(0, end - BATCH);
    const int n = end - base;
    if (tid < n) {
      const int gid = pair_gid[start + base + tid];
      const Row r = load_row(vfields + static_cast<size_t>(gid) * NF);
      float f[NF];
      unpack_row(r, f);
      s_row[tid] = r;
      s_mask[tid] = warp_mask(pair_extent(f), tx * TILE, ty * TILE);
      s_gid[tid] = gid;
#pragma unroll
      for (int k = 0; k < NF; ++k) s_g[tid][k] = 0.0f;
    }
    __syncthreads();

    // this warp's pairs of the batch, back to front: those before its last
    // applied one whose extent meets its block, 32 candidates per ballot
    const int jend = min(n, warp_last - base);
    for (int j0 = jend > 0 ? (jend - 1) & ~31 : -1; j0 >= 0; j0 -= 32) {
      unsigned todo = __ballot_sync(
          FULL_MASK, j0 + lane < jend && ((s_mask[j0 + lane] >> warp) & 1u));
      while (todo) {  // warp-uniform
        const int bit = 31 - __clz(todo);
        todo &= ~(1u << bit);
        const int j = j0 + bit;
        float f[NF];
        unpack_row(s_row[j], f);
        float gm[NF];
#pragma unroll
        for (int k = 0; k < NF; ++k) gm[k] = 0.0f;
        bool contrib = false;
        if (base + j < last) {
          float dx, dy, raw, alpha;
          if (pair_alpha(f, px, py, dx, dy, raw, alpha)) {
            contrib = true;
            const float inv = inv_one_minus(alpha);
            const float t_before = T * inv;
            const float w = alpha * t_before;
            // past the validity decision: explicit fused multiply-adds
            const float u = __fmaf_rn(g_d, f[F_DEPTH], __fmaf_rn(g_b, f[F_B],
                                      __fmaf_rn(g_g, f[F_G], g_r * f[F_R])));
            float dalpha = __fmaf_rn(u, t_before, -suffix * inv);
            suffix = __fmaf_rn(w, u, suffix);
            T = t_before;
            if (!(raw < ALPHA_MAX)) dalpha = 0.0f;  // clamped alpha has no gradient
            const float dpower = raw * dalpha;
            gm[F_MX] = -dpower * __fmaf_rn(f[F_CA], dx, f[F_CB] * dy);
            gm[F_MY] = -dpower * __fmaf_rn(f[F_CC], dy, f[F_CB] * dx);
            gm[F_CA] = -0.5f * dpower * dx * dx;
            gm[F_CB] = -dpower * dx * dy;
            gm[F_CC] = -0.5f * dpower * dy * dy;
            gm[F_DEPTH] = g_d * w;
            gm[F_OP] = dpower;  // divided by op once per block below
            gm[F_R] = g_r * w;
            gm[F_G] = g_g * w;
            gm[F_B] = g_b * w;
          }
        }
        if (!__any_sync(FULL_MASK, contrib)) continue;  // warp-uniform
        const float s = warp_sum10_scatter(gm, lane);
        if (owner) atomicAdd(&s_g[j][my_field], s);
      }
    }
    __syncthreads();

    if (tid < n) {
      float g[NF];
#pragma unroll
      for (int k = 0; k < NF; ++k) g[k] = s_g[tid][k];
      const float op = s_row[tid].b.z;
      g[F_OP] = op > 1e-12f ? g[F_OP] / op : 0.0f;
      // rows are 40 bytes, so 8-byte aligned: five float2 atomics (sm_90)
      float2* dst = reinterpret_cast<float2*>(vdf + static_cast<size_t>(s_gid[tid]) * NF);
#pragma unroll
      for (int k = 0; k < NF / 2; ++k) {
        if (g[2 * k] != 0.0f || g[2 * k + 1] != 0.0f)
          atomicAdd(dst + k, make_float2(g[2 * k], g[2 * k + 1]));
      }
    }
  }
}

}  // namespace fourdgs

extern "C" int composite_bwd_launch(const float* fields, const int* pair_gid,
                                    const int* tile_start, const int* tile_count,
                                    int n_tiles_total, int tiles_per_view, int tx_n,
                                    int n1, const float* out, const int* n_contrib,
                                    const float* grad_out, float* dfields,
                                    void* stream) {
  if (n_tiles_total > 0) {
    fourdgs::composite_bwd_kernel<<<n_tiles_total, fourdgs::NPIX, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        fields, pair_gid, tile_start, tile_count, tiles_per_view, tx_n, n1, out,
        n_contrib, grad_out, dfields);
  }
  return static_cast<int>(cudaGetLastError());
}
