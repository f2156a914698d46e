// Forward tile compositor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel_csr`
// (fourdgs/ops/rasterize/tile_kernel.py, launched by `_csr_fwd_impl`) and
// the pair gather `_csr_gather_pairs` in front of it.
//
// What it computes: for each 16x16 tile of each view, every pixel walks
// the tile's depth-sorted (tile, Gaussian) pairs front to back with
// alpha = min(0.99, op e^power); a pair is valid when power <= 0 and
// alpha >= 1/255 and applies while T after it is >= 1e-4. The pixel
// accumulates alpha T_before (r, g, b, depth). Per Gaussian it counts
// n_touched: in-image pixels where the pair applied with T > 0.5.
// Outputs per tile: (r, g, b, depth, T_final) x 256 pixels, and the count
// of pairs up to each pixel's last applied one, which the backward kernel
// walks from (the CUDA reference's n_contrib).
//
// What bounds it on an H100: by count, bytes (each pair's 40-byte field
// row is read once per tile through its Gaussian id, then serves 256
// pixels at ~20 flops and one exp each), but what it runs into is
// instruction issue. Tiles hold ~30 pairs, so one shared-memory batch holds
// a whole tile and staging is not the limit. What is left after the cull is
// the per-pixel work of the pairs that do reach a warp's pixels: the alpha
// test, then log1pf, expf and an IEEE divide for an applied pair, which
// must round as the plain version does.
//
// Design: one block per (view, tile), 256 threads, one pixel each, each
// warp an 8x4 pixel block — 12,000 blocks for 10 views at 640x480. A batch
// of 256 pairs is staged in shared memory through each pair's Gaussian id,
// each row padded to 12 floats (three 16-byte broadcast loads per pixel)
// beside a bit mask of the warps whose block the pair's conservative
// extent meets (composite_common.cuh); each warp walks only the pairs with
// its bit set, found 32 at a time by a ballot, so a pair that cannot reach
// its pixels costs it nothing, not even a vote. Each pixel keeps T in a
// register (in log space, as the reference does) and stops at T < 1e-4; a
// warp stops once all its pixels are done, the block once every pixel is
// (__syncthreads_count), the analogue of the TPU kernel's saturated-tile
// skip. n_touched is a warp ballot per pair, summed in shared memory, then
// one atomicAdd per (block, Gaussian). No (10, P) pair buffer is built in
// device memory; the kernel allocates nothing and does not synchronise.
// __launch_bounds__ asks for 8 blocks per SM, which caps registers at 32
// (ptxas then reports 36 bytes of spill stores): full occupancy beat 40
// and 48 registers without the cap's spills.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, compositor_ab.py on
// chip_smoke.py's 640x480 inputs): 0.222 ms at 10 views and 0.033 ms at 1
// view, against 0.287 and 0.040 ms for the earlier design (a warp per 16x2
// strip, every pair for every warp, scalar shared loads). The cull removes
// 45% of the (warp, pair) visits; a perfect one would remove 57%, but a
// test of the exact ellipse against each block cost more in staging than
// it saved (PERF.md). Two pixels per thread was slower at both shapes.
//
// Hopper features that do not apply: the tensor cores (the TPU's
// triangular matmuls computed the running log-T sum, which a per-pixel
// register loop does directly) and TMA or cp.async pipelining (one batch
// holds a tile, and the gather is indirect). What the card gives this
// design: warp-uniform control, vector shared loads, registers and
// occupancy.
#include "composite_common.cuh"

namespace fourdgs {

constexpr int FWD_MIN_BLOCKS = 8;  // blocks per SM: caps registers at 32

__global__ void __launch_bounds__(NPIX, FWD_MIN_BLOCKS) composite_fwd_kernel(
    const float* __restrict__ fields,     // (V, n1, NF)
    const int* __restrict__ pair_gid,     // (P,) Gaussian id of each pair
    const int* __restrict__ tile_start,   // (V*T,) range start into pair_gid
    const int* __restrict__ tile_count,   // (V*T,) range length
    int tiles_per_view, int tx_n, int n1, int width, int height,
    float* __restrict__ out,              // (V*T, NOUT, NPIX)
    int* __restrict__ n_contrib,          // (V*T, NPIX)
    int* __restrict__ n_touched) {        // (V, n1), zeroed by the caller
  __shared__ Row s_row[BATCH];
  __shared__ unsigned s_mask[BATCH];  // warps whose block the pair's extent meets
  __shared__ int s_gid[BATCH];
  __shared__ int s_nt[BATCH];

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
  const int ix = tx * TILE + lx;
  const int iy = ty * TILE + ly;
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(iy);
  const int start = tile_start[vt];
  const int count = tile_count[vt];
  const float* vfields = fields + static_cast<size_t>(v) * n1 * NF;
  int* vnt = n_touched + static_cast<size_t>(v) * n1;

  // pixels past the image edge contribute nothing and are done at once
  bool done = !(ix < width && iy < height);
  float cum = 0.0f;  // log T
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int last = 0;

  for (int base = 0; base < count; base += BATCH) {
    if (__syncthreads_count(done) == NPIX) break;
    const int n = min(BATCH, count - base);
    if (tid < n) {
      const int gid = pair_gid[start + base + tid];
      const Row r = load_row(vfields + static_cast<size_t>(gid) * NF);
      float f[NF];
      unpack_row(r, f);
      s_row[tid] = r;
      s_mask[tid] = warp_mask(pair_extent(f), tx * TILE, ty * TILE);
      s_gid[tid] = gid;
    }
    s_nt[tid] = 0;
    __syncthreads();

    // this warp's pairs of the batch, front to back: those whose extent
    // meets its block, 32 candidates per ballot; all warp-uniform
    bool warp_done = __all_sync(FULL_MASK, done);
    for (int j0 = 0; j0 < n && !warp_done; j0 += 32) {
      unsigned todo =
          __ballot_sync(FULL_MASK, j0 + lane < n && ((s_mask[j0 + lane] >> warp) & 1u));
      while (todo) {
        const int j = j0 + __ffs(todo) - 1;
        todo &= todo - 1;
        bool counted = false;
        if (!done) {
          float f[NF];
          unpack_row(s_row[j], f);
          float dx, dy, raw, alpha;
          if (pair_alpha(f, px, py, dx, dy, raw, alpha)) {
            const float cum_new = cum + log1pf(-alpha);
            const float t_incl = expf(cum_new);
            if (t_incl < T_EPS) {
              done = true;
            } else {
              const float t_before = t_incl * inv_one_minus(alpha);
              const float w = alpha * t_before;
              acc_r = acc_r + w * f[F_R];
              acc_g = acc_g + w * f[F_G];
              acc_b = acc_b + w * f[F_B];
              acc_d = acc_d + w * f[F_DEPTH];
              cum = cum_new;
              last = base + j + 1;
              counted = t_incl > 0.5f;
            }
          }
        }
        const unsigned votes = __ballot_sync(FULL_MASK, counted);
        if (lane == 0 && votes) atomicAdd(&s_nt[j], __popc(votes));
        if (__all_sync(FULL_MASK, done)) {
          warp_done = true;
          break;
        }
      }
    }
    __syncthreads();
    if (tid < n && s_nt[tid] > 0) atomicAdd(&vnt[s_gid[tid]], s_nt[tid]);
  }

  float* o = out + static_cast<size_t>(vt) * NOUT * NPIX + pix;
  o[0 * NPIX] = acc_r;
  o[1 * NPIX] = acc_g;
  o[2 * NPIX] = acc_b;
  o[3 * NPIX] = acc_d;
  o[4 * NPIX] = expf(cum);
  n_contrib[static_cast<size_t>(vt) * NPIX + pix] = last;
}

}  // namespace fourdgs

extern "C" int composite_fwd_launch(const float* fields, const int* pair_gid,
                                    const int* tile_start, const int* tile_count,
                                    int n_tiles_total, int tiles_per_view, int tx_n,
                                    int n1, int width, int height, float* out,
                                    int* n_contrib, int* n_touched, void* stream) {
  if (n_tiles_total > 0) {
    fourdgs::composite_fwd_kernel<<<n_tiles_total, fourdgs::NPIX, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        fields, pair_gid, tile_start, tile_count, tiles_per_view, tx_n, n1, width,
        height, out, n_contrib, n_touched);
  }
  return static_cast<int>(cudaGetLastError());
}
