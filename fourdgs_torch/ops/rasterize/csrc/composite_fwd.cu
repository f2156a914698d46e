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
// pixels at ~20 flops and one exp each), but at the SLAM path's shapes it
// runs far above both its byte and its operation bound (PERF.md). The
// likely limits, not yet measured apart, are the dependent per-pixel
// recurrence and the imbalance between tiles of very different pair
// counts.
//
// Design: one block per (view, tile), 256 threads, one pixel each — 12,000
// blocks for 10 views at 640x480, enough to fill 132 SMs. A batch of 256
// pairs is staged in shared memory through each pair's Gaussian id, so no
// (10, P) pair buffer is ever built in device memory. Each pixel keeps T in
// a register (in log space, as the reference does) and stops at T < 1e-4;
// the block stops once every pixel is done (__syncthreads_count), the
// analogue of the TPU kernel's saturated-tile skip. n_touched is a warp
// ballot per pair, summed in shared memory, then one atomicAdd per
// (block, Gaussian). The kernel allocates nothing and does not synchronise.
#include "composite_common.cuh"

namespace fourdgs {

__global__ void __launch_bounds__(NPIX) composite_fwd_kernel(
    const float* __restrict__ fields,     // (V, n1, NF)
    const int* __restrict__ pair_gid,     // (P,) Gaussian id of each pair
    const int* __restrict__ tile_start,   // (V*T,) range start into pair_gid
    const int* __restrict__ tile_count,   // (V*T,) range length
    int tiles_per_view, int tx_n, int n1, int width, int height,
    float* __restrict__ out,              // (V*T, NOUT, NPIX)
    int* __restrict__ n_contrib,          // (V*T, NPIX)
    int* __restrict__ n_touched) {        // (V, n1), zeroed by the caller
  __shared__ float s_f[BATCH][NF];
  __shared__ int s_gid[BATCH];
  __shared__ int s_nt[BATCH];

  const int vt = blockIdx.x;
  const int v = vt / tiles_per_view;
  const int t = vt - v * tiles_per_view;
  const int ty = t / tx_n;
  const int tx = t - ty * tx_n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ix = tx * TILE + tid % TILE;
  const int iy = ty * TILE + tid / TILE;
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
      const float* src = vfields + static_cast<size_t>(gid) * NF;
#pragma unroll
      for (int f = 0; f < NF; ++f) s_f[tid][f] = src[f];
      s_gid[tid] = gid;
    }
    s_nt[tid] = 0;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (__all_sync(FULL_MASK, done)) break;  // warp-uniform
      bool counted = false;
      if (!done) {
        float dx, dy, raw, alpha;
        if (pair_alpha(s_f[j], px, py, dx, dy, raw, alpha)) {
          const float cum_new = cum + log1pf(-alpha);
          const float t_incl = expf(cum_new);
          if (t_incl < T_EPS) {
            done = true;
          } else {
            const float t_before = t_incl * inv_one_minus(alpha);
            const float w = alpha * t_before;
            acc_r = acc_r + w * s_f[j][F_R];
            acc_g = acc_g + w * s_f[j][F_G];
            acc_b = acc_b + w * s_f[j][F_B];
            acc_d = acc_d + w * s_f[j][F_DEPTH];
            cum = cum_new;
            last = base + j + 1;
            counted = t_incl > 0.5f;
          }
        }
      }
      const unsigned votes = __ballot_sync(FULL_MASK, counted);
      if (lane == 0 && votes) atomicAdd(&s_nt[j], __popc(votes));
    }
    __syncthreads();
    if (tid < n && s_nt[tid] > 0) atomicAdd(&vnt[s_gid[tid]], s_nt[tid]);
  }

  float* o = out + static_cast<size_t>(vt) * NOUT * NPIX + tid;
  o[0 * NPIX] = acc_r;
  o[1 * NPIX] = acc_g;
  o[2 * NPIX] = acc_b;
  o[3 * NPIX] = acc_d;
  o[4 * NPIX] = expf(cum);
  n_contrib[static_cast<size_t>(vt) * NPIX + tid] = last;
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
