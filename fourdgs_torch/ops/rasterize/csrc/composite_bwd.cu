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
// pixel-pair), but at the SLAM path's shapes it runs far above its bound
// (PERF.md). The likely limit is the per-pair reduction: per pair a block
// does 10 warp reductions (5 shuffles each) for every warp that has a
// contribution, 8-way shared-memory atomics, then 10 global atomics per
// (block, Gaussian).
//
// Design: one block per (view, tile), 256 threads, one pixel each. T is
// recovered back to front from T_final by T_before = T / (1 - alpha), so
// nothing per pair is saved by the forward beyond each pixel's last
// applied index. Pairs are staged in shared memory in batches of 256 from
// the end; per pair each warp reduces its 10 values with shuffles and lane
// 0 adds them into a per-batch shared accumulator; after the batch one
// thread per pair divides the op term by op and atomically adds the 10
// sums into the per-Gaussian gradient. That replaces the reference's
// per-pair gradient buffer, its gathers and the binner's candidate tables.
#include "composite_common.cuh"

namespace fourdgs {

__global__ void __launch_bounds__(NPIX) composite_bwd_kernel(
    const float* __restrict__ fields,     // (V, n1, NF)
    const int* __restrict__ pair_gid,     // (P,)
    const int* __restrict__ tile_start,   // (V*T,)
    const int* __restrict__ tile_count,   // (V*T,)
    int tiles_per_view, int tx_n, int n1,
    const float* __restrict__ out,        // (V*T, NOUT, NPIX) forward outputs
    const int* __restrict__ n_contrib,    // (V*T, NPIX)
    const float* __restrict__ grad_out,   // (V*T, NOUT, NPIX)
    float* __restrict__ dfields) {        // (V, n1, NF), zeroed by the caller
  __shared__ float s_f[BATCH][NF];
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
  const float px = static_cast<float>(tx * TILE + tid % TILE);
  const float py = static_cast<float>(ty * TILE + tid / TILE);
  const int start = tile_start[vt];
  const float* vfields = fields + static_cast<size_t>(v) * n1 * NF;
  float* vdf = dfields + static_cast<size_t>(v) * n1 * NF;

  const size_t o = static_cast<size_t>(vt) * NOUT * NPIX + tid;
  const float g_r = grad_out[o + 0 * NPIX];
  const float g_g = grad_out[o + 1 * NPIX];
  const float g_b = grad_out[o + 2 * NPIX];
  const float g_d = grad_out[o + 3 * NPIX];
  const float g_tf = grad_out[o + 4 * NPIX];
  const float t_final = out[o + 4 * NPIX];
  const int last = n_contrib[static_cast<size_t>(vt) * NPIX + tid];

  float T = t_final;             // T after the pair being visited
  float suffix = g_tf * t_final; // sum over later applied pairs of w u, + g_Tf T_final

  if (tid == 0) s_last = 0;
  __syncthreads();
  if (last > 0) atomicMax(&s_last, last);
  __syncthreads();
  const int block_last = s_last;

  for (int end = block_last; end > 0; end -= BATCH) {
    const int base = max(0, end - BATCH);
    const int n = end - base;
    if (tid < n) {
      const int gid = pair_gid[start + base + tid];
      const float* src = vfields + static_cast<size_t>(gid) * NF;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        s_f[tid][f] = src[f];
        s_g[tid][f] = 0.0f;
      }
      s_gid[tid] = gid;
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float gm[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) gm[f] = 0.0f;
      bool contrib = false;
      if (base + j < last) {
        const float* f = s_f[j];
        float dx, dy, raw, alpha;
        if (pair_alpha(f, px, py, dx, dy, raw, alpha)) {
          contrib = true;
          const float inv = inv_one_minus(alpha);
          const float t_before = T * inv;
          const float w = alpha * t_before;
          const float u = g_r * f[F_R] + g_g * f[F_G] + g_b * f[F_B] + g_d * f[F_DEPTH];
          float dalpha = u * t_before - suffix * inv;
          suffix = suffix + w * u;
          T = t_before;
          if (!(raw < ALPHA_MAX)) dalpha = 0.0f;  // clamped alpha has no gradient
          const float dpower = raw * dalpha;
          gm[F_MX] = dpower * -(f[F_CA] * dx + f[F_CB] * dy);
          gm[F_MY] = dpower * -(f[F_CC] * dy + f[F_CB] * dx);
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
      if (__any_sync(FULL_MASK, contrib)) {  // warp-uniform
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float s = warp_sum(gm[f]);
          if (lane == 0 && s != 0.0f) atomicAdd(&s_g[j][f], s);
        }
      }
    }
    __syncthreads();

    if (tid < n) {
      const float op = s_f[tid][F_OP];
      float* dst = vdf + static_cast<size_t>(s_gid[tid]) * NF;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float g = s_g[tid][f];
        if (f == F_OP) g = op > 1e-12f ? g / op : 0.0f;
        if (g != 0.0f) atomicAdd(dst + f, g);
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
