// Kernel A: pair-stream slot -> packed (bin, first sub-row, triangle) key.
//
// Replaces plainrenderer_tpu/ops/raster.py:_expand_keys_kernel (:406,
// launched by _expand_keys :545). For every slot j of the pair stream it
// finds the owning triangle, owner(j) = the first t with cum[t] > j, and
// packs the int32 sort key exactly as the JAX kernel and its XLA twin do:
//   k = j - cum_ex[owner]; dy = k / span_x; dx = k % span_x
//   tile = (y0 + dy) * n_tiles_x + x0 + dx
//   key = (tile * bin_rows + max(rel_fy0 - dy * bin_rows, 0)) * (tpv + 1)
//         + owner % tpv                  (order_rows)
//   key = tile * (tpv + 1) + owner % tpv (otherwise)
// With order_alpha the geometry word carries one more low bit, the pair's
// alpha-tested flag, and tile becomes tile * 2 + flag: alpha-tested pairs
// sort to the end of each bin (raster.py:489-491, :518-519).
// owner % tpv is the view-local triangle of a vertical atlas of T / tpv
// views (the shadow cascades, raster.py:508-524); one view has tpv = T.
// Slots at or past total = cum[T - 1] get the sentinel key and owner 0.
//
// Bound on the H100: it moves ~4 MB at the main view's shapes (three
// (T,) int32 tables read, two (budget,) int32 outputs written), about a
// microsecond at 3.35 TB/s, so its time is latency: the chain of
// dependent loads that finds a slot's owner. PR 1's design searched the
// whole cum table per slot, ~20 dependent loads (T = 878,016 in the
// atlas). Design (since PR 11): a block owns A_THREADS consecutive
// slots, whose owners lie between the owners of its first
// and its last live slot.
// - Two warps find those two owners at once, 32 probes a round
//   (plain_warp_owner): each round keeps the 1/32 of the range where cum
//   first exceeds the slot, so 878,016 triangles take 4 dependent loads.
// - The block stages the cum values between them in shared memory when
//   there are at most A_STAGE (at slice 5's dense streams a block spans
//   ~1,000-2,000 triangles, most of them empty), else A_SAMPLES of them
//   evenly spaced (an interval across a flat run of cum: the alpha
//   streams keep every triangle of the view, ~0.1% of them live, and
//   the culled stretches of the opaque streams). Each slot
//   binary-searches the staged values, then, between two samples, the
//   cum table itself.
// - Forks measured on slice 5's four streams (H100 80GB HBM3, 700 W;
//   compare_trees.py, PR 11) [main alpha, main opaque, atlas opaque,
//   atlas alpha], PR 1's design [0.0053, 0.0059, 0.0067, 0.0057] ms,
//   this one [0.0041, 0.0055, 0.0065, 0.0059]:
//   - a warp's 32 slots at a time, from the search's owner on through
//     windows of 32 cum values resolved by shuffles, a new search past
//     each window [0.0038, 0.0086, 0.0102, 0.0051]; 4 such rounds per
//     warp [0.0055, 0.0145, 0.0135, 0.0074]. The opaque streams
//     interleave live and empty triangles (41,845 pairs over 292,672
//     triangles), so 32 slots span ~200 triangles: a chain of windows
//     and searches;
//   - the block's interval searched in global memory above A_STAGE
//     [0.0040, 0.0062, 0.0070, 0.0066], 2 slots per thread [0.0047,
//     0.0085, 0.0101, 0.0103], 1,024 samples [0.0041, 0.0063, 0.0069,
//     0.0065], 128-thread blocks [0.0041, 0.0070, 0.0079, 0.0071].
//   Each stream's time is mostly fixed: the launch and ~640-1,340
//   blocks, three quarters of them only storing dead slots. The atlas's
//   alpha blocks span the cascades' gap of empty triangles, so their
//   slots search ~1,100 triangles between two samples in memory.
// - The TPU kernel's forward-only chunk cursor (raster.py:448-534) relied
//   on its grid running in order on one core; a block here needs no other
//   block's result.
// - k / span_x is an integer division: the TPU's f32 divide plus exact
//   fix-up (raster.py:496-515) existed only because that divide is not
//   correctly rounded.
#include "common.cuh"

#define A_THREADS 256  // one slot per thread
#define A_STAGE 4096   // cum values a block stages (16 KB)
#define A_SAMPLES 256  // ... or samples of a longer interval

// The first t in [lo, hi] with cum[t] > j, given cum[hi] > j; j and the
// bounds the same on every lane of the warp, as is the result.
__device__ __forceinline__ int plain_warp_owner(const int* __restrict__ cum,
                                                int lo, int hi, int j) {
  const int lane = threadIdx.x & 31;
  while (hi - lo >= 32) {  // 32 probes, evenly spaced; the last is hi
    const int step = (hi - lo + 32) / 32;
    const int probe = min(lo + step * (lane + 1) - 1, hi);
    const unsigned above =
        __ballot_sync(PLAIN_FULL_MASK, __ldg(cum + probe) > j);
    const int f = __ffs(above) - 1;
    if (f > 0) lo = lo + step * f;
    hi = min(lo + step - 1, hi);
  }
  const unsigned above = __ballot_sync(
      PLAIN_FULL_MASK, __ldg(cum + min(lo + lane, hi)) > j);
  return lo + __ffs(above) - 1;
}

__global__ void __launch_bounds__(A_THREADS)
expand_keys_kernel(const int* __restrict__ cum,
                   const int* __restrict__ cum_ex,
                   const int* __restrict__ geom, int* __restrict__ keys,
                   int* __restrict__ owners, int t_count, int budget,
                   int n_tiles_x, int bin_rows, int order_rows,
                   int order_alpha, int tpv, int sentinel) {
  __shared__ int s_cum[A_STAGE];
  __shared__ int s_bounds[2];
  const int first = blockIdx.x * A_THREADS;
  const int total = __ldg(cum + t_count - 1);
  // the block's live slots: first .. end - 1
  const int end = min(min(first + A_THREADS, budget), total);
  int lo = 0, n = 0, stride = 1, m = 0;
  if (end > first) {  // the same on the whole block
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int o =
          plain_warp_owner(cum, 0, t_count - 1, warp == 0 ? first : end - 1);
      if ((threadIdx.x & 31) == 0) s_bounds[warp] = o;
    }
    __syncthreads();
    lo = s_bounds[0];
    n = s_bounds[1] - lo + 1;  // the owners lo .. lo + n - 1
    if (n > A_STAGE) stride = (n + A_SAMPLES - 1) / A_SAMPLES;
    m = (n + stride - 1) / stride;  // samples cum[lo + i * stride]
    for (int i = threadIdx.x; i < m; i += A_THREADS) {
      s_cum[i] = __ldg(cum + lo + i * stride);
    }
    __syncthreads();
  }
  const int j = first + threadIdx.x;
  if (j >= budget) return;
  if (j >= total) {
    keys[j] = sentinel;
    owners[j] = 0;
    return;
  }
  int sa = 0, sb = m;  // the first sample above j (m: none)
  while (sa < sb) {
    const int mid = (sa + sb) >> 1;
    if (s_cum[mid] <= j) {
      sa = mid + 1;
    } else {
      sb = mid;
    }
  }
  // the owner lies after sample sa - 1 and at or before sample sa (or
  // the interval's last triangle, whose cum exceeds every live slot)
  int a = sa > 0 ? (sa - 1) * stride + 1 : 0;
  int b = min(sa * stride, n - 1);
  while (a < b) {  // nothing left to search where stride is 1
    const int mid = (a + b) >> 1;
    if (__ldg(cum + lo + mid) <= j) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const int owner = lo + a;
  const int k = j - __ldg(cum_ex + owner);
  int g = __ldg(geom + owner);
  // geom word: ty0[9b] | tx0[7b] | span_x[7b] | rel_fy0[3b] [| alpha 1b]
  const int ia = order_alpha ? (g & 1) : 0;
  if (order_alpha) g >>= 1;
  const int rel0 = g & 7;
  const int sx = max((g >> 3) & 127, 1);
  const int x0 = (g >> 10) & 127;
  const int y0 = g >> 17;
  const int kc = min(max(k, 0), (1 << 23) - 1);
  const int dy = kc / sx;
  const int dx = kc - dy * sx;
  int tile = (y0 + dy) * n_tiles_x + x0 + dx;
  if (order_alpha) tile = tile * 2 + ia;
  const int tri_local = owner % tpv;
  int key;
  if (order_rows) {
    const int kymin = max(rel0 - dy * bin_rows, 0);
    key = (tile * bin_rows + kymin) * (tpv + 1) + tri_local;
  } else {
    key = tile * (tpv + 1) + tri_local;
  }
  keys[j] = key;
  owners[j] = owner;
}

extern "C" int expand_keys_launch(const void* cum, const void* cum_ex,
                                  const void* geom, void* keys, void* owners,
                                  int t_count, int budget, int n_tiles_x,
                                  int bin_rows, int order_rows,
                                  int order_alpha, int tpv, int sentinel,
                                  void* stream) {
  const int blocks = (budget + A_THREADS - 1) / A_THREADS;
  expand_keys_kernel<<<blocks, A_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)cum, (const int*)cum_ex, (const int*)geom, (int*)keys,
      (int*)owners, t_count, budget, n_tiles_x, bin_rows, order_rows,
      order_alpha, tpv, sentinel);
  PLAIN_RETURN_LAUNCH_STATUS();
}

// Message for a status returned by any entry point of this library.
extern "C" const char* plain_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
