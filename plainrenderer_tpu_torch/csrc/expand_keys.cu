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
// microsecond at 3.35 TB/s, so it is launch-bound. Design:
// - one thread per slot, no shared memory: each thread binary-searches
//   the whole cum table in global memory (1.2 MB at T = 292,672, resident
//   in the 50 MB L2 after the first probes of the first blocks);
// - the TPU kernel's forward-only chunk cursor (raster.py:448-534) relied
//   on its grid running in order on one core; blocks here run in any
//   order, so each slot searches the full table instead;
// - k / span_x is an integer division: the TPU's f32 divide plus exact
//   fix-up (raster.py:496-515) existed only because that divide is not
//   correctly rounded.
#include "common.cuh"

__global__ void expand_keys_kernel(const int* __restrict__ cum,
                                   const int* __restrict__ cum_ex,
                                   const int* __restrict__ geom,
                                   int* __restrict__ keys,
                                   int* __restrict__ owners, int t_count,
                                   int budget, int n_tiles_x, int bin_rows,
                                   int order_rows, int order_alpha, int tpv,
                                   int sentinel) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= budget) return;
  const int total = __ldg(cum + t_count - 1);
  if (j >= total) {
    keys[j] = sentinel;
    owners[j] = 0;
    return;
  }
  // first t with cum[t] > j; cum[t_count - 1] = total > j bounds it
  int lo = 0, hi = t_count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cum + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int owner = lo;
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
  const int threads = 256;
  const int blocks = (budget + threads - 1) / threads;
  expand_keys_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)cum, (const int*)cum_ex, (const int*)geom, (int*)keys,
      (int*)owners, t_count, budget, n_tiles_x, bin_rows, order_rows,
      order_alpha, tpv, sentinel);
  PLAIN_RETURN_LAUNCH_STATUS();
}

// Message for a status returned by any entry point of this library.
extern "C" const char* plain_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
