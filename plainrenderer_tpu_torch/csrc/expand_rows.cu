// Kernel M: the presort row expansion of build_pairs(carry_table=...).
//
// Replaces plainrenderer_tpu/ops/raster.py:_expand_rows_kernel (:606,
// launched by _expand_rows :697): out[r, j] = table[r, owner(j)] for the
// live slots j < total of the pair stream, 0 for the dead ones. owner
// comes from kernel A (expand_keys.cu), table is a (rows, T + 1) setup
// row table (ops/raster.py:setup_row_table). The sort then moves the
// columns with the keys (torch.sort's permutation and one index_select).
//
// Bound and design on the H100: a gather, bytes-bound: it reads the owner
// of every slot and writes rows x budget f32 (48 rows x ~470k slots, ~90
// MB at the bench's main view), and reads each table column about once.
// The TPU kernel streamed windows of the table through VMEM with a
// forward-only cursor because its grid ran in order on one core; here one
// thread per slot loads its owner once and copies the column row by row.
// Neighbouring slots have equal or neighbouring owners (owners are
// non-decreasing in the slot), so a warp's reads of one row fall in a few
// cache lines, and its writes are coalesced.
#include "common.cuh"

__global__ void expand_rows_kernel(const int* __restrict__ owners,
                                   const float* __restrict__ table,
                                   const int* __restrict__ total,
                                   float* __restrict__ out, int n_rows,
                                   int n_cols, int budget) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= budget) return;
  const bool live = j < __ldg(total);
  const int owner = live ? __ldg(owners + j) : 0;
  for (int r = 0; r < n_rows; ++r) {
    out[(size_t)r * budget + j] =
        live ? __ldg(table + (size_t)r * n_cols + owner) : 0.0f;
  }
}

extern "C" int expand_rows_launch(const void* owners, const void* table,
                                  const void* total, void* out, int n_rows,
                                  int n_cols, int budget, void* stream) {
  const int threads = 256;
  expand_rows_kernel<<<(budget + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)owners, (const float*)table, (const int*)total,
      (float*)out, n_rows, n_cols, budget);
  PLAIN_RETURN_LAUNCH_STATUS();
}
