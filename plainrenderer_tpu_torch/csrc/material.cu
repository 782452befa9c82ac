// Kernel C: per-pixel material constants.
//
// Replaces plainrenderer_tpu/ops/post.py:_material_kernel (:69): for every
// pixel, out[c] = table[c][clip(int(id), 0, 127)] where valid, else 0,
// with table the (C, 128) transposed, zero-padded material table.
//
// Bound on the H100: pure data movement, ~37 B per pixel (f32 id, bool
// valid, C = 8 f32 outputs), about 77 MB and 23 us at 1080p at 3.35 TB/s.
// Design: one thread per pixel; the (C, 128) table (4 KB) sits in shared
// memory, so the per-pixel lookup is a shared-memory read and the only
// device-memory traffic is the coalesced id/valid reads and the C planar
// output writes. The TPU version's lane gather over a VMEM-resident table
// row becomes that shared-memory read.
#include "common.cuh"

__global__ void material_kernel(const float* __restrict__ table,
                                const float* __restrict__ ids,
                                const unsigned char* __restrict__ valid,
                                float* __restrict__ out, int n_pix,
                                int channels) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < channels * 128; i += blockDim.x) {
    tab[i] = table[i];
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  // astype(int32) truncates toward zero, then clip to the 128 table lanes
  const int id = min(max(__float2int_rz(ids[p]), 0), 127);
  const bool ok = valid[p] != 0;
  for (int c = 0; c < channels; ++c) {
    out[(size_t)c * n_pix + p] = ok ? tab[c * 128 + id] : 0.0f;
  }
}

extern "C" int material_launch(const void* table, const void* ids,
                               const void* valid, void* out, int n_pix,
                               int channels, void* stream) {
  const int threads = 256;
  const int blocks = (n_pix + threads - 1) / threads;
  const size_t smem = (size_t)channels * 128 * sizeof(float);
  material_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)ids, (const unsigned char*)valid,
      (float*)out, n_pix, channels);
  PLAIN_RETURN_LAUNCH_STATUS();
}
