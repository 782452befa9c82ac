// Shared constants of the port's raster kernels. They mirror
// plainrenderer_tpu/ops/raster.py:61-69 and must stay equal to
// plainrenderer_tpu_torch/ops/raster.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PLAIN_TILE_H 16
#define PLAIN_TILE_W 128
#define PLAIN_GROUP 128
#define PLAIN_SLOT_BITS 11
#define PLAIN_SLOT_MASK ((1 << PLAIN_SLOT_BITS) - 1)
#define PLAIN_NATTR 30
#define PLAIN_GBUF_CHANNELS 13

// Every C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch (too many threads, too much
// shared memory) is reported instead of silently never running.
#define PLAIN_RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()
