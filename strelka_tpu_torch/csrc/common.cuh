// Shared helpers of the port's CUDA kernels (plain C interface, bound with
// ctypes from strelka_tpu_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Every C entry ends with this: a launch the CUDA runtime refused (too many
// threads, too much shared memory) never runs, and only this reports it.
#define STRELKA_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

static inline unsigned int strelka_blocks(long long n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}
