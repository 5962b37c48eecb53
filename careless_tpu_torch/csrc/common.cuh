// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
//
// Every entry point takes raw device pointers and the caller's stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CT_API extern "C" __attribute__((visibility("default")))

static inline cudaStream_t ct_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

static inline int ct_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}
