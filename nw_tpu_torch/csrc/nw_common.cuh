// Shared helpers of the package's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace nw {

constexpr unsigned kFull = 0xffffffffu;

// two's-complement wrapping int32 arithmetic (signed overflow is
// undefined in C++; the reference fill wraps)
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

}  // namespace nw
