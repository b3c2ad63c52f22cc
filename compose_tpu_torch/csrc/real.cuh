// Helpers shared by the kernels, overloaded on the real type (each kernel
// is a template instantiated for double and float).
#pragma once

#include <cuda_runtime.h>

namespace real {

__device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }

// The QP weight floor of limiter.limit_tracer, 1e-300, as the plain
// version rounds it: 0 in float.
template <class T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ double tiny<double>() { return 1e-300; }
template <>
__device__ __forceinline__ float tiny<float>() { return 0.0f; }

}  // namespace real
