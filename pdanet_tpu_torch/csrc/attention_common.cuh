// Element and arithmetic helpers shared by the float32 / float64 SIMT
// neighbour-attention kernels (neighbor_attention.cu,
// neighbor_attention_bwd.cu).
//
// T is the element type of the tensors and C = Acc<T>::type the type of
// every sum and of the shared-memory tiles: float for float32 elements,
// double for float64 elements.  The arithmetic asks for round-to-nearest
// operations explicitly, since the library builds with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace pdanet_attn {

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load_c(float x) { return x; }
__device__ __forceinline__ double load_c(double x) { return x; }

__device__ __forceinline__ void store_c(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_c(double* p, double x) { *p = x; }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_c(float x) { return expf(x); }
__device__ __forceinline__ double exp_c(double x) { return exp(x); }
__device__ __forceinline__ float max_c(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_c(double a, double b) { return fmax(a, b); }

// element type codes of the C interface (bfloat16 runs on the tensor-core
// kernels, which take no code)
enum DType { kFloat32 = 0, kFloat64 = 2 };

}  // namespace pdanet_attn
