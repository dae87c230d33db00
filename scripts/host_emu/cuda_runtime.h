// Host stand-ins for the CUDA runtime names the port's kernel sources use,
// so that g++ compiles them for the host emulation of run.py.  Every
// float32 operation is one IEEE operation (build with -ffp-contract=off),
// as the kernels' __f*_rn intrinsics and fmaf are on the card.  Static
// __shared__ arrays are function statics: one block runs at a time.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
#define ASM_STUB(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx, blockIdx;
extern thread_local dim3 gridDim, blockDim;
extern thread_local float* g_smem;   // the block's dynamic shared memory
void __syncthreads();
float __shfl_xor_sync(unsigned, float, int);

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1,
              cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
using std::abs;
using std::max;
using std::min;
