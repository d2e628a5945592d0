// Host stand-in for the CUDA runtime pieces that csrc/attention_wide.cuh's
// device code uses, so that g++ compiles the kernels as C++ and
// emulate.cpp runs them: one fiber per CUDA thread, the thread and block
// indices read from the running fiber, the barriers and warp collectives
// in emulate.cpp.
#pragma once
#include <math.h>

#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

struct uint4 {
  unsigned x, y, z, w;
};
struct float2 {
  float x, y;
};
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
// one rounding each, never contracted (the host build takes
// -ffp-contract=off as well)
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  memcpy(&x, &u, 4);
  return x;
}

struct EmuIdx {
  unsigned x, y, z;
};
EmuIdx& emu_thread_idx();
extern EmuIdx emu_block_idx, emu_block_dim, emu_grid_dim;
#define threadIdx (emu_thread_idx())
#define blockIdx emu_block_idx
#define blockDim emu_block_dim
#define gridDim emu_grid_dim
void __syncthreads();
void __syncwarp();
float __shfl_xor_sync(unsigned mask, float v, int lanemask);
