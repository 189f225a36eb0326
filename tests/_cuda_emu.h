// A CPU stand-in for the part of CUDA that the f32 kernels use
// (tfswa_tpu_torch/csrc/*_f32.cu, block_f32.cuh), so that their sources
// compile with g++ and run in a CPU test.  A launch runs the grid's blocks
// one after another on blockDim.x threads (std::thread); __syncthreads is
// a barrier of the block's threads, __shfl_xor_sync (float or double) an exchange through a
// warp's slots between two barriers of its 32 threads, __shared__ a static
// (one copy, shared by the threads of the block running).  Built with
// -DTFSWA_EMU -include _cuda_emu.h; emu_launch is in _cuda_emu.cpp.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <functional>

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static

extern thread_local dim3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;
extern std::barrier<>* emu_block_barrier;
extern std::barrier<>* emu_warp_barrier[32];
extern double emu_lanes[32][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
    const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
    emu_lanes[w][lane] = v;
    emu_warp_barrier[w]->arrive_and_wait();
    const T r = static_cast<T>(emu_lanes[w][lane ^ mask]);
    emu_warp_barrier[w]->arrive_and_wait();
    return r;
}

void emu_launch(dim3 grid, dim3 block, const std::function<void()>& kernel);

#define LAUNCH(kernel, grid, block, stream, ...) \
    emu_launch(dim3(grid), dim3(block), [&] { kernel(__VA_ARGS__); })
