// A CPU stand-in for the part of CUDA that the f32 kernels use
// (tfswa_tpu_torch/csrc/*_f32.cu, block_f32.cuh), so that their sources
// compile with g++ and run in a CPU test.  A launch runs the grid's blocks
// one after another on blockDim.x threads (std::thread); __syncthreads is
// a barrier of the block's threads, __shfl_xor_sync (float or double) an exchange through a
// warp's slots between two barriers of its 32 threads, __shared__ a static
// (one copy, shared by the threads of the block running).  The FP64 tensor
// core's mma.sync m16n8k4 (emu_mma_m16n8k4_f64) exchanges the warp's A and B
// fragments the same way and computes each lane's two C values at the PTX
// ISA's fragment layout; cp.async (emu_cp_async) is a plain copy, so its
// commit and wait are nothing; float4 and a double's word intrinsics are
// plain structs and copies.  Built with -DTFSWA_EMU -include _cuda_emu.h;
// emu_launch is in _cuda_emu.cpp.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
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
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct alignas(16) float4 {
    float x, y, z, w;
};

inline int __double2hiint(double d) {
    uint64_t u;
    std::memcpy(&u, &d, 8);
    return static_cast<int>(static_cast<uint32_t>(u >> 32));
}
inline double __hiloint2double(int hi, int lo) {
    const uint64_t u = (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
                       static_cast<uint32_t>(lo);
    double d;
    std::memcpy(&d, &u, 8);
    return d;
}

extern thread_local dim3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;
extern std::barrier<>* emu_block_barrier;
extern std::barrier<>* emu_warp_barrier[32];
extern double emu_lanes[32][32];
extern double emu_frags[32][32][3];

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

// c0..c3 += A (16 x 4) @ B (4 x 8) over the calling warp: lane l (g = l /
// 4, j = l % 4) holds a0 = A[g][j], a1 = A[g + 8][j], b = B[j][g], c0, c1 =
// C[g][2j + i] and c2, c3 = C[g + 8][2j + i]
// (mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64); each product an fma
// in k order.
inline void emu_mma_m16n8k4_f64(double& c0, double& c1, double& c2, double& c3, double a0,
                                double a1, double b) {
    const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
    emu_frags[w][lane][0] = a0;
    emu_frags[w][lane][1] = a1;
    emu_frags[w][lane][2] = b;
    emu_warp_barrier[w]->arrive_and_wait();
    const unsigned g = lane / 4, n = 2 * (lane % 4);
    for (unsigned k = 0; k < 4; ++k) {
        const double lo = emu_frags[w][g * 4 + k][0], hi = emu_frags[w][g * 4 + k][1];
        const double b0 = emu_frags[w][n * 4 + k][2], b1 = emu_frags[w][(n + 1) * 4 + k][2];
        c0 = std::fma(lo, b0, c0);
        c1 = std::fma(lo, b1, c1);
        c2 = std::fma(hi, b0, c2);
        c3 = std::fma(hi, b1, c3);
    }
    emu_warp_barrier[w]->arrive_and_wait();
}

// cp.async of `bytes` from src to dst, src_bytes of them read and the rest
// zero-filled (the PTX's src-size)
inline void emu_cp_async(void* dst, const void* src, int bytes, int src_bytes) {
    std::memset(dst, 0, bytes);
    if (src_bytes) std::memcpy(dst, src, src_bytes);
}

void emu_launch(dim3 grid, dim3 block, const std::function<void()>& kernel);

#define LAUNCH(kernel, grid, block, stream, ...) \
    emu_launch(dim3(grid), dim3(block), [&] { kernel(__VA_ARGS__); })
