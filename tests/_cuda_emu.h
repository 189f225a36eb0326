// A CPU stand-in for the part of CUDA that the f32 kernels use
// (tfswa_tpu_torch/csrc/*_f32.cu, block_f32.cuh), so that their sources
// compile with g++ and run in a CPU test.  A launch runs the grid's blocks
// one after another, each block's blockDim.x threads as fibers of the
// calling thread (ucontext), switched in turn where one waits at a
// barrier: so a test's process runs one kernel thread at a time, whatever
// the machine's load.  __syncthreads is a barrier of the block's threads,
// __shfl_xor_sync (float or double) an exchange through a warp's slots
// between two barriers of its 32 threads, __shared__ a static (one copy,
// shared by the threads of the block running).  The tensor
// cores' mma.sync forms exchange the warp's A and B fragments the same way
// (emu_mma_m16n8k4_f64 between two barriers; emu_mma_m16n8k8_tf32 and
// emu_mma_m16n8k32_s8 through emu_exchange, one barrier and two sets of
// slots in turn) and compute each lane's C values at the PTX ISA's
// fragment layout;
// cp.async (emu_cp_async) is a plain copy, so its commit and wait are
// nothing; float4, a float's and a double's word intrinsics are plain
// structs and copies.  Built with -DTFSWA_EMU -include _cuda_emu.h;
// emu_launch is in _cuda_emu.cpp.
#pragma once
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

inline unsigned __float_as_uint(float f) {
    unsigned u;
    std::memcpy(&u, &f, 4);
    return u;
}
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

extern dim3 threadIdx, blockIdx;              // the running fiber's
extern dim3 gridDim, blockDim;

// Switch to the block's next fiber that has not finished.
void emu_yield();

// A barrier of `count` fibers: the last to arrive opens it.
struct EmuBarrier {
    unsigned count, arrived, generation;

    void arrive_and_wait() {
        const unsigned g = generation;
        if (++arrived == count) {
            arrived = 0;
            ++generation;
            return;
        }
        while (generation == g) emu_yield();
    }
};

extern EmuBarrier emu_block_barrier;
extern EmuBarrier emu_warp_barrier[32];
extern double emu_lanes[32][32];
extern double emu_frags[32][32][3];
extern uint32_t emu_words[2][32][32][6];
extern unsigned emu_word_set[1024];       // each fiber's slot set

inline void __syncthreads() { emu_block_barrier.arrive_and_wait(); }

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
    const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
    emu_lanes[w][lane] = v;
    emu_warp_barrier[w].arrive_and_wait();
    const T r = static_cast<T>(emu_lanes[w][lane ^ mask]);
    emu_warp_barrier[w].arrive_and_wait();
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
    emu_warp_barrier[w].arrive_and_wait();
    const unsigned g = lane / 4, n = 2 * (lane % 4);
    for (unsigned k = 0; k < 4; ++k) {
        const double lo = emu_frags[w][g * 4 + k][0], hi = emu_frags[w][g * 4 + k][1];
        const double b0 = emu_frags[w][n * 4 + k][2], b1 = emu_frags[w][(n + 1) * 4 + k][2];
        c0 = std::fma(lo, b0, c0);
        c1 = std::fma(lo, b1, c1);
        c2 = std::fma(hi, b0, c2);
        c3 = std::fma(hi, b1, c3);
    }
    emu_warp_barrier[w].arrive_and_wait();
}

// The calling warp's 32 lanes' fragment words (a0..a3, b0, b1), each
// lane's written to a set of slots and all read after one barrier.  Two
// sets alternate: a set is written again two exchanges later, after the
// lanes have passed the barrier of the exchange between, so after each has
// read it.
inline const uint32_t (*emu_exchange(const uint32_t (&a)[4], const uint32_t (&b)[2]))[6] {
    const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
    uint32_t (*set)[6] = emu_words[emu_word_set[threadIdx.x] ^= 1u][w];
    for (int i = 0; i < 4; ++i) set[lane][i] = a[i];
    set[lane][4] = b[0];
    set[lane][5] = b[1];
    emu_warp_barrier[w].arrive_and_wait();
    return set;
}

// d0..d3 += A (16 x 8) @ B (8 x 8) over the calling warp, TF32 operands
// (the low 13 bits of each ignored, as the card does): lane l (g = l / 4,
// t = l % 4) holds a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 =
// A[g + 8][t + 4], b0 = B[t][g], b1 = B[t + 4][g], d0, d1 = C[g][2t + i]
// and d2, d3 = C[g + 8][2t + i]
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32); each product exact
// in f32 (11 x 11 significant bits), summed in k order with f32 rounding.
inline void emu_mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    const uint32_t (*x)[6] = emu_exchange(a, b);
    const unsigned g = threadIdx.x % 32 / 4, n = 2 * (threadIdx.x % 4);
    auto tf = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
    for (int e = 0; e < 4; ++e) {
        const unsigned row = g + 8 * (e >> 1), col = n + (e & 1);
        float acc = d[e];
        for (unsigned k = 0; k < 8; ++k) {
            const float av = tf(x[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)]);
            const float bv = tf(x[col * 4 + k % 4][4 + (k >= 4)]);
            acc = std::fma(av, bv, acc);
        }
        d[e] = acc;
    }
}

// d0..d3 += A (16 x 32) @ B (32 x 8), int8 operands, exact int32 sums, over
// the calling warp: lane l (g = l / 4, t = l % 4) holds in a0 the bytes
// A[g][4t + i], a1 A[g + 8][4t + i], a2 A[g][16 + 4t + i], a3 A[g + 8][16 +
// 4t + i], b0 B[4t + i][g], b1 B[16 + 4t + i][g] (byte i of each word), and
// d as the TF32 form (mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32).
inline void emu_mma_m16n8k32_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    const uint32_t (*x)[6] = emu_exchange(a, b);
    const unsigned g = threadIdx.x % 32 / 4, n = 2 * (threadIdx.x % 4);
    auto byte = [](uint32_t u, unsigned i) { return (int)(int8_t)((u >> (8 * i)) & 0xffu); };
    for (int e = 0; e < 4; ++e) {
        const unsigned row = g + 8 * (e >> 1), col = n + (e & 1);
        int acc = d[e];
        for (unsigned k = 0; k < 32; ++k) {
            const unsigned q = (k % 16) / 4, hi = k >= 16;
            acc += byte(x[(row % 8) * 4 + q][(row >= 8) + 2 * hi], k % 4) *
                   byte(x[col * 4 + q][4 + hi], k % 4);
        }
        d[e] = acc;
    }
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
