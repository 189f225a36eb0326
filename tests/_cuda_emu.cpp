// emu_launch of _cuda_emu.h: blockDim.x threads walk the grid's blocks in
// order, with a barrier of all of them after each block (a block's shared
// memory is reused by the next).
#include <thread>
#include <vector>

#include "_cuda_emu.h"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
std::barrier<>* emu_block_barrier;
std::barrier<>* emu_warp_barrier[32];
double emu_lanes[32][32];
double emu_frags[32][32][3];

void emu_launch(dim3 grid, dim3 block, const std::function<void()>& kernel) {
    const unsigned n = block.x;           // the kernels use 1-d blocks of whole warps
    gridDim = grid;
    blockDim = block;
    std::barrier<> block_barrier(n);
    emu_block_barrier = &block_barrier;
    for (unsigned w = 0; w < n / 32; ++w) emu_warp_barrier[w] = new std::barrier<>(32);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n; ++t) {
        threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            for (unsigned z = 0; z < grid.z; ++z)
                for (unsigned y = 0; y < grid.y; ++y)
                    for (unsigned x = 0; x < grid.x; ++x) {
                        blockIdx = dim3(x, y, z);
                        kernel();
                        block_barrier.arrive_and_wait();
                    }
        });
    }
    for (auto& th : threads) th.join();
    for (unsigned w = 0; w < n / 32; ++w) delete emu_warp_barrier[w];
}
