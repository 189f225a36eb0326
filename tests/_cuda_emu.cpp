// emu_launch of _cuda_emu.h: the grid's blocks one after another, each
// block's threads as fibers of the calling thread (ucontext), run from the
// first until one waits at a barrier (emu_yield: on to the next fiber not
// finished, in turn) or finishes (back to the launch, which resumes the
// next); a block ends when every fiber has finished (a block's shared
// memory is reused by the next).
#include <ucontext.h>

#include <vector>

#include "_cuda_emu.h"

dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
EmuBarrier emu_block_barrier;
EmuBarrier emu_warp_barrier[32];
double emu_lanes[32][32];
double emu_frags[32][32][3];
uint32_t emu_words[2][32][32][6];
unsigned emu_word_set[1024];

namespace {

constexpr size_t STACK_BYTES = 256 << 10;

struct Fiber {
    ucontext_t context;
    std::vector<char> stack = std::vector<char>(STACK_BYTES);
    bool done;
};

std::vector<Fiber> fibers;
ucontext_t launcher;
unsigned current;
const std::function<void()>* body;

void run_fiber() {
    (*body)();
    fibers[current].done = true;                // returns to the launcher (uc_link)
}

unsigned next_live(unsigned from) {
    unsigned to = from;
    do to = (to + 1) % blockDim.x;
    while (fibers[to].done && to != from);
    return to;
}

}  // namespace

void emu_yield() {
    const unsigned from = current, to = next_live(from);
    if (to == from) return;
    current = to;
    threadIdx = dim3(to);
    swapcontext(&fibers[from].context, &fibers[to].context);
}

void emu_launch(dim3 grid, dim3 block, const std::function<void()>& kernel) {
    const unsigned n = block.x;           // the kernels use 1-d blocks of whole warps
    gridDim = grid;
    blockDim = block;
    body = &kernel;
    if (fibers.size() < n) fibers.resize(n);
    for (unsigned t = 0; t < n; ++t) emu_word_set[t] = 0;
    for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
                blockIdx = dim3(x, y, z);
                emu_block_barrier = EmuBarrier{n, 0, 0};
                for (unsigned w = 0; w < n / 32; ++w) emu_warp_barrier[w] = EmuBarrier{32, 0, 0};
                for (unsigned t = 0; t < n; ++t) {
                    Fiber& f = fibers[t];
                    getcontext(&f.context);
                    f.context.uc_stack.ss_sp = f.stack.data();
                    f.context.uc_stack.ss_size = f.stack.size();
                    f.context.uc_link = &launcher;
                    makecontext(&f.context, run_fiber, 0);
                    f.done = false;
                }
                unsigned live = n;
                current = 0;
                while (live > 0) {
                    threadIdx = dim3(current);
                    swapcontext(&launcher, &fibers[current].context);
                    --live;                         // a fiber finished
                    current = next_live(current);
                }
            }
}
