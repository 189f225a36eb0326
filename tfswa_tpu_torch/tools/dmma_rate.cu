// The FP64 tensor cores' rate on the card, by mma.sync shape: each warp
// issues four independent chains of register-only f64 mma.sync, and the
// rate is their FLOPs over the launch's device time (CUDA events), at 2, 4
// and 8 blocks of 4 warps an SM.  It is the yardstick behind B4's f32 form
// (csrc/row_attention_f32.cu) taking m16n8k4 over m8n8k4, and behind the
// 67 TFLOP/s of chip_smoke.py's PEAK_F64_TC_FLOPS.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/dmma_rate \
//       tfswa_tpu_torch/tools/dmma_rate.cu && build/dmma_rate
//
// Prints one line a shape and occupancy: ms and TFLOP/s.  Exits 1 if the
// card refuses a launch.
#include <cstdio>
#include <cuda_runtime.h>

constexpr int THREADS = 128, ITERS = 20000, CHAINS = 4;

// SHAPE 0: m8n8k4, 1: m16n8k4, 2: m16n8k8, 3: m16n8k16 (the last three sm_90)
template <int SHAPE>
__global__ void mma_chains(double* out, int iters) {
    double a[8], b[4], c[CHAINS][4];
    for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
    for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
    for (int ch = 0; ch < CHAINS; ++ch)
        for (int i = 0; i < 4; ++i) c[ch][i] = 0.0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
            if (SHAPE == 0)
                asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
                             "{%3}, {%0, %1};"
                             : "+d"(c[ch][0]), "+d"(c[ch][1])
                             : "d"(a[0]), "d"(b[0]));
            else if (SHAPE == 1)
                asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                             "{%4, %5}, {%6}, {%0, %1, %2, %3};"
                             : "+d"(c[ch][0]), "+d"(c[ch][1]), "+d"(c[ch][2]), "+d"(c[ch][3])
                             : "d"(a[0]), "d"(a[1]), "d"(b[0]));
            else if (SHAPE == 2)
                asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                             "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                             : "+d"(c[ch][0]), "+d"(c[ch][1]), "+d"(c[ch][2]), "+d"(c[ch][3])
                             : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
            else
                asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                             "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
                             "{%0, %1, %2, %3};"
                             : "+d"(c[ch][0]), "+d"(c[ch][1]), "+d"(c[ch][2]), "+d"(c[ch][3])
                             : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                               "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
        }
    }
    double s = 0.0;                       // keep the chains live
    for (int ch = 0; ch < CHAINS; ++ch)
        for (int i = 0; i < 4; ++i) s += c[ch][i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int SHAPE>
bool run(const char* name, double flops_per_mma, int blocks_per_sm) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    const int blocks = sms * blocks_per_sm;
    double* out = nullptr;
    if (cudaMalloc(&out, sizeof(double) * blocks * THREADS) != cudaSuccess) return false;
    mma_chains<SHAPE><<<blocks, THREADS>>>(out, 10);       // warm-up
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    mma_chains<SHAPE><<<blocks, THREADS>>>(out, ITERS);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    const cudaError_t err = cudaGetLastError();
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double mmas = (double)blocks * (THREADS / 32) * ITERS * CHAINS;
    std::printf("%-9s %d blocks an SM: %.3f ms, %.1f TFLOP/s (%s)\n", name, blocks_per_sm, ms,
                mmas * flops_per_mma / (ms * 1e-3) / 1e12, cudaGetErrorString(err));
    cudaFree(out);
    return err == cudaSuccess;
}

int main() {
    bool ok = true;
    for (int bps : {2, 4, 8}) {
        ok &= run<0>("m8n8k4", 2.0 * 8 * 8 * 4, bps);
        ok &= run<1>("m16n8k4", 2.0 * 16 * 8 * 4, bps);
        ok &= run<2>("m16n8k8", 2.0 * 16 * 8 * 8, bps);
        ok &= run<3>("m16n8k16", 2.0 * 16 * 8 * 16, bps);
    }
    return ok ? 0 : 1;
}
