// Bilinear row attention, forward, in float32, for Hopper (sm_90a): the
// f32 form of B4.
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/row_attention.py
// _attention_kernel_bilinear with compute_dtype = float32 (it computes in
// x_ref.dtype).  Per row of x (R, N, C), f32 in and out, with A (H, C, C)
// f64, A_h = Wq_h Wk_h^T / sqrt(D) (made outside from the f32 weights), Wv,
// Wo (C, C) and b (C):
//   v = x @ Wv
//   per head h: t = x @ A_h                      (N, C)
//               s[n, m] = t[n] . x[m]            all C lanes
//               p = exp(s - max_m s) / sum_m exp(s - max_m s)
//               acc[:, hD:(h+1)D] = sum_m p v[m, hD:(h+1)D]
//   out = acc @ Wo + b
//
// Arithmetic.  v, the p . v sums and the out-projection are f32 FFMA (see
// block_f32.cuh).  t, the scores and their running max are f64 (DFMA, half
// the FFMA rate): a score is a sum of C^2 terms and reaches the hundreds
// where the softmax is peaked, and an f32 score that large is off by tens
// of its ulp (3e-5 at 500), which exp turns into a relative error of p
// above the f32 limit (1e-4 of the output's max over 4); in f64 the error
// left is that of exp(s - max) rounded to f32, a few f32 ulp.
//
// Launches: gemm v = x @ Wv; per head, t_kernel t = x @ A_h (into an
// (R N, C) f64 scratch, or the head's columns of the exported (R N, H C) t)
// and attn_kernel; gemm out = acc @ Wo + b.  attn_kernel: G threads a
// query (G the power of two with 32 G >= C), each holding 32 of t's C
// values (zeros past C) and D / G of the head's D sums; a block of 256
// threads takes 256 / G queries of a row; the row's keys x and the head's
// v stream through shared memory up to 16 keys at a time (as many as fit
// 48 KB: 7 at C = 512 with one head).  A score is each thread's 32-lane dot product summed over its G
// threads (shuffles).  The softmax is online: per key tile the scores' max,
// the running sum and sums rescaled by exp(old max - new max), then
// exp(s - max) summed; the result is divided by the sum at the end (the
// same function as the normalised p, up to f32 rounding).  No (N, N) plane
// exists.
//
// What bounds it: t (2 H C^2 FLOPs a token) and the scores (2 C FLOPs a
// pair and head) at the DFMA rate; exp a pair and head.
#include "block_f32.cuh"

namespace f32 {
namespace {

constexpr int THREADS = 256;

// t (M, C) f64, leading dimension ldt, = x (M, C) f32 @ a_h (C, C) f64:
// gemm_kernel's tile in DFMA.  grid (ceil(M / 64), ceil(C / 64)), 256
// threads of 4 x 4 outputs.
__global__ void __launch_bounds__(GEMM_THREADS)
t_kernel(const float* __restrict__ x, const double* __restrict__ a, double* __restrict__ t,
         long ldt, long M, int C) {
    __shared__ double as[BK][BM + 1];
    __shared__ double bs[BK][BN + 1];
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const long m0 = (long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    double acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += BK) {
        {
            const int r = tid >> 2, kk = (tid & 3) * 4;
            const long m = m0 + r;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                as[kk + i][r] = m < M && k0 + kk + i < C ? (double)x[m * C + k0 + kk + i] : 0.0;
        }
        {
            const int kk = tid >> 4, c = (tid & 15) * 4;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + c + j;
                bs[kk][c + j] = n < C && k0 + kk < C ? a[(long)(k0 + kk) * C + n] : 0.0;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            double av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long m = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (m < M && n < C) t[m * ldt + n] = acc[i][j];
        }
    }
}

// acc_out[(r N + i) C + h D + ...] for head h.  t: the head's t (leading
// dimension ldt); grid R * q_tiles, THREADS threads.  G = 32 C' / 32 lanes
// a query, C' = C rounded up to 32 G (G a power of two: the shuffle tree
// of a score; t and x zero past C), each thread its own DG = ceil(D / G)
// of the head's D output channels.  VSW: the columns of v a key tile holds
// (16 G where H >= 2 and D fits, else 32 G); KT keys a tile, as many as
// keep the static shared memory under 48 KB, at most 16.
template <int G, int VSW>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const float* __restrict__ x, const double* __restrict__ t, long ldt,
            const float* __restrict__ v, float* __restrict__ acc_out, int N, int C, int H, int h,
            int q_tiles) {
    constexpr int KEY_BYTES = G * 33 * 8 + VSW * 4;    // a key's x (f64) and v (f32)
    constexpr int CP = 32 * G, QT = THREADS / G;
    constexpr int KT = 49152 / KEY_BYTES < 16 ? 49152 / KEY_BYTES : 16;
    constexpr int DGM = VSW / G;             // a thread's output channels at most
    __shared__ double xs[KT][G][33];         // f64 once a key; padded per thread
    __shared__ float vs[KT][VSW];            // the head's D columns of v
    const int D = C / H, DG = (D + G - 1) / G;
    const int r = blockIdx.x / q_tiles;
    const int i = (blockIdx.x % q_tiles) * QT + threadIdx.x / G;
    const int g = threadIdx.x % G;
    const long row0 = (long)r * N;
    const bool live = i < N;
    double tq[32];
    float acc[DGM];
#pragma unroll
    for (int c = 0; c < 32; ++c)
        tq[c] = live && g * 32 + c < C ? t[(row0 + i) * ldt + g * 32 + c] : 0.0;
#pragma unroll
    for (int dd = 0; dd < DGM; ++dd) acc[dd] = 0.0f;
    double mx = -INFINITY;
    float sum = 0.0f;
    for (int j0 = 0; j0 < N; j0 += KT) {
        const int nk = N - j0 < KT ? N - j0 : KT;
        for (int e = threadIdx.x; e < nk * CP; e += THREADS) {
            const int j = e / CP, c = e % CP;
            xs[j][c / 32][c % 32] = c < C ? (double)x[(row0 + j0 + j) * C + c] : 0.0;
        }
        for (int e = threadIdx.x; e < nk * D; e += THREADS) {
            const int j = e / D, d = e % D;
            vs[j][d] = v[(row0 + j0 + j) * C + h * D + d];
        }
        __syncthreads();
        double s[KT];
        double tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            if (j < nk) {
                double part = 0.0;
#pragma unroll
                for (int c = 0; c < 32; ++c) part = fma(tq[c], xs[j][g][c], part);
                for (int o = 1; o < G; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
                s[j] = part;
                tile_max = fmax(tile_max, part);
            }
        }
        const double new_max = fmax(mx, tile_max);
        const float rescale = expf((float)(mx - new_max));
        sum *= rescale;
#pragma unroll
        for (int dd = 0; dd < DGM; ++dd) acc[dd] *= rescale;
        mx = new_max;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
            if (j < nk) {
                const float e = expf((float)(s[j] - mx));
                sum += e;
#pragma unroll
                for (int dd = 0; dd < DGM; ++dd)
                    if (dd < DG && g * DG + dd < D) acc[dd] = fmaf(e, vs[j][g * DG + dd], acc[dd]);
            }
        }
        __syncthreads();
    }
    if (live) {
#pragma unroll
        for (int dd = 0; dd < DGM; ++dd)
            if (dd < DG && g * DG + dd < D)
                acc_out[(row0 + i) * C + h * D + g * DG + dd] = acc[dd] / sum;
    }
}

template <int G, int VSW>
void launch_attn(const float* x, const double* t, long ldt, const float* v, float* acc, int R,
                 int N, int C, int H, int h, cudaStream_t st) {
    const int q_tiles = (N + THREADS / G - 1) / (THREADS / G);
    auto kernel = attn_kernel<G, VSW>;
    LAUNCH(kernel, (unsigned)((long)R * q_tiles), THREADS, st, x, t, ldt, v, acc, N, C, H, h,
           q_tiles);
}

// attn_kernel at C, H: G the power of two with 32 G >= C, VSW 16 G where
// the head's D columns fit (H >= 2), else 32 G.
template <int G>
void launch_attn_g(const float* x, const double* t, long ldt, const float* v, float* acc, int R,
                   int N, int C, int H, int h, cudaStream_t st) {
    if (C / H <= 16 * G)
        launch_attn<G, 16 * G>(x, t, ldt, v, acc, R, N, C, H, h, st);
    else
        launch_attn<G, 32 * G>(x, t, ldt, v, acc, R, N, C, H, h, st);
}

int forward(const float* x, const double* a, const float* wv, const float* wo,
            const float* bias, float* v, float* acc, float* out, double* t, int t_all_heads,
            int R, int N, int C, int H, cudaStream_t st) {
    const long M = (long)R * N;
    gemm(plain_a(x, C), wv, C, v, C, M, C, C, epi(), st);
    const int ldt = t_all_heads ? H * C : C;
    for (int h = 0; h < H; ++h) {
        double* th = t_all_heads ? t + (long)h * C : t;
        LAUNCH(t_kernel, dim3((unsigned)((M + BM - 1) / BM), (unsigned)((C + BN - 1) / BN)),
               GEMM_THREADS, st, x, a + (long)h * C * C, th, ldt, M, C);
        if (C <= 32) launch_attn_g<1>(x, th, ldt, v, acc, R, N, C, H, h, st);
        else if (C <= 64) launch_attn_g<2>(x, th, ldt, v, acc, R, N, C, H, h, st);
        else if (C <= 128) launch_attn_g<4>(x, th, ldt, v, acc, R, N, C, H, h, st);
        else if (C <= 256) launch_attn_g<8>(x, th, ldt, v, acc, R, N, C, H, h, st);
        else launch_attn_g<16>(x, th, ldt, v, acc, R, N, C, H, h, st);
    }
    gemm(plain_a(acc, C), wo, C, out, C, M, C, C, epi(EPI_NONE, bias), st);
    return cudaGetLastError();
}

}  // namespace
}  // namespace f32

// out, acc (the attention output before the out-projection) and v, all
// (R N, C) f32; a (H, C, C) f64; t, f64: with t_all_heads, the exported
// (R N, H C) t of every head, else an (R N, C) scratch.  C a multiple of 8
// up to 512, H dividing it.  Returns a CUDA error code.
extern "C" int row_attention_forward_f32(const float* x, const double* a, const float* wv,
                                         const float* wo, const float* bias, float* v,
                                         float* acc, float* out, double* t, int t_all_heads,
                                         int R, int N, int C, int H, void* stream) {
    if (R <= 0 || N <= 0 || H <= 0 || C <= 0 || C % 8 || C > 512 || C % H || !t)
        return cudaErrorInvalidValue;
    return f32::forward(x, a, wv, wo, bias, v, acc, out, t, t_all_heads, R, N, C, H,
                        static_cast<cudaStream_t>(stream));
}
