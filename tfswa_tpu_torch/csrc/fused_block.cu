// Fused pre-LN row transformer block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tfswa_tpu/ops/pallas/fused_block.py
// _fused_block_kernel (no mask, no dropout), reached through fused_row_block,
// in its two forms: serving (B1) and training (B1-train, with_mid=True,
// which also exports mid = bf16(y) and the per-head denominators den; the
// attention output acc is written in both forms); and its int8-score
// serving form (B3, int8_attn=True, reached through fused_row_block_int8).
// Per row of rows (R, N, C), bf16 in and out:
//   n1  = bf16(LN1(x))                      f32 statistics, eps 1e-5
//   q,k,v = bf16(n1 @ Wq'), bf16(n1 @ Wk), bf16(n1 @ Wv)
//                                           Wq' = Wq * log2(e)/sqrt(D), in bf16
//   per head: p = bf16(exp2(min(q.k, 110)))  max-free softmax, SCORE_CLAMP
//             acc = (sum p v) / (sum p)      both sums in f32
//   y   = x + (bf16(acc) @ Wo + bo)          f32
//   out = bf16(y + (bf16(gelu(bf16(LN2(y)) @ W1 + b1)) @ W2 + b2))
// The bf16 rounding points are the TPU kernel's: p is rounded to bf16
// before the AV sum and the denominator is the sum of the rounded p, as
// the TPU's appended ones row gives it.
//
// B3 replaces the score q.k by (qi.ki) * (sq * sk): sq = max|q| / 127 over
// the row's N*C values of q (all heads), the same for k, in f32;
// qi = rint(q / sq) as int8 (a true division, rounded half to even; 0 where
// the scale is 0); the int8 dot product summed exactly in int32 (the
// tensor cores' m16n8k32 int8 product).
// v is not quantised: the TPU kernel's int8_av is False, and p, the AV
// sums and the denominator stay as in B1.  The build must not use
// --use_fast_math: the division and the rounding have to give the plain
// version's int8 values bit for bit.
//
// Design.  Three launches (B3: four), every product on the tensor cores
// (mma.sync, the tile of block_common.cuh):
//   1. ln_qkv_kernel (block_common.cuh): LN1 prologue + the qkv product, 64
//                      tokens a block;
//  (B3) qk_scale_kernel: one block per row reduces max|q| and max|k| over
//                      the row's N*C values into an (R, 2) f32 buffer;
//  (N > 64; B3 always) k_norm_kernel: one block per row, the row's largest
//                      |k_h| per head, the bound of the attention's exp2
//                      fast path (B3: and the row's k quantised to int8);
//   2. attn_kernel:    one block per (row, 128 queries), the heads in passes
//                      of 32 channels, the keys streamed through shared
//                      memory for all the pass's heads: scores and P V
//                      (with the denominator as a ones column) on mma, the
//                      score -> p line in registers (see the kernel).  No
//                      (N, N) score or probability plane exists anywhere;
//   3. post_kernel:    out-projection + bias + residual + LN2 + fc1 + erf
//                      GELU + fc2 + bias + residual, 64 tokens a block, the
//                      MLP chunked over the hidden width so that its
//                      4C-wide activation never leaves the block (see the
//                      kernel).
// The A operands of launches 1 and 3 are the bf16 values the function
// rounds (n1, acc, n2, the GELU output), held in shared memory; each weight
// streams through shared memory in k-slices of 32 rows (cp.async, two
// buffers), since at C = 256 W_qkv (384 KB) and fc1 (512 KB) do not fit.
// The residual y stays f32 in shared memory and fc2's sums stay in
// registers across the hidden chunks.
//
// What bounds it on the H100.  The attention at stage 0 has D = 4: its
// scores and AV are a few percent of the tensor cores' rate, and the
// function's floor is exp2, H N^2 a row at 16 a clock an SM on the MUFU
// (about 125 ms a serving forward, 105 of it at stage 0).  With the
// products on mma a (query, key) pair costs on the CUDA cores the clamp,
// the exp2 (one MUFU op; its range fix-up only where a score can fall
// under -126) and half a packed bf16 convert, so the line is meant to be
// MUFU-bound (B3 adds an int -> f32 convert and the scale's multiply).  The products (launches 1 and 3, about 9 C^2 MACs on about
// 6 C bytes a token) sit below the card's 295 FLOP a byte up to C = 64,
// where bytes bound them.  The split into three launches costs extra
// device-memory bytes over one fused kernel: q, k, v and the attention
// output make a round trip, about 16*C bytes a token (~0.5 KB at C = 32;
// ~3.6 GB, ~1 ms at 3.35 TB/s, at stage-0 TSA with 7 M tokens).
//
// The training form and B3 are the same code instantiated with template
// flags, so the serving form's instructions are unchanged.
//
// The kernel lab (L; replaces tools/kernel_lab.py _kernel_prod and its stage
// and flag forms, launched there by _call_kernel) is B1 cut at a stage or
// with one step of its score -> p line changed, also by template
// parameters of B1's own kernels, so that what it times is B1
// (fused_block_lab_forward; ops/lab_block.py has the function of each
// form).  Stage qkv adds q + k + v (qkv_sum_kernel); scores, exp2 and av
// run attn_kernel up to that step; attn runs post_kernel's attention half
// only.  A cut stage keeps only part of its work in its output (scores:
// min(C, N) keys, exp2: D queries), so each thread folds what it computed
// into a checksum, one f32 a warp written to a sink buffer outside the
// output: nvcc cannot drop the work and the time measures it.  The scores
// stage's output, a sum over heads (over blocks), comes from a small
// launch of its own (kept_scores_kernel: the dot product over all C lanes
// is that sum, a small product per row) rather than from per-head partial
// scores, whose scratch (R*H*N*min(C, N) f32, 7.2 GB at a stage-0 shape)
// cost more than the scores themselves.  The av stage sums over query blocks: each block
// writes its sums to scratch and a second launch adds them in a fixed
// order (av_sum_kernel), no atomics, so two runs give the same bits.  The
// flags: SCORE_BF16 takes p from the clamped score
// rounded to bf16 as the JAX package computes exp2 of a bf16 value (XLA
// lowers it as exp(bf16(x * bf16(ln 2)))), P_F32 leaves p unrounded into AV
// and the denominator, NO_CLAMP drops the clamp.
//
// Interface: plain C, loaded with ctypes.  Each launch goes on the caller's
// stream; the function returns the first non-zero cudaGetLastError().

#include <algorithm>

#include "block_common.cuh"

namespace {

// The lab's stages (ops/lab_block.py STAGES) and flag bits.
enum : int { STAGE_QKV, STAGE_SCORES, STAGE_EXP2, STAGE_AV, STAGE_ATTN, STAGE_FULL };
enum : int { SCORE_BF16 = 1, P_F32 = 2, NO_CLAMP = 4 };
constexpr float LN2_BF16 = 0.69140625f;   // ln 2 rounded to bf16

// B3: q / s rounded half to even (rintf), as an int; 0 where s is 0.
__device__ __forceinline__ int quant_i8(float x, float s) {
    return s > 0.f ? (int)rintf(x / s) : 0;
}

// Four int8 values in one word, the first in the lowest byte (the order of
// an int8 array in memory, and of the int8 mma's k).
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
    return (int)((unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
                 ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24));
}

// |x|^2 of the two bf16 in a 32-bit word
__device__ __forceinline__ float sq_bf16x2(uint32_t w) {
    const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
    return lo * lo + hi * hi;
}

// B3: the per-row scales of q and k, max|.| / 127 over the row's N*C values
// of each, into scales (R, 2).  One block per row.
constexpr int SCALE_THREADS = 256;
__global__ void __launch_bounds__(SCALE_THREADS)
qk_scale_kernel(const bf16* __restrict__ qkv, float* __restrict__ scales, int N, int C) {
    __shared__ float red[2][SCALE_THREADS / 32];
    const size_t row0 = (size_t)blockIdx.x * N;
    const int ldq = 3 * C;
    float mq = 0.f, mk = 0.f;
    for (int i = threadIdx.x; i < N * C; i += SCALE_THREADS) {
        const bf16* p = qkv + (row0 + i / C) * ldq + i % C;
        mq = fmaxf(mq, fabsf(ld(p)));
        mk = fmaxf(mk, fabsf(ld(p + C)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
        mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, o));
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[0][warp] = mq;
        red[1][warp] = mk;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < SCALE_THREADS / 32; ++w) {
            mq = fmaxf(mq, red[0][w]);
            mk = fmaxf(mk, red[1][w]);
        }
        scales[2 * blockIdx.x] = mq / 127.0f;
        scales[2 * blockIdx.x + 1] = mk / 127.0f;
    }
}

// The row bound of attn_kernel's exp2 fast path: per row and head the
// largest |k_h| over the row's N keys, into kmax (R, H) f32.  INT8 (B3)
// also quantises the row's k with its scale (scales (R, 2)) into the k
// half of qk (R*N, 2C) int8, as 32-bit words: once a row, for every query
// block of the attention.  One block per row; each thread keeps one head
// (NORM_THREADS is a multiple of H).
constexpr int NORM_THREADS = 256;
template <bool INT8>
__global__ void __launch_bounds__(NORM_THREADS)
k_norm_kernel(const bf16* __restrict__ qkv, float* __restrict__ kmax,
              const float* __restrict__ scales, int* __restrict__ qk, int N, int C, int H) {
    __shared__ float red[NORM_THREADS];
    const int D = C / H, h = threadIdx.x % H, step = NORM_THREADS / H;
    const size_t row0 = (size_t)blockIdx.x * N;
    const bf16* kcol = qkv + row0 * 3 * C + C + h * D;
    const float sk = INT8 ? scales[2 * blockIdx.x + 1] : 0.f;
    float km = 0.f;
    for (int j = threadIdx.x / H; j < N; j += step) {
        const bf16* kp = kcol + (size_t)j * 3 * C;
        float k2 = 0.f;
        for (int d = 0; d < D; d += 4) {
            const uint2 w = *reinterpret_cast<const uint2*>(kp + d);
            k2 += sq_bf16x2(w.x) + sq_bf16x2(w.y);
            if constexpr (INT8)
                qk[((row0 + j) * 2 * C + C + h * D + d) / 4] =
                    pack4(quant_i8(__uint_as_float(w.x << 16), sk),
                          quant_i8(__uint_as_float(w.x & 0xffff0000u), sk),
                          quant_i8(__uint_as_float(w.y << 16), sk),
                          quant_i8(__uint_as_float(w.y & 0xffff0000u), sk));
        }
        km = fmaxf(km, k2);
    }
    red[threadIdx.x] = km;
    __syncthreads();
    if (threadIdx.x < H) {
        for (int t = threadIdx.x + H; t < NORM_THREADS; t += H) km = fmaxf(km, red[t]);
        kmax[(size_t)blockIdx.x * H + threadIdx.x] = sqrtf(km);
    }
}

// 2. Attention on the tensor cores.  One block per (row, 16 NW queries),
// NW warps (8 where N > 64, else 4); warp w owns the queries q0 + 16 w ..
// + 15.  The heads go in passes of AT_LANES = 32 channels (32 / D heads a
// pass, C / 32 passes); in a pass the block streams the row's keys through
// shared memory in tiles of AK keys (128 where N > 64, else 64): the
// pass's 32 channels of k and of v, whole 16-byte rows (at D = 4 a head's
// k is 8 bytes a key, under what cp.async and ldmatrix move), double
// buffered with cp.async, so that each tile serves every head of the pass
// and all the block's queries.  Per 16 keys and head h, in registers:
//   - the scores of the warp's 16 queries on mma (m16n8k16, K = 16
//     channels spanning 16 / D heads): q's A fragment with the channels
//     outside head h zeroed, so that the sum over the 16 channels is head
//     h's f32 score (the TPU kernel masks the same way); D = 16 takes one
//     k step, D = 32 two.  INT8: the int8 q and k on m16n8k32 (K = the
//     pass's 32 channels, q's bytes outside head h zeroed), exact int32
//     sums times sq * sk;
//   - p = bf16(exp2(min(s, SCORE_CLAMP))) (exp2_line), rounded and packed
//     by cvt.rn.bf16x2 straight into the A fragment of P V (pack_a): no p
//     goes to shared memory.  exp2 is exp2f's (ex2.approx, subnormal
//     results kept); its range fix-up (an FSETP and two predicated FMUL a
//     score) is skipped where no score can fall below -126, by |s| <=
//     |q_h| |k_h| with the warp's largest |q_h| and the row's largest
//     |k_h| (k_norm_kernel, rows of more than 64 keys); elsewhere each
//     chunk's scores are tested and the fix-up runs only where one is
//     below -126;
//   - P V and the denominator on mma: the B fragment is head h's v columns
//     plus a ones column built in registers, so sum_k p_k * 1 is the f32
//     sum of the rounded p, as the TPU kernel's appended ones row gives
//     it.  At D = 4 one n-tile holds the head's 4 v columns, the ones
//     column and 3 zeros (its neighbour head's columns replaced in
//     registers); at D >= 8 the ones column is an n-tile of its own.
// Keys past N are zero-filled and their scores set to -inf before the
// exp2 (p = 0: a zero key alone would give s = 0, p = 1 and add 1 to the
// denominator); 16-key chunks wholly past N are skipped; queries past N
// compute on zeros and write nothing.
// WITH_DEN also writes den (R, H, N), the f32 sum of the rounded p.
// INT8 (B3) takes int8 scores with the row scales in scales (R, 2) and
// the int8 q | k in qk_out, (R*N, 2C) int8 as 32-bit words: k quantised
// once a row by k_norm_kernel<true> and streamed from there as int8 key
// tiles, q quantised here once a pass into its A fragments and written
// back; both with a true division and rintf.
// The lab: STAGE cuts the attention after the scores (all kept in the
// checksum only), after p (packed to bf16 pairs as P V takes them, their
// bits in the checksum; out is then the final (R, N, C) output: p of
// queries n < D at [r, key, h*D + n]) or after the AV sums (acc / den
// summed over the block's queries to lab, (R*H*nqb, D) f32, over the
// warps in order); FLAGS change the score -> p line.  Every form runs its
// products on the tensor cores; P_F32, which has no bf16 p, splits p into
// its bf16 hi and the bf16 of p - hi and runs P V twice (hi + lo carries p
// to about 2^-17 of itself).
constexpr int AT_LANES = 32;                  // channels a pass
constexpr int AT_LD = 2 * AT_LANES + 8;       // bf16 a staged key row: k | v | padding
constexpr int AT_LD8 = AT_LANES + 16;         // bytes a row of the int8 key tile
constexpr int AT_MAX_WARPS = 8;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

size_t attn_smem_bytes(int ak) {
    return sizeof(bf16) * 2 * (size_t)ak * AT_LD + 2 * (size_t)ak * AT_LD8
           + sizeof(float) * AT_MAX_WARPS * AT_LANES;
}

// |q_h| |k_h| at most this: no score of the head can be below -126 (with
// room for the f32 sums' rounding)
constexpr float SAFE_BOUND = 120.0f;

// The score -> p line of the warp's 16 queries x 16 keys (two
// accumulators of 8 keys), in place: the f32 value that p's bf16 rounding
// takes (SCORE_BF16: already rounded).  Keys from nvalid on (of the 16)
// get p = 0.  exp2 is exp2f's: ex2.approx, whose results under 2^-126 are
// kept (subnormal).  The flushing form gives the same bits with no range
// fix-up where no score is below -126: so where ``safe`` (a bound on the
// head's |q| |k| says no score can be) it runs alone, else the warp's
// scores are tested and the fix-up runs only for chunks that need it.
template <int FLAGS>
__device__ __forceinline__ void exp2_line(float (&s)[2][4], int nvalid, bool safe) {
    const int q = threadIdx.x & 3;
    if ((FLAGS & NO_CLAMP) == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = fminf(s[j][e], SCORE_CLAMP);
    }
    float lo = INFINITY;
    if (!safe) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) lo = fminf(lo, s[j][e]);
    }
    if (nvalid < 16) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (8 * j + 2 * q + (e & 1) >= nvalid) s[j][e] = -INFINITY;
    }
    if constexpr ((FLAGS & SCORE_BF16) != 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[j][e] = round_bf16(expf(round_bf16(round_bf16(s[j][e]) * LN2_BF16)));
    } else if (!safe && __any_sync(0xffffffffu, lo < -126.0f)) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e]);
    } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = ex2_ftz(s[j][e]);
    }
}

template <int D, bool WITH_DEN, bool INT8, int STAGE = STAGE_FULL, int FLAGS = 0>
__global__ void __launch_bounds__(32 * AT_MAX_WARPS, 3)
attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ kmax,
            bf16* __restrict__ out, float* __restrict__ den_out,
            const float* __restrict__ scales, int* __restrict__ qk_out, int N, int C, int H,
            int nqb, int ak, float* __restrict__ lab, float* __restrict__ sink) {
    static_assert(STAGE == STAGE_FULL || (!WITH_DEN && !INT8 && FLAGS == 0),
                  "the lab cuts B1's serving form, flags only on the full attention");
    static_assert(D == 4 || D == 8 || D == 16 || D == 32, "head dim");
    constexpr int HP = AT_LANES / D;             // heads a pass
    constexpr int VT = D < 8 ? 1 : D / 8;        // n-tiles of a head's v
    constexpr int OT = D < 8 ? 1 : VT + 1;       // ... with its ones column
    constexpr bool SPLIT = (FLAGS & P_F32) != 0 && (FLAGS & SCORE_BF16) == 0;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* kv = reinterpret_cast<bf16*>(smem_raw);                 // 2 x ak x AT_LD
    unsigned char* k8 = reinterpret_cast<unsigned char*>(kv + 2 * ak * AT_LD);  // 2 x ak x AT_LD8
    float* red = reinterpret_cast<float*>(k8 + 2 * ak * AT_LD8);   // AT_MAX_WARPS x AT_LANES
    const int nw = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int qb = blockIdx.x % nqb;
    const size_t r = blockIdx.x / nqb;
    const size_t row0 = r * N;
    const int qrow = qb * 16 * nw + warp * 16;   // the warp's first query
    const int ldq = 3 * C;
    const int nkt = (N + ak - 1) / ak;
    float sk = 0.f, ss = 0.f, sq = 0.f;
    if constexpr (INT8) {
        sq = scales[2 * r];
        sk = scales[2 * r + 1];
        ss = sq * sk;
    }
    // the checksums of the lab's cut stages: scores summed, p's bf16 bits
    float chk = 0.f;
    uint32_t chk_bits = 0u;
    // B fragment of the ones n-tile (D >= 8): column 0 all ones
    const uint32_t ones_b = g == 0 ? BF16_ONES : 0u;

    for (int l0 = 0; l0 < C; l0 += AT_LANES) {
        // q's A fragments for the pass: masked per head (qm) where a k
        // step spans several heads
        uint32_t qm[D == 32 ? 2 : HP][4];
        if constexpr (INT8) {
            uint32_t qi[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int n = qrow + g + 8 * (i & 1);
                const int c = l0 + 4 * q + 16 * (i >> 1);
                int w = 0;
                if (n < N) {
                    const bf16* qp = qkv + (row0 + n) * ldq + c;
                    w = pack4(quant_i8(ld(qp), sq), quant_i8(ld(qp + 1), sq),
                              quant_i8(ld(qp + 2), sq), quant_i8(ld(qp + 3), sq));
                    qk_out[((row0 + n) * 2 * C + c) / 4] = w;
                }
                qi[i] = (uint32_t)w;
            }
#pragma unroll
            for (int hh = 0; hh < HP; ++hh)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    qm[hh][i] = (4 * q + 16 * (i >> 1)) / D == hh ? qi[i] : 0u;
        } else {
            uint32_t qa[2][4];
#pragma unroll
            for (int kg = 0; kg < 2; ++kg)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int n = qrow + g + 8 * (i & 1);
                    const int c = l0 + 16 * kg + 2 * q + 8 * (i >> 1);
                    qa[kg][i] = n < N ? *reinterpret_cast<const uint32_t*>(
                                            qkv + (row0 + n) * ldq + c)
                                      : 0u;
                }
            if constexpr (D == 32) {
#pragma unroll
                for (int kg = 0; kg < 2; ++kg)
#pragma unroll
                    for (int i = 0; i < 4; ++i) qm[kg][i] = qa[kg][i];
            } else {
#pragma unroll
                for (int hh = 0; hh < HP; ++hh) {
                    constexpr int HG = 16 / D;   // heads a k step (one at D = 16)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        qm[hh][i] = (2 * q + 8 * (i >> 1)) / D == hh % HG ? qa[hh / HG][i]
                                                                        : 0u;
                }
            }
        }
        // safe[hh]: no score of head hh in this warp can fall below -126,
        // by |s| <= |q_h| |k_h| with the warp's largest |q_h| and the row's
        // largest |k_h| (kmax, from k_norm_kernel; null: no bound, every
        // chunk's scores are tested), and a margin for the f32
        // sums (INT8: the int8 q's norm times sq, and |k_h| + sqrt(D) sk / 2
        // for k's rounding to int8)
        constexpr bool BOUND = STAGE >= STAGE_EXP2 && (FLAGS & SCORE_BF16) == 0;
        bool safe[HP];
#pragma unroll
        for (int hh = 0; hh < HP; ++hh) {
            safe[hh] = false;
            if (BOUND && kmax != nullptr) {
                float q2[2];     // |q|^2 of rows g, g + 8: this thread's channels
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    if constexpr (INT8)
                        q2[hr] = (float)__dp4a((int)qm[hh][hr], (int)qm[hh][hr],
                                               __dp4a((int)qm[hh][hr + 2], (int)qm[hh][hr + 2], 0));
                    else if constexpr (D == 32)
                        q2[hr] = sq_bf16x2(qm[0][hr]) + sq_bf16x2(qm[0][hr + 2])
                                 + sq_bf16x2(qm[1][hr]) + sq_bf16x2(qm[1][hr + 2]);
                    else
                        q2[hr] = sq_bf16x2(qm[hh][hr]) + sq_bf16x2(qm[hh][hr + 2]);
                    q2[hr] += __shfl_xor_sync(0xffffffffu, q2[hr], 1);
                    q2[hr] += __shfl_xor_sync(0xffffffffu, q2[hr], 2);
                }
                float qn = fmaxf(q2[0], q2[1]);
#pragma unroll
                for (int o_ = 4; o_ < 32; o_ <<= 1)
                    qn = fmaxf(qn, __shfl_xor_sync(0xffffffffu, qn, o_));
                qn = sqrtf(qn);
                float kn = kmax[r * H + l0 / D + hh];
                if constexpr (INT8) {
                    qn *= sq;
                    kn += 0.5f * sqrtf((float)D) * sk;
                }
                safe[hh] = qn * kn <= SAFE_BOUND;
            }
        }
        float o[HP][OT][4];
#pragma unroll
        for (int hh = 0; hh < HP; ++hh) zero(o[hh]);

        // a key tile: k (INT8: its int8 words, from qk_out), then v, in
        // 16-byte chunks
        auto load = [&](int kt) {
            const int k0 = kt * ak;
            bf16* dst = kv + (kt & 1) * ak * AT_LD;
            constexpr int KCH = INT8 ? 2 : 4;
            constexpr int CHUNKS = KCH + (STAGE >= STAGE_AV ? 4 : 0);
            for (int i = threadIdx.x; i < ak * CHUNKS; i += blockDim.x) {
                const int j = i / CHUNKS, c = i % CHUNKS;
                const bool valid = k0 + j < N;
                const size_t tok = row0 + (valid ? k0 + j : 0);
                if (c >= KCH)
                    cp_async16(dst + j * AT_LD + AT_LANES + 8 * (c - KCH),
                               qkv + tok * ldq + 2 * C + l0 + 8 * (c - KCH), valid);
                else if (INT8)
                    cp_async16(reinterpret_cast<bf16*>(k8 + ((kt & 1) * ak + j) * AT_LD8 + 16 * c),
                               reinterpret_cast<const bf16*>(
                                   reinterpret_cast<const unsigned char*>(qk_out)
                                   + tok * 2 * C + C + l0 + 16 * c),
                               valid);
                else
                    cp_async16(dst + j * AT_LD + 8 * c, qkv + tok * ldq + C + l0 + 8 * c, valid);
            }
        };
        load(0);
        cp_async_commit();
        for (int kt = 0; kt < nkt; ++kt) {
            const int k0 = kt * ak;
            if (kt + 1 < nkt) load(kt + 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            const bf16* tile = kv + (kt & 1) * ak * AT_LD;
            for (int kc = 0; kc < ak && k0 + kc < N; kc += 16) {
                const int nvalid = min(16, N - k0 - kc);
                uint32_t kf[INT8 ? 1 : 2][4];
                if constexpr (INT8)
                    ldsm_b_nmajor(kf[0], reinterpret_cast<const bf16*>(k8 + (kt & 1) * ak * AT_LD8),
                                  AT_LD8 / 2, 0, kc);
                else {
                    ldsm_b_nmajor(kf[0], tile, AT_LD, 0, kc);
                    ldsm_b_nmajor(kf[1], tile, AT_LD, 16, kc);
                }
                uint32_t vf[4][2];
                if constexpr (STAGE >= STAGE_AV) {
                    uint32_t b[4];
                    ldsm_b_kmajor(b, tile + AT_LANES, AT_LD, kc, 0);
                    vf[0][0] = b[0]; vf[0][1] = b[1]; vf[1][0] = b[2]; vf[1][1] = b[3];
                    ldsm_b_kmajor(b, tile + AT_LANES, AT_LD, kc, 16);
                    vf[2][0] = b[0]; vf[2][1] = b[1]; vf[3][0] = b[2]; vf[3][1] = b[3];
                }
#pragma unroll
                for (int hh = 0; hh < HP; ++hh) {
                    float s[2][4];
                    if constexpr (INT8) {
                        int si[2][4] = {};
                        mma_s8(si[0], qm[hh], kf[0][0], kf[0][1]);
                        mma_s8(si[1], qm[hh], kf[0][2], kf[0][3]);
#pragma unroll
                        for (int j = 0; j < 2; ++j)
#pragma unroll
                            for (int e = 0; e < 4; ++e) s[j][e] = (float)si[j][e] * ss;
                    } else {
                        zero(s);
                        if constexpr (D == 32) {
#pragma unroll
                            for (int kg = 0; kg < 2; ++kg) {
                                mma_bf16(s[0], qm[kg], kf[kg][0], kf[kg][1]);
                                mma_bf16(s[1], qm[kg], kf[kg][2], kf[kg][3]);
                            }
                        } else {
                            constexpr int HG = 16 / D;
                            mma_bf16(s[0], qm[hh], kf[hh / HG][0], kf[hh / HG][1]);
                            mma_bf16(s[1], qm[hh], kf[hh / HG][2], kf[hh / HG][3]);
                        }
                    }
                    if constexpr (STAGE == STAGE_SCORES) {
#pragma unroll
                        for (int j = 0; j < 2; ++j)
#pragma unroll
                            for (int e = 0; e < 4; ++e) chk += s[j][e];
                        continue;
                    }
                    exp2_line<FLAGS>(s, nvalid, safe[hh]);
                    uint32_t pf[4];
                    pack_a(pf, s[0], s[1]);
                    if constexpr (STAGE == STAGE_EXP2) {
                        // p's bf16 pairs, as P V would take them, kept in
                        // a checksum; p of the queries n < D written out
                        chk_bits ^= pf[0] ^ pf[1] ^ pf[2] ^ pf[3];
                        if (qrow < D) {
                            const int h = l0 / D + hh;
#pragma unroll
                            for (int j = 0; j < 2; ++j)
#pragma unroll
                                for (int e = 0; e < 4; ++e) {
                                    const int n = qrow + g + 8 * (e >> 1);
                                    const int key = k0 + kc + 8 * j + 2 * q + (e & 1);
                                    if (n < D && key < N)
                                        out[(row0 + key) * C + h * D + n] =
                                            __float2bfloat16(s[j][e]);
                                }
                        }
                        continue;
                    }
                    uint32_t pl[4];
                    if constexpr (SPLIT) {
                        float lo[2][4];
#pragma unroll
                        for (int j = 0; j < 2; ++j)
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                const float hi = round_bf16(s[j][e]);
                                lo[j][e] = fabsf(hi) < INFINITY ? s[j][e] - hi : 0.f;
                            }
                        pack_a(pl, lo[0], lo[1]);
                    }
                    // P V (and the ones column) for head hh
                    if constexpr (D == 4) {
                        const bool own = (g >> 2) == (hh & 1);
                        const uint32_t fill = g == 4 * (1 - (hh & 1)) ? BF16_ONES : 0u;
                        const uint32_t b0 = own ? vf[hh >> 1][0] : fill;
                        const uint32_t b1 = own ? vf[hh >> 1][1] : fill;
                        mma_bf16(o[hh][0], pf, b0, b1);
                        if constexpr (SPLIT) mma_bf16(o[hh][0], pl, b0, b1);
                    } else {
#pragma unroll
                        for (int t = 0; t < VT; ++t) {
                            mma_bf16(o[hh][t], pf, vf[hh * VT + t][0], vf[hh * VT + t][1]);
                            if constexpr (SPLIT)
                                mma_bf16(o[hh][t], pl, vf[hh * VT + t][0], vf[hh * VT + t][1]);
                        }
                        mma_bf16(o[hh][VT], pf, ones_b, ones_b);
                        if constexpr (SPLIT) mma_bf16(o[hh][VT], pl, ones_b, ones_b);
                    }
                }
            }
            __syncthreads();      // the buffers are free before they are refilled
        }
        if constexpr (STAGE == STAGE_SCORES || STAGE == STAGE_EXP2) continue;

        // acc = (sum p v) / (sum p) per head: the denominator is column
        // 4 (1 - hh % 2) of the head's n-tile (D = 4) or column 0 of its ones
        // n-tile, held by thread q = dq of each quad (rows g, g + 8)
#pragma unroll
        for (int hh = 0; hh < HP; ++hh) {
            const int h = l0 / D + hh;
            const int dq = D == 4 ? 2 * (1 - (hh & 1)) : 0;
            const int dt = D == 4 ? 0 : VT;
            float den[2];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
                den[hr] = __shfl_sync(0xffffffffu, o[hh][dt][2 * hr], (lane & ~3) | dq);
            float part[VT][2] = {};      // STAGE_AV: the two rows' sum
#pragma unroll
            for (int t = 0; t < VT; ++t) {
                // this thread's columns d, d + 1 of the head (D = 4: only the
                // head's own half of the n-tile)
                const int d = D == 4 ? 2 * q - 4 * (hh & 1) : 8 * t + 2 * q;
                if (D == 4 && (q >> 1) != (hh & 1)) continue;
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int n = qrow + g + 8 * hr;
                    const float a0 = o[hh][t][2 * hr] / den[hr];
                    const float a1 = o[hh][t][2 * hr + 1] / den[hr];
                    if constexpr (STAGE == STAGE_AV) {
                        if (n < N) {
                            part[t][0] += a0;
                            part[t][1] += a1;
                        }
                    } else if (n < N) {
                        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + n) * C + h * D + d) =
                            __floats2bfloat162_rn(a0, a1);
                    }
                }
            }
            if constexpr (WITH_DEN) {
                if (q == dq) {
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        const int n = qrow + g + 8 * hr;
                        if (n < N) den_out[(r * H + h) * N + n] = den[hr];
                    }
                }
            }
            if constexpr (STAGE == STAGE_AV) {
                // the warp's 16 queries summed (over g), then the block's
                // warps in order below
#pragma unroll
                for (int t = 0; t < VT; ++t)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int o_ = 4; o_ < 32; o_ <<= 1)
                            part[t][i] += __shfl_xor_sync(0xffffffffu, part[t][i], o_);
                if (g == 0) {
#pragma unroll
                    for (int t = 0; t < VT; ++t) {
                        const int d = D == 4 ? 2 * q - 4 * (hh & 1) : 8 * t + 2 * q;
                        if (D == 4 && (q >> 1) != (hh & 1)) continue;
                        red[warp * AT_LANES + hh * D + d] = part[t][0];
                        red[warp * AT_LANES + hh * D + d + 1] = part[t][1];
                    }
                }
            }
        }
        if constexpr (STAGE == STAGE_AV) {
            __syncthreads();
            if (threadIdx.x < AT_LANES) {
                float sum = 0.f;
                for (int w = 0; w < nw; ++w) sum += red[w * AT_LANES + threadIdx.x];
                const int c = l0 + threadIdx.x, h = c / D;
                lab[((r * H + h) * nqb + qb) * D + c % D] = sum;
            }
            __syncthreads();
        }
    }
    if constexpr (STAGE == STAGE_SCORES) {
        chk = warp_sum(chk);
        if (lane == 0) sink[(size_t)blockIdx.x * nw + warp] = chk;
    } else if constexpr (STAGE == STAGE_EXP2) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) chk_bits ^= __shfl_xor_sync(0xffffffffu, chk_bits, o);
        if (lane == 0) sink[(size_t)blockIdx.x * nw + warp] = __uint_as_float(chk_bits);
    }
}

// 3. Out-projection + residual + LN2 + MLP + residual, on the tensor
// cores.  64 tokens a block, 8 warps: warp w owns tokens 16 (w % 4) ..
// + 15 and, in every product, half w / 4 of the chunk's columns.
//   y = x + (bf16(acc) Wo + bo) into the f32 tile sy (the attention output
//       acc is the bf16 A tile sa);
//   n2 = bf16(LN2(y)) (f32 statistics) over sa, the A tile of fc1;
//   the MLP in chunks of HC hidden units: a chunk's fc1 columns, + b1,
//       erf GELU, rounded to bf16 into sh (64 x HC), and at once its share
//       of fc2 (sh W2[chunk rows, :]) summed into registers, so the 4C-wide
//       hidden activation exists only a chunk at a time, in shared memory.
//       A ragged last chunk (hidden a multiple of 8, not of HC) reads fc1's
//       columns and fc2's rows past hidden as zeros and b1 as 0 there, so
//       its units past hidden add GELU(0) * 0 = 0;
//   out = bf16(y + (fc2 + b2)).
// Each weight is streamed through shared memory in k-slices (block_gemm).
// WITH_MID also writes mid = bf16(y), the residual stream after the
// attention half.  ATTN_ONLY (the lab's stage attn) writes bf16(y) to out
// and stops there; it needs no sh.
constexpr int POST_TOK = 64;
constexpr int POST_THREADS = 256;
constexpr int HC = 128;            // hidden units a chunk of the MLP

template <int C, bool ATTN_ONLY>
constexpr size_t post_smem_bytes() {
    return sizeof(float) * POST_TOK * (C + 8)                       // sy
           + sizeof(bf16) * (POST_TOK * (C + 8)                     // sa
                             + 2 * KS * ((C > HC ? C : HC) + 8)     // wbuf
                             + (ATTN_ONLY ? 0 : POST_TOK * (HC + 8)));   // sh
}

template <int C, bool WITH_MID, bool ATTN_ONLY = false>
__global__ void __launch_bounds__(POST_THREADS)
post_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
            const bf16* __restrict__ wo, const bf16* __restrict__ bo,
            const bf16* __restrict__ ln_s, const bf16* __restrict__ ln_b,
            const bf16* __restrict__ w1, const bf16* __restrict__ b1,
            const bf16* __restrict__ w2, const bf16* __restrict__ b2,
            bf16* __restrict__ out, bf16* __restrict__ mid, int M, int hidden) {
    constexpr int LDY = C + 8, LDA = C + 8, LDH = HC + 8;
    constexpr int PNCH = C < 128 ? C : 128;   // out-projection columns a chunk
    constexpr int PNT = PNCH / 16;            // n-tiles a warp: out-projection,
    constexpr int FNT = HC / 16;              // fc1,
    constexpr int ONT = C / 16;               // fc2 (its sums live across chunks)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sy = reinterpret_cast<float*>(smem_raw);        // 64 x LDY  y, f32
    bf16* sa = reinterpret_cast<bf16*>(sy + POST_TOK * LDY);   // 64 x LDA  acc, then n2
    bf16* wbuf = sa + POST_TOK * LDA;                       // block_gemm's buffers
    bf16* sh = wbuf + 2 * KS * ((C > HC ? C : HC) + 8);     // 64 x LDH  GELU chunk
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int mrow = (warp & 3) * 16;
    const int half = warp >> 2;
    const size_t tok0 = (size_t)blockIdx.x * POST_TOK;
    const int ntok = min(POST_TOK, M - (int)tok0);
    stage_rows<POST_THREADS>(sa, LDA, attn, C, tok0, POST_TOK, ntok, C);
    cp_async_commit();
    for (int i = threadIdx.x; i < POST_TOK * C; i += POST_THREADS) {
        const int t = i / C;
        sy[t * LDY + i % C] = t < ntok ? ld(x + tok0 * C + i) : 0.f;
    }
    // the out-projection (block_gemm's first barrier orders the loads above)
    for (int n0 = 0; n0 < C; n0 += PNCH) {
        float acc[PNT][4];
        zero(acc);
        block_gemm<PNT, PNCH, POST_THREADS>(acc, sa + mrow * LDA, LDA, wo, C, n0, C, wbuf,
                                            half * PNCH / 2);
#pragma unroll
        for (int j = 0; j < PNT; ++j) {
            const int col = n0 + half * PNCH / 2 + 8 * j + 2 * q;
            const float b0 = ld(bo + col), b1v = ld(bo + col + 1);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float* yp = sy + (mrow + g + 8 * hh) * LDY + col;
                yp[0] += acc[j][2 * hh] + b0;
                yp[1] += acc[j][2 * hh + 1] + b1v;
            }
        }
    }
    __syncthreads();
    if constexpr (ATTN_ONLY) {
        for (int i = threadIdx.x; i < ntok * C; i += POST_THREADS)
            out[tok0 * C + i] = __float2bfloat16(sy[(i / C) * LDY + i % C]);
        return;
    }
    if (WITH_MID) {
        for (int i = threadIdx.x; i < ntok * C; i += POST_THREADS)
            mid[tok0 * C + i] = __float2bfloat16(sy[(i / C) * LDY + i % C]);
    }
    // LN2 over sa (the out-projection's last barrier freed it); padded
    // tokens (y = 0) normalise to the bias and are never written
    for (int t = warp * (POST_TOK / 8); t < (warp + 1) * (POST_TOK / 8); ++t) {
        float v[C / 32];
        bf16 n[C / 32];
#pragma unroll
        for (int i = 0; i < C / 32; ++i) v[i] = sy[t * LDY + lane + 32 * i];
        layer_norm_row<C>(v, ln_s, ln_b, n);
#pragma unroll
        for (int i = 0; i < C / 32; ++i) sa[t * LDA + lane + 32 * i] = n[i];
    }
    // the MLP, HC hidden units at a time
    float o[ONT][4];
    zero(o);
    for (int h0 = 0; h0 < hidden; h0 += HC) {
        float f[FNT][4];
        zero(f);
        block_gemm<FNT, HC, POST_THREADS>(f, sa + mrow * LDA, LDA, w1, hidden, h0, C, wbuf,
                                          half * HC / 2, 1 << 30, hidden);
#pragma unroll
        for (int j = 0; j < FNT; ++j) {
            const int col = half * HC / 2 + 8 * j + 2 * q;
            const bool in = h0 + col < hidden;     // a ragged last chunk: b1 = 0 past it
            const float c0 = in ? ld(b1 + h0 + col) : 0.f, c1 = in ? ld(b1 + h0 + col + 1) : 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const float h0v = f[j][2 * hh] + c0, h1v = f[j][2 * hh + 1] + c1;
                *reinterpret_cast<__nv_bfloat162*>(sh + (mrow + g + 8 * hh) * LDH + col) =
                    __floats2bfloat162_rn(
                        0.5f * h0v * (1.0f + erff(h0v * 0.70710678118654752f)),
                        0.5f * h1v * (1.0f + erff(h1v * 0.70710678118654752f)));
            }
        }
        // fc2's share of the chunk (block_gemm's first barrier orders sh)
        block_gemm<ONT, C, POST_THREADS>(o, sh + mrow * LDH, LDH, w2 + (size_t)h0 * C, C, 0,
                                         HC, wbuf, half * C / 2, hidden - h0);
    }
#pragma unroll
    for (int j = 0; j < ONT; ++j) {
        const int col = half * C / 2 + 8 * j + 2 * q;
        const float c0 = ld(b2 + col), c1 = ld(b2 + col + 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int t = mrow + g + 8 * hh;
            if (t < ntok) {
                const float* yp = sy + t * LDY + col;
                *reinterpret_cast<__nv_bfloat162*>(out + (tok0 + t) * C + col) =
                    __floats2bfloat162_rn(yp[0] + (o[j][2 * hh] + c0),
                                          yp[1] + (o[j][2 * hh + 1] + c1));
            }
        }
    }
}

// The attention's grid: one block per (row, block of 16 x warps queries),
// 8 warps and 128-key tiles where N > 64, else 4 warps and 64-key tiles.
struct AttnGrid {
    int threads, nqb, keys;
    size_t blocks;
};

AttnGrid attn_grid(int R, int N) {
    const int warps = N > 64 ? AT_MAX_WARPS : 4;
    const int nqb = (N + 16 * warps - 1) / (16 * warps);
    return {32 * warps, nqb, N > 64 ? 128 : 64, (size_t)R * nqb};
}

// One launch of attn_kernel in the given form.
// One launch of attn_kernel in the given form, after k_norm_kernel where
// the form takes the exp2 bound (kmax: R * H floats of scratch) and the
// rows are longer than one 64-key tile (shorter rows test their scores:
// the launch and the load would cost more than the test).
template <int D, bool WITH_DEN, bool INT8, int STAGE = STAGE_FULL, int FLAGS = 0>
cudaError_t launch_attn_form(const bf16* qkv, float* kmax, bf16* out, float* den,
                             const float* scales, int* qk_out, float* lab, float* sink, int R,
                             int N, int C, int H, cudaStream_t stream) {
    const AttnGrid g = attn_grid(R, N);
    if (g.blocks > 0x7fffffffULL || NORM_THREADS % H) return cudaErrorInvalidConfiguration;
    cudaError_t err;
    const bool bound = STAGE >= STAGE_EXP2 && (FLAGS & SCORE_BF16) == 0 && N > 64;
    if (bound || INT8) {
        k_norm_kernel<INT8><<<(unsigned)R, NORM_THREADS, 0, stream>>>(qkv, kmax, scales, qk_out,
                                                                      N, C, H);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    auto kernel = attn_kernel<D, WITH_DEN, INT8, STAGE, FLAGS>;
    const size_t smem = attn_smem_bytes(g.keys);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)g.blocks, g.threads, smem, stream>>>(qkv, bound ? kmax : nullptr, out,
                                                           den, scales, qk_out, N, C, H, g.nqb,
                                                           g.keys, lab, sink);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_attn(const bf16* qkv, float* kmax, bf16* attn, float* den,
                        const float* scales, int* qk_out, int R, int N, int C, int H,
                        cudaStream_t stream) {
    if (scales)
        return launch_attn_form<D, false, true>(qkv, kmax, attn, nullptr, scales, qk_out,
                                                nullptr, nullptr, R, N, C, H, stream);
    if (den)
        return launch_attn_form<D, true, false>(qkv, kmax, attn, den, nullptr, nullptr, nullptr,
                                                nullptr, R, N, C, H, stream);
    return launch_attn_form<D, false, false>(qkv, kmax, attn, nullptr, nullptr, nullptr,
                                             nullptr, nullptr, R, N, C, H, stream);
}

// 3. The out-projection and (unless ATTN_ONLY) the MLP half, at the given
// C (32, 64, 128 or 256).
template <bool WITH_MID, bool ATTN_ONLY>
cudaError_t launch_post(const void* x, const bf16* attn, const void* w_o, const void* b_o,
                        const void* ln2_s, const void* ln2_b, const void* w_1,
                        const void* b_1, const void* w_2, const void* b_2, void* out,
                        void* mid, int M, int C, int hidden, cudaStream_t stream) {
    if (hidden <= 0 || hidden % 8) return cudaErrorInvalidValue;
    auto go = [&](auto kernel, size_t smem) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        kernel<<<(unsigned)((M + POST_TOK - 1) / POST_TOK), POST_THREADS, smem, stream>>>(
            (const bf16*)x, attn, (const bf16*)w_o, (const bf16*)b_o, (const bf16*)ln2_s,
            (const bf16*)ln2_b, (const bf16*)w_1, (const bf16*)b_1, (const bf16*)w_2,
            (const bf16*)b_2, (bf16*)out, (bf16*)mid, M, hidden);
        return cudaGetLastError();
    };
    switch (C) {
        case 32: return go(post_kernel<32, WITH_MID, ATTN_ONLY>, post_smem_bytes<32, ATTN_ONLY>());
        case 64: return go(post_kernel<64, WITH_MID, ATTN_ONLY>, post_smem_bytes<64, ATTN_ONLY>());
        case 128:
            return go(post_kernel<128, WITH_MID, ATTN_ONLY>, post_smem_bytes<128, ATTN_ONLY>());
        case 256:
            return go(post_kernel<256, WITH_MID, ATTN_ONLY>, post_smem_bytes<256, ATTN_ONLY>());
        default: return cudaErrorInvalidValue;
    }
}

// The whole block: launches 1-3, with B3's scale launch before the
// attention when scales is non-null.  mid and den: B1-train's exports.
cudaError_t forward(const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
                    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
                    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
                    void* qkv_buf, void* kmax_buf, void* attn_buf, void* out, void* mid,
                    void* den, void* scales, void* qk_out, int R, int N, int C, int H,
                    int hidden, cudaStream_t stream) {
    const int M = R * N;
    cudaError_t err = launch_ln_qkv<false>((const bf16*)x, (const bf16*)ln1_s,
                                           (const bf16*)ln1_b, (const bf16*)w_qkv,
                                           (bf16*)qkv_buf, nullptr, M, C, stream);
    if (err != cudaSuccess) return err;

    const bf16* qkv = (const bf16*)qkv_buf;
    if (scales) {
        qk_scale_kernel<<<(unsigned)R, SCALE_THREADS, 0, stream>>>(qkv, (float*)scales, N, C);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bf16* attn = (bf16*)attn_buf;
    float* km = (float*)kmax_buf;
    float* dn = (float*)den;
    const float* sc = (const float*)scales;
    int* qk = (int*)qk_out;
    switch (C / H) {
        case 4: err = launch_attn<4>(qkv, km, attn, dn, sc, qk, R, N, C, H, stream); break;
        case 8: err = launch_attn<8>(qkv, km, attn, dn, sc, qk, R, N, C, H, stream); break;
        case 16: err = launch_attn<16>(qkv, km, attn, dn, sc, qk, R, N, C, H, stream); break;
        case 32: err = launch_attn<32>(qkv, km, attn, dn, sc, qk, R, N, C, H, stream); break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;

    return mid ? launch_post<true, false>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2,
                                          b_2, out, mid, M, C, hidden, stream)
               : launch_post<false, false>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2,
                                           b_2, out, nullptr, M, C, hidden, stream);
}

// The lab's stage qkv: out = bf16((f32(q) + k) + v), per token and channel.
__global__ void qkv_sum_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                               size_t total, int C) {
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const bf16* t = qkv + (i / C) * 3 * C + i % C;
        out[i] = __float2bfloat16(ld(t) + ld(t + C) + ld(t + 2 * C));
    }
}

// The lab's stage scores, its output: out[r, n, c] = q_n . k_c over all C
// lanes (the sum over heads of s_h[r, query n, key c]) for c < kept =
// min(C, N), else 0: per row an (N, C) x (C, kept) product in f32, lanes
// summed in order.  One block per (row, KS_Q queries); the queries' and the
// kept keys' lanes go through shared memory KS_L at a time; warp w owns
// queries 8w..8w+7 and lane j the keys j, j + 32, ... (KG = ceil(kept / 32)
// groups; kept <= 256).
constexpr int KS_Q = 32, KS_L = 32, KS_KEYS = 256;

template <int KG>
__global__ void __launch_bounds__(THREADS)
kept_scores_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int C) {
    __shared__ __align__(16) float qs[KS_L][KS_Q + 4];   // lane-major: a warp's 8 queries
    __shared__ float ks[32 * KG][KS_L + 1];              // are two float4 loads
    const int nqt = (N + KS_Q - 1) / KS_Q;
    const size_t r = blockIdx.x / nqt;
    const int n0 = (int)(blockIdx.x % nqt) * KS_Q;
    const int kept = min(C, N), ldq = 3 * C;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bf16* row = qkv + r * N * ldq;
    float acc[8][KG];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int m = 0; m < KG; ++m) acc[i][m] = 0.f;
    for (int l0 = 0; l0 < C; l0 += KS_L) {
        __syncthreads();
        for (int i = threadIdx.x; i < KS_Q * KS_L; i += THREADS) {
            const int n = n0 + i / KS_L;
            qs[i % KS_L][i / KS_L] = n < N ? ld(row + (size_t)n * ldq + l0 + i % KS_L) : 0.f;
        }
        for (int i = threadIdx.x; i < 32 * KG * KS_L; i += THREADS) {
            const int j = i / KS_L;
            ks[j][i % KS_L] = j < kept ? ld(row + (size_t)j * ldq + C + l0 + i % KS_L) : 0.f;
        }
        __syncthreads();
        for (int l = 0; l < KS_L; ++l) {
            const float4 qa = *reinterpret_cast<const float4*>(&qs[l][8 * warp]);
            const float4 qb = *reinterpret_cast<const float4*>(&qs[l][8 * warp + 4]);
            const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
            for (int m = 0; m < KG; ++m) {
                const float kv = ks[32 * m + lane][l];
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[i][m] += qv[i] * kv;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int n = n0 + 8 * warp + i;
        if (n >= N) continue;
        bf16* o = out + (r * N + n) * C;
#pragma unroll
        for (int m = 0; m < KG; ++m)
            if (32 * m + lane < kept) o[32 * m + lane] = __float2bfloat16(acc[i][m]);
        for (int c = kept + lane; c < C; c += 32) o[c] = __float2bfloat16(0.f);
    }
}

// The lab's stage av, second launch: the per-block sums of acc / den summed
// over the query blocks in order, out[r, n, c] the same for every n.  One
// thread per (r, c).
__global__ void av_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                              int R, int N, int C, int H, int nqb) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)R * C) return;
    const size_t r = i / C;
    const int c = (int)(i % C), D = C / H, h = c / D, d = c % D;
    float s = 0.f;
    for (int qb = 0; qb < nqb; ++qb) s += part[((r * H + h) * nqb + qb) * D + d];
    const bf16 b = __float2bfloat16(s);
    for (int n = 0; n < N; ++n) out[(r * N + n) * C + c] = b;
}

template <int D, int STAGE, int FLAGS>
cudaError_t launch_attn_lab(const bf16* qkv, float* kmax, bf16* out, float* lab, float* sink,
                            int R, int N, int C, int H, cudaStream_t stream) {
    return launch_attn_form<D, false, false, STAGE, FLAGS>(qkv, kmax, out, nullptr, nullptr,
                                                           nullptr, lab, sink, R, N, C, H,
                                                           stream);
}

// The lab's attention at head dim D: a cut stage, or the full attention
// with the flags.
template <int D>
cudaError_t lab_attn(int stage, int flags, const bf16* qkv, float* kmax, bf16* out,
                     float* lab, float* sink, int R, int N, int C, int H, cudaStream_t stream) {
    switch (stage) {
        case STAGE_SCORES:
            return launch_attn_lab<D, STAGE_SCORES, 0>(qkv, kmax, out, lab, sink, R, N, C, H,
                                                       stream);
        case STAGE_EXP2:
            return launch_attn_lab<D, STAGE_EXP2, 0>(qkv, kmax, out, lab, sink, R, N, C, H,
                                                     stream);
        case STAGE_AV:
            return launch_attn_lab<D, STAGE_AV, 0>(qkv, kmax, out, lab, sink, R, N, C, H,
                                                   stream);
        default:
            break;
    }
#define LAB_FLAGS(F)                                                                       \
    case F:                                                                                \
        return launch_attn_lab<D, STAGE_FULL, F>(qkv, kmax, out, lab, sink, R, N, C, H, stream);
    switch (flags) {
        LAB_FLAGS(0) LAB_FLAGS(1) LAB_FLAGS(2) LAB_FLAGS(3)
        LAB_FLAGS(4) LAB_FLAGS(5) LAB_FLAGS(6) LAB_FLAGS(7)
        default: return cudaErrorInvalidValue;
    }
#undef LAB_FLAGS
}

// Scratch of a lab launch, in floats: from stage scores on the rows'
// largest |k_h| (R * H) and after them, stages scores and exp2 the sink, av
// the per-block sums.
size_t lab_scratch_floats(int R, int N, int C, int H, int stage) {
    const AttnGrid g = attn_grid(R, N);
    const size_t kmax = (size_t)R * H;
    if (stage == STAGE_SCORES || stage == STAGE_EXP2) return kmax + g.blocks * (g.threads / 32);
    if (stage == STAGE_AV) return kmax + (size_t)R * C * g.nqb;
    return stage == STAGE_QKV ? 0 : kmax;
}

cudaError_t lab_forward(const void* x, const void* ln1_s, const void* ln1_b,
                        const void* w_qkv, const void* w_o, const void* b_o,
                        const void* ln2_s, const void* ln2_b, const void* w_1,
                        const void* b_1, const void* w_2, const void* b_2, void* qkv_buf,
                        void* attn_buf, void* out, void* scratch, int R, int N, int C,
                        int H, int hidden, int stage, int flags, cudaStream_t stream) {
    const int M = R * N;
    cudaError_t err = launch_ln_qkv<false>((const bf16*)x, (const bf16*)ln1_s,
                                           (const bf16*)ln1_b, (const bf16*)w_qkv,
                                           (bf16*)qkv_buf, nullptr, M, C, stream);
    if (err != cudaSuccess) return err;
    const bf16* qkv = (const bf16*)qkv_buf;
    if (stage == STAGE_QKV) {
        const size_t total = (size_t)M * C;
        const size_t blocks = std::min<size_t>((total + 255) / 256, (size_t)1 << 20);
        qkv_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(qkv, (bf16*)out, total, C);
        return cudaGetLastError();
    }
    float* kmax = (float*)scratch;
    float* lab = kmax + (size_t)R * H;
    float* sink = lab;
    bf16* attn = stage == STAGE_EXP2 ? (bf16*)out : (bf16*)attn_buf;
    switch (C / H) {
        case 4:
            err = lab_attn<4>(stage, flags, qkv, kmax, attn, lab, sink, R, N, C, H, stream);
            break;
        case 8:
            err = lab_attn<8>(stage, flags, qkv, kmax, attn, lab, sink, R, N, C, H, stream);
            break;
        case 16:
            err = lab_attn<16>(stage, flags, qkv, kmax, attn, lab, sink, R, N, C, H, stream);
            break;
        case 32:
            err = lab_attn<32>(stage, flags, qkv, kmax, attn, lab, sink, R, N, C, H, stream);
            break;
        default: return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || stage == STAGE_EXP2) return err;
    if (stage == STAGE_SCORES) {
        const int kept = std::min(C, N);
        const unsigned blocks = (unsigned)((size_t)R * ((N + KS_Q - 1) / KS_Q));
        auto kernel = kept <= 32 ? kept_scores_kernel<1> : kept <= 64 ? kept_scores_kernel<2>
                      : kept <= 128 ? kept_scores_kernel<4> : kept_scores_kernel<8>;
        kernel<<<blocks, THREADS, 0, stream>>>(qkv, (bf16*)out, N, C);
        return cudaGetLastError();
    }
    if (stage == STAGE_AV) {
        av_sum_kernel<<<(unsigned)(((size_t)R * C + 127) / 128), 128, 0, stream>>>(
            lab, (bf16*)out, R, N, C, H, attn_grid(R, N).nqb);
        return cudaGetLastError();
    }
    if (stage == STAGE_ATTN)
        return launch_post<false, true>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                                        out, nullptr, M, C, hidden, stream);
    return launch_post<false, false>(x, attn, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                                     out, nullptr, M, C, hidden, stream);
}

}  // namespace

// B1, B1-train and B3.  qkv_buf (R*N, 3C) bf16 receives q|k|v, kmax_buf
// (R, H) f32 the rows' largest |k_h| (scratch of the attention's bound).
// Serving form (B1): mid, den, scales and qk_out null.  Training form (B1-train): mid (R, N, C) bf16 and den (R, H, N) f32
// both given.  Int8 scores (B3, serving only): scales (R, 2) f32 receives
// the per-row scales of q and k and qk_out (R*N, 2C) int8 the int8 q | k
// the attention used.
extern "C" int fused_block_forward(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    void* qkv_buf, void* kmax_buf, void* attn_buf, void* out, void* mid, void* den,
    void* scales, void* qk_out, int R, int N, int C, int H, int hidden, void* stream_ptr) {
    if (R <= 0 || N <= 0 || H <= 0 || C % H || (mid == nullptr) != (den == nullptr)
        || (scales != nullptr && mid != nullptr) || (qk_out == nullptr) != (scales == nullptr)
        || kmax_buf == nullptr)
        return cudaErrorInvalidValue;
    return forward(x, ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                   qkv_buf, kmax_buf, attn_buf, out, mid, den, scales, qk_out, R, N, C, H,
                   hidden, static_cast<cudaStream_t>(stream_ptr));
}

// The kernel lab (L): B1 cut at stage (0 qkv, 1 scores, 2 exp2, 3 av, 4 attn,
// 5 full) with flags (1 score_bf16, 2 p_f32, 4 no clamp; attn and full
// only); out (R, N, C) bf16.  qkv_buf (R*N, 3C) bf16 receives q|k|v;
// attn_buf (R, N, C) bf16 is needed by the attn and full stages, scratch of
// fused_block_lab_scratch_bytes by every stage but qkv.
extern "C" size_t fused_block_lab_scratch_bytes(int R, int N, int C, int H, int stage) {
    return lab_scratch_floats(R, N, C, H, stage) * sizeof(float);
}

extern "C" int fused_block_lab_forward(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* w_o, const void* b_o, const void* ln2_s, const void* ln2_b,
    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    void* qkv_buf, void* attn_buf, void* out, void* scratch, int R, int N, int C, int H,
    int hidden, int stage, int flags, void* stream_ptr) {
    if (R <= 0 || N <= 0 || H <= 0 || C % H || stage < STAGE_QKV || stage > STAGE_FULL
        || flags < 0 || flags > 7 || (flags && stage < STAGE_ATTN)
        || (stage == STAGE_EXP2 && N < C / H) || (stage >= STAGE_ATTN && !attn_buf)
        || (stage == STAGE_SCORES && (std::min(C, N) > KS_KEYS || C % KS_L))
        || (lab_scratch_floats(R, N, C, H, stage) && !scratch))
        return cudaErrorInvalidValue;
    return lab_forward(x, ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2,
                       qkv_buf, attn_buf, out, scratch, R, N, C, H, hidden, stage, flags,
                       static_cast<cudaStream_t>(stream_ptr));
}
