// Device code shared by the recurrence kernels (recurrence.cu, the forward
// scans, and recurrence_bwd.cu, their backward passes): the 3xTF32
// tensor-core product (mma.sync.m16n8k8) and its operand loads, and the
// staging of rows into shared memory by the bulk copy engine on mbarriers
// or, for views whose bases or strides are not on 16 bytes, by 4-byte
// cp.async.  Each source includes it into its own translation unit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- PTX helpers: tensor-core products and asynchronous copies ----

// d += a * b for one 16 x 8 x 8 TF32 tile (a row-major 16 x 8, b 8 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes from src to the shared dst, or zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid)
{
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_fence_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a buffer's phase, announcing the bytes its copies bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A wait
// that outlasts any real copy (2^26 polls, seconds) traps, so a fault ends
// the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done;
    uint32_t polls = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (++polls == (1u << 26)) __trap();
    } while (!done);
}

// bytes (a multiple of 16) from 16-byte aligned global memory into shared
// memory by the bulk copy engine; completion counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// ---- end of the PTX helpers ----

// x = big + small: big keeps the sign, exponent and top 10 mantissa bits
// (what the tensor core reads of a TF32 operand), small is the exact rest,
// of which the tensor core reads the top 10 bits again: 2^-20 of |x| is lost.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small)
{
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4])
{
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
}

// One 16 x 8 output tile of a 3xTF32 product.  The three products
// (small * big, big * small, big * big) accumulate apart, so a k-step's three
// tensor-core operations do not wait on one another; value(e) adds them.
struct Tile {
    float d[3][4];

    __device__ __forceinline__ void zero()
    {
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[p][e] = 0.f;
    }

    __device__ __forceinline__ void scale_rows(float top, float bottom)
    {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            d[p][0] *= top;
            d[p][1] *= top;
            d[p][2] *= bottom;
            d[p][3] *= bottom;
        }
    }

    __device__ __forceinline__ float value(int e) const { return (d[0][e] + d[1][e]) + d[2][e]; }
};

// t += a * b in 3xTF32, b (8 x 8) split from two floats (rows k and k + 4).
__device__ __forceinline__ void mma3_b(Tile& t, const uint32_t (&a_big)[4],
                                       const uint32_t (&a_small)[4], float b0, float b1)
{
    uint32_t bb0, bs0, bb1, bs1;
    split_tf32(b0, bb0, bs0);
    split_tf32(b1, bb1, bs1);
    mma_tf32(t.d[0], a_small, bb0, bb1);
    mma_tf32(t.d[1], a_big, bs0, bs1);
    mma_tf32(t.d[2], a_big, bb0, bb1);
}

// The split A operand of rows m0 + g and + 8, columns k0 + q and + 4 of a
// row-major array, each column scaled (f0, f1).
template <int ST>
__device__ __forceinline__ void load_a(const float (*x)[ST], int m0, int k0, int g, int q,
                                       float f0, float f1, uint32_t (&big)[4],
                                       uint32_t (&small)[4])
{
    const float av[4] = {x[m0 + g][k0 + q] * f0, x[m0 + g + 8][k0 + q] * f0,
                         x[m0 + g][k0 + q + 4] * f1, x[m0 + g + 8][k0 + q + 4] * f1};
    split4(av, big, small);
}

// The same from an array stored transposed (A[m][k] = x[k][m]), each row scaled.
template <int ST>
__device__ __forceinline__ void load_at(const float (*x)[ST], int m0, int k0, int g, int q,
                                        float f_top, float f_bottom, float f_k0, float f_k1,
                                        uint32_t (&big)[4], uint32_t (&small)[4])
{
    const float av[4] = {x[k0 + q][m0 + g] * (f_top * f_k0), x[k0 + q][m0 + g + 8] * (f_bottom * f_k0),
                         x[k0 + q + 4][m0 + g] * (f_top * f_k1),
                         x[k0 + q + 4][m0 + g + 8] * (f_bottom * f_k1)};
    split4(av, big, small);
}

// Tile a (rows g and g + 8, columns 2 q and 2 q + 1) into dst at (m0, n0).
template <int ST>
__device__ __forceinline__ void store_tile(float (*dst)[ST], int m0, int n0, int g, int q,
                                           const Tile& a)
{
    dst[m0 + g][n0 + 2 * q] = a.value(0);
    dst[m0 + g][n0 + 2 * q + 1] = a.value(1);
    dst[m0 + g + 8][n0 + 2 * q] = a.value(2);
    dst[m0 + g + 8][n0 + 2 * q + 1] = a.value(3);
}

// The state tiles st (rows r0 + g and + 8, n-tiles n0 ..) into a row-major
// array of stride ST: the forward kernels' shared copy, the operand of the
// next chunk's product with it (a float2 a row: each half-warp's stores hit
// distinct banks), or the backward kernels' chunk-start states in global
// memory.
template <int N, int ST>
__device__ __forceinline__ void store_state(float (*dst)[ST], const float (&st)[N][4], int r0,
                                            int n0, int g, int q)
{
#pragma unroll
    for (int n = 0; n < N; ++n) {
        const int col = (n0 + n) * 8 + 2 * q;
        *reinterpret_cast<float2*>(&dst[r0 + g][col]) = make_float2(st[n][0], st[n][1]);
        *reinterpret_cast<float2*>(&dst[r0 + g + 8][col]) = make_float2(st[n][2], st[n][3]);
    }
}

// Rows t0 .. t0 + ROWS - 1 of one (b, h)'s slice src (row stride ss),
// columns 0 .. W - 1, into dst (row stride ST) by 4-byte cp.async from NT
// threads, the path for views whose bases or strides are not on 16 bytes;
// rows at or past seq_len are zero-filled.
template <int ROWS, int W, int ST, int NT>
__device__ __forceinline__ void stage_rows_4(float* dst, const float* src, long long ss, int t0,
                                             int seq_len)
{
    for (int e = threadIdx.x; e < ROWS * W; e += NT) {
        const int row = e / W, col = e % W;
        const bool ok = t0 + row < seq_len;
        cp_async4(dst + row * ST + col, ok ? src + (t0 + row) * ss + col : src, ok);
    }
}

// One row of W floats by the bulk copy engine, or zeros past the sequence.
template <int W>
__device__ __forceinline__ void stage_row_bulk(float* dst, const float* src, bool ok,
                                               uint64_t* bar)
{
    if (ok) {
        bulk_copy(dst, src, W * 4, bar);
    } else {
#pragma unroll
        for (int c = 0; c < W; c += 4) *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

}  // namespace
