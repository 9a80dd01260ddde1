// Flash-attention forward for NVIDIA Hopper (sm_90a), built on wgmma, TMA and a
// producer warp.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:_kernel
// (line 24, launched by flash_attention_fwd) for bfloat16 inputs at head_dim 64
// and 128; flash_attention.cu keeps float32 and head_dim 32.  It computes, for
// every batch b, head h and query row i < S,
//
//     o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,g,:] * D^-0.5) v[b,j,g,:],
//
// g = h / (H / KV) (grouped-query attention by index, no repeated K/V), over
// keys j < S_kv, and j <= i when causal, with the TPU kernel's online softmax: a
// running max m, a running sum l and a float32 accumulator carried over the
// key tiles, masked scores at the finite -1e30, probabilities rounded to bf16
// before the second product (as the JAX blocked path rounds them), and the
// output acc / max(l, 1e-30) stored in bf16.  q and o are (B, S, H, D), k and v
// (B, S_kv, KV, D), all read through strides (the last dimension contiguous).
// A non-causal call takes a key length of its own (cross-attention: S queries
// against an encoder's S_kv keys); a causal one has S_kv = S.
// When the caller passes an lse buffer, each row's log-sum-exp of the scaled
// scores, m + log(max(l, 1e-30)) in natural-log units, is stored there as
// float32 (B, H, S): the training path's recomputing backward reads it.  A null
// lse stores nothing more than the output.
//
// What bounds it on the H100: operations.  A causal (b, h) needs
// 4 * D * S(S+1)/2 flops; at the prefill's shape (B = 2, S = 32768, H = 16,
// D = 128) that is 8.796e12 flops per layer, 8.894 ms at 989 TFLOP/s, against
// 0.24 ms for its 0.81 GB of q, k, v and o.  Only wgmma reaches the tensor
// cores' full rate, and wgmma needs its operands in shared memory in the
// layout it reads, arriving without costing the math warps issue slots.  So:
//
// * A CTA owns one (b, h, 128-row query tile): two consumer warpgroups of 64
//   query rows each, and one producer warp, one of whose threads issues every
//   TMA load.
// * TMA brings the Q tile once and K and V tiles of 128 keys through two
//   rings of STAGES stages each, every stage with a "full" mbarrier (the
//   producer's expected bytes) and an "empty" one (one arrival from each of
//   the consumers' eight warps).  The tensor maps (built on the host, passed
//   as __grid_constant__) cover the 4-D strided (B, S, heads, D) layout with a
//   128-byte swizzle: a tile is D/64 boxes of 64 columns x 128 rows.  A box
//   clips at the sequence edge and fills with zeros, so K/V rows past S_kv are
//   zeros, never uninitialised memory.
// * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//   (K-major).  Its float32 accumulator layout is, once packed to bf16, the
//   register A-fragment layout of O += P V, wgmma m64nDk16 with P in registers
//   and V read from shared memory in its MN-major form.  Scores and
//   probabilities never leave registers; row max and row sum use quad shuffles
//   and ex2 with log2(e) folded into the scale.
// * The consumers take turns (named barriers 1 and 2) issuing one tile's
//   products, P V of the previous tile and then Q K^T of this one, so one
//   warpgroup's softmax runs while the other's products keep the tensor cores
//   busy.  Overlapping a warpgroup's own next Q K^T with its softmax would
//   keep scores, probabilities and output (160 registers) live across
//   in-flight wgmmas; ptxas then serialises the wgmmas and spills (its
//   warning C7512), whatever the register budget, and that version was
//   slower than this one.
// * Causal: the KV loop stops at the diagonal tile (128-row query tiles and
//   128-key tiles share a diagonal), and only the loop's last tile (the
//   diagonal, or the ragged end of S) takes mask arithmetic.  The grid is 1-D
//   and hands out the longest query tiles of every (b, h) first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // query rows per CTA, 64 per consumer warpgroup
constexpr int BN = 128;        // keys per K/V tile
constexpr int STAGES = 2;      // depth of the K ring and of the V ring
constexpr int CONSUMER_WARPS = 8;  // two warpgroups of 64 query rows each
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // + one producer warp
constexpr int BOX_COLS = 64;   // one 128-byte swizzle span of bf16
constexpr int BLOCK_BYTES = 128 * BOX_COLS * 2;  // one box: 64 columns x 128 rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
    bf16* o;
    float* lse;  // (B, H, S) row log-sum-exp of the scaled scores; null: not stored
    long long o_sb, o_ss, o_sh;  // element strides of o for batch, sequence and head
    int seq_len;
    int kv_len;  // keys; equal to seq_len when causal
    int num_heads;
    int group;  // H / KV
    int batch;
    int n_qtiles;
    int causal;
    float scale_log2;  // D^-0.5 * log2(e)
};

// Shared memory, from a 1024-byte-aligned base (the 128-byte swizzle repeats
// every 1024 bytes, and TMA and wgmma both assume tiles start on it).
template <int D>
struct Layout {
    static constexpr int TILE = BM * D * 2;  // a Q tile; a K or V tile is the same size
    static constexpr int Q = 0;
    static constexpr int K = TILE;
    static constexpr int V = K + STAGES * TILE;
    static constexpr int BARS = V + STAGES * TILE;  // q_full, {k,v}_{full,empty}[STAGES]
    static constexpr int BYTES = BARS + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of TMA transactions on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A wait
// that outlasts any real load or tile (2^26 polls, seconds) traps, so a fault
// in the pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    uint32_t polls = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (++polls == (1u << 26)) __trap();
    } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3)
{
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles (layout type 1):
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset).
// K-major: a k16 step moves the start address by 32 bytes within the row.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr)
{
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
           (1ull << 62);
}

// MN-major (V as B of P V): the N extent spans 64-column boxes `box_bytes` apart
// (the leading byte offset); a k16 step is 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t box_bytes)
{
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(box_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup's wgmmas are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
    return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem); both operands K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc)
{
    if constexpr (D == 128)
        wgmma_rs_n128(o, a, desc);
    else
        wgmma_rs_n64(o, a, desc);
}

// S = Q K^T for one warpgroup's 64 rows over D in k16 steps: D/64 boxes of
// four 32-byte steps each.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_rows, uint32_t k_tile)
{
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BLOCK_BYTES + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_k_major(q_rows + off), desc_k_major(k_tile + off), kk > 0);
    }
}

// O += P V over the tile's 128 keys in k16 steps of 16 rows (2048 bytes).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_tile)
{
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], desc_mn_major(v_tile + kk * 2048, BLOCK_BYTES));
}

// The online softmax of one tile's scores in this thread's rows row0 and
// row0 + 8: mask keys past S_kv and, when causal, above the diagonal (only when
// `mask`), update m and l, set alpha to the factor the output must take, and
// leave P = exp2(S * scale_log2 - m) in sc.
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2, bool mask,
                                               int key0, int row0, int kv_len, bool causal)
{
    if (mask) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            const int key = key0 + (i >> 2) * 8 + (i & 1);
            const int row = row0 + ((i >> 1) & 1) * 8;
            if (key >= kv_len || (causal && key > row)) sc[i] = NEG_INF;
        }
    }
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(FULL, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(FULL, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r] * scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -m[r]));
        l[r] += sc[i];
    }
}

// P rounded to bf16 into the A fragments of P V: k16 step kk takes the score
// n-blocks 2kk (keys 0-7) and 2kk + 1 (keys 8-15), rows row0 and row0 + 8.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2])
{
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = 4 * (2 * kk + half);
            pa[kk][2 * half] = pack_bf16(sc[i], sc[i + 1]);
            pa[kk][2 * half + 1] = pack_bf16(sc[i + 2], sc[i + 3]);
        }
    }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], const float (&alpha)[2])
{
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// Named barriers 1 and 2 order the two consumers' products: each waits for
// its turn before issuing and passes the turn on after.
__device__ __forceinline__ void turn_wait(int g)
{
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
}

__device__ __forceinline__ void turn_pass(int g)
{
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - g) : "memory");
}

// One arrival per warp on an "empty" barrier: this warp is done with the stage.
__device__ __forceinline__ void release(uint32_t bar, int lane)
{
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p)
{
    using L = Layout<D>;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sQ = base + L::Q;
    const uint32_t sK = base + L::K;
    const uint32_t sV = base + L::V;
    const uint32_t q_full = base + L::BARS;
    const uint32_t k_full = q_full + 8;            // + 8 * stage, for each barrier array
    const uint32_t k_empty = k_full + 8 * STAGES;
    const uint32_t v_full = k_empty + 8 * STAGES;
    const uint32_t v_empty = v_full + 8 * STAGES;

    const int bh_count = p.batch * p.num_heads;
    const int bh = blockIdx.x % bh_count;
    int qt = blockIdx.x / bh_count;
    if (p.causal) qt = p.n_qtiles - 1 - qt;  // the longest KV loops start first
    const int b = bh / p.num_heads;
    const int h = bh % p.num_heads;
    const int q0 = qt * BM;
    // BM == BN, so the causal diagonal of query tile qt is key tile qt.
    const int n_kv = p.causal ? qt + 1 : (p.kv_len + BN - 1) / BN;

    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
            mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Broadcast from lane 0, so the compiler knows the role is warp-uniform.
    const int warp = __shfl_sync(FULL, tid / 32, 0);
    if (warp >= CONSUMER_WARPS) {
        // ---------------------------------------------------------- producer
        if (tid == 32 * CONSUMER_WARPS) {
            const int kvh = h / p.group;
            mbar_expect_tx(q_full, L::TILE);
#pragma unroll
            for (int c = 0; c < D / BOX_COLS; ++c)
                tma_load_4d(sQ + c * BLOCK_BYTES, &tq, q_full, c * BOX_COLS, q0, h, b);
            for (int j = 0; j < n_kv; ++j) {
                const int s = j % STAGES;
                // A fresh barrier counts its phase before 0 as complete: round 0 passes.
                const uint32_t parity = ((j / STAGES) & 1) ^ 1;
                mbar_wait(k_empty + 8 * s, parity);
                mbar_expect_tx(k_full + 8 * s, L::TILE);
#pragma unroll
                for (int c = 0; c < D / BOX_COLS; ++c)
                    tma_load_4d(sK + s * L::TILE + c * BLOCK_BYTES, &tk, k_full + 8 * s,
                                c * BOX_COLS, j * BN, kvh, b);
                mbar_wait(v_empty + 8 * s, parity);
                mbar_expect_tx(v_full + 8 * s, L::TILE);
#pragma unroll
                for (int c = 0; c < D / BOX_COLS; ++c)
                    tma_load_4d(sV + s * L::TILE + c * BLOCK_BYTES, &tv, v_full + 8 * s,
                                c * BOX_COLS, j * BN, kvh, b);
            }
        }
    } else {
        // -------------------------------------------------------------- consumers
        const int g = warp / 4;  // this warpgroup's 64 rows of the query tile
        const int lane = tid & 31;
        const int S = p.seq_len;
        const bool causal = p.causal != 0;
        const float scale_log2 = p.scale_log2;
        // This thread's rows of the wgmma accumulators: row0 and row0 + 8.
        const int row0 = q0 + 64 * g + 16 * (warp % 4) + (lane >> 2);
        const int key_lane = (lane & 3) * 2;
        const bool last_tile_masked = causal || p.kv_len % BN != 0;
        const uint32_t q_rows = sQ + g * 64 * 128;  // 64 rows of 128 bytes into each box

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF};
        float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced at the end
        float alpha[2];
        float sc[BN / 2];         // one tile's scores, then its probabilities
        uint32_t pa[BN / 16][4];  // the previous tile's probabilities as bf16 A fragments

        if (g == 1) turn_pass(g);  // the first consumer issues first
        mbar_wait(q_full, 0);
        // Tile 0: its scores and probabilities.
        turn_wait(g);
        mbar_wait(k_full, 0);
        wgmma_fence();
        issue_qk<D>(sc, q_rows, sK);
        wgmma_commit();
        turn_pass(g);
        wgmma_wait<0>();
        reg_fence(sc);
        release(k_empty, lane);
        online_softmax(sc, m, l, alpha, scale_log2, last_tile_masked && n_kv == 1, key_lane, row0,
                       p.kv_len, causal);
        pack_p(pa, sc);
        // Tile j - 1's probabilities meet V, then tile j's scores are computed;
        // the other consumer's products run during this one's softmax.
        for (int j = 1; j < n_kv; ++j) {
            const int s = j % STAGES;
            const int sp = (j - 1) % STAGES;
            scale_rows(o, alpha);
            turn_wait(g);
            mbar_wait(v_full + 8 * sp, ((j - 1) / STAGES) & 1);
            reg_fence(o);
            wgmma_fence();
            issue_pv<D>(o, pa, sV + sp * L::TILE);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(o);
            release(v_empty + 8 * sp, lane);
            mbar_wait(k_full + 8 * s, (j / STAGES) & 1);
            wgmma_fence();
            issue_qk<D>(sc, q_rows, sK + s * L::TILE);
            wgmma_commit();
            turn_pass(g);
            wgmma_wait<0>();
            reg_fence(sc);
            release(k_empty + 8 * s, lane);
            online_softmax(sc, m, l, alpha, scale_log2, last_tile_masked && j == n_kv - 1,
                           j * BN + key_lane, row0, p.kv_len, causal);
            pack_p(pa, sc);
        }
        // The last tile's probabilities meet V.
        const int s_last = (n_kv - 1) % STAGES;
        scale_rows(o, alpha);
        turn_wait(g);
        mbar_wait(v_full + 8 * s_last, ((n_kv - 1) / STAGES) & 1);
        reg_fence(o);
        wgmma_fence();
        issue_pv<D>(o, pa, sV + s_last * L::TILE);
        wgmma_commit();
        if (g == 0) turn_pass(g);  // the second consumer's last turn is its last
        wgmma_wait<0>();
        reg_fence(o);

        float denom[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(FULL, l[r], 1);
            l[r] += __shfl_xor_sync(FULL, l[r], 2);
            denom[r] = fmaxf(l[r], 1e-30f);
        }
        bf16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row >= S) continue;
            // m is in log2 units of the scaled scores: lse = m ln 2 + ln l.
            if (p.lse != nullptr && key_lane == 0)
                p.lse[(static_cast<long long>(b) * p.num_heads + h) * S + row] =
                    m[r] * LN2 + logf(denom[r]);
            bf16* orow = og + row * p.o_ss + key_lane;
#pragma unroll
            for (int nb = 0; nb < D / 8; ++nb) {
                *reinterpret_cast<uint32_t*>(orow + nb * 8) =
                    pack_bf16(o[4 * nb + 2 * r] / denom[r], o[4 * nb + 2 * r + 1] / denom[r]);
            }
        }
    }
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda on its link line.
EncodeTiledFn encode_tiled()
{
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

// A (B, S, heads, D) bf16 tensor through element strides (batch, sequence,
// head); boxes of 64 columns x 128 rows of one (b, head), 128-byte swizzle,
// zeros outside the tensor.  The stride of a size-1 dimension is never used
// and is replaced by 16 bytes, which TMA takes whatever the caller's view says.
CUresult make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int batch, int seq,
                  int heads, int d, long long sb, long long ss, long long sh)
{
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                                static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {
        seq > 1 ? static_cast<cuuint64_t>(ss) * 2 : 16,
        heads > 1 ? static_cast<cuuint64_t>(sh) * 2 : 16,
        batch > 1 ? static_cast<cuuint64_t>(sb) * 2 : 16,
    };
    const cuuint32_t box[4] = {BOX_COLS, BM, 1, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int grid, cudaStream_t stream)
{
    const int smem = Layout<D>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

constexpr int ENCODE_FAILED = -1;  // returned as -1000 - CUresult

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 when queued, a cudaError_t, or
// -1000 - CUresult when a tensor map could not be encoded.
// strides: 12 element strides, (batch, sequence, head) for q, k, v and o.
// kv_len: the keys' sequence length; a causal call must pass seq_len.
// lse: null, or a contiguous float32 (batch, num_heads, seq_len) output that
// takes each row's log-sum-exp (natural log) of the D^-0.5-scaled scores.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                const long long* strides, int batch, int seq_len, int kv_len,
                                int num_heads, int num_kv_heads, int head_dim, int causal,
                                void* stream)
{
    if (batch < 1 || seq_len < 1 || kv_len < 1 || (causal && kv_len != seq_len) ||
        num_heads < 1 || num_kv_heads < 1 || num_heads % num_kv_heads != 0 ||
        (head_dim != 64 && head_dim != 128))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n_qtiles = (seq_len + BM - 1) / BM;
    const long long grid = n_qtiles * batch * num_heads;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);

    CUtensorMap tq, tk, tv;
    CUresult res = make_map(encode, &tq, q, batch, seq_len, num_heads, head_dim, strides[0],
                            strides[1], strides[2]);
    if (res == CUDA_SUCCESS)
        res = make_map(encode, &tk, k, batch, kv_len, num_kv_heads, head_dim, strides[3],
                       strides[4], strides[5]);
    if (res == CUDA_SUCCESS)
        res = make_map(encode, &tv, v, batch, kv_len, num_kv_heads, head_dim, strides[6],
                       strides[7], strides[8]);
    if (res != CUDA_SUCCESS) return ENCODE_FAILED * 1000 - static_cast<int>(res);

    Params p;
    p.o = static_cast<bf16*>(o);
    p.lse = static_cast<float*>(lse);
    p.o_sb = strides[9];
    p.o_ss = strides[10];
    p.o_sh = strides[11];
    p.seq_len = seq_len;
    p.kv_len = kv_len;
    p.num_heads = num_heads;
    p.group = num_heads / num_kv_heads;
    p.batch = batch;
    p.n_qtiles = static_cast<int>(n_qtiles);
    p.causal = causal ? 1 : 0;
    p.scale_log2 = static_cast<float>(LOG2E / sqrt(static_cast<double>(head_dim)));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = head_dim == 128 ? launch<128>(tq, tk, tv, p, static_cast<int>(grid), s)
                                            : launch<64>(tq, tk, tv, p, static_cast<int>(grid), s);
    return static_cast<int>(err);
}

const char* flash_attention_sm90_error_string(int err)
{
    static thread_local char buf[96];
    if (err <= ENCODE_FAILED * 1000) {
        snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled returned CUresult %d", -1000 - err);
        return buf;
    }
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
