// Sparse MTTKRP over a mode-ordered plan, balanced by nonzeros, for NVIDIA
// Hopper (sm_90a).  The main path's MTTKRP kernel; csrc/mttkrp.cu (one CTA per
// output block) is kept beside it as the "block" variant.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mttkrp/kernel.py:_kernel
// (launched by mttkrp_pallas_call).  It computes, for output mode `mode`,
//
//     out[b, i, r] = sum_{n : idx[n, mode] = i} vals[n] * prod_{k != mode} F_k[b, idx[n, k], r]
//
// over the plan's nonzero stream: nonzeros sorted by output row, grouped into
// output blocks, each block padded to whole tiles with entries of value 0
// (block_nnz_start[blk] .. block_real_end[blk] holds the block's real
// nonzeros, the rest up to block_nnz_start[blk + 1] is padding).
//
// What bounds it on the H100.  The bytes the function needs are 4*N per
// nonzero (N indices incl. the output row, and the value): ~1.1 GB at NELL-2
// size, 0.34 ms at 3.35 TB/s.  On top of that each nonzero gathers N-1 factor
// rows of R values that live in the 50 MB L2 (NELL-2's factors are < 2 MB at
// R = 16).  The TPU design does not carry over: its grid walks the blocks in
// order on one core, while a Zipf-skewed tensor's largest output block holds
// 2.6-4.5x the mean block's nonzeros and its hottest row 3-4% of all of them.
// One CTA per block left most SMs idle and the time set by the largest block.
//
// Design (after merge-path SpMV, Merrill & Garland, SC'16):
//
//  * Nonzero-balanced, persistent grid.  The grid is a few CTAs per SM (the
//    occupancy API's count times the SM count), and every warp of it takes an
//    equal contiguous slice [nnz_pad*w/W, nnz_pad*(w+1)/W) of the padded
//    stream, computed from its index w alone.  The plan's block size does not
//    set the parallelism.
//  * Rows from the stream.  A nonzero's output row is idx[n, mode], which
//    is streamed anyway: 16 bytes per nonzero at N = 3.  Padding entries are
//    skipped by position (n >= block_real_end of their block), never by
//    value, so they add nothing even where a factor's row 0 holds inf/NaN.
//    A skipped entry takes the row of the last real entry before it and adds
//    nothing; since padding only ever lies between two different rows, this
//    neither splits nor merges a run.
//  * Work in flight.  A warp takes 8 nonzeros per step, 4 threads per
//    nonzero with 4 rank columns each (float4 gathers, 8-byte for bf16), and
//    issues the index loads and factor gathers of U = 4 steps before it
//    consumes any.  That needs straight-line code: the loads are never
//    guarded (addresses are clamped to valid rows instead, and the results
//    of entries past the slice or in padding are dropped), three-mode
//    tensors gather exactly the two other factors (passed in mode order,
//    so no run-time mode test), and vector loads are a template parameter.
//    A branch around a gather gets its own block and a reused destination
//    register, so the gathers of a step would wait on one another.  With B
//    restarts (the fused path) one pass over the stream gathers and
//    accumulates up to 4 factor sets.
//  * Runs summed in registers.  While every nonzero of U steps continues
//    the warp's open row run (one vote), each thread adds its products to
//    its own register sums.  A step in which a row ends sums the run over
//    the 8 nonzero groups (a fixed butterfly) and resolves the step's other
//    runs by a segmented scan over the groups, again in a fixed order.
//  * Store once, with no atomics.  A warp stores every row whose run starts
//    and ends inside its slice, and zero-fills the empty rows between two of
//    its runs.  Its first and last run may be shared with neighbouring
//    warps, so they go to a (W, 2, B, R) carry scratch with their rows.  A
//    second, small launch takes one warp per slice: the warp whose slice
//    holds a row's first carry sums the carries of that row in slice order
//    and stores it once, and zero-fills the empty rows between its first row
//    and the previous slice's last row (a last slot zero-fills the rows after
//    the stream's last row).  So every output element is stored exactly once
//    across the pair of launches (the paper's Algorithm 1, line 11), every
//    sum runs in an order fixed by the grid, and two launches on the same
//    inputs and the same card agree bit for bit.
//
// Rank columns beyond 16 run in further passes over the stream (grid.y), and
// restarts beyond 4 in further passes (grid.z).  All nonzero offsets are
// 64-bit.
//
// Everything above is the row-run mode, which needs each output row's
// nonzeros to be one run of the stream (orderings lex, secondary-sort and
// degree).  The "blocked" ordering keeps only the output block as its
// primary key and brings a row back once per input band, so the row-run
// mode would store such a row once per run.  The TPU kernel is right for it
// because it accumulates the whole block in VMEM.  The tile mode (at the end
// of this file) does the same per CTA in shared memory, each warp adding to
// its own part of the tile; the wrapper picks the mode from the plan's
// contiguity flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_MODES 8
#define THREADS 256
#define WARPS (THREADS / 32)
#define TPN 4                 // threads per nonzero
#define GROUPS (32 / TPN)     // nonzeros per warp step
#define CHUNK (TPN * 4)       // rank columns per pass
#define FULL 0xffffffffu

// The audit build (-DMTTKRP_AUDIT, a library of its own: kernels/build.py)
// counts what the four kernels below do, to hold them to the contracts the
// JAX package proves of its Pallas kernel: every output element stored
// exactly once, no carry, partial sum or tile row read before it is written
// or zero-filled, and the nonzeros consumed equal to the performance model's
// census (per restart: nnz values, N*nnz index columns, (N-1)*nnz factor
// rows).  Its wrapper (kernel.mttkrp_cuda_audit) fills the output and the
// carries with AUDIT_UNSET and the carry rows or blocks with AUDIT_UNSET_IDX,
// so a read of a slot never written shows as that pattern.  The float sums
// run in the same order as in the production kernels, so both builds give
// the same bits.  Without the macro none of it is compiled.
#ifdef MTTKRP_AUDIT
#define AUDIT_UNSET 0x7fbadbadu        // a NaN no arithmetic produces
#define AUDIT_UNSET_IDX (-2147483647 - 1)
#define AUDIT_COUNTS 3                 // per restart: nonzeros, index columns, factor rows
#define AUDIT_READ 0                   // stream entries read (row-run) or staged (tile), first pass
#define AUDIT_UNINIT 1                 // reads of a slot never written or zero-filled
struct Audit {
    int* stores;                   // (batch, i_out, rank): stores each output element received
    unsigned long long* restart;   // (batch, AUDIT_COUNTS)
    unsigned long long* counts;    // [AUDIT_READ], [AUDIT_UNINIT]
};
static Audit g_audit{};  // set by mttkrp_audit_buffers before a launch
#define AUDIT_PARAM , Audit audit
#define AUDIT_ARG , g_audit

// n consecutive output elements from `elem` received one store each.
__device__ __forceinline__ void audit_store(const Audit& a, long long elem, int n)
{
    for (int j = 0; j < n; ++j) atomicAdd(a.stores + elem + j, 1);
}
__device__ __forceinline__ bool audit_unset(float x) { return __float_as_uint(x) == AUDIT_UNSET; }
__device__ __forceinline__ void audit_uninit(const Audit& a, int n)
{
    if (n) atomicAdd(a.counts + AUDIT_UNINIT, static_cast<unsigned long long>(n));
}
__device__ __forceinline__ void audit_value(const Audit& a, float x) { audit_uninit(a, audit_unset(x)); }
__device__ __forceinline__ void audit_index(const Audit& a, int x) { audit_uninit(a, x == AUDIT_UNSET_IDX); }
__device__ __forceinline__ void audit_row4(const Audit& a, const float4& t)
{
    audit_uninit(a, audit_unset(t.x) + audit_unset(t.y) + audit_unset(t.z) + audit_unset(t.w));
}
#else
#define AUDIT_PARAM
#define AUDIT_ARG
#endif

struct FactorArgs {
    const void* ptr[MAX_MODES - 1];         // the factors other than the output mode's
    long long batch_stride[MAX_MODES - 1];  // elements between restarts; 0 = shared
    int col[MAX_MODES - 1];                 // each one's column of the indices
};

// Four rank columns of a factor row.  VEC: one aligned vector load (rank % 4
// == 0 and aligned bases); else four scalar loads of columns
// min(j, ncols - 1), ncols >= 1.  Never a branch, so that the gathers of
// several nonzeros stay in flight together.
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int ncols, float (&x)[4])
{
    if constexpr (VEC) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = __ldg(p + min(j, ncols - 1));
    }
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int ncols, float (&x)[4])
{
    if constexpr (VEC) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
        x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = __bfloat162float(p[min(j, ncols - 1)]);
    }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int ncols, const float (&x)[4])
{
    if constexpr (VEC) {
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (j < ncols) p[j] = x[j];
    }
}

// NO: the number of factors gathered per nonzero (nmodes - 1), or 0 for
// any of 0..7 (then read at run time); NB: restarts per pass; U: steps per
// iteration.  With one restart the registers are capped for 3 CTAs per SM
// (faster at NELL-2 size than 2); with four the cap would spill.
template <typename T, int NO, int NB, int U, bool VEC>
__global__ void __launch_bounds__(THREADS, NB == 1 ? 3 : 1) mttkrp_split_kernel(
    const int32_t* __restrict__ indices,          // (nnz_pad, nmodes)
    const float* __restrict__ values,             // (nnz_pad,)
    const int64_t* __restrict__ block_start,      // (num_blocks + 1,)
    const int64_t* __restrict__ block_real_end,   // (num_blocks,)
    FactorArgs fac,
    float* __restrict__ out,                      // (batch, i_out, rank)
    float* __restrict__ carry_val,                // (W, 2, batch, rank)
    int32_t* __restrict__ carry_row,              // (W, 2)
    long long nnz_pad, int num_blocks, int nmodes, int mode, int rank, int batch, int i_out
    AUDIT_PARAM)
{
    constexpr int MO = NO > 0 ? NO : MAX_MODES - 1;
    const int nother = NO > 0 ? NO : nmodes - 1;
    const int lane = threadIdx.x & 31;
    const int g = lane / TPN;  // nonzero group of the warp step
    const int q = lane % TPN;  // 4-column slice of the rank chunk
    const long long num_warps = static_cast<long long>(gridDim.x) * WARPS;
    const long long w = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
    const long long lo = nnz_pad * w / num_warps;
    const long long hi = nnz_pad * (w + 1) / num_warps;
    const int c0 = blockIdx.y * CHUNK + q * 4;
    const int ncols = rank - c0;  // > 0: this thread owns min(4, ncols) columns
    const bool active = ncols > 0;
    const int b0 = blockIdx.z * NB;
    const int nb = min(NB, batch - b0);
    const long long cols = static_cast<long long>(batch) * rank;

    // Gathers read column 0 on threads without columns and restart b0 in
    // place of restarts past the batch: valid rows, results never stored.
    const int gather_cols = active ? ncols : 1;
    const T* f[MO];
    long long fstride[MO];
    int fcol[MO];
#pragma unroll
    for (int j = 0; j < MO; ++j) {
        const bool used = j < nother;
        f[j] = used ? static_cast<const T*>(fac.ptr[j]) + b0 * fac.batch_stride[j] +
                          (active ? c0 : 0)
                    : nullptr;
        fstride[j] = used ? fac.batch_stride[j] : 0;
        fcol[j] = used ? fac.col[j] : 0;
    }

    // The block of this thread's first entry, then followed as n grows.
    long long n_next = lo + g;
    int blk = 0;
    {
        int a = 0, z = num_blocks;  // block_start[a] <= n < block_start[z]
        while (z - a > 1) {
            const int m = (a + z) >> 1;
            if (block_start[m] <= n_next) a = m; else z = m;
        }
        blk = a;
    }
    long long blk_end = block_start[blk + 1];
    long long real_end = block_real_end[blk];

    int cur_row = -1;    // the warp's open run (-1: no real entry yet)
    int first_row = -1;  // the warp's first run: it goes to carry slot 0
    float acc[NB][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] = 0.0f;

    // A run's total over the 8 groups, in a fixed butterfly (every lane ends
    // with the same bits: each level adds a commuted pair).
    auto group_sum = [&](float (&x)[NB][4], float (&t)[NB][4]) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float s = x[b][j];
#pragma unroll
                for (int off = TPN; off < 32; off <<= 1) s += __shfl_xor_sync(FULL, s, off);
                t[b][j] = s;
            }
    };
    // One group's 4 threads write a finished run: carry slot 0 or 1, or
    // (slot -1) the output row itself.
    auto emit = [&](int row, const float (&t)[NB][4], int slot) {
        if (!active) return;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            if (b >= nb) break;
            const long long bb = b0 + b;
            float* dst = slot >= 0
                ? carry_val + (w * 2 + slot) * cols + bb * rank + c0
                : out + (bb * i_out + row) * rank + c0;
            store4<VEC>(dst, ncols, t[b]);
#ifdef MTTKRP_AUDIT
            if (slot < 0) audit_store(audit, (bb * i_out + row) * rank + c0, min(ncols, 4));
#endif
        }
    };
    auto zero_rows = [&](int from, int to) {
        if (!active) return;
        const float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int r = from; r < to; ++r)
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                if (b >= nb) break;
                store4<VEC>(out + ((b0 + b) * static_cast<long long>(i_out) + r) * rank + c0,
                            ncols, z);
#ifdef MTTKRP_AUDIT
                audit_store(audit, ((b0 + b) * static_cast<long long>(i_out) + r) * rank + c0,
                            min(ncols, 4));
#endif
            }
    };
#ifdef MTTKRP_AUDIT
    // One lane per nonzero (q == 0) counts, in the first column pass.
    unsigned a_nnz = 0, a_idx = 0, a_rows = 0, a_read = 0;
#endif

    for (long long base = lo; base < hi; base += U * GROUPS) {
        // Loads of the U steps, all issued before any is used: the stream
        // entry (clamped into the slice), then the factor rows it names.
        int row[U];
        float p[U][NB][4];
#ifdef MTTKRP_AUDIT
        int a_cols[U], a_gath[U];  // index columns read and factor rows gathered (one restart)
#endif
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long n = base + u * GROUPS + g;
            const long long nc = n < hi ? n : hi - 1;
            const int32_t* idx_n = indices + nc * nmodes;
            row[u] = __ldg(idx_n + mode);
            const float val = __ldg(values + nc);
            int ix[MO];
#pragma unroll
            for (int j = 0; j < MO; ++j) ix[j] = j < nother ? __ldg(idx_n + fcol[j]) : 0;
#ifdef MTTKRP_AUDIT
            a_cols[u] = 1;
            a_gath[u] = 0;
#pragma unroll
            for (int j = 0; j < MO; ++j) a_cols[u] += j < nother;
#endif
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int c = 0; c < 4; ++c) p[u][b][c] = val;
#pragma unroll
            for (int j = 0; j < MO; ++j) {
                if (j >= nother) break;
#ifdef MTTKRP_AUDIT
                ++a_gath[u];
#endif
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    float x[4];
                    load4<VEC>(f[j] + (b < nb ? b : 0) * fstride[j] +
                                   static_cast<long long>(ix[j]) * rank,
                               gather_cols, x);
#pragma unroll
                    for (int c = 0; c < 4; ++c) p[u][b][c] *= x[c];
                }
            }
        }
        // Entries past the slice, and padding (past their block's real ones),
        // add nothing and name no row.
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long n = base + u * GROUPS + g;
            while (n >= blk_end && blk + 1 < num_blocks) {
                ++blk;
                blk_end = block_start[blk + 1];
                real_end = block_real_end[blk];
            }
            if (n >= hi || n >= real_end) {
                row[u] = -1;
#pragma unroll
                for (int b = 0; b < NB; ++b)
#pragma unroll
                    for (int c = 0; c < 4; ++c) p[u][b][c] = 0.0f;
            }
#ifdef MTTKRP_AUDIT
            if (q == 0 && blockIdx.y == 0) {
                a_read += blockIdx.z == 0;
                if (row[u] >= 0) {
                    ++a_nnz;
                    a_idx += a_cols[u];
                    a_rows += a_gath[u];
                }
            }
#endif
        }
        // The common case: every entry of the U steps continues the open run.
        bool goes_on = true;
#pragma unroll
        for (int u = 0; u < U; ++u) goes_on &= row[u] < 0 || row[u] == cur_row;
        if (__all_sync(FULL, goes_on)) {
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int b = 0; b < NB; ++b)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[b][c] += p[u][b][c];
            continue;
        }

#pragma unroll
        for (int u = 0; u < U; ++u) {
            // Effective row: the last real row up to this entry (running max).
            int re = row[u];
#pragma unroll
            for (int off = 1; off < GROUPS; off <<= 1) {
                const int t = __shfl_up_sync(FULL, re, off * TPN);
                if (g >= off) re = max(re, t);
            }
            re = max(re, cur_row);
            const bool same = re == cur_row;
            if (__all_sync(FULL, same)) {  // the open run goes on
#pragma unroll
                for (int b = 0; b < NB; ++b)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[b][c] += p[u][b][c];
                continue;
            }
            // A run ends in this step.  `same` groups are a prefix and the
            // last group is not one of them.
            if (first_row < 0) {
                const unsigned m = __ballot_sync(FULL, re >= 0);
                first_row = __shfl_sync(FULL, re, __ffs(m) - 1);
            }
            if (same) {
#pragma unroll
                for (int b = 0; b < NB; ++b)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[b][c] += p[u][b][c];
            }
            if (cur_row >= 0) {
                float t[NB][4];
                group_sum(acc, t);
                if (g == 0) emit(cur_row, t, cur_row == first_row ? 0 : -1);
            }
            int re_prev = __shfl_up_sync(FULL, re, TPN);
            if (g == 0) re_prev = cur_row;
            const bool head = !same && re != re_prev;
            if (head && re_prev >= 0) zero_rows(re_prev + 1, re);
            // Segmented inclusive scan of the other runs over the groups.
            float v[NB][4];
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int c = 0; c < 4; ++c) v[b][c] = same ? 0.0f : p[u][b][c];
            int flag = head || g == 0;
#pragma unroll
            for (int off = 1; off < GROUPS; off <<= 1) {
                const int fu = __shfl_up_sync(FULL, flag, off * TPN);
#pragma unroll
                for (int b = 0; b < NB; ++b)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const float up = __shfl_up_sync(FULL, v[b][c], off * TPN);
                        if (g >= off && !flag) v[b][c] = up + v[b][c];
                    }
                if (g >= off) flag |= fu;
            }
            const int re_next = __shfl_down_sync(FULL, re, TPN);
            if (!same && g < GROUPS - 1 && re_next != re)
                emit(re, v, re == first_row ? 0 : -1);  // a run inside this step
            cur_row = __shfl_sync(FULL, re, 31);
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[b][c] = g == GROUPS - 1 ? v[b][c] : 0.0f;
        }
    }

    // The open run ends with the slice: the warp's last carry (or its first,
    // if the slice holds one run).
    float t[NB][4];
    group_sum(acc, t);
    if (cur_row >= 0 && g == 0) emit(cur_row, t, cur_row == first_row ? 0 : 1);
    if (lane == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
        carry_row[2 * w] = first_row;
        carry_row[2 * w + 1] = cur_row != first_row ? cur_row : -1;
    }
#ifdef MTTKRP_AUDIT
    // The warps' counts summed in shared memory, then one atomic per CTA and
    // counter (every thread of the CTA reaches this point).
    __shared__ unsigned long long a_sum[4];
    if (threadIdx.x < 4) a_sum[threadIdx.x] = 0;
    __syncthreads();
    const unsigned a_val[4] = {a_nnz, a_idx, a_rows, a_read};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned s = __reduce_add_sync(FULL, a_val[k]);
        if (lane == 0 && s) atomicAdd(a_sum + k, static_cast<unsigned long long>(s));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int b = 0; b < nb; ++b)
            for (int k = 0; k < AUDIT_COUNTS; ++k)
                if (a_sum[k]) atomicAdd(audit.restart + (b0 + b) * AUDIT_COUNTS + k, a_sum[k]);
        if (a_sum[3]) atomicAdd(audit.counts + AUDIT_READ, a_sum[3]);
    }
#endif
}

// One warp per slice v (and one for v == W): stores the rows whose first
// carry slice v holds, summed over the carries of that row in slice order,
// and zero-fills the empty rows before slice v's first row.
__global__ void __launch_bounds__(THREADS) mttkrp_carry_kernel(
    const float* __restrict__ carry_val, const int32_t* __restrict__ carry_row,
    float* __restrict__ out, int num_warps, int batch, int rank, int i_out AUDIT_PARAM)
{
    const int lane = threadIdx.x & 31;
    const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (v > num_warps) return;
    const long long cols = static_cast<long long>(batch) * rank;

    // The last real row before slice v: the nearest earlier slice with a row.
    int prev = -1;
    for (int j0 = v - 1; j0 >= 0; j0 -= 32) {
        const int j = j0 - lane;
        const int fr = j >= 0 ? carry_row[2 * j] : -1;
#ifdef MTTKRP_AUDIT
        audit_index(audit, fr);
#endif
        const unsigned m = __ballot_sync(FULL, fr >= 0);
        if (m) {
            const int jj = j0 - (__ffs(m) - 1);
            const int lr = carry_row[2 * jj + 1];
#ifdef MTTKRP_AUDIT
            if (lane == 0) audit_index(audit, lr);
#endif
            prev = lr >= 0 ? lr : carry_row[2 * jj];
            break;
        }
    }
    auto zero_rows = [&](int from, int to) {
        const long long count = static_cast<long long>(to - from) * cols;
        for (long long e = lane; e < count; e += 32) {
            const long long r = from + e / cols;
            const long long c = e % cols;
            out[((c / rank) * i_out + r) * rank + c % rank] = 0.0f;
#ifdef MTTKRP_AUDIT
            audit_store(audit, ((c / rank) * i_out + r) * rank + c % rank, 1);
#endif
        }
    };
    if (v == num_warps) {  // after the stream's last row
        if (prev + 1 < i_out) zero_rows(prev + 1, i_out);
        return;
    }
    const int first = carry_row[2 * v];
    const int last = carry_row[2 * v + 1];
#ifdef MTTKRP_AUDIT
    if (lane == 0) {
        audit_index(audit, first);
        audit_index(audit, last);
    }
#endif
    if (first < 0) return;  // no real entry in this slice

    // Sum row `row` from slice v's carry `slot` and, if the row may go on,
    // the first carries of the following slices that hold it; store it once.
    auto finish = [&](int row, int slot, bool goes_on) {
        int end = v;
        if (goes_on) {
            for (int j0 = v + 1; j0 < num_warps; j0 += 32) {
                const int j = j0 + lane;
                const int fr = j < num_warps ? carry_row[2 * j] : -2;
                const int lr = j < num_warps ? carry_row[2 * j + 1] : -1;
#ifdef MTTKRP_AUDIT
                audit_index(audit, fr);
                audit_index(audit, lr);
#endif
                const bool take = fr == row;
                const bool stop = (fr != row && fr != -1) || (take && lr >= 0);
                const unsigned sm = __ballot_sync(FULL, stop);
                unsigned tm = __ballot_sync(FULL, take);
                if (sm) tm &= (2u << (__ffs(sm) - 1)) - 1u;
                if (tm) end = j0 + 31 - __clz(tm);
                if (sm) break;
            }
        }
        for (long long c = lane; c < cols; c += 32) {
            float s = carry_val[(2LL * v + slot) * cols + c];
#ifdef MTTKRP_AUDIT
            audit_value(audit, s);
            for (int j = v + 1; j <= end; ++j)
                if (carry_row[2 * j] == row) audit_value(audit, carry_val[2LL * j * cols + c]);
            audit_store(audit, ((c / rank) * i_out + row) * rank + c % rank, 1);
#endif
#pragma unroll 8
            for (int j = v + 1; j <= end; ++j)
                if (carry_row[2 * j] == row) s += carry_val[2LL * j * cols + c];
            out[((c / rank) * i_out + row) * rank + c % rank] = s;
        }
    };
    if (first != prev) {  // slice v holds row `first`'s first carry
        if (prev + 1 < first) zero_rows(prev + 1, first);
        finish(first, 0, last < 0);
    }
    if (last >= 0) finish(last, 1, true);
}

// Steps per iteration: 4 with one restart, 2 with four (register budget).
#define SPLIT_KERNEL(T, NO, NB, VEC) mttkrp_split_kernel<T, NO, NB, (NB == 1 ? 4 : 2), VEC>

template <typename T, int NO, int NB, bool VEC>
static cudaError_t ctas_for(int* ctas)
{
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, SPLIT_KERNEL(T, NO, NB, VEC),
                                                            THREADS, 0);
    if (err == cudaSuccess) *ctas = (per_sm > 0 ? per_sm : 1) * sms;
    return err;
}

struct LaunchArgs {
    const int32_t* indices;
    const float* values;
    const int64_t* block_start;
    const int64_t* block_real_end;
    FactorArgs fac;
    float* out;
    float* carry_val;
    int32_t* carry_row;
    long long nnz_pad;
    int num_blocks, nmodes, mode, rank, batch, i_out, ctas;
    int rows_per_block = 0;  // tile mode only
};

template <typename T, int NO, int NB, bool VEC>
static cudaError_t launch(const LaunchArgs& a, cudaStream_t stream)
{
    const dim3 grid(a.ctas, (a.rank + CHUNK - 1) / CHUNK, (a.batch + NB - 1) / NB);
    SPLIT_KERNEL(T, NO, NB, VEC)<<<grid, THREADS, 0, stream>>>(
        a.indices, a.values, a.block_start, a.block_real_end, a.fac, a.out, a.carry_val,
        a.carry_row, a.nnz_pad, a.num_blocks, a.nmodes, a.mode, a.rank, a.batch, a.i_out AUDIT_ARG);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int num_warps = a.ctas * WARPS;
    mttkrp_carry_kernel<<<(num_warps + 1 + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        a.carry_val, a.carry_row, a.out, num_warps, a.batch, a.rank, a.i_out AUDIT_ARG);
    return cudaGetLastError();
}

// With a null `a`, the CTA count of the kernel the shape takes; else its
// launch.  Three modes (the main path) gather exactly two factors, with
// vector loads where aligned; other mode counts take the general kernel.
template <typename T, int NB>
static cudaError_t dispatch_nb(const LaunchArgs* a, int nmodes, int vec, cudaStream_t s, int* ctas)
{
    if (nmodes == 3) {
        if (!a) return ctas_for<T, 2, NB, true>(ctas);
        return vec ? launch<T, 2, NB, true>(*a, s) : launch<T, 2, NB, false>(*a, s);
    }
    if (!a) return ctas_for<T, 0, NB, false>(ctas);
    return launch<T, 0, NB, false>(*a, s);
}

template <typename T>
static cudaError_t dispatch(const LaunchArgs* a, int nmodes, int batch, int vec, cudaStream_t s,
                            int* ctas)
{
    return batch == 1 ? dispatch_nb<T, 1>(a, nmodes, vec, s, ctas)
                      : dispatch_nb<T, 4>(a, nmodes, vec, s, ctas);
}


// ---------------------------------------------------------------------------
// Tile mode: any plan, including those whose rows are not contiguous.
//
// Replaces the same TPU kernel (src/repro/kernels/mttkrp/kernel.py:_kernel)
// on the plans it is right for because it accumulates a whole output block
// in VMEM: the "blocked" ordering's, which keep the output block as their
// primary key and bring a row back once per input band.
//
// What bounds it on the H100 is the same 16 bytes per nonzero of stream (at
// N = 3) as in the row-run mode.  What held an earlier design, a tile per
// warp, at 7% of that bound was latency: the tiles left 14 warps on an SM,
// each waiting on factor gathers from L2, and every 8 nonzeros took a chain
// of some 40 warp-wide shuffles and votes, because the blocked ordering's
// runs are about one nonzero long.  This design:
//
//  * One tile per CTA.  Each CTA of a persistent grid (the occupancy API's
//    CTAs per SM times the SM count) takes an equal contiguous slice
//    [nnz_pad*c/C, nnz_pad*(c+1)/C) of the padded stream, and holds in
//    shared memory one tile of the output block it is in: rows_per_block x
//    16 columns x b_pass restarts, float32 (16 KB a restart at 256 rows).
//  * Warps own disjoint parts.  Warp (b, h) of a CTA of TILE_SPLIT = 2
//    warps per restart adds only to columns 8h..8h+7 of restart b; the tile
//    is laid out [restart][row][16].  No two warps write one word, so the
//    loop needs no atomics and no block barrier.  Warps without columns
//    (rank 8 and below in a pass) or restart (a ragged restart pass) exit
//    at the start.
//  * 16 nonzeros a step, 2 lanes a nonzero, U = 4 steps in flight.  A lane
//    gathers one float4 (its four columns; 8 bytes in bf16) of each input
//    factor row of its nonzero, so a warp's gather covers 32 bytes of 16
//    rows, with clamped, unguarded addresses, and multiplies.  Then
//    neighbouring nonzeros compare rows (two shuffles): where every row of
//    the step differs from its neighbour's, each nonzero's lanes add its
//    product to its tile row, a float4 read-modify-write each.  Runs longer
//    than one nonzero are summed by a segmented scan over the step's
//    nonzeros in a fixed order, as many rounds as the longest run needs,
//    and the run's last nonzero adds the sum.  A row can come back later in
//    the same step only after a descent of the row (the blocked ordering
//    starts a new input band); each descent starts a new turn, and the
//    turns add one after the other in stream order.  The shuffles and
//    votes of the U steps are independent and issued together; only the
//    read-modify-writes go one step after the other.  Every sum thus runs
//    in an order fixed by the grid, and two launches on the same inputs
//    agree bit for bit.
//    Measured on the card beside this layout: warps of one 4-column
//    quarter, a lane a nonzero, gathered 16 bytes of each row four times
//    over and took 1.4 times as long at NELL-2 Table II size; 4 lanes a
//    nonzero and one warp a restart, whose 16 KB tile left 10 warps on an
//    SM, took longer too.
//  * Indices and values once per CTA.  The warps of a CTA read the same
//    entries, so they are staged into a ring of TILE_STAGES chunks of
//    TILE_STAGE nonzeros by Hopper's bulk asynchronous copy (cp.async.bulk,
//    completion counted on an mbarrier), TILE_AHEAD chunks ahead of the
//    one in use; the warps read them from shared memory (faster on the
//    card than each warp's own __ldg of them).  With b_pass restarts a pass
//    the stream is read once for all of them.  Chunks start
//    at a multiple of 4 entries, so that every copy is 16-byte aligned; the
//    stream's last nnz_pad % 4 entries are copied by plain loads.
//  * Store once, with no atomics.  When the stream leaves a block, each warp
//    stores its part of the tile: to the output if the CTA's slice holds
//    the block whole, else to the CTA's carry slot 0 (its first block) or 1
//    (its last).  The tile starts at zero, so every row of the block gets
//    its value, and every block (an empty one holds a tile of padding) is
//    stored.  A second launch sums each shared block's carry tiles in slice
//    order and stores it once.  So every output element is stored exactly
//    once across the pair of launches.
//
// Padding is skipped by position (block_real_end), as in the row-run mode.
// Rank columns beyond 16 run in further passes (grid.y), restarts beyond
// b_pass in further passes (grid.z).  On the card the design still takes
// about 11 times its byte bound at one restart: its time grows with
// restarts x nonzeros (B = 4 costs 3.8 times B = 1), not with the stream,
// and it ran faster with every extra warp per SM that was tried, so what
// bounds it is the latency of each warp's chain of gathers, shuffles and
// read-modify-writes with 20-24 warps on an SM.
#define TILE_TPN 2                               // lanes per nonzero, 4 columns each
#define TILE_GROUPS (32 / TILE_TPN)              // nonzeros per warp step
#define TILE_SPLIT (CHUNK / (4 * TILE_TPN))      // warps per restart, a column part each
#define TILE_HEADS (TILE_TPN == 4 ? 0x11111111u : 0x55555555u)  // each nonzero's first lane
#define TILE_MAX_PASS 4        // restarts per pass
#define TILE_U 4               // warp steps of TILE_GROUPS nonzeros in flight
#define TILE_STAGE 64          // nonzeros per staged chunk: a multiple of TILE_GROUPS * TILE_U and of 4
#define TILE_STAGES 4          // chunks in the ring
#define TILE_AHEAD 2           // chunks filled ahead of the one in use; the other one is slack

// Bytes of dynamic shared memory a CTA takes: the tile, the staging ring and
// its barriers.
static size_t tile_smem_bytes(int nmodes, int rpb, int b_pass)
{
    return static_cast<size_t>(b_pass) * rpb * CHUNK * 4 +
           static_cast<size_t>(TILE_STAGES) * TILE_STAGE * (nmodes + 1) * 4 +
           2 * TILE_STAGES * sizeof(uint64_t);
}

// Restarts a pass on the current device: the most, at most TILE_MAX_PASS and
// at most `batch`, whose CTA fits the shared memory a block may opt in to; 0
// when a single restart's does not.
static cudaError_t tile_b_pass(int nmodes, int rpb, int batch, int* b_pass)
{
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    *b_pass = 0;
    for (int b = 1; b <= TILE_MAX_PASS && b <= batch; ++b)
        if (tile_smem_bytes(nmodes, rpb, b) <= static_cast<size_t>(limit)) *b_pass = b;
    return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

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
// that outlasts any real copy (2^26 polls, seconds) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
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

// `bytes` (a multiple of 16) from 16-byte aligned global memory into shared
// memory; completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Runs and turns of S warp steps at once, so that their shuffles and votes
// overlap.  For step s, key[s] is each lane's tile row (-1: it adds
// nothing; the groups that add are a contiguous range).  On return, on the
// last group of each run of one row (tail[s]), v[s] holds the run's sum, a
// segmented scan over the groups in a fixed order, as many rounds as the
// longest run needs; seg[s] is that group's non-descending segment of rows
// (its turn), and turns[s] the step's last turn.
template <int S>
__device__ __forceinline__ void tile_runs(const int (&key)[S], float (&v)[S][4], bool (&tail)[S],
                                          int (&seg)[S], int (&turns)[S])
{
    const int lane = threadIdx.x & 31;
    const int g = lane / TILE_TPN;
    const unsigned heads_le = (0xffffffffu >> (31 - lane)) & TILE_HEADS;  // groups 0..g
    bool open[S];  // the lane's sum has not reached its run's head
    unsigned scan = 0;  // the steps with a run longer than one nonzero
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int kp = __shfl_up_sync(FULL, key[s], TILE_TPN);
        const int kn = __shfl_down_sync(FULL, key[s], TILE_TPN);
        const bool valid = key[s] >= 0;
        const bool head = valid && (g == 0 || kp != key[s]);
        tail[s] = valid && (g == TILE_GROUPS - 1 || kn != key[s]);
        open[s] = valid && !head;
        if (__any_sync(FULL, open[s])) scan |= 1u << s;
        const unsigned desc = __ballot_sync(FULL, valid && kp > key[s]) & TILE_HEADS;
        seg[s] = __popc(desc & heads_le);
        turns[s] = __popc(desc);
    }
    for (int off = TILE_TPN; scan; off <<= 1) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            if (!(scan & (1u << s))) continue;
            const bool up_open = __shfl_up_sync(FULL, open[s], off);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float up = __shfl_up_sync(FULL, v[s][c], off);
                if (open[s]) v[s][c] = up + v[s][c];
            }
            if (open[s]) open[s] = up_open;
            if (!__any_sync(FULL, open[s])) scan &= ~(1u << s);
        }
    }
}

template <typename T, int NO, bool VEC>
__global__ void __launch_bounds__(TILE_MAX_PASS * TILE_SPLIT * 32, 4 / TILE_SPLIT + 1) mttkrp_tile_kernel(
    const int32_t* __restrict__ indices,          // (nnz_pad, nmodes), 16-byte aligned
    const float* __restrict__ values,             // (nnz_pad,), 16-byte aligned
    const int64_t* __restrict__ block_start,      // (num_blocks + 1,)
    const int64_t* __restrict__ block_real_end,   // (num_blocks,)
    FactorArgs fac,
    float* __restrict__ out,                      // (batch, i_out, rank)
    float* __restrict__ carry_val,                // (C, 2, batch, rpb, rank)
    int32_t* __restrict__ carry_blk,              // (C, 2)
    long long nnz_pad, int num_blocks, int nmodes, int mode, int rank, int batch, int i_out,
    int rpb, int b_pass AUDIT_PARAM)
{
    constexpr int MO = NO > 0 ? NO : MAX_MODES - 1;
    extern __shared__ __align__(16) unsigned char smem[];
    const int nother = NO > 0 ? NO : nmodes - 1;
    const int stride = NO > 0 ? NO + 1 : nmodes;  // int32 words per stream entry
    const int lane = threadIdx.x & 31;
    const int g = lane / TILE_TPN;  // nonzero of the warp step
    const int b = (threadIdx.x >> 5) / TILE_SPLIT;  // restart of the pass
    const int h = (threadIdx.x >> 5) % TILE_SPLIT;  // column part of the pass
    const int q = h * TILE_TPN + lane % TILE_TPN;  // 4-column quarter of the pass
    const long long ctas = gridDim.x;
    const long long cta = blockIdx.x;
    const long long lo = nnz_pad * cta / ctas;
    const long long hi = nnz_pad * (cta + 1) / ctas;
    const int c0 = blockIdx.y * CHUNK + q * 4;
    const int ncols = rank - c0;  // > 0: this lane owns min(4, ncols) columns
    const bool has_cols = ncols > 0;
    const int bb = blockIdx.z * b_pass + b;

    auto block_of = [&](long long n) {
        int a = 0, z = num_blocks;  // block_start[a] <= n < block_start[z]
        while (z - a > 1) {
            const int m = (a + z) >> 1;
            if (block_start[m] <= n) a = m; else z = m;
        }
        return a;
    };
    if (lo >= hi) {  // an empty slice (fewer nonzeros than CTAs)
        if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
            carry_blk[2 * cta] = -1;
            carry_blk[2 * cta + 1] = -1;
        }
        return;
    }

    // Shared memory: the tile (b_pass restarts of rpb rows of 4 float4s),
    // the ring of staged chunks (indices, then values), then the barriers.
    // Restart b's rows; this warp adds to float4 q of each.
    float4* part = reinterpret_cast<float4*>(smem) + static_cast<size_t>(b) * rpb * 4;
    int32_t* ring = reinterpret_cast<int32_t*>(
        reinterpret_cast<float4*>(smem) + static_cast<size_t>(b_pass) * rpb * 4);
    const int stage_words = TILE_STAGE * (stride + 1);
    uint64_t* bars = reinterpret_cast<uint64_t*>(ring + TILE_STAGES * stage_words);
    const uint32_t full0 = smem_u32(bars);                 // TILE_STAGES "full" barriers
    const uint32_t empty0 = full0 + TILE_STAGES * 8;       // TILE_STAGES "empty" barriers

    // Warps with columns and a restart in this pass: the first ah column
    // parts of the first ab restarts (warp 0 always, the producer).
    const int ah = min(TILE_SPLIT, (rank - static_cast<int>(blockIdx.y) * CHUNK + 4 * TILE_TPN - 1) /
                                       (4 * TILE_TPN));
    const int ab = min(b_pass, batch - static_cast<int>(blockIdx.z) * b_pass);
    if (threadIdx.x == 0) {
        for (int s = 0; s < TILE_STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, ab * ah);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (b >= ab || h >= ah) return;

#ifdef MTTKRP_AUDIT
    // Per restart, warp h == 0 counts, one lane per nonzero, in the first
    // column pass; thread 0 counts the entries it stages in the first pass.
    unsigned a_nnz = 0, a_idx = 0, a_rows = 0, a_read = 0;
    const bool a_counts = h == 0 && lane % TILE_TPN == 0 && blockIdx.y == 0;
#endif
    // Chunk k holds entries [a0 + k*TILE_STAGE, min(.. + TILE_STAGE, hi4)).
    const long long a0 = lo & ~3LL;
    const long long hi4 = (hi + 3) & ~3LL;
    const long long nnz4 = nnz_pad & ~3LL;
    const int nchunks = static_cast<int>((hi4 - a0 + TILE_STAGE - 1) / TILE_STAGE);
    auto stage_idx = [&](int k) { return ring + (k % TILE_STAGES) * stage_words; };
    // Thread 0 fills chunk k's stage: bulk copies of its 16-byte aligned
    // part, plain loads of any entries past nnz4 (the stream's last < 4).
    auto issue = [&](int k) {
        const long long cs = a0 + static_cast<long long>(k) * TILE_STAGE;
        const long long ce = min(cs + TILE_STAGE, hi4);
        int32_t* sidx = stage_idx(k);
        float* sval = reinterpret_cast<float*>(sidx + TILE_STAGE * stride);
#ifdef MTTKRP_AUDIT
        if (blockIdx.y == 0 && blockIdx.z == 0) a_read += static_cast<unsigned>(min(ce, nnz_pad) - cs);
#endif
        for (long long n = max(cs, nnz4); n < min(ce, nnz_pad); ++n) {
            for (int j = 0; j < stride; ++j) sidx[(n - cs) * stride + j] = indices[n * stride + j];
            sval[n - cs] = values[n];
        }
        const uint32_t bar = full0 + 8 * (k % TILE_STAGES);
        const long long bulk = min(ce, nnz4) - cs;
        if (bulk > 0) {
            const uint32_t ib = static_cast<uint32_t>(bulk * stride * 4);
            const uint32_t vb = static_cast<uint32_t>(bulk * 4);
            mbar_expect_tx(bar, ib + vb);
            bulk_copy(smem_u32(sidx), indices + cs * stride, ib, bar);
            bulk_copy(smem_u32(sval), values + cs, vb, bar);
        } else {
            mbar_arrive(bar);
        }
    };
    if (threadIdx.x == 0)
        for (int k = 0; k < min(TILE_AHEAD, nchunks); ++k) issue(k);

    // Gathers read column 0 on lanes without columns: valid rows, results
    // never stored.
    const int gather_cols = has_cols ? min(ncols, 4) : 1;
    const T* f[MO];
    int fcol[MO];
#pragma unroll
    for (int j = 0; j < MO; ++j) {
        const bool used = j < nother;
        f[j] = used ? static_cast<const T*>(fac.ptr[j]) + bb * fac.batch_stride[j] +
                          (has_cols ? c0 : 0)
                    : nullptr;
        fcol[j] = used ? fac.col[j] : 0;
    }

    int cur_blk = block_of(lo);
    const int first_blk = cur_blk;
    long long blk_lo = block_start[cur_blk];
    long long blk_end = block_start[cur_blk + 1];
    // This block's entries that add: [v_lo, v_hi).
    long long v_lo = max(lo, blk_lo);
    long long v_hi = min(hi, static_cast<long long>(block_real_end[cur_blk]));
    int carried0 = -1, carried1 = -1;
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#ifdef MTTKRP_AUDIT
    {
        const float u = __uint_as_float(AUDIT_UNSET);
        for (int r = g; r < rpb; r += TILE_GROUPS) part[r * 4 + q] = make_float4(u, u, u, u);
        __syncwarp();
    }
#endif
    for (int r = g; r < rpb; r += TILE_GROUPS) part[r * 4 + q] = zero4;
    __syncwarp();

    // Store this warp's part of block cur_blk's tile, then zero it: to the
    // output if the slice holds the block whole, else to carry slot 0 (the
    // slice's first block) or 1 (its last).  Lane (g, q) takes quarter q of
    // rows g, g + TILE_GROUPS, ...
    auto flush = [&]() {
        const bool own = blk_lo >= lo && blk_end <= hi;
        const int slot = cur_blk == first_blk ? 0 : 1;
        const long long row0 = static_cast<long long>(cur_blk) * rpb;
        float* dst = own ? out + (static_cast<long long>(bb) * i_out + row0) * rank + c0
                         : carry_val + ((cta * 2 + slot) * batch + bb) * static_cast<long long>(rpb) * rank + c0;
        const int rows = static_cast<int>(min(static_cast<long long>(rpb), i_out - row0));
        if (has_cols)
            for (int r = g; r < rows; r += TILE_GROUPS) {
                const float4 t = part[r * 4 + q];
                const float x[4] = {t.x, t.y, t.z, t.w};
                store4<VEC>(dst + static_cast<long long>(r) * rank, ncols, x);
#ifdef MTTKRP_AUDIT
                audit_row4(audit, t);
                if (own)
                    audit_store(audit, (static_cast<long long>(bb) * i_out + row0 + r) * rank + c0,
                                min(ncols, 4));
#endif
            }
        for (int r = g; r < rpb; r += TILE_GROUPS) part[r * 4 + q] = zero4;
        __syncwarp();
        if (!own) {
            if (slot == 0) carried0 = cur_blk; else carried1 = cur_blk;
        }
    };
    auto next_block = [&]() {
        ++cur_blk;
        blk_lo = blk_end;
        blk_end = block_start[cur_blk + 1];
        v_lo = max(lo, blk_lo);
        v_hi = min(hi, static_cast<long long>(block_real_end[cur_blk]));
    };
    // Add a step's run sums to the warp's part of the tile, one turn after
    // the other.
    auto commit = [&](int key, const float (&v)[4], bool tail, int seg, int turns) {
        for (int t = 0;; ++t) {
            if (tail && seg == t) {
                float4 x = part[key * 4 + q];
#ifdef MTTKRP_AUDIT
                audit_row4(audit, x);
#endif
                x.x += v[0]; x.y += v[1]; x.z += v[2]; x.w += v[3];
                part[key * 4 + q] = x;
            }
            __syncwarp();
            if (t == turns) break;
        }
    };

    for (int k = 0; k < nchunks; ++k) {
        // Thread 0 fills chunk k + TILE_AHEAD's stage once every warp has
        // left the chunk before in it (two chunks back).
        if (threadIdx.x == 0 && k + TILE_AHEAD < nchunks) {
            const int m = k + TILE_AHEAD - TILE_STAGES;
            if (m >= 0) mbar_wait(empty0 + 8 * (m % TILE_STAGES), (m / TILE_STAGES) & 1);
            issue(k + TILE_AHEAD);
        }
        __syncwarp();
        mbar_wait(full0 + 8 * (k % TILE_STAGES), (k / TILE_STAGES) & 1);
        const int32_t* sidx = stage_idx(k);
        const float* sval = reinterpret_cast<const float*>(sidx + TILE_STAGE * stride);
        const long long cs = a0 + static_cast<long long>(k) * TILE_STAGE;
        const long long ce = min(cs + TILE_STAGE, hi4);
        for (long long base = cs; base < ce; base += TILE_GROUPS * TILE_U) {
            // Loads of the U steps, all issued before any is used: the
            // staged entry (clamped into the slice), then the factor rows it
            // names.
            int row[TILE_U];
            float p[TILE_U][4];
#ifdef MTTKRP_AUDIT
            int a_cols[TILE_U], a_gath[TILE_U];  // index columns read and factor rows gathered
#endif
#pragma unroll
            for (int u = 0; u < TILE_U; ++u) {
                const long long n = base + u * TILE_GROUPS + g;
                const int o = static_cast<int>((n < hi ? n : hi - 1) - cs);
                const int32_t* e = sidx + o * stride;
                row[u] = e[mode];
                const float val = sval[o];
                int ix[MO];
#pragma unroll
                for (int j = 0; j < MO; ++j) ix[j] = j < nother ? e[fcol[j]] : 0;
#ifdef MTTKRP_AUDIT
                a_cols[u] = 1;
                a_gath[u] = 0;
#pragma unroll
                for (int j = 0; j < MO; ++j) a_cols[u] += j < nother;
#endif
#pragma unroll
                for (int c = 0; c < 4; ++c) p[u][c] = val;
#pragma unroll
                for (int j = 0; j < MO; ++j) {
                    if (j >= nother) break;
#ifdef MTTKRP_AUDIT
                    ++a_gath[u];
#endif
                    float x[4];
                    load4<VEC>(f[j] + static_cast<long long>(ix[j]) * rank, gather_cols, x);
#pragma unroll
                    for (int c = 0; c < 4; ++c) p[u][c] *= x[c];
                }
            }
            int key[TILE_U], seg[TILE_U], turns[TILE_U];
            bool tail[TILE_U];
            if (min(base + TILE_GROUPS * TILE_U - 1, hi - 1) < blk_end) {
                // The common case: the U steps lie in block cur_blk.
#pragma unroll
                for (int u = 0; u < TILE_U; ++u) {
                    const long long n = base + u * TILE_GROUPS + g;
                    key[u] = n >= v_lo && n < v_hi ? row[u] - cur_blk * rpb : -1;
#ifdef MTTKRP_AUDIT
                    if (a_counts && key[u] >= 0) { ++a_nnz; a_idx += a_cols[u]; a_rows += a_gath[u]; }
#endif
                }
                tile_runs<TILE_U>(key, p, tail, seg, turns);
#pragma unroll
                for (int u = 0; u < TILE_U; ++u) commit(key[u], p[u], tail[u], seg[u], turns[u]);
                continue;
            }
#pragma unroll
            for (int u = 0; u < TILE_U; ++u) {
                const long long sb = base + u * TILE_GROUPS;
                if (sb >= hi) break;
                const long long n = sb + g;
                const long long last = min(sb + TILE_GROUPS - 1, hi - 1);
                // One round per block the step touches.
                for (;;) {
                    int k1[1] = {n >= v_lo && n < v_hi ? row[u] - cur_blk * rpb : -1};
#ifdef MTTKRP_AUDIT
                    if (a_counts && k1[0] >= 0) { ++a_nnz; a_idx += a_cols[u]; a_rows += a_gath[u]; }
#endif
                    float v1[1][4] = {{p[u][0], p[u][1], p[u][2], p[u][3]}};
                    bool t1[1];
                    int s1[1], n1[1];
                    tile_runs<1>(k1, v1, t1, s1, n1);
                    commit(k1[0], v1[0], t1[0], s1[0], n1[0]);
                    if (last < blk_end) break;
                    flush();
                    next_block();
                }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * (k % TILE_STAGES));
    }
    flush();  // the slice's last block
    if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
        carry_blk[2 * cta] = carried0;
        carry_blk[2 * cta + 1] = carried1;
    }
#ifdef MTTKRP_AUDIT
    // One atomic per warp and counter: warps of a CTA leave at different
    // points, so there is no barrier to sum them at.
    const unsigned a_val[4] = {a_nnz, a_idx, a_rows, a_read};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned s = __reduce_add_sync(FULL, a_val[k]);
        if (lane == 0 && s)
            atomicAdd(k < AUDIT_COUNTS ? audit.restart + static_cast<long long>(bb) * AUDIT_COUNTS + k
                                       : audit.counts + AUDIT_READ,
                      static_cast<unsigned long long>(s));
    }
#endif
}

// CTAs of THREADS elements each over (output block, restart): if slices
// hold carry tiles of block b, each thread sums its element's carries in
// slice order and stores it once.  `parts` CTAs per block: one CTA per
// block would be too few CTAs (48 on NELL-2's mode 0) to hide the latency of
// the carry loads.
__global__ void __launch_bounds__(THREADS) mttkrp_tile_carry_kernel(
    const float* __restrict__ carry_val, const int32_t* __restrict__ carry_blk,
    const int64_t* __restrict__ block_start, float* __restrict__ out, long long nnz_pad,
    int slices, int batch, int rank, int i_out, int rpb, int parts AUDIT_PARAM)
{
    const int b = blockIdx.x / parts;
    const int part = blockIdx.x % parts;
    const int bz = blockIdx.y;
    // The slice that holds entry n: the last v with nnz_pad * v / slices <= n.
    auto slice_of = [&](long long n) {
        long long v = n * slices / nnz_pad;
        while (v + 1 < slices && nnz_pad * (v + 1) / slices <= n) ++v;
        while (v > 0 && nnz_pad * v / slices > n) --v;
        return v;
    };
    const long long wa = slice_of(block_start[b]);
    const long long wz = slice_of(block_start[b + 1] - 1);
    const long long row0 = static_cast<long long>(b) * rpb;
    const long long rows = min(static_cast<long long>(rpb), i_out - row0);
    const long long e = static_cast<long long>(part) * blockDim.x + threadIdx.x;
    if (rows <= 0 || e >= rows * rank) return;
    bool carried = false;
    for (long long v = wa; v <= wz && !carried; ++v)
        carried = carry_blk[2 * v] == b || carry_blk[2 * v + 1] == b;
#ifdef MTTKRP_AUDIT
    for (long long v = wa; v <= wz; ++v) {
        audit_index(audit, carry_blk[2 * v]);
        audit_index(audit, carry_blk[2 * v + 1]);
    }
#endif
    if (!carried) return;  // stored by the slice that holds it whole
    const long long r = e / rank;
    const long long c = e % rank;
    float s = 0.0f;
#pragma unroll 4
    for (long long v = wa; v <= wz; ++v) {
        const int slot = carry_blk[2 * v] == b ? 0 : carry_blk[2 * v + 1] == b ? 1 : -1;
        if (slot >= 0) s += carry_val[(((v * 2 + slot) * batch + bz) * rpb + r) * rank + c];
#ifdef MTTKRP_AUDIT
        if (slot >= 0) audit_value(audit, carry_val[(((v * 2 + slot) * batch + bz) * rpb + r) * rank + c]);
#endif
    }
    out[(static_cast<long long>(bz) * i_out + row0 + r) * rank + c] = s;
#ifdef MTTKRP_AUDIT
    audit_store(audit, (static_cast<long long>(bz) * i_out + row0 + r) * rank + c, 1);
#endif
}

#define TILE_KERNEL(T, NO, VEC) mttkrp_tile_kernel<T, NO, VEC>

// CTAs per SM of the tile kernel at this block size and shared memory.
template <typename T, int NO, bool VEC>
static cudaError_t tile_per_sm(int threads, size_t smem, int* per_sm, int* sms)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(TILE_KERNEL(T, NO, VEC),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, TILE_KERNEL(T, NO, VEC),
                                                            threads, smem);
    if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
    return err;
}

template <typename T, int NO, bool VEC>
static cudaError_t tile_launch(const LaunchArgs& a, int b_pass, cudaStream_t stream)
{
    const size_t smem = tile_smem_bytes(a.nmodes, a.rows_per_block, b_pass);
    cudaError_t err = cudaFuncSetAttribute(TILE_KERNEL(T, NO, VEC),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(a.ctas, (a.rank + CHUNK - 1) / CHUNK, (a.batch + b_pass - 1) / b_pass);
    TILE_KERNEL(T, NO, VEC)<<<grid, b_pass * TILE_SPLIT * 32, smem, stream>>>(
        a.indices, a.values, a.block_start, a.block_real_end, a.fac, a.out, a.carry_val,
        a.carry_row, a.nnz_pad, a.num_blocks, a.nmodes, a.mode, a.rank, a.batch, a.i_out,
        a.rows_per_block, b_pass AUDIT_ARG);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int parts = (a.rows_per_block * a.rank + THREADS - 1) / THREADS;
    mttkrp_tile_carry_kernel<<<dim3(a.num_blocks * parts, a.batch), THREADS, 0, stream>>>(
        a.carry_val, a.carry_row, a.block_start, a.out, a.nnz_pad, a.ctas, a.batch, a.rank,
        a.i_out, a.rows_per_block, parts AUDIT_ARG);
    return cudaGetLastError();
}

// With a null `a`, the CTAs per SM of the kernel the shape takes; else its
// launch.
template <typename T>
static cudaError_t tile_dispatch(const LaunchArgs* a, int nmodes, int rpb, int b_pass, int vec,
                                 cudaStream_t s, int* per_sm, int* sms)
{
    const int threads = b_pass * TILE_SPLIT * 32;
    const size_t smem = tile_smem_bytes(nmodes, rpb, b_pass);
    if (nmodes == 3) {
        if (!a) return tile_per_sm<T, 2, true>(threads, smem, per_sm, sms);
        return vec ? tile_launch<T, 2, true>(*a, b_pass, s) : tile_launch<T, 2, false>(*a, b_pass, s);
    }
    if (!a) return tile_per_sm<T, 0, false>(threads, smem, per_sm, sms);
    return tile_launch<T, 0, false>(*a, b_pass, s);
}

extern "C" {

// CTAs of the split kernel's grid on the current device for this shape; the
// carry scratch holds 8 slices (warps) per CTA.  Returns the cudaError_t.
int mttkrp_split_ctas(int nmodes, int batch, int factor_is_bf16, int* ctas)
{
    if (nmodes < 1 || nmodes > MAX_MODES || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = factor_is_bf16
        ? dispatch<__nv_bfloat16>(nullptr, nmodes, batch, 0, nullptr, ctas)
        : dispatch<float>(nullptr, nmodes, batch, 0, nullptr, ctas);
    return static_cast<int>(err);
}

// Launches the split kernel and its carry pass on `stream`; returns the
// cudaError_t of the launches (0 = queued).  factor_ptrs / factor_batch_strides
// are host arrays of nmodes entries; carry_val holds ctas*8*2*batch*rank
// floats and carry_row ctas*8*2 ints.  vec: rank % 4 == 0 and every factor
// 16-byte (float32) or 8-byte (bfloat16) aligned.
int mttkrp_split_launch(const int32_t* indices, const float* values,
                        const int64_t* block_start, const int64_t* block_real_end,
                        const void* const* factor_ptrs, const int64_t* factor_batch_strides,
                        float* out, float* carry_val, int32_t* carry_row, long long nnz_pad,
                        int num_blocks, int nmodes, int mode, int rank, int batch, int i_out,
                        int ctas, int factor_is_bf16, int vec, void* stream)
{
    if (nmodes < 1 || nmodes > MAX_MODES || mode < 0 || mode >= nmodes || rank < 1 ||
        batch < 1 || i_out < 1 || num_blocks < 1 || nnz_pad < 1 || ctas < 1 ||
        (rank + CHUNK - 1) / CHUNK > 65535 || (batch + 3) / 4 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    LaunchArgs a{indices, values, block_start, block_real_end, FactorArgs{}, out, carry_val,
                 carry_row, nnz_pad, num_blocks, nmodes, mode, rank, batch, i_out, ctas};
    for (int k = 0, j = 0; k < nmodes; ++k) {
        if (k == mode) continue;
        a.fac.ptr[j] = factor_ptrs[k];
        a.fac.batch_stride[j] = factor_batch_strides[k];
        a.fac.col[j] = k;
        ++j;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = factor_is_bf16
        ? dispatch<__nv_bfloat16>(&a, nmodes, batch, vec, s, nullptr)
        : dispatch<float>(&a, nmodes, batch, vec, s, nullptr);
    return static_cast<int>(err);
}

// The tile mode's CTA on the current device for this shape: restarts a pass
// (0, with the rest 0, when a single restart's tile does not fit shared
// memory), warps and bytes of dynamic shared memory per CTA, CTAs per SM and
// the SM count.  Returns the cudaError_t.
int mttkrp_tiles_grid(int nmodes, int rows_per_block, int batch, int factor_is_bf16,
                      int* b_pass, int* warps, int* smem_bytes, int* per_sm, int* sms)
{
    if (nmodes < 1 || nmodes > MAX_MODES || rows_per_block < 1 || rows_per_block > (1 << 20) ||
        batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    *warps = *smem_bytes = *per_sm = *sms = 0;
    cudaError_t err = tile_b_pass(nmodes, rows_per_block, batch, b_pass);
    if (err != cudaSuccess || *b_pass == 0) return static_cast<int>(err);
    *warps = *b_pass * TILE_SPLIT;
    *smem_bytes = static_cast<int>(tile_smem_bytes(nmodes, rows_per_block, *b_pass));
    err = factor_is_bf16
        ? tile_dispatch<__nv_bfloat16>(nullptr, nmodes, rows_per_block, *b_pass, 0, nullptr,
                                       per_sm, sms)
        : tile_dispatch<float>(nullptr, nmodes, rows_per_block, *b_pass, 0, nullptr, per_sm, sms);
    return static_cast<int>(err);
}

// Launches the tile mode and its carry pass on `stream`; returns the
// cudaError_t of the launches (0 = queued).  As mttkrp_split_launch, but
// `ctas` CTAs of mttkrp_tiles_grid's shape, indices and values 16-byte
// aligned, carry_val holding ctas*2*batch*rows_per_block*rank floats and
// carry_blk ctas*2 ints.
int mttkrp_tiles_launch(const int32_t* indices, const float* values,
                        const int64_t* block_start, const int64_t* block_real_end,
                        const void* const* factor_ptrs, const int64_t* factor_batch_strides,
                        float* out, float* carry_val, int32_t* carry_blk, long long nnz_pad,
                        int num_blocks, int nmodes, int mode, int rank, int batch, int i_out,
                        int rows_per_block, int ctas, int factor_is_bf16, int vec, void* stream)
{
    if (nmodes < 1 || nmodes > MAX_MODES || mode < 0 || mode >= nmodes || rank < 1 ||
        batch < 1 || i_out < 1 || num_blocks < 1 || nnz_pad < 1 || ctas < 1 ||
        rows_per_block < 1 || rows_per_block > (1 << 20) ||
        (rank + CHUNK - 1) / CHUNK > 65535 || batch > 65535 ||
        reinterpret_cast<uintptr_t>(indices) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(values) % 16 != 0 ||
        static_cast<long long>(num_blocks) *
                ((static_cast<long long>(rows_per_block) * rank + THREADS - 1) / THREADS) >
            2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    int b_pass = 0;
    cudaError_t err = tile_b_pass(nmodes, rows_per_block, batch, &b_pass);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b_pass == 0) return static_cast<int>(cudaErrorInvalidValue);
    LaunchArgs a{indices, values, block_start, block_real_end, FactorArgs{}, out, carry_val,
                 carry_blk, nnz_pad, num_blocks, nmodes, mode, rank, batch, i_out, ctas,
                 rows_per_block};
    for (int k = 0, j = 0; k < nmodes; ++k) {
        if (k == mode) continue;
        a.fac.ptr[j] = factor_ptrs[k];
        a.fac.batch_stride[j] = factor_batch_strides[k];
        a.fac.col[j] = k;
        ++j;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = factor_is_bf16
        ? tile_dispatch<__nv_bfloat16>(&a, nmodes, rows_per_block, b_pass, vec, s, nullptr, nullptr)
        : tile_dispatch<float>(&a, nmodes, rows_per_block, b_pass, vec, s, nullptr, nullptr);
    return static_cast<int>(err);
}

const char* mttkrp_split_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef MTTKRP_AUDIT
// The audit build's counters for the launches that follow: stores holds
// batch*i_out*rank ints, restart batch*AUDIT_COUNTS and counts 2 unsigned
// 64-bit counts, all on the device and zeroed by the caller.
int mttkrp_audit_buffers(int* stores, unsigned long long* restart, unsigned long long* counts)
{
    g_audit = Audit{stores, restart, counts};
    return 0;
}
#endif

}  // extern "C"
