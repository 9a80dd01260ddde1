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
// of this file) does the same per warp in shared memory; the wrapper picks
// the mode from the plan's contiguity flag.

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
    long long nnz_pad, int num_blocks, int nmodes, int mode, int rank, int batch, int i_out)
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
            }
    };

    for (long long base = lo; base < hi; base += U * GROUPS) {
        // Loads of the U steps, all issued before any is used: the stream
        // entry (clamped into the slice), then the factor rows it names.
        int row[U];
        float p[U][NB][4];
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
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int c = 0; c < 4; ++c) p[u][b][c] = val;
#pragma unroll
            for (int j = 0; j < MO; ++j) {
                if (j >= nother) break;
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
}

// One warp per slice v (and one for v == W): stores the rows whose first
// carry slice v holds, summed over the carries of that row in slice order,
// and zero-fills the empty rows before slice v's first row.
__global__ void __launch_bounds__(THREADS) mttkrp_carry_kernel(
    const float* __restrict__ carry_val, const int32_t* __restrict__ carry_row,
    float* __restrict__ out, int num_warps, int batch, int rank, int i_out)
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
        const unsigned m = __ballot_sync(FULL, fr >= 0);
        if (m) {
            const int jj = j0 - (__ffs(m) - 1);
            const int lr = carry_row[2 * jj + 1];
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
        }
    };
    if (v == num_warps) {  // after the stream's last row
        if (prev + 1 < i_out) zero_rows(prev + 1, i_out);
        return;
    }
    const int first = carry_row[2 * v];
    const int last = carry_row[2 * v + 1];
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
    int rows_per_block = 0, warps = 0;  // tile mode only
};

template <typename T, int NO, int NB, bool VEC>
static cudaError_t launch(const LaunchArgs& a, cudaStream_t stream)
{
    const dim3 grid(a.ctas, (a.rank + CHUNK - 1) / CHUNK, (a.batch + NB - 1) / NB);
    SPLIT_KERNEL(T, NO, NB, VEC)<<<grid, THREADS, 0, stream>>>(
        a.indices, a.values, a.block_start, a.block_real_end, a.fac, a.out, a.carry_val,
        a.carry_row, a.nnz_pad, a.num_blocks, a.nmodes, a.mode, a.rank, a.batch, a.i_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int num_warps = a.ctas * WARPS;
    mttkrp_carry_kernel<<<(num_warps + 1 + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        a.carry_val, a.carry_row, a.out, num_warps, a.batch, a.rank, a.i_out);
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
// The same nonzero-balanced slices as the row-run mode, one restart per pass
// (grid.z) and 16 rank columns per pass (grid.y).  Each warp keeps the output
// block it is in as a float32 tile of rows_per_block x 16 in shared memory
// (16 KB at 256 rows; the host picks the warps per CTA that put the most
// warps on an SM, at most 8) and adds each run of products at its row:
//
//  * Runs of one row that sit next to each other are summed in registers
//    first, as in the row-run mode (an open run across steps while every
//    entry continues it; else a segmented scan over the step's groups).
//  * A run's total goes to the tile by the run's last group.  Where two
//    groups of a step end runs on one row (match_any finds them), the groups
//    add one after the other in group order; else all at once.  No atomics,
//    so every sum runs in an order fixed by the grid and two launches on the
//    same inputs agree bit for bit.
//  * When the stream leaves a block, the warp stores the tile whole: to the
//    output if the block starts and ends inside its slice, else to a carry
//    scratch of (W, 2, batch, rows_per_block, rank), slot 0 for its first
//    block and slot 1 for its last.  The tile starts at zero, so every row
//    of the block gets its value, and every block (an empty one holds a tile
//    of padding) is stored.
//  * A second launch takes the elements of each (block, restart), 256 to a
//    CTA: if slices hold carry tiles of the block, it sums an element's
//    carries in slice order and stores it once.  So every output element is stored exactly once across the
//    pair of launches.
//
// Padding is skipped by position (block_real_end), as in the row-run mode.
// Its costs over the row-run mode: the tile bounds the warps an SM holds (14
// at 256 rows, against the row-run mode's 24), and where runs are short, as
// in the blocked ordering, nearly every step takes the segmented scan and a
// shared-memory read-modify-write per run.
#define TILE_MAX_WARPS 8

template <typename T, int NO, bool VEC>
__global__ void __launch_bounds__(TILE_MAX_WARPS * 32) mttkrp_tile_kernel(
    const int32_t* __restrict__ indices,          // (nnz_pad, nmodes)
    const float* __restrict__ values,             // (nnz_pad,)
    const int64_t* __restrict__ block_start,      // (num_blocks + 1,)
    const int64_t* __restrict__ block_real_end,   // (num_blocks,)
    FactorArgs fac,
    float* __restrict__ out,                      // (batch, i_out, rank)
    float* __restrict__ carry_val,                // (W, 2, batch, rpb, rank)
    int32_t* __restrict__ carry_blk,              // (W, 2)
    long long nnz_pad, int num_blocks, int nmodes, int mode, int rank, int batch, int i_out,
    int rpb)
{
    constexpr int U = 4;
    constexpr int MO = NO > 0 ? NO : MAX_MODES - 1;
    extern __shared__ float4 tiles[];
    const int nother = NO > 0 ? NO : nmodes - 1;
    const int lane = threadIdx.x & 31;
    const int g = lane / TPN;
    const int q = lane % TPN;
    const int warps = blockDim.x >> 5;
    const long long num_warps = static_cast<long long>(gridDim.x) * warps;
    const long long w = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5);
    const long long lo = nnz_pad * w / num_warps;
    const long long hi = nnz_pad * (w + 1) / num_warps;
    const int c0 = blockIdx.y * CHUNK + q * 4;
    const int ncols = rank - c0;
    const bool active = ncols > 0;
    const int bz = blockIdx.z;
    // This warp's tile: rpb rows of 16 columns, 4 float4s a row.
    float4* tile = tiles + static_cast<size_t>(threadIdx.x >> 5) * rpb * TPN;

    const int gather_cols = active ? ncols : 1;
    const T* f[MO];
    int fcol[MO];
#pragma unroll
    for (int j = 0; j < MO; ++j) {
        const bool used = j < nother;
        f[j] = used ? static_cast<const T*>(fac.ptr[j]) + bz * fac.batch_stride[j] +
                          (active ? c0 : 0)
                    : nullptr;
        fcol[j] = used ? fac.col[j] : 0;
    }

    auto block_of = [&](long long n) {
        int a = 0, z = num_blocks;  // block_start[a] <= n < block_start[z]
        while (z - a > 1) {
            const int m = (a + z) >> 1;
            if (block_start[m] <= n) a = m; else z = m;
        }
        return a;
    };
    int blk = block_of(lo + g);  // the block of this thread's entry, followed as n grows
    long long blk_end = block_start[blk + 1];
    long long real_end = block_real_end[blk];
    int cur_blk = block_of(lo);  // the warp's tile's block
    const int first_blk = cur_blk;
    int carried0 = -1, carried1 = -1;
    int cur_row = -1;  // the warp's open run (-1: none)
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    auto zero_tile = [&]() {
        for (int e = lane; e < rpb * TPN; e += 32) tile[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        __syncwarp();
    };
    auto group_sum = [&](const float (&x)[4], float (&t)[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float s = x[j];
#pragma unroll
            for (int off = TPN; off < 32; off <<= 1) s += __shfl_xor_sync(FULL, s, off);
            t[j] = s;
        }
    };
    // Lanes with `add` add x to their columns of tile row `local`; groups
    // whose rows coincide take turns in group order.
    auto tile_add = [&](bool add, int local, const float (&x)[4]) {
        const int key = add ? local * TPN + q : -1 - lane;
        const unsigned peers = __match_any_sync(FULL, key);
        const bool clash = __any_sync(FULL, __popc(peers) > 1);
        const int turns = clash ? GROUPS : 1;
        for (int s = 0; s < turns; ++s) {
            if (add && (!clash || g == s)) {
                float4 t = tile[local * TPN + q];
                t.x += x[0]; t.y += x[1]; t.z += x[2]; t.w += x[3];
                tile[local * TPN + q] = t;
            }
            __syncwarp();
        }
    };
    // Store the tile of block cur_blk, then zero it: to the output if the
    // block starts and ends in this slice, else to carry slot 0 (the slice's
    // first block) or 1 (its last).
    auto flush = [&]() {
        const bool own = block_start[cur_blk] >= lo && block_start[cur_blk + 1] <= hi;
        const int slot = cur_blk == first_blk ? 0 : 1;
        const long long row0 = static_cast<long long>(cur_blk) * rpb;
        float* dst = own ? out + (static_cast<long long>(bz) * i_out + row0) * rank
                         : carry_val + ((w * 2 + slot) * batch + bz) * static_cast<long long>(rpb) * rank;
        const long long rows = own ? min(static_cast<long long>(rpb), i_out - row0) : rpb;
        for (long long e = lane; e < rows * TPN; e += 32) {
            const int c = blockIdx.y * CHUNK + static_cast<int>(e % TPN) * 4;
            if (c >= rank) continue;
            const float4 t = tile[e];
            const float x[4] = {t.x, t.y, t.z, t.w};
            store4<VEC>(dst + (e / TPN) * rank + c, rank - c, x);
        }
        if (!own) {
            if (slot == 0) carried0 = cur_blk; else carried1 = cur_blk;
        }
        __syncwarp();
        zero_tile();
    };

    if (lo < hi) zero_tile();
    for (long long base = lo; base < hi; base += U * GROUPS) {
        // Loads of the U steps, all issued before any is used (as in the
        // row-run mode): the stream entry, clamped into the slice, then the
        // factor rows it names.
        int row[U], nblk[U];
        float p[U][4];
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
#pragma unroll
            for (int c = 0; c < 4; ++c) p[u][c] = val;
#pragma unroll
            for (int j = 0; j < MO; ++j) {
                if (j >= nother) break;
                float x[4];
                load4<VEC>(f[j] + static_cast<long long>(ix[j]) * rank, gather_cols, x);
#pragma unroll
                for (int c = 0; c < 4; ++c) p[u][c] *= x[c];
            }
        }
        // Each entry's block (-1 past the slice); padding and entries past
        // the slice add nothing and name no row.
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long n = base + u * GROUPS + g;
            while (n >= blk_end && blk + 1 < num_blocks) {
                ++blk;
                blk_end = block_start[blk + 1];
                real_end = block_real_end[blk];
            }
            nblk[u] = n < hi ? blk : -1;
            if (n >= hi || n >= real_end) {
                row[u] = -1;
#pragma unroll
                for (int c = 0; c < 4; ++c) p[u][c] = 0.0f;
            }
        }
        // The common case: every entry of the U steps continues the open run
        // inside the tile's block.
        bool goes_on = true;
#pragma unroll
        for (int u = 0; u < U; ++u)
            goes_on &= nblk[u] < 0 || (nblk[u] == cur_blk && (row[u] < 0 || row[u] == cur_row));
        if (__all_sync(FULL, goes_on)) {
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[c] += p[u][c];
            continue;
        }

#pragma unroll
        for (int u = 0; u < U; ++u) {
            // One round per block the step touches (two where it crosses a
            // block boundary; more only for tiles of fewer than 8 entries).
            for (;;) {
                const bool here = nblk[u] == cur_blk;
                const bool ahead = nblk[u] > cur_blk;
                const bool cont = !ahead && (!here || row[u] < 0 || row[u] == cur_row);
                if (__all_sync(FULL, cont)) {  // the open run goes on
                    if (here) {
#pragma unroll
                        for (int c = 0; c < 4; ++c) acc[c] += p[u][c];
                    }
                    break;
                }
                // The open run ends: its total goes to its row (one group
                // adds, so no turns are needed).
                if (cur_row >= 0) {
                    float t[4];
                    group_sum(acc, t);
                    if (g == 0) {
                        float4* dst = tile + (cur_row - cur_blk * rpb) * TPN + q;
                        float4 v4 = *dst;
                        v4.x += t[0]; v4.y += t[1]; v4.z += t[2]; v4.w += t[3];
                        *dst = v4;
                    }
                    __syncwarp();
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
                    cur_row = -1;
                }
                // The step's runs in this block, summed over the groups by a
                // segmented inclusive scan.
                const bool mine = here && row[u] >= 0;
                const int key = mine ? row[u] : -1;
                int key_prev = __shfl_up_sync(FULL, key, TPN);
                int key_next = __shfl_down_sync(FULL, key, TPN);
                if (g == 0) key_prev = -2;
                if (g == GROUPS - 1) key_next = -2;
                float v[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) v[c] = mine ? p[u][c] : 0.0f;
                int flag = !mine || key != key_prev;
                // Where no run spans two groups every flag is set and the scan
                // would leave v as it is: skip it.
                if (__any_sync(FULL, !flag))
#pragma unroll
                for (int off = 1; off < GROUPS; off <<= 1) {
                    const int fu = __shfl_up_sync(FULL, flag, off * TPN);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const float up = __shfl_up_sync(FULL, v[c], off * TPN);
                        if (g >= off && !flag) v[c] = up + v[c];
                    }
                    if (g >= off) flag |= fu;
                }
                const bool tail = mine && key != key_next;
                const bool leaves = __any_sync(FULL, ahead);
                // Unless the step leaves the block, its last run stays open.
                const bool open = !leaves && g == GROUPS - 1;
                tile_add(tail && !open, key - cur_blk * rpb, v);
                if (!leaves) {
                    cur_row = __shfl_sync(FULL, key, 31);
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[c] = g == GROUPS - 1 ? v[c] : 0.0f;
                    break;
                }
                flush();
                ++cur_blk;
            }
        }
    }

    if (lo < hi) {
        if (cur_row >= 0) {
            float t[4];
            group_sum(acc, t);
            if (g == 0) {
                float4* dst = tile + (cur_row - cur_blk * rpb) * TPN + q;
                float4 v4 = *dst;
                v4.x += t[0]; v4.y += t[1]; v4.z += t[2]; v4.w += t[3];
                *dst = v4;
            }
            __syncwarp();
        }
        flush();
    }
    if (lane == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
        carry_blk[2 * w] = carried0;
        carry_blk[2 * w + 1] = carried1;
    }
}

// CTAs of THREADS elements each over (output block, restart): if slices
// hold carry tiles of block b, each thread sums its element's carries in
// slice order and stores it once.  `parts` CTAs per block: one CTA per
// block would be too few CTAs (48 on NELL-2's mode 0) to hide the latency of
// the carry loads.
__global__ void __launch_bounds__(THREADS) mttkrp_tile_carry_kernel(
    const float* __restrict__ carry_val, const int32_t* __restrict__ carry_blk,
    const int64_t* __restrict__ block_start, float* __restrict__ out, long long nnz_pad,
    int num_warps, int batch, int rank, int i_out, int rpb, int parts)
{
    const int b = blockIdx.x / parts;
    const int part = blockIdx.x % parts;
    const int bz = blockIdx.y;
    // The slice that holds entry n: the last v with nnz_pad * v / W <= n.
    auto slice_of = [&](long long n) {
        long long v = n * num_warps / nnz_pad;
        while (v + 1 < num_warps && nnz_pad * (v + 1) / num_warps <= n) ++v;
        while (v > 0 && nnz_pad * v / num_warps > n) --v;
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
    if (!carried) return;  // stored by the slice that holds it whole
    const long long r = e / rank;
    const long long c = e % rank;
    float s = 0.0f;
#pragma unroll 4
    for (long long v = wa; v <= wz; ++v) {
        const int slot = carry_blk[2 * v] == b ? 0 : carry_blk[2 * v + 1] == b ? 1 : -1;
        if (slot >= 0) s += carry_val[(((v * 2 + slot) * batch + bz) * rpb + r) * rank + c];
    }
    out[(static_cast<long long>(bz) * i_out + row0 + r) * rank + c] = s;
}

#define TILE_KERNEL(T, NO, VEC) mttkrp_tile_kernel<T, NO, VEC>

// The warps per CTA (1..8) that put the most warps on an SM, and the CTAs of
// the persistent grid at that size.
template <typename T, int NO, bool VEC>
static cudaError_t tile_grid_for(int rpb, int* ctas, int* warps)
{
    int dev = 0, sms = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const size_t per_warp = static_cast<size_t>(rpb) * CHUNK * sizeof(float);
    int best = 0;
    for (int wpc = 1; wpc <= TILE_MAX_WARPS; ++wpc) {
        const size_t smem = per_warp * wpc;
        if (smem > static_cast<size_t>(optin)) break;
        err = cudaFuncSetAttribute(TILE_KERNEL(T, NO, VEC),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        int per_sm = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, TILE_KERNEL(T, NO, VEC),
                                                                wpc * 32, smem);
        if (err != cudaSuccess) return err;
        if (per_sm * wpc >= best && per_sm > 0) {
            best = per_sm * wpc;
            *warps = wpc;
            *ctas = per_sm * sms;
        }
    }
    return best > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int NO, bool VEC>
static cudaError_t tile_launch(const LaunchArgs& a, cudaStream_t stream)
{
    const size_t smem = static_cast<size_t>(a.rows_per_block) * CHUNK * sizeof(float) * a.warps;
    cudaError_t err = cudaFuncSetAttribute(TILE_KERNEL(T, NO, VEC),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(a.ctas, (a.rank + CHUNK - 1) / CHUNK, a.batch);
    TILE_KERNEL(T, NO, VEC)<<<grid, a.warps * 32, smem, stream>>>(
        a.indices, a.values, a.block_start, a.block_real_end, a.fac, a.out, a.carry_val,
        a.carry_row, a.nnz_pad, a.num_blocks, a.nmodes, a.mode, a.rank, a.batch, a.i_out,
        a.rows_per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int parts = (a.rows_per_block * a.rank + THREADS - 1) / THREADS;
    mttkrp_tile_carry_kernel<<<dim3(a.num_blocks * parts, a.batch), THREADS, 0, stream>>>(
        a.carry_val, a.carry_row, a.block_start, a.out, a.nnz_pad, a.ctas * a.warps, a.batch,
        a.rank, a.i_out, a.rows_per_block, parts);
    return cudaGetLastError();
}

// With a null `a`, the grid of the kernel the shape takes; else its launch.
template <typename T>
static cudaError_t tile_dispatch(const LaunchArgs* a, int nmodes, int rpb, int vec,
                                 cudaStream_t s, int* ctas, int* warps)
{
    if (nmodes == 3) {
        if (!a) return tile_grid_for<T, 2, true>(rpb, ctas, warps);
        return vec ? tile_launch<T, 2, true>(*a, s) : tile_launch<T, 2, false>(*a, s);
    }
    if (!a) return tile_grid_for<T, 0, false>(rpb, ctas, warps);
    return tile_launch<T, 0, false>(*a, s);
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

// The tile mode's grid on the current device for this shape: CTAs and warps
// per CTA (one slice a warp).  Returns the cudaError_t.
int mttkrp_tiles_grid(int nmodes, int rows_per_block, int factor_is_bf16, int* ctas, int* warps)
{
    if (nmodes < 1 || nmodes > MAX_MODES || rows_per_block < 1 || rows_per_block > (1 << 20))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = factor_is_bf16
        ? tile_dispatch<__nv_bfloat16>(nullptr, nmodes, rows_per_block, 0, nullptr, ctas, warps)
        : tile_dispatch<float>(nullptr, nmodes, rows_per_block, 0, nullptr, ctas, warps);
    return static_cast<int>(err);
}

// Launches the tile mode and its carry pass on `stream`; returns the
// cudaError_t of the launches (0 = queued).  As mttkrp_split_launch, but
// carry_val holds ctas*warps*2*batch*rows_per_block*rank floats and
// carry_blk ctas*warps*2 ints; any restart count (one per pass).
int mttkrp_tiles_launch(const int32_t* indices, const float* values,
                        const int64_t* block_start, const int64_t* block_real_end,
                        const void* const* factor_ptrs, const int64_t* factor_batch_strides,
                        float* out, float* carry_val, int32_t* carry_blk, long long nnz_pad,
                        int num_blocks, int nmodes, int mode, int rank, int batch, int i_out,
                        int rows_per_block, int ctas, int warps, int factor_is_bf16, int vec,
                        void* stream)
{
    if (nmodes < 1 || nmodes > MAX_MODES || mode < 0 || mode >= nmodes || rank < 1 ||
        batch < 1 || i_out < 1 || num_blocks < 1 || nnz_pad < 1 || ctas < 1 ||
        warps < 1 || warps > TILE_MAX_WARPS || rows_per_block < 1 || rows_per_block > (1 << 20) ||
        (rank + CHUNK - 1) / CHUNK > 65535 || batch > 65535 ||
        static_cast<long long>(num_blocks) *
                ((static_cast<long long>(rows_per_block) * rank + THREADS - 1) / THREADS) >
            2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    LaunchArgs a{indices, values, block_start, block_real_end, FactorArgs{}, out, carry_val,
                 carry_blk, nnz_pad, num_blocks, nmodes, mode, rank, batch, i_out, ctas,
                 rows_per_block, warps};
    for (int k = 0, j = 0; k < nmodes; ++k) {
        if (k == mode) continue;
        a.fac.ptr[j] = factor_ptrs[k];
        a.fac.batch_stride[j] = factor_batch_strides[k];
        a.fac.col[j] = k;
        ++j;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = factor_is_bf16
        ? tile_dispatch<__nv_bfloat16>(&a, nmodes, rows_per_block, vec, s, nullptr, nullptr)
        : tile_dispatch<float>(&a, nmodes, rows_per_block, vec, s, nullptr, nullptr);
    return static_cast<int>(err);
}

const char* mttkrp_split_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
