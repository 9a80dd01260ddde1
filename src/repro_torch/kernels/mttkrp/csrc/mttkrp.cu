// Sparse MTTKRP over a mode-ordered plan, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mttkrp/kernel.py:_kernel
// (launched by mttkrp_pallas_call).  It computes, for output mode `mode`,
//
//     out[b, i, r] = sum_{n : idx[n, mode] = i} vals[n] * prod_{k != mode} F_k[b, idx[n, k], r]
//
// over the plan's nonzero stream: nonzeros sorted by output mode, grouped
// into output blocks of `rows_per_block` rows, each block a contiguous range
// [block_nnz_start[blk], block_nnz_start[blk + 1]).  The output is exactly
// (B, I_mode, R) in float32: no lane padding, no padded block rows.
//
// Translation.  The TPU kernel walks the tiles in order on one core and
// carries the block's partial sums in VMEM scratch from one grid step to the
// next; its scatter is a one-hot matmul on the MXU.  GPU blocks run in
// parallel and in no order, so here one CTA owns one output block (times one
// restart, times one chunk of <= 64 rank columns) and walks the block's whole
// nonzero range with a loop.  Threads take (nonzero, rank) pairs, gather the
// factor rows themselves (no (K, nnz, R) staging tensor in device memory) and
// form the product in float32.  The CTA's nonzero lanes each walk a
// contiguous run of the block, sum in a register while the output row repeats
// and add each run's sum into a shared-memory accumulator of
// rows_per_block x rank_chunk floats at local_row[n].  After the loop the CTA
// stores its rows < I_mode exactly once: the paper's
// store-each-output-row-once property (Algorithm 1, line 11).  A block with
// no real nonzeros still stores zeros, so the output may start uninitialised.
//
// What bounds it on the H100: device-memory bytes.  Each nonzero needs
// 4*N + 4 bytes (N-1 gather indices, its row, its value); this kernel
// streams 4*N + 8, since the interleaved (nnz, N) index rows bring in the
// output mode's index, which local_row already gives.  It also needs
// (N-1)*R factor values that mostly hit in the 50 MB L2 (NELL-2's factors
// are < 4 MB at R = 16);
// the arithmetic (about N*R flops a nonzero) is far below the float32 peak.
// What this simple design does about it: index and value loads are shared by
// the rank_chunk threads of a nonzero (one broadcast transaction), factor
// loads are rank-contiguous across neighbouring threads, each lane streams a
// contiguous run (cache lines reused from L1), and partial sums stay in
// registers and shared memory until the single store.  What it does not do: a
// Table II tensor has only 36-113 output blocks at rows_per_block = 256, so a
// single restart fills 36-113 of the 132 SMs and each CTA walks ~1M nonzeros
// serially.  Splitting a block's nonzero range across CTAs (with a second
// reduction pass) is the first optimisation for a later change.
//
// Summation order differs from the plain version's, and the shared-memory
// atomics of runs that share a row land in a run-dependent order, so results
// match the plain version to a tolerance, not bit for bit.  All nonzero
// offsets are 64-bit (nnz_pad * nmodes passes 2^31 at PATENTS scale).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_MODES 8
#define THREADS 1024

struct FactorArgs {
    const void* ptr[MAX_MODES];       // factor k: (B, I_k, R) or (I_k, R), row-major
    long long batch_stride[MAX_MODES];  // elements between restarts; 0 = shared
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS) mttkrp_block_kernel(
    const int32_t* __restrict__ indices,        // (nnz_pad, nmodes)
    const float* __restrict__ values,           // (nnz_pad,)
    const int32_t* __restrict__ local_row,      // (nnz_pad,) in [0, rows_per_block)
    const int64_t* __restrict__ block_nnz_start,  // (num_blocks + 1,)
    FactorArgs fac,
    float* __restrict__ out,                    // (B, i_out, rank)
    int nmodes, int mode, int rank, int rank_chunk, int rows_per_block, int i_out)
{
    extern __shared__ float acc[];  // rows_per_block x rank_chunk
    const int blk = blockIdx.x;
    const long long b = blockIdx.y;
    const int r0 = blockIdx.z * rank_chunk;
    const int width = min(rank_chunk, rank - r0);
    const int tid = threadIdx.x;
    const int acc_size = rows_per_block * rank_chunk;

    for (int i = tid; i < acc_size; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();

    const T* f[MAX_MODES];
#pragma unroll
    for (int k = 0; k < MAX_MODES; ++k)
        f[k] = k < nmodes ? static_cast<const T*>(fac.ptr[k]) + b * fac.batch_stride[k] + r0
                          : nullptr;

    // The block's nonzeros are sorted by output row, so neighbouring nonzeros
    // share a row.  Each of the `lanes` nonzero lanes (rank_chunk threads, one
    // per rank column) walks its own contiguous run of the block, sums in a
    // register while the row repeats and does one shared-memory atomicAdd per
    // row change (an atomicAdd per nonzero would make the lanes collide on one
    // row's addresses).
    const int lanes = blockDim.x / rank_chunk;
    const int r = tid % rank_chunk;
    const int lane = tid / rank_chunk;
    if (lane < lanes && r < width) {
        const long long lo = block_nnz_start[blk];
        const long long hi = block_nnz_start[blk + 1];
        const long long span = (hi - lo + lanes - 1) / lanes;
        const long long begin = lo + lane * span;
        const long long end = begin + span < hi ? begin + span : hi;
        int row = -1;
        float sum = 0.0f;
#pragma unroll 4
        for (long long n = begin; n < end; ++n) {
            const int32_t* idx_n = indices + n * nmodes;
            float p = values[n];
#pragma unroll
            for (int k = 0; k < MAX_MODES; ++k) {
                if (k < nmodes && k != mode)
                    p *= to_f32(f[k][static_cast<long long>(idx_n[k]) * rank + r]);
            }
            const int row_n = local_row[n];
            if (row_n != row) {
                if (row >= 0) atomicAdd(&acc[row * rank_chunk + r], sum);
                row = row_n;
                sum = p;
            } else {
                sum += p;
            }
        }
        if (row >= 0) atomicAdd(&acc[row * rank_chunk + r], sum);
    }
    __syncthreads();

    // The block's single store.
    const long long row0 = static_cast<long long>(blk) * rows_per_block;
    float* o = out + b * static_cast<long long>(i_out) * rank + r0;
    for (int i = tid; i < acc_size; i += blockDim.x) {
        const int row = i / rank_chunk;
        const int c = i % rank_chunk;
        const long long g = row0 + row;
        if (g < i_out && c < width) o[g * rank + c] = acc[i];
    }
}

template <typename T>
static cudaError_t launch(const int32_t* indices, const float* values, const int32_t* local_row,
                          const int64_t* block_nnz_start, const FactorArgs& fac, float* out,
                          int nmodes, int mode, int rank, int rank_chunk, int rows_per_block,
                          int num_blocks, int i_out, int batch, cudaStream_t stream)
{
    const size_t smem = static_cast<size_t>(rows_per_block) * rank_chunk * sizeof(float);
    // Above 48 KB dynamic shared memory must be opted into, or the launch is refused.
    cudaError_t err = cudaFuncSetAttribute(
        mttkrp_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(num_blocks, batch, (rank + rank_chunk - 1) / rank_chunk);
    mttkrp_block_kernel<T><<<grid, THREADS, smem, stream>>>(
        indices, values, local_row, block_nnz_start, fac, out,
        nmodes, mode, rank, rank_chunk, rows_per_block, i_out);
    return cudaGetLastError();
}

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = queued).
// factor_ptrs / factor_batch_strides are host arrays of nmodes entries.
int mttkrp_launch(const int32_t* indices, const float* values, const int32_t* local_row,
                  const int64_t* block_nnz_start, const void* const* factor_ptrs,
                  const int64_t* factor_batch_strides, float* out, int nmodes, int mode,
                  int rank, int rank_chunk, int rows_per_block, int num_blocks, int i_out,
                  int batch, int factor_is_bf16, void* stream)
{
    if (nmodes < 1 || nmodes > MAX_MODES || mode < 0 || mode >= nmodes || rank < 1 ||
        rank_chunk < 1 || rank_chunk > THREADS || rows_per_block < 1 || num_blocks < 1 ||
        batch < 1 || i_out < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    FactorArgs fac;
    for (int k = 0; k < MAX_MODES; ++k) {
        fac.ptr[k] = k < nmodes ? factor_ptrs[k] : nullptr;
        fac.batch_stride[k] = k < nmodes ? factor_batch_strides[k] : 0;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = factor_is_bf16
        ? launch<__nv_bfloat16>(indices, values, local_row, block_nnz_start, fac, out, nmodes,
                                mode, rank, rank_chunk, rows_per_block, num_blocks, i_out, batch, s)
        : launch<float>(indices, values, local_row, block_nnz_start, fac, out, nmodes, mode,
                        rank, rank_chunk, rows_per_block, num_blocks, i_out, batch, s);
    return static_cast<int>(err);
}

const char* mttkrp_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
