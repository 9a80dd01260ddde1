"""Wrapper of the hand-written CUDA MTTKRP kernel (``csrc/mttkrp.cu``).

``mttkrp_cuda`` launches the kernel that replaces the Pallas TPU kernel
``repro/kernels/mttkrp/kernel.py:_kernel``.  It takes CUDA tensors only:
it checks device, dtype, shape and contiguity and raises on anything the
kernel does not take; there is no fallback.  CPU tensors go to the plain
version (``ref.mttkrp_plan_ref``) one level up, in ``ops.mttkrp_from_plan``.

``mttkrp_cuda.launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Sequence

import torch

from repro_torch.kernels import build

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.ops import PlanBuffers

__all__ = ["MAX_MODES", "MAX_RANK_CHUNK", "mttkrp_cuda", "rank_chunk"]

MAX_MODES = 8  # csrc/mttkrp.cu: MAX_MODES
MAX_RANK_CHUNK = 64  # rank columns per CTA
SHARED_MEMORY_LIMIT = 232_448  # bytes of shared memory one H100 block may use
MAX_GRID_YZ = 65_535

_FACTOR_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rank_chunk(rank: int, rows_per_block: int) -> int:
    """Rank columns per CTA: at most 64, and the accumulator fits shared memory."""
    fit = SHARED_MEMORY_LIMIT // (4 * rows_per_block)
    chunk = min(rank, MAX_RANK_CHUNK, fit)
    if chunk < 1:
        raise ValueError(
            f"rows_per_block={rows_per_block} does not fit one float32 column of "
            f"the accumulator in {SHARED_MEMORY_LIMIT} bytes of shared memory"
        )
    return chunk


def _entry():
    lib = build.load("mttkrp")
    fn = lib.mttkrp_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.mttkrp_error_string.argtypes = [ctypes.c_int]
        lib.mttkrp_error_string.restype = ctypes.c_char_p
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mttkrp_cuda(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
) -> torch.Tensor:
    """Launch the MTTKRP kernel; returns ``(..., i_out, R)`` float32.

    ``factors`` are all ``(I_k, R)`` or all ``(B, I_k, R)`` (one launch
    covers the restart batch), float32 or bfloat16, contiguous, on the
    plan buffers' CUDA device.  The kernel runs on the current stream and
    is not synchronised.
    """
    bufs = plan_bufs
    device = bufs.values.device
    if device.type != "cuda":
        raise ValueError(
            f"mttkrp_cuda needs CUDA tensors, got plan buffers on {device}; "
            "CPU tensors take the plain version (ops.mttkrp_from_plan)"
        )
    nmodes = len(factors)
    if not 1 <= nmodes <= MAX_MODES:
        raise ValueError(f"{nmodes} modes; the kernel takes 1..{MAX_MODES}")
    if not 0 <= mode < nmodes:
        raise ValueError(f"mode {mode} out of range for {nmodes} factors")
    nnz_pad = int(bufs.values.shape[0])
    num_blocks = int(bufs.block_nnz_start.shape[0]) - 1
    rows_per_block = int(bufs.rows_per_block)
    _check(bufs.indices, "indices", torch.int32, (nnz_pad, nmodes), device)
    _check(bufs.values, "values", torch.float32, (nnz_pad,), device)
    _check(bufs.local_row, "local_row", torch.int32, (nnz_pad,), device)
    _check(bufs.block_nnz_start, "block_nnz_start", torch.int64, (num_blocks + 1,), device)
    if num_blocks < 1 or not 0 <= i_out <= num_blocks * rows_per_block:
        raise ValueError(
            f"i_out={i_out} does not fit {num_blocks} blocks of {rows_per_block} rows"
        )
    if i_out < bufs.index_bound[mode]:
        raise ValueError(f"i_out={i_out} < the plan's output rows {bufs.index_bound[mode]}")

    dtype = factors[0].dtype
    if dtype not in _FACTOR_DTYPES:
        raise TypeError(f"factor dtype {dtype}; the kernel takes float32 or bfloat16")
    lead = tuple(factors[0].shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"factors must be (I, R) or (B, I, R), got {tuple(factors[0].shape)}")
    batch = lead[0] if lead else 1
    rank = int(factors[0].shape[-1])
    if batch < 1 or rank < 1:
        raise ValueError(f"factors of shape {tuple(factors[0].shape)}: empty batch or rank")
    for k, f in enumerate(factors):
        rows = int(f.shape[-2]) if f.dim() >= 2 else -1
        _check(f, f"factor {k}", dtype, lead + (rows, rank), device)
        if k != mode and rows < bufs.index_bound[k]:
            raise ValueError(
                f"factor {k} has {rows} rows; the plan indexes up to row "
                f"{bufs.index_bound[k] - 1}"
            )
    chunk = rank_chunk(rank, rows_per_block)
    if batch > MAX_GRID_YZ or -(-rank // chunk) > MAX_GRID_YZ:
        raise ValueError(f"batch={batch} / rank={rank} exceed the grid's y/z limit")

    out = torch.empty(lead + (i_out, rank), dtype=torch.float32, device=device)
    if i_out == 0:
        return out
    ptrs = (ctypes.c_void_p * nmodes)(*[f.data_ptr() for f in factors])
    batch_strides = (ctypes.c_int64 * nmodes)(*[f.stride(0) if lead else 0 for f in factors])
    fn = _entry()
    with torch.cuda.device(device):
        err = fn(
            bufs.indices.data_ptr(),
            bufs.values.data_ptr(),
            bufs.local_row.data_ptr(),
            bufs.block_nnz_start.data_ptr(),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(batch_strides, ctypes.c_void_p),
            out.data_ptr(),
            nmodes,
            mode,
            rank,
            chunk,
            rows_per_block,
            num_blocks,
            i_out,
            batch,
            _FACTOR_DTYPES[dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        msg = build.load("mttkrp").mttkrp_error_string(err).decode()
        raise RuntimeError(f"MTTKRP kernel launch failed: cudaError_t {err} ({msg})")
    mttkrp_cuda.launches += 1
    return out


mttkrp_cuda.launches = 0
