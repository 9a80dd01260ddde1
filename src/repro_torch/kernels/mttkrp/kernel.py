"""Wrappers of the hand-written CUDA MTTKRP kernels.

``mttkrp_cuda`` launches a kernel that replaces the Pallas TPU kernel
``repro/kernels/mttkrp/kernel.py:_kernel``.  Two variants take the same
plan buffers and compute the same function:

  * ``"split"`` (``csrc/mttkrp_split.cu``), every call's kernel unless the
    caller names another: a persistent grid sized from the card, each warp
    an equal slice of the nonzero stream, and a second small launch that
    sums what slices share and stores it once.  It has two modes
    (``SPLIT_MODES``), picked from the plan buffers' ``rows_contiguous``
    flag: ``"rows"`` sums each output row's run in registers and needs
    each row's nonzeros to be one run of the stream (the ``lex``,
    ``secondary-sort`` and ``degree`` orderings); ``"tiles"`` takes any
    plan (the ``blocked`` ordering's): each CTA, not each warp, takes a
    slice of the stream, stages its indices and values in shared memory
    once, and accumulates the output block it is in as a shared-memory
    tile of up to four restarts, each warp half the columns of one
    restart (``tile_grid``);
  * ``"block"`` (``csrc/mttkrp.cu``), asked for by name only: one CTA per
    plan output block, kept to time the two in one run.

It takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything the kernel does not take; there is no
fallback.  CPU tensors go to the plain version (``ref.mttkrp_plan_ref``)
one level up, in ``ops.mttkrp_from_plan``.

``mttkrp_cuda.launches`` counts the MTTKRPs launched by this process (the
split variant's carry pass is part of its call),
``mttkrp_cuda.launches_by_variant`` counts them per variant and
``mttkrp_cuda.launches_by_mode`` the split variant's per mode.

``mttkrp_cuda_audit`` launches the split kernel's audit build (the same
source compiled with ``-DMTTKRP_AUDIT``) on the same grid as
``mttkrp_cuda``, into an output and carries filled with a NaN pattern no
arithmetic produces, and returns what the build counted (``AuditCounts``):
the stores each output element received, the nonzeros, index columns and
factor rows each restart consumed, the stream entries read, and the reads
of a carry, partial sum or tile row never written.  It is the card's half
of ``repro_torch.analysis``'s kernel contracts, whose CPU half replays the
same launches (``partition.py``); ``mttkrp_cuda_audit.launches`` counts it
apart from the main path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import TYPE_CHECKING, NamedTuple, Sequence

import torch

from repro_torch.kernels import build

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.ops import PlanBuffers

__all__ = [
    "AUDIT_UNSET",
    "AUDIT_UNSET_IDX",
    "AuditCounts",
    "MAX_MODES",
    "MAX_RANK_CHUNK",
    "SPLIT_MODES",
    "VARIANTS",
    "mttkrp_cuda",
    "mttkrp_cuda_audit",
    "rank_chunk",
    "reset_launch_counts",
    "split_mode_for",
    "split_slices",
    "tile_grid",
]

VARIANTS = ("split", "block")
SPLIT_MODES = ("rows", "tiles")
MAX_MODES = 8  # csrc/mttkrp.cu and csrc/mttkrp_split.cu: MAX_MODES
MAX_RANK_CHUNK = 64  # rank columns per CTA of the block kernel
SHARED_MEMORY_LIMIT = 232_448  # bytes of shared memory one H100 block may use
MAX_GRID_YZ = 65_535
SPLIT_WARPS_PER_CTA = 8  # csrc/mttkrp_split.cu: THREADS / 32; one slice per warp
SPLIT_RANK_CHUNK = 16  # csrc/mttkrp_split.cu: CHUNK, rank columns per pass
SPLIT_BATCH_CHUNK = 4  # restarts per pass over the stream
_FACTOR_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
AUDIT_UNSET = 0x7FBADBAD  # csrc/mttkrp_split.cu: the bits of a float never written
AUDIT_UNSET_IDX = -(2**31)  # csrc/mttkrp_split.cu: a carry row or block never written
# The split variant's libraries: the production build and the audit build.
_SPLIT_LIBRARIES = {"split": "mttkrp_split", "split_audit": "mttkrp_split_audit"}


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


def _library(variant: str):
    """The variant's library, with its C entry points' argument types set."""
    if variant == "block":
        lib = build.load("mttkrp")
        if lib.mttkrp_launch.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mttkrp_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.mttkrp_launch.restype = ctypes.c_int
            lib.mttkrp_error_string.argtypes = [ctypes.c_int]
            lib.mttkrp_error_string.restype = ctypes.c_char_p
        return lib
    lib = build.load(_SPLIT_LIBRARIES[variant])
    if lib.mttkrp_split_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mttkrp_split_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll,
                                            i, i, i, i, i, i, i, i, i, p]
        lib.mttkrp_split_launch.restype = ctypes.c_int
        lib.mttkrp_split_ctas.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.mttkrp_split_ctas.restype = ctypes.c_int
        lib.mttkrp_split_error_string.argtypes = [ctypes.c_int]
        lib.mttkrp_split_error_string.restype = ctypes.c_char_p
        lib.mttkrp_tiles_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll,
                                            i, i, i, i, i, i, i, i, i, i, p]
        lib.mttkrp_tiles_launch.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.mttkrp_tiles_grid.argtypes = [i, i, i, i, ip, ip, ip, ip, ip]
        lib.mttkrp_tiles_grid.restype = ctypes.c_int
        if variant == "split_audit":
            lib.mttkrp_audit_buffers.argtypes = [p, p, p]
            lib.mttkrp_audit_buffers.restype = ctypes.c_int
    return lib


def _raise_on(err: int, variant: str) -> None:
    if err != 0:
        lib = _library(variant)
        name = "mttkrp_error_string" if variant == "block" else "mttkrp_split_error_string"
        msg = getattr(lib, name)(err).decode()
        raise RuntimeError(f"MTTKRP kernel ({variant}) launch failed: cudaError_t {err} ({msg})")


_CTAS: dict[tuple, int] = {}


def split_slices(nmodes: int, batch: int, dtype: torch.dtype, device: torch.device) -> int:
    """Slices of the nonzero stream (warps of the split kernel's grid) on
    ``device`` for this shape: the occupancy API's CTAs per SM, times the
    SM count, times 8 warps per CTA."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, nmodes == 3, batch == 1, dtype)  # the kernel instance the shape takes
    if key not in _CTAS:
        ctas = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _library("split").mttkrp_split_ctas(
                nmodes, batch, _FACTOR_DTYPES[dtype], ctypes.byref(ctas))
        _raise_on(err, "split")
        _CTAS[key] = ctas.value
    return _CTAS[key] * SPLIT_WARPS_PER_CTA


class TileGrid(NamedTuple):
    """The tile mode's grid for one shape on one card, as the kernel's
    source computes it (``mttkrp_tiles_grid`` in csrc/mttkrp_split.cu)."""

    ctas: int  # CTAs of the persistent grid, one slice of the stream each
    warps: int  # warps per CTA: two per restart of a pass, a column part each
    b_pass: int  # restarts per pass over the stream
    smem_bytes: int  # dynamic shared memory per CTA: tile, staging ring, barriers
    warps_per_sm: int  # resident warps per SM (the occupancy API's CTAs per SM x warps)


_TILE_GRID: dict[tuple, TileGrid] = {}


def tile_grid(nmodes: int, rows_per_block: int, dtype: torch.dtype, device: torch.device, *,
              batch: int = 1) -> TileGrid:
    """The split kernel's tile-mode grid on ``device`` for this shape: the
    most restarts a pass (at most 4 and at most ``batch``) whose tiles of
    ``rows_per_block x 16`` float32 fit shared memory beside the staging
    ring, and as many CTAs as the occupancy API fits on the card's SMs.
    ``ctas`` is the number of slices of the stream.  Raises ``ValueError``
    when a single restart's tile does not fit."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, nmodes, rows_per_block, batch, dtype)
    if key not in _TILE_GRID:
        b_pass, warps, smem, per_sm, sms = (ctypes.c_int(0) for _ in range(5))
        with torch.cuda.device(device):
            err = _library("split").mttkrp_tiles_grid(
                nmodes, rows_per_block, batch, _FACTOR_DTYPES[dtype], ctypes.byref(b_pass),
                ctypes.byref(warps), ctypes.byref(smem), ctypes.byref(per_sm), ctypes.byref(sms))
        _raise_on(err, "split")
        if b_pass.value == 0:
            raise ValueError(
                f"rows_per_block={rows_per_block}: the tile mode's tile of "
                f"{rows_per_block} x {SPLIT_RANK_CHUNK} float32 and its staging ring do not "
                f"fit the card's shared memory"
            )
        _TILE_GRID[key] = TileGrid(per_sm.value * sms.value, warps.value, b_pass.value,
                                   smem.value, per_sm.value * warps.value)
    return _TILE_GRID[key]


def split_mode_for(plan_bufs: "PlanBuffers", split_mode: str | None) -> str:
    """The split kernel's mode for these plan buffers: ``split_mode`` when
    given, else ``"rows"`` if each output row's nonzeros are contiguous and
    ``"tiles"`` if not.  The row-run mode refuses a plan whose rows are not
    contiguous: it would store such a row once per run."""
    if split_mode is None:
        return "rows" if plan_bufs.rows_contiguous else "tiles"
    if split_mode not in SPLIT_MODES:
        raise ValueError(f"unknown split mode {split_mode!r}; the modes are {SPLIT_MODES}")
    if split_mode == "rows" and not plan_bufs.rows_contiguous:
        raise ValueError(
            "the split kernel's row-run mode needs each output row's nonzeros "
            "to be contiguous, and this plan's are not (the 'blocked' ordering); "
            "its tile mode takes it (split_mode='tiles' or None)"
        )
    return split_mode


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class _Call(NamedTuple):
    """One checked call's shape: what the launch needs beyond the tensors."""

    variant: str
    split_mode: str | None
    device: torch.device
    nmodes: int
    nnz_pad: int
    num_blocks: int
    rows_per_block: int
    dtype: torch.dtype
    lead: tuple[int, ...]
    batch: int
    rank: int
    chunk: int  # the block variant's rank columns per CTA (0 for the split variant)
    grid: TileGrid | None  # the tile mode's grid


def _checked_call(
    bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    variant: str | None,
    split_mode: str | None,
) -> _Call:
    """Check the call's tensors and options; raise on anything the kernels do not take."""
    variant = "split" if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the kernels are {VARIANTS}")
    if variant == "split":
        split_mode = split_mode_for(bufs, split_mode)
    elif split_mode is not None:
        raise ValueError("split_mode is an option of the split variant")
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
    _check(bufs.block_real_end, "block_real_end", torch.int64, (num_blocks,), device)
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
    chunk, grid = 0, None
    if variant == "block":
        chunk = rank_chunk(rank, rows_per_block)
        passes = (batch, -(-rank // chunk))
    elif split_mode == "tiles":
        grid = tile_grid(nmodes, rows_per_block, dtype, device, batch=batch)
        passes = (-(-batch // grid.b_pass), -(-rank // SPLIT_RANK_CHUNK))
    else:
        passes = (-(-batch // SPLIT_BATCH_CHUNK), -(-rank // SPLIT_RANK_CHUNK))
    if max(passes) > MAX_GRID_YZ:
        raise ValueError(f"batch={batch} / rank={rank} exceed the grid's y/z limit")
    return _Call(variant, split_mode, device, nmodes, nnz_pad, num_blocks, rows_per_block, dtype,
                 lead, batch, rank, chunk, grid)


def _carries(call: _Call, alloc) -> tuple[torch.Tensor, torch.Tensor]:
    """The split variant's carry scratch, ``(values, rows or blocks)``, from
    ``alloc(shape, dtype)``: per slice its first and last row's partial sums
    (row-run mode) or its first and last block's tiles (tile mode)."""
    if call.split_mode == "tiles":
        slices = call.grid.ctas
        tail = (call.batch, call.rows_per_block, call.rank)
    else:
        slices = split_slices(call.nmodes, call.batch, call.dtype, call.device)
        tail = (call.batch, call.rank)
    return alloc((slices, 2) + tail, torch.float32), alloc((slices, 2), torch.int32)


def _launch_split(lib, call: _Call, bufs: "PlanBuffers", factors: Sequence[torch.Tensor],
                  mode: int, i_out: int, out: torch.Tensor, carry_val: torch.Tensor,
                  carry_idx: torch.Tensor) -> int:
    """Queue the split variant's two launches on the current stream; returns
    the C entry point's cudaError_t."""
    ptrs = (ctypes.c_void_p * call.nmodes)(*[f.data_ptr() for f in factors])
    batch_strides = (ctypes.c_int64 * call.nmodes)(
        *[f.stride(0) if call.lead else 0 for f in factors])
    stream = torch.cuda.current_stream(call.device).cuda_stream
    align = 16 if call.dtype == torch.float32 else 8
    vec = call.rank % 4 == 0 and all(f.data_ptr() % align == 0 for f in factors)
    common = (bufs.indices.data_ptr(), bufs.values.data_ptr(), bufs.block_nnz_start.data_ptr(),
              bufs.block_real_end.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
              ctypes.cast(batch_strides, ctypes.c_void_p), out.data_ptr(), carry_val.data_ptr(),
              carry_idx.data_ptr(), call.nnz_pad, call.num_blocks, call.nmodes, mode, call.rank,
              call.batch, i_out)
    if call.split_mode == "tiles":
        if bufs.indices.data_ptr() % 16 or bufs.values.data_ptr() % 16:
            raise ValueError("the tile mode stages the stream by bulk copies: the plan's "
                             "indices and values must be 16-byte aligned")
        return lib.mttkrp_tiles_launch(*common, call.rows_per_block, call.grid.ctas,
                                       _FACTOR_DTYPES[call.dtype], int(vec), stream)
    return lib.mttkrp_split_launch(*common, int(carry_idx.shape[0]) // SPLIT_WARPS_PER_CTA,
                                   _FACTOR_DTYPES[call.dtype], int(vec), stream)


def mttkrp_cuda(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    *,
    variant: str | None = None,
    split_mode: str | None = None,
) -> torch.Tensor:
    """Launch an MTTKRP kernel; returns ``(..., i_out, R)`` float32.

    ``factors`` are all ``(I_k, R)`` or all ``(B, I_k, R)`` (one call
    covers the restart batch), float32 or bfloat16, contiguous, on the
    plan buffers' CUDA device.  ``variant`` is ``"split"`` (the default)
    or ``"block"``; ``split_mode`` the split variant's mode, by default the
    one the plan buffers' ``rows_contiguous`` flag picks
    (``split_mode_for``).  The kernel runs on the current stream and is
    not synchronised.
    """
    bufs = plan_bufs
    call = _checked_call(bufs, factors, mode, i_out, variant, split_mode)
    device = call.device
    out = torch.empty(call.lead + (i_out, call.rank), dtype=torch.float32, device=device)
    if i_out == 0:
        return out
    with torch.cuda.device(device):
        if call.variant == "block":
            ptrs = (ctypes.c_void_p * call.nmodes)(*[f.data_ptr() for f in factors])
            batch_strides = (ctypes.c_int64 * call.nmodes)(
                *[f.stride(0) if call.lead else 0 for f in factors])
            err = _library("block").mttkrp_launch(
                bufs.indices.data_ptr(),
                bufs.values.data_ptr(),
                bufs.local_row.data_ptr(),
                bufs.block_nnz_start.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p),
                ctypes.cast(batch_strides, ctypes.c_void_p),
                out.data_ptr(),
                call.nmodes,
                mode,
                call.rank,
                call.chunk,
                call.rows_per_block,
                call.num_blocks,
                i_out,
                call.batch,
                _FACTOR_DTYPES[call.dtype],
                torch.cuda.current_stream(device).cuda_stream,
            )
        else:
            carry_val, carry_idx = _carries(
                call, lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device))
            err = _launch_split(_library("split"), call, bufs, factors, mode, i_out, out,
                                carry_val, carry_idx)
    _raise_on(err, call.variant)
    mttkrp_cuda.launches += 1
    mttkrp_cuda.launches_by_variant[call.variant] += 1
    if call.variant == "split":
        mttkrp_cuda.launches_by_mode[call.split_mode] += 1
    return out


class AuditCounts(NamedTuple):
    """What the split kernel's audit build counted over one call, on the card."""

    stores: torch.Tensor  # (..., i_out, R) int32: the stores each output element received
    nonzeros: torch.Tensor  # (B,) int64: stream entries each restart consumed as nonzeros
    index_columns: torch.Tensor  # (B,) int64: index columns read for those nonzeros
    factor_rows: torch.Tensor  # (B,) int64: factor rows gathered for those nonzeros
    entries_read: torch.Tensor  # () int64: stream entries read (row-run) or staged (tile), one pass
    uninit_reads: torch.Tensor  # () int64: reads of a carry, partial sum or tile row never written


# The audit build takes its counters' addresses through a setter that the
# launch then reads, so a call sets and launches under one lock.
_AUDIT_LOCK = threading.Lock()


def mttkrp_cuda_audit(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    *,
    split_mode: str | None = None,
) -> tuple[torch.Tensor, AuditCounts]:
    """The split kernel's audit build on the same grid as ``mttkrp_cuda``'s
    split variant: returns ``(out, AuditCounts)``, both on the card and not
    synchronised.  It takes what ``mttkrp_cuda`` takes, and fills the output
    and the carry values with ``AUDIT_UNSET`` and the carry rows or blocks
    with ``AUDIT_UNSET_IDX`` first, so that an element never stored stays a
    NaN and a carry read before it is written is counted."""
    bufs = plan_bufs
    call = _checked_call(bufs, factors, mode, i_out, "split", split_mode)
    device = call.device

    def unset(shape, dtype):
        fill = AUDIT_UNSET if dtype == torch.float32 else AUDIT_UNSET_IDX
        return torch.full(shape, fill, dtype=torch.int32, device=device).view(dtype)

    out = unset(call.lead + (i_out, call.rank), torch.float32)
    stores = torch.zeros((call.batch, i_out, call.rank), dtype=torch.int32, device=device)
    per_restart = torch.zeros((call.batch, 3), dtype=torch.int64, device=device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    if i_out:
        carry_val, carry_idx = _carries(call, unset)
        lib = _library("split_audit")
        with torch.cuda.device(device), _AUDIT_LOCK:
            lib.mttkrp_audit_buffers(stores.data_ptr(), per_restart.data_ptr(), counts.data_ptr())
            err = _launch_split(lib, call, bufs, factors, mode, i_out, out, carry_val, carry_idx)
        _raise_on(err, "split_audit")
        mttkrp_cuda_audit.launches += 1
    return out, AuditCounts(stores.reshape(call.lead + (i_out, call.rank)), per_restart[:, 0],
                            per_restart[:, 1], per_restart[:, 2], counts[0], counts[1])


def reset_launch_counts() -> None:
    """Set the launch count and every per-variant and per-mode count to 0,
    and the audit build's launch count."""
    mttkrp_cuda.launches = 0
    mttkrp_cuda_audit.launches = 0
    mttkrp_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
    mttkrp_cuda.launches_by_mode = dict.fromkeys(SPLIT_MODES, 0)


reset_launch_counts()
