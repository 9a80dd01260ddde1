"""The plans the kernel contract checkers replay the split kernel over.

``kernel-contract``, ``carry-init`` and ``traffic-model-drift`` all judge
the same replays of the split MTTKRP kernel's two launches
(``kernels/mttkrp/partition.py``): each in the mode ``kernel.split_mode_for``
picks for its plan, at B = 1 and 4 restarts and several slice counts.  The
plans are tiny and deterministic (a comparison of exact counts, not of
times): 300 nonzeros drawn from a seed at N = 3, 4 and 5 in every
ordering, the four partition edges of ``chip_smoke.py`` at a reduced
size, and one stacked service plan.  :func:`replay_suite` runs them once
per analysis and keeps the result in the context's memo.

The replay module is the one the scanned tree holds at
:data:`PARTITION_PATH`: the repo's own, or a fixture's (the checkers'
tests plant faults in a replay that way).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.sparse_tensor import SparseTensor, build_mttkrp_plan, random_sparse_tensor
from repro_torch.kernels.mttkrp import ops
from repro_torch.kernels.mttkrp import partition as _partition
from repro_torch.kernels.mttkrp.kernel import split_mode_for
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref
from repro_torch.reorder import ORDERINGS

if TYPE_CHECKING:
    from repro_torch.analysis.core import AnalysisContext, SourceFile

__all__ = ["PARTITION_PATH", "PLAIN_TOL", "PlanReplay", "REPLAY_NMODES", "replay_suite",
           "suite_line", "suite_plan", "suite_tensor"]

PARTITION_PATH = "src/repro_torch/kernels/mttkrp/partition.py"

#: Tensor mode counts replayed, and the shape and draw at each.
REPLAY_NMODES = (3, 4, 5)
REPLAY_SHAPES = {3: (30, 24, 18), 4: (14, 12, 10, 9), 5: (9, 8, 7, 6, 5)}
REPLAY_NNZ = 300
REPLAY_TILE_NNZ = 32
REPLAY_ROWS_PER_BLOCK = 8
REPLAY_RANK = 4
REPLAY_SEED = 20260808
REPLAY_BATCHES = (1, 4)
#: Slice counts of every plan, and of mode 0's besides (the last: more
#: slices than stream entries, so that some slices are empty).
REPLAY_SLICES = (37,)
EDGE_SLICES = (1, 3, 37, "more than the stream")
TILE_MAX_PASS = 4  # csrc/mttkrp_split.cu: restarts a pass of the tile mode, at most
PLAIN_TOL = 1e-4  # replay against the plain version: float32 sums in another order


@dataclasses.dataclass
class PlanReplay:
    """One replay of one plan: what it is, and what the replay counted."""

    label: str  # e.g. "lex N=3 B=4", "partition edge: hot row", "stacked service plan"
    ordering: str
    nmodes: int
    mode: int
    batch: int
    slices: int
    split_mode: str  # "rows" or "tiles"
    nnz: int  # the plan's real nonzeros
    i_out: int
    rank: int
    store_min: int
    store_max: int
    census: list[dict]  # per restart (partition.SplitReplay / TileReplay .census)
    entries_read: int  # partition.stream_entries_read
    tile_rmw: int  # the tile mode's tile-row read-modify-writes (0 in the row-run mode)
    carry_reads: int
    uninit_reads: int
    unmarked_reads: int
    max_abs_vs_plain: float  # against ref.mttkrp_plan_ref on the same plan
    matches_plain: bool  # within PLAIN_TOL (absolute and relative) of it
    error: str = ""  # what the replay raised (its own checks), with nothing counted


def _load_partition(sf: "SourceFile") -> ModuleType:
    """The scanned tree's replay module: the imported one when it is the
    same file, else the file loaded on its own."""
    if sf.abspath.resolve() == Path(_partition.__file__).resolve():
        return _partition
    spec = importlib.util.spec_from_file_location(f"_replay_{abs(hash(sf.abspath))}", sf.abspath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _factors(shape, batch: int, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    lead = () if batch == 1 else (batch,)
    return [torch.from_numpy(rng.standard_normal(lead + (s, REPLAY_RANK)).astype(np.float32))
            for s in shape]


def _edge_tensors() -> dict[str, SparseTensor]:
    """``chip_smoke.partition_edge_tensors`` at a hundredth of the size."""
    rng = np.random.default_rng(8)

    def coo(rows, dims):
        idx = np.stack([rows] + [rng.integers(0, d, rows.size) for d in dims[1:]], 1)
        return SparseTensor(idx.astype(np.int32),
                            rng.standard_normal(rows.size).astype(np.float32), dims)

    return {
        "hot row": coo(np.concatenate([np.zeros(2000, np.int64), rng.integers(1, 50, 100)]),
                       (50, 30, 40)),
        "slice boundaries inside padding": coo(np.arange(0, 3200, 16) + rng.integers(0, 16, 200),
                                               (3200, 5, 6)),
        "empty rows between slices": coo(np.repeat(np.arange(0, 2000, 50), 10), (2000, 7, 9)),
        "fewer nonzeros than slices": coo(rng.integers(0, 40, 5), (40, 3, 2)),
    }


def _replay(module, label: str, ordering: str, bufs, mode: int, i_out: int, nnz: int,
            facs: list[torch.Tensor], slices: int) -> PlanReplay:
    split_mode = split_mode_for(bufs, None)
    batch = int(facs[0].shape[0]) if facs[0].dim() == 3 else 1
    nnz_pad = int(bufs.values.shape[0])
    try:
        if split_mode == "tiles":
            r = module.emulate_tiles(bufs, facs, mode, i_out, slices, min(TILE_MAX_PASS, batch))
            tile_rmw = r.tile_rmw
        else:
            r = module.emulate_split(bufs, facs, mode, i_out, slices)
            tile_rmw = 0
    except AssertionError as exc:  # the tile replay's check of its turns
        return PlanReplay(label, ordering, len(facs), mode, batch, slices, split_mode, nnz, i_out,
                          int(facs[0].shape[-1]), 0, 0, [], 0, 0, 0, 0, 0, float("inf"), False,
                          error=str(exc) or type(exc).__name__)
    want = mttkrp_plan_ref(bufs, facs, mode, i_out)
    gap = float((r.out - want).abs().max()) if want.numel() else 0.0
    close = bool(torch.allclose(r.out, want, rtol=PLAIN_TOL, atol=PLAIN_TOL))
    return PlanReplay(
        label=label, ordering=ordering, nmodes=len(facs), mode=mode, batch=batch, slices=slices,
        split_mode=split_mode, nnz=nnz, i_out=i_out, rank=int(facs[0].shape[-1]),
        store_min=int(r.stores.min()), store_max=int(r.stores.max()), census=r.census,
        entries_read=module.stream_entries_read(nnz_pad, slices, split_mode, batch),
        tile_rmw=tile_rmw, carry_reads=r.carry_reads, uninit_reads=r.uninit_reads,
        unmarked_reads=r.unmarked_reads,
        max_abs_vs_plain=gap if np.isfinite(gap) else float("inf"), matches_plain=close)


def _slice_counts(bufs, every: tuple) -> list[int]:
    nnz_pad = int(bufs.values.shape[0])
    return [nnz_pad + 1 if s == "more than the stream" else s for s in every]


def suite_tensor(nmodes: int) -> SparseTensor:
    """The suite's deterministic tensor of ``nmodes`` modes."""
    return random_sparse_tensor(REPLAY_SHAPES[nmodes], REPLAY_NNZ, seed=REPLAY_SEED + nmodes)


def suite_plan(tensor: SparseTensor, mode: int, ordering: str):
    """The suite's plan of ``tensor`` for ``mode`` in ``ordering``, built on the CPU."""
    return build_mttkrp_plan(tensor, mode, tile_nnz=REPLAY_TILE_NNZ,
                             rows_per_block=REPLAY_ROWS_PER_BLOCK, ordering=ordering,
                             device="cpu")


def _run_suite(module: ModuleType) -> list[PlanReplay]:
    out: list[PlanReplay] = []
    for nmodes in REPLAY_NMODES:
        shape = REPLAY_SHAPES[nmodes]
        tensor = suite_tensor(nmodes)
        for ordering in ORDERINGS:
            for mode in range(nmodes):
                bufs = ops.plan_device_buffers(suite_plan(tensor, mode, ordering), "cpu")
                for batch in REPLAY_BATCHES:
                    facs = _factors(shape, batch, seed=nmodes * 10 + batch)
                    counts = EDGE_SLICES if mode == 0 and batch == 1 else REPLAY_SLICES
                    for slices in _slice_counts(bufs, counts):
                        out.append(_replay(module, f"{ordering} N={nmodes} B={batch}", ordering,
                                           bufs, mode, shape[mode], tensor.nnz, facs, slices))
    for name, tensor in _edge_tensors().items():
        for mode in range(tensor.nmodes):
            plan = build_mttkrp_plan(tensor, mode, tile_nnz=16, rows_per_block=8, device="cpu")
            bufs = ops.plan_device_buffers(plan, "cpu")
            facs = _factors(tensor.shape, 1, seed=len(name))
            for slices in _slice_counts(bufs, (37, "more than the stream")):
                out.append(_replay(module, f"partition edge: {name}", "lex", bufs, mode,
                                   tensor.shape[mode], tensor.nnz, facs, slices))
    # One stacked service batch: three tenants of one padded geometry.
    dims = (16, 12, 10)
    tenants = [random_sparse_tensor(dims, n, seed=s) for s, n in ((1, 120), (2, 200), (3, 7))]
    indices, values, _ = ops.stacked_operands(tenants, dims, 256, device="cpu")
    facs = _factors([len(tenants) * d for d in dims], 1, seed=5)
    for mode in range(3):
        bufs = ops.stacked_plan_buffers(indices, values, [t.nnz for t in tenants], dims, mode,
                                        tile_nnz=16)
        out.append(_replay(module, "stacked service plan", "lex", bufs, mode,
                           len(tenants) * dims[mode], sum(t.nnz for t in tenants), facs, 37))
    return out


def replay_suite(ctx: "AnalysisContext") -> tuple["SourceFile | None", list[PlanReplay]]:
    """The scanned tree's replay module's file and its replays of the suite,
    run once per analysis; ``(None, [])`` when the tree has no replay module."""
    sf = ctx.file(PARTITION_PATH)
    if sf is None:
        return None, []
    key = f"replay_suite:{sf.abspath}"
    if key not in ctx.memo:
        ctx.memo[key] = _run_suite(_load_partition(sf))
    return sf, ctx.memo[key]


def suite_line(sf: "SourceFile", name: str) -> int:
    """The line of ``def name`` in the replay module (1 if absent)."""
    for i, line in enumerate(sf.lines, start=1):
        if line.startswith(f"def {name}("):
            return i
    return 1
