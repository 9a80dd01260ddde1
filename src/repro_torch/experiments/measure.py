"""Measured CP-ALS runs: per-mode times, closed-form cost, executed-trace hit rates.

The port of ``repro.experiments.measure``, the measurement half of the
experiment engine (DESIGN.md §7): run real CP-ALS sweeps through one
MTTKRP impl and capture, per mode,

  * the wall time of every MTTKRP call, fenced by
    ``torch.cuda.synchronize()`` on both sides inside the ``perf_counter``
    interval (the counterpart of ``jax.block_until_ready``), and on the
    card its device time from CUDA events; the first call is kept apart
    from the steady median;
  * the call's cost in closed form: the paper's ``2·N·|T|·R`` flops and
    the bytes the function must move (``mttkrp_bytes``).  The JAX package
    reads XLA's ``cost_analysis()`` here; the port compiles nothing it
    could ask, so its numbers are the closed form by construction;
  * the EXECUTED nonzero order: the raw COO order for ``ref`` and the
    plan linearization for ``kernel`` (``MTTKRPPlan.executed_row_trace``),
    simulated exactly against any ``CacheGeometry`` through
    ``repro_torch.core.cache_sim.simulate_traces``.  The plan order is the
    modelled FPGA's stream (Algorithm 1).  The CUDA kernel reads that
    stream too, but in warp slices that run at once, so it is not the
    H100's own access order.

The impls are ``"ref"`` (``mttkrp_ref`` over the COO stream, uploaded
once) and ``"kernel"`` (the counterpart of JAX's ``"pallas"``: the
per-mode plans are built once, and on CUDA tensors every call is one
launch of the split kernel, in its row-run mode or, for a ``blocked``
plan, its tile mode).  ``"sharded"`` raises (ROADMAP.md Queue 1 item 8).

``ExecutedTraceHitRates`` packages the traces as a drop-in
``HitRateCache``, so the DSE evaluator prices the measured runs on every
technology without a separate pricing path (DESIGN.md §8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.cache_sim import CacheStats, simulate_traces
from repro_torch.core.cp_als import cp_als, cp_init
from repro_torch.core.cp_als_fused import FusedCPALS
from repro_torch.core.hierarchy import CacheGeometry
from repro_torch.core.mttkrp import check_impl, mttkrp, mttkrp_ref
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data.frostt import FrosttTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dse.evaluator import HitRateCache, geometry_sim_config
from repro_torch.kernels.mttkrp.ops import get_plan, tensor_device_operands
from repro_torch.reorder.strategies import nonzero_order, nonzero_order_tensor

__all__ = [
    "MeasuredMode",
    "MeasuredRun",
    "measure_cp_als",
    "mode_cost_analysis",
    "mttkrp_bytes",
    "executed_input_traces",
    "executed_traces",
    "executed_trace_stats",
    "ExecutedTraceHitRates",
]


@dataclasses.dataclass(frozen=True)
class MeasuredMode:
    """Times and closed-form cost of one mode's MTTKRP calls."""

    mode: int
    calls: int
    first_s: float  # first call (includes plan upload and first launch)
    steady_s: float  # median of the post-first calls (first if only one)
    total_s: float
    flops: float | None  # closed form 2·N·|T|·R; None without cost_analysis
    bytes_accessed: float | None  # mttkrp_bytes; None without cost_analysis
    paper_flops: float  # closed form 2·N·|T|·R (§IV-A)
    # Median CUDA-event time of the post-first calls (the first's alone if
    # there is one call); None off the card.
    steady_device_s: float | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class MeasuredRun:
    """One executed CP-ALS sweep of one impl on one scaled tensor.

    The ``fused_*`` fields are the fused executor's timing path
    (``repro_torch.core.cp_als_fused``, DESIGN.md §11), measured on the
    same (tensor, impl, ordering, initial factors): ``fused_wall_s`` is the
    cold run (executor construction included), ``fused_warm_wall_s`` a
    second run on the reused executor.  ``fused_max_fit_delta`` is the max
    |fused − eager| over the fit trajectories.  ``None`` when the fused
    path was not measured.
    """

    tensor: str
    impl: str
    rank: int
    n_iters: int
    fit: float
    iters: int
    wall_s: float
    modes: tuple[MeasuredMode, ...]
    fused_wall_s: float | None = None
    fused_warm_wall_s: float | None = None
    fused_fit: float | None = None
    fused_max_fit_delta: float | None = None

    @property
    def steady_mode_s(self) -> tuple[float, ...]:
        return tuple(m.steady_s for m in self.modes)

    @property
    def eager_warm_est_s(self) -> float:
        """Eager wall with each mode's first-call surplus removed.

        ``wall_s`` is one cold run; subtracting the per-mode surplus
        ``first_s − steady_s`` gives a warm-eager estimate to set beside
        the warm fused wall without a second eager run."""
        surplus = sum(max(m.first_s - m.steady_s, 0.0) for m in self.modes)
        return max(self.wall_s - surplus, 0.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["modes"] = [m.to_dict() for m in self.modes]
        return d

    @staticmethod
    def from_dict(d: dict) -> "MeasuredRun":
        modes = tuple(MeasuredMode(**m) for m in d["modes"])
        return MeasuredRun(**{**d, "modes": modes})


def mttkrp_bytes(
    shape: Sequence[int], mode: int, rank: int, *, stream_nnz: int, offsets: int = 0
) -> int:
    """Bytes one MTTKRP must move: each input read once, the output
    written once (float32 factors and values, int32 indices).

    Per streamed nonzero it needs N-1 gather indices, one output-row index
    and the value; ``offsets`` counts 8-byte stream offsets (a plan's
    block starts).  A plan also stores each row twice (``local_row`` and
    the output mode's index column); the second copy is not counted.
    """
    n = len(shape)
    stream = stream_nnz * (4 * (n - 1) + 4 + 4) + offsets * 8
    factors = sum(int(shape[k]) * rank * 4 for k in range(n) if k != mode)
    return stream + factors + int(shape[mode]) * rank * 4


def mode_cost_analysis(
    tensor: SparseTensor,
    rank: int,
    mode: int,
    impl: str,
    *,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> tuple[float, float]:
    """(flops, bytes) of one mode's MTTKRP in closed form.

    Flops are the paper's ``2·N·|T|·R``; bytes are ``mttkrp_bytes`` over
    the stream the impl reads: the COO nonzeros for ``ref``, the padded
    plan of the measured geometry (its plan, from the memo) for
    ``kernel``.  ``device`` sorts an ordered plan.
    """
    check_impl(impl)
    flops = 2.0 * tensor.nmodes * tensor.nnz * rank
    if impl == "kernel":
        plan = get_plan(
            tensor,
            mode,
            tile_nnz=tile_nnz,
            rows_per_block=rows_per_block,
            ordering=ordering if ordering is not None else "lex",
            device=device,
        )
        nbytes = mttkrp_bytes(
            tensor.shape, mode, rank, stream_nnz=plan.nnz_pad, offsets=plan.num_blocks + 1
        )
    else:
        nbytes = mttkrp_bytes(tensor.shape, mode, rank, stream_nnz=tensor.nnz)
    return flops, float(nbytes)


def measure_cp_als(
    tensor: SparseTensor,
    *,
    name: str,
    rank: int = 16,
    n_iters: int = 3,
    impl: str = "ref",
    seed: int = 0,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str | None = None,
    cost_analysis: bool = True,
    fused: bool = False,
    fit_every: int = 1,
    device: str | torch.device = DEFAULT_DEVICE,
    first_call_hook: Callable | None = None,
) -> MeasuredRun:
    """Run CP-ALS with an instrumented MTTKRP and collect per-mode timings.

    The tensor is uploaded to ``device`` once (default ``"cuda"``; raises
    without a GPU).  Every MTTKRP call runs between two
    ``torch.cuda.synchronize()`` inside its ``perf_counter`` interval, so
    the interval is the call alone as the host experiences it, and CUDA
    events give its device time.  The first call per mode is kept apart
    (``first_s``); ``steady_s`` is the median of the rest.

    ``ordering`` makes the impl execute the strategy's nonzero order
    (``repro_torch.reorder``, sorted on ``device``): the ref path gathers
    per-mode permuted streams, the kernel's plans linearize with it.
    ``None`` keeps the impl-native order.  For the degree strategy,
    relabel the tensor first; the engine does.

    The eager and the fused runs start from the same ``cp_init(seed)``
    draw.  ``fused=True`` also times the fused executor on the same
    configuration, one cold and one warm run, and attaches the
    ``fused_*`` fields.  ``first_call_hook(mode, factors, out)``, when
    given, sees each mode's first call after it was timed (the card check
    holds the kernel against its plain version there); its seconds, up to
    a ``torch.cuda.synchronize()`` after it, are left out of ``wall_s``.
    """
    check_impl(impl)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    init_factors = cp_init(tensor, rank, seed=seed, device=dev)
    indices, values, _ = tensor_device_operands(tensor, device=dev)
    if impl == "ref":
        streams = {m: (indices, values) for m in range(tensor.nmodes)}
        if ordering is not None:
            for m in range(tensor.nmodes):
                o = nonzero_order_tensor(
                    indices, tensor.shape, m, ordering, rows_per_block=rows_per_block
                )
                streams[m] = (indices[o], values[o])

        def base(t, f, m):
            i_m, v_m = streams[m]
            return mttkrp_ref((i_m, v_m, t.shape), f, m)

    else:
        plans = {
            m: get_plan(
                tensor,
                m,
                tile_nnz=tile_nnz,
                rows_per_block=rows_per_block,
                ordering=ordering if ordering is not None else "lex",
                device=dev,
            )
            for m in range(tensor.nmodes)
        }

        def base(t, f, m):
            # The plan encodes the geometry and the ordering; mttkrp_kernel
            # reads neither when it is given one.
            return mttkrp(t, f, m, impl="kernel", plan=plans[m], ordering=ordering)

    call_s: dict[int, list[float]] = {m: [] for m in range(tensor.nmodes)}
    device_s: dict[int, list[float]] = {m: [] for m in range(tensor.nmodes)}
    hook_s = 0.0  # seconds inside first_call_hook, kept out of wall_s

    def timed(t, f, m):
        nonlocal hook_s
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if on_card:
            start.record()
        out = base(t, f, m)
        if on_card:
            end.record()
            torch.cuda.synchronize()
        call_s[m].append(time.perf_counter() - t0)
        if on_card:
            device_s[m].append(start.elapsed_time(end) / 1e3)
        if first_call_hook is not None and len(call_s[m]) == 1:
            h0 = time.perf_counter()
            first_call_hook(m, f, out)
            if on_card:
                torch.cuda.synchronize()
            hook_s += time.perf_counter() - h0
        return out

    t0 = time.perf_counter()
    state = cp_als(
        tensor,
        rank,
        n_iters=n_iters,
        tol=0.0,
        seed=seed,
        mttkrp_fn=timed,
        device=dev,
        init_factors=init_factors,
    )
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0 - hook_s

    modes = []
    for m in range(tensor.nmodes):
        ts, ds = call_s[m], device_s[m]
        flops = nbytes = None
        if cost_analysis:
            flops, nbytes = mode_cost_analysis(
                tensor, rank, m, impl, tile_nnz=tile_nnz,
                rows_per_block=rows_per_block, ordering=ordering, device=dev,
            )
        modes.append(
            MeasuredMode(
                mode=m,
                calls=len(ts),
                first_s=ts[0],
                steady_s=float(np.median(ts[1:] if len(ts) > 1 else ts)),
                total_s=float(sum(ts)),
                flops=flops,
                bytes_accessed=nbytes,
                paper_flops=2.0 * tensor.nmodes * tensor.nnz * rank,
                steady_device_s=(
                    float(np.median(ds[1:] if len(ds) > 1 else ds)) if ds else None
                ),
            )
        )
    fused_wall = fused_warm = fused_fit = fused_delta = None
    if fused:
        t0 = time.perf_counter()
        executor = FusedCPALS(
            tensor,
            rank,
            impl=impl,
            device=dev,
            tile_nnz=tile_nnz,
            rows_per_block=rows_per_block,
            ordering=ordering,
        )
        executor.run(n_iters=n_iters, tol=0.0, fit_every=fit_every, init_factors=[init_factors])
        if on_card:
            torch.cuda.synchronize()
        fused_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = executor.run(
            n_iters=n_iters, tol=0.0, fit_every=fit_every, init_factors=[init_factors]
        )
        if on_card:
            torch.cuda.synchronize()
        fused_warm = time.perf_counter() - t0
        fused_fit = warm.state.fit
        fused_delta = float(
            np.max(np.abs(np.asarray(warm.state.fits) - np.asarray(state.fits)))
        )

    return MeasuredRun(
        tensor=name,
        impl=impl,
        rank=rank,
        n_iters=n_iters,
        fit=state.fit,
        iters=state.iters,
        wall_s=wall_s,
        modes=tuple(modes),
        fused_wall_s=fused_wall,
        fused_warm_wall_s=fused_warm,
        fused_fit=fused_fit,
        fused_max_fit_delta=fused_delta,
    )


# --------------------------------------------------------------------------
# Executed-order trace capture
# --------------------------------------------------------------------------


def executed_input_traces(
    tensor: SparseTensor,
    impl: str,
    mode: int,
    *,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict[int, list[np.ndarray]]:
    """Per input factor ``k``, the row-index streams ``impl`` accesses.

    One array per independent cache unit, and each impl here has one: the
    raw COO order for ``ref`` (the ref impl never reorders) and the plan's
    mode-ordered linearization for ``kernel``, the modelled FPGA's stream
    (module docstring).  Padding gathers are EXCLUDED: they fetch only a
    block's first row, do no useful work, and would inflate the measured
    reuse the reconciliation compares against the model.

    ``ordering`` selects an explicit execution-order strategy
    (``repro_torch.reorder``, sorted on ``device``): the ref stream
    follows the strategy permutation, the kernel plan linearizes with it.
    Mode *relabeling* (the degree strategy's other half) is the caller's
    job; the experiment engine passes the relabeled tensor.
    """
    check_impl(impl)
    inputs = [k for k in range(tensor.nmodes) if k != mode]
    if impl == "ref":
        if ordering is None:
            return {k: [tensor.indices[:, k]] for k in inputs}
        order = nonzero_order(
            tensor, mode, ordering, rows_per_block=rows_per_block, device=device
        )
        return {k: [tensor.indices[order, k]] for k in inputs}
    plan = get_plan(
        tensor,
        mode,
        tile_nnz=tile_nnz,
        rows_per_block=rows_per_block,
        ordering=ordering if ordering is not None else "lex",
        device=device,
    )
    return {k: [plan.executed_row_trace(k, include_padding=False)] for k in inputs}


def executed_traces(
    tensor: SparseTensor,
    impl: str,
    mode: int,
    k: int,
    *,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[np.ndarray]:
    """Single-input convenience wrapper around ``executed_input_traces``."""
    return executed_input_traces(
        tensor,
        impl,
        mode,
        tile_nnz=tile_nnz,
        rows_per_block=rows_per_block,
        ordering=ordering,
        device=device,
    )[k]


def executed_trace_stats(
    tensor: SparseTensor,
    impl: str,
    mode: int,
    geometry: CacheGeometry,
    rank: int,
    *,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str | None = None,
    input_traces: dict[int, list[np.ndarray]] | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> tuple[CacheStats, ...]:
    """Per input factor, exact LRU stats over the executed access order.

    The per-input capacity share comes from the SAME construction the DSE
    trace method uses (``geometry_sim_config``), so a measured hit rate
    and a DSE trace hit rate on the same geometry compare directly.
    ``input_traces`` injects a precomputed ``executed_input_traces``
    result (the hit-rate memo passes it so the ordering work is not redone
    per geometry).
    """
    n_inputs = max(1, tensor.nmodes - 1)
    cfg, row_bytes = geometry_sim_config(geometry, rank, n_inputs=n_inputs)
    if input_traces is None:
        input_traces = executed_input_traces(
            tensor,
            impl,
            mode,
            tile_nnz=tile_nnz,
            rows_per_block=rows_per_block,
            ordering=ordering,
            device=device,
        )
    return tuple(
        simulate_traces(input_traces[k], cfg, row_bytes=row_bytes)
        for k in range(tensor.nmodes)
        if k != mode
    )


class ExecutedTraceHitRates(HitRateCache):
    """A ``HitRateCache`` that answers from one impl's executed order.

    Passing this to ``repro_torch.dse.evaluate_sweep`` makes the evaluator
    price every technology's hierarchy with the hit rates the executed run
    produced (the measured side of the reconciliation) through its usual
    batching and energy pass.  The full ``CacheStats`` (with
    compulsory-miss counts, for the Che comparison) are kept in ``stats``
    keyed like the memo.  ``capture_s`` and ``simulate_s`` add up the host
    seconds spent linearizing traces and simulating them.
    """

    def __init__(
        self,
        tensor: SparseTensor,
        impl: str,
        *,
        tile_nnz: int = 256,
        rows_per_block: int = 256,
        ordering: str | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> None:
        super().__init__()
        check_impl(impl)
        self.tensor = tensor
        self.impl = impl
        self.tile_nnz = tile_nnz
        self.rows_per_block = rows_per_block
        # Execution-order strategy of the run this cache answers from;
        # None = the impl-native order.  For the degree strategy pass the
        # RELABELED tensor (relabeling needs factor perms: engine-side).
        self.ordering = ordering
        self.device = device
        self._point_orderings: set[str] = set()
        self.stats: dict[tuple, tuple[CacheStats, ...]] = {}
        self.geometries: dict[tuple, tuple[CacheGeometry, int]] = {}
        # Executed order depends only on the mode: linearize once and reuse
        # across every priced cache geometry.
        self._input_traces: dict[int, dict[int, list[np.ndarray]]] = {}
        self.capture_s = 0.0
        self.simulate_s = 0.0

    def input_traces(self, mode: int) -> dict[int, list[np.ndarray]]:
        if mode not in self._input_traces:
            t0 = time.perf_counter()
            self._input_traces[mode] = executed_input_traces(
                self.tensor,
                self.impl,
                mode,
                tile_nnz=self.tile_nnz,
                rows_per_block=self.rows_per_block,
                ordering=self.ordering,
                device=self.device,
            )
            self.capture_s += time.perf_counter() - t0
        return self._input_traces[mode]

    def get(
        self,
        tensor: FrosttTensor,
        mode: int,
        geometry: CacheGeometry,
        rank: int,
        *,
        ordering: str = "lex",
        **_ignored,
    ) -> tuple[float, ...]:
        # This cache answers from ONE executed run; a per-point `ordering`
        # cannot change the answer, so a sweep whose points vary it is an
        # error (it would report zero deltas, DESIGN.md §10).
        self._point_orderings.add(ordering)
        if len(self._point_orderings) > 1:
            raise ValueError(
                "ExecutedTraceHitRates answers from one executed run "
                f"(ordering={self.ordering!r}); it cannot differentiate the "
                f"sweep's ordering axis {sorted(self._point_orderings)} — "
                "build one cache per strategy (repro_torch.reorder.bench does)"
            )
        if tuple(tensor.dims) != tuple(self.tensor.shape):
            raise ValueError(
                f"characteristics {tensor.name!r} (dims {tensor.dims}) do not "
                f"describe the executed tensor (shape {self.tensor.shape})"
            )
        key = (mode, rank) + geometry.key()
        if key in self._store:
            self.hits += 1
            return self._store[key]
        self.misses += 1
        traces = self.input_traces(mode)
        t0 = time.perf_counter()
        stats = executed_trace_stats(
            self.tensor, self.impl, mode, geometry, rank, ordering=self.ordering,
            input_traces=traces,
        )
        self.simulate_s += time.perf_counter() - t0
        rates = tuple(s.hit_rate for s in stats)
        self._store[key] = rates
        self.stats[key] = stats
        self.geometries[key] = (geometry, mode)
        return rates
