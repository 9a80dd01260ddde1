"""Copy of ``repro.core.hierarchy`` for the PyTorch port (numpy only, held
equal to the original by ``tests/test_torch_perf_model.py``).

Composable multi-level memory hierarchy (DESIGN.md §2, §9).

``MemoryHierarchy`` is an ordered stack of ``MemoryLevel``s — top level
closest to the compute mesh, bottom level the unbounded backing store —
plus a ``ComputeSpec`` that prices the paper's ``N·|T|·R`` elementary ops.
The paper's E-SRAM and O-SRAM FPGA systems, the TPU-v5e HBM→VMEM roofline,
and the photonic-IMC system of arXiv 2503.18206 are four instances of the
same stack (``fpga_hierarchy`` / ``tpu_hierarchy`` /
``photonic_imc_hierarchy``), and ``repro.dse`` sweeps hierarchy levels as
first-class axes.

A generic traffic-propagation pass turns the per-nonzero requests at the
top level — ``(N−1)`` factor-row loads, the nonzero stream, the amortized
output row — into residual traffic at each lower level: caching levels
absorb their (LRU-stack cumulative) hit fraction, everything else falls
through, and the backing store additionally carries the stream and output
bytes (the §IV-A formula, generalized).

Two timing families price a stack:

* ``"fpga"``     — the paper's three-rate steady-state model (§IV-B):
  compute lanes at ``f_clock``, per-level request-occupancy (``PortModel``,
  Eq 1) or bandwidth bounds, and the backing-store bandwidth.  Produces
  ``ModeTime`` (nonzeros per electrical cycle).
* ``"roofline"`` — seconds-domain rooflines: peak-FLOP/s compute term vs
  per-level byte/bandwidth terms.  Produces ``TpuModeTime``.  Photonic IMC
  uses this family with the MACs folded into the top memory level
  (``compute_in_memory``).

All engines are **batched**: they evaluate P design points at once with
NumPy element-wise ops.  Every expression preserves the operation order of
the original flat model, so a batch of one reproduces the paper tables
bit-exactly (``tests/test_hierarchy.py`` pins this against golden
fixtures).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from repro_torch.core.cache_sim import che_hit_rate
from repro_torch.core.memory_tech import (
    E_SRAM,
    PAPER_SYSTEM,
    MemoryTechSpec,
    SystemConstants,
    TpuSpec,
)

if TYPE_CHECKING:  # AcceleratorConfig lives above this module; duck-typed here.
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.data.frostt import FrosttTensor

__all__ = [
    "PSUM_ACCESSES_PER_NNZ",
    "analytic_traffic_census",
    "CacheGeometry",
    "PortModel",
    "SwitchingModel",
    "MemoryLevel",
    "ComputeSpec",
    "MemoryHierarchy",
    "ModeTime",
    "TpuModeTime",
    "LevelTraffic",
    "PhotonicImcSpec",
    "PHOTONIC_IMC",
    "fpga_hierarchy",
    "tpu_hierarchy",
    "photonic_imc_hierarchy",
    "resolve_hierarchy",
    "split_capacity_hit_rates",
    "scratchpad_hit_rates",
    "dram_traffic_per_nnz",
    "hierarchy_hit_rates",
    "propagate_traffic",
    "hierarchy_mode_time",
    "hierarchy_mode_times_batch",
    "hierarchy_energy",
    "hierarchy_energy_batch",
    "level_power_w",
]


# --------------------------------------------------------------------------
# Geometry: the hit-rate memo contract
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Hit-rate-determining geometry of one caching level.

    This is THE memo-key contract of DESIGN.md §8 step 3:
    ``repro.dse.evaluator.HitRateCache`` derives its key exclusively from
    ``key()``, which reads the single declared ``KEY_FIELDS`` tuple.  The
    import-time check below asserts every field of this dataclass appears
    in ``KEY_FIELDS`` — adding a geometry-affecting field without declaring
    it in the key is an ImportError, not a silent memo alias.
    """

    capacity_bytes: int
    line_bytes: int | None  # None -> row granularity (rank * value_bytes)
    associativity: int | None  # None -> fully-associative, Che-only level

    KEY_FIELDS = ("capacity_bytes", "line_bytes", "associativity")

    def key(self) -> tuple:
        return tuple(getattr(self, f) for f in self.KEY_FIELDS)


def _check_geometry_key_complete() -> None:
    declared = set(CacheGeometry.KEY_FIELDS)
    actual = {f.name for f in dataclasses.fields(CacheGeometry)}
    if declared != actual:
        raise AssertionError(
            "CacheGeometry.KEY_FIELDS must list every geometry field "
            f"(declared {sorted(declared)}, dataclass has {sorted(actual)}); "
            "a field affecting hit rates that is missing from the key would "
            "silently alias HitRateCache memo entries (DESIGN.md §8 step 3)"
        )


_check_geometry_key_complete()


# --------------------------------------------------------------------------
# Level building blocks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PortModel:
    """Eq-1 request-service model of an FPGA cache subsystem level (§IV).

    ``concurrency`` is the Eq-1 effective-port ratio of the level's memory
    technology over the electrical baseline (O-SRAM: 100×); the request
    occupancy of the electrical design divides by it.
    """

    n_units: int  # parallel cache units (n_pe * n_caches)
    base_occupancy: float  # cycles one request holds a unit
    miss_occupancy: float  # extra cycles on a miss
    concurrency: float  # Eq-1 port ratio vs the electrical baseline
    issue_limit: int  # requests/cycle roof of the electrical mesh (lanes)


@dataclasses.dataclass(frozen=True)
class SwitchingModel:
    """Eq-3 switched-bits accounting for one factor-row request.

    Phased access (tag probe, then the single hit way) switches only the
    needed bits; the parallel-access design pulls all ``associativity``
    ways + tags + LRU state per request and pays fill + victim writeback
    bits on misses (paper Figs 5/6).
    """

    phased: bool
    associativity: int
    tag_bits: int
    lru_bits: int


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of a memory hierarchy.

    ``capacity_bytes is None`` marks the backing store (DRAM/HBM): it
    terminates traffic propagation and must be the bottom level.  Caching
    levels filter factor-row requests via ``hit_model``:

    * ``"lru"``        — Che or exact-trace LRU on the level's (stack-
      cumulative) capacity share;
    * ``"scratchpad"`` — hit = 1 (software-managed level that always holds
      its working set);
    * ``"none"``       — annotation-only passthrough: it filters nothing
      and contributes NO timing or energy terms (the engines skip it), so
      declaring a bound or Eq-3 constants on one is a validation error.
    """

    name: str
    capacity_bytes: int | None = None  # None = backing store
    hit_model: str = "none"  # "lru" | "scratchpad" | "none"
    line_bytes: int | None = None  # fill granularity; None -> one factor row
    associativity: int | None = None
    bandwidth_bytes_per_s: float | None = None  # bandwidth roof, if bound
    port_model: PortModel | None = None  # FPGA request-occupancy bound
    switching_model: SwitchingModel | None = None  # Eq-3 switched bits
    static_pj_per_bit_cycle: float | None = None  # Eq-3 static energy
    switching_pj_per_bit: float | None = None  # Eq-3 switching energy
    provisioned_bytes: int | None = None  # capacity charged static power
    pj_per_byte: float | None = None  # per-byte interface energy (Eq-2 DRAM)
    # Declarative marker: this level's array performs the MACs (photonic
    # IMC).  The compute roof itself is supplied via ComputeSpec
    # (peak_flops = the array throughput); MemoryHierarchy validation
    # enforces that such a level is roofline-priced and bandwidth-bound.
    compute_in_memory: bool = False

    @property
    def is_backing_store(self) -> bool:
        return self.capacity_bytes is None

    @property
    def is_caching(self) -> bool:
        return not self.is_backing_store and self.hit_model != "none"


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """Prices the paper's ``N·|T|·R`` elementary ops for one mode.

    ``kind="lanes"``: ``lanes`` parallel pipelines at ``f_clock`` (the FPGA
    mesh).  ``kind="flops"``: a peak-ops/s roof (TPU MXU, or a photonic
    IMC array with the MACs folded into the memory level).
    """

    kind: str  # "lanes" | "flops"
    lanes: int = 0
    f_clock: float = 0.0  # electrical cycle for "lanes" (and Eq-3 static)
    peak_flops: float = 0.0
    power_w: float | None = None  # Eq-2 compute power; None -> no energy
    pj_per_flop: float | None = None  # per-MAC energy (IMC)


@dataclasses.dataclass(frozen=True)
class MemoryHierarchy:
    """An ordered memory stack: top (closest to compute) → backing store."""

    name: str
    levels: tuple[MemoryLevel, ...]
    compute: ComputeSpec
    family: str  # "fpga" | "roofline" — which timing engine prices it
    value_bytes: int = 4
    index_bytes: int = 4

    def __post_init__(self):
        if len(self.levels) < 2:
            raise ValueError(f"{self.name}: a hierarchy needs >= 2 levels")
        if not self.levels[-1].is_backing_store:
            raise ValueError(f"{self.name}: bottom level must be the backing store")
        for lvl in self.levels[:-1]:
            if lvl.is_backing_store:
                raise ValueError(
                    f"{self.name}: backing store {lvl.name!r} must be the bottom level"
                )
        if self.backing.bandwidth_bytes_per_s is None:
            raise ValueError(f"{self.name}: backing store needs a bandwidth")
        if self.family not in ("fpga", "roofline"):
            raise ValueError(f"{self.name}: unknown timing family {self.family!r}")
        if self.family == "fpga" and self.compute.kind != "lanes":
            raise ValueError(f"{self.name}: fpga family prices compute in lanes")
        if not self.caching_levels():
            raise ValueError(f"{self.name}: no caching level above the backing store")
        for lvl in self.levels[:-1]:
            if lvl.hit_model == "none" and (
                lvl.port_model is not None
                or lvl.bandwidth_bytes_per_s is not None
                or lvl.switching_model is not None
                or lvl.static_pj_per_bit_cycle is not None
            ):
                raise ValueError(
                    f"{self.name}: passthrough level {lvl.name!r} "
                    "(hit_model='none') is skipped by every engine; its "
                    "timing/energy models would be silently ignored — give "
                    "it a hit model or drop the bounds"
                )
        for lvl in self.levels:
            if lvl.compute_in_memory and (
                self.family != "roofline" or lvl.bandwidth_bytes_per_s is None
            ):
                raise ValueError(
                    f"{self.name}: compute-in-memory level {lvl.name!r} needs "
                    "the roofline family and an array bandwidth — the MAC "
                    "roof itself is supplied via ComputeSpec(peak_flops=...)"
                )

    @property
    def backing(self) -> MemoryLevel:
        return self.levels[-1]

    def caching_levels(self) -> list[MemoryLevel]:
        return [lvl for lvl in self.levels[:-1] if lvl.is_caching]

    def hit_geometries(self) -> tuple[CacheGeometry, ...]:
        """Per caching level, the *stack-cumulative* geometry its hit rate
        is solved on (LRU-stack inclusion: a level's reuse window spans its
        own capacity plus everything above it)."""
        out, cum = [], 0
        for lvl in self.caching_levels():
            cum += lvl.capacity_bytes
            out.append(
                CacheGeometry(
                    capacity_bytes=cum,
                    line_bytes=lvl.line_bytes,
                    associativity=lvl.associativity,
                )
            )
        return tuple(out)

    # --- level surgery (sweepable hierarchy edits, DESIGN.md §9) ----------

    def _index_of(self, level_name: str) -> int:
        for i, lvl in enumerate(self.levels):
            if lvl.name == level_name:
                return i
        raise KeyError(f"{self.name}: no level named {level_name!r}")

    def replace_level(self, level_name: str, **changes: Any) -> "MemoryHierarchy":
        """A copy with one level's fields replaced (sweep-axis primitive)."""
        i = self._index_of(level_name)
        levels = list(self.levels)
        levels[i] = dataclasses.replace(levels[i], **changes)
        return dataclasses.replace(self, levels=tuple(levels))

    def with_level(self, level: MemoryLevel, index: int) -> "MemoryHierarchy":
        """A copy with ``level`` inserted at ``index`` (add-a-level axis)."""
        levels = list(self.levels)
        levels.insert(index, level)
        return dataclasses.replace(self, levels=tuple(levels))

    def without_level(self, level_name: str) -> "MemoryHierarchy":
        """A copy with one level removed (remove-a-level axis)."""
        i = self._index_of(level_name)
        return dataclasses.replace(
            self, levels=tuple(l for j, l in enumerate(self.levels) if j != i)
        )

    @property
    def has_energy_model(self) -> bool:
        """True when Eq-2 constants exist for EVERY term of this stack:
        the compute term, the backing-store interface, and (for any level
        declaring Eq-3 static constants) the full per-level set.  A stack
        missing any of them prices with ``energy_j=None`` rather than
        crashing the energy engine on a half-specified level."""
        if self.family == "fpga":
            if self.compute.power_w is None or self.backing.pj_per_byte is None:
                return False
            return all(
                lvl.static_pj_per_bit_cycle is None
                or (
                    lvl.switching_pj_per_bit is not None
                    and lvl.provisioned_bytes is not None
                )
                for lvl in self.caching_levels()
            )
        if self.compute.pj_per_flop is None or self.backing.pj_per_byte is None:
            return False
        return all(
            lvl.static_pj_per_bit_cycle is None
            or (lvl.provisioned_bytes is not None and self.compute.f_clock > 0)
            for lvl in self.caching_levels()
        )

    def batch_signature(self) -> tuple:
        """Structural fingerprint two stacks must share to batch together.

        The batched engines read which sub-models exist (port, bandwidth,
        switching, Eq-3 constants) per caching level; grouping by this
        signature keeps that uniform across a batch, so a stack can never
        inherit another point's model presence.
        """
        return (
            self.family,
            self.has_energy_model,
            tuple(
                (
                    lvl.port_model is not None,
                    lvl.bandwidth_bytes_per_s is not None,
                    lvl.switching_model is not None,
                    lvl.static_pj_per_bit_cycle is not None,
                )
                for lvl in self.caching_levels()
            ),
        )

    def fill_granularity(self, level: MemoryLevel, rank: Any) -> Any:
        """Bytes one fill request at ``level`` moves: its line, or one
        factor row when the level is row-granular (``line_bytes=None``)."""
        if level.line_bytes is not None:
            return level.line_bytes
        return rank * self.value_bytes


# --------------------------------------------------------------------------
# Result records (shared with repro.core.accelerator / repro.perf.roofline)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModeTime:
    """Per-mode steady-state rates (nonzeros per electrical cycle) + time."""

    mode: int
    rate_compute: float
    rate_cache: float
    rate_dram: float
    hit_rates: tuple[float, ...]
    dram_bytes: float
    onchip_bytes_touched: float
    seconds: float

    @property
    def bottleneck(self) -> str:
        rates = {
            "compute": self.rate_compute,
            "onchip": self.rate_cache,
            "dram": self.rate_dram,
        }
        return min(rates, key=rates.get)


@dataclasses.dataclass(frozen=True)
class TpuModeTime:
    """Roofline time for one spMTTKRP mode on a seconds-domain hierarchy.

    Mirrors ``ModeTime`` closely enough for the DSE comparison layer:
    ``seconds`` + a ``bottleneck`` label + the backing-store traffic.
    ``onchip_s``/``onchip_bytes`` are nonzero only for hierarchies whose
    top level is itself bandwidth-bound (photonic IMC); for the TPU they
    stay 0 and ``seconds`` reduces to ``max(compute_s, memory_s)``.
    """

    mode: int
    compute_s: float
    memory_s: float
    hit_rates: tuple[float, ...]
    hbm_bytes: float
    onchip_s: float = 0.0
    onchip_bytes: float = 0.0

    @property
    def seconds(self) -> float:
        return max(self.compute_s, self.memory_s, self.onchip_s)

    @property
    def bottleneck(self) -> str:
        if self.onchip_s > max(self.compute_s, self.memory_s):
            return "onchip"
        return "compute" if self.compute_s >= self.memory_s else "memory"


@dataclasses.dataclass(frozen=True)
class LevelTraffic:
    """Per-nonzero bytes one hierarchy level serves (propagation output)."""

    level: str
    request_bytes: float  # factor-row fills that reach this level
    stream_bytes: float  # nonzero stream + output bytes (backing store only)

    @property
    def total_bytes(self) -> float:
        return self.request_bytes + self.stream_bytes


# --------------------------------------------------------------------------
# Hit rates and traffic propagation
# --------------------------------------------------------------------------


def split_capacity_hit_rates(
    tensor: "FrosttTensor",
    mode: int,
    *,
    capacity_bytes: int,
    rank: int,
    trace_length: float | None = None,
) -> tuple[float, ...]:
    """Che/LRU hit rate per input factor for a shared row-cache capacity.

    The capacity (whatever memory plays the factor-row cache — the FPGA
    cache subsystem, TPU VMEM, or a photonic IMC array) is split evenly
    across the N-1 input factor matrices (§IV: 'Each cache is shared with
    multiple input factor matrices').  ``trace_length`` switches the Che
    solve to its finite-trace (transient) form — used by the experiment
    engine to reconcile measured executed traces (DESIGN.md §7).
    """
    row_bytes = rank * 4
    total_rows = capacity_bytes // row_bytes
    n_inputs = max(1, tensor.nmodes - 1)
    rows_per_input = max(1, total_rows // n_inputs)
    hits = []
    for k in range(tensor.nmodes):
        if k == mode:
            continue
        hits.append(
            che_hit_rate(
                tensor.dims[k],
                rows_per_input,
                zipf_alpha=tensor.zipf_alpha,
                trace_length=trace_length,
            )
        )
    return tuple(hits)


#: Partial-sum accesses per nonzero: one read + one write of the output
#: accumulator row (the §IV switching term's RMW pair).  The symbolic
#: traffic interpreter (repro.analysis.traffic) proves the XLA kernel's
#: ``acc.at[rows].add`` performs exactly this many accumulator accesses
#: per nonzero; the ``traffic-model-drift`` checker pins the two against
#: each other.
PSUM_ACCESSES_PER_NNZ = 2


def analytic_traffic_census(nmodes: int) -> dict[str, int]:
    """The per-nonzero element counts the performance model is built on.

    These are the coefficients behind ``_traffic_terms`` and
    ``propagate_traffic`` — stated as counts (not bytes) so the static
    traffic interpreter can compare them term-for-term against the
    closed forms it extracts from the kernel ASTs:

    * ``values_per_nnz`` — the nonzero's value, streamed once;
    * ``indices_per_nnz`` — one coordinate per tensor mode (the §IV-A
      stream term is ``value_bytes + nmodes · index_bytes``);
    * ``factor_rows_per_nnz`` — one row per input factor (``N−1``), the
      request count arriving at the top caching level;
    * ``output_rows_amortized`` — output traffic is ``I_mode · rank``
      elements total, i.e. amortized (not per-nonzero);
    * ``psum_accesses_per_nnz`` — the accumulator RMW pair.
    """
    n_inputs = max(1, nmodes - 1)
    return {
        "values_per_nnz": 1,
        "indices_per_nnz": nmodes,
        "factor_rows_per_nnz": n_inputs,
        "output_rows_amortized": 1,
        "psum_accesses_per_nnz": PSUM_ACCESSES_PER_NNZ,
    }


def _traffic_terms(
    tensor: "FrosttTensor",
    mode: int,
    residual_sum: Any,
    *,
    rank: Any,
    row_bytes: Any,
    value_bytes: Any = 4,
    index_bytes: Any = 4,
) -> tuple[Any, Any, Any]:
    """§IV-A traffic per nonzero given the accumulated residual miss
    fraction (scalars or per-point NumPy arrays, identical op order)."""
    stream_bytes = value_bytes + tensor.nmodes * index_bytes
    miss_bytes = residual_sum * row_bytes
    out_bytes = tensor.dims[mode] * rank * value_bytes / tensor.nnz
    return stream_bytes, miss_bytes, out_bytes


def dram_traffic_per_nnz(
    tensor: "FrosttTensor",
    mode: int,
    hit_rates: tuple[float, ...],
    *,
    rank: int,
    row_bytes: float,
    value_bytes: int = 4,
    index_bytes: int = 4,
) -> tuple[float, float, float]:
    """Paper §IV-A traffic per nonzero: (stream, factor-miss, output) bytes.

    stream — the nonzero element itself (value + per-mode indices);
    miss   — factor-row fills, only cache MISSES touch the backing store;
    output — the output factor matrix, amortized over the nonzeros.
    The two-level specialization of ``propagate_traffic``, kept as the
    shared formula every instance prices DRAM/HBM with (DESIGN.md §2).
    """
    residual = sum((1.0 - h) for h in hit_rates)
    return _traffic_terms(
        tensor,
        mode,
        residual,
        rank=rank,
        row_bytes=row_bytes,
        value_bytes=value_bytes,
        index_bytes=index_bytes,
    )


def hierarchy_hit_rates(
    hier: MemoryHierarchy, tensor: "FrosttTensor", mode: int, *, rank: int
) -> tuple[tuple[float, ...], ...]:
    """Per caching level, per input factor: the level's cumulative hit rate.

    Cumulative means LRU-stack inclusive (each level is solved on its own
    capacity plus everything above it), so ``level k`` absorbs
    ``H_k − H_{k−1}`` of the request stream during propagation.
    Scratchpad levels hit everything by definition.
    """
    pairs = zip(hier.caching_levels(), hier.hit_geometries())
    return _hits_for_level_pairs(pairs, tensor, mode, rank)


def scratchpad_hit_rates(tensor: "FrosttTensor") -> tuple[float, ...]:
    """Per-input hit rates of a scratchpad level: everything hits.

    The single definition of scratchpad semantics — shared by the scalar
    path here and the memoized DSE path (repro.dse.evaluator).
    """
    return tuple(1.0 for _ in range(max(1, tensor.nmodes - 1)))


def _hits_for_level_pairs(
    pairs, tensor: "FrosttTensor", mode: int, rank: int
) -> tuple[tuple[float, ...], ...]:
    out = []
    for lvl, geom in pairs:
        if lvl.hit_model == "scratchpad":
            out.append(scratchpad_hit_rates(tensor))
        else:
            out.append(
                split_capacity_hit_rates(
                    tensor, mode, capacity_bytes=geom.capacity_bytes, rank=rank
                )
            )
    return tuple(out)


def propagate_traffic(
    hier: MemoryHierarchy,
    tensor: "FrosttTensor",
    mode: int,
    *,
    rank: int,
    level_hits: tuple[tuple[float, ...], ...] | None = None,
) -> tuple[LevelTraffic, ...]:
    """The generic pass: per-nonzero requests at the top level → residual
    traffic at each lower level.

    Factor-row requests arrive at the top caching level in full
    (``N−1``/nonzero); caching level k passes fraction ``1 − H_k`` of each
    input's requests downward.  A level serves its own fill granularity;
    the backing store serves the granularity of the caching level directly
    above it, plus the nonzero stream and the amortized output rows.
    """
    if level_hits is None:
        level_hits = hierarchy_hit_rates(hier, tensor, mode, rank=rank)
    n_inputs = max(1, tensor.nmodes - 1)
    out: list[LevelTraffic] = []
    arriving = tuple(1.0 for _ in range(n_inputs))  # fraction per input
    last_gran = rank * hier.value_bytes
    k = -1  # caching-level counter (passthrough levels don't consume hits)
    for lvl in hier.levels[:-1]:
        if not lvl.is_caching:
            out.append(LevelTraffic(lvl.name, 0.0, 0.0))
            continue
        k += 1
        gran = hier.fill_granularity(lvl, rank)
        out.append(
            LevelTraffic(lvl.name, request_bytes=sum(arriving) * gran, stream_bytes=0.0)
        )
        arriving = tuple(1.0 - h for h in level_hits[k])
        last_gran = gran
    residual = sum(arriving)
    stream, miss, out_b = _traffic_terms(
        tensor,
        mode,
        residual,
        rank=rank,
        row_bytes=last_gran,
        value_bytes=hier.value_bytes,
        index_bytes=hier.index_bytes,
    )
    out.append(
        LevelTraffic(hier.backing.name, request_bytes=miss, stream_bytes=stream + out_b)
    )
    return tuple(out)


# --------------------------------------------------------------------------
# Batched timing engines
# --------------------------------------------------------------------------


def _hits_array(
    all_hits: Sequence[tuple[tuple[float, ...], ...]], level_idx: int, n_inputs: int
) -> np.ndarray:
    """[P, n_inputs] float64 array of one caching level's hit rates."""
    return np.array(
        [[pt[level_idx][i] for i in range(n_inputs)] for pt in all_hits],
        dtype=np.float64,
    )


def _residual_sum(hits: np.ndarray, n_inputs: int) -> np.ndarray:
    # Sequential accumulation, matching the flat model's builtin-sum order.
    s = np.zeros(hits.shape[0])
    for i in range(n_inputs):
        s = s + (1.0 - hits[:, i])
    return s


def _sum_cols(arr: np.ndarray) -> np.ndarray:
    # Sequential column sum, same op order as the flat model's builtin sum.
    s = np.zeros(arr.shape[0])
    for i in range(arr.shape[1]):
        s = s + arr[:, i]
    return s


def _fpga_mode_times_batch(
    hiers: Sequence[MemoryHierarchy],
    tensor: "FrosttTensor",
    mode: int,
    ranks: np.ndarray,
    all_hits: Sequence[tuple[tuple[float, ...], ...]],
) -> list[ModeTime]:
    """Price one (tensor, mode) across P fpga-family stacks at once.

    Element-wise NumPy float64 ops in the flat model's exact operation
    order: a batch of one is bit-identical to the historical scalar path.
    """
    n = tensor.nmodes
    nnz = tensor.nnz
    P = len(hiers)
    n_inputs = n - 1
    requests_per_nnz = n_inputs

    f = np.array([h.compute.f_clock for h in hiers])
    lanes = np.array([h.compute.lanes for h in hiers], dtype=np.int64)
    value_bytes = np.array([h.value_bytes for h in hiers], dtype=np.int64)
    index_bytes = np.array([h.index_bytes for h in hiers], dtype=np.int64)

    # --- compute rate (paper: N*|T|*R ops per mode) ------------------------
    rate_compute = lanes / (n * ranks)

    # --- per-level bounds + request propagation ----------------------------
    caching = hiers[0].caching_levels()
    n_caching = len(caching)
    rate_onchip = np.full(P, np.inf)
    switched = np.zeros(P)
    # Per-input fraction of factor-row requests arriving at this level
    # ([P, n_inputs]); None means the full integer request count (top).
    arriving: np.ndarray | None = None
    hits_k = None
    gran = None
    for k in range(n_caching):
        levels = [h.caching_levels()[k] for h in hiers]
        hits_k = _hits_array(all_hits, k, n_inputs)
        gran = np.array(
            [
                hiers[p].fill_granularity(levels[p], ranks[p])
                for p in range(P)
            ],
            dtype=np.int64,
        )
        requests = requests_per_nnz if arriving is None else _sum_cols(arriving)

        pm = levels[0].port_model
        if pm is not None:
            n_units = np.array([l.port_model.n_units for l in levels], dtype=np.int64)
            base = np.array([l.port_model.base_occupancy for l in levels])
            miss_occ = np.array([l.port_model.miss_occupancy for l in levels])
            conc = np.array([l.port_model.concurrency for l in levels])
            issue = np.array([l.port_model.issue_limit for l in levels], dtype=np.int64)
            avg_occ = np.zeros(P)
            for i in range(n_inputs):
                avg_occ = avg_occ + (base + (1.0 - hits_k[:, i]) * miss_occ)
            avg_occ = avg_occ / max(n_inputs, 1)
            rate_k = (n_units * conc) / (requests * avg_occ)
            # Bounded by issue slots of the electrical mesh (§III-A), over
            # the requests actually arriving at this level.
            rate_k = np.minimum(rate_k, issue / requests)
            rate_onchip = np.minimum(rate_onchip, rate_k)

        bw = levels[0].bandwidth_bytes_per_s
        if bw is not None:
            bw_arr = np.array([l.bandwidth_bytes_per_s for l in levels])
            rate_onchip = np.minimum(rate_onchip, bw_arr / (requests * gran * f))

        sm = levels[0].switching_model
        if sm is not None:
            # Eq-3 switched bits per request at this level (Figs 5/6).
            line_bits = gran * 8
            tag = np.array([l.switching_model.tag_bits for l in levels], dtype=np.int64)
            lru = np.array([l.switching_model.lru_bits for l in levels], dtype=np.int64)
            assoc = np.array(
                [l.switching_model.associativity for l in levels], dtype=np.int64
            )
            phased = np.array([l.switching_model.phased for l in levels])
            for i in range(n_inputs):
                h = hits_k[:, i]
                phased_bits = tag + line_bits + (1.0 - h) * line_bits
                parallel_bits = (
                    assoc * (line_bits + tag)
                    + lru
                    + (1.0 - h) * 2 * line_bits  # fill + victim writeback
                )
                # Weight by THIS input's arriving fraction (1 at the top).
                w = 1.0 if arriving is None else arriving[:, i]
                switched = switched + w * np.where(
                    phased, phased_bits, parallel_bits
                )

        arriving = 1.0 - hits_k

    # --- backing store (DRAM): §IV-A traffic, misses only for rows ---------
    residual = _sum_cols(arriving)
    dram_bw = np.array([h.backing.bandwidth_bytes_per_s for h in hiers])
    stream_b, miss_b, out_b = _traffic_terms(
        tensor,
        mode,
        residual,
        rank=ranks,
        row_bytes=gran,
        value_bytes=value_bytes,
        index_bytes=index_bytes,
    )
    dram_bytes_per_nnz = stream_b + miss_b + out_b
    rate_dram = dram_bw / (dram_bytes_per_nnz * f)

    rate = np.minimum(np.minimum(rate_compute, rate_onchip), rate_dram)
    seconds = nnz / (rate * f)

    # Partial-sum RMW and the nonzero stream switch bits once, at the top.
    psum_bits = PSUM_ACCESSES_PER_NNZ * ranks * 32
    stream_bits = stream_b * 8
    switched_per_nnz = switched + psum_bits + stream_bits

    top_hits = _hits_array(all_hits, 0, n_inputs) if n_caching else None
    out: list[ModeTime] = []
    for p in range(P):
        out.append(
            ModeTime(
                mode=mode,
                rate_compute=float(rate_compute[p]),
                rate_cache=float(rate_onchip[p]),
                rate_dram=float(rate_dram[p]),
                hit_rates=tuple(float(x) for x in top_hits[p]),
                dram_bytes=float(dram_bytes_per_nnz[p] * nnz),
                onchip_bytes_touched=float(switched_per_nnz[p] / 8.0 * nnz),
                seconds=float(seconds[p]),
            )
        )
    return out


def _roofline_mode_times_batch(
    hiers: Sequence[MemoryHierarchy],
    tensor: "FrosttTensor",
    mode: int,
    ranks: np.ndarray,
    all_hits: Sequence[tuple[tuple[float, ...], ...]],
) -> list[TpuModeTime]:
    """Seconds-domain roofline across P stacks (TPU, photonic IMC)."""
    n = tensor.nmodes
    nnz = tensor.nnz
    P = len(hiers)
    n_inputs = n - 1

    peak = np.array([h.compute.peak_flops for h in hiers])
    flops = float(n) * nnz * ranks
    compute_s = flops / peak

    caching = hiers[0].caching_levels()
    n_caching = len(caching)
    arriving: np.ndarray | None = None
    gran = None
    onchip_s = np.zeros(P)
    onchip_bytes = np.zeros(P)
    for k in range(n_caching):
        levels = [h.caching_levels()[k] for h in hiers]
        hits_k = _hits_array(all_hits, k, n_inputs)
        gran = np.array(
            [hiers[p].fill_granularity(levels[p], ranks[p]) for p in range(P)],
            dtype=np.int64,
        )
        requests = n_inputs if arriving is None else arriving
        if levels[0].bandwidth_bytes_per_s is not None:
            bw = np.array([l.bandwidth_bytes_per_s for l in levels])
            # Every request touches the level (hits included).  Partial-sum
            # RMW (2 output-row slices per nonzero) lives at the TOP level
            # only — it never traverses deeper caching levels.
            if k == 0:
                psum = PSUM_ACCESSES_PER_NNZ * ranks * np.array(
                    [h.value_bytes for h in hiers], dtype=np.int64
                )
                level_bytes = (requests * gran + psum) * nnz
            else:
                level_bytes = (requests * gran) * nnz
            onchip_s = onchip_s + level_bytes / bw
            onchip_bytes = onchip_bytes + level_bytes
        arriving = _residual_sum(hits_k, n_inputs)

    value_bytes = np.array([h.value_bytes for h in hiers], dtype=np.int64)
    index_bytes = np.array([h.index_bytes for h in hiers], dtype=np.int64)
    stream_b, miss_b, out_b = _traffic_terms(
        tensor,
        mode,
        arriving,
        rank=ranks,
        row_bytes=gran,
        value_bytes=value_bytes,
        index_bytes=index_bytes,
    )
    hbm_bytes = (stream_b + miss_b + out_b) * nnz
    hbm_bw = np.array([h.backing.bandwidth_bytes_per_s for h in hiers])
    memory_s = hbm_bytes / hbm_bw

    top_hits = _hits_array(all_hits, 0, n_inputs)
    out: list[TpuModeTime] = []
    for p in range(P):
        out.append(
            TpuModeTime(
                mode=mode,
                compute_s=float(compute_s[p]),
                memory_s=float(memory_s[p]),
                hit_rates=tuple(float(x) for x in top_hits[p]),
                hbm_bytes=float(hbm_bytes[p]),
                onchip_s=float(onchip_s[p]),
                onchip_bytes=float(onchip_bytes[p]),
            )
        )
    return out


def hierarchy_mode_times_batch(
    hiers: Sequence[MemoryHierarchy],
    tensor: "FrosttTensor",
    mode: int,
    ranks: Sequence[int],
    all_hits: Sequence[tuple[tuple[float, ...], ...]],
) -> list[ModeTime] | list[TpuModeTime]:
    """Price one (tensor, mode) across P same-family hierarchies at once.

    ``all_hits[p]`` holds, per caching level of ``hiers[p]``, the tuple of
    per-input hit rates (from ``hierarchy_hit_rates`` or the DSE memo).
    """
    signatures = {h.batch_signature() for h in hiers}
    if len(signatures) != 1:
        raise ValueError(
            "batch must share one structural signature (family, energy "
            f"model, per-level sub-models), got {len(signatures)} distinct"
        )
    ranks_arr = np.asarray(ranks, dtype=np.int64)
    if hiers[0].family == "fpga":
        return _fpga_mode_times_batch(hiers, tensor, mode, ranks_arr, all_hits)
    return _roofline_mode_times_batch(hiers, tensor, mode, ranks_arr, all_hits)


def hierarchy_mode_time(
    hier: MemoryHierarchy,
    tensor: "FrosttTensor",
    mode: int,
    *,
    rank: int = 16,
    hit_rates: tuple[float, ...] | None = None,
) -> ModeTime | TpuModeTime:
    """Scalar entry point: a batch of one.

    ``hit_rates`` optionally injects the TOP caching level's per-input hit
    rates (the legacy ``mode_execution_time`` contract, fed by the DSE
    memo); only the deeper levels — none, on the paper's 2-level stacks —
    are solved here in that case.
    """
    if hit_rates is None:
        level_hits = hierarchy_hit_rates(hier, tensor, mode, rank=rank)
    else:
        deeper = list(zip(hier.caching_levels(), hier.hit_geometries()))[1:]
        level_hits = (tuple(hit_rates),) + _hits_for_level_pairs(
            deeper, tensor, mode, rank
        )
    return hierarchy_mode_times_batch([hier], tensor, mode, [rank], [level_hits])[0]


# --------------------------------------------------------------------------
# Energy (Eq 2 / Eq 3, generalized per level)
# --------------------------------------------------------------------------


def level_power_w(
    *,
    provisioned_bytes: int,
    static_pj_per_bit_cycle: float,
    switching_pj_per_bit: float,
    active_bytes_per_cycle: float,
    f_clock: float,
) -> tuple[float, float]:
    """Paper Eq (3): (static_W, switching_W) for one on-chip level.

    Static power charges the full provisioned capacity; switching charges
    the actively accessed bits per clock cycle.  Pure element-wise
    arithmetic: every argument may be a scalar or a per-point NumPy array
    (the batched energy engine passes arrays).
    """
    total_bits = provisioned_bytes * 8
    static_w = total_bits * static_pj_per_bit_cycle * 1e-12 * f_clock
    active_bits = active_bytes_per_cycle * 8
    switching_w = active_bits * switching_pj_per_bit * 1e-12 * f_clock
    return static_w, switching_w


def hierarchy_energy_batch(
    hiers: Sequence[MemoryHierarchy],
    tensor: "FrosttTensor",
    mode_times_per_point: Sequence[Sequence[ModeTime | TpuModeTime]],
) -> list[tuple[float | None, dict | None]]:
    """Eq-2 energy across P same-family stacks: E = P_comp·t + E_backing +
    Σ_levels P_level·t, accumulated over all modes of the tensor.

    Points without energy constants (the TPU stack) yield ``(None, None)``.
    Like ``hierarchy_mode_times_batch``, the batch must share one
    structural signature — the engines read sub-model layout from point 0.
    """
    P = len(hiers)
    signatures = {h.batch_signature() for h in hiers}
    if len(signatures) != 1:
        raise ValueError(
            "energy batch must share one structural signature (family, "
            f"energy model, per-level sub-models), got {len(signatures)} distinct"
        )
    if not hiers[0].has_energy_model:
        return [(None, None)] * P
    if hiers[0].family == "fpga":
        return _fpga_energy_batch(hiers, mode_times_per_point)
    return _imc_energy_batch(hiers, mode_times_per_point)


def _fpga_energy_batch(
    hiers: Sequence[MemoryHierarchy],
    mode_times_per_point: Sequence[Sequence[ModeTime]],
) -> list[tuple[float, dict]]:
    P = len(hiers)
    n_modes = len(mode_times_per_point[0])
    power_w = np.array([h.compute.power_w for h in hiers])
    f = np.array([h.compute.f_clock for h in hiers])
    pj_byte = np.array([h.backing.pj_per_byte for h in hiers])
    # The provisioned on-chip system: every caching level with Eq-3 constants.
    sram_levels = [
        [l for l in h.caching_levels() if l.static_pj_per_bit_cycle is not None]
        for h in hiers
    ]
    e_compute = np.zeros(P)
    e_dram = np.zeros(P)
    e_sram = np.zeros(P)
    for m in range(n_modes):
        t = np.array([mode_times_per_point[p][m].seconds for p in range(P)])
        dram_bytes = np.array(
            [mode_times_per_point[p][m].dram_bytes for p in range(P)]
        )
        touched = np.array(
            [mode_times_per_point[p][m].onchip_bytes_touched for p in range(P)]
        )
        e_compute = e_compute + power_w * t
        e_dram = e_dram + dram_bytes * pj_byte * 1e-12
        active_bytes_per_cycle = touched / (t * f)
        # Flat-model op order: level_power_w element-wise over the batch.
        mode_sram = np.zeros(P)
        n_sram = len(sram_levels[0])
        for j in range(n_sram):
            static_w, switching_w = level_power_w(
                provisioned_bytes=np.array(
                    [sram_levels[p][j].provisioned_bytes for p in range(P)],
                    dtype=np.int64,
                ),
                static_pj_per_bit_cycle=np.array(
                    [sram_levels[p][j].static_pj_per_bit_cycle for p in range(P)]
                ),
                switching_pj_per_bit=np.array(
                    [sram_levels[p][j].switching_pj_per_bit for p in range(P)]
                ),
                active_bytes_per_cycle=active_bytes_per_cycle,
                f_clock=f,
            )
            mode_sram = mode_sram + (static_w + switching_w) * t
        e_sram = e_sram + mode_sram
    total = e_compute + e_dram + e_sram
    return [
        (
            float(total[p]),
            {
                "compute": float(e_compute[p]),
                "dram": float(e_dram[p]),
                "sram": float(e_sram[p]),
            },
        )
        for p in range(P)
    ]


def _imc_energy_batch(
    hiers: Sequence[MemoryHierarchy],
    mode_times_per_point: Sequence[Sequence[TpuModeTime]],
) -> list[tuple[float, dict]]:
    """Energy for seconds-domain stacks with IMC constants (DESIGN.md §9).

    Per mode: MAC energy (``pj_per_flop`` covers the in-array switching,
    arXiv 2503.18206's fJ-class optical MAC), backing-store interface
    energy per byte, and array static power on the provisioned capacity.
    """
    P = len(hiers)
    n_modes = len(mode_times_per_point[0])
    peak = np.array([h.compute.peak_flops for h in hiers])
    pj_flop = np.array([h.compute.pj_per_flop for h in hiers])
    # has_energy_model guarantees every term's constants exist.
    pj_byte = np.array([h.backing.pj_per_byte for h in hiers])
    static_w = np.zeros(P)
    for p, h in enumerate(hiers):
        for lvl in h.caching_levels():
            if lvl.static_pj_per_bit_cycle is not None:
                s, _ = level_power_w(
                    provisioned_bytes=lvl.provisioned_bytes,
                    static_pj_per_bit_cycle=lvl.static_pj_per_bit_cycle,
                    switching_pj_per_bit=0.0,
                    active_bytes_per_cycle=0.0,
                    f_clock=h.compute.f_clock,
                )
                static_w[p] += s
    e_compute = np.zeros(P)
    e_dram = np.zeros(P)
    e_sram = np.zeros(P)
    for m in range(n_modes):
        mts = [mode_times_per_point[p][m] for p in range(P)]
        t = np.array([mt.seconds for mt in mts])
        flops = np.array([mt.compute_s for mt in mts]) * peak
        e_compute = e_compute + flops * pj_flop * 1e-12
        e_dram = e_dram + np.array([mt.hbm_bytes for mt in mts]) * pj_byte * 1e-12
        e_sram = e_sram + static_w * t
    total = e_compute + e_dram + e_sram
    return [
        (
            float(total[p]),
            {
                "compute": float(e_compute[p]),
                "dram": float(e_dram[p]),
                "sram": float(e_sram[p]),
            },
        )
        for p in range(P)
    ]


def hierarchy_energy(
    hier: MemoryHierarchy,
    tensor: "FrosttTensor",
    mode_times: Sequence[ModeTime | TpuModeTime],
) -> tuple[float | None, dict | None]:
    """Scalar Eq-2 energy for one stack (a batch of one)."""
    return hierarchy_energy_batch([hier], tensor, [list(mode_times)])[0]


# --------------------------------------------------------------------------
# Instances: the four systems as one stack
# --------------------------------------------------------------------------


def fpga_hierarchy(
    tech: MemoryTechSpec,
    *,
    accel: "AcceleratorConfig",
    system: SystemConstants = PAPER_SYSTEM,
) -> MemoryHierarchy:
    """The paper's wafer-scale FPGA (§IV/§V-A) as a 2-level stack.

    Top: the cache subsystem in ``tech`` (E-SRAM or O-SRAM), request-
    occupancy bound with the Eq-1 concurrency ratio over the electrical
    baseline.  Bottom: the DDR4 channels.  Identical constants and
    operation order to the historical flat model.
    """
    f = system.f_electrical
    concurrency = tech.effective_ports(f) / E_SRAM.effective_ports(f)
    lanes = accel.n_pe * accel.pipelines_per_pe
    onchip = MemoryLevel(
        name=f"{tech.name} cache",
        capacity_bytes=accel.n_caches * accel.cache.capacity_bytes,
        hit_model="lru",
        line_bytes=accel.cache.line_bytes,
        associativity=accel.cache.associativity,
        port_model=PortModel(
            n_units=accel.n_pe * accel.n_caches,
            base_occupancy=accel.base_request_occupancy,
            miss_occupancy=accel.miss_occupancy,
            concurrency=concurrency,
            issue_limit=lanes,
        ),
        switching_model=SwitchingModel(
            phased=tech.phased_access,
            associativity=accel.cache.associativity,
            tag_bits=accel.tag_bits,
            lru_bits=accel.lru_bits,
        ),
        static_pj_per_bit_cycle=tech.static_pj_per_bit_cycle,
        switching_pj_per_bit=tech.switching_pj_per_bit,
        provisioned_bytes=system.onchip_bytes,
    )
    dram = MemoryLevel(
        name="DRAM",
        bandwidth_bytes_per_s=system.dram_bw,
        pj_per_byte=system.dram_pj_per_byte,
    )
    compute = ComputeSpec(
        kind="lanes", lanes=lanes, f_clock=f, power_w=system.compute_power_w
    )
    return MemoryHierarchy(
        name=f"{tech.name} FPGA",
        levels=(onchip, dram),
        compute=compute,
        family="fpga",
        value_bytes=accel.value_bytes,
        index_bytes=accel.index_bytes,
    )


def tpu_hierarchy(hw: TpuSpec) -> MemoryHierarchy:
    """TPU-v5e-class chip as a 2-level stack: VMEM row cache over HBM.

    No Table-III constants exist for HBM, so the stack carries no energy
    model and compares on time only (DESIGN.md §8).
    """
    vmem = MemoryLevel(
        name="VMEM",
        capacity_bytes=hw.vmem_bytes,
        hit_model="lru",
        line_bytes=None,  # row-granular fills (rank * 4 bytes)
        associativity=None,  # fully-associative Che model only
    )
    hbm = MemoryLevel(name="HBM", bandwidth_bytes_per_s=hw.hbm_bw)
    compute = ComputeSpec(kind="flops", peak_flops=hw.peak_bf16_flops)
    return MemoryHierarchy(
        name=hw.name, levels=(vmem, hbm), compute=compute, family="roofline"
    )


@dataclasses.dataclass(frozen=True)
class PhotonicImcSpec:
    """Photonic SRAM-based in-memory computing (arXiv 2503.18206).

    The pSRAM array both stores factor rows and performs the MACs
    (compute-in-memory), so the compute roof IS the array throughput:
    ``n_arrays × wavelengths`` MACs per array cycle.  Constants the paper
    gives as ranges are fixed here and marked CALIBRATED.
    """

    name: str = "pSRAM-IMC"
    frequency_hz: float = 10e9  # GHz-class optical array clock (§III)
    wavelengths: int = 4  # WDM MAC lanes per array (CALIBRATED)
    n_arrays: int = 432  # 432 x 128 KB = the paper platform's 54 MB
    array_kbytes: int = 128
    pj_per_mac: float = 0.05  # fJ-class optical MAC, 50 fJ (CALIBRATED)
    static_pj_per_bit_cycle: float = 4.17e-6  # photonic bitcell static
    static_ref_hz: float = 500e6  # Table-III constants are per 500 MHz cycle

    @property
    def capacity_bytes(self) -> int:
        return self.n_arrays * self.array_kbytes * 1024

    @property
    def peak_macs_per_s(self) -> float:
        return self.n_arrays * self.wavelengths * self.frequency_hz

    @property
    def array_bandwidth_bytes_per_s(self) -> float:
        # One 32-bit operand word per MAC lane per array cycle.
        return self.peak_macs_per_s * 4


PHOTONIC_IMC = PhotonicImcSpec()


def photonic_imc_hierarchy(
    spec: PhotonicImcSpec = PHOTONIC_IMC,
    *,
    system: SystemConstants = PAPER_SYSTEM,
) -> MemoryHierarchy:
    """arXiv 2503.18206's pSRAM-IMC system as a 2-level stack.

    The top level is the photonic array: an LRU-modeled row store whose
    bandwidth bound doubles as the compute roof (``compute_in_memory``).
    The backing store reuses the paper platform's DDR4 channels so the
    comparison isolates the on-chip stack.
    """
    array = MemoryLevel(
        name="pSRAM array",
        capacity_bytes=spec.capacity_bytes,
        hit_model="lru",
        line_bytes=None,  # row-granular, like VMEM
        associativity=None,
        bandwidth_bytes_per_s=spec.array_bandwidth_bytes_per_s,
        static_pj_per_bit_cycle=spec.static_pj_per_bit_cycle,
        provisioned_bytes=spec.capacity_bytes,
        compute_in_memory=True,
    )
    dram = MemoryLevel(
        name="DRAM",
        bandwidth_bytes_per_s=system.dram_bw,
        pj_per_byte=system.dram_pj_per_byte,
    )
    compute = ComputeSpec(
        kind="flops",
        peak_flops=spec.peak_macs_per_s,
        f_clock=spec.static_ref_hz,
        pj_per_flop=spec.pj_per_mac,
    )
    return MemoryHierarchy(
        name=spec.name, levels=(array, dram), compute=compute, family="roofline"
    )


def resolve_hierarchy(
    spec: "MemoryHierarchy | MemoryTechSpec | TpuSpec | PhotonicImcSpec",
    *,
    accel: "AcceleratorConfig",
    system: SystemConstants = PAPER_SYSTEM,
) -> MemoryHierarchy:
    """Any technology spec → its memory stack (the DSE entry point).

    A ``MemoryHierarchy`` passes through; the legacy per-technology specs
    build their canonical instances.  This replaces the evaluator's old
    ``SweepPoint.is_tpu`` special case.
    """
    if isinstance(spec, MemoryHierarchy):
        return spec
    if isinstance(spec, MemoryTechSpec):
        return fpga_hierarchy(spec, accel=accel, system=system)
    if isinstance(spec, TpuSpec):
        return tpu_hierarchy(spec)
    if isinstance(spec, PhotonicImcSpec):
        return photonic_imc_hierarchy(spec, system=system)
    raise TypeError(f"cannot build a MemoryHierarchy from {type(spec).__name__}")
