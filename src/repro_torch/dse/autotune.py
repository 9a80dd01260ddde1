"""Closed-loop tile autotuning for the split MTTKRP kernel (DESIGN.md §13).

The port of ``repro.dse.autotune``.  The analytic design-space explorer
prices every configuration by the paper's closed-form memory model; this
module closes the loop: the plan-geometry knobs that exist in the port's
kernel — ``(tile_nnz, rows_per_block, ordering)`` — are swept with
*measured* time, the winner is cached by padded geometry band, and the
measurements feed back into the DSE evaluator so modeled and measured
seconds sit side by side in one table.

Three pieces, with the JAX package's names and defaults:

  * ``TileConfig`` / ``TuneSpace`` — the swept knob grid.  The default
    config ``(256, 256, "lex")`` is always a member, so the selected
    winner is ≤ the default *by construction under the shared
    measurement protocol* (argmin over a set containing the default, ties
    going to the default).
  * ``WallTimeMemo`` — a ``HitRateCache``-style memo (hits/misses
    counters, keyed store) of per-(signature, mode, config, device, reps)
    median times, so re-tuning a tensor that lands in an already-tuned
    band measures nothing.
  * ``Autotuner`` — tunes per tensor, keyed by
    ``repro_torch.serve.geometry_signature`` with ``n_iters=0``, the same
    power-of-two banding the service buckets on.  ``config_for`` is the
    duck-typed hook ``DecompositionService`` and ``FusedCPALS`` consume.

Where the JAX tuner has a ``backend`` (its resolver picks a compiled
Pallas path), the port has the device: ``"cuda"`` measures the split
kernel, ``"cpu"`` its plain PyTorch version.  The device's type takes
``backend``'s place in the memo key and in ``TuneResult`` (whose
``to_dict()`` keeps JAX's key ``"backend"`` for it).

The measurement protocol (``measure_config``) differs from JAX's fenced
wall medians on the card, where a call's wall time is mostly the host's:
see its docstring.

``measured_vs_modeled`` prices the tuner's per-ordering measurements
through ``evaluate_sweep``'s exact-trace method on an ad-hoc
characteristics record, returning rows with both numbers per config.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.cp_als import cp_init
from repro_torch.core.memory_tech import O_SRAM, MemoryTechSpec
from repro_torch.data.frostt import FrosttTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.dse.evaluator import evaluate_sweep
from repro_torch.dse.sweep import SweepPoint
from repro_torch.kernels.mttkrp.ops import get_plan, mttkrp_from_plan
from repro_torch.reorder import ORDERINGS
from repro_torch.serve.service import BucketSignature, geometry_signature

__all__ = [
    "TileConfig",
    "DEFAULT_TILE_CONFIG",
    "TuneSpace",
    "WallTimeMemo",
    "TuneResult",
    "Autotuner",
    "measure_config",
    "measured_vs_modeled",
]

# A device sleep of ~1 ms on an H100, ahead of each timed call: the host
# queues the call behind it, so the events around the call time the device
# alone (a call's host enqueue takes ~0.1 ms).
SLEEP_CYCLES = 2_000_000


@dataclasses.dataclass(frozen=True, order=True)
class TileConfig:
    """One point of the kernel plan-geometry space."""

    tile_nnz: int = 256
    rows_per_block: int = 256
    ordering: str = "lex"

    def __post_init__(self):
        if self.tile_nnz < 1:
            raise ValueError(f"tile_nnz must be >= 1, got {self.tile_nnz}")
        if self.rows_per_block < 1:
            raise ValueError(
                f"rows_per_block must be >= 1, got {self.rows_per_block}"
            )
        if self.ordering not in ORDERINGS:
            raise ValueError(
                f"unknown ordering {self.ordering!r}; known: {list(ORDERINGS)}"
            )

    @property
    def label(self) -> str:
        return f"({self.tile_nnz},{self.rows_per_block},{self.ordering})"


#: The fixed plan geometry every call site uses without a tuner.
DEFAULT_TILE_CONFIG = TileConfig(256, 256, "lex")


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """The swept grid.  ``configs()`` always contains the default config,
    first, which makes "tuned ≤ default" a structural property."""

    tile_nnz: tuple[int, ...] = (128, 256, 512)
    rows_per_block: tuple[int, ...] = (64, 256, 512)
    orderings: tuple[str, ...] = ("lex",)

    def configs(self) -> list[TileConfig]:
        out = [DEFAULT_TILE_CONFIG]
        for o in self.orderings:
            for t in self.tile_nnz:
                for r in self.rows_per_block:
                    cfg = TileConfig(t, r, o)
                    if cfg not in out:
                        out.append(cfg)
        return out


class WallTimeMemo:
    """Measured-seconds memo in the mold of ``dse.evaluator.HitRateCache``:
    a keyed store plus hits/misses counters, so tests and the card check
    can verify the tuner never re-measures a (band, mode, config) cell."""

    def __init__(self) -> None:
        self._store: dict[tuple, float] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def key(
        signature: BucketSignature,
        mode: int,
        config: TileConfig,
        device: str,
        reps: int,
    ) -> tuple:
        # ``device`` is the device's type ("cuda" or "cpu"), in JAX's
        # ``backend`` slot.  ``reps`` is part of the measurement protocol:
        # a median over 3 samples and one over 20 are different estimators.
        return (signature, mode, config, device, reps)

    def lookup(self, key: tuple) -> float | None:
        if key in self._store:
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def store(self, key: tuple, seconds: float) -> float:
        self._store[key] = float(seconds)
        return self._store[key]


def measure_config(
    tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    config: TileConfig,
    *,
    reps: int = 3,
) -> float:
    """Median seconds of one mode's MTTKRP under ``config``, on the
    factors' device.

    One untimed warm-up call absorbs the plan build (sorted on the factors'
    device for an ordering other than lex) and its upload; the median of
    ``reps`` samples follows.  On the CPU a sample is the wall time of one
    call of the plain version, which runs synchronously.  On the card a
    sample is the device time of one call of the split kernel (its main
    launch and its carry pass), read from two CUDA events around the call,
    the call queued behind a device sleep of about a millisecond: by the
    time the device reaches the first event the host has enqueued the
    whole call, so the host's enqueue gap is not counted.  JAX's fenced
    wall medians would rank configs by host overhead here: at 2M nonzeros
    a launch takes 0.06-0.26 ms of device time and a call 0.17-0.47 ms of
    wall (PERF.md §5).
    """
    plan = get_plan(
        tensor,
        mode,
        tile_nnz=config.tile_nnz,
        rows_per_block=config.rows_per_block,
        ordering=config.ordering,
        device=factors[0].device,
    )
    on_card = factors[0].device.type == "cuda"
    mttkrp_from_plan(plan, factors)
    times = []
    for _ in range(max(1, reps)):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            mttkrp_from_plan(plan, factors)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            mttkrp_from_plan(plan, factors)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of tuning one tensor band.  ``device`` is the type of the
    device measured on ("cuda" or "cpu"); ``to_dict()`` gives it under
    JAX's key ``"backend"``."""

    signature: BucketSignature
    device: str
    best: TileConfig
    timings: Mapping[TileConfig, float]  # summed over tuned modes
    # Which modes the timings cover.  A partial-mode result answers the
    # call that asked for it but is NOT a band cache entry: the band
    # winner must rank configs on a full CP-ALS sweep's worth of work.
    modes: tuple[int, ...] = ()

    @property
    def best_s(self) -> float:
        return self.timings[self.best]

    @property
    def default_s(self) -> float:
        return self.timings[DEFAULT_TILE_CONFIG]

    @property
    def speedup_vs_default(self) -> float:
        return self.default_s / self.best_s

    def to_dict(self) -> dict:
        return {
            "signature": dataclasses.asdict(self.signature),
            "backend": self.device,
            "modes": list(self.modes),
            "best": dataclasses.asdict(self.best),
            "best_s": self.best_s,
            "default_s": self.default_s,
            "speedup_vs_default": self.speedup_vs_default,
            "timings": {
                cfg.label: s for cfg, s in sorted(self.timings.items())
            },
        }


class Autotuner:
    """Per-tensor closed-loop tile tuner with band-keyed config caching.

    ``tune`` sweeps ``space.configs()`` over the tensor's modes with
    ``measure_config`` on ``device`` (default the card; raises without
    one) and caches the argmin per geometry band; ``config_for`` answers
    from that cache (optionally tuning on miss) and is the duck-typed hook
    of the service and the fused executor.
    """

    def __init__(
        self,
        space: TuneSpace | None = None,
        *,
        device: str | torch.device = DEFAULT_DEVICE,
        reps: int = 3,
        memo: WallTimeMemo | None = None,
        tune_on_miss: bool = False,
    ) -> None:
        # JAX's tuner raises ValueError for an unknown backend; this one
        # for a device it does not measure on.
        kind = device.type if isinstance(device, torch.device) else str(device).split(":")[0]
        if kind not in ("cuda", "cpu"):
            raise ValueError(
                f"unknown device={str(device)!r}; the tuner measures on 'cuda' (the split "
                "kernel) or 'cpu' (its plain version)"
            )
        self.space = space or TuneSpace()
        self.device = resolve_device(device)
        self.device_type = self.device.type
        self.reps = reps
        self.memo = memo if memo is not None else WallTimeMemo()
        self.tune_on_miss = tune_on_miss
        self.results: dict[BucketSignature, TuneResult] = {}

    @staticmethod
    def signature_of(tensor, rank: int) -> BucketSignature:
        """The tuning-cache key: the service's geometry band with
        ``n_iters=0`` (sweep count is irrelevant to kernel geometry)."""
        return geometry_signature(tensor.shape, tensor.nnz, rank, 0)

    def config_for(self, tensor, rank: int) -> TileConfig:
        """The cached winning config for the tensor's band.  Untuned bands
        answer the default config unless ``tune_on_miss``: admission must
        stay cheap by default."""
        sig = self.signature_of(tensor, rank)
        result = self.results.get(sig)
        if result is not None:
            return result.best
        if self.tune_on_miss:
            return self.tune(tensor, rank).best
        return DEFAULT_TILE_CONFIG

    def tune(
        self,
        tensor,
        rank: int,
        *,
        modes: Sequence[int] | None = None,
        seed: int = 0,
        force: bool = False,
    ) -> TuneResult:
        """Measure every config on ``tensor`` and cache the band winner.

        Timings sum the per-mode medians over ``modes`` (default: all
        modes, one CP-ALS sweep's worth of MTTKRP work).  Cells already
        measured for this band come from the ``WallTimeMemo``.  Only
        full-mode results enter the band cache.  ``force=True`` bypasses
        both the result cache and the memo and overwrites the memo cells.
        A config the kernel refuses (a ``rows_per_block`` the tile mode has
        no grid for) raises, naming the config: skipping it would hide the
        kernel.
        """
        sig = self.signature_of(tensor, rank)
        all_modes = tuple(range(tensor.nmodes))
        modes = all_modes if modes is None else tuple(int(m) for m in modes)
        covers_band = modes == all_modes
        if not force and covers_band and sig in self.results:
            return self.results[sig]
        factors = cp_init(tensor, rank, seed=seed, device=self.device)
        timings: dict[TileConfig, float] = {}
        for cfg in self.space.configs():
            total = 0.0
            for m in modes:
                key = self.memo.key(sig, m, cfg, self.device_type, self.reps)
                s = None if force else self.memo.lookup(key)
                if s is None:
                    try:
                        s = measure_config(tensor, factors, m, cfg, reps=self.reps)
                    except ValueError as err:
                        raise ValueError(
                            f"config {cfg.label}, mode {m}: the kernel refuses it: {err}"
                        ) from err
                    s = self.memo.store(key, s)
                total += s
            timings[cfg] = total
        best = min(timings, key=lambda c: (timings[c], c != DEFAULT_TILE_CONFIG))
        result = TuneResult(
            signature=sig,
            device=self.device_type,
            best=best,
            timings=timings,
            modes=modes,
        )
        if covers_band:
            self.results[sig] = result
        return result


def measured_vs_modeled(
    tensor,
    result: TuneResult,
    *,
    rank: int,
    name: str = "autotuned",
    tech: MemoryTechSpec = O_SRAM,
    zipf_alpha: float = 0.75,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[dict]:
    """Price the tuner's measurements against the analytic DSE model.

    Each distinct ordering in the tune result becomes one ``SweepPoint``
    evaluated with the exact-trace hit-rate method over THIS tensor (an
    ad-hoc characteristics record carries its true dims/nnz), so every
    measured config gets the closed-form Eq-1 seconds the paper's model
    assigns to its execution order.  Modeled seconds move only with the
    ordering axis: the model has no concept of tile geometry, which is why
    the measured column exists.  ``device`` is where the traces of
    orderings other than lex are sorted; the pricing is numpy on the host.
    """
    # math.prod over Python ints: np.prod wraps in int64 once the dense
    # volume passes 2**63, and a negative volume turns density into garbage.
    volume = math.prod(int(d) for d in tensor.shape)
    chars = FrosttTensor(
        name=name,
        dims=tuple(int(d) for d in tensor.shape),
        nnz=int(tensor.nnz),
        density=float(tensor.nnz / max(1, volume)),
        zipf_alpha=zipf_alpha,
    )
    orderings = sorted({cfg.ordering for cfg in result.timings})
    points = [
        SweepPoint(label=f"{name}[ordering={o}]", tech=tech, rank=rank, ordering=o)
        for o in orderings
    ]
    sweep = evaluate_sweep(
        points,
        {name: chars},
        hit_rate_method="trace",
        trace_tensors={name: tensor},
        trace_nnz_limit=max(tensor.nnz, 1),
        device=device,
    )
    modeled = {
        o: sweep.cell(f"{name}[ordering={o}]", name).seconds for o in orderings
    }
    rows = []
    for cfg, measured_s in sorted(result.timings.items()):
        rows.append(
            {
                "config": cfg.label,
                "tile_nnz": cfg.tile_nnz,
                "rows_per_block": cfg.rows_per_block,
                "ordering": cfg.ordering,
                "measured_s": measured_s,
                "modeled_s": modeled[cfg.ordering],
                "best": cfg == result.best,
            }
        )
    return rows
