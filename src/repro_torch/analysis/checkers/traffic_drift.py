"""traffic-model-drift: what the split kernel consumes is the model's census.

The counterpart of the JAX package's ``traffic-model-drift``.  The
performance model (``repro_torch.core.hierarchy``) prices one MTTKRP from
``analytic_traffic_census(N)``: per nonzero one value, ``N`` index
columns and ``N - 1`` factor rows, and ``I_mode * R`` output elements
stored once per restart.  The O-SRAM against E-SRAM price, the paper's
claim, rests on that census.  This gate holds the split kernel's replay
(``kernels/mttkrp/partition.py``, whose counts are of what the kernel
consumes) to it exactly, with no tolerance:

  1. **Census identity**: for every replay of the suite of
     ``analysis/replay.py`` (N = 3, 4 and 5, every ordering, B = 1 and 4)
     and every restart, the values, index columns, factor rows and output
     stores counted equal the census times the real nonzeros
     (``analysis.census.census_drift``).
  2. **Replayed streams**: ``model.controller.request_stream_lengths``,
     the traffic the cache and controller models consume, gives one
     request per input factor per nonzero in every ordering and mode.
  3. **Executed traces**: ``MTTKRPPlan.executed_row_trace`` with padding
     gives ``N - 1`` rows per stream entry, the rows the kernel gathers
     before it drops a padding entry's product.

Reported, not compared: the stream entries the kernel reads or stages
beyond the nonzeros (padding, whole steps, the tile mode's alignment),
and the partial-sum accesses per nonzero, which differ from the model's
read-modify-write pair by design (the row-run mode sums in registers; the
tile mode adds once per run of one row to a shared-memory tile row).
The kernel's audit build counts the same census on the card.
"""

from __future__ import annotations

from repro_torch.analysis import replay
from repro_torch.analysis.census import census_drift
from repro_torch.analysis.core import AnalysisContext, Checker, register
from repro_torch.analysis.replay import (
    replay_suite,
    suite_line,
    suite_plan,
    suite_tensor,
)


@register
class TrafficModelDrift(Checker):
    check_id = "traffic-model-drift"
    description = (
        "The split MTTKRP kernel's replayed census equals analytic_traffic_census(N) x nnz "
        "exactly for N = 3, 4, 5, and matches request_streams and executed_row_trace"
    )

    def run(self, ctx: AnalysisContext) -> None:
        sf, replays = replay_suite(ctx)
        if sf is None:
            return
        identities = 0
        for r in replays:
            fn = "emulate_tiles" if r.split_mode == "tiles" else "emulate_split"
            for b, got in enumerate(r.census):
                drift = census_drift(got, r.nmodes, r.nnz, r.i_out, r.rank)
                identities += not drift
                for msg in drift:
                    self.emit(sf, suite_line(sf, fn), f"{fn} ({r.label}, mode {r.mode}, "
                                                      f"{r.slices} slices, restart {b}): {msg}")
        streams, traces = self._streams_and_traces(ctx, sf)
        by_mode = {m: [r for r in replays if r.split_mode == m] for m in ("rows", "tiles")}
        self.facts = {
            "file": sf.path,
            # read at the call, as replay_suite reads it, not bound at import
            "nmodes_checked": list(replay.REPLAY_NMODES),
            "census_identities_verified": identities,
            "request_streams_verified": streams,
            "executed_traces_verified": traces,
            # Over the whole suite: stream entries read or staged past the
            # nonzeros, and partial-sum accesses (a tile row's read and write
            # per run), each over the nonzeros.
            "excess_entries_read_per_nnz": {
                m: sum(r.entries_read - r.nnz for r in rs) / sum(r.nnz for r in rs) if rs else None
                for m, rs in by_mode.items()},
            "psum_accesses_per_nnz": {
                "rows": 0.0,  # sums in registers
                "tiles": sum(2 * r.tile_rmw for r in by_mode["tiles"])
                / sum(r.nnz for r in by_mode["tiles"]) if by_mode["tiles"] else None,
            },
        }

    def _streams_and_traces(self, ctx: AnalysisContext, sf) -> tuple[int, int]:
        from repro_torch.core.hierarchy import analytic_traffic_census
        from repro_torch.model.controller import request_stream_lengths
        from repro_torch.reorder import ORDERINGS

        streams = traces = 0
        for nmodes in replay.REPLAY_NMODES:
            tensor = suite_tensor(nmodes)
            rows_per_nnz = analytic_traffic_census(nmodes)["factor_rows_per_nnz"]
            for ordering in ORDERINGS:
                for mode in range(nmodes):
                    lengths = request_stream_lengths(tensor, mode, ordering=ordering, device="cpu")
                    if (len(lengths) != rows_per_nnz
                            or any(v != tensor.nnz for v in lengths.values())):
                        self.emit(sf, 1, f"request_streams ({ordering!r}, N={nmodes}, mode "
                                         f"{mode}) gave {lengths}: not one request per input "
                                         f"per nonzero ({rows_per_nnz * tensor.nnz} in all)")
                    else:
                        streams += 1
                    plan = suite_plan(tensor, mode, ordering)
                    executed = sum(int(plan.executed_row_trace(k, include_padding=True).shape[0])
                                   for k in range(nmodes) if k != mode)
                    if executed != rows_per_nnz * plan.nnz_pad:
                        self.emit(sf, 1, f"executed_row_trace ({ordering!r}, N={nmodes}, mode "
                                         f"{mode}) holds {executed} rows, not "
                                         f"{rows_per_nnz} x {plan.nnz_pad} stream entries")
                    else:
                        traces += 1
        return streams, traces
