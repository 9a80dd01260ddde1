"""carry-init: no carry or partial-sum slot is read before it is written.

The counterpart of the JAX package's ``grid-carry-init``, which proves that
the Pallas kernel writes its VMEM accumulator before the grid step that
reads it.  The split MTTKRP kernel's accumulators that outlive a warp are
its carries: each slice's first and last row's partial sums (row-run
mode) or its first and last block's tiles (tile mode), written by launch 1
and summed by launch 2.  The replay (``kernels/mttkrp/partition.py``)
starts every carry slot as NaN with a written flag and counts launch 2's
reads of a slot launch 1 did not write, and of a slot marked ``-1`` (no
row or block).  Over the suite of ``analysis/replay.py`` both counts must
be zero; the facts give the slots proven.  A tile row starts at zero in
both the replay and the kernel; the kernel's audit build checks on the card
that no tile row is read before that fill.
"""

from __future__ import annotations

from repro_torch.analysis.core import AnalysisContext, Checker, register
from repro_torch.analysis.replay import replay_suite, suite_line


@register
class CarryInit(Checker):
    check_id = "carry-init"
    description = (
        "The split MTTKRP kernel's replayed launch 2 reads no carry slot launch 1 did not "
        "write, and no slot marked -1"
    )

    def run(self, ctx: AnalysisContext) -> None:
        sf, replays = replay_suite(ctx)
        if sf is None:
            return
        proven: dict[str, int] = {"rows": 0, "tiles": 0}
        for r in replays:
            fn = "emulate_tiles" if r.split_mode == "tiles" else "emulate_split"
            where = f"{r.label}, mode {r.mode}, {r.slices} slices"
            if r.uninit_reads:
                self.emit(sf, suite_line(sf, fn), f"{fn} ({where}): launch 2 read {r.uninit_reads} "
                                                  "carry slot(s) launch 1 did not write")
            if r.unmarked_reads:
                self.emit(sf, suite_line(sf, fn), f"{fn} ({where}): launch 2 read "
                                                  f"{r.unmarked_reads} carry slot(s) marked -1")
            if not (r.uninit_reads or r.unmarked_reads):
                proven[r.split_mode] += r.carry_reads
        self.facts = {"file": sf.path, "replays": len(replays), "carry_reads_proven": proven}
