"""kernel-contract: every output element of the port's kernels stored once.

The counterpart of the JAX package's ``pallas-kernel-contract``, which
proves from the Pallas kernel's source that its output ref is stored
exactly once and never read.  The port's kernels are CUDA C++, which an
AST cannot read, so the contract is proven on what mirrors their launches:

  * the split MTTKRP kernel, by its CPU replay (``partition.emulate_split``
    for the row-run mode, ``partition.emulate_tiles`` for the tile mode,
    each where ``kernel.split_mode_for`` picks it) over the suite of
    ``analysis/replay.py``: every output element receives exactly one
    store across the pair of launches, and the replay equals
    ``ref.mttkrp_plan_ref`` on the same plan;
  * the flash-attention kernels, by their grid (``kernel.cta_rows``, one
    CTA per ``(b, h, query tile)`` as the sources decode ``blockIdx``):
    every ``(b, s, h)`` output row belongs to exactly one CTA.

The card's half is the split kernel's audit build
(``kernel.mttkrp_cuda_audit``), which counts the stores of the kernel
itself; ``chip_smoke.py`` runs it.  The facts mirror JAX's
``kernels[].out_refs[].stores``.
"""

from __future__ import annotations

import itertools

import numpy as np

from repro_torch.analysis.core import AnalysisContext, Checker, register
from repro_torch.analysis.replay import PLAIN_TOL, replay_suite, suite_line

FLASH_PATH = "src/repro_torch/kernels/flash_attention/kernel.py"
# Phase 6's sequence lengths of chip_smoke.py, batches and heads.
FLASH_SEQS = (1, 63, 64, 65, 127, 129, 200, 1000)
FLASH_BATCHES = (1, 3)
FLASH_HEADS = (4, 16)


@register
class KernelContract(Checker):
    check_id = "kernel-contract"
    description = (
        "The split MTTKRP kernel's replayed launches store every output element exactly once "
        "and equal the plain version; the flash kernels' grids store every (b, s, h) row once"
    )

    def run(self, ctx: AnalysisContext) -> None:
        kernels: list[dict] = []
        sf, replays = replay_suite(ctx)
        if sf is not None:
            for split_mode, fn, name in (("rows", "emulate_split",
                                          "mttkrp_split_kernel + mttkrp_carry_kernel"),
                                         ("tiles", "emulate_tiles",
                                          "mttkrp_tile_kernel + mttkrp_tile_carry_kernel")):
                runs = [r for r in replays if r.split_mode == split_mode]
                line = suite_line(sf, fn)
                for r in runs:
                    where = f"{r.label}, mode {r.mode}, {r.slices} slices"
                    if r.error:
                        self.emit(sf, line, f"{fn} ({where}) raised: {r.error}")
                        continue
                    if (r.store_min, r.store_max) != (1, 1):
                        self.emit(sf, line, f"{fn} ({where}): output elements stored "
                                            f"{r.store_min}..{r.store_max} times, not exactly once")
                    if not r.matches_plain:
                        self.emit(sf, line, f"{fn} ({where}): differs from ref.mttkrp_plan_ref by "
                                            f"{r.max_abs_vs_plain:.3e} (tol {PLAIN_TOL:g})")
                kernels.append({
                    "kernel": name,
                    "file": sf.path,
                    "replay": fn,
                    "replays": len(runs),
                    "out": {"stores": [min((r.store_min for r in runs), default=None),
                                       max((r.store_max for r in runs), default=None)]},
                    "max_abs_vs_plain": max((r.max_abs_vs_plain for r in runs), default=0.0),
                })
            self.facts["cells"] = sorted({f"{r.ordering} N={r.nmodes} B={r.batch}"
                                          for r in replays if "N=" in r.label})
            self.facts["other_plans"] = sorted({r.label for r in replays if "N=" not in r.label})
            self.facts["slice_counts"] = sorted({r.slices for r in replays})
        flash = ctx.file(FLASH_PATH)
        if flash is not None:
            kernels.append(self._flash_grid(flash))
        self.facts["kernels"] = kernels

    def _flash_grid(self, sf) -> dict:
        from repro_torch.kernels.flash_attention.kernel import QUERY_TILE, cta_rows

        ctas = 0
        cover_min, cover_max = None, None
        for variant, causal, b, s, h in itertools.product(
                QUERY_TILE, (True, False), FLASH_BATCHES, FLASH_SEQS, FLASH_HEADS):
            cover = np.zeros((b, s, h), dtype=np.int64)
            for bb, hh, q0, q1 in cta_rows(b, s, h, variant, causal):
                cover[bb, q0:q1, hh] += 1
                ctas += 1
            lo, hi = int(cover.min()), int(cover.max())
            cover_min = lo if cover_min is None else min(cover_min, lo)
            cover_max = hi if cover_max is None else max(cover_max, hi)
            if (lo, hi) != (1, 1):
                self.emit(sf, 1, f"flash grid {variant} causal={causal} B={b} S={s} H={h}: "
                                 f"output rows covered {lo}..{hi} times, not exactly once")
        return {"kernel": "flash_fwd_sm90_kernel, flash_fwd_bf16_kernel, flash_fwd_f32_kernel",
                "file": sf.path, "replay": "cta_rows", "ctas": ctas,
                "out": {"stores": [cover_min, cover_max]}}
