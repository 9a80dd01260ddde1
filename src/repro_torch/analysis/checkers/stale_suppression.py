"""stale-suppression: ``# repro_torch: ignore[...]`` must suppress something.

A suppression comment is a standing claim: "this line violates check X,
intentionally".  When the underlying code is fixed or the checker
sharpened, the comment outlives the finding and starts lying, and a new
violation on that line later is silently absorbed by it.  This audit runs
after every other selected checker (``run_analysis`` orders it last) and
flags each suppression entry that matched no emitted finding this run.

Judgment is per check id and only for ids whose checker actually ran
(``ctx.checks_run``).  Fixture files are exempt.  The finding is itself
suppressable (``# repro_torch: ignore[stale-suppression]``) for a
deliberately kept tombstone.  The JAX package's own marker is not read
here: its gate judges it.
"""

from __future__ import annotations

from repro_torch.analysis.core import AnalysisContext, Checker, register


@register
class StaleSuppression(Checker):
    check_id = "stale-suppression"
    description = (
        "Every `# repro_torch: ignore[check-id]` comment suppresses at least one finding of a "
        "checker that ran (audited last, per entry)"
    )

    def run(self, ctx: AnalysisContext) -> None:
        audited = stale = 0
        for sf in ctx.scannable():
            for lineno in sorted(sf.suppressions):
                for check_id in sorted(sf.suppressions[lineno]):
                    if check_id == self.check_id or check_id not in ctx.checks_run:
                        continue  # the audit's own tombstone, or a checker not run
                    audited += 1
                    if (lineno, check_id) in sf.used_suppressions:
                        continue
                    stale += 1
                    self.emit(
                        sf, lineno,
                        f"suppression `repro_torch: ignore[{check_id}]` matched no finding this "
                        "run: the violation it excused is gone; delete the comment (or it will "
                        "silently absorb the next real finding on this line)",
                    )
        self.facts = {"suppressions_audited": audited, "stale": stale}
