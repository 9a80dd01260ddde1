"""docs-citation: every ``DESIGN.md §N`` citation must resolve to a heading.

The port's modules cite the repo's ``DESIGN.md`` as the JAX package does;
a citation of a section that has no heading sends the reader nowhere.
Findings carry the citing file and line; the facts record the census of
citations and of the sections defined.
"""

from __future__ import annotations

import re

from repro_torch.analysis.core import AnalysisContext, Checker, register

CITE_RE = re.compile(r"DESIGN\.md\s*§(\d+)")
HEADING_RE = re.compile(r"^#{1,4}\s*§(\d+)\b", re.MULTILINE)


@register
class DocsCitation(Checker):
    check_id = "docs-citation"
    description = "Every `DESIGN.md §N` citation in source resolves to a DESIGN.md heading"

    def run(self, ctx: AnalysisContext) -> None:
        design = ctx.root / "DESIGN.md"
        headings = set(HEADING_RE.findall(design.read_text())) if design.exists() else set()
        citations: dict[str, int] = {}
        for sf in ctx.scannable():
            for lineno, line in enumerate(sf.lines, start=1):
                for sec in CITE_RE.findall(line):
                    citations[sec] = citations.get(sec, 0) + 1
                    if sec not in headings:
                        known = ", ".join("§" + h for h in sorted(headings, key=int))
                        self.emit(sf, lineno, f"DESIGN.md §{sec} cited but DESIGN.md has no "
                                              f"matching heading (known: {known})")
        self.facts = {
            "citations": sum(citations.values()),
            "sections_cited": sorted(citations, key=int),
            "sections_defined": sorted(headings, key=int),
        }
