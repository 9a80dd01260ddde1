"""FROSTT tensor characteristics — paper Table II (copy of ``repro.data.frostt``).

``zipf_alpha`` is the per-tensor index-popularity skew the synthetic
stand-ins draw with; the values are the JAX package's, fixed once and
never tuned per experiment.
"""

from __future__ import annotations

import dataclasses

__all__ = ["FrosttTensor", "FROSTT_TENSORS", "PAPER_RANK"]

PAPER_RANK = 16  # §V-A2: tensor rank R is set to 16


@dataclasses.dataclass(frozen=True)
class FrosttTensor:
    name: str
    dims: tuple[int, ...]
    nnz: int
    density: float
    zipf_alpha: float  # index popularity skew (see module docstring)

    def __post_init__(self):
        # A density outside (0, 1] is always an upstream arithmetic bug,
        # typically a dense volume that overflowed int64.
        if not 0.0 < self.density <= 1.0:
            raise ValueError(
                f"{self.name}: density must be in (0, 1], got "
                f"{self.density!r} (int-overflowed volume?)"
            )
        if self.nnz < 1:
            raise ValueError(f"{self.name}: nnz must be >= 1, got {self.nnz}")

    @property
    def nmodes(self) -> int:
        return len(self.dims)


FROSTT_TENSORS: dict[str, FrosttTensor] = {
    t.name: t
    for t in [
        # name, dims (Table II), nnz, density, skew
        FrosttTensor("NELL-1", (2_900_000, 2_100_000, 25_500_000), 143_600_000, 9.1e-13, 0.55),
        FrosttTensor("NELL-2", (12_100, 9_200, 28_800), 76_900_000, 2.4e-5, 0.85),
        FrosttTensor("PATENTS", (46, 239_200, 239_200), 3_600_000_000, 1.4e-3, 0.95),
        FrosttTensor("LBNL", (1_600, 4_200, 1_600, 4_200, 868_100), 1_700_000, 4.2e-14, 0.75),
        FrosttTensor("DELICIOUS", (532_900, 17_300_000, 2_500_000, 1_400), 140_100_000, 4.3e-15, 0.55),
        FrosttTensor("AMAZON", (4_800_000, 1_800_000, 1_800_000), 1_700_000_000, 1.1e-10, 0.70),
        FrosttTensor("REDDIT", (8_200_000, 177_000, 8_100_000), 4_700_000_000, 4.0e-10, 0.75),
    ]
}
