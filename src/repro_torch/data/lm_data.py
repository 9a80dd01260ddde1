"""Deterministic synthetic LM token stream (copy of ``repro.data.lm_data``).

Any batch is regenerated from ``(seed, step)`` alone; the draws are the JAX
package's, array for array (numpy only).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMStream"]


@dataclasses.dataclass
class SyntheticLMStream:
    """Zipf-distributed token stream with next-token labels.

    A Markov-ish structure (token depends on previous via a mixing hash)
    gives the model something learnable.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, state: dict, **kwargs) -> "SyntheticLMStream":
        return cls(seed=state["seed"], step=state["step"], **kwargs)

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # zipf-ish marginal
        u = rng.random((b, s + 1))
        base = np.floor((v - 1) * u ** 3.0).astype(np.int32)
        # second-order structure: next token correlated with previous
        mixed = (base[:, 1:] + 7 * base[:, :-1]) % v
        tokens = np.concatenate([base[:, :1], mixed], axis=1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __next__(self) -> dict:
        batch = self._batch_at(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    def skip_to(self, step: int):
        """Jump the cursor (O(1), deterministic)."""
        self.step = step
        return self
