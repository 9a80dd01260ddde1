"""Batched serving loop: continuous batching over a decode step (port of
``repro.runtime.serve_loop``).

Requests (prompt token lists) are admitted into a fixed set of slots; each
engine tick decodes one token for every active slot; finished sequences
(eos or ``max_len``) free their slot for the next queued request.  The
decode state is ``models.transformer.init_decode_state``'s, its caches
float32 as in JAX, updated in place on ``device``.  Each tick reads the
batch's argmax back to the host, as JAX's does, so the host waits for the
device once a tick.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.model_zoo import init_decode_state, make_decode_fn

__all__ = ["ServeConfig", "BatchServer"]

# Decode-state entries that carry a sequence's history, (layers, slots, ...).
RECURRENT_STATES = ("wkv", "x_prev_t", "x_prev_c", "h", "conv_buf")


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 4
    max_len: int = 64
    eos_id: int = 1


class BatchServer:
    """Continuous-batching server of one model of any family on ``device``
    (default the GPU; raises without one)."""

    def __init__(self, cfg, model, serve_cfg: ServeConfig, *,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self.model = model
        self.sc = serve_cfg
        self.device = resolve_device(device)
        self.decode = make_decode_fn(cfg, device=self.device)
        self.state = init_decode_state(cfg, serve_cfg.max_slots, serve_cfg.max_len,
                                       cache_dtype=torch.float32, device=self.device)
        self.queue: deque = deque()
        self.slots: list[dict | None] = [None] * serve_cfg.max_slots
        self.completed: list[dict] = []

    # --- request admission ---------------------------------------------
    def submit(self, request_id: str, prompt: Sequence[int]):
        """Queue a request.  A prompt must hold 1 to ``max_len`` tokens: the
        cache has ``max_len`` positions (JAX drops the writes past them
        silently; an empty prompt has no first token to feed)."""
        if not 1 <= len(prompt) <= self.sc.max_len:
            raise ValueError(
                f"{request_id}: a prompt of {len(prompt)} tokens; the server takes 1 to "
                f"max_len={self.sc.max_len}"
            )
        self.queue.append({"id": request_id, "prompt": list(prompt)})

    def _admit(self):
        for i in range(self.sc.max_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = {
                    "id": req["id"],
                    "prompt": req["prompt"],
                    "pos": 0,
                    "generated": [],
                }
                self._reset_slot(i)

    def _reset_slot(self, i: int):
        """A reused slot restarts at position 0 and its recurrent states
        (RWKV's ``wkv``, ``x_prev_t``, ``x_prev_c``; the hybrid's ``h`` and
        ``conv_buf``) are zeroed along the slot axis, as JAX's are.  Its KV
        cache entries are overwritten as the new sequence advances and masked
        by the per-sequence position until then, so they need no clearing."""
        self.state["pos"][i] = 0
        for key in RECURRENT_STATES:
            if key in self.state:
                self.state[key][:, i] = 0

    # --- engine tick ------------------------------------------------------
    def tick(self):
        """Feed one token per active slot (prompt token or generated)."""
        self._admit()
        if not any(self.slots):
            return False
        tokens = np.zeros((self.sc.max_slots,), np.int32)
        idle = [i for i, slot in enumerate(self.slots) if slot is None]
        if idle:
            # An idle slot decodes too (token 0, its output unread) and its
            # position advances each tick.  JAX drops the cache writes that
            # pass max_len; an index write here would raise, so an idle
            # slot is held at position 0, a row its next request rewrites.
            self.state["pos"][idle] = 0
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot["pos"] < len(slot["prompt"]):
                tokens[i] = slot["prompt"][slot["pos"]]
            else:
                tokens[i] = slot["generated"][-1]
        logits, self.state = self.decode(self.model, tokens, self.state)
        nxt = logits.argmax(-1).cpu().numpy()
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot["pos"] += 1
            if slot["pos"] >= len(slot["prompt"]):
                tok = int(nxt[i])
                slot["generated"].append(tok)
                done = tok == self.sc.eos_id or (
                    slot["pos"] + len(slot["generated"]) >= self.sc.max_len
                ) or len(slot["generated"]) >= self.sc.max_len - len(slot["prompt"])
                if done:
                    self.completed.append(
                        {"id": slot["id"], "tokens": slot["generated"]}
                    )
                    self.slots[i] = None
        return True

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (any(self.slots) or self.queue) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.completed
