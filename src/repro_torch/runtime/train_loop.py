"""Fault-tolerant training loop (port of ``repro.runtime.train_loop``).

The model zoo's train step, AdamW, the checkpoint manager and the
deterministic data stream, with JAX's failure handling:

  * resume from the latest checkpoint on start;
  * periodic checkpoints with atomic publish;
  * step-scoped retry: a failed step (an exception, an injected fault, a
    non-finite loss) is replayed from the live state; repeated failures
    restore from the last checkpoint and replay from there.

JAX's state is immutable, so a failed step cannot touch it.  The port
updates in place, so its train step raises before the update when the
loss is not finite, and any other failure in the forward or backward
comes before the update too.  The live state a
retry replays from is then the state before the step.

``jit`` is accepted and ignored (the port compiles nothing).  With
``state_shardings`` (``train_state_shardings``' specs) and ``mesh``, run
on every rank of the mesh's group, the state is placed on the mesh
(``shard_state``), a resume restores it there (``restore_latest(
shardings=)``, as JAX's loop does) and each step is
``distributed.sharded_step.sharded_train_step``, the port's counterpart of
JAX's jitted step following its inputs' shardings; the batch is the
stream's global batch on every rank, placed by ``batch_shardings``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.distributed.sharded_step import sharded_train_step
from repro_torch.distributed.sharding import batch_shardings, shard_state
from repro_torch.models.model_zoo import init_model, make_train_step
from repro_torch.optim.adamw import AdamW, init_adamw_state
from repro_torch.runtime.checkpoint import CheckpointManager, latest_step
from repro_torch.runtime.metrics import MetricsLogger

__all__ = ["TrainLoopConfig", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    save_every: int = 50
    keep_checkpoints: int = 3
    lr: float = 3e-4
    num_microbatches: int = 1
    max_step_retries: int = 2
    checkpoint_dir: str = "checkpoints"


def train(
    cfg,  # ModelConfig
    loop: TrainLoopConfig,
    *,
    stream: SyntheticLMStream,
    optimizer: AdamW | None = None,
    init_params_fn: Callable | None = None,
    fault_hook: Callable | None = None,  # (step) -> None, may raise (tests)
    state_shardings=None,
    mesh=None,
    jit: bool = True,
    device="cuda",
) -> dict:
    """Run the loop on ``device`` (default the GPU; raises without one);
    returns ``{"state", "history", "resumed_from"}``.  ``init_params_fn()``
    returns a ``Transformer`` on ``device`` (default ``init_model(cfg,
    seed=0)``).  ``state_shardings`` needs the ``mesh`` they place on."""
    if state_shardings is not None and mesh is None:
        raise ValueError("train(state_shardings=) needs the mesh they place the state on (mesh=)")
    dev = resolve_device(device)
    optimizer = optimizer or AdamW()
    mgr = CheckpointManager(loop.checkpoint_dir, keep=loop.keep_checkpoints,
                            save_every=loop.save_every)
    metrics_log = MetricsLogger()
    if init_params_fn is None:
        init_params_fn = lambda: init_model(cfg, seed=0, device=dev)  # noqa: E731

    state = init_adamw_state(init_params_fn(), lr=loop.lr)
    restore = dict(shardings=state_shardings, mesh=mesh)
    resumed_from = None
    if latest_step(loop.checkpoint_dir) is not None:
        state, meta = mgr.restore_latest(state, **restore)
        stream.skip_to(int(meta.get("stream_step", 0)))
        resumed_from = int(state["step"])
    elif state_shardings is not None:
        state = shard_state(state, state_shardings, mesh)

    if state_shardings is None:
        step_fn = make_train_step(cfg, optimizer, num_microbatches=loop.num_microbatches,
                                  device=dev)
    else:  # the stream's batch shapes place the batch, as JAX's step's inputs do
        shapes = {k: torch.empty((stream.global_batch, stream.seq_len), device="meta")
                  for k in ("tokens", "labels")}
        step_fn = sharded_train_step(cfg, optimizer, mesh, state_shardings,
                                     batch_shardings(shapes, cfg, mesh),
                                     num_microbatches=loop.num_microbatches)

    history = []
    step = int(state["step"])
    while step < loop.total_steps:
        batch = next(stream)
        attempts = 0
        while True:
            try:
                if fault_hook is not None:
                    fault_hook(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                break
            except Exception:
                attempts += 1
                if attempts <= loop.max_step_retries:
                    continue  # transient: replay the step from live state
                # persistent: restore from the last checkpoint and replay
                if latest_step(loop.checkpoint_dir) is None:
                    raise
                state, meta = mgr.restore_latest(state, **restore)
                stream.skip_to(int(meta.get("stream_step", 0)))
                step = int(state["step"])
                batch = next(stream)
                attempts = 0
        step += 1
        if step % loop.log_every == 0 or step == loop.total_steps:
            metrics_log.log(step, loss=loss)
            history.append({"step": step, "loss": loss})
        mgr.maybe_save(step, state, metadata={"stream_step": stream.step})

    return {"state": state, "history": history, "resumed_from": resumed_from}

