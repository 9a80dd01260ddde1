"""Start the ranks of a sharded run on this host: the port's device mesh.

The counterpart of ``jax.make_mesh`` over the JAX package's forced host
device count: where JAX runs one program over N emulated devices, the port
runs N processes, one per shard, in one ``torch.distributed`` group.
``spawn`` starts them with ``torch.multiprocessing`` and a ``FileStore``
rendezvous in a temporary directory, so no TCP port is chosen and runs in
parallel (pytest workers) cannot collide.

The backend is the caller's choice, and ``backend_for`` is the one rule
the engine and the card check use: gloo on the CPU or when ranks share a
card, NCCL when each rank has a card of its own.  NCCL does not put two
ranks of one communicator on one GPU, so ``spawn`` refuses it when ranks
outnumber cards.  Both backends move CUDA tensors.  Every rank runs on
this host, so gloo talks over the loopback interface unless
``GLOO_SOCKET_IFNAME`` names another.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

__all__ = ["BACKENDS", "SPAWN_TIMEOUT", "backend_for", "rank_device", "spawn"]

BACKENDS = ("gloo", "nccl")
# The ranks' time limit, seconds: ranks that wait on each other's collectives
# (a call one rank skipped, two ranks calling in another order) hang rather
# than fail, so every spawn ends, one way or the other.
SPAWN_TIMEOUT = 1800.0


def backend_for(device: str | torch.device, world_size: int) -> str:
    """The backend rule: gloo on the CPU or on a card shared by ranks,
    NCCL when there is a card for every rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device, rank: int | None = None) -> torch.device:
    """Rank ``rank``'s device (default: this process's rank): the CPU for
    ``device="cpu"``, else ``cuda:{rank % device_count}``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if rank is None:
        rank = dist.get_rank()
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, device: str, backend: str, tmp: str) -> None:
    fn, args = pickle.loads(Path(tmp, "call.pkl").read_bytes())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # The ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable[..., Any],
    n_shards: int,
    *,
    device: str | torch.device,
    backend: str,
    args: Sequence = (),
    timeout: float | None = SPAWN_TIMEOUT,
) -> list[Any]:
    """Run ``fn(*args)`` in ``n_shards`` processes, one rank each, and return
    their results in rank order.

    In each process the default group is initialized (``backend``, world
    size ``n_shards``) and the current CUDA device is ``rank_device(
    device)`` before ``fn`` runs; ``fn`` and ``args`` must pickle, and so
    must its result.  A rank that raises makes ``spawn`` raise with that
    rank's traceback (``torch.multiprocessing.ProcessRaisedException``),
    after the other ranks are stopped.  Ranks still running after
    ``timeout`` seconds (``None``: no limit) are stopped, and ``spawn``
    raises ``TimeoutError``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' needs device='cuda'; the CPU takes gloo")
        if n_shards > torch.cuda.device_count():
            raise ValueError(
                f"backend='nccl' with {n_shards} ranks on {torch.cuda.device_count()} "
                "card(s): NCCL puts at most one rank of a group on a card; ranks that "
                "share a card take backend='gloo' (backend_for)"
            )
    dev = resolve_device(dev)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # The call goes through a file: through the start pipe, arguments past
        # its 64 KB would block the parent until each rank had imported its
        # main module, and the ranks would start one after another.
        Path(tmp, "call.pkl").write_bytes(
            pickle.dumps((fn, tuple(args)), protocol=pickle.HIGHEST_PROTOCOL))
        ctx = mp.start_processes(_rank_main, args=(n_shards, str(dev.type), backend, tmp),
                                 nprocs=n_shards, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=None if deadline is None else 1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
                for proc in ctx.processes:
                    proc.join(10)
                    if proc.is_alive():
                        proc.kill()
                        proc.join()
                raise TimeoutError(f"{n_shards} ranks ran past {timeout} s: a collective that "
                                   "not every rank called hangs rather than fails")
        results = []
        for rank in range(n_shards):
            results.append(pickle.loads(Path(tmp, f"result-{rank}.pkl").read_bytes()))
    return results
