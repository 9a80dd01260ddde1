"""Worker process of the experiment engine's sharded measurements.

The counterpart of ``repro.experiments.worker``.  ``python -m
repro_torch.experiments.worker`` reads a JSON payload on stdin (``name``,
``scale`` and ``seed`` identify the tensor; ``devices`` is the number of
shards), re-materializes the tensor and re-applies ``prepare_execution``
for the payload's ordering, starts one rank per shard
(``repro_torch.distributed.spawn``, on ``device`` with the backend rule
``backend_for``, printed on stderr), runs ``measure_cp_als(impl=
"sharded")`` in every rank and prints rank 0's ``MeasuredRun`` as one
JSON line on stdout.  It exits 2 when it cannot place the ranks it was
asked for.
"""

from __future__ import annotations

import json
import sys

import torch

from repro_torch.data.synthetic_tensors import make_frostt_like
from repro_torch.distributed.spawn import backend_for, rank_device, spawn
from repro_torch.experiments.measure import measure_cp_als
from repro_torch.reorder import prepare_execution


def _measure_rank(tensor, payload: dict) -> dict:
    run = measure_cp_als(
        tensor,
        name=payload["tensor_name"],
        rank=payload["rank"],
        n_iters=payload["n_iters"],
        impl="sharded",
        seed=payload["seed"],
        scheme=payload.get("scheme", "mode_ordered"),
        ordering=payload.get("ordering"),
        cost_analysis=bool(payload.get("cost_analysis", True)),
        fused=bool(payload.get("fused", False)),
        fit_every=int(payload.get("fit_every", 1)),
        device=rank_device(payload["device"]),
    )
    return run.to_dict()


def main() -> int:
    payload = json.loads(sys.stdin.read())
    shards = int(payload.get("devices", 8))
    device = payload.get("device", "cuda")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"worker: {shards} ranks asked for on {device!r}, but "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    backend = backend_for(device, shards)
    print(f"worker: {shards} ranks on {device}, backend {backend} (gloo on the CPU or a "
          "shared card, NCCL with a card per rank)", file=sys.stderr)
    tensor = make_frostt_like(payload["name"], scale=payload["scale"], seed=payload["seed"])
    # The engine-side degree relabeling, again: a pure function of the tensor.
    tensor, _ = prepare_execution(tensor, payload.get("ordering"))
    runs = spawn(_measure_rank, shards, device=device, backend=backend, args=(tensor, payload))
    print(json.dumps(runs[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
