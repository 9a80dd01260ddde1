"""Collective traffic of a sharded step by call site (port of
``repro.perf.coll_breakdown``).

    PYTHONPATH=src python -m repro_torch.perf.coll_breakdown <arch> <shape> [top_n]

JAX's tool walks the compiled HLO's collectives, trip counts applied.  The
port's collectives are the calls its sharded step makes, and it reads
them in one of two ways:

* ``breakdown(trace_json, top_n)`` reads a ``torch.profiler`` chrome trace
  of a sharded step on a group.  Each collective runs inside a label that
  ``distributed.sharding.collective_label`` writes (kind, mesh axes, group
  size: gloo's own events carry the kind, ``Input Dims`` and ``Input
  type`` but no group size); the backend's event inside it (``gloo:*``,
  ``nccl:*``) gives the input's shape and dtype.  Calls are grouped by
  (kind, input shape, group) and ranked by the ring bytes a rank moves
  (``perf.coll_stats.ring_bytes``).
* the command line prints the same table for a production cell from the
  calls one rank's step records on ``meta`` (``launch.dryrun``'s records).
  The port cannot start the 256 or 512 ranks of a production mesh, so a
  trace of one does not exist; the tests and the card check hold the
  recorded calls to the trace of a small group.
"""

from __future__ import annotations

import json
import math
import re
import sys
from collections import defaultdict
from pathlib import Path

from repro_torch.perf.coll_stats import ring_bytes

__all__ = ["breakdown", "print_table", "records_from_trace", "rows_from_records"]

_LABEL_RE = re.compile(r"^repro_torch\.([a-z\-]+)\[([\w,]*)\|(\d+)\]$")
_BACKENDS = ("gloo:", "nccl:")
# the profiler's names of the dtypes a step's collectives move
_ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "int": 4,
             "long int": 8, "signed char": 1, "unsigned char": 1, "bool": 1}


def records_from_trace(trace) -> list[dict]:
    """One record per labelled collective call in a chrome trace (a path, a
    JSON string or the loaded dict): ``{"kind", "axes", "group", "shape",
    "dtype", "result_bytes"}``; the result of an all-gather is its gathered
    output, of a reduce-scatter its scattered output (its input over the
    group), of the others their input."""
    if isinstance(trace, (str, Path)) and not str(trace).lstrip().startswith("{"):
        trace = Path(trace).read_text()
    if isinstance(trace, str):
        trace = json.loads(trace)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    backend = [e for e in events if e.get("name", "").startswith(_BACKENDS)]
    out = []
    for e in events:
        m = _LABEL_RE.match(e.get("name", ""))
        if not m:
            continue
        kind, axes, group = m.group(1), tuple(a for a in m.group(2).split(",") if a), int(m.group(3))
        t0, t1 = e["ts"], e["ts"] + e.get("dur", 0)
        inner = [b for b in backend if b.get("pid") == e.get("pid") and t0 <= b["ts"] <= t1]
        if len(inner) != 1:
            raise ValueError(f"{e['name']} at {t0}: {len(inner)} backend events inside, not 1")
        args = inner[0].get("args", {})
        shape = tuple(args["Input Dims"][0])
        dtype = args["Input type"][0]
        nbytes = math.prod(shape) * _ITEMSIZE[dtype]
        result = {"all-gather": nbytes * group, "reduce-scatter": nbytes / group}.get(kind, nbytes)
        out.append({"kind": kind, "axes": axes, "group": group, "shape": shape, "dtype": dtype,
                    "result_bytes": float(result)})
    return out


def rows_from_records(records, top_n: int = 12):
    """``(total ring bytes a rank, rows)``: records grouped by (kind, shape,
    group), each row ``(ring bytes, calls, kind, shape, group, axes)``, the
    largest first, the first ``top_n``."""
    groups: dict[tuple, list] = defaultdict(lambda: [0.0, 0, ()])
    for r in records:
        shape = r.get("shape", (r["result_bytes"],))
        key = (r["kind"], tuple(shape), int(r["group"]))
        groups[key][0] += ring_bytes(r["kind"], r["result_bytes"], r["group"])
        groups[key][1] += 1
        groups[key][2] = tuple(r.get("axes", ()))
    rows = [(b, n, kind, shape, group, axes) for (kind, shape, group), (b, n, axes)
            in groups.items()]
    rows.sort(key=lambda row: (row[0], row[1]), reverse=True)
    return sum(row[0] for row in rows), rows[:top_n]


def breakdown(trace_json, top_n: int = 12):
    """The ranked table of a profiled sharded step's collectives."""
    return rows_from_records(records_from_trace(trace_json), top_n)


def print_table(total: float, rows) -> None:
    print(f"total ring bytes a rank: {total/1e9:.3f} GB")
    for b, n, kind, shape, group, axes in rows:
        print(f"{b/1e9:8.3f}GB n={n:5d} grp={group:3d} {kind:16s} "
              f"{str(shape):24s} ({','.join(axes)})")


def main(argv=None) -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun

    argv = sys.argv[1:] if argv is None else argv
    arch, shape = argv[0], argv[1]
    top_n = int(argv[2]) if len(argv) > 2 else 12
    records: list[dict] = []
    dryrun.dryrun_cell(get_config(arch), SHAPES[shape], dryrun.PRODUCTION_MESHES[False],
                       arch=arch, calls=records)
    print(f"{arch} x {shape} x 16x16, the calls one rank's step records on meta")
    print_table(*rows_from_records(records, top_n))


if __name__ == "__main__":
    main()
