"""``perf.coll_stats`` and ``perf.coll_breakdown`` against JAX's
``hlo_stats`` and against a profiled sharded step.

* ``collective_stats(records)`` equals JAX's ``collective_stats`` over HLO
  lines made from the same records: every kind, groups of 1, 2 and 16
  (counts and result bytes exactly, ring bytes to 1e-12 relative);
* on 4 gloo CPU ranks (``tests/torch_coll_ranks.py``, started as
  ``tests/test_torch_distributed_lm.py`` starts its ranks), a reduced
  config's ``sharded_train_step`` under ``torch.profiler``: ``breakdown`` of
  rank 0's trace gives the calls the dry run's rank records for the same
  step on ``meta`` (``launch.dryrun.rank_collectives``), kind by kind, with
  their counts, result bytes, groups and mesh axes (bf16 weights in a (2, 2)
  "2d" mesh with 2 microbatches; float32 under "dp_only").
"""

import math

import pytest

import torch_coll_ranks as ranks
from repro.perf import hlo_stats as jstats
from repro_torch.distributed.spawn import spawn
from repro_torch.perf import coll_breakdown as cb
from repro_torch.perf.coll_stats import KINDS, collective_stats

_DTYPES = {"f32": 4, "bf16": 2}


def _hlo_line(i: int, kind: str, dtype: str, dims: tuple, group: int) -> str:
    shape = f"{dtype}[{','.join(map(str, dims))}]{{{','.join(map(str, range(len(dims))))}}}"
    groups = f", replica_groups=[{16 // group},{group}]<=[16]" if group > 1 else ""
    return f"  %c.{i} = {shape} {kind}({shape} %p.{i}){groups}"


def test_collective_stats_equal_jaxs_on_the_same_calls():
    records, lines = [], []
    i = 0
    for kind in KINDS:
        for group in (1, 2, 16):
            for dtype, dims in (("f32", (4096,)), ("bf16", (16, 2048, 128))):
                i += 1
                nbytes = math.prod(dims) * _DTYPES[dtype]
                records.append({"kind": kind, "result_bytes": nbytes, "group": group})
                lines.append(_hlo_line(i, kind, dtype, dims, group))
    assert [r["group"] for r in jstats.parse_hlo_collectives("\n".join(lines))] == \
        [r["group"] for r in records]
    want = jstats.collective_stats("\n".join(lines))
    got = collective_stats(records)
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.total_result_bytes == want.total_result_bytes
    assert got.ici_bytes_per_chip == pytest.approx(want.ici_bytes_per_chip, rel=1e-12)
    assert got.summary() == want.summary()


def test_rows_rank_calls_by_ring_bytes():
    recs = [{"kind": "all-reduce", "result_bytes": 100.0, "group": 4, "shape": (25,)},
            {"kind": "all-reduce", "result_bytes": 100.0, "group": 4, "shape": (25,)},
            {"kind": "all-gather", "result_bytes": 1000.0, "group": 4, "shape": (250,)},
            {"kind": "all-gather", "result_bytes": 8.0, "group": 1, "shape": (2,)}]
    total, rows = cb.rows_from_records(recs)
    assert [(r[2], r[1]) for r in rows] == [("all-gather", 1), ("all-reduce", 2),
                                           ("all-gather", 1)]
    assert rows[0][0] == 750.0 and rows[1][0] == 300.0 and rows[2][0] == 0.0
    assert total == 1050.0


def _by_kind(records) -> dict:
    out: dict = {}
    for r in records:
        n, b = out.get(r["kind"], (0, 0.0))
        out[r["kind"]] = (n + 1, b + float(r["result_bytes"]))
    return out


def test_profiled_sharded_step_matches_the_closed_form(tmp_path):
    out = spawn(ranks.profiled_steps, 4, device="cpu", backend="gloo", args=(str(tmp_path),))[0]
    assert set(out) == {label for label, *_ in ranks.RUNS}
    for label, got in out.items():
        traced = cb.records_from_trace(got["trace"])
        closed = got["records"]
        assert _by_kind(traced) == _by_kind(closed), label
        key = lambda r: (r["kind"], tuple(r["axes"]), r["group"], r["result_bytes"])  # noqa: E731
        assert sorted(map(key, traced)) == sorted(map(key, closed)), label
        total, rows = cb.breakdown(got["trace"])
        assert total == pytest.approx(collective_stats(closed).ici_bytes_per_chip, rel=1e-12)
        assert sum(r[1] for r in rows) == len(closed)
    dtypes = {r["dtype"] for r in cb.records_from_trace(out["2d-bf16-mb2"]["trace"])}
    assert dtypes == {"c10::BFloat16", "float"}  # bf16 weights, float32 vectors and gradients
