"""The split MTTKRP kernel's traffic census against the performance model's.

The performance model (``repro_torch.core.hierarchy``) prices one MTTKRP of
one restart from per-nonzero counts (``analytic_traffic_census``): the
value and ``N`` index columns of each nonzero streamed once, ``N - 1``
factor rows gathered for it, and ``I_mode * R`` output elements stored
once.  What the split kernel consumes is counted twice: on the CPU by the
replay of its launches (``kernels/mttkrp/partition.py``), and on the card by
its audit build (``kernel.mttkrp_cuda_audit``).  This module states what
both counts must equal, and reads the audit build's counters.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core.hierarchy import analytic_traffic_census

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.kernel import AuditCounts

__all__ = ["CENSUS_KEYS", "audit_failures", "audit_summary", "census_drift", "model_census"]

#: The consumed counts of one restart, in the model's terms.
CENSUS_KEYS = ("values", "indices", "factor_rows", "output_stores")


def model_census(nmodes: int, nnz: int, i_out: int, rank: int) -> dict[str, int]:
    """What ``analytic_traffic_census(nmodes)`` prices for one restart of an
    MTTKRP over ``nnz`` nonzeros into ``i_out`` rows of ``rank`` columns."""
    per_nnz = analytic_traffic_census(nmodes)
    return {
        "values": per_nnz["values_per_nnz"] * nnz,
        "indices": per_nnz["indices_per_nnz"] * nnz,
        "factor_rows": per_nnz["factor_rows_per_nnz"] * nnz,
        "output_stores": per_nnz["output_rows_amortized"] * i_out * rank,
    }


def census_drift(got: dict[str, int], nmodes: int, nnz: int, i_out: int, rank: int) -> list[str]:
    """One message per count of ``got`` (keys ``CENSUS_KEYS``) that is not
    exactly the model's; empty when the census matches."""
    want = model_census(nmodes, nnz, i_out, rank)
    return [f"{key}: counted {got[key]}, analytic_traffic_census({nmodes}) x {nnz} nonzeros "
            f"requires {want[key]}" for key in CENSUS_KEYS if got[key] != want[key]]


def audit_summary(counts: "AuditCounts", out: torch.Tensor) -> dict:
    """The audit build's counters of one call as host numbers (synchronises)."""
    stores = counts.stores.reshape(-1, *counts.stores.shape[-2:])
    return {
        "store_min": int(stores.min()) if stores.numel() else 1,
        "store_max": int(stores.max()) if stores.numel() else 1,
        "census": [
            {"values": int(v), "indices": int(i), "factor_rows": int(f), "output_stores": int(s)}
            for v, i, f, s in zip(counts.nonzeros.tolist(), counts.index_columns.tolist(),
                                  counts.factor_rows.tolist(), stores.sum(dim=(1, 2)).tolist())
        ],
        "entries_read": int(counts.entries_read),
        "uninit_reads": int(counts.uninit_reads),
        "nan_left": int(torch.isnan(out).sum()),
    }


def audit_failures(summary: dict, nmodes: int, nnz: int, i_out: int, rank: int) -> list[str]:
    """What breaks the kernel contracts in one call's ``audit_summary``:
    an element not stored exactly once, a restart's census off the model's,
    an uninitialised read, a NaN left in the output."""
    failures = []
    if summary["store_min"] != 1 or summary["store_max"] != 1:
        failures.append(f"output elements stored {summary['store_min']}..{summary['store_max']} "
                        "times, not exactly once")
    for b, got in enumerate(summary["census"]):
        failures += [f"restart {b}: {m}" for m in census_drift(got, nmodes, nnz, i_out, rank)]
    if summary["uninit_reads"]:
        failures.append(f"{summary['uninit_reads']} reads of a carry, partial sum or tile row "
                        "never written")
    if summary["nan_left"]:
        failures.append(f"{summary['nan_left']} output elements left NaN")
    return failures
