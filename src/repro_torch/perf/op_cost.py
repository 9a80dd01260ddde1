"""The cost of one call of a step, counted from the ATen ops it dispatches
(port of ``repro.perf.hlo_cost``).

JAX's module walks XLA's optimised HLO and multiplies each ``while``
body by its trip count.  The port runs eagerly and has no HLO; what it
has is the stream of ATen ops a step dispatches, which ``OpCounter``, a
``TorchDispatchMode``, reads.  Run on ``meta`` tensors (shapes without
storage) the step costs nothing, so a production cell can be counted on
any host; run on the card, the same mode reads the same ops.

Conventions:

* **flops.** Ops with a formula in ``torch.utils.flop_counter``'s registry
  take it: the matrix products (2 flops a multiply-add), and the port's
  hand-written kernels, registered as custom ops with their own formulas
  (``kernels/flash_attention/kernel.py``, ``kernels/recurrence/kernel.py``).
  The rest as JAX's ``hlo_cost`` counts them: a pointwise op one flop per
  result element; a reduction, scan or sort its operand bytes / 4; a
  softmax as JAX lowers it, two reductions and three pointwise ops over its
  input.  Views, copies, gathers and allocation cost no flops.
* **bytes.** Each op's input bytes plus its output bytes: every op of an
  eager step reads its operands from HBM and writes its result there,
  since nothing is fused.  That is why the port's bytes are larger than
  JAX's, whose fusions keep their intermediates on chip.  Views and
  allocations move nothing; an in-place copy or fill does not read the
  tensor it overwrites.
* **peak live bytes.** Every storage the step touches or makes is held
  from its first sight until it is freed (a weak reference to the storage
  says when), so autograd's saved tensors, remat's recompute and each
  microbatch's freed graph all shape the peak.  ``hold`` enters the
  step's arguments before it starts.
* **the trip-count analogue.** ``repeat(n)`` multiplies everything counted
  inside it by n: the dry run counts one microbatch of a train step under
  ``repeat(num_microbatches)``, where XLA's HLO has a loop of that trip
  count.  The peak is not multiplied: microbatches run one after another.

The collectives are not ATen ops of a rank's step on ``meta``: the dry run
adds the calls that step records (``add_collectives``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.perf.coll_stats import ring_bytes

__all__ = ["OpCost", "OpCounter"]

aten = torch.ops.aten

_ALLOC = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
          aten.new_empty_strided}
# ops that return an alias (or a fresh header over the same data) without
# declaring it in their schema
_ALIAS = {aten._unsafe_view, aten.lift_fresh, aten.detach, aten.alias,
          aten._reshape_alias, aten.set_}
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}  # the destination is not read
_SCAN_SORT = {aten.cumsum, aten.cumprod, aten.sort, aten.topk, aten.argsort}
_SOFTMAX = {aten._softmax, aten._log_softmax, aten._softmax_backward_data,
            aten._log_softmax_backward_data}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class OpCost:
    """A rank's counts for one step."""

    flops: float = 0.0
    matmul_flops: float = 0.0  # the matrix products (flop_counter's registry, aten ops)
    kernel_flops: float = 0.0  # the hand-written kernels' registered formulas
    bytes: float = 0.0
    peak_bytes: float = 0.0
    op_counts: Counter = dataclasses.field(default_factory=Counter)  # by op class
    coll_counts: Counter = dataclasses.field(default_factory=Counter)
    coll_bytes: Counter = dataclasses.field(default_factory=Counter)  # result bytes a kind
    ici_bytes: float = 0.0  # ring bytes a rank

    def add_collectives(self, records) -> None:
        """Add collective records ``{"kind", "result_bytes", "group"}``: their
        counts, result bytes and ring bytes, and to ``bytes`` each call's
        operand and result, as JAX's ``hlo_cost`` counts a collective."""
        for r in records:
            kind, res, n = r["kind"], float(r["result_bytes"]), max(int(r["group"]), 1)
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += res
            self.ici_bytes += ring_bytes(kind, res, n)
            operand = res / n if kind == "all-gather" else res * n if kind == "reduce-scatter" else res
            self.bytes += operand + res


class OpCounter(TorchDispatchMode):
    """Counts every ATen op dispatched inside ``with OpCounter() as c:`` into
    ``c.cost`` (the conventions are the module's)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._mult = 1
        self._held: dict[int, int] = {}  # id(storage) -> bytes, while alive
        self._live = 0

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times (the peak once)."""
        prev = self._mult
        self._mult = prev * int(n)
        try:
            yield self
        finally:
            self._mult = prev

    def hold(self, *trees) -> None:
        """Enter the storages of every tensor in ``trees`` as live."""
        for t in _tensors(trees):
            self._track(t)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    @property
    def live_bytes(self) -> int:
        return self._live

    def _release(self, key: int) -> None:
        self._live -= self._held.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self._live += n
        weakref.finalize(st, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # A composite op reaches the mode whole where autograd is off
            # (``torch.inference_mode``: ``matmul``, ``einsum``); count the
            # ops it decomposes into, as autograd's dispatch would show them.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in ins + outs:
            self._track(t)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
        self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        c, m = self.cost, self._mult
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            kind = "kernel" if func.namespace == "repro_torch" else "matmul"
            c.flops += m * flops
            if kind == "kernel":
                c.kernel_flops += m * flops
            else:
                c.matmul_flops += m * flops
        elif func.is_view or packet in _ALIAS:
            c.op_counts["view"] += m
            return
        elif packet in _ALLOC:
            c.op_counts["alloc"] += m
            return
        elif packet in _SOFTMAX:
            kind = "reduction"
            c.flops += m * (2 * sum(_nbytes(t) for t in ins[:1]) / 4.0
                            + 3 * sum(t.numel() for t in ins[:1]))
        elif torch.Tag.reduction in func.tags or packet in _SCAN_SORT:
            kind = "reduction"
            c.flops += m * sum(_nbytes(t) for t in ins) / 4.0
        elif torch.Tag.pointwise in func.tags:
            kind = "elementwise"
            c.flops += m * sum(t.numel() for t in outs)
        else:
            kind = "movement"
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if packet in _OVERWRITE and ins:
            nbytes -= _nbytes(ins[0])
        c.bytes += m * nbytes
        c.op_counts[kind] += m
