"""``perf.op_cost`` and the kernels' custom ops, against JAX's HLO and the
card check's formulas.

* The flash kernel's custom op registers the flops the causal mask leaves:
  8.796e12 a layer at B = 2, S = 32768, H = 16, D = 128 (``PERF.md`` §6,
  ``flash_attention_sm90.cu``'s notes), and a non-causal call with a key
  length of its own counts its S x S_kv pairs.  The scans' ops register
  the counts behind ``chip_smoke.py``'s bounds, exactly.
* A reduced dense config's forward: the matrix-product flops the counter
  reads on the CPU are within 1% of the dot flops of JAX's compiled HLO of
  its jitted forward, summed with ``repro.perf.hlo_cost``'s own parser over
  ``dot`` instructions, trip counts applied.  Both sides take the dense
  attention at S = 64 (below the blocked path's 2048), so nothing is held
  by a closed form.
* Counting one microbatch ``n`` times equals counting ``n``.
* ``meta`` tensors reach the custom ops (shapes, no launch); CPU tensors
  run the plain versions; the peak follows tensor lifetimes.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
import repro.perf.hlo_cost as H
from repro.configs import registry as jreg
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.recurrence import kernel as rk
from repro_torch.kernels.recurrence import ops as rops
from repro_torch.launch import dryrun
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.perf.op_cost import OpCounter
from repro_torch.tree import param_tree, tree_map

MATMUL_REL_TOL = 0.01  # the port's matmul flops against JAX's HLO dot flops


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _flops(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return fc.get_total_flops()


@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_op_counts_the_causal_triangle_at_the_prefill_shape(return_lse):
    q, k = _meta(2, 32768, 16, 128), _meta(2, 32768, 8, 128)
    got = _flops(flash_attention, q, k, k, causal=True, return_lse=return_lse)
    assert got == 8_796_361_457_664  # 4 * 128 * S(S+1)/2 * 2 * 16, exact
    assert got == chip_smoke.attention_flops(2, 32768, 16, 128, True)
    assert f"{got:.4g}" == "8.796e+12"


def test_flash_op_counts_a_cross_attention_with_its_own_key_length():
    q, k = _meta(2, 448, 8, 64), _meta(2, 32768, 8, 64)
    got = _flops(flash_attention, q, k, k, causal=False)
    assert got == 4 * 64 * 448 * 32768 * 2 * 8
    assert got == fk.attention_flops(2, 448, 8, 64, False, 32768)
    # the encoder's non-causal self-attention: every pair
    q = _meta(2, 4096, 8, 64)
    assert _flops(flash_attention, q, q, q, causal=False) == 4 * 64 * 4096 * 4096 * 2 * 8


def test_flash_op_on_meta_gives_shapes_and_checks_its_inputs():
    q, k = _meta(2, 100, 4, 64), _meta(2, 100, 2, 64)
    out, lse = flash_attention(q, k, k, causal=True, return_lse=True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 100, 4, 64)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 4, 100)
    with pytest.raises(ValueError, match="as many keys as queries"):
        flash_attention(q, _meta(2, 99, 2, 64), _meta(2, 99, 2, 64), causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(_meta(1, 8, 2, 48), _meta(1, 8, 2, 48), _meta(1, 8, 2, 48))
    with pytest.raises(ValueError, match=r"needs CUDA \(or meta\) tensors, got q on cpu"):
        fk.flash_attention_cuda(torch.zeros(1, 8, 2, 64), _meta(1, 8, 2, 64), _meta(1, 8, 2, 64))
    with pytest.raises(ValueError, match="tensors, got k on cpu"):
        fk.flash_attention_cuda(_meta(1, 8, 2, 64), torch.zeros(1, 8, 2, 64), _meta(1, 8, 2, 64))


@pytest.mark.parametrize("kind,b,s,h", [("wkv6", 2, 4096, 40), ("wkv6", 2, 32768, 40),
                                        ("ssd", 2, 4096, 64), ("ssd", 3, 1000, 5),
                                        ("ssd", 1, 1, 1)])
def test_scan_ops_count_the_card_checks_formulas(kind, b, s, h):
    fwd = (chip_smoke.SCAN_MMA_PER_CHUNK[kind] * chip_smoke.MMA_TF32_FLOPS * b * h
           * -(-s // chip_smoke.SCAN_CHUNK))
    bwd = sum(chip_smoke.bwd_min_flops(kind, b, s, h))
    assert rk.scan_flops(kind, b, s, h) == fwd
    assert sum(rk.scan_bwd_flops(kind, b, s, h)) == bwd
    f32 = torch.float32
    if kind == "wkv6":
        args = [_meta(b, s, h, 64, dtype=f32, grad=True) for _ in range(4)]
        args.append(_meta(h, 64, dtype=f32, grad=True))
        fn = rops.wkv6_scan_logw
    else:
        args = [_meta(b, s, h, dtype=f32, grad=True), _meta(b, s, h, 64, dtype=f32, grad=True),
                _meta(b, s, 64, dtype=f32, grad=True), _meta(b, s, 64, dtype=f32, grad=True)]
        fn = rops.ssd_scan_logdec
    with torch.no_grad():
        assert _flops(fn, *args) == fwd

    def step():
        fn(*args).sum().backward()

    with OpCounter() as c:
        step()
    assert c.cost.kernel_flops == fwd + bwd
    assert c.cost.op_counts["kernel"] == 2
    for a in args:
        assert a.grad is not None and a.grad.shape == a.shape and a.grad.device.type == "meta"


def test_cpu_tensors_run_the_plain_versions_and_reach_no_custom_op():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 40, 2, 32, generator=g)
    with OpCounter() as c:
        flash_attention(q, q, q, causal=True)
        r = torch.randn(1, 5, 1, 64, generator=g)
        rops.wkv6_scan_logw(r, r, r, -torch.rand(1, 5, 1, 64, generator=g),
                            torch.randn(1, 64, generator=g))
    assert c.cost.kernel_flops == 0 and c.cost.op_counts["kernel"] == 0
    assert c.cost.matmul_flops > 0


def _jax_dot_flops(hlo: str) -> float:
    """Dot flops of a compiled HLO module, each computation's dots times the
    trip counts of the loops that reach it (``repro.perf.hlo_cost``'s parser)."""
    comps = H._parse_computations(hlo)
    entry = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.M).group(1)
    memo: dict[str, float] = {}

    def dots(name: str) -> float:
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        instrs = comps.get(name, [])
        shapes = {i.name: i.shape_str for i in instrs}
        total = 0.0
        for i in instrs:
            called = H._called_comps(i.rest)
            if i.op == "while":
                tm = H._TRIP_RE.search(i.rest)
                trips = int(tm.group(1)) if tm else 1
                total += trips * sum(dots(called[k]) for k in ("body", "condition") if k in called)
            elif i.op in ("fusion", "call", "conditional"):
                total += sum(dots(c) for c in called.values())
            elif i.op == "dot":
                elems, _ = H._shape_elems_bytes(i.shape_str)
                contract = 1
                cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", i.rest)
                lhs = shapes[i.operand_names()[0]]
                dims = [int(d) for d in H._SHAPE_RE.search(lhs).group(2).split(",") if d]
                for idx in cm.group(1).split(","):
                    if idx.strip():
                        contract *= dims[int(idx)]
                total += 2.0 * elems * contract
        memo[name] = total
        return total

    return dots(entry)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-20b", "granite-moe-1b-a400m"])
def test_forward_matmul_flops_match_jax_hlo_dots(arch):
    b, s = 2, 64
    jcfg = jreg.reduced_config(arch)
    tcfg = treg.reduced_config(arch)
    params = jtr.init_model(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    hlo = jax.jit(lambda p, t: jtr.forward(p, jcfg, {"tokens": t})).lower(
        params, jnp.asarray(toks)).compile().as_text()
    want = _jax_dot_flops(hlo)
    model = ttr.init_model(tcfg, seed=0, device="cpu")
    toks = torch.from_numpy(toks)
    with torch.no_grad(), OpCounter() as c:
        ttr.forward(model, tcfg, {"tokens": toks})
    got = c.cost.matmul_flops
    assert want > 0
    assert abs(got - want) <= MATMUL_REL_TOL * want, (got, want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_one_microbatch_counted_n_times_equals_counting_n(arch):
    cfg = treg.reduced_config(arch)
    n = 4
    spec = ShapeSpec("x", "train", 32, 8)
    batch = tzoo.input_specs(cfg, spec)
    loss_fn = tzoo.make_loss_fn(cfg)
    params = param_tree(tzoo.init_model(cfg, device="meta"))

    def run(once: bool):
        with OpCounter() as c:
            w = tree_map(lambda p: tzoo.compute_weight(p, cfg).detach().requires_grad_(), params)
            tzoo.microbatch_grads(loss_fn, w, batch, n,
                                  indices=dryrun._counted_once(c, n) if once else None)
        return c.cost

    once, every = run(True), run(False)
    assert once.flops == every.flops and once.matmul_flops == every.matmul_flops
    assert once.bytes == every.bytes
    assert once.op_counts == every.op_counts
    assert once.flops > 0 and once.peak_bytes <= every.peak_bytes


def test_peak_follows_lifetimes_and_repeat_multiplies_counts():
    with OpCounter() as c:
        x = torch.empty(1000, dtype=torch.float32, device="meta")  # 4000 B
        c.hold(x)
        y = x * 2  # +4000: peak 8000
        del y
        with c.repeat(3):
            z = x + 1  # +4000 again, freed y's
        v = z.view(10, 100)  # a view: no bytes, and it keeps z's storage live
        del z
    assert c.cost.peak_bytes == 8000
    assert c.cost.flops == 1000 + 3 * 1000
    assert c.cost.bytes == (4000 + 4000) + 3 * (4000 + 4000)
    assert c.cost.op_counts["elementwise"] == 4 and c.cost.op_counts["view"] == 1
    assert c.live_bytes == 8000 and v.shape == (10, 100)


def _cost(fn, x):
    with OpCounter() as c:
        fn(x)
    return c.cost


def test_reduction_and_softmax_counts_follow_jax_conventions():
    x = torch.empty(4, 256, dtype=torch.float32, device="meta")
    assert _cost(lambda t: t.sum(-1), x).flops == 4 * 256 * 4 / 4.0
    assert _cost(lambda t: torch.softmax(t, -1), x).flops == 2 * (4 * 256 * 4) / 4.0 + 3 * 4 * 256
    # the clone reads and writes; the fill only writes
    assert _cost(lambda t: t.clone().fill_(0.0), x).bytes == 2 * 4096 + 4096
