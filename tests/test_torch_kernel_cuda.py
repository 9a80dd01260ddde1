"""The CUDA MTTKRP kernels against their plain PyTorch version, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernel is built with nvcc
on first use); skipped elsewhere.  Imports no JAX, so it runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_cuda.py

Tolerances: 1e-4 for float32 factors, 3e-2 for bfloat16 (the kernels sum
in another order than the plain version).  The edge cases of the split
kernel's partition hold each element within that fraction of the sum of
its terms' absolute values, as ``chip_smoke.compare`` does, and check that
two launches agree bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sparse_tensor import SparseTensor, build_mttkrp_plan, random_sparse_tensor
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp.partition import real_mask, slice_bounds
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _factors(shape, rank, device, *, batch=None, dtype=torch.float32, seed=0, offset=0):
    """Factors from a seed; with ``offset``, each starts ``offset`` elements
    into a buffer of its own, so that its address is not vector-aligned."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    out = []
    for s in shape:
        f = torch.from_numpy(rng.standard_normal(lead + (s, rank)).astype(np.float32))
        buf = torch.empty(f.numel() + offset, dtype=dtype, device=device)
        out.append(buf[offset:].view(f.shape).copy_(f))
    return out


def _compare(t, rank, device, *, tile_nnz=64, rows_per_block=32, batch=None,
             dtype=torch.float32, tol=1e-4, variant=None):
    facs = _factors(t.shape, rank, device, batch=batch, dtype=dtype)
    for mode in range(t.nmodes):
        plan = build_mttkrp_plan(t, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block)
        bufs = tops.plan_device_buffers(plan, device)
        before = dict(tkernel.mttkrp_cuda.launches_by_variant)
        got = tkernel.mttkrp_cuda(bufs, facs, mode, t.shape[mode], variant=variant)
        torch.cuda.synchronize()
        after = tkernel.mttkrp_cuda.launches_by_variant
        assert after[variant or "split"] == before[variant or "split"] + 1
        want = mttkrp_plan_ref(bufs, facs, mode, t.shape[mode])
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


VARIANTS = [None, "block"]  # None: the default, the split kernel


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("rank", [1, 16, 128])
def test_kernel_matches_plain_version(cuda, rank, variant):
    _compare(random_sparse_tensor((70, 33, 41), 2000, seed=3, zipf_a=0.8), rank, cuda,
             variant=variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_edge_geometry(cuda, variant):
    idx = np.array([[0, 0, 0], [1, 1, 1], [250, 2, 2]], np.int32)
    _compare(SparseTensor(idx, np.array([1.0, 2.0, 3.0], np.float32), (300, 4, 4)), 8, cuda,
             rows_per_block=64, variant=variant)
    _compare(SparseTensor(np.array([[5, 2, 7]], np.int32), np.array([2.5], np.float32),
                          (11, 6, 9)), 8, cuda, variant=variant)
    _compare(random_sparse_tensor((40, 30, 20), 5, seed=13), 16, cuda, tile_nnz=256,
             variant=variant)
    _compare(random_sparse_tensor((20, 15, 10, 8), 300, seed=4), 8, cuda, variant=variant)
    _compare(random_sparse_tensor((9, 8, 7, 6, 5), 300, seed=5), 8, cuda, variant=variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_bf16_and_batched(cuda, variant):
    t = random_sparse_tensor((60, 50, 40), 3000, seed=6, zipf_a=0.9)
    _compare(t, 16, cuda, dtype=torch.bfloat16, tol=3e-2, variant=variant)
    _compare(t, 16, cuda, batch=4, variant=variant)


# -- the split kernel's partition ---------------------------------------------

def _hot_row(rng):
    """200K nonzeros on row 0 among 10K elsewhere: row 0 spans many slices."""
    rows = np.concatenate([np.zeros(200_000, np.int64), rng.integers(1, 500, 10_000)])
    idx = np.stack([rows, rng.integers(0, 300, rows.size), rng.integers(0, 400, rows.size)], 1)
    return SparseTensor(idx.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32),
                        (500, 300, 400))


def _padding_heavy(rng):
    """One nonzero per block of 16 rows, 255 padding entries after each:
    most slice boundaries fall inside a block's padding."""
    rows = np.arange(0, 32_000, 16) + rng.integers(0, 16, 2000)
    idx = np.stack([rows, rng.integers(0, 50, 2000), rng.integers(0, 60, 2000)], 1)
    return SparseTensor(idx.astype(np.int32), rng.standard_normal(2000).astype(np.float32),
                        (32_000, 50, 60))


def _sparse_rows(rng):
    """Every 50th row holds 100 nonzeros: runs of empty rows between slices."""
    rows = np.repeat(np.arange(0, 100_000, 50), 100)
    idx = np.stack([rows, rng.integers(0, 70, rows.size), rng.integers(0, 90, rows.size)], 1)
    return SparseTensor(idx.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32),
                        (100_000, 70, 90))


def _few(rng):
    """Fewer nonzeros than slices."""
    idx = np.stack([rng.integers(0, 400, 50), rng.integers(0, 30, 50), rng.integers(0, 20, 50)], 1)
    return SparseTensor(idx.astype(np.int32), rng.standard_normal(50).astype(np.float32),
                        (400, 30, 20))


def _moderate(rng):
    return random_sparse_tensor((300, 200, 250), 60_000, seed=2, zipf_a=0.8)


# name -> (tensor maker, rank, tile_nnz, rows_per_block, batch, dtype)
SPLIT_CASES = {
    "hot row": (_hot_row, 16, 256, 256, None, torch.float32),
    "slice boundary in padding": (_padding_heavy, 16, 256, 16, None, torch.float32),
    "empty rows between slices": (_sparse_rows, 16, 128, 64, None, torch.float32),
    "fewer nonzeros than slices": (_few, 16, 32, 16, None, torch.float32),
    "one nonzero": (lambda rng: SparseTensor(np.array([[5, 2, 7]], np.int32),
                                             np.array([2.5], np.float32), (11, 6, 9)),
                    16, 256, 64, None, torch.float32),
    "rank 1": (_moderate, 1, 256, 256, None, torch.float32),
    "rank 13": (_moderate, 13, 128, 32, None, torch.float32),
    "rank 16": (_moderate, 16, 256, 256, None, torch.float32),
    "rank 128": (_moderate, 128, 256, 256, None, torch.float32),
    "4 modes": (lambda rng: random_sparse_tensor((60, 50, 40, 30), 20_000, seed=4, zipf_a=0.7),
                16, 128, 32, None, torch.float32),
    "5 modes": (lambda rng: random_sparse_tensor((20, 18, 16, 14, 12), 20_000, seed=5),
                8, 128, 32, None, torch.float32),
    "bf16 factors": (_moderate, 16, 256, 256, None, torch.bfloat16),
    "B=4": (_moderate, 16, 256, 256, 4, torch.float32),
    "B=5": (_moderate, 16, 64, 16, 5, torch.float32),
}


def _terms_compare(bufs, facs, mode, i_out, got, tol):
    """max |got - want| / (the MTTKRP of |values| and |factors|), elementwise."""
    want = mttkrp_plan_ref(bufs, facs, mode, i_out)
    scale = mttkrp_plan_ref(bufs._replace(values=bufs.values.abs()), [f.abs() for f in facs],
                            mode, i_out)
    return bool(((got - want).abs() <= tol * scale).all())


def _premise(name, t, plan, slices):
    """Each case's partition really has the edge it is named for (mode 0)."""
    bufs = tops.plan_device_buffers(plan, "cpu")
    bounds = slice_bounds(int(bufs.values.shape[0]), slices)[1:-1]
    real = real_mask(bufs)
    if name == "hot row":
        assert (bufs.indices[:, 0] == 0).sum().item() > 4 * bufs.values.shape[0] / slices
    elif name == "slice boundary in padding":
        assert (~real[torch.from_numpy(bounds)]).any()
    elif name == "empty rows between slices":
        pos = torch.nonzero(real).flatten()
        rows = bufs.indices[:, 0][pos]
        at = torch.searchsorted(pos, torch.from_numpy(bounds))
        inside = (at > 0) & (at < pos.numel())
        gap = rows[at[inside]] - rows[at[inside] - 1]
        assert (gap > 1).any()
    elif name == "fewer nonzeros than slices":
        assert t.nnz < slices


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_kernel_partition_edges(cuda, name):
    make, rank, tile_nnz, rows_per_block, batch, dtype = SPLIT_CASES[name]
    t = make(np.random.default_rng(8))
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    facs = _factors(t.shape, rank, cuda, batch=batch, dtype=dtype, seed=t.nnz)
    slices = tkernel.split_slices(t.nmodes, batch or 1, dtype, cuda)
    for mode in range(t.nmodes):
        plan = build_mttkrp_plan(t, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block)
        bufs = tops.plan_device_buffers(plan, cuda)
        if mode == 0:
            _premise(name, t, plan, slices)
        before = tkernel.mttkrp_cuda.launches_by_variant["split"]
        got = tkernel.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
        again = tkernel.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
        torch.cuda.synchronize()
        assert tkernel.mttkrp_cuda.launches_by_variant["split"] == before + 2
        assert got.shape == (() if batch is None else (batch,)) + (t.shape[mode], rank)
        assert _terms_compare(bufs, facs, mode, t.shape[mode], got, tol), f"mode {mode}"
        assert torch.equal(got, again), f"mode {mode}: two launches differ"


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = random_sparse_tensor((30, 20, 10), 200, seed=7)
    bufs = tops.plan_device_buffers(build_mttkrp_plan(t, 0, tile_nnz=32, rows_per_block=16), cuda)
    facs = _factors(t.shape, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.mttkrp_cuda(bufs, [facs[0], facs[1], facs[2].t().contiguous().t()], 0, 30)
    with pytest.raises(TypeError):
        tkernel.mttkrp_cuda(bufs, [f.double() for f in facs], 0, 30)
    with pytest.raises(ValueError, match="rows"):
        tkernel.mttkrp_cuda(bufs, [facs[0], facs[1][:5].contiguous(), facs[2]], 0, 30)
    with pytest.raises(ValueError, match="variant"):
        tkernel.mttkrp_cuda(bufs, facs, 0, 30, variant="atomic")


# -- the orderings, and the split kernel's tile mode --------------------------

ORDERINGS = ("lex", "secondary-sort", "degree", "blocked")


def _ordered_check(t, rank, device, ordering, *, tile_nnz, rows_per_block, batch, dtype,
                   split_mode=None, offset=0):
    """Each mode's plan in ``ordering`` through the split kernel (in the mode
    the plan picks, or ``split_mode``) against the plain version, and a
    bit-for-bit repeat; returns the modes the launches took."""
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    facs = _factors(t.shape, rank, device, batch=batch, dtype=dtype, seed=t.nnz, offset=offset)
    taken = []
    for mode in range(t.nmodes):
        plan = build_mttkrp_plan(t, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block,
                                 ordering=ordering, device=device)
        bufs = tops.plan_device_buffers(plan, device)
        before = dict(tkernel.mttkrp_cuda.launches_by_mode)
        got = tkernel.mttkrp_cuda(bufs, facs, mode, t.shape[mode], split_mode=split_mode)
        again = tkernel.mttkrp_cuda(bufs, facs, mode, t.shape[mode], split_mode=split_mode)
        torch.cuda.synchronize()
        after = tkernel.mttkrp_cuda.launches_by_mode
        taken += [m for m in after if after[m] == before[m] + 2]
        assert _terms_compare(bufs, facs, mode, t.shape[mode], got, tol), (ordering, mode)
        assert torch.equal(got, again), f"{ordering} mode {mode}: two launches differ"
    return taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [None, 4], ids=["B1", "B4"])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_every_ordering_through_the_split_kernel(cuda, ordering, batch, dtype):
    t = random_sparse_tensor((600, 500, 700), 60_000, seed=1, zipf_a=0.8)
    taken = _ordered_check(t, 16, cuda, ordering, tile_nnz=32, rows_per_block=64, batch=batch,
                           dtype=dtype)
    assert taken == ["tiles" if ordering == "blocked" else "rows"] * 3
    # The tile mode takes every plan; the contiguous ones too.
    if ordering != "blocked":
        assert _ordered_check(t, 16, cuda, ordering, tile_nnz=32, rows_per_block=64,
                              batch=batch, dtype=dtype, split_mode="tiles") == ["tiles"] * 3


def _tile_edges(rng):
    """Block 0 shared by many slices, empty blocks, a block of mostly
    padding (tests/test_torch_reorder.py's partition edges, scaled up)."""
    rows = np.concatenate([rng.integers(0, 16, 300_000), rng.integers(64, 80, 400),
                           rng.integers(160, 176, 5)])
    idx = np.stack([rows, rng.integers(0, 300, rows.size), rng.integers(0, 200, rows.size)], 1)
    return SparseTensor(idx.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32),
                        (200, 300, 200))


# name -> (tensor maker, rank, tile_nnz, rows_per_block, factor offset in elements)
TILE_CASES = {
    "block shared by many slices, empty blocks": (_tile_edges, 16, 8, 16, 0),
    "slice boundary in padding": (_padding_heavy, 16, 256, 16, 0),
    "hot row": (_hot_row, 16, 256, 256, 0),
    "fewer nonzeros than slices": (_few, 16, 32, 16, 0),
    "rank 13": (_moderate, 13, 128, 32, 0),
    "rank 40": (_moderate, 40, 64, 512, 0),
    "4 modes": (lambda rng: random_sparse_tensor((60, 50, 40, 30), 20_000, seed=4, zipf_a=0.7),
                16, 128, 32, 0),
    "rank 20 (a ragged column pass)": (_moderate, 20, 128, 32, 0),
    "rank 8 (one column part)": (_moderate, 8, 128, 32, 0),
    "unaligned factors (scalar loads)": (_moderate, 16, 128, 32, 1),
    "rows_per_block 1024 (3 restarts a pass)": (_moderate, 16, 128, 1024, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [None, 3, 4, 5], ids=["B1", "B3", "B4", "B5"])
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tile_mode_partition_edges(cuda, name, batch, dtype):
    make, rank, tile_nnz, rows_per_block, offset = TILE_CASES[name]
    t = make(np.random.default_rng(8))
    grid = tkernel.tile_grid(t.nmodes, rows_per_block, dtype, cuda, batch=batch or 1)
    if name.startswith("block shared"):  # the premise, on mode 0's blocked plan
        plan = build_mttkrp_plan(t, 0, tile_nnz=tile_nnz, rows_per_block=rows_per_block,
                                 ordering="blocked", device=cuda)
        start = tops.block_nnz_start(plan)
        bounds = slice_bounds(plan.nnz_pad, grid.ctas)  # one slice per CTA
        blk = np.searchsorted(start, bounds[:-1], side="right") - 1
        assert np.bincount(blk).max() > 2
        assert (tops.block_real_end(plan) == start[:-1]).any()
    if name.startswith("rows_per_block 1024") and (batch or 1) > 3:
        assert grid.b_pass == 3
    taken = _ordered_check(t, rank, cuda, "blocked", tile_nnz=tile_nnz,
                           rows_per_block=rows_per_block, batch=batch, dtype=dtype,
                           offset=offset)
    assert set(taken) == {"tiles"}


def test_tile_grid_on_the_card(cuda):
    """Two warps per restart of a pass, as many restarts as fit (at most 4),
    a tile of rows_per_block x 16 float32 per restart beside a staging ring
    of 4 x 64 entries of 3 indices and a value and its 8 barriers, at least
    as many CTAs as SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ring = 4 * 64 * 4 * 4 + 8 * 8
    for batch, rpb, b_pass in [(1, 256, 1), (4, 256, 4), (3, 256, 3), (5, 256, 4),
                               (4, 1024, 3)]:
        grid = tkernel.tile_grid(3, rpb, torch.float32, cuda, batch=batch)
        assert (grid.warps, grid.b_pass) == (2 * b_pass, b_pass), (batch, rpb)
        assert grid.smem_bytes == b_pass * rpb * 16 * 4 + ring, (batch, rpb)
        assert grid.ctas >= sms and grid.ctas % sms == 0
        assert grid.warps_per_sm == grid.ctas // sms * grid.warps


def test_row_run_mode_refuses_a_blocked_plan_on_the_card(cuda):
    t = random_sparse_tensor((600, 500, 700), 40_000, seed=1, zipf_a=0.8)
    plan = build_mttkrp_plan(t, 0, tile_nnz=32, rows_per_block=64, ordering="blocked",
                             device=cuda)
    bufs = tops.plan_device_buffers(plan, cuda)
    facs = _factors(t.shape, 16, cuda)
    with pytest.raises(ValueError, match="row-run mode"):
        tkernel.mttkrp_cuda(bufs, facs, 0, 600, split_mode="rows")
    with pytest.raises(ValueError, match="shared memory"):
        tkernel.tile_grid(3, 4096, torch.float32, cuda)
    # The tile mode's bulk copies need 16-byte aligned stream buffers.
    n = bufs.values.numel()
    shifted = torch.empty(n + 1, dtype=torch.float32, device=cuda)[1:].copy_(bufs.values)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tkernel.mttkrp_cuda(bufs._replace(values=shifted), facs, 0, 600)
