"""Wrappers of the hand-written CUDA recurrence kernels (``csrc/recurrence.cu``
and ``csrc/recurrence_bwd.cu``).

``wkv6_scan_cuda`` and ``ssd_scan_cuda`` each launch one kernel that runs a
whole sequence's recurrence on the card: the WKV-6 state update of RWKV-6
and the Mamba2 state update.  ``wkv6_scan_bwd_cuda`` and
``ssd_scan_bwd_cuda`` launch their backward passes: the gradients of every
input against the output's gradient, the decays' in their log.  They replace
no Pallas kernel: the JAX package runs both recurrences with ``lax.scan``,
one compiled loop on the device, and differentiates it; these are the
port's counterpart of that loop and of its derivative (the sources' notes
say how they work and what bounds them).

The forward kernels are chunked scans whose chunk products run on the
tensor cores in 3xTF32; the backward kernels run 32-step chunks in reverse,
their state and pair products on the tensor cores in 3xTF32, from
chunk-start states that their own first pass writes into a scratch buffer,
each (b, h) on two CTAs that take half of the state's key dimension each.
The halves' shares of the one output that sums over that dimension (WKV-6's
dv; the SSD's ddtx and dlogdec) are summed here, in a fixed order.  All
compute from a zero state.  ``bwd_grid`` gives the backward kernels' launch
geometry on the card (CTAs, CTAs resident on an SM, threads and shared
memory a CTA).

They take CUDA tensors only, float32, with a contiguous last dimension
(any other strides; the forward kernels stage views whose bases or strides
are not on 16 bytes 4 bytes at a time), and check device, dtype and shape,
raising on anything the kernels do not take; there is no fallback.  CPU
tensors go to the plain versions (``ref.py``) one level up, in ``ops``,
where the autograd functions pair each forward with its backward.

``<wrapper>.launches`` counts each kernel's launches in this process;
``reset_launch_counts`` sets all four to 0.

**Custom ops.** Each launch runs inside a ``torch.library.custom_op``
(``repro_torch::wkv6_scan``, ``ssd_scan``, ``wkv6_scan_bwd``,
``ssd_scan_bwd``): the wrapper checks its inputs and calls the op, whose
CUDA implementation allocates the outputs and launches.  Each op also has
a fake implementation that gives the outputs' shapes only (the wrappers
take ``meta`` tensors too and reach it with them, checks and all, where
the plain loops would take minutes at S = 32768), and a flop formula that
``torch.utils.flop_counter`` and ``perf.op_cost`` read: ``scan_flops``, the
forward's 3xTF32 chunk products, and ``scan_bwd_flops``, the backward
function's products and elementwise work, as ``chip_smoke.py`` counts them
for the kernels' bounds.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

__all__ = ["HEAD_DIM", "SSD_STATE", "bwd_grid", "check_ssd_inputs", "check_wkv_inputs",
           "reset_launch_counts", "scan_bwd_flops", "scan_flops",
           "ssd_scan_bwd_cuda", "ssd_scan_cuda", "wkv6_scan_bwd_cuda", "wkv6_scan_cuda"]

HEAD_DIM = 64  # rwkv's WKV head dim; mamba's head dim
SSD_STATE = 64  # the Mamba2 state size the SSD kernel is built for
MAX_BATCH = 65_535  # gridDim.y
CHUNK = 32  # the backward kernels' chunk: one scratch state a chunk


def check_wkv_inputs(r, k, v, w, u) -> None:
    """r, k, v, w (B, S, H, 64) and u (H, 64), all float32."""
    if r.dim() != 4 or r.shape[-1] != HEAD_DIM:
        raise ValueError(f"r must be (B, S, H, {HEAD_DIM}); got {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from r {tuple(r.shape)}")
    if tuple(u.shape) != (r.shape[2], HEAD_DIM):
        raise ValueError(f"u must be (H={r.shape[2]}, {HEAD_DIM}); got {tuple(u.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the scan takes float32")


def check_ssd_inputs(decay, dtx, bm, cm) -> None:
    """decay (B, S, H), dtx (B, S, H, 64), bm and cm (B, S, N), all float32."""
    if dtx.dim() != 4 or dtx.shape[-1] != HEAD_DIM:
        raise ValueError(f"dtx must be (B, S, H, {HEAD_DIM}); got {tuple(dtx.shape)}")
    bsz, s, h, _ = dtx.shape
    if tuple(decay.shape) != (bsz, s, h):
        raise ValueError(f"decay must be (B={bsz}, S={s}, H={h}); got {tuple(decay.shape)}")
    for name, t in (("bm", bm), ("cm", cm)):
        if t.dim() != 3 or tuple(t.shape[:2]) != (bsz, s):
            raise ValueError(f"{name} must be (B={bsz}, S={s}, N); got {tuple(t.shape)}")
    if bm.shape != cm.shape:
        raise ValueError(f"bm {tuple(bm.shape)} and cm {tuple(cm.shape)} differ")
    for name, t in (("decay", decay), ("dtx", dtx), ("bm", bm), ("cm", cm)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the scan takes float32")


def _check_cuda(kernel: str, tensors: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{kernel} needs CUDA (or meta) tensors, got {name} on {t.device}; "
                             "CPU tensors take the plain version (kernels.recurrence.ops)")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the others on {dev}")
        if t.dim() and t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must have a contiguous last dimension; strides {t.stride()}")
    return dev


def _check_dy_shape(dy: torch.Tensor, like: torch.Tensor) -> None:
    """dy must be float32 of y's shape (B, S, H, 64)."""
    if tuple(dy.shape) != tuple(like.shape[:3]) + (HEAD_DIM,):
        raise ValueError(f"dy must be {tuple(like.shape[:3]) + (HEAD_DIM,)}; got {tuple(dy.shape)}")
    if dy.dtype != torch.float32:
        raise TypeError(f"dy is {dy.dtype}; the scan takes float32")


def _check_dy(dy: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """dy checked, returned contiguous and on 16 bytes (the kernels bring its
    rows by bulk copies)."""
    _check_dy_shape(dy, like)
    dy = dy.contiguous()
    return dy if dy.data_ptr() % 16 == 0 else dy.clone()


def _bwd_library():
    lib = build.load("recurrence_bwd")
    if lib.wkv6_scan_bwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_scan_bwd_launch.argtypes = [p] * 13 + [i, i, i, p]
        lib.wkv6_scan_bwd_launch.restype = i
        lib.ssd_scan_bwd_launch.argtypes = [p] * 11 + [i, i, i, i, p]
        lib.ssd_scan_bwd_launch.restype = i
        lib.recurrence_bwd_occupancy.argtypes = [i, p]
        lib.recurrence_bwd_occupancy.restype = i
        lib.recurrence_bwd_error_string.argtypes = [i]
        lib.recurrence_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    lib = build.load("recurrence")
    if lib.wkv6_scan_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_scan_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.wkv6_scan_launch.restype = i
        lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.ssd_scan_launch.restype = i
        lib.recurrence_error_string.argtypes = [i]
        lib.recurrence_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(error_string, err: int, kernel: str) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err} ({msg})")


def _strides(*groups) -> ctypes.Array:
    """The element strides of each ``(tensors, dims)`` group's tensors, their
    first ``dims`` each, as one int64 array."""
    flat = [st for tensors, dims in groups for t in tensors for st in t.stride()[:dims]]
    return (ctypes.c_int64 * len(flat))(*flat)


def wkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """Launch the WKV-6 scan; returns y (B, S, H, 64) float32, contiguous.
    r, k, v, w (B, S, H, 64) and u (H, 64), float32 on one CUDA device; the
    state starts at zero.  Runs on the current stream, not synchronised."""
    _check_cuda("wkv6_scan_cuda", dict(r=r, k=k, v=v, w=w, u=u))
    _check_wkv(r, k, v, w, u)
    return torch.ops.repro_torch.wkv6_scan(r, k, v, w, u)


def _check_wkv(r, k, v, w, u) -> None:
    check_wkv_inputs(r, k, v, w, u)
    if r.shape[0] > MAX_BATCH:
        raise ValueError(f"batch {r.shape[0]} exceeds the kernel's grid ({MAX_BATCH})")


@torch.library.custom_op("repro_torch::wkv6_scan", mutates_args=(), device_types="cuda")
def _wkv6_scan_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    dev = r.device
    b, s, h, _ = r.shape
    y = torch.empty((b, s, h, HEAD_DIM), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    u = u.contiguous()
    lib = _library()
    strides = _strides(((r, k, v, w), 3))
    with torch.cuda.device(dev):
        err = lib.wkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, s, h,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib.recurrence_error_string, err, "wkv6_scan")
    wkv6_scan_cuda.launches += 1
    return y


def ssd_scan_cuda(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                  cm: torch.Tensor) -> torch.Tensor:
    """Launch the Mamba2 state scan; returns y (B, S, H, 64) float32,
    contiguous.  decay (B, S, H), dtx (B, S, H, 64), bm and cm (B, S, 64),
    float32 on one CUDA device; the state starts at zero.  A state size N
    other than 64 raises ``ValueError``.  Runs on the current stream."""
    _check_cuda("ssd_scan_cuda", dict(decay=decay, dtx=dtx, bm=bm, cm=cm))
    _check_ssd(decay, dtx, bm, cm)
    return torch.ops.repro_torch.ssd_scan(decay, dtx, bm, cm)


def _check_ssd(decay, dtx, bm, cm) -> None:
    check_ssd_inputs(decay, dtx, bm, cm)
    if bm.shape[-1] != SSD_STATE:
        raise ValueError(f"state size {bm.shape[-1]}; the SSD kernel is built for {SSD_STATE}")
    if dtx.shape[0] > MAX_BATCH:
        raise ValueError(f"batch {dtx.shape[0]} exceeds the kernel's grid ({MAX_BATCH})")


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cuda")
def _ssd_scan_op(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor) -> torch.Tensor:
    dev = dtx.device
    b, s, h, _ = dtx.shape
    y = torch.empty((b, s, h, HEAD_DIM), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    lib = _library()
    strides = _strides(((decay, dtx), 3), ((bm, cm), 2))
    with torch.cuda.device(dev):
        err = lib.ssd_scan_launch(
            decay.data_ptr(), dtx.data_ptr(), bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, s, h, SSD_STATE,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib.recurrence_error_string, err, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return y


def _scratch(b: int, s: int, h: int, dev) -> torch.Tensor:
    """The backward kernels' chunk-start states: B * H * ceil(S / 32) of 64 x 64."""
    return torch.empty(b * h * -(-s // CHUNK) * HEAD_DIM * HEAD_DIM, dtype=torch.float32,
                       device=dev)


def wkv6_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       u: torch.Tensor, dy: torch.Tensor):
    """Launch the WKV-6 scan's backward against ``dy`` (B, S, H, 64): returns
    ``(dr, dk, dv, dlogw, du)``, the first four (B, S, H, 64) contiguous,
    dlogw the gradient of log w, du (H, 64).  Inputs as ``wkv6_scan_cuda``
    takes them, dy float32 (copied if not contiguous).  Holds a scratch of
    B * H * ceil(S / 32) * 16 KB and the two halves' shares of dv for the
    launch; dv is their sum, du the sum of each (b, h)'s share over the
    batch.  Runs on the current stream, not synchronised."""
    _check_cuda("wkv6_scan_bwd_cuda", dict(r=r, k=k, v=v, w=w, u=u, dy=dy))
    _check_wkv(r, k, v, w, u)
    _check_dy_shape(dy, r)
    return tuple(torch.ops.repro_torch.wkv6_scan_bwd(r, k, v, w, u, dy))


@torch.library.custom_op("repro_torch::wkv6_scan_bwd", mutates_args=(), device_types="cuda")
def _wkv6_scan_bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                      u: torch.Tensor, dy: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    dev = r.device
    dy = _check_dy(dy, r)
    b, s, h, _ = r.shape
    dr, dk, dlw = (torch.empty((b, s, h, HEAD_DIM), dtype=torch.float32, device=dev)
                   for _ in range(3))
    dv_part = torch.empty((2, b, s, h, HEAD_DIM), dtype=torch.float32, device=dev)
    du_part = torch.empty((b, h, HEAD_DIM), dtype=torch.float32, device=dev)
    if dr.numel() == 0:
        return (dr, dk, dv_part[0], dlw, torch.zeros((h, HEAD_DIM), dtype=torch.float32, device=dev))
    u = u.contiguous()
    lib = _bwd_library()
    strides = _strides(((r, k, v, w), 3))
    scratch = _scratch(b, s, h, dev)
    with torch.cuda.device(dev):
        err = lib.wkv6_scan_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), dy.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv_part.data_ptr(), dlw.data_ptr(), du_part.data_ptr(),
            scratch.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), b, s, h,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib.recurrence_bwd_error_string, err, "wkv6_scan_bwd")
    wkv6_scan_bwd_cuda.launches += 1
    return dr, dk, dv_part[0] + dv_part[1], dlw, du_part.sum(0)


def ssd_scan_bwd_cuda(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                      cm: torch.Tensor, dy: torch.Tensor):
    """Launch the Mamba2 state scan's backward against ``dy`` (B, S, H, 64):
    returns ``(dlogdec (B, S, H), ddtx, dbm_h, dcm_h)``, the last three
    (B, S, H, 64) contiguous; dlogdec is the gradient of log decay, dbm_h
    and dcm_h each head's share of the gradient of the shared bm and cm
    (their sum over H is it).  Inputs as ``ssd_scan_cuda`` takes them, dy
    float32.  dlogdec and ddtx are the sums of the two halves' shares.  Runs
    on the current stream, not synchronised."""
    _check_cuda("ssd_scan_bwd_cuda", dict(decay=decay, dtx=dtx, bm=bm, cm=cm, dy=dy))
    _check_ssd(decay, dtx, bm, cm)
    _check_dy_shape(dy, dtx)
    return tuple(torch.ops.repro_torch.ssd_scan_bwd(decay, dtx, bm, cm, dy))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=(), device_types="cuda")
def _ssd_scan_bwd_op(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                     dy: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = dtx.device
    dy = _check_dy(dy, dtx)
    b, s, h, _ = dtx.shape
    dlog_part = torch.empty((2, b, s, h), dtype=torch.float32, device=dev)
    dx_part = torch.empty((2, b, s, h, HEAD_DIM), dtype=torch.float32, device=dev)
    db_h, dc_h = (torch.empty((b, s, h, HEAD_DIM), dtype=torch.float32, device=dev)
                  for _ in range(2))
    if dlog_part[0].numel() == 0:
        return dlog_part[0], dx_part[0], db_h, dc_h
    lib = _bwd_library()
    strides = _strides(((decay, dtx), 3), ((bm, cm), 2))
    scratch = _scratch(b, s, h, dev)
    with torch.cuda.device(dev):
        err = lib.ssd_scan_bwd_launch(
            decay.data_ptr(), dtx.data_ptr(), bm.data_ptr(), cm.data_ptr(), dy.data_ptr(),
            dlog_part.data_ptr(), dx_part.data_ptr(), db_h.data_ptr(), dc_h.data_ptr(),
            scratch.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), b, s, h, SSD_STATE,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib.recurrence_bwd_error_string, err, "ssd_scan_bwd")
    ssd_scan_bwd_cuda.launches += 1
    return dlog_part[0] + dlog_part[1], dx_part[0] + dx_part[1], db_h, dc_h


def _y_like(x: torch.Tensor) -> torch.Tensor:
    b, s, h = x.shape[:3]
    return x.new_empty((b, s, h, HEAD_DIM), dtype=torch.float32)


@_wkv6_scan_op.register_fake
def _(r, k, v, w, u):
    return _y_like(r)


@_ssd_scan_op.register_fake
def _(decay, dtx, bm, cm):
    return _y_like(dtx)


@_wkv6_scan_bwd_op.register_fake
def _(r, k, v, w, u, dy):
    return _y_like(r), _y_like(r), _y_like(r), _y_like(r), u.new_empty(u.shape)


@_ssd_scan_bwd_op.register_fake
def _(decay, dtx, bm, cm, dy):
    return decay.new_empty(decay.shape), _y_like(dtx), _y_like(dtx), _y_like(dtx)


# The forward kernels' tensor-core work: mma.sync m16n8k8 (2 x 16 x 8 x 8 TF32
# flops) a (b, h) and 32-step chunk, the 3xTF32 split's three products each.
# WKV-6: (r P) S_start 128, A's off-diagonal block 16, A V over A's three
# 16 x 16 lower blocks 48, (k Q)^T V 128: 320 x 3.  SSD: C h^T 128, C B^T's
# lower blocks 48, (Ls C B^T) X 48, (suf B)^T X 128: 352 x 3.
MMA_PER_CHUNK = {"wkv6": 960, "ssd": 1056}
MMA_TF32_FLOPS = 2 * 16 * 8 * 8


def scan_flops(kind: str, b: int, s: int, h: int) -> int:
    """The forward kernel's 3xTF32 chunk products, each counted three times."""
    return MMA_PER_CHUNK[kind] * MMA_TF32_FLOPS * b * h * -(-s // CHUNK)


def scan_bwd_flops(kind: str, b: int, s: int, h: int) -> tuple[int, int]:
    """The backward function's work on these shapes, ``(products,
    elementwise)``, per (b, h) and 32-step chunk of L steps in the chunked
    form with its O(L^2) sums; products counted three times, a 3xTF32
    product's.  Products: the five state products (2 L 64^2 each) and the
    pair products (WKV-6: D, A and dv's A^T dy over the pairs with their
    diagonal, dr's and dk's over the pairs below it; the SSD: E, C B^T, dc,
    db and dx over the pairs with their diagonal).  Elementwise: the decays'
    gradient, a product and two prefix sums a pair and column (WKV-6; a pair
    for the SSD) and its start- and end-state parts."""
    n, d = CHUNK, HEAD_DIM
    pairs, incl = n * (n - 1) // 2, n * (n + 1) // 2
    state = 5 * 2 * n * d * d
    if kind == "wkv6":
        products = state + 3 * 2 * incl * d + 2 * 2 * pairs * d
        elementwise = 3 * pairs * d + 4 * n * d + 2 * d * d
    else:
        products = state + 5 * 2 * incl * d
        elementwise = 3 * incl + 4 * n * d + 2 * d * d
    per = b * h * -(-s // CHUNK)
    return 3 * products * per, elementwise * per


@register_flop_formula(torch.ops.repro_torch.wkv6_scan)
def _wkv6_flops(r_shape, *args, out_shape=None, **kwargs):
    b, s, h, _ = r_shape
    return scan_flops("wkv6", b, s, h)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flops(decay_shape, dtx_shape, *args, out_shape=None, **kwargs):
    b, s, h, _ = dtx_shape
    return scan_flops("ssd", b, s, h)


@register_flop_formula(torch.ops.repro_torch.wkv6_scan_bwd)
def _wkv6_bwd_flops(r_shape, *args, out_shape=None, **kwargs):
    b, s, h, _ = r_shape
    return sum(scan_bwd_flops("wkv6", b, s, h))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _ssd_bwd_flops(decay_shape, dtx_shape, *args, out_shape=None, **kwargs):
    b, s, h, _ = dtx_shape
    return sum(scan_bwd_flops("ssd", b, s, h))


def bwd_grid(kind: str, b: int, h: int) -> dict:
    """The backward kernel's launch at batch ``b`` and ``h`` heads on the
    current card: its CTAs (two per (b, h)), the CTAs the card holds at once
    (CTAs resident on an SM, from cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    times the SMs), threads and shared memory a CTA.  ``kind`` "wkv6" or "ssd"."""
    if kind not in ("wkv6", "ssd"):
        raise ValueError(f"kind must be 'wkv6' or 'ssd'; got {kind!r}")
    lib = _bwd_library()
    out = (ctypes.c_int * 3)()
    _raise_on(lib.recurrence_bwd_error_string,
              lib.recurrence_bwd_occupancy(0 if kind == "wkv6" else 1,
                                           ctypes.cast(out, ctypes.c_void_p)), "occupancy")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    ctas = 2 * b * h
    return dict(ctas=ctas, per_sm=out[0], threads=out[1], smem_bytes=out[2], sms=sms,
                one_wave=ctas <= out[0] * sms)


def reset_launch_counts() -> None:
    """Set the four kernels' launch counts to 0."""
    wkv6_scan_cuda.launches = 0
    ssd_scan_cuda.launches = 0
    wkv6_scan_bwd_cuda.launches = 0
    ssd_scan_bwd_cuda.launches = 0


reset_launch_counts()
