"""Port hygiene: no JAX in the port, no silent CPU fallback, a failing smoke off the card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_cuda
from repro_torch.models import model_zoo as tzoo
from repro_torch import serve as tserve

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_repro(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_every_port_module_loads_no_jax():
    modules = [
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = random_sparse_tensor((10, 9, 8), 60, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        tcp.cp_als(t, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tfused.cp_als_fused(t, 4, impl="kernel")
    with pytest.raises(RuntimeError, match="cuda"):
        tcp.cp_init(t, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        tdevice.resolve_device("meta")


def test_service_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.DecompositionService()
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.DecompositionService(device="cuda")
    assert tserve.DecompositionService(device="cpu").device == torch.device("cpu")


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="cuda"):
        tzoo.init_model(cfg, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        tzoo.make_prefill_fn(cfg)
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    # A CPU tensor asks for the plain version by where it lies.
    assert flash_attention(q, q, q).shape == q.shape
    small = reduced_config("internlm2-1.8b")
    model = tzoo.init_model(small, seed=0, device="cpu")
    assert model.embed.device.type == "cpu"
    with pytest.raises(ValueError, match="prefill runs on"):
        tzoo.make_prefill_fn(small, device="cpu")(model.to("meta"), {"tokens": np.zeros((1, 2))})


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
                         + sorted(PORT.rglob("*.cuh")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_calls_no_library_attention_and_no_compiler(path):
    """The port's kernels are its own: no fused library attention, no torch.compile."""
    text = path.read_text()
    for name in ("scaled_dot_product_attention", "torch.compile", "cudnn", "flash_attn"):
        assert name not in text, name


def test_cuda_sources_and_build_directory():
    srcs = build.sources()
    assert "mttkrp" in srcs and srcs["mttkrp"].suffix == ".cu"
    assert "flash_attention" in srcs and srcs["flash_attention"].suffix == ".cu"
    assert "flash_attention_sm90" in srcs and srcs["flash_attention_sm90"].suffix == ".cu"
    assert "recurrence" in srcs and srcs["recurrence"].suffix == ".cu"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.BUILD_DIR.is_relative_to(REPO)
    ignored = (REPO / ".gitignore").read_text().split()
    assert "/build/" in ignored and "chiprun_out/" in ignored


def test_an_edited_header_changes_the_library_path(tmp_path):
    """A library's digest covers every header beside its source: an edited
    ``*.cuh`` in the source's ``csrc/`` builds a new library (a stale one
    would load otherwise), while a header elsewhere changes nothing."""
    csrc = tmp_path / "scan" / "csrc"
    csrc.mkdir(parents=True)
    src = csrc / "scan.cu"
    src.write_text('#include "common.cuh"\n')
    header = csrc / "common.cuh"
    header.write_text("// v1\n")
    (tmp_path / "elsewhere.cuh").write_text("// unrelated\n")
    assert build.headers(src) == [header]
    before = build._library_path("scan", src, ())
    assert before == build._library_path("scan", src, ())
    (tmp_path / "elsewhere.cuh").write_text("// edited\n")
    assert build._library_path("scan", src, ()) == before
    header.write_text("// v2\n")
    after = build._library_path("scan", src, ())
    assert after != before and after.parent == before.parent
    assert build._library_path("scan", src, ("-DX",)) != after
    repo_src = build.sources()["recurrence_bwd"]
    assert [p.name for p in build.headers(repo_src)] == ["recurrence_common.cuh"]


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Off the card the smoke exits nonzero and prints no result, both in
    the repo and as a lone copy of the script."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in [(REPO / "chip_smoke.py", REPO), (lone, tmp_path)]:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout


def test_fused_rejects_bad_budgets():
    t = random_sparse_tensor((10, 9, 8), 60, seed=0)
    ex = tfused.FusedCPALS(t, 2, device="cpu")
    for kw in (dict(n_iters=0), dict(fit_every=0), dict(restarts=0)):
        with pytest.raises(ValueError):
            ex.run(**kw)
    assert np.isfinite(ex.run(n_iters=2).fits).all()
