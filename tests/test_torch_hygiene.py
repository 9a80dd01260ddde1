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
from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.kernels import build

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


def test_cuda_sources_and_build_directory():
    srcs = build.sources()
    assert "mttkrp" in srcs and srcs["mttkrp"].suffix == ".cu"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.BUILD_DIR.is_relative_to(REPO)
    ignored = (REPO / ".gitignore").read_text().split()
    assert "/build/" in ignored and "chiprun_out/" in ignored


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
