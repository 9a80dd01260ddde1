"""LM decode and the continuous-batching server on the card.

Needs an NVIDIA GPU; skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_cuda.py

A reduced internlm2-1.8b config: float32 decode logits on the card against
the same steps on the CPU (1e-4, tests/test_torch_models.py's
``LOGITS_F32_TOL``, TF32 off), the servers' completed tokens equal on both,
and bf16 teacher-forced decode against the prefill within 5e-2 of the
largest logit (chip_smoke.py phase 7's bound).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.runtime.serve_loop import BatchServer, ServeConfig

pytestmark = pytest.mark.cuda

LOGITS_F32_TOL = 1e-4
BF16_SCALE_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, dtype=torch.float32):
    cfg = reduced_config("internlm2-1.8b", num_kv_heads=2, dtype=dtype, vocab_size=500)
    return cfg, tzoo.init_model(cfg, seed=0, device="cpu").to(device)


def test_decode_steps_on_the_card_match_the_cpu(cuda):
    cfg, model = _model(cuda)
    host = tzoo.init_model(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (12, 3), dtype=np.int32)
    states = [ttr.init_decode_state(cfg, 3, 16, cache_dtype=torch.float32, device=d)
              for d in (cuda, "cpu")]
    steps = [tzoo.make_decode_fn(cfg, device=d) for d in (cuda, "cpu")]
    for t in range(12):
        got, _ = steps[0](model, toks[t], states[0])
        want, _ = steps[1](host, toks[t], states[1])
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=LOGITS_F32_TOL,
                                   atol=LOGITS_F32_TOL)
    assert states[0]["pos"].tolist() == [12, 12, 12]


def test_batch_server_on_the_card_matches_the_cpu(cuda):
    cfg, model = _model(cuda)
    host = tzoo.init_model(cfg, seed=0, device="cpu")
    out = []
    for m, d in ((model, cuda), (host, "cpu")):
        srv = BatchServer(cfg, m, ServeConfig(max_slots=2, max_len=12, eos_id=-1), device=d)
        for i in range(5):
            srv.submit(f"r{i}", [1 + i, 2, 3])
        out.append(srv.run_until_drained())
    assert out[0] == out[1] and len(out[0]) == 5


def test_bf16_teacher_forced_decode_matches_prefill(cuda):
    cfg, model = _model(cuda, torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))).to(cuda)
    with torch.inference_mode():
        full = ttr.forward(model, cfg, {"tokens": toks}).float()
    state = ttr.init_decode_state(cfg, 2, 40, device=cuda)
    decode = tzoo.make_decode_fn(cfg, device=cuda)
    steps = torch.stack([decode(model, toks[:, t], state)[0] for t in range(40)], dim=1)
    gap = float((steps[..., :500] - full[..., :500]).abs().max())
    assert gap <= BF16_SCALE_TOL * float(full[..., :500].abs().max())
