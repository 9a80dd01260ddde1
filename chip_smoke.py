#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line).  They
run in the order 1, 2, 6-8, 13, 16, 17, 18, 3-5, 12's Table II part, 10,
9, 11, 12, 14, 15, 19: phase 3's tensor is drawn in a child process on the
host while phases 6-8, 13, 16, 17 and 18 keep the card busy.

  1. the card, the versions, both TF32 flags, and the build of every CUDA
     source with nvcc for sm_90a;
  2. both MTTKRP kernels (the split kernel, every call's default, and the
     block kernel) against their plain PyTorch version on the card, over
     the edge cases of the CPU tests and of the split kernel's partition
     (a hot row spanning many slices, slice boundaries inside padding,
     empty rows between slices, fewer nonzeros than slices; tolerance 1e-4
     for float32 factors, 3e-2 for bfloat16, relative to the size of each
     output's sum: see ``compare``), two split launches bit for bit equal,
     and the port's CP-ALS on the card against the same run on the CPU
     (fits within FUSED_FIT_TOL);
  3. the main path at full size: a NELL-2 stand-in at Table II size (dims
     12100 x 9200 x 28800, 76.9M drawn nonzeros, Zipf 0.85, drawn in a
     child process and written to the files phase 14 reads), rank 16,
     through eager ``cp_als(impl="kernel")`` (5 sweeps) and
     ``cp_als_fused`` with 4 batched restarts (5 sweeps, one sync); per
     mode the largest block's and the hottest row's share of nonzeros and
     the split kernel's CTAs; the launch counters must show one split
     launch per mode per sweep in each;
  4. per mode at full size, the split kernel against its plain version
     with one restart and with 4 restarts whose factors differ, two
     launches bit for bit equal, then times (CUDA events, median of 10) of
     the split kernel, the block kernel and the plain version beside the
     least time the card could take for the bytes the function needs;
  5. a ``torch.profiler`` trace of one eager sweep: device time by kernel
     (the split kernel and its carry pass apart) and the device's idle
     share;
  6. the flash-attention kernels against their plain version on the card
     over S in {1, 63, 64, 65, 127, 129, 200, 1000}, causal and not, (H, KV)
     in {(4, 4), (4, 2), (4, 1), (16, 8)}, D in {64, 128}, B in {1, 3},
     float32 and bfloat16, and over q, k, v that are strided views of one
     fused projection, and non-causal cross-attention cases with a key
     length of their own (FLASH_CROSS_SEQS, among them (448, 1500),
     (1, 1000), (129, 64) and (448, 4096)): each case through the kernel
     ``variant_for`` picks
     (wgmma for bfloat16, the float32 kernel for float32) and each bfloat16
     case through the ``mma.sync`` kernel too; each output row within
     FLASH_ROW_TOL of its own norm (see ``max_row_error``), and each element
     within the JAX tests' 2e-5 and 3e-2 (absolute plus relative);
  7. the LM main path: internlm2-1.8b at full width and depth (random
     weights from ``init_model(seed=0)``), ``make_prefill_fn`` on B = 2,
     S = 32768 tokens (prefill_32k's length; its batch of 32 cut to 2): one
     warm-up and 3 timed prefills, each launching the wgmma flash kernel
     once per layer (launches counted per variant); then the same model at
     S = 256 with the kernel against plain dense attention, and a reduced
     config on the card against the CPU;
  8. both bfloat16 flash kernels on layer 0's q, k, v at the main path's
     shape against their plain version by the same two limits, two planted
     faults in the wgmma kernel's output that the row limit must reject
     (late rows scaled by 0.9; the last 64 rows without the first 64 keys),
     the times (CUDA events) of the wgmma kernel, the ``mma.sync`` kernel,
     the plain version and ``scaled_dot_product_attention`` (a yardstick the
     port never calls) beside the bound, and a ``torch.profiler`` trace of
     one prefill;
  9. the multi-tenant CP-ALS service (``DecompositionService``, max_batch 8,
     2 batches in flight) on 24 synthetic requests at a tenth of NELL-2's
     dims (1.3-2.2M drawn nonzeros each, ranks 8 and 16, 10 sweeps): a
     closed-loop drain of the trace submitted four times (each batch
     uploads its tensors and builds its stacked plans on the card inside
     the clock), then a replay of the requests at the trace's arrivals;
     every bucket batch's MTTKRP one split-kernel launch over its stacked
     plan (launches counted per variant); one batch's stacked MTTKRP per
     mode against its plain version, staging and ``run_batch`` queued
     behind a sleep (the host must return first) and ``run_batch`` under
     ``torch.cuda.set_sync_debug_mode("error")``, every response against a
     standalone ``cp_als_fused`` on the card (FUSED_FIT_TOL), and a
     ``torch.profiler`` trace of one batch, staging included;
 10. the nonzero orderings (lex, secondary-sort, degree, blocked) on phase
     3's tensor, run right after phase 5 while its tensor and lex plans are
     resident: per ordering the order of each mode sorted on the card
     (CUDA-event ms; mode 0 array-equal to the CPU's), the plans and their
     contiguity flag and padding, each mode's split kernel in the mode its
     plan picks (row-run for the first three, tile for blocked) against
     the plain version (1e-4 of the sum of absolute terms) with a bit-for-bit
     repeat, at B=1 and at B=4 (the fused run's initial factors), the times
     of the split kernel in that mode (B=1 and 4) and in tile mode, the
     block kernel and the plain version beside the byte bound, and one
     ``cp_als_fused(ordering=o, restarts=4, impl="kernel")`` of 5 sweeps
     whose fits must stay within FUSED_FIT_TOL of phase 3's lex run, its
     launches counted by variant and mode (all split, 0 block); the tile
     mode's grid at B=1 and B=4 (CTAs, warps per CTA and per SM, restarts a
     pass, shared memory per CTA), the bound at B=4 (the stream once,
     factors, output and flops 4 times) beside the B=4 time, and on the
     blocked plans a ``torch.profiler`` trace of one sweep at B=1 and one
     at B=4 that splits the tile mode's time between its main launch and
     its carry pass.  Blocked runs second, after lex; each ordering's plans
     are freed before the next.
 11. the paper's experiment engine (``repro_torch.experiments``) through
     the split kernel: ``run_experiments`` with ``impls=("kernel",)``, 3
     sweeps eager and fused (cold and warm), on the largest stand-ins that
     ``make_frostt_like``'s cap of 2M nonzeros gives (NELL-2 at 0.026,
     LBNL at its Table II size with 5 modes, PATENTS at 5.6e-4), one call
     per tensor; per run the split launches (the counter's step across its
     call: eager plus both fused runs, 0 block), each mode's
     first call against the plain version (1e-4 of the sum of absolute
     terms), eager against fused fits (FUSED_FIT_TOL), the closed-form
     flops; per mode the steady per-call ms (synchronized on both sides),
     its CUDA-event ms and the byte bound (the tensor's nonzeros, not the
     plan's padding); the host seconds of the trace
     simulation and of the pricing; the priced and Che-modeled E-SRAM to
     O-SRAM speedups and energy savings, and the trace-vs-Che hit-rate gaps
     (printed, not asserted); NELL-2's hit rates again from the plans'
     ``executed_row_trace`` (must be equal) and a ``ref`` run on NELL-2 (its
     fit within FUSED_FIT_TOL of the kernel's); then the controller's gates
     as ``scripts/run_controller.py`` runs them (``reconcile_controller``
     and ``controller_gates``: reconciliation within
     CONTROLLER_RECON_TOL, the paper's bands, fewer bank conflicts under
     degree and blocked, sorted on the card) and the ordering benchmark
     (``run_reorder_sweep(quick=True)``, its acceptance);
 12. the autotuner (``repro_torch.dse.autotune``) on the card.  Right after
     phase 5, while phase 3's lex plans are memoized, ``FusedCPALS(autotune=
     Autotuner(...))`` over lex and degree at Table II size (the degree
     plans built in 3 threads first): the winner, 5 sweeps at it, fits
     within FUSED_FIT_TOL of phase 3's lex run.  After phase 11: the 9
     default configs on one request of phase 9's population at ranks 8 and
     16, every config's per-mode times (each the device time of one call
     queued behind a sleep, median of 3) and the winner, ``speedup_vs_default``
     (>= 1), the default's and the winner's kernel alone (50 back to back),
     no memo miss on a repeat ``tune`` or ``config_for``, the winner's plans
     through the split kernel against plain (1e-4 of the sum of absolute
     terms); a ``DecompositionService(autotuner=)`` over 6 requests (every
     bucket's ``nnz_pad`` a multiple of the tuned tile, every fit within
     FUSED_FIT_TOL of a standalone ``cp_als_fused(autotune=)`` of the same
     seed), ``measured_vs_modeled`` for the rank-16 band, and
     ``run_experiments(ExperimentSpec(autotune=True))`` on NELL-2@0.026, its
     first calls against plain on the winner's plans.  Each part's split
     launches are counted and must all be split launches;
 13. LM decode serving at full width and depth (internlm2-1.8b, bf16,
     random weights): a 256-token prompt decoded token by token (B = 1)
     against ``forward`` at S = 256 (``max |gap| <= 5e-2 max |logit|``), two
     ``BatchServer`` runs (launch/serve.py's load: 8 requests, 4 slots,
     ``max_len`` 48; 4 requests of 256-token prompts from ``data/lm_data``,
     4 slots, ``max_len`` 320), each with requests, tokens, ticks, tokens/s,
     the median CUDA-event ms per tick, peak memory and a profile of one
     step by kernel class (device busy, idle share of a tick); every
     request must be answered; a reused slot's tokens equal to a fresh
     server's.  The decode path launches no hand-written kernel (checked);
 14. the sharded path (``repro_torch.distributed``), one process per rank
     started by ``spawn`` with the backend ``backend_for`` picks: (a) at 1
     rank (NCCL) and 3 and 8 ranks sharing the card (gloo), ``mttkrp(impl=
     "sharded")`` in both schemes and every mode over the cases of
     tests/test_distributed.py, a restart batch and the blocked order,
     against ``mttkrp_ref`` on the card (1e-4 of each element's sum of
     absolute terms), one split launch per call on every rank, a
     ``mode_ordered`` call bit for bit, each rank's launch on its shard plan
     against the plain version; (b) phase 3's tensor, memory-mapped from
     the files its draw wrote, on 4 ranks sharing the card:
     eager ``cp_als(impl="sharded")`` in both schemes and ``cp_als_fused``
     with 4 restarts (``mode_ordered``), 5 sweeps each, fits within
     FUSED_FIT_TOL of phase 3's, launches per rank, the setups' host
     seconds, per mode the local launch alone (one rank at a time, queued
     behind a sleep), the collective alone and the whole call, peak memory
     per rank; (c) ``run_experiments(impls=("sharded",), n_shards=4)`` on
     phase 11's first stand-in (NELL-2@0.026), each rank's launches and the
     fit against phase 11's;
 15. kernel contracts on the card: the split MTTKRP kernel's audit build
     (``kernel.mttkrp_cuda_audit``, the same source built with
     ``-DMTTKRP_AUDIT`` beside the production library) on phase 10's lex
     plans (row-run mode) and blocked plans (tile mode) at B = 1 and 4,
     run inside phase 10 while they are resident; on phase 9's stacked
     batch and phase 11's 5-mode plans, run inside those phases; and on
     phase 2's partition edges in both modes.  On each: every output
     element stored exactly once, each restart's nonzeros, index columns,
     factor rows and output stores exactly ``analytic_traffic_census(N)``
     times the nonzeros (``repro_torch.analysis.census``), no carry or tile
     row read before it is written, no NaN left in an output filled with
     NaN, the stream entries read equal to the replay's count
     (``partition.stream_entries_read``, printed with the excess over the
     nonzeros), and the output bit for bit the production kernel's.  Then
     each flash kernel's C entry point into a NaN-filled output on phase
     6's input sets: no NaN left, equal to the wrapper's call.
 16. training and the MoE family on the card: (a) each flash kernel's
     row log-sum-exp (``return_lse``) against the plain version's at the
     prefill's shape (bf16 at head_dim 128 and 64, float32) and the
     training shape, the output bit for bit the one without it; (b)
     gradients through ``blocked_attention`` (kernel forward, plain
     recomputing backward) against autograd through the plain dense
     attention in float32; (c) ``moe_layer`` at granite-moe-1b-a400m's
     width on 8192 tokens against a per-token oracle, its dispatch and
     experts' device ms and peak memory; (d) a reduced granite-moe config's
     float32 AdamW train steps on the card against the CPU, one bf16 SGD
     step as (e) runs it (the cotangent fence in, MoE routing, remat
     "full") card against CPU per leaf, then a reduced
     ``train()`` with a checkpoint, an injected fault (retry, then restore)
     and a resume; (e) granite-moe-1b-a400m at full width and depth through
     ``launch/train.py``'s path, B = 4, S = 4096, 2 microbatches, remat
     "full", 6 steps: every loss, the step time, tokens/s, peak memory, the
     flash launches (96 a step), device time by class and model FLOP/s.
 17. the RWKV-6, hybrid, encoder-decoder and VLM families: (a) both
     recurrence kernels (``kernels/recurrence/csrc/recurrence.cu``) against
     their plain loops over S in {1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65,
     129, 1000} (around the 32-step chunks' and 16-step sub-chunks' edges),
     B in {1, 3}, H in {1, 5, 40}, contiguous and strided, then exactly-0,
     unit and spike decays and views 4 bytes off their buffer (1e-4 of each
     (b, h)'s largest |plain|, two launches bit for bit); (b) zamba2-1.2b and
     (c) rwkv6-3b at full width and depth: ``make_prefill_fn`` at B = 2,
     S = 32768 (one warm-up, 3 timed; SSD 38 and flash 6 launches a
     prefill, WKV 32), the scan kernel at that shape on layer 0's inputs
     against its plain loop with its time and bound (bytes, or its 3xTF32
     products at the TF32 peak), the kernel path against the plain one at
     S = 256, teacher-forced decode of 128 tokens against ``forward`` (for
     rwkv6-3b these two bf16 checks are printed at 32 layers and held at 4),
     each recurrent block in float32, and ``BatchServer`` on
     ``launch/serve.py``'s load with a reused slot; the decode and serving
     paths' launches are counted and must be 0 (they are plain PyTorch); (d)
     whisper-base on ``input_specs(prefill_32k)`` at B = 2 (frames 32768,
     448 tokens; 12 flash launches a prefill: 6 non-causal encoder, 6
     cross-attention of 448 queries against 32768 keys), the kernel path
     against plain at 256 frames and 64 tokens, decode against ``forward``
     through ``fill_cross_cache``; (e) internvl2-26b at full width, 8 of 48
     layers, B = 1, S = 32768 with 1024 patch embeddings (8 flash launches),
     against plain at S = 256; (f) the wgmma flash kernel at phase 16's
     training shape and at (b)'s and (d)'s shapes beside its plain version,
     SDPA and the bound.
 18. training the RWKV-6, hybrid, encoder-decoder and VLM families: (a)
     both scans' backward kernels (``kernels/recurrence/csrc/
     recurrence_bwd.cu``) against their plain versions (the chunked
     algorithm of ``ref.py`` in float64) over (17)'s 176 cases a kernel
     (1e-4 of each (b, h)'s largest |plain| over every gradient, two
     launches bit for bit), then at the training shape (B = 2, S = 4096;
     rwkv6-3b's 40 heads, zamba2-1.2b's 64) beside the forward kernel, the
     plain version and the bound (the function's bytes, or its products at
     the TF32 rate and the rest at the float32 rate); (b) each family's
     reduced config, 3
     float32 AdamW steps with 2 microbatches on the card against the CPU
     (``FAMILY_STEP_TOL``); (c) rwkv6-3b and zamba2-1.2b at full width and
     depth through ``launch/train.py``'s path, B = 2, S = 4096, AdamW,
     remat "full", 4 steps: losses, step time, tokens/s, peak memory, each
     kernel's launches a step (the scans twice forward, once backward,
     flash twice a shared-block use), one step under the profiler by kernel
     class, and layer 0's gradients in float32 through the kernels against
     the plain step loops under autograd; (d) the flash kernels with their
     lse, not causal, at whisper-base's training shapes (its encoder, and
     448 queries against 4096 and 1500 keys) against the plain version's
     output and lse; whisper-base on ``input_specs(train_4k)`` at B = 4 and
     internvl2-26b at 4 of 48 layers, B = 2, through ``make_train_step``,
     the same figures.
 19. the sharded LM on 4 gloo ranks sharing the card (one group, the
     unsharded references run first in this process and are freed): (a)
     ``sharded_train_step`` on a (2, 2) (data, model) mesh, granite-moe-
     1b-a400m at full width, 4 of 24 layers, B = 4, S = 4096, 2
     microbatches, 2 AdamW steps from ``shard_state``, every layer
     computing its model shard (8 of 16 query heads, 4 of 8 KV heads, 16 of
     32 experts, half the vocabulary): each leaf's update against a
     control of the same split on a (replica, model) mesh (1e-4); the same
     steps in float64 (the plain attention) against the unsharded float64
     step (1e-4); one bf16 SGD step's gradient no farther from the float32
     gradient than 1.25x the unsharded bf16 one; the AdamW updates' gaps to
     the unsharded step, an independent control (4 one-row microbatches)
     and, in float32, the unsharded float32 step, printed; the step
     time, the weights' gather and the gradients' sum over the data axis
     timed alone, each rank's peak memory, flash launches (36 a rank, all
     wgmma) and their query heads (8); (a2) ``sharded_prefill`` (B = 8, S =
     4096) and ``sharded_decode`` (12 steps over caches of 8192 positions
     filled as if prefilled, rows from positions 100-8000) of the same config
     in bf16 (the main path; each row's distance to the float32 run, median
     over rows, within 1.25x the unsharded bf16 run's) and float32 (1e-4,
     3e-4 of the largest |logit|), and granite-20b's decode at full width, 2 of 52 layers, whose
     single KV head puts its caches' sequence on model (the query heads
     gathered before the windows combine), in bf16 and float32, the logits
     gathered whole against the unsharded ones; the bf16 prefill once more
     under the op counter for phase 20 (b); (b) its
     weights saved from (2, 2) and restored onto (4, 1), array-equal; (c)
     ``sharded_decode_attention``, internlm2-1.8b's attention at full width
     in float32, B = 4, a cache of 32768 over 4 ranks, 12 steps across a
     window's edge, against the unsharded ``decode_attention`` (3e-4); (d)
     ``compressed_psum`` of 64 M float32 a rank (5% of the exact sum, equal
     to the plain computation) and ``ring_allgather_matmul`` (m 4096, k
     2048, n 4 x 2048; 2e-4 of x @ w), each beside ``all_reduce`` and
     ``all_gather`` + matmul.  Rank 0's first step runs under
     ``torch.profiler`` for phase 20 (c); the step time and gloo's share
     are the last step's, untraced.
 20. the dry run (``launch/dryrun.py``) against the card: (a) phase 7's
     prefill and phase 16e's train step priced on a (1, 1) mesh beside
     their measured times and peaks, the train cell's argument bytes equal
     to phase 16e's; (b) the op counter on the card over internlm2-1.8b's
     prefill at 2 layers, equal to its count on ``meta`` (1e-9), the flash
     kernel reached through its custom op, and phase 19's tensor-parallel
     prefill on rank 0 equal to the dry run's rank on a (2, 2) mesh; (c)
     phase 19's traced
     collectives equal, call for call, to those the dry run's rank records
     on meta for the same config, batch and mesh, gloo's seconds per byte beside
     the NVLink term; (d) the phase's seconds and the script's.

The last four lines are phase 15's facts (``{"phase15": ...}``), the card's
``name, power.limit``, a JSON object
with the main paths' kernels' numbers (the split MTTKRP kernel's row-run
mode with the block kernel's time as ``previous_ms``, its launches over
the CP-ALS paths of phases 3, 9, 10, 11, 12 and 14 under ``launches_by_path``,
its per-ordering times, phase 11's per-tensor times and phase 12's tunes; its
tile mode, on the blocked plans of phase 10, with the block kernel's time
as ``previous_ms``; and the wgmma flash kernel
with the ``mma.sync`` kernel's, phase 13's decode numbers and phase 16's
training numbers, its launches on the training path, phase 17's and
phase 19's ranks' under ``launches_by_path``; the two recurrence kernels and their two backward
kernels, ``library_ms`` null),
and
``{"ok": true, "device": {...}}``.  The
script needs no network and imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# The port, from this checkout (a lone copy of this script fails here).
from repro_torch.core import cp_als as tcp  # noqa: E402
from repro_torch.core import cp_als_fused as tfused  # noqa: E402
from repro_torch.core import sparse_tensor as tst  # noqa: E402
from repro_torch.data.synthetic_tensors import make_frostt_like  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.core.cache_sim import simulate_trace  # noqa: E402
from repro_torch.core.hierarchy import CacheGeometry  # noqa: E402
from repro_torch.dse.evaluator import geometry_sim_config  # noqa: E402
from repro_torch.experiments import (  # noqa: E402
    CHE_VS_TRACE_TOL,
    CONTROLLER_RECON_TOL,
    ExperimentResult,
    ExperimentSpec,
    controller_gates,
    reconcile_controller,
    run_experiments,
)
from repro_torch.experiments.reconcile import ENERGY_BAND, SPEEDUP_BAND  # noqa: E402
from repro_torch.experiments import measure as texp_measure  # noqa: E402
from repro_torch.reorder.bench import run_reorder_sweep  # noqa: E402
from repro_torch.analysis import census as tcensus  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as kmod  # noqa: E402
from repro_torch.kernels.mttkrp import ops  # noqa: E402
from repro_torch.kernels.mttkrp import partition as kpart  # noqa: E402
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref  # noqa: E402
from repro_torch.reorder import strategies as tstrat  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data.lm_data import SyntheticLMStream  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkmod  # noqa: E402
from repro_torch.kernels.recurrence import draws as rdraws  # noqa: E402
from repro_torch.kernels.recurrence import kernel as rkmod  # noqa: E402
from repro_torch.kernels.recurrence import ref as rref  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention.ref import NEG_INF, max_row_error  # noqa: E402
from repro_torch.models.attention import project_qkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import AdamW, init_adamw_state  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoopConfig, train  # noqa: E402
from repro_torch.models.model_zoo import init_model, make_prefill_fn  # noqa: E402
from repro_torch.models.transformer import forward, forward_params  # noqa: E402
from repro_torch.dse import (  # noqa: E402
    DEFAULT_TILE_CONFIG,
    Autotuner,
    TuneSpace,
    measured_vs_modeled,
)
from repro_torch.experiments import engine as texp_engine  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.perf import coll_breakdown as tcollb  # noqa: E402
from repro_torch.perf.coll_stats import collective_stats, ring_bytes  # noqa: E402
from repro_torch.perf.op_cost import OpCounter  # noqa: E402
from repro_torch.perf.roofline import H100_SXM  # noqa: E402
from repro_torch.tree import param_tree, tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model_zoo import init_decode_state, input_specs, make_decode_fn  # noqa: E402
from repro_torch.runtime.serve_loop import BatchServer, ServeConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BucketExecutor,
    DecompositionService,
    TrafficConfig,
    bucket_signature,
    replay_trace,
    synthetic_trace,
)

HBM_BYTES_PER_S = H100_SXM.hbm_bw  # H100 SXM device memory, 3.35 TB/s (perf/roofline.py)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA's data sheet)
F64_TC_FLOPS_PER_S = 67e12  # H100 SXM float64 on the tensor cores (NVIDIA's data sheet)
BF16_FLOPS_PER_S = H100_SXM.peak_bf16_flops  # H100 SXM dense bf16 on the tensor cores, 989 TFLOP/s
F32_TOL = 1e-4
BF16_TOL = 3e-2
FLASH_F32_TOL = 2e-5  # tests/test_flash_kernel.py
# Flash output rows, ||kernel - plain|| / ||plain|| per (b, s, h).  bf16: both
# sides round each element to bf16 (up to 2^-9 of it each, so up to 2^-8 of
# the row's norm together) and the kernel rounds probabilities to bf16 before
# P.V; 1e-2 leaves room over that and is 10x below a 0.9 scaling.  float32:
# the same sums in another order, ~1e-6.
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LOGITS_F32_TOL = 1e-4  # tests/test_torch_models.py
BF16_SCALE_TOL = 5e-2  # bf16 logits: max |a - b| <= 5e-2 * max |b| (tests/test_torch_models.py)

ARCH = "internlm2-1.8b"
PREFILL_BATCH = 2  # prefill_32k's global batch of 32, cut to 2
PREFILL_SEQ = 32_768  # prefill_32k's length
PREFILL_REPS = 3  # timed prefills after one warm-up
PLAIN_Q_CHUNK = 512  # query rows per step of the plain attention at full size
FLASH_REPS = 5
FLASH_SEQS = (1, 63, 64, 65, 127, 129, 200, 1000)  # 127, 129, 1000: S % 128 != 0
# (S_q, S_kv) of non-causal cross-attention: whisper's 448 decoder positions
# against 1500 encoder frames (its 30 s window) and against 4096; ragged tiles.
FLASH_CROSS_SEQS = ((448, 1500), (1, 1000), (129, 64), (448, 4096), (64, 1), (200, 129))

NELL2_DIMS = (12_100, 9_200, 28_800)  # paper Table II
NELL2_NNZ = 76_900_000
NELL2_ZIPF = 0.85
RANK = 16  # paper §V-A2
SWEEPS = 5
RESTARTS = 4
TIMING_REPS = 10

# Phase 9: NELL-2 Table II's dims / 10 and its Zipf 0.85; nonzeros at the
# scale of FROSTT's smaller tensors (LBNL-network 1.7M, NIPS 3.1M).  Every
# request bands to dims (2048, 1024, 4096) and nnz_pad 2^21; ranks 8 and 16
# make two buckets.
SERVE_TRAFFIC = TrafficConfig(
    n_requests=24, base_dims=(1210, 920, 2880), dim_jitter=0.1,
    nnz_range=(1_300_000, 2_200_000), ranks=(8, 16), n_iters=10, zipf_a=0.85, seed=0)
SERVE_MAX_BATCH = 8
SERVE_MAX_INFLIGHT = 2
SERVE_REPLAY_SCALE = 1.0  # the trace's own arrivals: 24 within ~50 ms, a queue forms
# The closed-loop drain submits the trace this many times under new ids (12
# batches), so that its rate is not mostly pipeline fill and drain.  Nothing
# is memoized per request, so a repeated tensor costs what a new one does.
SERVE_DRAIN_ROUNDS = 4
SLEEP_CYCLES = 1_000_000_000  # torch.cuda._sleep ahead of a launch: ~0.5 s on an H100
# CUDA queues about 1020 launches ahead of the device and then blocks
# the host until there is room (phase 9's launch-queue line).  One served
# sweep queues about 109 device operations, so the check behind a sleep runs
# 4 sweeps: a batch's 10 fill the queue, and that wait is back-pressure, not
# a read of a result.
SLEEP_CHECK_SWEEPS = 4


# Phase 16: training.  granite-moe-1b-a400m at full width and depth; the
# batch of 4 x 4096 tokens is cut from a pretraining batch of millions of
# tokens to what one card holds with float32 masters and AdamW's moments.
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH = 4
TRAIN_SEQ = 4096  # above 2048: attention_impl "auto" takes the kernel
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 6
LSE_TOL = 1e-4  # tests/test_torch_train_cuda.py
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # the same file
MOE_TOL = 2e-4  # tests/test_moe.py
STEP_TOL = 1e-4
# 16(d)'s bf16 step (tests/test_torch_train_cuda.py): each leaf's update,
# card against CPU, within 0.25 in norm and elementwise within 1e-1 of the
# leaf's largest update on all but 3% of its elements; and the card's update
# no farther from the float32 config's than 1.25 x the CPU's.  bf16 router
# logits flip near-tied top-k choices differently on each side: measured on
# the card, 0.02-0.17 in norm, at most 1.4% of elements off, ratio <= 1.12,
# with each side 0.03-0.25 from the float32 update.
BF16_STEP_TOL = 0.25
BF16_STEP_ELEM = 1e-1
BF16_STEP_FLIPS = 3e-2
BF16_F32_RATIO = 1.25


class SmokeFailure(Exception):
    pass


T_START = time.perf_counter()


def phase(title: str) -> None:
    """Print a phase's title with the seconds since the script started."""
    print(f"{title}  [{time.perf_counter() - T_START:.1f} s]")


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(bufs, facs, mode: int, i_out: int, got: torch.Tensor, tol: float):
    """Kernel output against the plain version on the same inputs.

    Both sides sum the same float32 products in different orders, so the
    error of an output element scales with the size of its sum, not with
    its value, which may cancel to near zero.  The check is therefore
    ``|got - want| <= tol * scale``, where ``scale`` is the same MTTKRP of
    ``|values|`` and ``|factors|`` (the sum of the absolute terms of each
    element).  Returns (max |got - want|, max |got - want| / scale, ok).
    """
    want = mttkrp_plan_ref(bufs, facs, mode, i_out)
    scale = mttkrp_plan_ref(bufs._replace(values=bufs.values.abs()), [f.abs() for f in facs],
                            mode, i_out)
    diff = (got.float() - want).abs()
    if not diff.numel():
        return 0.0, 0.0, True
    max_rel = float((diff / scale.clamp_min(torch.finfo(torch.float32).tiny)).max())
    return float(diff.max()), max_rel, bool((diff <= tol * scale).all())


def factors_on(shape, rank, dev, *, batch=None, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lead = () if batch is None else (batch,)
    return [
        torch.randn(lead + (s, rank), generator=gen).to(device=dev, dtype=dtype).contiguous()
        for s in shape
    ]


def partition_edge_tensors():
    """The split kernel's partition edges (tests/test_torch_kernel_cuda.py):
    name -> (tensor, rank, tile_nnz, rows_per_block)."""
    rng = np.random.default_rng(8)

    def coo(rows, dims):
        idx = np.stack([rows] + [rng.integers(0, d, rows.size) for d in dims[1:]], 1)
        return tst.SparseTensor(idx.astype(np.int32),
                                rng.standard_normal(rows.size).astype(np.float32), dims)

    hot = coo(np.concatenate([np.zeros(200_000, np.int64), rng.integers(1, 500, 10_000)]),
              (500, 300, 400))
    padding = coo(np.arange(0, 32_000, 16) + rng.integers(0, 16, 2000), (32_000, 50, 60))
    sparse_rows = coo(np.repeat(np.arange(0, 100_000, 50), 100), (100_000, 70, 90))
    few = coo(rng.integers(0, 400, 50), (400, 30, 20))
    return {
        "hot row (200K of 210K nnz on row 0)": (hot, RANK, 256, 256),
        "slice boundaries inside padding": (padding, RANK, 256, 16),
        "empty rows between slices": (sparse_rows, RANK, 128, 64),
        "fewer nonzeros than slices": (few, RANK, 32, 16),
    }


def audit_plan(bufs, facs, mode: int, i_out: int, nnz: int, label: str, card: str, *,
               split_mode: str | None = None) -> dict:
    """Phase 15 on one plan: the split kernel's audit build
    (``kmod.mttkrp_cuda_audit``) against the kernel contracts
    (``tcensus.audit_failures``: every output element stored exactly once,
    each restart's census exactly ``analytic_traffic_census(N)`` times
    ``nnz``, no uninitialised read, no NaN left), its stream entries read
    against the replay's count (``partition.stream_entries_read``), and its
    output bit for bit against the production kernel's on the same inputs.
    Each call's device time (CUDA events, one call each, the audit's fills
    of its output and scratch included) is printed beside the production
    call's.  Prints one line; returns the facts and the failures."""
    dev = bufs.values.device
    nmodes, rank = len(facs), int(facs[0].shape[-1])
    batch = int(facs[0].shape[0]) if facs[0].dim() == 3 else 1
    split_mode = kmod.split_mode_for(bufs, split_mode)
    t0 = time.perf_counter()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    got, counts = kmod.mttkrp_cuda_audit(bufs, facs, mode, i_out, split_mode=split_mode)
    events[1].record()
    want = kmod.mttkrp_cuda(bufs, facs, mode, i_out, split_mode=split_mode)
    events[2].record()
    summary = tcensus.audit_summary(counts, got)
    same = bool(torch.equal(got, want))
    seconds = time.perf_counter() - t0
    audit_ms, production_ms = (events[0].elapsed_time(events[1]),
                               events[1].elapsed_time(events[2]))
    del got, want, counts
    failures = tcensus.audit_failures(summary, nmodes, nnz, i_out, rank)
    slices = (kmod.tile_grid(nmodes, int(bufs.rows_per_block), facs[0].dtype, dev, batch=batch).ctas
              if split_mode == "tiles" else kmod.split_slices(nmodes, batch, facs[0].dtype, dev))
    predicted = kpart.stream_entries_read(int(bufs.values.shape[0]), slices, split_mode, batch)
    if summary["entries_read"] != predicted:
        failures.append(f"stream entries read {summary['entries_read']}, the replay's count "
                        f"{predicted}")
    if not same:
        failures.append("the audit build's output differs from the production kernel's")
    first = summary["census"][0]
    alike = all(c == first for c in summary["census"])
    excess = summary["entries_read"] - nnz
    print(f"  {label} mode {mode} ({split_mode}, B={batch}, {slices} slices): stores "
          f"{summary['store_min']}..{summary['store_max']}; census a restart"
          f"{'' if alike else ' (restarts DIFFER)'}: values {first['values']}, indices "
          f"{first['indices']}, factor rows {first['factor_rows']}, output stores "
          f"{first['output_stores']} (model {tcensus.model_census(nmodes, nnz, i_out, rank)}); "
          f"entries read {summary['entries_read']} (replay {predicted}; excess {excess}, "
          f"{excess / max(nnz, 1):.4f} a nonzero); uninitialised reads {summary['uninit_reads']}, "
          f"NaN left {summary['nan_left']}; audit = production bit for bit: {same}; audit "
          f"{audit_ms:.3f} ms, production {production_ms:.3f} ms (device, one call each); "
          f"{seconds:.3f} s  {'ok' if not failures else 'FAIL: ' + '; '.join(failures)}  [{card}]")
    return dict(label=label, mode=mode, split_mode=split_mode, batch=batch, nnz=nnz, i_out=i_out,
                census=first, entries_read=summary["entries_read"], excess=excess,
                stores=[summary["store_min"], summary["store_max"]],
                uninit_reads=summary["uninit_reads"], nan_left=summary["nan_left"],
                bit_equal=same, failures=failures, seconds=seconds, audit_ms=audit_ms,
                production_ms=production_ms)


def kernel_cases():
    """(name, tensor, rank, tile_nnz, rows_per_block, batch, dtype, tol)."""
    rng = np.random.default_rng(4)
    one_block = tst.SparseTensor(
        np.stack([rng.integers(0, 16, 3000), rng.integers(0, 40, 3000), rng.integers(0, 40, 3000)],
                 axis=1).astype(np.int32),
        rng.standard_normal(3000).astype(np.float32), (256, 40, 40))
    mid = make_frostt_like("NELL-2", scale=1e-2, seed=1, shuffle=True)
    moderate = tst.random_sparse_tensor((300, 200, 250), 60_000, seed=2, zipf_a=0.8)
    return [
        ("NELL-2-like mid-size (scale 1e-2)", mid, RANK, 256, 256, None, torch.float32, F32_TOL),
        ("empty blocks", tst.SparseTensor(np.array([[0, 0, 0], [1, 1, 1], [250, 2, 2]], np.int32),
                                         np.array([1.0, 2.0, 3.0], np.float32), (300, 4, 4)),
         8, 64, 64, None, torch.float32, F32_TOL),
        ("single nonzero", tst.SparseTensor(np.array([[5, 2, 7]], np.int32),
                                           np.array([2.5], np.float32), (11, 6, 9)),
         8, 256, 64, None, torch.float32, F32_TOL),
        ("rank 1", moderate, 1, 256, 256, None, torch.float32, F32_TOL),
        ("rank 16", moderate, 16, 256, 256, None, torch.float32, F32_TOL),
        ("rank 128", moderate, 128, 256, 256, None, torch.float32, F32_TOL),
        ("every nonzero in one block", one_block, 16, 256, 64, None, torch.float32, F32_TOL),
        ("nnz < tile", tst.random_sparse_tensor((40, 30, 20), 5, seed=13),
         16, 256, 64, None, torch.float32, F32_TOL),
        ("4 modes", tst.random_sparse_tensor((60, 50, 40, 30), 20_000, seed=4, zipf_a=0.7),
         16, 128, 32, None, torch.float32, F32_TOL),
        ("5 modes", tst.random_sparse_tensor((20, 18, 16, 14, 12), 20_000, seed=5),
         8, 128, 32, None, torch.float32, F32_TOL),
        ("bf16 factors", moderate, 16, 256, 256, None, torch.bfloat16, BF16_TOL),
        ("batched factors B=4", moderate, 16, 256, 256, 4, torch.float32, F32_TOL),
        ("rank 13 (unaligned)", moderate, 13, 128, 32, None, torch.float32, F32_TOL),
        ("batched factors B=5", moderate, 16, 64, 16, 5, torch.float32, F32_TOL),
    ] + [(name, t, rank, tile, rpb, None, torch.float32, F32_TOL)
         for name, (t, rank, tile, rpb) in partition_edge_tensors().items()]


def phase_kernel_cases(dev) -> None:
    failures = []
    print(f"  split kernel: {kmod.split_slices(3, 1, torch.float32, dev)} slices (warps) for "
          f"3 modes B=1 float32, {kmod.split_slices(3, 4, torch.float32, dev)} at B=4")
    for name, t, rank, tile, rpb, batch, dtype, tol in kernel_cases():
        facs = factors_on(t.shape, rank, dev, batch=batch, dtype=dtype, seed=t.nnz)
        for mode in range(t.nmodes):
            plan = tst.build_mttkrp_plan(t, mode, tile_nnz=tile, rows_per_block=rpb)
            bufs = ops.plan_device_buffers(plan, dev)
            got = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
            again = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
            block = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode], variant="block")
            torch.cuda.synchronize()
            max_abs, max_rel, ok = compare(bufs, facs, mode, t.shape[mode], got, tol)
            same = torch.equal(got, again)
            b_abs, b_rel, b_ok = compare(bufs, facs, mode, t.shape[mode], block, tol)
            print(f"  case {name:<36} mode {mode} nnz {t.nnz:>8} rank {rank:>3} "
                  f"split max_abs {max_abs:.3e} max_rel {max_rel:.3e} {'ok' if ok else 'FAIL'}"
                  f"{'' if same else ' (two launches DIFFER)'}, block max_rel {b_rel:.3e} "
                  f"{'ok' if b_ok else 'FAIL'} (tol {tol:g} x scale)")
            if not (ok and same and b_ok):
                failures.append(f"{name} mode {mode}")
    check(not failures, f"a kernel disagrees with its plain version: {failures}")

    # The port's CP-ALS on the card (kernel) against the same run on the CPU (plain version).
    fused_tol = tfused.FUSED_FIT_TOL
    small = tst.random_sparse_tensor((300, 200, 250), 60_000, seed=6, zipf_a=0.8)
    init = tcp.cp_init(small, 8, seed=3, device="cpu")
    on_cpu = tcp.cp_als(small, 8, n_iters=5, tol=0.0, impl="kernel", device="cpu",
                                   init_factors=init)
    on_card = tcp.cp_als(small, 8, n_iters=5, tol=0.0, impl="kernel", device=dev,
                                    init_factors=init)
    gap = float(np.max(np.abs(np.array(on_cpu.fits) - np.array(on_card.fits))))
    print(f"  cp_als small tensor: card fits {on_card.fits} cpu fits {on_cpu.fits} "
          f"max gap {gap:.3e} tol {fused_tol}")
    check(gap <= fused_tol, f"cp_als on the card differs from the CPU run by {gap}")


def profile_sweep(tensor, dev, sweep_ms: float) -> None:
    """Where one eager sweep's time goes: device time by kernel (torch.profiler),
    and the device's idle share of ``sweep_ms``, the sweep's wall time measured
    without the profiler (whose own start-up inflates the traced wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tcp.cp_als(tensor, RANK, n_iters=1, tol=0.0, impl="kernel", device=dev)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tcp.cp_als(tensor, RANK, n_iters=1, tol=0.0, impl="kernel", device=dev)
        torch.cuda.synchronize()
    # Device-side entries only (kernels, memcpy, memset), so nothing counts twice.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  one eager sweep: device busy {busy_ms:.2f} ms (profiler) of {sweep_ms:.2f} ms "
          f"wall (unprofiled), idle share {max(0.0, 1 - busy_ms / sweep_ms):.3f}")
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4} {e.key[:90]}")


def mttkrp_bytes(plan, rank: int, nnz: int) -> int:
    """Each input the function needs read once, each output written once
    (``repro_torch.experiments.measure.mttkrp_bytes`` over the tensor's
    ``nnz`` nonzeros and the plan's block offsets).  The plan's padding is
    not counted: the function does not need it, and the split kernel skips
    it by position."""
    return texp_measure.mttkrp_bytes(plan.shape, plan.mode, rank, stream_nnz=nnz,
                                     offsets=plan.num_blocks + 1)


def mttkrp_flops(plan, rank: int, nnz: int) -> int:
    """N-1 factor multiplies, one value multiply and one add per (nonzero, rank)."""
    return nnz * rank * (len(plan.shape) + 1)


class Nell2Draw:
    """Phase 3's tensor, drawn in a child process by ``random_sparse_tensor``
    (the same draw, seed and arguments as in this process) into
    ``indices.npy`` and ``values.npy``, which phase 3 loads and phase 14's
    ranks memory-map.  It runs while phases 6-8, 13 and 16 keep the card
    busy; ``stop`` ends it if the run fails first."""

    def __init__(self, directory: str):
        self.paths = (str(Path(directory, "indices.npy")), str(Path(directory, "values.npy")))
        code = "\n".join([
            "import json, time",
            "import numpy as np",
            "from repro_torch.core import sparse_tensor as tst",
            "t0 = time.perf_counter()",
            f"t = tst.random_sparse_tensor({NELL2_DIMS!r}, {NELL2_NNZ}, seed=0, "
            f"zipf_a={NELL2_ZIPF!r}, shuffle=True)",
            "drawn = time.perf_counter() - t0",
            f"np.save({self.paths[0]!r}, t.indices)",
            f"np.save({self.paths[1]!r}, t.values)",
            "print(json.dumps({'draw_s': drawn, 'write_s': time.perf_counter() - t0 - drawn}))"])
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, env=env)

    def result(self) -> tuple[tst.SparseTensor, dict]:
        t0 = time.perf_counter()
        out, err = self.proc.communicate()
        info = {"waited_s": time.perf_counter() - t0}
        check(self.proc.returncode == 0,
              f"the NELL-2 draw failed with code {self.proc.returncode}: {err[-2000:]}")
        info.update(json.loads(out.strip().splitlines()[-1]))
        t0 = time.perf_counter()
        tensor = tst.SparseTensor(np.load(self.paths[0]), np.load(self.paths[1]), NELL2_DIMS)
        info["load_s"] = time.perf_counter() - t0
        return tensor, info

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def cp_als_phases(dev, card: str, draw: Nell2Draw
                  ) -> tuple[dict, tst.SparseTensor, np.ndarray, np.ndarray]:
    """Phases 3-5: the CP-ALS main path at NELL-2 Table II size.  Returns the
    MTTKRP kernel's entry of the ``kernels`` line, the tensor, the fused
    run's fits (restarts x sweeps), for phases 10, 12 and 14, and the eager
    run's, for phase 14."""
    # -- phase 3: the main path at Table II size -----------------------------
    phase("phase 3: NELL-2 stand-in at Table II size, rank 16")
    tensor, drawn = draw.result()
    host_data_s = drawn["draw_s"]
    print(f"  tensor: dims {tensor.shape}, {NELL2_NNZ} drawn, {tensor.nnz} after coalescing, "
          f"host {host_data_s:.2f} s in a child process beside phases 6-8, 13 and 16 (written "
          f"in {drawn['write_s']:.2f} s); waited {drawn['waited_s']:.2f} s for it here, loaded "
          f"in {drawn['load_s']:.2f} s")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(tensor.nmodes) as pool:
        plans = list(pool.map(lambda m: ops.get_plan(tensor, m), range(tensor.nmodes)))
    host_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in plans:
        ops.plan_device_buffers(p, dev)
    ops.tensor_device_operands(tensor, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    split_ctas = kmod.split_slices(tensor.nmodes, 1, torch.float32, dev) // kmod.SPLIT_WARPS_PER_CTA
    for p in plans:
        bufs = ops.plan_device_buffers(p, dev)
        largest = int((bufs.block_real_end - bufs.block_nnz_start[:-1]).max())
        hottest = int(np.bincount(tensor.indices[:, p.mode]).max())
        print(f"  plan mode {p.mode}: {p.num_blocks} output blocks (the block kernel's CTAs for "
              f"one restart), nnz_pad {p.nnz_pad}, padding overhead {p.padding_overhead:.6f}; "
              f"largest block {largest / tensor.nnz:.4f} of nnz ({largest * p.num_blocks / tensor.nnz:.2f}x "
              f"the mean), hottest row {hottest / tensor.nnz:.4f} of nnz; split kernel {split_ctas} "
              f"CTAs x {kmod.SPLIT_WARPS_PER_CTA} slices of {p.nnz_pad / (split_ctas * kmod.SPLIT_WARPS_PER_CTA):.0f} "
              f"nonzeros")
    print(f"  host: plans {host_plan_s:.2f} s (3 threads), upload {upload_s:.2f} s")

    fused_tol = tfused.FUSED_FIT_TOL
    expected = SWEEPS * tensor.nmodes
    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    eager = tcp.cp_als(tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0,
                                  impl="kernel", device=dev)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches = kmod.mttkrp_cuda.launches
    t0 = time.perf_counter()
    fused = tfused.cp_als_fused(
        tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, restarts=RESTARTS, fit_every=SWEEPS,
        impl="kernel", device=dev)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    main_launches = kmod.mttkrp_cuda.launches  # the main path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  eager cp_als: fits {eager.fits}")
    print(f"  eager: {eager_s:.3f} s for {SWEEPS} sweeps ({eager_s / SWEEPS * 1e3:.1f} ms/sweep "
          f"incl. per-sweep fit sync), kernel launches {eager_launches} (expected {expected})")
    for r in range(RESTARTS):
        print(f"  fused restart {r} (seed {fused.seeds[r]}): fits {[float(x) for x in fused.fits[r]]}")
    print(f"  fused: {fused_s:.3f} s for {SWEEPS} sweeps x {RESTARTS} restarts "
          f"({fused_s / SWEEPS * 1e3:.1f} ms/sweep), {fused.sync_count} sync(s), kernel launches "
          f"{main_launches - eager_launches} (expected {expected})")
    print(f"  peak device memory {peak_gb:.2f} GB")
    check(eager_launches == expected, f"eager launched the kernel {eager_launches} times")
    check(main_launches - eager_launches == expected,
          f"fused launched the kernel {main_launches - eager_launches} times")
    print(f"  MTTKRP launches by variant over the main path: {by_variant}")
    check(by_variant["split"] == main_launches,
          f"the main path's MTTKRPs did not all take the split kernel: {by_variant}")
    check(np.isfinite(eager.fits).all() and np.isfinite(fused.fits).all(), "non-finite fit")
    check(all(f.shape == (s, RANK) and bool(torch.isfinite(f).all())
              for f, s in zip(eager.factors, tensor.shape)), "eager factors have the wrong shape or are not finite")
    gap = float(np.max(np.abs(np.array(eager.fits) - fused.fits[0])))
    print(f"  fused restart 0 vs eager (same seed): max fit gap {gap:.3e} (tol {fused_tol})")
    check(gap <= fused_tol, f"fused restart 0 differs from eager by {gap}")

    # -- phase 4: per-mode kernel against plain, and times -------------------
    phase("phase 4: per-mode MTTKRP at the main path's shapes "
          f"(B=1: eager's final factors; B={RESTARTS}: the fused run's initial factors, "
          f"one draw per restart; kernels median of {TIMING_REPS})")
    facs = [f.contiguous() for f in eager.factors]
    inits = [tcp.cp_init(tensor, RANK, seed=s, device=dev) for s in range(RESTARTS)]
    batched = [torch.stack(per_mode).contiguous() for per_mode in zip(*inits)]
    del inits
    rows = []
    for p in plans:
        bufs = ops.plan_device_buffers(p, dev)
        i_out = p.shape[p.mode]
        got = kmod.mttkrp_cuda(bufs, facs, p.mode, i_out)
        got_b = kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)
        same = (torch.equal(got, kmod.mttkrp_cuda(bufs, facs, p.mode, i_out))
                and torch.equal(got_b, kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)))
        torch.cuda.synchronize()
        max_abs, max_rel, ok = compare(bufs, facs, p.mode, i_out, got, F32_TOL)
        check(got_b.shape == (RESTARTS, i_out, RANK), f"batched output shape {tuple(got_b.shape)}")
        max_abs_b, max_rel_b, ok_b = compare(bufs, batched, p.mode, i_out, got_b, F32_TOL)
        del got, got_b
        ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out), TIMING_REPS)
        ms_b = median_ms(lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out), TIMING_REPS)
        block = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out, variant="block"),
                          TIMING_REPS)
        block_b = median_ms(
            lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out, variant="block"), TIMING_REPS)
        plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, p.mode, i_out), TIMING_REPS, 1)
        nbytes, flops = mttkrp_bytes(p, RANK, tensor.nnz), mttkrp_flops(p, RANK, tensor.nnz)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        rows.append(dict(mode=p.mode, ms=ms, ms_b4=ms_b, block_ms=block, block_ms_b4=block_b,
                         plain_ms=plain, bound_ms=bound, bytes=nbytes, flops=flops,
                         max_abs=max(max_abs, max_abs_b), ok=ok and ok_b, same=same))
        print(f"  mode {p.mode}: split {ms:.3f} ms (B={RESTARTS}: {ms_b:.3f} ms), block {block:.3f} ms "
              f"(B={RESTARTS}: {block_b:.3f} ms), plain {plain:.3f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), share of bound {bound / ms:.4f} "
              f"(block {bound / block:.4f}), block / split {block / ms:.2f}x; B=1 max_abs "
              f"{max_abs:.3e} max_rel {max_rel:.3e} {'ok' if ok else 'FAIL'}, B={RESTARTS} "
              f"max_abs {max_abs_b:.3e} max_rel {max_rel_b:.3e} {'ok' if ok_b else 'FAIL'} "
              f"(tol {F32_TOL:g} x scale); two launches bit for bit "
              f"{'equal' if same else 'DIFFER'}  [{card}]")
    check(all(r["ok"] for r in rows), "kernel disagrees with its plain version at full size")
    check(all(r["same"] for r in rows), "two launches of the split kernel differ")
    del batched
    bytes_bound = all(r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS_PER_S for r in rows)

    # -- phase 5: where the time of a sweep goes --------------------------------
    phase("phase 5: profile of one eager sweep")
    profile_sweep(tensor, dev, eager_s / SWEEPS * 1e3)
    print(f"  host: data {host_data_s:.1f} s, plans {host_plan_s:.1f} s")
    kern = dict(
        name="mttkrp_split_kernel",
        route="cuda",
        source="src/repro_torch/kernels/mttkrp/csrc/mttkrp_split.cu",
        replaces="src/repro/kernels/mttkrp/kernel.py:44",
        launches=main_launches,
        max_abs_err=max(r["max_abs"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        previous_ms=sum(r["block_ms"] for r in rows),
        previous="mttkrp_block_kernel, csrc/mttkrp.cu (one CTA per output block)",
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by="bytes" if bytes_bound else "operations",
        library_ms=None,
        per="one CP-ALS sweep of MTTKRPs: modes 0-2, one restart",
        per_mode_ms=[r["ms"] for r in rows],
        per_mode_ms_b4=[r["ms_b4"] for r in rows],
        per_mode_previous_ms=[r["block_ms"] for r in rows],
        per_mode_previous_ms_b4=[r["block_ms_b4"] for r in rows],
        split_ctas=split_ctas,
        launches_by_variant=by_variant,
    )
    return kern, tensor, fused.fits, np.asarray(eager.fits)


ORDERINGS = ("lex", "secondary-sort", "degree", "blocked")
# Phase 10 runs blocked right after lex (whose plans are phase 3's), so
# that the tile mode's profile on blocked plans is the phase's only one
# and comes before the other orderings' plan builds.
PHASE10_ORDER = ("lex", "blocked", "secondary-sort", "degree")


def device_ms_by_kernel(fn, launches: int, tries: int = 3) -> dict:
    """Device ms and launch count by kernel in one call of ``fn``
    (torch.profiler), keyed "carry" for the carry pass and "main" for the
    rest.  Within this script the profiler has recorded fewer launches than
    ``fn`` made (PERF.md §7), so the call is profiled again, up to ``tries``
    times, until each kernel shows ``launches``; the last reading is
    returned either way, its counts beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                key = "carry" if "carry" in e.key else "main"
                ms, n = out.get(key, (0.0, 0))
                out[key] = (ms + e.self_device_time_total / 1e3, n + e.count)
        if set(out) == {"main", "carry"} and all(n == launches for _, n in out.values()):
            break
    return {k: dict(ms=ms, launches=n) for k, (ms, n) in out.items()}


def ordering_phase(dev, card: str, tensor, lex_fits: np.ndarray) -> dict:
    """Phase 10: each nonzero ordering at NELL-2 Table II size, phase 3's
    tensor.  Per ordering: the ordered plans (the order sorted on the card,
    held array-equal to the CPU's on mode 0), their contiguity flag, each
    mode's split kernel (in the mode its plan picks) against the plain
    version with a bit-for-bit repeat, at B=1 and at B=RESTARTS (the fused
    run's initial factors, as phase 4), the times of the split kernel in
    both modes, the block kernel and the plain version beside the bound,
    and a fused CP-ALS run whose fits must stay within FUSED_FIT_TOL of
    phase 3's lex run.  On the blocked plans, one profiled sweep splits the
    tile mode's time between its two launches.  Each ordering's plans are
    freed before the next."""
    phase(f"phase 10: the orderings {ORDERINGS} at NELL-2 Table II size, rank {RANK}")
    grids = {}
    for batch in (1, RESTARTS):
        g = kmod.tile_grid(tensor.nmodes, 256, torch.float32, dev, batch=batch)
        grids[f"B={batch}"] = g._asdict()
        print(f"  tile mode at B={batch}: {g.ctas} CTAs (slices) x {g.warps} warps, "
              f"{g.warps_per_sm} warps per SM, {g.b_pass} restart(s) a pass, {g.smem_bytes} "
              f"bytes of shared memory per CTA")
    print(f"  row-run mode: {kmod.split_slices(tensor.nmodes, 1, torch.float32, dev)} slices")
    idx_dev = torch.as_tensor(tensor.indices, device=dev)
    results, launches = {}, collections.Counter()
    for o in PHASE10_ORDER:
        t_start = time.perf_counter()
        if o != "lex":  # lex keeps phase 3's plans (its host argsort), memoized
            ops.clear_caches()
            gc.collect()
        # The order on the card, timed by CUDA events, then held against the CPU's.
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        orders = [tstrat.nonzero_order_tensor(idx_dev, tensor.shape, m, o)
                  for m in range(tensor.nmodes)]
        end.record()
        end.synchronize()
        order_ms = start.elapsed_time(end)
        t0 = time.perf_counter()
        on_cpu = tstrat.nonzero_order(tensor, 0, o, device="cpu")
        cpu_order_s = time.perf_counter() - t0
        same_order = bool(np.array_equal(orders[0].cpu().numpy(), on_cpu))
        del orders, on_cpu
        t0 = time.perf_counter()
        with ThreadPoolExecutor(tensor.nmodes) as pool:
            plans = list(pool.map(lambda m: ops.get_plan(tensor, m, ordering=o, device=dev),
                                  range(tensor.nmodes)))
        bufs_all = [ops.plan_device_buffers(p, dev) for p in plans]
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        print(f"  {o}: order on the card {order_ms:.2f} ms device for 3 modes (mode 0 array-equal "
              f"to the CPU's: {same_order}, CPU {cpu_order_s:.2f} s); plans + upload "
              f"{plan_s:.2f} s host{' (phase 3 memo)' if o == 'lex' else ''}; rows contiguous "
              f"{[p.rows_contiguous for p in plans]}; padding overhead "
              f"{[round(p.padding_overhead, 6) for p in plans]}")
        check(same_order, f"{o}: the card's order differs from the CPU's")
        facs = tcp.cp_init(tensor, RANK, seed=7, device=dev)
        inits = [tcp.cp_init(tensor, RANK, seed=s, device=dev) for s in range(RESTARTS)]
        batched = [torch.stack(per_mode).contiguous() for per_mode in zip(*inits)]
        del inits
        rows = []
        for p, bufs in zip(plans, bufs_all):
            i_out = p.shape[p.mode]
            mode_name = kmod.split_mode_for(bufs, None)
            got = kmod.mttkrp_cuda(bufs, facs, p.mode, i_out)
            got_b = kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)
            same = (torch.equal(got, kmod.mttkrp_cuda(bufs, facs, p.mode, i_out))
                    and torch.equal(got_b, kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)))
            torch.cuda.synchronize()
            max_abs, max_rel, ok = compare(bufs, facs, p.mode, i_out, got, F32_TOL)
            check(got_b.shape == (RESTARTS, i_out, RANK), f"batched output shape {tuple(got_b.shape)}")
            max_abs_b, max_rel_b, ok_b = compare(bufs, batched, p.mode, i_out, got_b, F32_TOL)
            del got, got_b
            ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out), TIMING_REPS)
            ms_b = median_ms(lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out), TIMING_REPS)
            tiles = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out,
                                                       split_mode="tiles"), TIMING_REPS)
            block = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out, variant="block"),
                              TIMING_REPS)
            plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, p.mode, i_out), TIMING_REPS, 1)
            nbytes, flops = mttkrp_bytes(p, RANK, tensor.nnz), mttkrp_flops(p, RANK, tensor.nnz)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
            # B restarts: the stream once, factors, output and flops B times.
            bound_b = max(mttkrp_bytes(p, RANK * RESTARTS, tensor.nnz) / HBM_BYTES_PER_S,
                          RESTARTS * flops / F32_FLOPS_PER_S) * 1e3
            rows.append(dict(mode=p.mode, split_mode=mode_name, ms=ms, ms_b4=ms_b, tiles_ms=tiles,
                             block_ms=block, plain_ms=plain, bound_ms=bound, bound_ms_b4=bound_b,
                             max_abs=max(max_abs, max_abs_b), ok=ok and ok_b, same=same))
            print(f"    mode {p.mode}: split ({mode_name}) {ms:.3f} ms (B={RESTARTS}: {ms_b:.3f} ms), "
                  f"tile mode {tiles:.3f} ms, block {block:.3f} ms, plain {plain:.3f} ms, bound "
                  f"{bound:.4f} ms (share {bound / ms:.4f}; B={RESTARTS}: {bound_b:.4f} ms, share "
                  f"{bound_b / ms_b:.4f}); B=1 max_abs {max_abs:.3e} max_rel "
                  f"{max_rel:.3e} {'ok' if ok else 'FAIL'}, B={RESTARTS} max_abs {max_abs_b:.3e} "
                  f"max_rel {max_rel_b:.3e} {'ok' if ok_b else 'FAIL'} (tol {F32_TOL:g} x scale); "
                  f"two launches bit for bit {'equal' if same else 'DIFFER'}  [{card}]")
        contracts = []
        if o in ("lex", "blocked"):  # phase 15's Table II part, on these plans and factors
            phase(f"phase 15 (Table II part, run in phase 10): the audit build on the {o} plans, "
                  f"B=1 and B={RESTARTS}")
            contracts = [audit_plan(b, fs, p.mode, p.shape[p.mode], tensor.nnz,
                                    f"NELL-2 Table II, {o}", card)
                         for p, b in zip(plans, bufs_all) for fs in (facs, batched)]
        tile_split = {}
        if o == "blocked":  # the tile mode's two launches apart, one sweep at B=1 and at B=4
            for batch, fs in ((1, facs), (RESTARTS, batched)):
                split = tile_split[f"B={batch}"] = device_ms_by_kernel(lambda: [
                    kmod.mttkrp_cuda(b, fs, p.mode, p.shape[p.mode])
                    for p, b in zip(plans, bufs_all)], launches=len(plans))
                print(f"    profile of one B={batch} sweep in the tile mode ({len(plans)} launches "
                      f"of each): " + (", ".join(
                          f"{k} {v['ms']:.3f} ms over {v['launches']} recorded launches"
                          for k, v in split.items()) or "not measured") + f"  [{card}]")
        del facs, batched
        check(all(r["ok"] for r in rows), f"{o}: the split kernel disagrees with plain")
        check(all(r["same"] for r in rows), f"{o}: two launches of the split kernel differ")
        # The path: fused CP-ALS with this ordering, launches counted.
        kmod.reset_launch_counts()
        t0 = time.perf_counter()
        run = tfused.cp_als_fused(tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, restarts=RESTARTS,
                                  fit_every=SWEEPS, impl="kernel", device=dev, ordering=o)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
        by_mode = dict(kmod.mttkrp_cuda.launches_by_mode)
        gap = float(np.max(np.abs(run.fits - lex_fits)))
        want_mode = "tiles" if o == "blocked" else "rows"
        print(f"    cp_als_fused(ordering={o!r}, restarts={RESTARTS}, impl='kernel'): {fused_s:.3f} s "
              f"for {SWEEPS} sweeps, final fits {[round(float(f), 6) for f in run.fits[:, -1]]}, "
              f"max gap to phase 3's lex fits {gap:.3e} (tol {tfused.FUSED_FIT_TOL}); launches by "
              f"variant {by_variant}, by mode {by_mode}")
        check(np.isfinite(run.fits).all() and gap <= tfused.FUSED_FIT_TOL,
              f"{o}: fused fits differ from lex by {gap}")
        expected = SWEEPS * tensor.nmodes
        check(by_variant == {"split": expected, "block": 0} and by_mode[want_mode] == expected,
              f"{o}: the path's MTTKRPs did not all take the split kernel's {want_mode} mode")
        launches[want_mode] += expected
        results[o] = dict(rows=rows, order_ms=order_ms, plan_s=plan_s, fused_s=fused_s,
                          fit_gap=gap, launches_by_mode=by_mode, tile_split_ms=tile_split,
                          contracts=contracts,
                          rows_contiguous=[p.rows_contiguous for p in plans],
                          padding_overhead=[p.padding_overhead for p in plans],
                          seconds=time.perf_counter() - t_start)
        del plans, bufs_all, run
    ops.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(results=results, launches=dict(launches), tile_grid=grids)


def flash_inputs(dev):
    """Phase 6's input sets: (name, q, k, v, causal)."""
    for dtype, s, causal, (h, kvh), d, b in itertools.product(
            (torch.float32, torch.bfloat16), FLASH_SEQS, (True, False),
            ((4, 4), (4, 2), (4, 1), (16, 8)), (64, 128), (1, 3)):
        gen = torch.Generator(device=dev).manual_seed(s * 7 + h + d + b)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        yield f"{dtype} S={s} causal={causal} H={h} KV={kvh} D={d} B={b}", q, k, v, causal
    # q, k, v as views of one fused projection: strided rows, q not contiguous.
    for s, causal, d in itertools.product((129, 1000), (True, False), (64, 128)):
        gen = torch.Generator(device=dev).manual_seed(s + d)
        fused = torch.randn((2, s, 16 + 2 * 8, d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = fused[:, :, :16], fused[:, :, 16:24], fused[:, :, 24:]
        check(not q.is_contiguous(), "the strided case's q is contiguous")
        yield f"strided bf16 S={s} causal={causal} H=16 KV=8 D={d} B=2", q, k, v, causal
    # Cross-attention: S_q queries against S_kv keys of their own, not causal.
    for dtype, (s, skv), (h, kvh), d in itertools.product(
            (torch.float32, torch.bfloat16), FLASH_CROSS_SEQS, ((8, 8), (16, 8)), (64, 128)):
        gen = torch.Generator(device=dev).manual_seed(s * 3 + skv + h + d)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((2, s, h, d), (2, skv, kvh, d), (2, skv, kvh, d)))
        yield f"{dtype} S={s} S_kv={skv} causal=False H={h} KV={kvh} D={d} B=2", q, k, v, False


def flash_cases(dev) -> None:
    """Phase 6: each flash kernel against its plain version over edge shapes."""
    failures, worst, worst_row, count = [], {}, {}, {}
    for name, q, k, v, causal in flash_inputs(dev):
        tol = FLASH_F32_TOL if q.dtype == torch.float32 else BF16_TOL
        want = flash_attention_plain(q, k, v, causal=causal)
        routed = fkmod.variant_for(q.dtype, q.shape[3])
        for variant in (routed, "mma") if q.dtype == torch.bfloat16 else (routed,):
            got = fkmod.flash_attention_cuda(q, k, v, causal=causal, variant=variant)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            row_err = max_row_error(got, want)
            ok = (bool((diff <= tol + tol * want.float().abs()).all()) and got.shape == q.shape
                  and row_err <= FLASH_ROW_TOL[q.dtype])
            worst[variant] = max(worst.get(variant, 0.0), float(diff.max()))
            worst_row[variant] = max(worst_row.get(variant, 0.0), row_err)
            count[variant] = count.get(variant, 0) + 1
            if not ok:
                failures.append(f"{variant}: {name}")
    for variant, err in worst.items():
        dtype = torch.float32 if variant == "f32" else torch.bfloat16
        print(f"  {variant} kernel ({dtype}): {count[variant]} cases, max row error "
              f"{worst_row[variant]:.3e} (tol {FLASH_ROW_TOL[dtype]:g}), max |kernel - plain| "
              f"{err:.3e} (tol {FLASH_F32_TOL if variant == 'f32' else BF16_TOL:g} abs + rel)")
    check(not failures, f"flash kernels disagree with their plain version: {failures[:10]}")


def first_key_tile_dropped(q, k, v, rows: int, tile: int = 64) -> torch.Tensor:
    """The plain causal attention of the last ``rows`` queries with keys
    ``[0, tile)`` left out: what a kernel whose KV loop skipped its first
    tile would write for them.  (B, rows, H, D) in q's dtype."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    ks, vs = (t[:, tile:].float().repeat_interleave(group, dim=2) for t in (k, v))
    scores = torch.einsum("brhd,bshd->bhrs", q[:, s - rows:].float(), ks) * d**-0.5
    qpos = torch.arange(s - rows, s, device=q.device)
    kpos = torch.arange(tile, s, device=q.device)
    scores.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    return torch.einsum("bhrs,bshd->brhd", torch.softmax(scores, dim=-1), vs).to(q.dtype)


def flash_full_shape_check(q, k, v) -> dict:
    """Phase 8's comparison: both bf16 kernels on the main path's q, k, v
    against their plain version by the row limit and by the JAX tests'
    elementwise one, then the same readings of two planted faults in the
    wgmma kernel's output, which the row limit must reject: rows t >= S/2
    scaled by 0.9, and the last 64 rows computed without the first 64 keys."""
    got = fkmod.flash_attention_cuda(q, k, v, causal=True)
    previous = fkmod.flash_attention_cuda(q, k, v, causal=True, variant="mma")
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True, q_chunk=PLAIN_Q_CHUNK)
    s = q.shape[1]

    def readings(out):
        diff = (out.float() - want.float()).abs()
        within = bool((diff <= BF16_TOL + BF16_TOL * want.float().abs()).all())
        return dict(max_abs=float(diff.max()), row=max_row_error(out, want), elementwise_ok=within)

    sound, sound_previous = readings(got), readings(previous)
    del previous
    scaled = got.clone()
    scaled[:, s // 2:] *= 0.9
    skipped = got.clone()
    skipped[:, s - 64:] = first_key_tile_dropped(q, k, v, 64)
    rms = {f"rows {a}-{z - 1}": float(want[:, a:z].float().pow(2).mean().sqrt())
           for a, z in ((0, 64), (s - 1024, s))}
    return dict(sound=sound, sound_previous=sound_previous, rms=rms, planted={
        "rows t >= S/2 scaled by 0.9": readings(scaled),
        "last 64 rows without the first 64 keys": readings(skipped)})


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> int:
    """Two products of 2*D flops per (query, key) pair the inputs need: for
    causal attention only the triangle, S(S+1)/2 pairs per (b, h)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * d * pairs * b * h


def prefill_matmul_flops(cfg, tokens: int) -> int:
    """The products outside the kernel per prefill: q/k/v and output
    projections, SwiGLU's three, and the lm_head over every position."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (2 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                 + 2 * cfg.num_heads * hd * d + 6 * d * cfg.d_ff)
    return tokens * (cfg.num_layers * per_layer + 2 * d * cfg.padded_vocab)


def logits_gap(got: torch.Tensor, want: torch.Tensor, vocab: int):
    """(max |got - want|, max |want|) over the real vocabulary (padded
    entries are both -1e9, where one bf16 ulp is 4e6)."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max()), float(want.abs().max())


def profile_prefill(prefill, model, batch, prefill_ms: float, matmul_flops: int | None) -> dict:
    """Device time of one prefill by kernel class, and the idle share of
    ``prefill_ms`` (the unprofiled median); ``matmul_flops`` (None: not
    printed) gives the products' rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(model, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes = {"flash": 0.0, "matmul (cuBLAS)": 0.0, "rest": 0.0}
    for e in events:
        name = e.key.lower()
        if "flash_fwd" in name:
            key = "flash"
        elif "_scan_kernel" in name:  # the recurrence kernels (phase 17)
            key = "scan"
            classes.setdefault(key, 0.0)
        elif any(t in name for t in ("gemm", "sm90_", "cutlass", "nvjet", "xmma")):
            key = "matmul (cuBLAS)"
        else:
            key = "rest"
        classes[key] += e.self_device_time_total / 1e3
    busy = sum(classes.values())
    print(f"  one prefill: device busy {busy:.2f} ms (profiler) of {prefill_ms:.2f} ms wall "
          f"(unprofiled), idle share {max(0.0, 1 - busy / prefill_ms):.3f}")
    for key, ms in classes.items():
        print(f"    {key:<16} {ms:10.2f} ms  {ms / busy:6.1%} of device time")
    if matmul_flops is not None:
        print(f"    matmul rate: {matmul_flops:.3e} flops per prefill, "
              f"{matmul_flops / classes['matmul (cuBLAS)'] / 1e9:.1f} TFLOP/s")
    for e in events[:10]:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5} {e.key[:90]}")
    return dict(busy_ms=busy, **{k.split()[0] + "_ms": v for k, v in classes.items()})


def lm_phases(dev, card: str) -> dict:
    """Phases 6-8: the flash kernels' edge cases, the internlm2-1.8b prefill at
    full width and depth, and both bf16 kernels at the main path's shape; the
    wgmma flash kernel's entry of the ``kernels`` line."""
    phase("phase 6: flash kernels vs plain version on the card")
    flash_cases(dev)

    phase(f"phase 7: {ARCH} prefill, full width and depth, B={PREFILL_BATCH} S={PREFILL_SEQ}")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  init_model(seed=0): {cfg.param_count() / 1e9:.3f}e9 parameters (param_count), "
          f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB "
          f"float32, {time.perf_counter() - t0:.2f} s")
    stream = SyntheticLMStream(cfg.vocab_size, PREFILL_SEQ, PREFILL_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(next(stream)["tokens"]).to(dev)}
    prefill = make_prefill_fn(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, walls = [], []
    fkmod.reset_launch_counts()  # the main path starts here
    for rep in range(1 + PREFILL_REPS):
        before = fkmod.flash_attention_cuda.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = prefill(model, batch)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        grew = fkmod.flash_attention_cuda.launches - before
        check(grew == cfg.num_layers, f"prefill {rep} launched the flash kernel {grew} times")
        if rep:
            times.append(start.elapsed_time(end))
            walls.append(wall)
    main_launches = fkmod.flash_attention_cuda.launches  # the main path ends here
    by_variant = dict(fkmod.flash_attention_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = float(np.median(times))
    held_weights = sum(p.numel() * p.element_size() for p in model.parameters())
    held_tokens = batch["tokens"].numel() * batch["tokens"].element_size()
    tokens = PREFILL_BATCH * PREFILL_SEQ
    check(logits.shape == (PREFILL_BATCH, cfg.padded_vocab), f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite next-token logits")
    check(bool((logits[:, cfg.vocab_size:] < -1e8).all()), "padded vocabulary not masked")
    print(f"  prefill: median {prefill_ms:.2f} ms (CUDA events; runs {[round(t, 2) for t in times]}), "
          f"host wall {[round(w, 2) for w in walls]} ms, {tokens / prefill_ms * 1e3:.0f} tokens/s; "
          f"flash launches {main_launches} over {1 + PREFILL_REPS} prefills "
          f"({cfg.num_layers} each); peak device memory {peak_gb:.2f} GB  [{card}]")
    per_prefill = {k_: n / (1 + PREFILL_REPS) for k_, n in by_variant.items()}
    print(f"  flash launches per prefill by variant: {per_prefill}")
    check(by_variant["wgmma"] == main_launches,
          f"the prefill's flash launches did not all take the wgmma kernel: {by_variant}")
    print(f"  next-token argmax {logits.float().argmax(-1).tolist()}, "
          f"max |logit| {float(logits[:, :cfg.vocab_size].float().abs().max()):.3f}")
    del logits

    # The same model at S = 256: the kernel (blocked) against plain torch (dense).
    short = {"tokens": torch.from_numpy(next(SyntheticLMStream(cfg.vocab_size, 256, 2, seed=1))
                                        ["tokens"]).to(dev)}
    with torch.inference_mode():
        blocked = forward(model, dataclasses.replace(cfg, attention_impl="blocked"), short)
        dense = forward(model, dataclasses.replace(cfg, attention_impl="dense"), short)
    gap, scale = logits_gap(blocked, dense, cfg.vocab_size)
    print(f"  S=256 full model, blocked (kernel) vs dense (plain torch): max |gap| {gap:.4f} "
          f"of max |logit| {scale:.3f} (tol {BF16_SCALE_TOL} x scale)")
    check(gap <= BF16_SCALE_TOL * scale, "blocked and dense logits differ at S=256")
    del blocked, dense

    # A reduced config: the port's forward on the card against the CPU.
    for dtype, tol in ((torch.float32, None), (torch.bfloat16, BF16_SCALE_TOL)):
        small = reduced_config(ARCH, num_kv_heads=2, attention_impl="blocked", dtype=dtype)
        small_model = init_model(small, seed=1, device="cpu")
        toks = {"tokens": next(SyntheticLMStream(small.vocab_size, 300, 2, seed=2))["tokens"]}
        with torch.inference_mode():
            want = forward(small_model, small, toks)
            got = forward(small_model.to(dev), small, toks).cpu()  # moves the module
        gap, scale = logits_gap(got, want, small.vocab_size)
        limit = LOGITS_F32_TOL if tol is None else tol * scale
        print(f"  reduced config {dtype}: card vs CPU max |gap| {gap:.3e} of max |logit| "
              f"{scale:.3f} (limit {limit:.3e})")
        check(gap <= limit, f"reduced-config forward in {dtype}: card differs from CPU")

    phase("phase 8: the bf16 flash kernels at the main path's shape (layer 0's q, k, v)")
    layer = model.layers[0]
    with torch.inference_mode():
        x = model.embed[batch["tokens"].long()].to(cfg.dtype)
        q, k, v = project_qkv(layer.attn.params(), cfg, layer.ln1(x, cfg.norm_eps))
    del x
    b, s, h, d = q.shape
    found = flash_full_shape_check(q, k, v)
    row_tol = FLASH_ROW_TOL[q.dtype]
    for label, sound in (("wgmma", found["sound"]), ("mma", found["sound_previous"])):
        ok = sound["row"] <= row_tol and sound["elementwise_ok"]
        print(f"  {label} kernel: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}, over all (b, h): "
              f"max row error {sound['row']:.3e} (tol {row_tol:g}), max |kernel - plain| "
              f"{sound['max_abs']:.3e} (tol {BF16_TOL:g} abs + rel: "
              f"{'ok' if sound['elementwise_ok'] else 'FAIL'}) {'ok' if ok else 'FAIL'}")
        check(ok, f"the {label} flash kernel disagrees with its plain version at the main path's shape")
    sound = found["sound"]
    print("  rms of the plain output: " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in found["rms"].items()))
    for fault, r in found["planted"].items():
        print(f"  planted fault in the wgmma kernel's output, {fault}: max row error {r['row']:.3e} "
              f"({'rejected' if r['row'] > row_tol else 'NOT rejected'}); the elementwise "
              f"tol alone would {'pass' if r['elementwise_ok'] else 'reject'} it")
        check(r["row"] > row_tol, f"the row limit does not reject a planted fault: {fault}")
    ms = median_ms(lambda: fkmod.flash_attention_cuda(q, k, v, causal=True), FLASH_REPS)
    previous_ms = median_ms(
        lambda: fkmod.flash_attention_cuda(q, k, v, causal=True, variant="mma"), FLASH_REPS)
    plain_ms = median_ms(
        lambda: flash_attention_plain(q, k, v, causal=True, q_chunk=PLAIN_Q_CHUNK), 3, 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), FLASH_REPS)
    flops = attention_flops(b, s, h, d, True)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"  wgmma kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), mma.sync kernel "
          f"{previous_ms:.3f} ms ({flops / previous_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.1f} ms, "
          f"SDPA {library_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} ({flops:.3e} flops "
          f"at 989 TFLOP/s, {nbytes / 1e9:.3f} GB at 3.35 TB/s), share of bound "
          f"{bound_ms / ms:.3f} (mma.sync {bound_ms / previous_ms:.3f})  [{card}]")
    check(ms < previous_ms, f"the wgmma kernel ({ms:.3f} ms) is not faster than mma.sync "
                            f"({previous_ms:.3f} ms)")
    del q, k, v, qt, kt, vt
    prof = profile_prefill(prefill, model, batch, prefill_ms,
                           prefill_matmul_flops(cfg, PREFILL_BATCH * PREFILL_SEQ))
    return dict(
        name="flash_fwd_sm90_kernel",
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:24",
        launches=main_launches,
        max_abs_err=sound["max_abs"],
        max_row_err=sound["row"],
        ms=ms,
        previous_ms=previous_ms,
        previous="flash_fwd_bf16_kernel, csrc/flash_attention.cu (mma.sync)",
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=library_ms,
        per=f"one layer's causal attention, B={b} S={s} H={h} KV={cfg.num_kv_heads} D={d} bf16",
        launches_per_prefill=cfg.num_layers,
        launches_by_variant=by_variant,
        prefill_ms=prefill_ms,
        prefill_tokens_per_s=tokens / prefill_ms * 1e3,
        prefill_peak_gb=peak_gb,
        prefill_peak_bytes=peak_gb * 1e9,
        prefill_held_bytes=dict(weights=held_weights, tokens=held_tokens),
        prefill_profile_ms=prof,
    )


def service_summary(svc, wall_s: float) -> dict:
    """Requests/s, latency percentiles and batches of one service run."""
    resps = list(svc.completed.values())
    batches = collections.Counter((r.dispatch_t, r.signature) for r in resps)
    summary = {key: svc.metrics.summary(key) for key in ("latency_s", "queue_wait_s", "service_s")}
    return dict(requests=len(resps), wall_s=wall_s, requests_per_s=len(resps) / wall_s,
                batches=len(batches), batch_sizes=sorted(batches.values(), reverse=True),
                max_queue_depth=max(svc.metrics.values("queue_depth")),
                **{f"{k[:-2]}_{stat}_ms": v[stat] * 1e3 for k, v in summary.items()
                   for stat in ("p50", "p99")})


def profile_batch(executor, members, batch_ms: float) -> dict:
    """Device time of one batch by kernel class: its staging (uploads and the
    stacked plans' build) and its ``run_batch``; the idle share is of
    ``batch_ms``, the unprofiled wall time of both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_stage:
        *operands, plans = executor.stage(members, pad_to=SERVE_MAX_BATCH)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        executor.core.run_batch(*operands, n_iters=executor.signature.n_iters, plans=plans)
        torch.cuda.synchronize()
    stage_events = [e for e in prof_stage.key_averages() if e.device_type == DeviceType.CUDA]
    stage_ms = {"uploads (memcpy HtoD)": 0.0, "plan build (sort, scatter, rest)": 0.0}
    for e in stage_events:
        key = "uploads (memcpy HtoD)" if "memcpy" in e.key.lower() else \
            "plan build (sort, scatter, rest)"
        stage_ms[key] += e.self_device_time_total / 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes = {"split kernel": 0.0, "carry pass": 0.0, "fit gathers": 0.0,
               "products (mul, GEMM/GEMV)": 0.0, "solves": 0.0, "rest": 0.0}
    for e in events:
        name = e.key.lower()
        if "mttkrp_split_kernel" in name:
            key = "split kernel"
        elif "mttkrp_carry_kernel" in name:
            key = "carry pass"
        elif "index" in name or "gather" in name:
            key = "fit gathers"
        elif any(t in name for t in ("getrf", "getrs", "trsm", "lu_", "laswp", "solve", "magma",
                                     "cusolver", "batch_")):
            key = "solves"
        elif any(t in name for t in ("mulfunctor", "gemm", "gemv", "dot", "nvjet", "sm90_",
                                     "cutlass")):
            key = "products (mul, GEMM/GEMV)"
        else:
            key = "rest"
        classes[key] += e.self_device_time_total / 1e3
    classes = {**{f"staging: {k}": v for k, v in stage_ms.items()}, **classes}
    busy = sum(classes.values())
    print(f"  one batch, staged and run (B={SERVE_MAX_BATCH}, {executor.signature.n_iters} "
          f"sweeps): device busy {busy:.2f} ms (profiler) of {batch_ms:.2f} ms wall "
          f"(unprofiled), idle share {max(0.0, 1 - busy / batch_ms):.3f}")
    for key, ms in classes.items():
        print(f"    {key:<40} {ms:9.3f} ms  {ms / busy:6.1%} of device time")
    stage_events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for label, evs in (("staging", stage_events[:6]), ("run_batch", events[:12])):
        for e in evs:
            print(f"    {label:<9} {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
                  f"{e.key[:80]}")
    return dict(busy_ms=busy, **{k.split(" (")[0].replace("staging: ", "stage_")
                                 .replace(" ", "_") + "_ms": v for k, v in classes.items()})


def behind_a_sleep(fn, cycles: int = SLEEP_CYCLES):
    """Run ``fn`` behind ``cycles`` of queued device work (~0.5 s by
    default).  Returns ``(result, host ms of the call, whether the sleep had
    ended when it returned)``: a call that synchronises with the device
    returns only after the sleep."""
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    slept = torch.cuda.Event()
    slept.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ended = slept.query()
    torch.cuda.synchronize()
    return out, host_ms, ended


def host_waits(dev, dims) -> None:
    """Where the host waits for the device on the service's path: the ALS
    solve at a batch's shapes by PyTorch's default route and by the port's
    (``cp_als._solve``, which must never wait), and how many launches the
    launch queue takes before it blocks the host."""
    gen = torch.Generator().manual_seed(0)
    waits = {"default": [], "port": []}
    for rank in SERVE_TRAFFIC.ranks:
        for rows in sorted(set(dims)):
            f = torch.rand((SERVE_MAX_BATCH, 64, rank), generator=gen)
            a = (f.mT @ f + 1e-2 * torch.eye(rank)).to(dev)
            b = torch.randn((SERVE_MAX_BATCH, rank, rows), generator=gen).to(dev)
            routes = {"default": lambda: torch.linalg.solve_ex(a, b, check_errors=False),
                      "port": lambda: tcp._solve(a, b)}
            for route, fn in routes.items():
                fn()  # the first call loads the library
                if behind_a_sleep(fn, SLEEP_CYCLES // 5)[2]:
                    waits[route].append((rank, rows))
    print(f"  ALS solves of {SERVE_MAX_BATCH} systems (rank, right-hand sides) that waited for a "
          f"queued sleep: PyTorch's default route {waits['default']}, the port's {waits['port']}")
    check(not waits["port"], f"the port's solve waited for the device at {waits['port']}")
    x = torch.zeros(16, device=dev)
    queued = {}
    for n in (512, 1000, 1020, 1024, 1100):
        queued[n] = not behind_a_sleep(lambda: [x.add_(1.0) for _ in range(n)],
                                       SLEEP_CYCLES // 5)[2]
    print(f"  launch queue: n tiny kernels behind a sleep, did the host get back first? {queued}")


def service_phase(dev, card: str) -> dict:
    """Phase 9: the multi-tenant CP-ALS service at a real size; what it adds
    to the MTTKRP kernel's entry of the ``kernels`` line."""
    cfg = SERVE_TRAFFIC
    phase(f"phase 9: the CP-ALS service, {cfg.n_requests} requests, dims ~{cfg.base_dims} "
          f"(NELL-2 / 10), {cfg.nnz_range} drawn nonzeros, ranks {cfg.ranks}, "
          f"{cfg.n_iters} sweeps, max_batch {SERVE_MAX_BATCH}, max_inflight {SERVE_MAX_INFLIGHT}")
    t0 = time.perf_counter()
    trace = synthetic_trace(cfg)
    draw_s = time.perf_counter() - t0
    reqs = [r for _, r in trace]
    sigs = {r.request_id: bucket_signature(r) for r in reqs}
    nnz = [r.tensor.nnz for r in reqs]
    print(f"  trace: {len(reqs)} requests, {min(nnz)}-{max(nnz)} nonzeros after coalescing, "
          f"arrivals over {trace[-1][0] * 1e3:.1f} ms; host draw {draw_s:.2f} s")
    for sig, n in sorted(collections.Counter(sigs.values()).items()):
        print(f"  bucket dims {sig.dims} nnz_pad {sig.nnz_pad} rank_pad {sig.rank_pad} "
              f"n_iters {sig.n_iters}: {n} requests")

    # Off the clock: one batch per bucket through a throwaway service, so the
    # drain does not time the first use of each library kernel.  It leaves
    # nothing of its requests behind: the drain uploads and plans each anew.
    warm = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                                device=dev)
    for sig in set(sigs.values()):
        first = next(r for r in reqs if sigs[r.request_id] == sig)
        warm.submit(dataclasses.replace(first, request_id=first.request_id + "-warm"))
    warm.run_until_drained()

    # -- the main path: a closed-loop drain, then an open-loop replay ---------
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_counts()  # the main path starts here
    drain = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                                 device=dev)
    drained = [dataclasses.replace(r, request_id=f"{r.request_id}-d{k}")
               for k in range(SERVE_DRAIN_ROUNDS) for r in reqs]
    t0 = time.perf_counter()
    for r in drained:
        check(drain.submit(r), f"{r.request_id} refused")
    done = drain.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    replay_trace_ = [(a, dataclasses.replace(r, request_id=r.request_id + "-replay"))
                     for a, r in trace]
    replay = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                                  device=dev)
    t0 = time.perf_counter()
    replayed = replay_trace(replay, replay_trace_, time_scale=SERVE_REPLAY_SCALE)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = kmod.mttkrp_cuda.launches  # the main path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    runs = {"closed-loop drain": (drain, drain_s), f"replay at time_scale {SERVE_REPLAY_SCALE}":
            (replay, replay_s)}
    stats = {}
    for label, (svc, wall) in runs.items():
        st = stats[label] = service_summary(svc, wall)
        print(f"  {label}: {st['requests']} answered in {wall:.3f} s, "
              f"{st['requests_per_s']:.2f} requests/s; latency p50 {st['latency_p50_ms']:.1f} ms "
              f"p99 {st['latency_p99_ms']:.1f} ms, queue wait p50 {st['queue_wait_p50_ms']:.1f} "
              f"p99 {st['queue_wait_p99_ms']:.1f} ms, service p50 {st['service_p50_ms']:.1f} "
              f"p99 {st['service_p99_ms']:.1f} ms; {st['batches']} batches of "
              f"{st['batch_sizes']} real requests; max queue depth at a completion "
              f"{st['max_queue_depth']:.0f}  [{card}]")
    batches = sum(st["batches"] for st in stats.values())
    expected = batches * cfg.n_iters * len(cfg.base_dims)
    print(f"  MTTKRP launches over the service: {by_variant} (expected {expected} split = "
          f"{batches} batches x {cfg.n_iters} sweeps x {len(cfg.base_dims)} modes, 0 block); "
          f"peak device memory {peak_gb:.2f} GB")
    check(by_variant == {"split": expected, "block": 0} and launches == expected,
          f"the service's MTTKRPs were not one split launch per mode per sweep per batch: "
          f"{by_variant}")
    check(stats[f"replay at time_scale {SERVE_REPLAY_SCALE}"]["max_queue_depth"] >= 1,
          "the replay never found a queue: raise its arrival rate")

    # (d) every request answered once, pad slots dropped.
    for label, (svc, _) in runs.items():
        want = ({r.request_id for r in drained} if svc is drain
                else {r.request_id + "-replay" for r in reqs})
        check(set(svc.completed) == want and svc.metrics.total_logged == len(want),
              f"{label}: a request was dropped or answered twice")
        check(sum(stats[label]["batch_sizes"]) == len(want), f"{label}: pad slots answered")

    # (c) every response against a standalone cp_als_fused on the card.
    t0 = time.perf_counter()
    worst = 0.0
    for r in reqs:
        alone = tfused.cp_als_fused(r.tensor, r.rank, n_iters=cfg.n_iters, tol=0.0, seed=r.seed,
                                    impl="kernel", device=dev).fits[0]
        for resp in [done[f"{r.request_id}-d{k}"] for k in range(SERVE_DRAIN_ROUNDS)] + [
                replayed[r.request_id + "-replay"]]:
            st = resp.state
            check(len(st.fits) == cfg.n_iters and np.isfinite(st.fits).all(),
                  f"{resp.request_id}: fits {st.fits}")
            check([tuple(f.shape) for f in st.factors] == [(d, r.rank) for d in r.tensor.shape]
                  and tuple(st.weights.shape) == (r.rank,), f"{resp.request_id}: not trimmed")
            worst = max(worst, float(np.max(np.abs(np.array(st.fits) - alone))))
    print(f"  every response vs a standalone cp_als_fused(impl='kernel') on the card, same seed: "
          f"max fit gap {worst:.3e} over {(SERVE_DRAIN_ROUNDS + 1) * len(reqs)} responses "
          f"(tol {tfused.FUSED_FIT_TOL}), "
          f"{time.perf_counter() - t0:.1f} s")
    check(worst <= tfused.FUSED_FIT_TOL, f"a served response differs from cp_als_fused by {worst}")
    first = reqs[0]
    print(f"  {first.request_id}: rank {first.rank}, fits {done[first.request_id + '-d0'].state.fits}")

    # (a) one batch's stacked MTTKRP per mode, kernel against plain.
    sig = sigs[reqs[0].request_id]
    members = [r for r in reqs if sigs[r.request_id] == sig][:SERVE_MAX_BATCH]
    members += [members[0]] * (SERVE_MAX_BATCH - len(members))
    tensors = [r.tensor for r in members]
    facs = factors_on([SERVE_MAX_BATCH * d for d in sig.dims], sig.rank_pad, dev, seed=9)
    s_idx, s_val, _ = ops.stacked_operands(tensors, sig.dims, sig.nnz_pad, device=dev)
    rows, contracts = [], []
    for mode in range(sig.nmodes):
        bufs = ops.stacked_plan_buffers(s_idx, s_val, [t.nnz for t in tensors], sig.dims, mode)
        i_out = SERVE_MAX_BATCH * sig.dims[mode]
        got = kmod.mttkrp_cuda(bufs, facs, mode, i_out)
        same = torch.equal(got, kmod.mttkrp_cuda(bufs, facs, mode, i_out))
        torch.cuda.synchronize()
        max_abs, max_rel, ok = compare(bufs, facs, mode, i_out, got, F32_TOL)
        del got
        ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, mode, i_out), TIMING_REPS)
        plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, mode, i_out), TIMING_REPS, 1)
        nnz_pad, nblocks = int(bufs.values.shape[0]), int(bufs.block_real_end.shape[0])
        nbytes = (nnz_pad * 4 * (sig.nmodes + 1) + (nblocks + 1) * 8
                  + sum(SERVE_MAX_BATCH * d * sig.rank_pad * 4 for d in sig.dims))
        flops = nnz_pad * sig.rank_pad * (sig.nmodes + 1)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        rows.append(dict(ms=ms, plain_ms=plain, bound_ms=bound, max_abs=max_abs, ok=ok, same=same))
        contracts.append(audit_plan(bufs, facs, mode, i_out, sum(t.nnz for t in tensors),
                                    f"phase 15 on the service's stacked batch ({len(tensors)} "
                                    f"tenants)", card))
        print(f"  stacked MTTKRP mode {mode} (B={SERVE_MAX_BATCH}, rank_pad {sig.rank_pad}, "
              f"nnz_pad {nnz_pad}, {nblocks} blocks, {i_out} rows): split {ms:.3f} ms, plain "
              f"{plain:.3f} ms, bound {bound:.4f} ms; max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"{'ok' if ok else 'FAIL'} (tol {F32_TOL:g} x scale); two launches bit for bit "
              f"{'equal' if same else 'DIFFER'}  [{card}]")
    check(all(r["ok"] for r in rows), "the stacked MTTKRP disagrees with its plain version")
    check(all(r["same"] for r in rows), "two launches on a stacked plan differ")
    del facs

    del s_idx, s_val, bufs

    host_waits(dev, sig.dims)
    # (b) staging and run_batch enqueue without a host-device synchronisation:
    # the sync debug mode does not see every synchronising call, so each is
    # also queued behind a sleep, and the host must get back before it ends.
    executor = BucketExecutor(sig, device=dev)
    staged, stage_host_ms, ended = behind_a_sleep(
        lambda: executor.stage(members, pad_to=SERVE_MAX_BATCH))
    check(not ended, "staging a batch waited for the device")
    *operands, plans = staged
    _, short_ms, ended = behind_a_sleep(
        lambda: executor.core.run_batch(*operands, n_iters=SLEEP_CHECK_SWEEPS, plans=plans))
    check(not ended, "run_batch waited for the device")
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        executor.core.run_batch(*operands, n_iters=sig.n_iters, plans=plans)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  behind a {SLEEP_CYCLES:.0e}-cycle sleep the host got back before it ended: staging "
          f"(uploads, plans) in {stage_host_ms:.1f} ms, run_batch of {SLEEP_CHECK_SWEEPS} sweeps "
          f"in {short_ms:.1f} ms; run_batch of {sig.n_iters} sweeps under "
          f"set_sync_debug_mode('error'): no synchronisation, enqueued in {enqueue_ms:.1f} ms")
    del staged, operands, plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    executor.launch(members, pad_to=SERVE_MAX_BATCH)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_batch(executor, members, batch_ms)
    print(f"  host: draw {draw_s:.1f} s; one batch staged in {stage_host_ms:.1f} ms and enqueued "
          f"in {enqueue_ms:.1f} ms, done after {batch_ms:.1f} ms")
    return dict(launches=launches, by_variant=by_variant, peak_gb=peak_gb, stats=stats,
                batch_ms=batch_ms, profile_ms=prof, draw_s=draw_s,
                stage_host_ms=stage_host_ms, enqueue_ms=enqueue_ms,
                stacked_ms=[r["ms"] for r in rows], stacked_plain_ms=[r["plain_ms"] for r in rows],
                stacked_bound_ms=[r["bound_ms"] for r in rows],
                stacked_max_abs=max(r["max_abs"] for r in rows), contracts=contracts)


# Phase 11: the paper's experiment engine at the largest stand-ins that
# make_frostt_like's cap of 2M nonzeros gives: NELL-2 (3585, 2725, 8532),
# LBNL at its full Table II size with 5 modes, PATENTS (4, 19716, 19716).
ENGINE_TENSORS = (("NELL-2", 0.026), ("LBNL", 1.0), ("PATENTS", 5.6e-4))
ENGINE_ITERS = 3
BACK_TO_BACK = 50  # launches between two CUDA events, for the kernel's own time


def back_to_back_ms(fn, n: int = BACK_TO_BACK) -> float:
    """Device ms per call of ``n`` calls queued back to back between two
    CUDA events: the host gaps between launches hide behind the queue
    whenever a call takes the device longer than the host takes to enqueue
    the next one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def engine_phase(dev, card: str) -> dict:
    """Phase 11: ``run_experiments`` through the split kernel on the engine's
    stand-ins, then the controller's gates and the ordering benchmark."""
    phase(f"phase 11: the experiment engine, {ENGINE_TENSORS}, rank {RANK}, "
          f"{ENGINE_ITERS} sweeps eager and fused (cold, warm), impl kernel")
    held = []  # (dims, mode, max_abs, max_rel, ok): each mode's first call vs plain
    tensors = {}  # dims -> the engine's tensor, from its first call

    def hold(tensor, impl, mode, facs, out):
        if impl != "kernel":
            return
        tensors[tensor.shape] = tensor
        bufs = ops.plan_device_buffers(ops.get_plan(tensor, mode), dev)  # the run's plan
        max_abs, max_rel, ok = compare(bufs, list(facs), mode, tensor.shape[mode], out, F32_TOL)
        held.append((tensor.shape, mode, max_abs, max_rel, ok))

    # One run_experiments per tensor, so each run's launches are the counter's
    # step across it; the runs together are the spec's result (run_experiments
    # prices each tensor on its own).
    spec = ExperimentSpec(tensors=ENGINE_TENSORS, impls=("kernel",), n_iters=ENGINE_ITERS,
                          fused=True, device="cuda")
    runs, per_run = [], []
    kmod.reset_launch_counts()  # the main path of phase 11 starts here
    t0 = time.perf_counter()
    for one in ENGINE_TENSORS:
        before = kmod.mttkrp_cuda.launches
        runs += run_experiments(dataclasses.replace(spec, tensors=(one,)),
                                first_call_hook=hold).runs
        per_run.append(kmod.mttkrp_cuda.launches - before)
    engine_s = time.perf_counter() - t0
    launches = kmod.mttkrp_cuda.launches  # the main path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    by_mode = dict(kmod.mttkrp_cuda.launches_by_mode)
    result = ExperimentResult(spec=spec, runs=runs)
    print(f"  engine: {engine_s:.1f} s host wall for {len(result.runs)} runs; split launches "
          f"{launches} by variant {by_variant} by mode {by_mode}  [{card}]")
    check(by_variant.get("block", 0) == 0 and by_variant["split"] == launches,
          f"the engine's MTTKRPs did not all take the split kernel: {by_variant}")
    check(len(per_run) == len(result.runs), f"{len(result.runs)} runs for {len(per_run)} tensors")
    kernel_ms = {}  # shape -> per mode, the split kernel alone on the run's plans
    contracts = []
    for tensor in tensors.values():
        facs = factors_on(tensor.shape, RANK, dev)  # random factors, for the time only
        kernel_ms[tensor.shape] = [
            back_to_back_ms(lambda b=ops.plan_device_buffers(ops.get_plan(tensor, m), dev), m=m:
                            kmod.mttkrp_cuda(b, facs, m, tensor.shape[m]))
            for m in range(tensor.nmodes)]
        if tensor.nmodes == 5:  # phase 15 on the run's 5-mode plans (LBNL)
            contracts += [audit_plan(ops.plan_device_buffers(ops.get_plan(tensor, m), dev), facs,
                                     m, tensor.shape[m], tensor.nnz,
                                     f"phase 15 on phase 11's 5-mode plans, dims {tensor.shape}",
                                     card) for m in range(tensor.nmodes)]
        del facs
    fit_tol = tfused.FUSED_FIT_TOL
    entries = {}
    for run, n_launches in zip(result.runs, per_run):
        m = run.measured
        expected = 3 * ENGINE_ITERS * len(run.dims)  # eager, fused cold, fused warm
        print(f"  {run.key}: dims {run.dims}, nnz {run.nnz}; split launches {n_launches} "
              f"(expected {expected}: {ENGINE_ITERS} sweeps x {len(run.dims)} modes, eager and "
              f"fused cold and warm); fit eager {m.fit:.6f} fused {m.fused_fit:.6f}, max fit gap "
              f"{m.fused_max_fit_delta:.3e} (tol {fit_tol}); wall eager {m.wall_s:.3f} s, fused cold "
              f"{m.fused_wall_s:.3f} s, warm {m.fused_warm_wall_s:.3f} s")
        check(n_launches == expected, f"{run.key} launched the split kernel {n_launches} times")
        check(m.fused_max_fit_delta <= fit_tol and abs(m.fused_fit - m.fit) <= fit_tol,
              f"{run.key}: fused fits differ from eager by {m.fused_max_fit_delta}")
        check(np.isfinite([m.fit, m.fused_fit]).all(), f"{run.key}: non-finite fit")
        rows = []
        for mm in m.modes:
            plan = ops.get_plan(tensors[run.dims], mm.mode)
            nbytes = mttkrp_bytes(plan, RANK, run.nnz)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            paper = 2.0 * len(run.dims) * run.nnz * RANK
            check(mm.flops == mm.paper_flops == paper,
                  f"{run.key} mode {mm.mode}: flops {mm.flops} != closed form {paper}")
            kms = kernel_ms[run.dims][mm.mode]
            rows.append(dict(ms=mm.steady_s * 1e3, event_ms=mm.steady_device_s * 1e3,
                             first_ms=mm.first_s * 1e3, kernel_ms=kms, bound_ms=bound))
            print(f"    mode {mm.mode}: {run.dims[mm.mode]} rows, steady {mm.steady_s * 1e3:.4f} ms "
                  f"per call (CUDA events {mm.steady_device_s * 1e3:.4f} ms), first "
                  f"{mm.first_s * 1e3:.3f} ms; the kernel alone {kms:.4f} ms ({BACK_TO_BACK} back "
                  f"to back), byte bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB), "
                  f"flops {mm.flops:.4g} = 2·N·|T|·R")
        for _, mode, max_abs, max_rel, ok in [h for h in held if h[0] == run.dims]:
            print(f"    mode {mode} first call vs plain: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
                  f"{'ok' if ok else 'FAIL'} (tol {F32_TOL:g} x scale)")
        hs = {k: f"{v:.2f}" for k, v in run.host_s.items()}
        print(f"    host s: {hs}; hit rates: {len(run.hit_rates)} scenarios, max |trace - che(L)| "
              f"{max(h.max_abs_err for h in run.hit_rates):.4f}, all_within_tol {run.all_within_tol} "
              f"(tol {CHE_VS_TRACE_TOL}, printed, not asserted)")
        entries[run.tensor] = dict(dims=list(run.dims), nnz=run.nnz, launches=n_launches,
                                   per_mode_ms=[r["ms"] for r in rows],
                                   per_mode_event_ms=[r["event_ms"] for r in rows],
                                   per_mode_kernel_ms=[r["kernel_ms"] for r in rows],
                                   per_mode_bound_ms=[r["bound_ms"] for r in rows],
                                   host_s=run.host_s, all_within_tol=run.all_within_tol,
                                   fit=m.fit)
    check(len(held) == sum(len(r.dims) for r in result.runs), f"{len(held)} first calls held")
    check(all(h[4] for h in held), "a first call of the engine disagrees with the plain version")
    print("  E-SRAM -> O-SRAM, priced (measured trace hit rates) beside modeled (Che):")
    for key, sp in result.speedup_table().items():
        ev = result.energy_table()[key]
        print(f"    {key}: speedup {sp['priced']:.4f} (Che {sp['modeled']:.4f}), energy saving "
              f"{ev['priced']:.4f} (Che {ev['modeled']:.4f})")
    for run in result.runs:
        for tech in run.techs:
            print(f"    {run.key} {tech.tech}: priced {sum(tech.priced_mode_s):.4e} s, modeled "
                  f"{sum(tech.modeled_mode_s):.4e} s, measured-vs-priced share residual max "
                  f"{tech.max_share_residual:.4f}")

    # The NELL-2 run's hit rates, again on the host from the plans' traces.
    nell = result.runs[0]
    nell_tensor = tensors[nell.dims]
    t0 = time.perf_counter()
    same = True
    for h in nell.hit_rates:
        geometry = CacheGeometry(capacity_bytes=h.capacity_bytes, line_bytes=h.line_bytes,
                                 associativity=h.associativity)
        cfg, row_bytes = geometry_sim_config(geometry, RANK, n_inputs=len(nell.dims) - 1)
        plan = ops.get_plan(nell_tensor, h.mode)
        rates = tuple(simulate_trace(plan.executed_row_trace(k, include_padding=False), cfg,
                                     row_bytes=row_bytes).hit_rate
                      for k in range(len(nell.dims)) if k != h.mode)
        same = same and rates == h.trace
    print(f"  NELL-2 hit rates recomputed from executed_row_trace: "
          f"{'equal' if same else 'DIFFER'} over {len(nell.hit_rates)} scenarios "
          f"({time.perf_counter() - t0:.1f} s host)")
    check(same, "the engine's NELL-2 hit rates differ from the plans' traces")

    t0 = time.perf_counter()
    ref = run_experiments(ExperimentSpec(tensors=ENGINE_TENSORS[:1], impls=("ref",),
                                         n_iters=ENGINE_ITERS, fused=True, device="cuda"))
    ref_run = ref.runs[0]
    gap = abs(ref_run.measured.fit - nell.measured.fit)
    print(f"  {ref_run.key}: {time.perf_counter() - t0:.1f} s host wall; steady ms per mode "
          f"{[round(mm.steady_s * 1e3, 4) for mm in ref_run.measured.modes]} (CUDA events "
          f"{[round(mm.steady_device_s * 1e3, 4) for mm in ref_run.measured.modes]}); fit "
          f"{ref_run.measured.fit:.6f}, kernel {nell.measured.fit:.6f}, gap {gap:.3e} "
          f"(tol {fit_tol}); speedup priced {ref.speedup_table()[ref_run.key]['priced']:.4f}; "
          f"host s {({k: round(v, 2) for k, v in ref_run.host_s.items()})}")
    check(gap <= fit_tol, f"ref and kernel fits on NELL-2 differ by {gap}")
    check(ref_run.measured.fused_max_fit_delta <= fit_tol, "ref fused fits differ from eager")
    ops.clear_caches()

    # The controller's gates, as scripts/run_controller.py runs them.
    t0 = time.perf_counter()
    cells, _ = reconcile_controller()
    recon_s = time.perf_counter() - t0
    for c in cells:
        print(f"    recon {c.workload:8s} {c.tech:7s} analytic {c.analytic_seconds:.4e} s, "
              f"controller {c.controller_seconds:.4e} s, rel {c.rel_err:+.5f}")
    check(all(c.ok and c.rel_err >= -1e-9 for c in cells),
          f"the controller does not reconcile within {CONTROLLER_RECON_TOL}")
    t0 = time.perf_counter()
    gates = controller_gates(rank=RANK, device=dev)
    gates_s = time.perf_counter() - t0
    rates = {o: c.conflict_rate for o, c in gates.conflicts.items()}
    print(f"  controller: reconciliation {len(cells)} cells in {recon_s:.1f} s host (tol "
          f"{CONTROLLER_RECON_TOL}); paper bands {gates.bands} (speedup {SPEEDUP_BAND}, energy "
          f"{ENERGY_BAND}); bank conflict rates {rates}; bands and conflicts {gates_s:.1f} s host")
    check(gates.bands_ok, f"the cycle model leaves the paper bands: {gates.bands}")
    check(gates.conflicts_ok, f"degree/blocked do not reduce bank conflicts: {rates}")
    t0 = time.perf_counter()
    sweep = run_reorder_sweep(quick=True, device=dev)
    reorder_s = time.perf_counter() - t0
    acc = sweep["acceptance"]
    print(f"  ordering benchmark (quick, orders sorted on the card): {reorder_s:.1f} s host; "
          f"winners {({n: r['winners'] for n, r in acc['tensors'].items()})}, ok {acc['ok']}")
    check(acc["ok"], f"the ordering benchmark's acceptance fails: {acc}")
    return dict(launches=launches, by_variant=by_variant, runs=entries, contracts=contracts,
                max_abs=max(h[2] for h in held), engine_s=engine_s,
                ref=dict(per_mode_ms=[mm.steady_s * 1e3 for mm in ref_run.measured.modes],
                         per_mode_event_ms=[mm.steady_device_s * 1e3 for mm in ref_run.measured.modes],
                         host_s=ref_run.host_s, fit_gap=gap),
                speedup=result.speedup_table(), energy=result.energy_table(),
                recon_s=recon_s, gates_s=gates_s, reorder_s=reorder_s)


# Phase 12: the autotuner on the card.  The service's band is one request
# of phase 9's population (NELL-2's dims / 10, Zipf 0.85, ~2M nonzeros);
# at Table II size the space has one axis, the ordering, since each
# ordering's plans take ~20 s of host time and ~4 GB of device memory.
TUNE_TRAFFIC = dataclasses.replace(SERVE_TRAFFIC, n_requests=6, seed=1)
TUNE_RANKS = (8, 16)
TABLE2_SPACE = TuneSpace(tile_nnz=(256,), rows_per_block=(256,), orderings=("lex", "degree"))
TUNE_ENGINE_TENSOR = ("NELL-2", 0.026)


def tune_launches(tuner, nmodes: int) -> int:
    """Split launches of one full tune that measured every cell: a warm-up
    and ``reps`` samples per (config, mode)."""
    return len(tuner.space.configs()) * nmodes * (1 + tuner.reps)


def autotune_table2_phase(dev, card: str, tensor, lex_fits: np.ndarray) -> dict:
    """Phase 12, Table II part: ``FusedCPALS(autotune=)`` on phase 3's tensor
    over lex and degree, while phase 3's lex plans are memoized (the degree
    plans are built here, 3 threads, as phase 10 builds them; phase 10
    clears them at its second ordering)."""
    phase(f"phase 12 (Table II part, run after phase 5): FusedCPALS(autotune=) at NELL-2 "
          f"Table II size, rank {RANK}, space {[c.label for c in TABLE2_SPACE.configs()]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(tensor.nmodes) as pool:
        plans = list(pool.map(lambda m: ops.get_plan(tensor, m, ordering="degree", device=dev),
                              range(tensor.nmodes)))
    for p in plans:
        ops.plan_device_buffers(p, dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    tuner = Autotuner(TABLE2_SPACE, device=dev, tune_on_miss=True)
    kmod.reset_launch_counts()  # the path starts here
    t0 = time.perf_counter()
    executor = tfused.FusedCPALS(tensor, RANK, impl="kernel", device=dev, autotune=tuner)
    tune_s = time.perf_counter() - t0
    run = executor.run(n_iters=SWEEPS, tol=0.0, seed=0, fit_every=SWEEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kmod.mttkrp_cuda.launches  # the path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    (result,) = tuner.results.values()
    expected = tune_launches(tuner, tensor.nmodes) + SWEEPS * tensor.nmodes
    gap = float(np.max(np.abs(run.fits[0] - lex_fits[0])))
    print(f"  degree plans + upload {plan_s:.2f} s host (3 threads); lex plans from phase 3's memo")
    for cfg, sec in result.timings.items():
        print(f"  {cfg.label}: {sec * 1e3:.4f} ms per sweep of MTTKRPs (tuner, median of "
              f"{tuner.reps} device-timed calls per mode){'  <- winner' if cfg == result.best else ''}")
    print(f"  winner {result.best.label}, speedup_vs_default {result.speedup_vs_default:.4f}; "
          f"executor geometry {[(p.tile_nnz, p.rows_per_block, p.ordering) for p in executor._plans]}"
          f"; tune {tune_s:.2f} s host; {SWEEPS} sweeps at the winner, fits "
          f"{[round(float(f), 6) for f in run.fits[0]]}, max gap to phase 3's lex fits {gap:.3e} "
          f"(tol {tfused.FUSED_FIT_TOL}); split launches {launches} by variant {by_variant} "
          f"(expected {expected})  [{card}]")
    check(result.speedup_vs_default >= 1.0, "the tuned config is slower than the default")
    check(all(p.ordering == result.best.ordering for p in executor._plans),
          "the executor did not take the tuned ordering")
    check(np.isfinite(run.fits).all() and gap <= tfused.FUSED_FIT_TOL,
          f"the autotuned fused fits differ from lex by {gap}")
    check(by_variant == {"split": expected, "block": 0} and launches == expected,
          f"the autotuned path's MTTKRPs were not all split launches: {by_variant}")
    del executor, run, plans
    return dict(launches=launches, best=result.best.label, fit_gap=gap,
                timings_ms={c.label: v * 1e3 for c, v in result.timings.items()},
                speedup_vs_default=result.speedup_vs_default, plan_s=plan_s, tune_s=tune_s)


def autotune_phase(dev, card: str) -> dict:
    """Phase 12: the tuner over the default space on a phase-9 tensor at ranks
    8 and 16, the winner's plans against plain, the service and standalone
    fused runs under the tuner, ``measured_vs_modeled``, and the experiment
    engine with ``autotune=True`` on NELL-2@0.026."""
    space = TuneSpace()
    phase(f"phase 12: the autotuner on the card, {len(space.configs())} configs "
          f"{[c.label for c in space.configs()]}, ranks {TUNE_RANKS}")
    ops.clear_caches()
    t0 = time.perf_counter()
    reqs = [r for _, r in synthetic_trace(TUNE_TRAFFIC)]
    draw_s = time.perf_counter() - t0
    tensor = reqs[0].tensor
    tuner = Autotuner(space, device=dev)
    kmod.reset_launch_counts()  # the tuning path starts here
    t0 = time.perf_counter()
    results = {rank: tuner.tune(tensor, rank) for rank in TUNE_RANKS}
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_count = kmod.mttkrp_cuda.launches  # the tuning path ends here
    tune_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    expected = len(TUNE_RANKS) * tune_launches(tuner, tensor.nmodes)
    print(f"  tensor: dims {tensor.shape}, {tensor.nnz} nonzeros (host draw of {len(reqs)} "
          f"requests {draw_s:.2f} s); tune {tune_s:.2f} s host for {len(TUNE_RANKS)} bands "
          f"(plan builds included); split launches {tune_count} by variant {tune_variant} "
          f"(expected {expected})  [{card}]")
    check(tune_variant == {"split": expected, "block": 0} and tune_count == expected,
          f"the tuner's MTTKRPs were not one split launch per measured call: {tune_variant}")
    misses, hits = tuner.memo.misses, tuner.memo.hits
    entries = {}
    for rank, result in results.items():
        per_mode = [tuner.tune(tensor, rank, modes=(m,)).timings for m in range(tensor.nmodes)]
        print(f"  rank {rank}, band {dataclasses.astuple(result.signature)}: ms per mode (tuner)")
        for cfg in space.configs():
            print(f"    {cfg.label:<16} {[round(t[cfg] * 1e3, 4) for t in per_mode]}, sweep "
                  f"{result.timings[cfg] * 1e3:.4f}{'  <- winner' if cfg == result.best else ''}")
        facs = tcp.cp_init(tensor, rank, seed=0, device=dev)
        alone = {}
        for cfg in dict.fromkeys((DEFAULT_TILE_CONFIG, result.best)):
            alone[cfg.label] = [
                back_to_back_ms(lambda b=ops.plan_device_buffers(ops.get_plan(
                    tensor, m, tile_nnz=cfg.tile_nnz, rows_per_block=cfg.rows_per_block), dev),
                    m=m: kmod.mttkrp_cuda(b, facs, m, tensor.shape[m]))
                for m in range(tensor.nmodes)]
            print(f"    {cfg.label}: the kernel alone ({BACK_TO_BACK} back to back) "
                  f"{[round(ms, 4) for ms in alone[cfg.label]]} ms per mode, tuner "
                  f"{[round(t[cfg] * 1e3, 4) for t in per_mode]}")
        held = []
        for m in range(tensor.nmodes):
            bufs = ops.plan_device_buffers(ops.get_plan(
                tensor, m, tile_nnz=result.best.tile_nnz,
                rows_per_block=result.best.rows_per_block), dev)
            got = kmod.mttkrp_cuda(bufs, facs, m, tensor.shape[m])
            held.append(compare(bufs, facs, m, tensor.shape[m], got, F32_TOL))
        print(f"    winner {result.best.label}, speedup_vs_default "
              f"{result.speedup_vs_default:.4f}; its plans vs plain: max_abs "
              f"{max(h[0] for h in held):.3e} max_rel {max(h[1] for h in held):.3e} "
              f"(tol {F32_TOL:g} x scale)  [{card}]")
        check(result.speedup_vs_default >= 1.0, f"rank {rank}: tuned is slower than the default")
        check(all(h[2] for h in held), f"rank {rank}: the winner's plans disagree with plain")
        entries[rank] = dict(best=result.best.label, speedup_vs_default=result.speedup_vs_default,
                             timings_ms={c.label: v * 1e3 for c, v in result.timings.items()},
                             kernel_alone_ms=alone, max_abs=max(h[0] for h in held))
        del facs
    again = Autotuner(space, device=dev, memo=tuner.memo)
    repeat = [tuner.tune(tensor, r) is results[r] for r in TUNE_RANKS]
    repeat += [again.tune(tensor, r).timings == results[r].timings for r in TUNE_RANKS]
    in_band = [r for r in reqs if tuner.signature_of(r.tensor, r.rank) == results[r.rank].signature]
    repeat += [tuner.config_for(r.tensor, r.rank) == results[r.rank].best for r in in_band]
    print(f"  repeat tunes and config_for ({len(in_band)} of {len(reqs)} requests in the tuned "
          f"bands): same answers {all(repeat)}, memo misses "
          f"{misses} -> {tuner.memo.misses}, hits {hits} -> {tuner.memo.hits}")
    check(all(repeat) and tuner.memo.misses == misses, "a repeat tune measured again")

    # The service and standalone fused runs under the tuner.
    kmod.reset_launch_counts()  # the service path starts here
    svc = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                               device=dev, autotuner=tuner)
    t0 = time.perf_counter()
    for r in reqs:
        check(svc.submit(r), f"{r.request_id} refused")
    done = svc.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    worst = 0.0
    for r in reqs:
        alone_fits = tfused.cp_als_fused(r.tensor, r.rank, n_iters=r.n_iters, tol=0.0,
                                         seed=r.seed, impl="kernel", device=dev,
                                         autotune=tuner).fits[0]
        worst = max(worst, float(np.max(np.abs(np.array(done[r.request_id].state.fits)
                                               - alone_fits))))
    torch.cuda.synchronize()
    serve_count = kmod.mttkrp_cuda.launches  # the service path ends here
    serve_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    tiles = {r.request_id: tuner.config_for(r.tensor, r.rank).tile_nnz for r in reqs}
    aligned = all(done[r.request_id].signature.nnz_pad % tiles[r.request_id] == 0 for r in reqs)
    buckets = sorted({(d.signature.nnz_pad, d.signature.rank_pad) for d in done.values()})
    print(f"  DecompositionService(autotuner=): {len(done)} of {len(reqs)} answered in "
          f"{serve_s:.2f} s; buckets (nnz_pad, rank_pad) {buckets}, tuned tiles "
          f"{sorted(set(tiles.values()))}, aligned {aligned}; fits vs a standalone "
          f"cp_als_fused(autotune=) of the same seed: max gap {worst:.3e} (tol "
          f"{tfused.FUSED_FIT_TOL}); split launches {serve_count} by variant {serve_variant}")
    check(set(done) == {r.request_id for r in reqs}, "a tuned service request was not answered")
    check(aligned, "a bucket's nnz_pad is not a multiple of its tuned tile")
    check(worst <= tfused.FUSED_FIT_TOL, f"a tuned service response differs by {worst}")
    check(serve_variant["split"] == serve_count > 0 and serve_variant["block"] == 0,
          f"the tuned service's MTTKRPs were not all split launches: {serve_variant}")

    t0 = time.perf_counter()
    mvm = measured_vs_modeled(tensor, results[TUNE_RANKS[-1]], rank=TUNE_RANKS[-1],
                              name="phase9-band", device=dev)
    mvm_s = time.perf_counter() - t0
    print(f"  measured_vs_modeled, rank {TUNE_RANKS[-1]} ({mvm_s:.1f} s host, exact trace):")
    for row in mvm:
        print(f"    {row['config']:<16} measured {row['measured_s']:.4e} s, modeled (O-SRAM) "
              f"{row['modeled_s']:.4e} s{'  <- winner' if row['best'] else ''}")
    check(all(np.isfinite(r["modeled_s"]) and r["modeled_s"] > 0 for r in mvm),
          "measured_vs_modeled priced a config at a non-positive time")
    ops.clear_caches()

    # The experiment engine with autotune=True; its tuner is recorded.
    made = []

    class RecordedTuner(Autotuner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    held = []

    def hold(t, impl, mode, facs, out):
        (engine_tuner,) = made
        best = engine_tuner.config_for(t, RANK)
        bufs = ops.plan_device_buffers(ops.get_plan(
            t, mode, tile_nnz=best.tile_nnz, rows_per_block=best.rows_per_block), dev)
        held.append(compare(bufs, list(facs), mode, t.shape[mode], out, F32_TOL))

    spec = ExperimentSpec(tensors=(TUNE_ENGINE_TENSOR,), impls=("kernel",), n_iters=ENGINE_ITERS,
                          fused=True, device=dev.type, autotune=True)
    texp_engine.Autotuner = RecordedTuner
    try:
        kmod.reset_launch_counts()  # the engine path starts here
        t0 = time.perf_counter()
        (run,) = run_experiments(spec, first_call_hook=hold).runs
        engine_s = time.perf_counter() - t0
        engine_count = kmod.mttkrp_cuda.launches  # the engine path ends here
    finally:
        texp_engine.Autotuner = Autotuner
    engine_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    (engine_tuner,) = made
    (engine_result,) = engine_tuner.results.values()
    expected_engine = tune_launches(engine_tuner, len(run.dims)) + 3 * ENGINE_ITERS * len(run.dims)
    m = run.measured
    print(f"  run_experiments(autotune=True) {run.key}: {engine_s:.1f} s host; tuned "
          f"{engine_result.best.label} (speedup_vs_default {engine_result.speedup_vs_default:.4f}, "
          f"{len(engine_tuner.memo)} cells); fits eager {m.fit:.6f} fused {m.fused_fit:.6f}; "
          f"steady ms per mode {[round(mm.steady_s * 1e3, 4) for mm in m.modes]} (CUDA events "
          f"{[mm.steady_device_s and round(mm.steady_device_s * 1e3, 4) for mm in m.modes]}); "
          f"first calls vs plain on "
          f"the winner's plans max_rel {max(h[1] for h in held):.3e}; host s "
          f"{({k: round(v, 2) for k, v in run.host_s.items()})}; split launches {engine_count} "
          f"by variant {engine_variant} (expected {expected_engine})  [{card}]")
    check(engine_variant == {"split": expected_engine, "block": 0}
          and engine_count == expected_engine,
          f"the autotuned engine's MTTKRPs were not all split launches: {engine_variant}")
    check(len(held) == len(run.dims) and all(h[2] for h in held),
          "an autotuned engine call disagrees with plain")
    check(engine_result.speedup_vs_default >= 1.0 and m.fused_max_fit_delta <= tfused.FUSED_FIT_TOL
          and np.isfinite([m.fit, m.fused_fit]).all(), f"{run.key}: the autotuned run failed")
    ops.clear_caches()
    return dict(launches_tune=tune_count, launches_service=serve_count,
                launches_engine=engine_count, bands=entries, tune_s=tune_s, serve_s=serve_s,
                fit_gap=worst, mvm_s=mvm_s, engine_s=engine_s,
                engine_best=engine_result.best.label,
                max_abs=max([e["max_abs"] for e in entries.values()]
                            + [h[0] for h in held]))


# Phase 13: LM decode serving at full width and depth.
DECODE_PROMPT = 256
SERVE_RUNS = {  # label -> (requests, prompt tokens, slots, max_len)
    "launch/serve.py's load": (8, 4, 4, 48),
    "256-token prompts": (4, DECODE_PROMPT, 4, 320),
}


def timed_decode(decode, events: list):
    """``decode`` with CUDA events recorded around each call."""
    def step(model, tokens, state):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = decode(model, tokens, state)
        end.record()
        events.append((start, end))
        return out
    return step


def profile_decode_step(model, cfg, decode, slots: int, max_len: int, tick_ms: float) -> dict:
    """Device time of one decode step at B = ``slots`` by kernel class
    (torch.profiler); the idle share is of ``tick_ms``, a tick's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.zeros((slots,), dtype=torch.int32, device=model.embed.device)
    state = init_decode_state(cfg, slots, max_len, cache_dtype=torch.float32,
                              device=model.embed.device)
    decode(model, tokens, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(model, tokens, state)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes = {"casts and copies": 0.0, "products (GEMM/GEMV)": 0.0, "softmax": 0.0,
               "index (embedding, cache writes)": 0.0, "rest (elementwise, reductions)": 0.0}
    for e in events:
        name = e.key.lower()
        if "copy" in name or "memcpy" in name:
            key = "casts and copies"
        elif any(t in name for t in ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "dot_kernel",
                                     "splitk", "bmm")):
            key = "products (GEMM/GEMV)"
        elif "softmax" in name:
            key = "softmax"
        elif "index" in name or "gather" in name or "scatter" in name:
            key = "index (embedding, cache writes)"
        else:
            key = "rest (elementwise, reductions)"
        classes[key] += e.self_device_time_total / 1e3
    busy = sum(classes.values())
    kernels = sum(e.count for e in events)
    print(f"    profile of one step at B={slots}: {kernels} device operations, device busy "
          f"{busy:.3f} ms (profiler) of a {tick_ms:.3f} ms tick, idle share "
          f"{max(0.0, 1 - busy / tick_ms):.3f}")
    for key, ms in classes.items():
        print(f"      {key:<34} {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}")
    for e in events[:8]:
        print(f"      {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} {e.key[:90]}")
    return dict(busy_ms=busy, kernels=kernels, **{k.split(" (")[0].replace(" ", "_") + "_ms": v
                                                  for k, v in classes.items()})


def decode_phase(dev, card: str) -> dict:
    """Phase 13: internlm2-1.8b decode at full width and depth (bf16, random
    weights): teacher-forced decode against the prefill's logits, two
    ``BatchServer`` runs, and a reused slot against a fresh server."""
    cfg = get_config(ARCH)
    phase(f"phase 13: {ARCH} decode serving, full width and depth ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads, {cfg.num_kv_heads} KV heads, head_dim "
          f"{cfg.head_dim}), {cfg.dtype}")
    model = init_model(cfg, seed=0, device=dev)
    decode = make_decode_fn(cfg, device=dev)
    fkmod.reset_launch_counts()
    kmod.reset_launch_counts()

    # Teacher-forced decode of one 256-token prompt against forward at S = 256.
    toks = torch.from_numpy(next(SyntheticLMStream(cfg.vocab_size, DECODE_PROMPT, 1, seed=3))
                            ["tokens"]).to(dev)
    with torch.inference_mode():
        full = forward(model, cfg, {"tokens": toks})[0].float()
    state = init_decode_state(cfg, 1, DECODE_PROMPT, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = [decode(model, toks[:, t], state)[0][0] for t in range(DECODE_PROMPT)]
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    gap, scale = logits_gap(torch.stack(steps), full, cfg.vocab_size)
    print(f"  teacher-forced decode of {DECODE_PROMPT} tokens (B=1, bf16 cache) against forward "
          f"at S={DECODE_PROMPT}: max |gap| {gap:.4f} of max |logit| {scale:.3f} (tol "
          f"{BF16_SCALE_TOL} x scale); {tf_s:.2f} s host, {DECODE_PROMPT / tf_s:.1f} steps/s; "
          f"pos {state['pos'].tolist()}  [{card}]")
    check(gap <= BF16_SCALE_TOL * scale, "decode logits differ from the prefill's")
    check(state["pos"].tolist() == [DECODE_PROMPT], "pos did not advance once a step")
    del steps, full, state

    runs = {}
    for label, (n_req, prompt_len, slots, max_len) in SERVE_RUNS.items():
        if prompt_len == DECODE_PROMPT:
            prompts = next(SyntheticLMStream(cfg.vocab_size, prompt_len, n_req, seed=4))["tokens"]
            prompts = [p.tolist() for p in prompts]
            eos = -1
        else:  # launch/serve.py's prompts and ServeConfig's eos
            prompts = [[2 + (i % 11), 5, 7, 3] for i in range(n_req)]
            eos = ServeConfig().eos_id
        srv = BatchServer(cfg, model, ServeConfig(max_slots=slots, max_len=max_len, eos_id=eos),
                          device=dev)
        events = []
        srv.decode = timed_decode(srv.decode, events)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            srv.submit(f"req-{i}", p)
        done = srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ticks = len(events)
        tick_ms = [s.elapsed_time(e) for s, e in events]
        tokens = sum(len(d["tokens"]) for d in done)
        cache_mb = sum(srv.state[k].numel() * srv.state[k].element_size()
                       for k in ("k", "v")) / 1e6
        runs[label] = dict(requests=len(done), tokens=tokens, ticks=ticks, wall_s=wall,
                           tokens_per_s=tokens / wall, tick_device_ms_p50=float(np.median(tick_ms)),
                           tick_wall_ms=wall / ticks * 1e3, peak_gb=peak, cache_mb=cache_mb)
        print(f"  BatchServer, {label}: {len(done)} of {n_req} requests answered, {tokens} tokens "
              f"in {ticks} ticks, {wall:.2f} s, {tokens / wall:.1f} tokens/s; ticks median "
              f"{np.median(tick_ms):.3f} ms between CUDA events ({wall / ticks * 1e3:.3f} ms wall "
              f"each); float32 cache {cache_mb:.1f} MB; peak device memory {peak:.2f} GB  [{card}]")
        check(sorted(d["id"] for d in done) == sorted(f"req-{i}" for i in range(n_req)),
              f"{label}: a request was not answered")
        check(all(d["tokens"] for d in done), f"{label}: an empty answer")
        del srv
        runs[label]["profile_ms"] = profile_decode_step(model, cfg, decode, slots, max_len,
                                                        wall / ticks * 1e3)

    # A reused slot against a fresh server, as tests/test_runtime.py checks.
    prompt = next(SyntheticLMStream(cfg.vocab_size, 16, 1, seed=5))["tokens"][0].tolist()
    outs = []
    for first in ([3, 3], None):
        srv = BatchServer(cfg, model, ServeConfig(max_slots=1, max_len=32, eos_id=-1), device=dev)
        if first is not None:
            srv.submit("a", first)
        srv.submit("b", prompt)
        outs.append({d["id"]: d["tokens"] for d in srv.run_until_drained()}["b"])
    print(f"  slot reuse: request b after a in one slot {outs[0]} ; in a fresh server {outs[1]}")
    check(outs[0] == outs[1], "a reused slot's tokens differ from a fresh server's")
    flash, split = fkmod.flash_attention_cuda.launches, kmod.mttkrp_cuda.launches
    print(f"  hand-written kernels launched by phase 13: flash {flash}, MTTKRP {split} (the decode "
          f"path is plain PyTorch, as JAX's is plain jnp)")
    check(flash == 0 and split == 0, "the decode path launched a hand-written kernel")
    del model
    return dict(teacher_forced_gap=gap, teacher_forced_scale=scale, teacher_forced_s=tf_s,
                runs=runs, slot_reuse_equal=True)


# Phase 14: the sharded path (repro_torch.distributed), one process per rank.
# (a) 1 rank on NCCL (a card for it), 3 and 8 ranks sharing the card on gloo;
# (b) Table II on 4 ranks sharing the card; (c) the engine's sharded impl.
SHARD_WORLDS = (1, 3, 8)
TABLE2_SHARDS = 4
ENGINE_SHARDS = 4  # 8 until phase 19 was added, cut to make room for it
# (c) runs phase 11's first stand-in: with PATENTS@5.6e-4 as well, phase 14
# took 252-270 s, past its 240 s target; LBNL@1.0 took 77-80 s of it more,
# and the whole script 783-892 s of the 1200 s it may take.  The 5-mode
# sharded MTTKRP stays in (a), LBNL@1.0's engine run in phase 11.
SHARDED_ENGINE_TENSORS = ENGINE_TENSORS[:1]
SHARD_REPS = 5  # timed repeats per mode in (b)


def sharded_cases():
    """Phase 14 (a): the cases of tests/test_distributed.py (3-, 4- and
    5-mode, uneven, a single nonzero, rank 1, one output block, fewer
    nonzeros than shards), a restart batch and the blocked order past one
    input band: (name, tensor, rank, batch, ordering, rows_per_block)."""
    rng = np.random.default_rng(4)
    one_block = tst.SparseTensor(
        np.stack([rng.integers(0, 16, 300), rng.integers(0, 40, 300), rng.integers(0, 40, 300)],
                 axis=1).astype(np.int32),
        rng.standard_normal(300).astype(np.float32), (256, 40, 40))
    moderate = tst.random_sparse_tensor((3000, 2000, 2500), 200_000, seed=2, zipf_a=0.8)
    return [
        ("3-mode", tst.random_sparse_tensor((97, 40, 33), 1200, seed=3), 16, None, None, 256),
        ("3-mode, uneven", tst.random_sparse_tensor((61, 47, 33), 1201, seed=3), 16, None, None,
         256),
        ("4-mode", tst.random_sparse_tensor((25, 19, 13, 11), 875, seed=4), 16, None, None, 256),
        ("5-mode", tst.random_sparse_tensor((13, 11, 9, 7, 5), 403, seed=5), 16, None, None, 256),
        ("single nonzero", tst.SparseTensor(np.array([[5, 2, 7]], np.int32),
                                            np.array([2.5], np.float32), (11, 6, 9)),
         8, None, None, 256),
        ("rank 1", tst.random_sparse_tensor((30, 20, 10), 200, seed=21), 1, None, None, 256),
        ("one output block", one_block, 16, None, None, 256),
        ("fewer nonzeros than shards", tst.random_sparse_tensor((40, 30, 20), 5, seed=13), 16,
         None, None, 256),
        ("200K nonzeros, B=4", moderate, 16, 4, None, 256),
        ("200K nonzeros, blocked", moderate, 16, None, "blocked", 64),
    ]


def sharded_cases_rank(cases) -> dict:
    """Phase 14 (a) on one rank: every case's ``mttkrp(impl="sharded")``, both
    schemes and every mode, counted (one launch a call, and one more for
    the residual pass of a ``mode_ordered`` partition with leftovers), then
    held against ``mttkrp_ref`` on the card (1e-4 of each element's sum of
    absolute terms, as ``compare``), a ``mode_ordered`` call repeated bit
    for bit, and the rank's own launch on its shard plan against the plain
    version (the last two cases)."""
    from repro_torch.core.mttkrp import mttkrp, mttkrp_ref
    from repro_torch.distributed import mttkrp_dist

    dev = torch.device("cuda", torch.cuda.current_device())
    kmod.reset_launch_counts()  # the main path of (a) on this rank starts here
    outs = []
    for name, t, rank, batch, ordering, rpb in cases:
        facs = factors_on(t.shape, rank, dev, batch=batch, seed=t.nnz)
        for mode in range(t.nmodes):
            for scheme in mttkrp_dist.SCHEMES:
                got = mttkrp(t, facs, mode, impl="sharded", scheme=scheme, ordering=ordering,
                             rows_per_block=rpb)
                outs.append((name, t, facs, mode, scheme, ordering, rpb, got))
    torch.cuda.synchronize()
    launches = kmod.mttkrp_cuda.launches  # ... and ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    by_mode = dict(kmod.mttkrp_cuda.launches_by_mode)
    expected = sum(1 + (mttkrp_dist.sharded_setup(t, mode, scheme=scheme, ordering=ordering,
                                                  rows_per_block=rpb, device=dev)
                        .leftover_plan is not None)
                   for _, t, _, mode, scheme, ordering, rpb, _ in outs)
    worst, repeat_equal, held = 0.0, True, []
    for name, t, facs, mode, scheme, ordering, rpb, got in outs:
        want = mttkrp_ref(t, facs, mode)
        scale = mttkrp_ref(tst.SparseTensor(t.indices, np.abs(t.values), t.shape),
                           [f.abs() for f in facs], mode)
        ratio = (got - want).abs() / (F32_TOL * scale).clamp_min(torch.finfo(torch.float32).tiny)
        worst = max(worst, float(ratio.max()))
        if scheme == "mode_ordered" and name == "200K nonzeros, B=4":
            again = mttkrp(t, facs, mode, impl="sharded", scheme=scheme, rows_per_block=rpb)
            repeat_equal = repeat_equal and torch.equal(got, again)
        if name.startswith("200K"):
            setup = mttkrp_dist.sharded_setup(t, mode, scheme=scheme, ordering=ordering,
                                              rows_per_block=rpb, device=dev)
            held.extend(hold_setup_plans(setup, facs, dev))
    return dict(calls=len(outs), expected=expected, launches=launches, by_variant=by_variant,
                by_mode=by_mode, worst=worst, repeat_equal=repeat_equal,
                plain_max_abs=max(h["max_abs"] for h in held),
                plain_max_rel=max(h["max_rel"] for h in held),
                plain_ok=all(h["ok"] for h in held))


def hold_setup_plans(setup, facs, dev) -> list[dict]:
    """One rank's setup held against the plain version: a split-kernel
    launch over the shard's plan and one over the leftovers' plan (if any),
    each against ``mttkrp_plan_ref`` on the same buffers (``compare``,
    ``F32_TOL``).  These launches are not the main path's."""
    held = []
    for part, plan in (("shard", setup.plan), ("leftovers", setup.leftover_plan)):
        if plan is None:
            continue
        bufs = ops.plan_device_buffers(plan, dev)
        height = plan.shape[setup.mode]
        got = kmod.mttkrp_cuda(bufs, facs, setup.mode, height)
        max_abs, max_rel, ok = compare(bufs, facs, setup.mode, height, got, F32_TOL)
        held.append(dict(scheme=setup.scheme, mode=setup.mode, part=part, nnz=plan.nnz_pad,
                         max_abs=max_abs, max_rel=max_rel, ok=ok))
    return held


def held_line(held: list[dict]) -> str:
    return (f"{len(held)} plans ({sum(h['part'] == 'leftovers' for h in held)} of leftovers, "
            f"{min(h['nnz'] for h in held)}-{max(h['nnz'] for h in held)} padded nonzeros) max_abs "
            f"{max(h['max_abs'] for h in held):.3e} max_rel {max(h['max_rel'] for h in held):.3e} "
            f"(tol {F32_TOL:g} x scale)")


def table2_rank(paths, shape, eager_fits, fused_fits) -> dict:
    """Phase 14 (b) on one rank of ``TABLE2_SHARDS``: phase 3's tensor from
    the memory-mapped files, each mode's setup in both schemes, then eager
    (``mode_ordered`` and ``allreduce``) and fused (``mode_ordered``, B = 4)
    CP-ALS from phase 3's seeds, each after a one-sweep warm-up; then every
    shard plan and leftovers' plan against the plain version, with the
    eager run's factors (phase 3's, up to rounding); then per
    mode, one rank at a time, the local launch queued behind a ~1 ms sleep,
    and with every rank at once
    the collective alone and the whole call, host wall around a sync."""
    from repro_torch.distributed import mttkrp_dist

    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    tensor = tst.SparseTensor(np.load(paths[0], mmap_mode="r"), np.load(paths[1], mmap_mode="r"),
                              shape)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setups = {scheme: [mttkrp_dist.sharded_setup(tensor, m, scheme=scheme, device=dev)
                       for m in range(tensor.nmodes)] for scheme in mttkrp_dist.SCHEMES}
    mttkrp_dist.sharded_fit_operands(tensor, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # One sweep of each run first, so that the timed runs leave out first-call
    # costs (solver handles, the collectives' first buffers, allocator growth).
    for scheme, restarts in (("mode_ordered", 1), ("mode_ordered", RESTARTS), ("allreduce", 1)):
        tfused.cp_als_fused(tensor, RANK, n_iters=1, tol=0.0, seed=0, restarts=restarts,
                            impl="sharded", scheme=scheme, device=dev)
    torch.cuda.synchronize()
    runs, states = {}, {}
    kmod.reset_launch_counts()  # the main path of (b) on this rank starts here
    for label, fn in (
        ("eager mode_ordered", lambda: tcp.cp_als(
            tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, impl="sharded",
            scheme="mode_ordered", device=dev)),
        (f"fused mode_ordered B={RESTARTS}", lambda: tfused.cp_als_fused(
            tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, restarts=RESTARTS, fit_every=SWEEPS,
            impl="sharded", scheme="mode_ordered", device=dev)),
        ("eager allreduce", lambda: tcp.cp_als(
            tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, impl="sharded", scheme="allreduce",
            device=dev)),
    ):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        state = fn()
        torch.cuda.synchronize()
        runs[label] = dict(fits=np.asarray(state.fits).tolist(), s=time.perf_counter() - t0)
        states[label] = state
    launches = kmod.mttkrp_cuda.launches  # ... and ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fitted = [f.contiguous() for f in states["eager mode_ordered"].factors]
    held = [h for per_mode in setups.values() for setup in per_mode
            for h in hold_setup_plans(setup, fitted, dev)]
    # A call is one launch, and one more for a residual pass (mode_ordered's
    # leftovers); eager and fused mode_ordered, then eager allreduce.
    expected = SWEEPS * sum(
        2 * (1 + (s.leftover_plan is not None)) for s in setups["mode_ordered"]) + (
        SWEEPS * len(setups["allreduce"]))

    facs = tcp.cp_init(tensor, RANK, seed=0, device=dev)
    timing = {}
    for scheme, per_mode in setups.items():
        rows = []
        for setup in per_mode:
            local_ms = []
            for turn in range(world):  # one rank at a time: the card is this rank's
                torch.distributed.barrier()
                if turn == rank:
                    for _ in range(SHARD_REPS):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        torch.cuda._sleep(2_000_000)
                        start.record()
                        mttkrp_dist.local_mttkrp(setup, facs)
                        end.record()
                        end.synchronize()
                        local_ms.append(start.elapsed_time(end))
                torch.distributed.barrier()
            block = torch.zeros((setup.rows_per if scheme == "mode_ordered" else setup.i_out,
                                 RANK), device=dev)
            parts = [torch.empty_like(block) for _ in range(world)]
            coll_ms, call_ms = [], []
            for _ in range(SHARD_REPS):
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if scheme == "mode_ordered":
                    torch.distributed.all_gather(parts, block)
                else:
                    torch.distributed.all_reduce(block)
                torch.cuda.synchronize()
                coll_ms.append((time.perf_counter() - t0) * 1e3)
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mttkrp_dist.mttkrp_sharded_apply(setup, facs)
                torch.cuda.synchronize()
                call_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(dict(
                mode=setup.mode, shard_nnz=setup.shard.nnz, height=setup.plan.shape[setup.mode],
                leftovers=0 if setup.leftovers is None else setup.leftovers.nnz,
                local_ms=float(np.median(local_ms)), collective_ms=float(np.median(coll_ms)),
                call_ms=float(np.median(call_ms))))
        timing[scheme] = rows
    return dict(rank=rank, setup_s=setup_s, runs=runs, launches=launches, expected=expected,
                by_variant=by_variant, timing=timing, held=held, peak_gb=peak_gb)


def sharded_phase(dev, card: str, paths, shape, eager_fits, fused_fits, engine_fits) -> dict:
    """Phase 14: the sharded MTTKRP and CP-ALS, one process per rank."""
    from repro_torch.distributed import backend_for, mttkrp_dist, spawn

    phase(f"phase 14: sharded MTTKRP and CP-ALS, one process per rank (worlds {SHARD_WORLDS}; "
          f"Table II on {TABLE2_SHARDS}; the engine on {ENGINE_SHARDS}, "
          f"{SHARDED_ENGINE_TENSORS})")
    fit_tol = tfused.FUSED_FIT_TOL
    launches = {}  # path -> (row-run launches, tile launches), summed over ranks

    # -- (a) the cases, per world size and backend ----------------------------
    cases = sharded_cases()
    rows_a = tiles_a = 0
    for world in SHARD_WORLDS:
        backend = backend_for("cuda", world)
        t0 = time.perf_counter()
        results = spawn(sharded_cases_rank, world, device="cuda", backend=backend, args=(cases,))
        wall = time.perf_counter() - t0
        for r, res in enumerate(results):
            check(res["launches"] == res["expected"] == res["by_variant"]["split"],
                  f"{world} ranks, rank {r}: {res['launches']} launches for {res['calls']} calls, "
                  f"expected {res['expected']} ({res['by_variant']})")
            check(res["worst"] <= 1.0, f"{world} ranks, rank {r}: sharded MTTKRP off mttkrp_ref "
                                      f"by {res['worst']:.3f}x the tolerance")
            check(res["repeat_equal"], f"{world} ranks, rank {r}: mode_ordered not bit for bit")
            check(res["plain_ok"], f"{world} ranks, rank {r}: the shard's launch disagrees with "
                                   f"the plain version")
            rows_a += res["by_mode"]["rows"]
            tiles_a += res["by_mode"]["tiles"]
        print(f"  (a) {world} rank(s), backend {backend} (gloo on the CPU or a shared card, NCCL "
              f"with a card per rank): {len(cases)} cases x modes x 2 schemes, {results[0]['calls']} "
              f"calls a rank, split launches per rank {[r['launches'] for r in results]} (expected "
              f"{results[0]['expected']}: a call, and a residual pass where leftovers; by mode "
              f"{results[0]['by_mode']}); worst |got - ref| / (1e-4 x sum of |terms|) "
              f"{max(r['worst'] for r in results):.4f} (must be <= 1); mode_ordered repeat bit "
              f"for bit equal; shard launch vs plain max_abs "
              f"{max(r['plain_max_abs'] for r in results):.3e} max_rel "
              f"{max(r['plain_max_rel'] for r in results):.3e} (tol {F32_TOL:g} x scale); "
              f"{wall:.1f} s wall")
    launches["mttkrp_sharded, 1 (NCCL) / 3 / 8 ranks (phase 14a)"] = (rows_a, tiles_a)

    # -- (b) Table II, 4 ranks sharing the card ------------------------------
    t0 = time.perf_counter()
    results = spawn(table2_rank, TABLE2_SHARDS, device="cuda",
                    backend=backend_for("cuda", TABLE2_SHARDS),
                    args=(paths, shape, eager_fits, fused_fits))
    wall_b = time.perf_counter() - t0
    first = results[0]
    for res in results:
        check(res["launches"] == res["expected"] == res["by_variant"]["split"],
              f"Table II rank {res['rank']}: {res['launches']} launches, expected {res['expected']}")
        check(all(res["runs"][k]["fits"] == first["runs"][k]["fits"] for k in first["runs"]),
              f"rank {res['rank']}'s fits differ from rank 0's")
        check(all(h["ok"] for h in res["held"]),
              f"Table II rank {res['rank']}: a shard or leftovers plan's launch disagrees with "
              f"the plain version: {[h for h in res['held'] if not h['ok']]}")
    want = {"eager mode_ordered": np.asarray(eager_fits),
            f"fused mode_ordered B={RESTARTS}": np.asarray(fused_fits),
            "eager allreduce": np.asarray(eager_fits)}
    gaps = {}
    print(f"  (b) NELL-2 Table II ({shape}), rank {RANK}, {TABLE2_SHARDS} ranks on the card, backend "
          f"{backend_for('cuda', TABLE2_SHARDS)}: {wall_b:.1f} s wall; setups (both schemes, 3 "
          f"modes) and fit blocks per rank {[round(r['setup_s'], 2) for r in results]} s host; "
          f"split launches per rank {[r['launches'] for r in results]} (expected "
          f"{first['expected']}, residual passes included); "
          f"peak device memory per rank {[round(r['peak_gb'], 3) for r in results]} GB  [{card}]")
    print(f"    every rank's plans against the plain version with the eager run's factors, both "
          f"schemes, every mode: {held_line([h for r in results for h in r['held']])}")
    for label, run in first["runs"].items():
        fits = np.asarray(run["fits"])
        gaps[label] = float(np.max(np.abs(fits - want[label])))
        print(f"    {label}: {run['s']:.3f} s for {SWEEPS} sweeps ({run['s'] / SWEEPS * 1e3:.1f} "
              f"ms a sweep, rank 0's wall); fits {np.round(fits, 6).tolist()}; max gap to phase "
              f"3's single-process lex fits {gaps[label]:.3e} (tol {fit_tol})")
        check(np.isfinite(fits).all() and gaps[label] <= fit_tol,
              f"{label}: sharded fits differ from phase 3's by {gaps[label]}")
    for scheme in first["timing"]:
        for m in range(len(shape)):
            per_rank = [r["timing"][scheme][m] for r in results]
            print(f"    {scheme} mode {m}: shard nnz {[x['shard_nnz'] for x in per_rank]}, "
                  f"local rows {[x['height'] for x in per_rank]}, leftovers "
                  f"{per_rank[0]['leftovers']}; local launch alone (CUDA events, behind a sleep) "
                  f"{[round(x['local_ms'], 4) for x in per_rank]} ms; collective alone "
                  f"{[round(x['collective_ms'], 3) for x in per_rank]} ms wall; whole call "
                  f"{[round(x['call_ms'], 3) for x in per_rank]} ms wall (median of {SHARD_REPS})")
    launches[f"cp_als / cp_als_fused, impl sharded, Table II, {TABLE2_SHARDS} ranks (phase 14b)"] = (
        sum(r["launches"] for r in results), 0)

    # -- (c) the engine's sharded impl -----------------------------------------
    spec = ExperimentSpec(tensors=SHARDED_ENGINE_TENSORS, impls=("sharded",),
                          n_iters=ENGINE_ITERS, fused=True, n_shards=ENGINE_SHARDS, device="cuda")
    t0 = time.perf_counter()
    result = run_experiments(spec)
    engine_s = time.perf_counter() - t0
    rows_c = 0
    for (name, scale), run in zip(SHARDED_ENGINE_TENSORS, result.runs):
        m = run.measured
        residual = sum(max(shares) > 0 for shares in run.residual_share)
        expected = 3 * ENGINE_ITERS * (len(run.dims) + residual)
        # Rank 0's setups of this run, built here as its rank built them
        # (the same tensor, scheme and geometry), held against plain.
        tensor = make_frostt_like(name, scale=scale, seed=spec.seed)
        facs = factors_on(tensor.shape, RANK, dev, seed=tensor.nnz)
        held = [h for mode in range(tensor.nmodes) for h in hold_setup_plans(
            mttkrp_dist.build_sharded_mode_setup(tensor, mode, ENGINE_SHARDS, rank=0,
                                                 scheme=spec.scheme, device=dev), facs, dev)]
        check(all(h["ok"] for h in held), f"{run.key}: rank 0's plans disagree with the plain "
                                          f"version: {[h for h in held if not h['ok']]}")
        del tensor, facs
        ops.clear_caches()  # the memo pins those plans' device buffers
        per_rank = m.launches_per_rank or ()
        gap = abs(m.fit - engine_fits[run.tensor])
        print(f"  (c) {run.key}: {ENGINE_SHARDS} ranks, split launches per rank {list(per_rank)} "
              f"(expected {expected}: {residual} mode(s) with a residual pass); fit {m.fit:.6f}, phase 11's kernel {engine_fits[run.tensor]:.6f}, "
              f"gap {gap:.3e}; fused max gap {m.fused_max_fit_delta:.3e} (tol {fit_tol}); steady ms "
              f"per mode {[round(mm.steady_s * 1e3, 3) for mm in m.modes]} (rank 0's CUDA events "
              f"{[round(mm.steady_device_s * 1e3, 3) for mm in m.modes]}); wall eager "
              f"{m.wall_s:.3f} s, fused cold {m.fused_wall_s:.3f} s, warm {m.fused_warm_wall_s:.3f} s; "
              f"host s {({k: round(v, 2) for k, v in run.host_s.items()})}; max |trace - che(L)| "
              f"{max(h.max_abs_err for h in run.hit_rates):.4f} over {len(run.hit_rates)} scenarios "
              f"(printed, not asserted)")
        print(f"    share of each shard's priced trace its plan does not run (the leftovers, "
              f"run by the residual pass), max over shards per mode "
              f"{[round(max(sh), 4) for sh in run.residual_share]}; rank 0's "
              f"{held_line(held)}")
        check(len(per_rank) == ENGINE_SHARDS and all(n == expected for n in per_rank),
              f"{run.key}: split launches per rank {per_rank}, expected {expected}")
        check(np.isfinite([m.fit, m.fused_fit]).all() and gap <= fit_tol
              and m.fused_max_fit_delta <= fit_tol, f"{run.key}: fits off by {gap}")
        rows_c += sum(per_rank)
    for key, sp in result.speedup_table().items():
        print(f"    {key}: E-SRAM -> O-SRAM speedup priced {sp['priced']:.4f} (Che "
              f"{sp['modeled']:.4f}), energy saving {result.energy_table()[key]['priced']:.4f}")
    print(f"  (c) engine: {engine_s:.1f} s host wall for {len(result.runs)} runs")
    launches[f"run_experiments, impl sharded, {ENGINE_SHARDS} ranks (phase 14c)"] = (rows_c, 0)
    return dict(launches=launches, fit_gaps=gaps, table2_s=wall_b, engine_s=engine_s,
                table2={label: run["s"] / SWEEPS * 1e3 for label, run in first["runs"].items()},
                timing=first["timing"], peak_gb=[r["peak_gb"] for r in results])


def contract_phase(dev, card: str, earlier: list[dict]) -> dict:
    """Phase 15: kernel contracts on the card.  The split kernel's audit build
    (``audit_plan``) on the partition edges of phase 2, in both modes, after
    the Table II plans of phase 10, the service's stacked batch of phase 9
    and phase 11's 5-mode plans (``earlier``, audited where those phases
    built them); then each flash kernel's C entry point run into an output
    filled with NaN on phase 6's input sets, which must leave no NaN and
    equal the wrapper's call bit for bit.  Any failure fails the run."""
    phase("phase 15: kernel contracts on the card (the split kernel's audit build; the flash "
          "kernels into a NaN-filled output)")
    t_start = time.perf_counter()
    audits = list(earlier)
    for name, (t, rank, tile, rpb) in partition_edge_tensors().items():
        facs = factors_on(t.shape, rank, dev, seed=t.nnz)
        for mode in range(t.nmodes):
            bufs = ops.plan_device_buffers(
                tst.build_mttkrp_plan(t, mode, tile_nnz=tile, rows_per_block=rpb), dev)
            for split_mode in kmod.SPLIT_MODES:
                audits.append(audit_plan(bufs, facs, mode, t.shape[mode], t.nnz,
                                         f"partition edge: {name}", card, split_mode=split_mode))
        del facs
    ops.clear_caches()
    flash_sets = flash_bad = 0
    for name, q, k, v, causal in flash_inputs(dev):
        routed = fkmod.variant_for(q.dtype, q.shape[3])
        for variant in (routed, "mma") if q.dtype == torch.bfloat16 else (routed,):
            out = torch.full(q.shape, float("nan"), dtype=q.dtype, device=dev)
            fkmod._launch(q, k, v, out, causal=causal, variant=variant)
            want = fkmod.flash_attention_cuda(q, k, v, causal=causal, variant=variant)
            if bool(torch.isnan(out).any()) or not torch.equal(out, want):
                flash_bad += 1
                print(f"  flash {variant} {name}: NaN left {int(torch.isnan(out).sum())}, "
                      f"equal to the wrapper's call: {torch.equal(out, want)}  FAIL")
            flash_sets += 1
    torch.cuda.synchronize()
    failed = [f"{a['label']} mode {a['mode']} ({a['split_mode']}, B={a['batch']}): "
              f"{'; '.join(a['failures'])}" for a in audits if a["failures"]]
    seconds = time.perf_counter() - t_start + sum(a["seconds"] for a in earlier)
    print(f"  {len(audits)} audited calls ({sum(a['split_mode'] == 'rows' for a in audits)} "
          f"row-run, {sum(a['split_mode'] == 'tiles' for a in audits)} tile), "
          f"{len(failed)} failing; flash: {flash_sets} launches into NaN, {flash_bad} failing; "
          f"{seconds:.1f} s of phase time  [{card}]")
    check(not failed, f"the split kernel breaks its contracts: {failed[:5]}")
    check(flash_bad == 0, f"{flash_bad} flash launches left NaN or differ from the wrapper's")
    table2 = [a for a in audits if a["label"].startswith("NELL-2")]
    return dict(
        audits=len(audits), seconds=seconds, flash_launches=flash_sets,
        table2={f"{a['label'].split(', ')[1]} mode {a['mode']} B={a['batch']}": dict(
            census=a["census"], entries_read=a["entries_read"], excess=a["excess"],
            audit_ms=a["audit_ms"], production_ms=a["production_ms"]) for a in table2},
        excess_per_nnz={m: sum(a["excess"] for a in audits if a["split_mode"] == m)
                        / max(1, sum(a["nnz"] for a in audits if a["split_mode"] == m))
                        for m in kmod.SPLIT_MODES},
    )


def _qkv_on(dev, dtype, b, s, h, kvh, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def lse_phase(dev, card: str) -> dict:
    """Phase 16 (a): each flash kernel's log-sum-exp against the plain
    version's (1e-4 absolute and relative), and its output bit for bit the
    output without it; then the kernel's time with and without the lse store
    at the training shape."""
    cases = [  # label, dtype, B, S, H, KV, D
        ("prefill shape, bf16 D=128", torch.bfloat16, PREFILL_BATCH, PREFILL_SEQ, 16, 8, 128),
        ("prefill shape, bf16 D=64", torch.bfloat16, PREFILL_BATCH, PREFILL_SEQ, 16, 8, 64),
        ("prefill shape, float32 D=128", torch.float32, PREFILL_BATCH, PREFILL_SEQ, 16, 8, 128),
        ("training shape, bf16 D=64", torch.bfloat16, TRAIN_BATCH // TRAIN_MICROBATCHES,
         TRAIN_SEQ, 16, 8, 64),
        ("uneven, bf16 D=64", torch.bfloat16, 3, 1000, 4, 1, 64),
        ("uneven, float32 D=64", torch.float32, 3, 1000, 4, 2, 64),
    ]
    worst = 0.0
    for label, dtype, b, s, h, kvh, d in cases:
        q, k, v = _qkv_on(dev, dtype, b, s, h, kvh, d, seed=s + d)
        _, want = flash_attention_plain(q, k, v, causal=True, q_chunk=PLAIN_Q_CHUNK,
                                        return_lse=True)
        routed = fkmod.variant_for(dtype, d)
        for variant in (routed, "mma") if dtype == torch.bfloat16 else (routed,):
            out, lse = fkmod.flash_attention_cuda(q, k, v, causal=True, variant=variant,
                                                  return_lse=True)
            same = torch.equal(out, fkmod.flash_attention_cuda(q, k, v, causal=True,
                                                               variant=variant))
            diff = (lse - want).abs()
            ok = bool((diff <= LSE_TOL + LSE_TOL * want.abs()).all()) and same
            worst = max(worst, float(diff.max()))
            print(f"  lse {label} ({variant}): max |kernel - plain| {float(diff.max()):.3e} "
                  f"(tol {LSE_TOL:g} abs + rel), out bit for bit the out without lse: {same} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"the {variant} kernel's lse or output is wrong: {label}")
        del q, k, v, want, out, lse
    q, k, v = _qkv_on(dev, torch.bfloat16, TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, 16, 8,
                      64, seed=5)
    plain = median_ms(lambda: fkmod.flash_attention_cuda(q, k, v), FLASH_REPS)
    with_lse = median_ms(lambda: fkmod.flash_attention_cuda(q, k, v, return_lse=True),
                         FLASH_REPS)
    print(f"  wgmma kernel at the training shape {tuple(q.shape)}: {plain:.3f} ms without lse, "
          f"{with_lse:.3f} ms with it  [{card}]")
    return dict(max_abs_err=worst, train_shape_ms=plain, train_shape_lse_ms=with_lse)


def grad_phase(dev, card: str) -> dict:
    """Phase 16 (b): gradients through ``blocked_attention`` (kernel forward,
    plain recomputing backward, full-width blocks 512 x 1024) against
    autograd through the plain dense attention in float32; then the
    backward's time at the training shape beside SDPA's backward."""
    cases = [  # label, dtype, B, S, H, KV, causal
        ("bf16 causal, GQA 16/8, S=1024", torch.bfloat16, 1, 1024, 16, 8, True),
        ("bf16 causal, GQA 16/8, S=4096", torch.bfloat16, 1, 4096, 16, 8, True),
        ("bf16 not causal, GQA 4/1, S=1000", torch.bfloat16, 2, 1000, 4, 1, False),
        ("float32 causal, GQA 16/8, S=1024", torch.float32, 1, 1024, 16, 8, True),
        ("float32 causal, GQA 4/2, S=1000", torch.float32, 2, 1000, 4, 2, True),
    ]
    worst = {}
    for label, dtype, b, s, h, kvh, causal in cases:
        q, k, v = (t.requires_grad_() for t in _qkv_on(dev, dtype, b, s, h, kvh, 64, seed=s))
        w = torch.randn((b, s, h, 64), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
        out = tattn.blocked_attention(q, k, v, causal, 512, 1024)
        got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad((tattn._dense_attention(*ref, causal=causal) * w).sum(), ref)
        rels = [float((g.float() - x).norm() / x.norm()) for g, x in zip(got, want)]
        ok = max(rels) <= GRAD_TOL[dtype]
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), max(rels))
        print(f"  grads {label}: ||got - dense f32|| / ||dense f32|| dq {rels[0]:.2e} dk "
              f"{rels[1]:.2e} dv {rels[2]:.2e} (tol {GRAD_TOL[dtype]:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"blocked-attention gradients disagree with dense autograd: {label}")
        del q, k, v, w, out, got, ref, want
    b, s = TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ
    q, k, v = _qkv_on(dev, torch.bfloat16, b, s, 16, 8, 64, seed=7)
    out, lse = fkmod.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.randn_like(out)
    bwd_ms = median_ms(lambda: tattn._blocked_backward(q, k, v, out, lse, dout, causal=True,
                                                       block_q=512, block_kv=1024), 3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
        sdpa_bwd_ms = median_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), FLASH_REPS)
    flops = 2 * attention_flops(b, s, 16, 64, True)  # dq, dk, dv: twice the forward's products
    bound = flops / BF16_FLOPS_PER_S * 1e3
    print(f"  attention backward at the training shape {tuple(q.shape)} bf16: plain recompute "
          f"{bwd_ms:.3f} ms, SDPA's backward {sdpa_bwd_ms:.3f} ms, bound {bound:.3f} ms "
          f"({flops:.3e} flops at 989 TFLOP/s)  [{card}]")
    return dict(max_rel_err=worst, bwd_ms=bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms, bwd_bound_ms=bound)


def moe_phase(dev, card: str) -> dict:
    """Phase 16 (c): ``moe_layer`` at granite-moe-1b-a400m's width (d 1024,
    32 experts, top-8, moe_d_ff 512) on 8192 tokens, capacity_factor 4 (no
    drops) in float32, against a per-token oracle (each token's top-k
    experts' SwiGLU, gate-weighted, ``tests/test_moe.py``); then, in bf16 at
    the config's capacity, the device ms of the routing with its one-hot
    dispatch and combine products and of the experts, forward and
    forward + backward, and the layer's peak memory."""
    base = get_config(TRAIN_ARCH)
    e, k, d = base.num_experts, base.top_k, base.d_model
    cfg = dataclasses.replace(base, capacity_factor=e / k, dtype=torch.float32)
    params = tmoe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn((TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, d),
                    generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    y = tmoe.moe_layer(params, cfg, x)
    xt = x.reshape(-1, d)
    vals, idx = torch.topk(torch.softmax(xt @ params["router"], -1), k)
    vals = vals / vals.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for ex in range(e):
        rows, slot = (idx == ex).nonzero(as_tuple=True)
        h = xt[rows]
        f = (torch.nn.functional.silu(h @ params["w_gate"][ex]) * (h @ params["w_up"][ex])) \
            @ params["w_down"][ex]
        want.index_add_(0, rows, vals[rows, slot, None] * f)
    diff = (y.reshape(-1, d) - want).abs()
    ok = bool((diff <= MOE_TOL + MOE_TOL * want.abs()).all())
    max_abs = float(diff.max())
    disp, _, _, _ = tmoe.dispatch(params, cfg, x.reshape(-1, cfg.moe_group_size, d))
    kept = int(disp.sum())
    print(f"  moe_layer float32, {xt.shape[0]} tokens, capacity_factor {cfg.capacity_factor:g}: "
          f"max |layer - oracle| {max_abs:.3e} (tol {MOE_TOL:g} abs + rel), slots kept "
          f"{kept} of {xt.shape[0] * k} {'ok' if ok else 'FAIL'}")
    check(ok and kept == xt.shape[0] * k, "moe_layer disagrees with the per-token oracle")
    del params, x, y, want, disp, xt, diff

    cfg = dataclasses.replace(base, dtype=torch.bfloat16)
    params = {n: p.requires_grad_() for n, p in
              tmoe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg).items()}
    x = torch.randn((TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, d),
                    generator=torch.Generator(device=dev).manual_seed(1), device=dev
                    ).to(torch.bfloat16).requires_grad_()
    g, tg = x.shape[0] * x.shape[1] // cfg.moe_group_size, cfg.moe_group_size
    cap = min(max(1, int(cfg.capacity_factor * k * tg / e)), tg)
    xe = torch.randn((e, g * cap, d), device=dev, dtype=torch.bfloat16).requires_grad_()
    with torch.no_grad():
        layer_ms = median_ms(lambda: tmoe.moe_layer(params, cfg, x), 5)
        route_ms = median_ms(lambda: tmoe.dispatch(params, cfg, x.reshape(g, tg, d)), 5)
        experts_ms = median_ms(lambda: tmoe.experts(params, xe), 5)
    dy = torch.randn_like(x)
    inputs = [x, *params.values()]
    layer_fb_ms = median_ms(lambda: torch.autograd.grad(
        tmoe.moe_layer(params, cfg, x), inputs, dy), 5)
    dxe = torch.randn_like(xe)
    experts_fb_ms = median_ms(lambda: torch.autograd.grad(
        tmoe.experts(params, xe), [xe, *params.values()], dxe, allow_unused=True), 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    torch.autograd.grad(tmoe.moe_layer(params, cfg, x), inputs, dy)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    experts_flops = 3 * 2 * e * g * cap * d * cfg.moe_d_ff
    onehot_flops = 2 * 2 * g * tg * e * cap * d
    print(f"  moe_layer bf16 at the training shape {tuple(x.shape)}, capacity {cap} a group: "
          f"forward {layer_ms:.3f} ms (routing and one-hot tensors {route_ms:.3f} ms, experts "
          f"{experts_ms:.3f} ms, the dispatch and combine products the rest, "
          f"{layer_ms - route_ms - experts_ms:.3f} ms); forward + backward {layer_fb_ms:.3f} ms "
          f"(experts {experts_fb_ms:.3f} ms); forward flops: experts {experts_flops:.3e}, "
          f"one-hot dispatch and combine {onehot_flops:.3e}; peak memory of one forward + "
          f"backward above what was held {peak_gb:.2f} GB  [{card}]")
    return dict(layer_ms=layer_ms, route_ms=route_ms, experts_ms=experts_ms,
                layer_fwd_bwd_ms=layer_fb_ms, experts_fwd_bwd_ms=experts_fb_ms,
                peak_gb=peak_gb, max_abs_err=max_abs)


def reduced_training_phase(dev, card: str, workdir: str) -> dict:
    """Phase 16 (d): a reduced granite-moe config, 3 AdamW steps with 2
    microbatches in float32 on the card against the CPU (losses and gradient
    norms 1e-4 relative, every parameter leaf 1e-4 in norm), one bf16 step
    with the fence in against the CPU (``bf16_step_gaps``), then
    ``train()`` on the card: 10 steps with a checkpoint every 5, step 3
    failing twice (replayed from the live state) and step 7 once more than
    the retries allow (restored from step 5's checkpoint), then a resume to
    step 15."""
    small = reduced_config(TRAIN_ARCH, dtype=torch.float32, attention_impl="blocked")
    batches = [next(SyntheticLMStream(small.vocab_size, 256, 4, seed=i)) for i in range(3)]
    runs = {}
    # The bf16 cotangent fence is out of both sides here: it rounds to bf16,
    # so a float32 difference of 1e-7 below it moves a gradient by a bf16
    # step (2^-8), which AdamW's next steps carry (with it: 3.7e-4 on the
    # grad norm, the first run of this phase).  The CPU tests hold the fence to JAX's.
    fence, ttr.grad_fence_bf16 = ttr.grad_fence_bf16, lambda x: x
    try:
        for where in ("cpu", dev):
            state = init_adamw_state(init_model(small, seed=0, device="cpu").to(where), lr=1e-3)
            step = tzoo.make_train_step(small, AdamW(), num_microbatches=2, device=where)
            metrics = []
            for batch in batches:
                state, m = step(state, batch)
                metrics.append({key: float(val) for key, val in m.items()})
            runs[str(where)] = (metrics, tree_to_numpy(state["params"]))
    finally:
        ttr.grad_fence_bf16 = fence
    (cpu_m, cpu_p), (card_m, card_p) = runs["cpu"], runs[str(dev)]
    gaps = [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(card_m, cpu_m)
            for key in ("loss", "grad_norm")]
    leaf_gaps = {}

    def walk(got, want, where=""):
        if isinstance(want, dict):
            for key in want:
                walk(got[key], want[key], f"{where}/{key}")
        else:
            leaf_gaps[where] = float(np.linalg.norm(got - want) / np.linalg.norm(want))

    walk(card_p, cpu_p)
    print(f"  reduced {TRAIN_ARCH} float32 (no bf16 fence), 3 AdamW steps, 2 microbatches: losses "
          f"{[round(m['loss'], 6) for m in card_m]} (card) vs {[round(m['loss'], 6) for m in cpu_m]}"
          f" (CPU); max relative gap of losses and gradient norms {max(gaps):.2e}, of a "
          f"parameter leaf (in norm) {max(leaf_gaps.values()):.2e} (tol {STEP_TOL:g})")
    check(max(gaps) <= STEP_TOL and max(leaf_gaps.values()) <= STEP_TOL,
          "the reduced train steps on the card differ from the CPU's")
    bf16 = bf16_step_gaps(dev, card)

    faults = {"n": 0}

    def fault_hook(step):
        if step == 3 and faults["n"] < 2:
            faults["n"] += 1
            raise RuntimeError("injected preemption")
        if step == 7 and faults["n"] == 2:
            faults["n"] += 1
            raise RuntimeError("injected node loss")

    small = reduced_config(TRAIN_ARCH, num_layers=2)
    mk = lambda: SyntheticLMStream(small.vocab_size, 64, 4)  # noqa: E731
    loop = lambda n: TrainLoopConfig(total_steps=n, log_every=1, save_every=5,  # noqa: E731
                                     max_step_retries=2, checkpoint_dir=workdir)
    first = train(small, loop(10), stream=mk(), fault_hook=fault_hook, device=dev)
    second = train(small, loop(15), stream=mk(), device=dev)
    losses = [h["loss"] for h in first["history"] + second["history"]]
    ok = (faults["n"] == 3 and int(first["state"]["step"]) == 10
          and second["resumed_from"] == 10 and int(second["state"]["step"]) == 15
          and all(np.isfinite(losses)))
    print(f"  reduced train() on the card: 3 faults injected, steps {int(first['state']['step'])}"
          f", resumed from {second['resumed_from']} to {int(second['state']['step'])}, losses "
          f"finite {all(np.isfinite(losses))} {'ok' if ok else 'FAIL'}")
    check(ok, "the reduced training loop did not survive its faults or resume")
    return dict(max_gap=max(gaps), max_leaf_gap=max(leaf_gaps.values()), bf16=bf16)


def _leaf_items(tree: dict, where: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaf_items(val, f"{where}/{key}")
        else:
            yield f"{where}/{key}", np.array(val, np.float32)  # a copy: the step updates in place


def bf16_step_gaps(dev, card: str) -> dict:
    """Phase 16 (d), bf16: one SGD step (lr 1, so each update is the
    gradient) of a reduced granite-moe config as (e) runs it: bf16 compute
    over float32 masters, the cotangent fence in every layer, MoE routing,
    remat "full", the blocked attention (the kernel on the card, the plain
    version on the CPU).  Each leaf's update, card against CPU, within
    BF16_STEP_TOL in norm and within BF16_STEP_ELEM of its largest element
    on all but BF16_STEP_FLIPS of its elements; and the card's distance to
    the float32 config's update (on the CPU) within BF16_F32_RATIO of the
    CPU's."""
    small = reduced_config(TRAIN_ARCH, attention_impl="blocked")
    batch = next(SyntheticLMStream(small.vocab_size, 256, 4, seed=3))
    updates = {}
    for label, cfg, where in (("card", small, dev), ("cpu", small, "cpu"),
                              ("cpu float32", dataclasses.replace(small, dtype=torch.float32),
                               "cpu")):
        model = init_model(small, seed=0, device="cpu").to(where)
        before = dict(_leaf_items(tree_to_numpy(model)))
        launched = fkmod.flash_attention_cuda.launches
        state, _ = tzoo.make_train_step(cfg, None, device=where)({"params": model, "lr": 1.0},
                                                                 batch)
        if label == "card":
            check(fkmod.flash_attention_cuda.launches - launched == 2 * small.num_layers,
                  "the bf16 step did not launch the flash kernel in each layer's forward "
                  "and recompute")
        updates[label] = {k: v - before[k]
                          for k, v in _leaf_items(tree_to_numpy(state["params"]))}
    rel = {k: float(np.linalg.norm(updates["card"][k] - w) / np.linalg.norm(w))
           for k, w in updates["cpu"].items()}
    off = {k: float((np.abs(updates["card"][k] - w) > BF16_STEP_ELEM * np.abs(w).max()).mean())
           for k, w in updates["cpu"].items()}
    to_f32 = {side: {k: float(np.linalg.norm(updates[side][k] - w) / np.linalg.norm(w))
                     for k, w in updates["cpu float32"].items()} for side in ("card", "cpu")}
    ratio = {k: to_f32["card"][k] / to_f32["cpu"][k] for k in to_f32["cpu"]}
    worst_rel, worst_off = max(rel, key=rel.get), max(off, key=off.get)
    worst_ratio = max(ratio, key=ratio.get)
    ok = (rel[worst_rel] <= BF16_STEP_TOL and off[worst_off] <= BF16_STEP_FLIPS
          and ratio[worst_ratio] <= BF16_F32_RATIO)
    print(f"  reduced {TRAIN_ARCH} bf16 (fence in, remat full, kernel forward), one SGD step, "
          f"each leaf's update card vs CPU: max ||card - cpu|| / ||cpu|| {rel[worst_rel]:.3e} "
          f"({worst_rel}; tol {BF16_STEP_TOL:g}), max share of elements off by more than "
          f"{BF16_STEP_ELEM:g} x the leaf's largest {off[worst_off]:.2e} ({worst_off}; tol "
          f"{BF16_STEP_FLIPS:g}); gap to the float32 config's update, largest: card "
          f"{max(to_f32['card'].values()):.3e}, CPU {max(to_f32['cpu'].values()):.3e}, largest "
          f"card / CPU {ratio[worst_ratio]:.3f} ({worst_ratio}; tol {BF16_F32_RATIO:g}) "
          f"{'ok' if ok else 'FAIL'}  [{card}]")
    check(ok, "the bf16 train step on the card differs from the CPU's")
    return dict(max_rel=rel[worst_rel], max_off_share=off[worst_off],
                max_ratio_to_f32=ratio[worst_ratio], card_to_f32=max(to_f32["card"].values()),
                cpu_to_f32=max(to_f32["cpu"].values()))


def classify_step(fn, extra: dict | None = None) -> dict:
    """One call of ``fn`` under torch.profiler: device ms by kernel class
    (the flash forward by its kernel's name; cuBLAS products; ``extra``'s
    classes, name substring -> class; the rest), the top kernels, and the
    device's busy ms."""
    extra = extra or {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes = {"flash forward": 0.0, "matrix products (cuBLAS)": 0.0,
               **{c: 0.0 for c in extra.values()}, "rest": 0.0}
    for e in events:
        name = e.key.lower()
        hit = next((c for sub, c in extra.items() if sub in name), None)
        if hit is not None:
            key = hit
        elif "flash_fwd" in name:
            key = "flash forward"
        elif any(t in name for t in ("gemm", "sm90_", "cutlass", "nvjet", "xmma")):
            key = "matrix products (cuBLAS)"
        else:
            key = "rest"
        classes[key] += e.self_device_time_total / 1e3
    top = [(e.key[:80], e.count, e.self_device_time_total / 1e3) for e in events[:12]]
    return dict(classes=classes, busy_ms=sum(classes.values()), top=top)


def full_training_phase(dev, card: str, workdir: str, parts: dict) -> dict:
    """Phase 16 (e): granite-moe-1b-a400m at full width and depth through
    ``launch/train.py``'s path (``train()``, AdamW with warm-up-cosine), B = 4,
    S = 4096, 2 microbatches, remat "full", 6 steps, no checkpoint (one
    would be 16.6 GB): losses, step time, tokens/s, peak memory, flash
    launches, then one step under the profiler."""
    cfg = get_config(TRAIN_ARCH)
    args = tlaunch.parse_args([
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ),
        "--batch", str(TRAIN_BATCH), "--microbatches", str(TRAIN_MICROBATCHES),
        "--log-every", "1", "--save-every", str(TRAIN_STEPS + 1), "--checkpoint-dir", workdir,
        "--device", str(dev)])
    marks = []

    def mark(step):  # each step's start, after the device is done with the last one
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fkmod.reset_launch_counts()  # the main path of phase 16 starts here
    res = tlaunch.run(args, fault_hook=mark)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    launches = fkmod.flash_attention_cuda.launches  # the main path of phase 16 ends here
    by_variant = dict(fkmod.flash_attention_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res["history"]]
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    median_s = float(np.median(step_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    expected = TRAIN_STEPS * 2 * cfg.num_layers * TRAIN_MICROBATCHES
    attn = attention_flops(TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.head_dim, True)
    model_flops = 6 * cfg.active_param_count() * tokens + 3 * cfg.num_layers * attn
    print(f"  {TRAIN_ARCH}: {cfg.param_count() / 1e9:.3f}e9 parameters, "
          f"{cfg.active_param_count() / 1e9:.3f}e9 active; B={TRAIN_BATCH} S={TRAIN_SEQ}, "
          f"{TRAIN_MICROBATCHES} microbatches, remat {cfg.remat_policy}")
    print(f"  losses {[round(x, 5) for x in losses]}")
    print(f"  step wall times {[round(t, 3) for t in step_s]} s (each ends in a sync); median "
          f"of steps 2-{TRAIN_STEPS} {median_s:.3f} s, {tokens / median_s:.0f} tokens/s; peak "
          f"memory {peak_gb:.2f} GB; flash launches {launches} (expected {expected}: "
          f"{cfg.num_layers} layers x forward and recompute x {TRAIN_MICROBATCHES} microbatches "
          f"x {TRAIN_STEPS} steps), by variant {by_variant}  [{card}]")
    print(f"  model FLOPs a step {model_flops:.3e} (6 x active params x tokens + 3 x the causal "
          f"attention's forward flops), {model_flops / median_s / 1e12:.1f} TFLOP/s, "
          f"{model_flops / median_s / BF16_FLOPS_PER_S:.3f} of 989 TFLOP/s")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")
    check(launches == expected and by_variant["wgmma"] == launches,
          f"training launched the flash kernel {launches} times ({by_variant}), not {expected}")

    state = res["state"]
    del res
    step_fn = tzoo.make_train_step(cfg, AdamW(), num_microbatches=TRAIN_MICROBATCHES,
                                   device=dev)
    batch = next(SyntheticLMStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1))
    arg_bytes = (sum(t.numel() * t.element_size()
                     for t in tree_leaves(dict(state, params=param_tree(state["params"]))))
                 + sum(np.asarray(v).nbytes for v in batch.values()))
    prof = classify_step(lambda: step_fn(state, batch))
    n_layer_mb = cfg.num_layers * TRAIN_MICROBATCHES
    isolated = {  # one microbatch-layer's ms (CUDA events) times the count in a step
        "flash forward (forward and recompute)": 2 * n_layer_mb * parts["lse"]["train_shape_lse_ms"],
        "attention backward (plain)": n_layer_mb * parts["grad"]["bwd_ms"],
        "MoE routing, dispatch and combine (fwd, recompute, bwd)": n_layer_mb * (
            parts["moe"]["layer_fwd_bwd_ms"] + parts["moe"]["layer_ms"]
            - parts["moe"]["experts_fwd_bwd_ms"] - parts["moe"]["experts_ms"]),
        "MoE experts (fwd, recompute, bwd)": n_layer_mb * (
            parts["moe"]["experts_fwd_bwd_ms"] + parts["moe"]["experts_ms"]),
    }
    busy = max(prof["busy_ms"], 1e-9)
    print(f"  one step under torch.profiler: device busy {busy:.1f} ms of a {median_s * 1e3:.1f} "
          f"ms step (idle share {max(0.0, 1 - busy / (median_s * 1e3)):.3f})")
    for key, ms in prof["classes"].items():
        print(f"    by kernel name: {key:<28} {ms:10.1f} ms  {ms / busy:6.1%}")
    for key, ms in isolated.items():
        print(f"    by isolated timing x count: {key:<56} {ms:10.1f} ms  {ms / busy:6.1%}")
    rest = busy - sum(isolated.values())
    print(f"    by isolated timing x count: {'the rest (projections, lm_head and loss, norms, '
          f'optimizer)':<56} {rest:10.1f} ms  {rest / busy:6.1%}")
    for name, count, ms in prof["top"]:
        print(f"    {ms:10.3f} ms  x{count:<6} {name}")
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, losses=losses, step_s=step_s, median_step_s=median_s,
                tokens_per_s=tokens / median_s, peak_gb=peak_gb, arg_bytes=arg_bytes,
                model_flops=model_flops,
                mfu=model_flops / median_s / BF16_FLOPS_PER_S, busy_ms=busy,
                by_kernel_name_ms=prof["classes"], by_isolated_ms=dict(isolated, rest=rest))


def training_phase(dev, card: str) -> dict:
    """Phase 16: training and the MoE family on the card, (a)-(e)."""
    phase("phase 16: training and the MoE family on the card")
    t0 = time.perf_counter()
    parts = {"lse": lse_phase(dev, card), "grad": grad_phase(dev, card),
             "moe": moe_phase(dev, card)}
    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        parts["reduced"] = reduced_training_phase(dev, card, str(Path(workdir, "reduced")))
        parts["full"] = full_training_phase(dev, card, str(Path(workdir, "full")), parts)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    parts["seconds"] = time.perf_counter() - t0
    print(f"  phase 16 took {parts['seconds']:.1f} s")
    return parts


# Phase 17: the RWKV-6, hybrid (Mamba2), encoder-decoder and VLM families at
# full width, through the recurrence kernels and the flash kernel.
FAMILY_BATCH = 2  # prefill_32k's global batch of 32, cut to 2
FAMILY_SEQ = 32_768  # prefill_32k's length
FAMILY_REPS = 3  # timed prefills after one warm-up
FAMILY_CHECK_SEQ = 256
FAMILY_DECODE = 128  # teacher-forced decode steps
VLM_ARCH = "internvl2-26b"
VLM_LAYERS = 8  # of 48: float32 masters of all 48 outgrow the 80 GB card
VLM_BATCH = 1
SCAN_TOL = 1e-4  # of the largest |plain| of each (b, h): float32 sums in another order
# recurrent_blocks: float32 on both sides; the scans alone differ by up to
# 2.4e-5 (WKV-6) and 2.5e-6 (SSD) of a head's largest output over phase 17
# (a)'s cases on an H100, the layer's norms and products add float32
# rounding; 1e-3 leaves 40x room and is 50x below BF16_SCALE_TOL.  The whole-model bf16 comparison does not hold for
# rwkv6-3b with random weights: on the CPU a relative 1e-6 perturbation of
# each layer's WKV output grows ~1.9x a layer in float32 (2e-5, 1e-4, 1.2e-3
# of the logits at 2, 4 and 8 full-width layers), and bf16 rounding alone
# puts 2.3% between two runs at 2 layers; at 32 layers the two correct
# paths differ by half the logits' range.  So rwkv6-3b's whole-model bf16
# checks are held at RWKV_HELD_LAYERS full-width layers (a model of its own,
# init_model(seed=0)) and printed at 32.
BLOCK_TOL = 1e-3
RWKV_HELD_LAYERS = 4
# The chunked kernels cut 32-step chunks into 16-step sub-chunks: lengths at
# and around both edges, beside PR 23's.
SCAN_SEQS = (1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 129, 1000)
SCAN_BATCHES = (1, 3)
SCAN_HEADS = (1, 5, 40)
# Decay draws beyond the models' (SCAN_DECAY_SHAPES each; rdraws.DECAYS):
# exact zeros ("strong"), none ("unit"), one near-zero decay among mild ones
# ("spike").  "misaligned" views start 4 bytes into their buffer.
SCAN_DECAYS = ("strong", "unit", "spike")
SCAN_DECAY_SHAPES = ((1, 65, 5), (3, 1000, 40))  # (B, S, H)
# The chunked kernels' tensor-core work: mma.sync m16n8k8 (2048 TF32 flops)
# a CTA (one (b, h)) and 32-step chunk, the 3xTF32 split's three products
# each.  WKV-6: (r P) S_start 128, A's off-diagonal block 16, A V over A's
# three 16 x 16 lower blocks 48, (k Q)^T V 128: 320 x 3.  SSD: C h^T 128,
# C B^T's lower blocks 48, (Ls C B^T) X 48, (suf B)^T X 128: 352 x 3.
SCAN_CHUNK = 32
SCAN_MMA_PER_CHUNK = {"wkv6": 960, "ssd": 1056}
MMA_TF32_FLOPS = 2 * 16 * 8 * 8
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
# Row 2's training shape (B, S_q, S_kv, H, KV, D, causal) and phase 17's new ones.
FLASH_NEW_SHAPES = {
    "training shape (phase 16e): B=2 S=4096 H=16 KV=8 D=64 causal": (2, 4096, 4096, 16, 8, 64, True),
    "zamba2-1.2b shared block: B=2 S=32768 H=32 KV=32 D=64 causal": (2, 32768, 32768, 32, 32, 64,
                                                                   True),
    "whisper-base encoder: B=2 S=32768 H=8 D=64 not causal": (2, 32768, 32768, 8, 8, 64, False),
    "whisper-base cross-attention: B=2 S_q=448 S_kv=32768 H=8 D=64": (2, 448, 32768, 8, 8, 64,
                                                                      False),
}


@contextlib.contextmanager
def plain_scans():
    """The models' recurrences through their plain per-step loops, on the
    card too (the kernel-against-plain checks); restored on exit."""
    saved = trwkv.wkv6_scan_logw, tssm.ssd_scan_logdec
    trwkv.wkv6_scan_logw = lambda r, k, v, log_w, u: rref.wkv6_scan_ref(r, k, v, torch.exp(log_w), u)
    tssm.ssd_scan_logdec = lambda log_dec, *rest: rref.ssd_scan_ref(torch.exp(log_dec), *rest)
    try:
        yield
    finally:
        trwkv.wkv6_scan_logw, tssm.ssd_scan_logdec = saved


class _Captured(Exception):
    pass


def first_call_args(module, name: str, run) -> list:
    """Clones of the tensors the first call of ``module.<name>`` gets in
    ``run()``; that call raises, so ``run`` stops there."""
    real, got = getattr(module, name), {}

    def hook(*args):
        got["args"] = [a.clone() for a in args]
        raise _Captured

    setattr(module, name, hook)
    try:
        run()
    except _Captured:
        pass
    finally:
        setattr(module, name, real)
    check("args" in got, f"{module.__name__}.{name} was not called")
    return got["args"]


def scan_inputs(kind: str, b: int, s: int, h: int, dev, **kw):
    """Phase 17 (a)'s inputs, drawn as tests/test_torch_recurrence_cuda.py
    draws them (kernels/recurrence/draws.py)."""
    return (rdraws.wkv_inputs if kind == "wkv6" else rdraws.ssd_inputs)(b, s, h, dev, **kw)


SCANS = {"wkv6": (rkmod.wkv6_scan_cuda, rref.wkv6_scan_ref),
         "ssd": (rkmod.ssd_scan_cuda, rref.ssd_scan_ref)}


def per_head_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| over each (b, h) of (B, S, H, 64)."""
    scale = want.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


def scan_case_list() -> list[dict]:
    """Phase 17 (a)'s cases: every (S, B, H) of SCAN_SEQS x SCAN_BATCHES x
    SCAN_HEADS, contiguous and strided, with the models' decays; then each of
    SCAN_DECAYS at SCAN_DECAY_SHAPES, contiguous, strided and misaligned."""
    cases = [dict(s=s, b=b, h=h, strided=strided)
             for s, b, h, strided in itertools.product(SCAN_SEQS, SCAN_BATCHES, SCAN_HEADS,
                                                       (False, True))]
    cases += [dict(s=s, b=b, h=h, strided=lay == "strided", misaligned=lay == "misaligned",
                   decay=decay)
              for decay in SCAN_DECAYS for b, s, h in SCAN_DECAY_SHAPES
              for lay in ("contiguous", "strided", "misaligned")]
    cases += [dict(s=s, b=b, h=h, strided=False, misaligned=True)
              for b, s, h in SCAN_DECAY_SHAPES]
    return cases


def scan_cases(dev) -> dict:
    """Phase 17 (a): both recurrence kernels against their plain versions,
    each case launched twice."""
    worst = {}
    cases = scan_case_list()
    for kind, (kernel, plain) in SCANS.items():
        failures, errs, by_regime = [], [], {}
        for case in cases:
            case = dict(case)
            s, b, h = case.pop("s"), case.pop("b"), case.pop("h")
            args = scan_inputs(kind, b, s, h, dev, seed=s * 7 + h + b, **case)
            got, again = kernel(*args), kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = per_head_error(got, want)
            errs.append(err)
            regime = (case.get("decay", "model"), "misaligned" if case.get("misaligned") else
                      "strided" if case["strided"] else "contiguous")
            by_regime[regime] = max(by_regime.get(regime, 0.0), err)
            if not (err <= SCAN_TOL and torch.equal(got, again) and got.shape == want.shape):
                failures.append(f"S={s} B={b} H={h} {case}: error {err:.3e}, "
                                f"repeat equal {torch.equal(got, again)}")
        worst[kind] = max(errs)
        print(f"  {kind} kernel: {len(errs)} cases (S {SCAN_SEQS}, B {SCAN_BATCHES}, H "
              f"{SCAN_HEADS}, contiguous and strided; decays {SCAN_DECAYS} and misaligned views "
              f"at (B, S, H) {SCAN_DECAY_SHAPES}), max error {max(errs):.3e} of each (b, h)'s "
              f"largest |plain| (tol {SCAN_TOL:g}), every repeat bit for bit; worst by (decay, "
              f"layout): { {f'{d}/{l}': float(f'{e:.3e}') for (d, l), e in by_regime.items()} }")
        check(not failures, f"the {kind} kernel disagrees with its plain version: {failures[:5]}")
    return worst


def scan_full_shape(kind: str, args: list, card: str) -> dict:
    """One kernel at the main path's shape (layer 0's inputs) against its plain
    loop: error, CUDA-event times and the bound, the larger of the bytes
    (each input read once, y written once) and the kernel's own tensor-core
    products at the TF32 peak."""
    kernel, plain = SCANS[kind]
    got = kernel(*args)
    times = [median_ms(lambda: kernel(*args), FLASH_REPS) for _ in range(2)]
    ms = float(np.median(times))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = per_head_error(got, want)
    max_abs = float((got - want).abs().max())
    b, s, h, hd = got.shape
    nbytes = (sum(a.numel() for a in args) + got.numel()) * 4
    flops = SCAN_MMA_PER_CHUNK[kind] * MMA_TF32_FLOPS * b * h * -(-s // SCAN_CHUNK)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / TF32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  {kind} kernel at B={b} S={s} H={h} (layer 0's inputs): {[round(t, 3) for t in times]} "
          f"ms (medians of {FLASH_REPS}), plain loop {plain_ms:.1f} ms, bound {bound_ms:.3f} ms by "
          f"{bound_by} ({nbytes / 1e9:.3f} GB at 3.35 TB/s, {bytes_ms:.3f} ms; {flops:.3e} TF32 "
          f"flops of its 3xTF32 products at 495 TFLOP/s, {ops_ms:.3f} ms), share of bound "
          f"{bound_ms / ms:.3f}; error {err:.3e} of each (b, h)'s largest |plain| (tol "
          f"{SCAN_TOL:g}), max |kernel - plain| {max_abs:.3e}  [{card}]")
    check(err <= SCAN_TOL, f"the {kind} kernel disagrees with its plain loop at full shape")
    return dict(ms=ms, times_ms=times, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max_abs, rel_err=err, shape=[b, s, h, hd])


LAUNCH_COUNTERS = {"flash": lambda: fkmod.flash_attention_cuda.launches,
                   "wkv6": lambda: rkmod.wkv6_scan_cuda.launches,
                   "ssd": lambda: rkmod.ssd_scan_cuda.launches,
                   "wkv6_bwd": lambda: rkmod.wkv6_scan_bwd_cuda.launches,
                   "ssd_bwd": lambda: rkmod.ssd_scan_bwd_cuda.launches}


def family_prefill(label: str, cfg, model, batch: dict, positions: int, expect: dict,
                   card: str) -> dict:
    """``make_prefill_fn`` once to warm up and FAMILY_REPS times timed; each
    run must launch each kernel as ``expect`` says, the flash kernel as wgmma."""
    prefill = make_prefill_fn(cfg, device=batch["tokens"].device)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    times, walls = [], []
    fkmod.reset_launch_counts()  # the main path starts here
    rkmod.reset_launch_counts()
    for rep in range(1 + FAMILY_REPS):
        before = {k: f() for k, f in LAUNCH_COUNTERS.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = prefill(model, batch)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        grew = {k: f() - before[k] for k, f in LAUNCH_COUNTERS.items()}
        check(grew == {k: expect.get(k, 0) for k in grew},
              f"{label}: prefill {rep} launched {grew}, expected {expect}")
        if rep:
            times.append(start.elapsed_time(end))
    launches = {k: f() for k, f in LAUNCH_COUNTERS.items()}  # the main path ends here
    by_variant = dict(fkmod.flash_attention_cuda.launches_by_variant)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(times))
    b = batch["tokens"].shape[0]
    check(logits.shape == (b, cfg.padded_vocab), f"{label}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite next-token logits")
    check(bool((logits[:, cfg.vocab_size:] < -1e8).all()), f"{label}: padded vocabulary not masked")
    check(by_variant["wgmma"] == launches["flash"], f"{label}: flash launches {by_variant}")
    profile = profile_prefill(prefill, model, batch, ms, None)
    print(f"  {label} prefill: median {ms:.2f} ms (CUDA events; runs "
          f"{[round(t, 2) for t in times]}), host wall {[round(w, 2) for w in walls[1:]]} ms, "
          f"{positions / ms * 1e3:.0f} positions/s; launches over {1 + FAMILY_REPS} prefills "
          f"{launches} ({expect} each; flash by variant {by_variant}); peak device memory "
          f"{peak:.2f} GB  [{card}]")
    del logits
    return dict(ms=ms, walls_ms=walls[1:], positions_per_s=positions / ms * 1e3, peak_gb=peak,
                launches=launches, per_prefill=expect, profile_ms=profile)


def family_vs_plain(label: str, cfg, model, batch: dict, *, hold: bool = True) -> dict:
    """The kernel path (scan kernels, the flash kernel: ``attention_impl``
    "blocked") against the plain one (plain scans, dense attention).  With
    ``hold=False`` the gap is printed, not checked (rwkv6-3b at 32 layers:
    see BLOCK_TOL)."""
    with torch.inference_mode():
        kern = forward(model, dataclasses.replace(cfg, attention_impl="blocked"), batch)
        with plain_scans():
            plain = forward(model, dataclasses.replace(cfg, attention_impl="dense"), batch)
    check(kern.shape[:2] == batch["tokens"].shape[:2],
          f"{label}: logits {tuple(kern.shape)}, one a token expected (after any prefix)")
    gap, scale = logits_gap(kern, plain, cfg.vocab_size)
    print(f"  {label}, kernel path vs plain path (plain scans, dense attention), "
          f"{ {k: tuple(v.shape) for k, v in batch.items()} }: max |gap| {gap:.4f} of max |logit| "
          f"{scale:.3f} ({f'tol {BF16_SCALE_TOL} x scale' if hold else 'printed, not held'})")
    check(not hold or gap <= BF16_SCALE_TOL * scale,
          f"{label}: the kernel path's logits differ from plain")
    return dict(gap=gap, scale=scale, held=hold)


def family_decode(label: str, cfg, model, toks: torch.Tensor, frames=None, *,
                  hold: bool = True) -> dict:
    """Teacher-forced decode of ``toks`` (1, n) against ``forward``; whisper's
    cross cache filled from ``frames`` by ``fill_cross_cache``.  With
    ``hold=False`` the gap is printed, not checked (rwkv6-3b at 32 layers)."""
    dev = toks.device
    batch = {"tokens": toks} if frames is None else {"tokens": toks, "frames": frames}
    state = init_decode_state(cfg, 1, toks.shape[1], device=dev)
    decode = make_decode_fn(cfg, device=dev)
    with torch.inference_mode():
        full = forward(model, cfg, batch)[0].float()
        if frames is not None:
            ttr.fill_cross_cache(model, cfg, frames, state)
    torch.cuda.synchronize()
    fkmod.reset_launch_counts()  # the main path (decode_step) starts here
    rkmod.reset_launch_counts()
    t0 = time.perf_counter()
    steps = [decode(model, toks[:, t], state)[0][0] for t in range(toks.shape[1])]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f() for k, f in LAUNCH_COUNTERS.items()}  # and ends here
    gap, scale = logits_gap(torch.stack(steps), full, cfg.vocab_size)
    n = toks.shape[1]
    print(f"  {label}, teacher-forced decode of {n} tokens against forward: max |gap| {gap:.4f} "
          f"of max |logit| {scale:.3f} ({f'tol {BF16_SCALE_TOL} x scale' if hold else 'printed, not held'}); "
          f"{seconds:.2f} s host, {n / seconds:.1f} steps/s; pos {state['pos'].tolist()}; "
          f"hand-written kernels launched by the decode steps {launches}")
    check(bool(torch.isfinite(torch.stack(steps)).all()), f"{label}: non-finite decode logits")
    check(not hold or gap <= BF16_SCALE_TOL * scale, f"{label}: decode logits differ from forward's")
    check(state["pos"].tolist() == [n], f"{label}: pos did not advance once a step")
    check(not any(launches.values()), f"{label}: the decode path launched a hand-written kernel")
    return dict(gap=gap, scale=scale, seconds=seconds, steps_per_s=n / seconds, held=hold,
                launches=launches)


def recurrent_blocks(label: str, cfg, model, toks: torch.Tensor) -> dict:
    """Block by block in float32 (a block: one rwkv6-3b layer; one zamba2-1.2b
    group of ``shared_attn_every`` Mamba layers with the shared block after
    it, and the trailing layers): from the kernel path's input to each block,
    the block's output through the kernel path (scan kernels, the flash
    kernel's float32 variant), through the plain one (plain scans, dense
    attention) and through the decode path's per-token update
    (``transformer._decode_rwkv`` / ``_decode_hybrid``, a state of the block's
    own); each output's change to the residual within BLOCK_TOL of the
    largest.  Random-weight models this deep amplify any difference: a
    whole-model comparison holds two correct paths only as far as the
    amplification allows (see BLOCK_TOL)."""
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    kern_cfg = dataclasses.replace(c32, attention_impl="blocked")
    plain_cfg = dataclasses.replace(c32, attention_impl="dense")
    p = model.params()
    b, n = toks.shape
    every = cfg.shared_attn_every or 1
    if cfg.rwkv:
        blocks = [(i, i + 1) for i in range(cfg.num_layers)]
    else:
        blocks = [(lo, min(lo + every, cfg.num_layers)) for lo in range(0, cfg.num_layers, every)]

    def seq(c, lo, hi, x):
        for i in range(lo, hi):
            lp = p["layers"][i]
            x = (ttr._rwkv_layer_seq(lp, c, x) if cfg.rwkv
                 else ttr._hybrid_layer_seq(lp, c, x, p.get("shared_attn"), i))
        return x

    def stepped(lo, hi, x):
        params = {"layers": p["layers"][lo:hi], "shared_attn": p.get("shared_attn")}
        state = {k: v[lo:hi] if k not in ("pos", "shared_k", "shared_v") else v
                 for k, v in init_decode_state(c32, b, n, cache_dtype=torch.float32,
                                               device=toks.device).items()}
        if "shared_k" in state:
            g = lo // every
            state["shared_k"], state["shared_v"] = (state[k][g:g + 1]
                                                    for k in ("shared_k", "shared_v"))
        outs = []
        for t in range(n):
            step = ttr._decode_rwkv if cfg.rwkv else ttr._decode_hybrid
            outs.append(step(params, c32, x[:, t:t + 1], state))
            state["pos"] += 1
        return torch.cat(outs, dim=1)

    worst = {"plain": 0.0, "decode": 0.0}
    with torch.inference_mode():
        x = p["embed"]["emb"][toks.long()].float()
        for lo, hi in blocks:
            y = seq(kern_cfg, lo, hi, x)
            with plain_scans():
                y_plain = seq(plain_cfg, lo, hi, x)
            y_dec = stepped(lo, hi, x)
            scale = float((y - x).abs().max())
            for key, other in (("plain", y_plain), ("decode", y_dec)):
                worst[key] = max(worst[key], float((other - y).abs().max()) / scale)
            x = y
    print(f"  {label}, block by block in float32 ({len(blocks)} blocks, B={b}, S={n}): each "
          f"block's output through the plain path within {worst['plain']:.3e}, through the "
          f"decode steps within {worst['decode']:.3e} of its largest change to the residual "
          f"(tol {BLOCK_TOL:g})")
    check(worst["plain"] <= BLOCK_TOL, f"{label}: a block's kernel path differs from plain")
    check(worst["decode"] <= BLOCK_TOL, f"{label}: a block's decode steps differ from forward")
    return dict(blocks=len(blocks), plain=worst["plain"], decode=worst["decode"])


def family_serve(label: str, cfg, model, dev, card: str) -> dict:
    """``launch/serve.py``'s load through ``BatchServer`` (8 requests, 4 slots,
    ``max_len`` 48), then a reused slot's tokens against a fresh server's."""
    n_req, slots, max_len = SERVE_RUNS["launch/serve.py's load"][0], 4, 48
    srv = BatchServer(cfg, model, ServeConfig(max_slots=slots, max_len=max_len), device=dev)
    events = []
    srv.decode = timed_decode(srv.decode, events)
    torch.cuda.synchronize()
    fkmod.reset_launch_counts()  # the main path (BatchServer) starts here
    rkmod.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n_req):
        srv.submit(f"req-{i}", [2 + (i % 11), 5, 7, 3])
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(d["tokens"]) for d in done)
    tick_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    check(sorted(d["id"] for d in done) == sorted(f"req-{i}" for i in range(n_req)),
          f"{label}: a request was not answered")
    check(all(d["tokens"] for d in done), f"{label}: an empty answer")
    prompt = next(SyntheticLMStream(cfg.vocab_size, 16, 1, seed=5))["tokens"][0].tolist()
    outs = []
    for first in ([3, 3], None):
        srv = BatchServer(cfg, model, ServeConfig(max_slots=1, max_len=32, eos_id=-1), device=dev)
        if first is not None:
            srv.submit("a", first)
        srv.submit("b", prompt)
        outs.append({d["id"]: d["tokens"] for d in srv.run_until_drained()}["b"])
    launches = {k: f() for k, f in LAUNCH_COUNTERS.items()}  # the main path ends here
    print(f"  {label}, BatchServer on launch/serve.py's load: {len(done)} of {n_req} requests, "
          f"{tokens} tokens in {len(events)} ticks, {wall:.2f} s, {tokens / wall:.1f} tokens/s; "
          f"ticks median {tick_ms:.3f} ms between CUDA events ({wall / len(events) * 1e3:.3f} ms "
          f"wall each); a reused slot's tokens {'equal' if outs[0] == outs[1] else 'DIFFER FROM'} "
          f"a fresh server's; hand-written kernels launched by the servers {launches}  [{card}]")
    check(outs[0] == outs[1], f"{label}: a reused slot's tokens differ from a fresh server's")
    check(not any(launches.values()), f"{label}: the serving path launched a hand-written kernel")
    return dict(requests=len(done), tokens=tokens, ticks=len(events), wall_s=wall,
                tokens_per_s=tokens / wall, tick_device_ms_p50=tick_ms, launches=launches)


def lm_tokens(cfg, b: int, s: int, dev, seed: int) -> torch.Tensor:
    return torch.from_numpy(next(SyntheticLMStream(cfg.vocab_size, s, b, seed=seed))["tokens"]
                            ).to(dev)


def bf16_randn(shape, dev, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def flash_new_shapes(dev, card: str) -> dict:
    """The wgmma kernel at row 2's training shape and at the shapes phase 17
    gives it, against its plain version (row and elementwise limits), with its
    time, the plain version's, SDPA's (a yardstick the port never calls) and
    the bound."""
    out = {}
    for label, (b, s, skv, h, kvh, d, causal) in FLASH_NEW_SHAPES.items():
        q = bf16_randn((b, s, h, d), dev, s + h)
        k, v = (bf16_randn((b, skv, kvh, d), dev, skv + kvh + i) for i in range(2))
        got = fkmod.flash_attention_cuda(q, k, v, causal=causal)
        ms = median_ms(lambda: fkmod.flash_attention_cuda(q, k, v, causal=causal), FLASH_REPS)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = flash_attention_plain(q, k, v, causal=causal, q_chunk=PLAIN_Q_CHUNK)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        row = max_row_error(got, want)
        diff = (got.float() - want.float()).abs()
        within = bool((diff <= BF16_TOL + BF16_TOL * want.float().abs()).all())
        max_abs = float(diff.max())
        del want, diff
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=kvh != h), FLASH_REPS)
        del qt, kt, vt
        pairs = s * (s + 1) // 2 if causal else s * skv
        flops = 4 * d * pairs * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
        print(f"  flash (wgmma) at {label}: {ms:.3f} ms, plain {plain_ms:.1f} ms, SDPA "
              f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}, share of bound "
              f"{bound_ms / ms:.3f}; max row error {row:.3e} (tol {FLASH_ROW_TOL[q.dtype]:g}), "
              f"elementwise {'ok' if within else 'FAIL'}  [{card}]")
        check(row <= FLASH_ROW_TOL[q.dtype] and within,
              f"the wgmma flash kernel disagrees with its plain version at {label}")
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_row_err=row, max_abs_err=max_abs)
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def decode_launches(fams: dict, kind: str) -> dict:
    """Launches of one kernel counted on phase 17's decode and serving paths."""
    return {f"{path}, {arch} (phase 17)": entry[key]["launches"][kind]
            for arch, entry in fams.items()
            for key, path in (("decode", "decode_step"), ("serve", "BatchServer"))
            if key in entry}


def scan_entries(families: dict) -> list[dict]:
    """The ``kernels`` line's entries of the two recurrence kernels, from phase 17."""
    fams = families["families"]
    out = []
    for kind, arch, name, site, what in (
            ("wkv6", "rwkv6-3b", "wkv6_scan_kernel", "src/repro/models/rwkv.py:154",
             "the lax.scan of rwkv_time_mix_seq (through _chunked_scan); no Pallas kernel"),
            ("ssd", "zamba2-1.2b", "ssd_scan_kernel", "src/repro/models/ssm.py:108",
             "the lax.scan of mamba_seq (through _chunked_scan); no Pallas kernel")):
        full = fams[arch][f"{kind}_full"]
        b, s, h, hd = full["shape"]
        by_path = {f"prefill, {arch} (phase 17)": fams[arch]["prefill"]["launches"][kind],
                   **decode_launches(fams, kind),
                   f"train(), {arch} full width, forward and recompute (phase 18c)":
                       families["trained"]["train"][arch]["launches"][kind]}
        out.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/recurrence/csrc/recurrence.cu",
            replaces=site, replaces_note=what, launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=full["max_abs_err"],
            max_err_per_head=full["rel_err"], cases_max_err=families["scan_cases_max_err"][kind],
            ms=full["ms"], times_ms=full["times_ms"], plain_ms=full["plain_ms"],
            bound_ms=full["bound_ms"], bound_by=full["bound_by"], library_ms=None,
            per=f"one layer's scan, B={b} S={s} H={h} float32, layer 0's inputs of {arch}",
            prefill_ms=fams[arch]["prefill"]["ms"]))
    return out


def families_phase(dev, card: str) -> dict:
    """Phase 17: the recurrence kernels against plain, then zamba2-1.2b,
    rwkv6-3b and whisper-base at full width and depth and internvl2-26b at
    full width, 8 of 48 layers: prefill (launches counted per kernel), the
    kernel path against the plain one, decode against forward, serving; the
    flash kernel at the new shapes beside SDPA."""
    t_start = time.perf_counter()
    phase("phase 17: the RWKV-6, hybrid, encoder-decoder and VLM families on the card")
    print("  (a) the recurrence kernels against their plain loops")
    worst = scan_cases(dev)
    result = {"scan_cases_max_err": worst, "families": {}}
    fam = result["families"]

    # (b) zamba2-1.2b: Mamba2 layers through the SSD kernel, the shared block through flash.
    cfg = get_config("zamba2-1.2b")
    print(f"  (b) {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads, head_dim {cfg.head_dim}, ssm_state {cfg.ssm_state}, shared block every "
          f"{cfg.shared_attn_every}, {cfg.param_count() / 1e9:.3f}e9 parameters, {cfg.dtype}")
    model = init_model(cfg, seed=0, device=dev)
    batch = {"tokens": lm_tokens(cfg, FAMILY_BATCH, FAMILY_SEQ, dev, seed=0)}
    n_shared = cfg.num_layers // cfg.shared_attn_every
    entry = {"prefill": family_prefill(cfg.name, cfg, model, batch, FAMILY_BATCH * FAMILY_SEQ,
                                       {"flash": n_shared, "wkv6": 0, "ssd": cfg.num_layers}, card)}
    with torch.inference_mode():
        args = first_call_args(tssm, "ssd_scan_logdec", lambda: forward(model, cfg, batch))
    args[0] = torch.exp(args[0])  # the decay, as the scan forms it from its log
    entry["ssd_full"] = scan_full_shape("ssd", args, card)
    del args
    entry["vs_plain"] = family_vs_plain(cfg.name, cfg, model, {
        "tokens": lm_tokens(cfg, 2, FAMILY_CHECK_SEQ, dev, seed=1)})
    entry["decode"] = family_decode(cfg.name, cfg, model, lm_tokens(cfg, 1, FAMILY_DECODE, dev, 3))
    entry["blocks"] = recurrent_blocks(cfg.name, cfg, model,
                                       lm_tokens(cfg, 2, FAMILY_DECODE, dev, seed=4))
    entry["serve"] = family_serve(cfg.name, cfg, model, dev, card)
    fam[cfg.name] = entry
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) rwkv6-3b: every layer's WKV through the WKV-6 kernel, no attention.
    cfg = get_config("rwkv6-3b")
    print(f"  (c) {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // 64} WKV heads, d_ff {cfg.d_ff}, {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters, {cfg.dtype}")
    model = init_model(cfg, seed=0, device=dev)
    batch = {"tokens": lm_tokens(cfg, FAMILY_BATCH, FAMILY_SEQ, dev, seed=0)}
    entry = {"prefill": family_prefill(cfg.name, cfg, model, batch, FAMILY_BATCH * FAMILY_SEQ,
                                       {"flash": 0, "wkv6": cfg.num_layers, "ssd": 0}, card)}
    with torch.inference_mode():
        args = first_call_args(trwkv, "wkv6_scan_logw", lambda: forward(model, cfg, batch))
    args[3] = torch.exp(args[3])  # w, as the scan forms it from its log
    entry["wkv6_full"] = scan_full_shape("wkv6", args, card)
    del args
    # The whole-model gaps at 32 layers are printed; they are held at
    # RWKV_HELD_LAYERS layers and block by block (BLOCK_TOL says why).
    entry["vs_plain"] = family_vs_plain(cfg.name, cfg, model, {
        "tokens": lm_tokens(cfg, 2, FAMILY_CHECK_SEQ, dev, seed=1)}, hold=False)
    entry["decode"] = family_decode(cfg.name, cfg, model, lm_tokens(cfg, 1, FAMILY_DECODE, dev, 3),
                                    hold=False)
    cut = dataclasses.replace(cfg, num_layers=RWKV_HELD_LAYERS)
    cut_model, cut_label = init_model(cut, seed=0, device=dev), f"{cfg.name} ({cut.num_layers} layers)"
    entry["vs_plain_cut"] = family_vs_plain(cut_label, cut, cut_model, {
        "tokens": lm_tokens(cut, 2, FAMILY_CHECK_SEQ, dev, seed=1)})
    entry["decode_cut"] = family_decode(cut_label, cut, cut_model,
                                        lm_tokens(cut, 1, FAMILY_DECODE, dev, 3))
    del cut_model
    entry["blocks"] = recurrent_blocks(cfg.name, cfg, model,
                                       lm_tokens(cfg, 2, FAMILY_DECODE, dev, seed=4))
    entry["serve"] = family_serve(cfg.name, cfg, model, dev, card)
    fam[cfg.name] = entry
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (d) whisper-base on input_specs(prefill_32k), its batch cut to 2.
    cfg = get_config("whisper-base")
    specs = input_specs(cfg, dataclasses.replace(SHAPES["prefill_32k"],
                                                 global_batch=FAMILY_BATCH))
    print(f"  (d) {cfg.name}: {cfg.encoder_layers} encoder and {cfg.num_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads, head_dim {cfg.head_dim}; input_specs: "
          f"{ {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()} }")
    model = init_model(cfg, seed=0, device=dev)
    frames = bf16_randn(tuple(specs["frames"].shape), dev, 0)
    batch = {"frames": frames, "tokens": lm_tokens(cfg, *specs["tokens"].shape, dev, seed=0)}
    entry = {"prefill": family_prefill(
        cfg.name, cfg, model, batch, frames.shape[0] * frames.shape[1],
        {"flash": cfg.encoder_layers + cfg.num_layers, "wkv6": 0, "ssd": 0}, card)}
    del batch, frames
    entry["vs_plain"] = family_vs_plain(cfg.name, cfg, model, {
        "frames": bf16_randn((2, FAMILY_CHECK_SEQ, cfg.d_model), dev, 1),
        "tokens": lm_tokens(cfg, 2, 64, dev, seed=1)})
    entry["decode"] = family_decode(
        cfg.name, cfg, model, lm_tokens(cfg, 1, 64, dev, seed=3),
        frames=bf16_randn((1, cfg.max_target_len, cfg.d_model), dev, 3))
    fam[cfg.name] = entry
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (e) internvl2-26b at full width, depth cut, 1024 patch embeddings before the text.
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    specs = input_specs(cfg, dataclasses.replace(SHAPES["prefill_32k"], global_batch=VLM_BATCH))
    print(f"  (e) {VLM_ARCH}: {VLM_LAYERS} of {get_config(VLM_ARCH).num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads, {cfg.num_kv_heads} KV heads, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}; input_specs: "
          f"{ {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()} }")
    model = init_model(cfg, seed=0, device=dev)
    batch = {"prefix_embeds": bf16_randn(tuple(specs["prefix_embeds"].shape), dev, 0),
             "tokens": lm_tokens(cfg, *specs["tokens"].shape, dev, seed=0)}
    entry = {"prefill": family_prefill(f"{VLM_ARCH} ({VLM_LAYERS} layers)", cfg, model, batch,
                                       VLM_BATCH * FAMILY_SEQ,
                                       {"flash": VLM_LAYERS, "wkv6": 0, "ssd": 0}, card)}
    del batch
    entry["vs_plain"] = family_vs_plain(VLM_ARCH, cfg, model, {
        "prefix_embeds": bf16_randn((1, 64, cfg.d_model), dev, 1),
        "tokens": lm_tokens(cfg, 1, FAMILY_CHECK_SEQ - 64, dev, seed=1)})
    fam[VLM_ARCH] = entry
    del model
    gc.collect()
    torch.cuda.empty_cache()

    print("  (f) the flash kernel at row 2's training shape and phase 17's shapes")
    result["flash_shapes"] = flash_new_shapes(dev, card)
    result["seconds"] = time.perf_counter() - t_start
    print(f"  phase 17 took {result['seconds']:.1f} s")
    return result


# Phase 18: training the RWKV-6, hybrid, encoder-decoder and VLM families on
# the card, through the scan kernels' backward kernels and the flash kernel.
TRAIN_FAMILY_SEQ = 4096  # train_4k's length
TRAIN_FAMILY_BATCH = 2  # train_4k's global batch of 256, cut to what one card holds
TRAIN_FAMILY_STEPS = 4  # the first one warms up
WHISPER_TRAIN_BATCH = 4
VLM_TRAIN_LAYERS = 4  # of 48: AdamW's masters and moments of all 48 need ~240 GB
BWD_SHAPES = {"wkv6": ("rwkv6-3b", (2, 4096, 40)), "ssd": ("zamba2-1.2b", (2, 4096, 64))}
PTXAS: dict[str, str] = {}  # mangled kernel name -> ptxas -v's resources, from phase 1's build
BWD_REPS = 5
# tests/test_torch_train_families.py: float32 AdamW steps at lr 1e-3 within
# 1e-4 relative.  The recurrent families' reduced configs amplify float32
# rounding in their scans into their gradients and moments; each limit lies
# between what sound runs read and what a control reads (scripts/
# torch_family_step_gaps.py, seeds 0-2, NVIDIA H100 80GB HBM3 at 700 W):
# card vs CPU with the scan kernels, and with the plain step loops on the
# card, against the kernels with their operands and gradients rounded to
# TF32 (one TF32 pass, not 3xTF32).  rwkv6-3b: sound up to 5.16e-3 (the
# plain loops on the card; the kernels 2.54e-3 at seed 0, this phase's),
# control 0.328-0.433; the CPU's own float32 scan lies 1.7e-4-4.0e-3 from a
# float64 one.  zamba2-1.2b: sound up to 2.79e-4 (kernels, seed 0; the
# plain loops 1.31e-4), control 7.96e-4-1.06e-3.  Both families' blocks are
# held in float32 at full width in (c), 1e-3 of each gradient's norm.
FAMILY_STEP_TOL = {"rwkv6-3b": 1e-2, "zamba2-1.2b": 5e-4}
FAMILY_STEP_LR = 1e-3
# One recurrent block's gradients in float32, scan kernels against plain
# loops: each leaf within 1e-3 of its norm (one layer: the forward blocks of
# phase 17 hold 1e-3 of the residual's change; a gradient sums such terms).
GRAD_BLOCK_TOL = 1e-3
GRAD_BLOCK_BATCH = 1  # the plain loop's autograd keeps a state a step: 8.6 GB at H = 64


def bwd_inputs(kind: str, b: int, s: int, h: int, dev, **kw):
    """Phase 18 (a)'s inputs (phase 17 (a)'s draws) and a cotangent dy."""
    args = scan_inputs(kind, b, s, h, dev, **kw)
    gen = torch.Generator(device=dev).manual_seed(kw.get("seed", 0) + 1)
    return args, torch.randn((b, s, h, 64), generator=gen, device=dev)


# Each backward kernel's plain version: its chunked algorithm in plain
# PyTorch (kernels/recurrence/ref.py), which the CPU tests hold against
# autograd through the step loops and against jax.vjp; run here in float64,
# so that a gradient that is one 64-term dot product (S = 1: dv = A[0, 0]
# dy_0) is held to its exact value, not to another float32 rounding of a
# sum that cancels.  The step loops under autograd, the independent oracle,
# hold each block's gradients in (c); tests/test_torch_recurrence_cuda.py
# holds the kernels to them over this grid.
BWD = {"wkv6": (rkmod.wkv6_scan_bwd_cuda, rref.wkv6_scan_bwd_chunked_ref),
       "ssd": (rkmod.ssd_scan_bwd_cuda, rref.ssd_scan_bwd_chunked_ref)}


def bwd_plain(kind: str, args, dy, dtype=torch.float64) -> list[torch.Tensor]:
    """The plain version's gradients in float32, as bwd_errors compares them
    (the SSD's dbm and dcm summed over the heads)."""
    out = BWD[kind][1](*(a.to(dtype) for a in args), dy.to(dtype))
    if kind == "ssd":
        out = (out[0], out[1], out[2].sum(2), out[3].sum(2))
    return [t.float() for t in out]


def bwd_errors(kind: str, got, want) -> list[float]:
    """Each gradient's largest |kernel - plain| over the largest |plain| of its
    (b, h) (du: of its head; the SSD's per-head dbm and dcm summed over the
    heads: of its sequence)."""
    if kind == "ssd":
        got = (got[0], got[1], got[2].sum(2), got[3].sum(2))
        dims = [(1,), (1, 3), (1, 2), (1, 2)]
    else:
        dims = [(1, 3)] * 4 + [(1,)]
    out = []
    for g, w, d in zip(got, want, dims):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{kind} backward: a gradient of shape {tuple(g.shape)} (plain {tuple(w.shape)}) "
              "or not finite")
        scale = w.abs().amax(dim=d, keepdim=True).clamp_min(1e-30)
        out.append(float(((g - w).abs() / scale).max()) if w.numel() else 0.0)
    return out


def bwd_cases(dev) -> dict:
    """Phase 18 (a): both backward kernels against their plain versions (in
    float64) over phase 17 (a)'s cases, each launched twice."""
    worst = {}
    for kind, (kernel, plain) in BWD.items():
        failures, errs = [], []
        for case in scan_case_list():
            case = dict(case)
            s, b, h = case.pop("s"), case.pop("b"), case.pop("h")
            args, dy = bwd_inputs(kind, b, s, h, dev, seed=s * 11 + h + b, **case)
            got, again = kernel(*args, dy), kernel(*args, dy)
            each = bwd_errors(kind, got, bwd_plain(kind, args, dy))
            err = max(each)
            errs.append(err)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            if not (err <= SCAN_TOL and same):
                failures.append(f"S={s} B={b} H={h} {case}: errors {[f'{e:.2e}' for e in each]}"
                                f", repeat equal {same}")
        worst[kind] = max(errs)
        print(f"  {kind} backward kernel: {len(errs)} cases (phase 17 (a)'s), max error "
              f"{max(errs):.3e} of each (b, h)'s largest |plain| over every gradient (tol "
              f"{SCAN_TOL:g}), every repeat bit for bit")
        check(not failures, f"the {kind} backward kernel disagrees with its plain version: "
                            f"{failures[:5]}")
    return worst


def bwd_min_flops(kind: str, b: int, s: int, h: int) -> tuple[int, int]:
    """The operations the backward function needs on these shapes, counted
    per (b, h) and 32-step chunk of L steps in the chunked form with its
    O(L^2) sums, ``(products, elementwise)``; the products are counted as the
    forward rows count theirs, three a 3xTF32 product.  Products: the five
    state products (2 L 64^2 each: the chunk-start state's recompute, the
    start state's share of dr (WKV-6) or dc (SSD), the end state's of dk
    and dv (WKV-6) or db and dx (SSD), G's update) and the pair products
    (2 a pair and column: WKV-6's D, A, dv's A^T dy over the pairs with
    their diagonal, dr's and dk's over the pairs below it; the SSD's E,
    C B^T, dc, db and dx over the pairs with their diagonal).  Elementwise:
    the decays' gradient, a product and two prefix sums a pair and column
    (WKV-6; a pair for the SSD) and its start- and end-state parts."""
    n, d = SCAN_CHUNK, 64
    pairs, incl = n * (n - 1) // 2, n * (n + 1) // 2
    state = 5 * 2 * n * d * d
    if kind == "wkv6":
        products = state + 3 * 2 * incl * d + 2 * 2 * pairs * d
        elementwise = 3 * pairs * d + 4 * n * d + 2 * d * d
    else:
        products = state + 5 * 2 * incl * d
        elementwise = 3 * incl + 4 * n * d + 2 * d * d
    per = b * h * -(-s // SCAN_CHUNK)
    return 3 * products * per, elementwise * per


def bwd_kernel_flops(kind: str, b: int, s: int, h: int) -> dict[str, int]:
    """What the backward kernels' own algorithm (csrc/recurrence_bwd.cu)
    computes on these shapes, by where it runs, per (b, h) and 32-step chunk
    of L steps, both CTAs of a (b, h) summed.  "tf32": the 3xTF32 products,
    each counted three times, per CTA (a half of the key dimension): WKV-6's
    recompute, S0 dy^T, G v^T and G's update, L 64^2 each, D (formed whole
    in both CTAs) 2 L^2 64, dv's [A^T | k Q] [dy; G] 2 L^2 64 + L 64^2; the
    SSD's dy h0, x G, b G^T, the recompute and G's update, L 64^2 each, and
    Ls E b, (Ls E)^T c and half of (Ls C B^T)^T dy, L^2 64 each.  "f64_tc":
    the SSD's E and C B^T in float64 on the tensor cores, 2 L^2 64 each in
    both CTAs.  "f32", on the CUDA cores: WKV-6's pair work, every lane of a
    warp at every row tau > 0 for each of the 64 channels, 16 flops (W's
    running product, dki's and the pairs' terms, the prefix sum's adds); the
    SSD's pairs (one CTA: 16 a lane and row) and pair matrices (4 an entry,
    both CTAs).  "f64", float64 on the CUDA cores: WKV-6's D diagonal in
    both CTAs and the bonus, 2 a term.  Printed beside the bound, not part
    of it."""
    n, d = SCAN_CHUNK, 64
    if kind == "wkv6":
        out = dict(tf32=3 * 2 * (5 * n * d * d + 4 * n * n * d), f64_tc=0,
                   f32=(n - 1) * 32 * d * 16, f64=2 * (2 * n * d) + 2 * n * d)
    else:
        out = dict(tf32=3 * 2 * (5 * n * d * d + 3 * n * n * d), f64_tc=2 * 2 * (2 * n * n * d),
                   f32=(n - 1) * 32 * 16 + 2 * 4 * n * n, f64=0)
    per = b * h * -(-s // SCAN_CHUNK)
    return {k: v * per for k, v in out.items()}


def bwd_full_shape(kind: str, card: str) -> dict:
    """Phase 18 (a): one backward kernel at the training shape (B = 2, S =
    4096, the family's heads; strided views with the models' decays), its
    forward kernel's time beside it, its plain version (float32 timed, held
    in float64), and the bound: the larger of its bytes (each input and dy
    read once, each gradient written once) and the function's operations
    (``bwd_min_flops``), its products at the TF32 rate as the forward rows
    count theirs, the rest at the float32 rate, the two times summed."""
    arch, (b, s, h) = BWD_SHAPES[kind]
    kernel, plain = BWD[kind]
    fwd = SCANS[kind][0]
    args, dy = bwd_inputs(kind, b, s, h, resolve_device("cuda"), seed=5, strided=True)
    got = kernel(*args, dy)
    times = [median_ms(lambda: kernel(*args, dy), BWD_REPS) for _ in range(2)]
    ms = float(np.median(times))
    fwd_ms = median_ms(lambda: fwd(*args), BWD_REPS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain(*args, dy)  # the plain version in float32: its time
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    want = bwd_plain(kind, args, dy)
    errs = bwd_errors(kind, got, want)
    g_ssd = (got[0], got[1], got[2].sum(2), got[3].sum(2)) if kind == "ssd" else got
    max_abs = max(float((g - w).abs().max()) for g, w in zip(g_ssd, want))
    del want, got
    read = (sum(a.numel() for a in args) + dy.numel()) * 4  # inputs and dy, once each
    if kind == "wkv6":  # dr, dk, dv, dlogw and du
        written = (4 * dy.numel() + args[4].numel()) * 4
    else:  # dlogdec, ddtx, dbm and dcm (the kernel's per-head ones are its own)
        written = (args[0].numel() + dy.numel() + 2 * args[2].numel()) * 4
    nbytes = read + written
    products, elementwise = bwd_min_flops(kind, b, s, h)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (products / TF32_FLOPS_PER_S + elementwise / F32_FLOPS_PER_S) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    own = bwd_kernel_flops(kind, b, s, h)
    own_ms = (own["tf32"] / TF32_FLOPS_PER_S + own["f64_tc"] / F64_TC_FLOPS_PER_S
              + own["f32"] / F32_FLOPS_PER_S + own["f64"] / F64_FLOPS_PER_S) * 1e3
    grid = rkmod.bwd_grid(kind, b, h)
    resources = {k: v for k, v in PTXAS.items() if f"{kind}_scan_bwd_kernel" in k}
    print(f"  {kind} backward kernel's grid at B={b} H={h}: {grid['ctas']} CTAs of "
          f"{grid['threads']} threads, {grid['smem_bytes']} bytes of shared memory each, "
          f"{grid['per_sm']} resident an SM on {grid['sms']} SMs: "
          f"{'one wave' if grid['one_wave'] else 'MORE THAN ONE WAVE'}; ptxas: "
          f"{'; '.join(resources.values()) or 'not built in this process'}")
    check(grid["one_wave"] and grid["per_sm"] >= 2,
          f"the {kind} backward kernel's grid is not resident in one wave: {grid}")
    print(f"  {kind} backward kernel at {arch}'s training shape B={b} S={s} H={h}: "
          f"{[round(t, 3) for t in times]} ms (medians of {BWD_REPS}); its forward kernel "
          f"{fwd_ms:.3f} ms; plain (the chunked algorithm, float32) {plain_ms:.1f} ms; bound "
          f"{bound_ms:.3f} ms by {bound_by} ({nbytes / 1e9:.3f} GB at 3.35 TB/s, {bytes_ms:.3f} "
          f"ms; the function's {products:.3e} TF32 product flops at 495 TFLOP/s and "
          f"{elementwise:.3e} float32 elementwise at 67, {ops_ms:.3f} ms), share of bound "
          f"{bound_ms / ms:.3f}; the kernel's own algorithm {own['tf32']:.3e} TF32 tensor-core flops "
          f"at 495 TFLOP/s, {own['f64_tc']:.3e} float64 tensor-core at 67, {own['f32']:.3e} "
          f"float32 at 67 and {own['f64']:.3e} float64 at 34, {own_ms:.3f} ms; error "
          f"{max(errs):.3e} of each (b, h)'s largest |plain| (tol {SCAN_TOL:g}), max |kernel - "
          f"plain| {max_abs:.3e}  [{card}]")
    check(max(errs) <= SCAN_TOL, f"the {kind} backward kernel disagrees with plain at full shape")
    return dict(ms=ms, times_ms=times, fwd_ms=fwd_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=max_abs, rel_err=max(errs), shape=[b, s, h, 64],
                grid=grid, ptxas=resources, own_ms=own_ms)


def family_train_batch(cfg, b: int, dev, seed: int, *, seq: int = 32, frames: int = 40,
                       prefix: int = 8) -> dict:
    """A batch of the family's inputs: tokens and labels, and whisper's
    frames or internvl2's patch embeddings (float32)."""
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(SyntheticLMStream(cfg.vocab_size, seq, b, seed=seed)).items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((b, frames, cfg.d_model), generator=gen, device=dev)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = torch.randn((b, prefix, cfg.d_model), generator=gen, device=dev)
    return batch


def reduced_family_steps(dev, card: str) -> dict:
    """Phase 18 (b): each family's reduced config, 3 float32 AdamW steps with
    2 microbatches on the card against the CPU (the bf16 cotangent fence out
    of both sides, as phase 16 (d)): losses, gradient norms and every leaf of
    the parameters and both moments; the card's steps must launch each scan's
    forward and backward kernels, and the flash kernel."""
    out = {}
    fence, ttr.grad_fence_bf16 = ttr.grad_fence_bf16, lambda x: x
    try:
        for arch in ("rwkv6-3b", "zamba2-1.2b", "whisper-base", "internvl2-26b"):
            small = reduced_config(arch, dtype=torch.float32, attention_impl="blocked")
            batches = [family_train_batch(small, 4, "cpu", seed=i) for i in range(3)]
            runs = {}
            for where in ("cpu", dev):
                rkmod.reset_launch_counts()
                fkmod.reset_launch_counts()
                state = init_adamw_state(init_model(small, seed=0, device="cpu").to(where),
                                         lr=FAMILY_STEP_LR)
                step = tzoo.make_train_step(small, AdamW(), num_microbatches=2, device=where)
                metrics = []
                for batch in batches:
                    state, m = step(state, batch)
                    metrics.append({key: float(val) for key, val in m.items()})
                runs[str(where)] = (metrics, tree_to_numpy(state), {
                    k: f() for k, f in LAUNCH_COUNTERS.items()})
            (cpu_m, cpu_s, _), (card_m, card_s, launched) = runs["cpu"], runs[str(dev)]
            gaps = [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(card_m, cpu_m)
                    for key in ("loss", "grad_norm")]
            leaf = {}
            for (where, want), got in zip(_leaf_items({k: cpu_s[k] for k in ("params", "m", "v")}),
                                          (g for _, g in _leaf_items(
                                              {k: card_s[k] for k in ("params", "m", "v")}))):
                leaf[where] = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
            worst = max(leaf, key=leaf.get)
            tol = FAMILY_STEP_TOL.get(arch, STEP_TOL)
            expect = {"wkv6": small.rwkv, "wkv6_bwd": small.rwkv,
                      "ssd": small.family == "hybrid", "ssd_bwd": small.family == "hybrid",
                      "flash": not small.rwkv}
            launches_ok = all((launched[k] > 0) == want for k, want in expect.items())
            print(f"  reduced {arch} float32, 3 AdamW steps (lr {FAMILY_STEP_LR:g}), 2 "
                  f"microbatches, card vs CPU: losses {[round(m['loss'], 6) for m in card_m]}; max "
                  f"relative gap of losses and gradient norms {max(gaps):.2e}, of a leaf of the "
                  f"parameters and moments (in norm) {leaf[worst]:.2e} ({worst}; tol {tol:g}); "
                  f"card launches {launched} {'ok' if launches_ok else 'FAIL'}")
            check(max(gaps) <= tol and leaf[worst] <= tol,
                  f"reduced {arch}: the card's train steps differ from the CPU's")
            check(launches_ok, f"reduced {arch}: the card's steps launched {launched}")
            out[arch] = dict(max_gap=max(gaps), max_leaf_gap=leaf[worst], launches=launched)
    finally:
        ttr.grad_fence_bf16 = fence
    return out


SCAN_CLASSES = {"wkv6_scan_bwd": "WKV-6 backward kernel", "ssd_scan_bwd": "SSD backward kernel",
                "wkv6_scan_kernel": "WKV-6 forward kernel", "ssd_scan_kernel": "SSD forward kernel"}


def block_grads(arch: str, cfg, model, toks: torch.Tensor) -> dict:
    """Phase 18 (c): layer 0 of the model in float32 on its inputs (the
    embedded tokens), its output against a fixed random cotangent: every
    gradient (its input's and each weight's) through the scan kernels and
    their backward kernels against the plain loops under autograd."""
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    lp = {k: v.detach().float() for k, v in model.params()["layers"][0][
        "rwkv" if cfg.rwkv else "mamba"].items()}
    lp_full = {k: (v.detach().float() if not isinstance(v, dict) else None)
               for k, v in model.params()["layers"][0].items()}
    x = model.params()["embed"]["emb"][toks.long()].detach().float()
    gen = torch.Generator(device=x.device).manual_seed(9)
    cot = torch.randn(x.shape, generator=gen, device=x.device)

    def grads():
        leaves = {k: v.clone().requires_grad_() for k, v in lp.items()}
        xin = x.clone().requires_grad_()
        layer = dict(lp_full, **({"rwkv": leaves} if cfg.rwkv else {"mamba": leaves}))
        out = (ttr._rwkv_layer_seq(layer, c32, xin) if cfg.rwkv
               else ttr._hybrid_layer_seq(layer, c32, xin, None, 0))
        names = ["x", *leaves]
        got = torch.autograd.grad(out, [xin, *leaves.values()], cot, allow_unused=True,
                                  materialize_grads=True)
        return dict(zip(names, got))

    before = {k: f() for k, f in LAUNCH_COUNTERS.items()}
    kern = grads()
    launched = {k: f() - before[k] for k, f in LAUNCH_COUNTERS.items()}
    with plain_scans():
        plain = grads()
    rel = {k: float((kern[k] - plain[k]).norm() / plain[k].norm().clamp_min(1e-30)) for k in plain}
    worst = max(rel, key=rel.get)
    kind = "wkv6" if cfg.rwkv else "ssd"
    print(f"  {arch} layer 0 in float32 on its inputs (B={x.shape[0]}, S={x.shape[1]}), every "
          f"gradient through the {kind} kernels vs the plain loops under autograd: max "
          f"||kernel - plain|| / ||plain|| {rel[worst]:.3e} ({worst}; tol {GRAD_BLOCK_TOL:g}); "
          f"launches {launched}")
    check(rel[worst] <= GRAD_BLOCK_TOL, f"{arch}: layer 0's gradients differ from plain")
    check(launched[kind] == 1 and launched[f"{kind}_bwd"] == 1,
          f"{arch}: layer 0's gradients launched {launched}")
    return dict(max_rel=rel[worst], worst=worst)


def family_training(label: str, cfg, run_steps, tokens_a_step: int, steps: int, card: str,
                    expect: dict) -> dict:
    """Time ``run_steps()`` (which runs ``steps`` train steps and returns their
    losses, marking each step's start): losses finite, step time, tokens/s,
    peak memory and each kernel's launches a step, which must be
    ``expect``'s."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rkmod.reset_launch_counts()  # the main path of phase 18 starts here
    fkmod.reset_launch_counts()
    marks = []

    def mark(_step=None):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    losses = run_steps(mark)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    launched = {k: f() for k, f in LAUNCH_COUNTERS.items()}  # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    median_s = float(np.median(step_s[1:]))
    per_step = {k: v / steps for k, v in launched.items()}
    print(f"  {label}: losses {[round(x, 5) for x in losses]}; step wall times "
          f"{[round(t, 3) for t in step_s]} s (each ends in a sync), median of steps 2-{steps} "
          f"{median_s:.3f} s, {tokens_a_step / median_s:.0f} tokens/s; peak memory {peak_gb:.2f} "
          f"GB; launches a step {per_step} (expected {expect})  [{card}]")
    check(len(losses) == steps and all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(per_step == {k: float(expect.get(k, 0)) for k in per_step},
          f"{label}: launches a step {per_step}, expected {expect}")
    return dict(losses=losses, step_s=step_s, median_step_s=median_s,
                tokens_per_s=tokens_a_step / median_s, peak_gb=peak_gb, launches=launched,
                launches_per_step=per_step)


def profile_train_step(label: str, step_fn, busy_of: float) -> dict:
    """One more step under torch.profiler: device ms by class (the scan
    kernels, flash, cuBLAS, the rest) and the idle share of the step."""
    prof = classify_step(step_fn, extra=SCAN_CLASSES)
    busy = max(prof["busy_ms"], 1e-9)
    print(f"  {label}, one step under torch.profiler: device busy {busy:.1f} ms of a "
          f"{busy_of * 1e3:.1f} ms step (idle share {max(0.0, 1 - busy / (busy_of * 1e3)):.3f})")
    for key, ms in prof["classes"].items():
        print(f"    by kernel name: {key:<28} {ms:10.1f} ms  {ms / busy:6.1%}")
    for name, count, ms in prof["top"][:8]:
        print(f"    {ms:10.3f} ms  x{count:<6} {name}")
    return dict(busy_ms=busy, by_kernel_name_ms=prof["classes"])


def recurrent_family_training(arch: str, dev, card: str, workdir: str) -> dict:
    """Phase 18 (c): one of rwkv6-3b and zamba2-1.2b at full width and depth
    through ``launch/train.py``'s path (``train()``, AdamW, warm-up-cosine,
    remat "full"), B = 2, S = 4096, one microbatch, TRAIN_FAMILY_STEPS steps,
    no checkpoint; then one step under the profiler and layer 0's gradients
    against plain."""
    cfg = get_config(arch)
    args = tlaunch.parse_args([
        "--arch", arch, "--steps", str(TRAIN_FAMILY_STEPS), "--seq-len", str(TRAIN_FAMILY_SEQ),
        "--batch", str(TRAIN_FAMILY_BATCH), "--microbatches", "1", "--log-every", "1",
        "--save-every", str(TRAIN_FAMILY_STEPS + 1), "--checkpoint-dir", workdir,
        "--device", str(dev)])
    held = {}

    def run_steps(mark):
        res = tlaunch.run(args, fault_hook=mark)
        held["state"] = res["state"]
        return [h["loss"] for h in res["history"]]

    n_shared = cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    kind = "wkv6" if cfg.rwkv else "ssd"
    expect = {kind: 2 * cfg.num_layers, f"{kind}_bwd": cfg.num_layers, "flash": 2 * n_shared}
    print(f"  (c) {arch}: {cfg.param_count() / 1e9:.3f}e9 parameters, {cfg.num_layers} layers, "
          f"B={TRAIN_FAMILY_BATCH} S={TRAIN_FAMILY_SEQ}, remat {cfg.remat_policy}, AdamW  "
          f"[{time.perf_counter() - T_START:.1f} s]")
    out = family_training(f"{arch} train()", cfg, run_steps, TRAIN_FAMILY_BATCH * TRAIN_FAMILY_SEQ,
                          TRAIN_FAMILY_STEPS, card, expect)
    state = held.pop("state")
    step_fn = tzoo.make_train_step(cfg, AdamW(), device=dev)
    batch = next(SyntheticLMStream(cfg.vocab_size, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_BATCH, seed=1))
    out["profile"] = profile_train_step(arch, lambda: step_fn(state, batch), out["median_step_s"])
    model = state["params"]
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    out["block"] = block_grads(arch, cfg, model, lm_tokens(cfg, GRAD_BLOCK_BATCH,
                                                            TRAIN_FAMILY_SEQ, dev, seed=2))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 18 (d): the flash kernel as whisper-base's training path calls it:
# not causal, with its lse, at B = 4 and train_4k's 4096 frames (the
# encoder; the cross-attention's 448 queries against its keys), and at 1500
# keys, whisper's own encoder length, whose last key tile is part masked.
WHISPER_LSE_SHAPES = {
    "encoder: B=4 S=4096 H=8 D=64": (WHISPER_TRAIN_BATCH, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_SEQ),
    "cross-attention: B=4 S_q=448 S_kv=4096 H=8 D=64": (WHISPER_TRAIN_BATCH, 448,
                                                         TRAIN_FAMILY_SEQ),
    "cross-attention: B=4 S_q=448 S_kv=1500 H=8 D=64": (WHISPER_TRAIN_BATCH, 448, 1500),
}


def whisper_lse_shapes(dev, card: str) -> dict:
    """Phase 18 (d): the flash kernels (the routed wgmma and ``mma.sync``)
    with ``return_lse`` and a key length of their own, at whisper-base's
    training shapes, against the plain version's output and lse: the lse
    within LSE_TOL (absolute and relative, as phase 16 (a)), the output
    within FLASH_ROW_TOL a row and BF16_TOL elementwise (as phase 17 (f)),
    and bit for bit the output without the lse."""
    worst = 0.0
    for label, (b, s, skv) in WHISPER_LSE_SHAPES.items():
        q = bf16_randn((b, s, 8, 64), dev, s + skv)
        k, v = (bf16_randn((b, skv, 8, 64), dev, skv + i) for i in range(2))
        want, want_lse = flash_attention_plain(q, k, v, causal=False, q_chunk=PLAIN_Q_CHUNK,
                                               return_lse=True)
        for variant in (fkmod.variant_for(q.dtype, 64), "mma"):
            out, lse = fkmod.flash_attention_cuda(q, k, v, causal=False, variant=variant,
                                                  return_lse=True)
            same = torch.equal(out, fkmod.flash_attention_cuda(q, k, v, causal=False,
                                                               variant=variant))
            lse_diff = (lse - want_lse).abs()
            lse_ok = bool((lse_diff <= LSE_TOL + LSE_TOL * want_lse.abs()).all())
            row = max_row_error(out, want)
            diff = (out.float() - want.float()).abs()
            within = bool((diff <= BF16_TOL + BF16_TOL * want.float().abs()).all())
            ok = lse_ok and same and row <= FLASH_ROW_TOL[q.dtype] and within
            worst = max(worst, float(lse_diff.max()))
            print(f"  flash ({variant}) with lse at whisper-base's {label}: lse max |kernel - "
                  f"plain| {float(lse_diff.max()):.3e} (tol {LSE_TOL:g} abs + rel), output max row "
                  f"error {row:.3e} (tol {FLASH_ROW_TOL[q.dtype]:g}), elementwise "
                  f"{'ok' if within else 'FAIL'}, bit for bit the output without lse: {same} "
                  f"{'ok' if ok else 'FAIL'}  [{card}]")
            check(ok, f"the {variant} flash kernel's output or lse is wrong at whisper-base's {label}")
            del out, lse, lse_diff, diff
        del q, k, v, want, want_lse
    torch.cuda.empty_cache()
    return dict(max_lse_abs_err=worst)


def attention_family_training(arch: str, dev, card: str) -> dict:
    """Phase 18 (d): whisper-base at full size on ``input_specs(train_4k)``
    (frames 4096, 448 tokens) with the batch cut, or internvl2-26b at full
    width with its depth cut, B = 2 (2048 patch embeddings, then text):
    ``make_train_step`` with AdamW, TRAIN_FAMILY_STEPS steps, then one step
    under the profiler."""
    cfg = get_config(arch)
    b = WHISPER_TRAIN_BATCH if cfg.is_encoder_decoder else TRAIN_FAMILY_BATCH
    vlm = cfg.frontend == "vision_stub"
    if vlm:
        cfg = dataclasses.replace(cfg, num_layers=VLM_TRAIN_LAYERS)
    specs = input_specs(cfg, dataclasses.replace(SHAPES["train_4k"], global_batch=b))
    print(f"  (d) {arch}: {cfg.num_layers} layers{f' of {get_config(arch).num_layers}' if vlm else ''}"
          f", {cfg.param_count() / 1e9:.3f}e9 parameters; input_specs(train_4k) at B={b}: "
          f"{ {k: tuple(v.shape) for k, v in specs.items()} }  [{time.perf_counter() - T_START:.1f} s]")
    batch = {k: (bf16_randn(tuple(v.shape), dev, i) if v.dtype == torch.bfloat16
                 else lm_tokens(cfg, *v.shape, dev, seed=i))
             for i, (k, v) in enumerate(specs.items())}
    state = init_adamw_state(init_model(cfg, seed=0, device=dev), lr=3e-4)
    step_fn = tzoo.make_train_step(cfg, AdamW(), device=dev)

    def run_steps(mark):
        losses = []
        for i in range(TRAIN_FAMILY_STEPS):
            mark(i)
            _, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
        return losses

    # Flash runs where the longer of S_q and S_kv passes 2048 ("auto"): every
    # layer of internvl2; whisper's encoder and cross-attention, not its
    # decoder's self-attention over 448 tokens.  Each twice a step (remat).
    layers = cfg.encoder_layers + cfg.num_layers
    tokens = b * (TRAIN_FAMILY_SEQ if not cfg.is_encoder_decoder else cfg.max_target_len)
    out = family_training(f"{arch} make_train_step", cfg, run_steps, tokens, TRAIN_FAMILY_STEPS,
                          card, {"flash": 2 * layers})
    out["profile"] = profile_train_step(arch, lambda: step_fn(state, batch), out["median_step_s"])
    out["layers"] = cfg.num_layers
    del state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_training_phase(dev, card: str) -> dict:
    """Phase 18: training the RWKV-6, hybrid, encoder-decoder and VLM families."""
    t_start = time.perf_counter()
    phase("phase 18: training the RWKV-6, hybrid, encoder-decoder and VLM families on the card")
    print("  (a) the backward kernels against their plain versions")
    result = {"bwd_cases_max_err": bwd_cases(dev)}
    result["bwd_full"] = {kind: bwd_full_shape(kind, card) for kind in BWD}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (b) each family's reduced config, card vs CPU  [{time.perf_counter() - T_START:.1f} s]")
    result["reduced"] = reduced_family_steps(dev, card)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train18_")
    try:
        result["train"] = {arch: recurrent_family_training(arch, dev, card,
                                                           str(Path(workdir, arch)))
                           for arch in ("rwkv6-3b", "zamba2-1.2b")}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"  (d) whisper-base's flash shapes with the lse  [{time.perf_counter() - T_START:.1f} s]")
    result["whisper_lse"] = whisper_lse_shapes(dev, card)
    for arch in ("whisper-base", VLM_ARCH):
        result["train"][arch] = attention_family_training(arch, dev, card)
    result["seconds"] = time.perf_counter() - t_start
    print(f"  phase 18 took {result['seconds']:.1f} s")
    return result


def bwd_entries(trained: dict) -> list[dict]:
    """The ``kernels`` line's entries of the two backward kernels, from phase 18."""
    out = []
    for kind, name, arch in (("wkv6", "wkv6_scan_bwd_kernel", "rwkv6-3b"),
                             ("ssd", "ssd_scan_bwd_kernel", "zamba2-1.2b")):
        full = trained["bwd_full"][kind]
        b, s, h, hd = full["shape"]
        by_path = {f"train(), {arch} full width (phase 18c)":
                       trained["train"][arch]["launches"][f"{kind}_bwd"],
                   "reduced train steps, card vs CPU (phase 18b)": sum(
                       r["launches"][f"{kind}_bwd"] for r in trained["reduced"].values())}
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/recurrence/csrc/recurrence_bwd.cu",
            replaces=("src/repro/models/rwkv.py:154" if kind == "wkv6"
                      else "src/repro/models/ssm.py:108"),
            replaces_note="the derivative of that lax.scan through _chunked_scan's checkpoints "
                          "(src/repro/models/rwkv.py:77-102); no Pallas kernel",
            launches=by_path[f"train(), {arch} full width (phase 18c)"],
            launches_by_path=by_path, max_abs_err=full["max_abs_err"],
            max_err_per_head=full["rel_err"],
            cases_max_err=trained["bwd_cases_max_err"][kind], ms=full["ms"],
            times_ms=full["times_ms"], forward_ms=full["fwd_ms"], plain_ms=full["plain_ms"],
            bound_ms=full["bound_ms"], bound_by=full["bound_by"], library_ms=None,
            per=f"one layer's scan backward, B={b} S={s} H={h} float32, {arch}'s training shape"))
    return out


# -- phase 19: the sharded LM on ranks that share the card ----------------------

SHARD_LM = dict(  # phase 19's sizes
    arch=TRAIN_ARCH, layers=4,  # of 24: ~0.31e9 parameters, 1.26 GB a float32 copy
    batch=4, seq=4096, microbatches=2, steps=2, mesh=(2, 2), lr=1e-3,
    # (a2) the tensor-parallel prefill (B=8, S=4096) and decode: 12 steps over
    # caches of 8192 positions filled as if prefilled, rows at these positions
    # (rows 0 and 1 cross the edge of the two windows of granite-20b's cache)
    serve_batch=8, serve_seq=4096, serve_cache=8192, serve_pos=(4090, 4094, 100, 8000),
    window_arch="granite-20b", window_layers=2,  # of 52: MQA, so its cache's sequence is on model
    decode_arch=ARCH, decode_batch=4, decode_cache=32_768, decode_steps=12,
    decode_pos=(8186, 8190, 100, 20_000),  # rows 0 and 1 cross the edge at 8192
    psum_elems=64 * 2**20, ring=(4096, 2048, 2048))  # ring: m, k, n a rank
SHARD_RANKS = 4
# Two sharded AdamW steps against references, each leaf read in norm.  The
# witness that the split computes the step: the same steps in float64 (the
# plain attention), the parameters ||p - p_ref|| / ||p_ref|| against the
# unsharded float64 step's within the CPU tests' STEP_TOL
# (tests/test_torch_distributed_lm.py).  Not in float32: there a sum in
# another order flips top-k routing near ties in the first step, and the
# experts' and router's parameters then part by 3.9e-3 after two steps
# (printed; PERF.md, the sharded LM); in float64 no tie is that near.  In bf16 the
# update each leaf took, ||delta - delta_ref|| / ||delta_ref||, against a
# control of the same split on a (replica, model) mesh, 4 microbatches of one
# row (a rank's products, the same model-axis sums; only the data group's
# float32 sum differs), within float32's step tolerance.  And one bf16 SGD
# step's gradient (lr 1: the update is the gradient) against the float32
# step's, within 1.25x the unsharded bf16 step's own distance to it: a split
# that rounds differently is held to what bf16 costs, and not to another bf16
# run, since the routing's near ties flip on any change of rounding.  The
# AdamW updates' gaps to the unsharded bf16 step and to an independent
# control (the unsharded step with 4 microbatches of one row) are printed
# beside them.
SHARD_WITNESS_TOL = 1e-4
SHARD_CONTROL_TOL = 1e-4
SHARD_UNSHARDED_RATIO = 1.25
SHARD_SGD_LR = 1.0
# the tensor-parallel prefill's and decode's logits against the unsharded ones
# on the same weights and state: in float32 relative to the largest |logit|
# (tests/test_torch_models.py:48, tests/test_distributed.py:115); in bf16 the
# median over rows (and steps) of each row's distance to the float32 run,
# within SHARD_UNSHARDED_RATIO x the unsharded bf16 run's (BF16_F32_RATIO's
# rule: top-k routing near ties flip a few rows on either side, 8 of 48 decode
# rows on the card), and, for a config with no routing, BF16_SCALE_TOL
# (tests/test_torch_models.py:49)
SHARD_PREFILL_TOL = 1e-4
SHARD_DECODE_TOL = 3e-4  # tests/test_distributed.py:115
SHARD_PSUM_TOL = 5e-2  # tests/test_distributed.py:141
SHARD_RING_TOL = 2e-4  # tests/test_distributed.py:159


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def shard_lm_config(sizes: dict):
    cfg = get_config(sizes["arch"]) if "reduced" not in sizes else reduced_config(
        sizes["arch"], **sizes["reduced"])
    return dataclasses.replace(cfg, num_layers=sizes["layers"])


def shard_decode_config(sizes: dict):
    cfg = get_config(sizes["decode_arch"]) if "reduced" not in sizes else reduced_config(
        sizes["decode_arch"], **sizes["reduced"])
    return dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)


def shard_lm_batches(cfg, sizes: dict) -> list[dict]:
    """The steps' global batches: every row has its first 16 labels set to
    -100, so each row holds as many labels and a microbatch of one row (the
    control's) computes the same function as one of two."""
    stream = SyntheticLMStream(cfg.vocab_size, sizes["seq"], sizes["batch"], seed=19)
    out = []
    for _ in range(sizes["steps"]):
        b = next(stream)
        labels = np.array(b["labels"], copy=True)
        labels[:, :16] = -100
        out.append({"tokens": np.asarray(b["tokens"]), "labels": labels})
    return out


def shard_decode_inputs(cfg, sizes: dict, dev):
    """The attention weights, the full caches (random, as if prefilled), the
    steps' inputs: the same draws on every process."""
    gen = torch.Generator(device=dev).manual_seed(1919)
    params = tattn.init_attention(gen, cfg)
    shape = (sizes["decode_batch"], sizes["decode_cache"], cfg.num_kv_heads, cfg.head_dim)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    xs = torch.randn((sizes["decode_steps"], sizes["decode_batch"], 1, cfg.d_model),
                     generator=gen, device=dev)
    return params, k, v, xs


def _psum_input(sizes: dict, rank: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(4000 + rank)
    return torch.randn(sizes["psum_elems"], generator=gen, device=dev) * (1.0 + rank)


def _ring_inputs(sizes: dict, rank: int, dev):
    m, k, n = sizes["ring"]
    x = torch.randn((m, k), generator=torch.Generator(device=dev).manual_seed(5000), device=dev)
    w = torch.randn((k, n), generator=torch.Generator(device=dev).manual_seed(5001 + rank),
                    device=dev)
    return x, w


def _wall(dev, fn):
    """``fn()``'s host seconds, every rank starting together, ending in a sync."""
    import torch.distributed as dist

    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


# phase 19 (a2): the sharded serving runs, (label, config, dtype, with a prefill)
SERVE_CASES = (
    ("bf16", "lm", torch.bfloat16, True),  # the main path: the caches' KV heads on model
    ("f32", "lm", torch.float32, True),
    ("window bf16", "window", torch.bfloat16, False),  # MQA: the caches' sequence on model
    ("window f32", "window", torch.float32, False),
)


def shard_witness_config(cfg, dtype):
    """Phase 19's step computing in ``dtype``; in float64 with the plain
    attention (the flash kernels take bf16 and float32)."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    return dataclasses.replace(cfg, attention_impl="dense") if dtype == torch.float64 else cfg


def shard_serve_config(sizes: dict, which: str, dtype):
    """A serving run's config: phase 19's LM (``"lm"``) or granite-20b cut to
    ``window_layers`` (``"window"``), computing in ``dtype``."""
    if which == "lm":
        cfg = shard_lm_config(sizes)
    else:
        arch = sizes["window_arch"]
        cfg = get_config(arch) if "reduced" not in sizes else reduced_config(
            arch, **dict(sizes["reduced"], num_kv_heads=1))
        cfg = dataclasses.replace(cfg, num_layers=sizes["window_layers"])
    return dataclasses.replace(cfg, dtype=dtype)


def shard_serve_weights(cfg, dev) -> dict:
    """The serving weights: seed 0's float32 masters, cast to the config's
    dtype (the dry run's bf16 serving weights)."""
    tree = param_tree(init_model(cfg, seed=0, device=dev))
    return tree_map(lambda p: p.detach().to(cfg.dtype), tree)


def shard_serve_inputs(cfg, sizes: dict) -> tuple[dict, np.ndarray]:
    """The prefill's batch and the decode's tokens, the same draws everywhere."""
    rng = np.random.default_rng(1919)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (sizes["serve_batch"],
                                                        sizes["serve_seq"]), dtype=np.int32)}
    tokens = rng.integers(0, cfg.vocab_size, (sizes["decode_steps"], len(sizes["serve_pos"])),
                          dtype=np.int32)
    return batch, tokens


def shard_serve_state(cfg, sizes: dict, dev) -> dict:
    """A decode state of ``serve_cache`` positions whose caches hold random
    keys and values everywhere, as if prefilled, its rows at ``serve_pos``:
    the same draws on every process."""
    state = ttr.init_decode_state(cfg, len(sizes["serve_pos"]), sizes["serve_cache"],
                                  cache_dtype=cfg.dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2929)
    for key in ("k", "v"):
        state[key].copy_(torch.randn(state[key].shape, generator=gen, device=dev))
    state["pos"].copy_(torch.tensor(sizes["serve_pos"], dtype=torch.int32, device=dev))
    return state


def serve_reference(sizes: dict, which: str, dtype, prefill: bool, dev) -> dict:
    """A serving run's unsharded prefill and decode on one process."""
    cfg = shard_serve_config(sizes, which, dtype)
    tree = shard_serve_weights(cfg, dev)
    batch, tokens = shard_serve_inputs(cfg, sizes)
    out: dict = {}
    with torch.inference_mode():
        if prefill:
            logits, out["prefill_s"] = _timed(dev, lambda: forward_params(tree, cfg, batch))
            out["prefill"] = logits[:, -1].float().cpu().numpy()
            del logits
        state = shard_serve_state(cfg, sizes, dev)
        model = ttr.Transformer(cfg, tree)
        steps, ticks = [], []
        for tok in tokens:
            (logits, _), seconds = _timed(dev, lambda: ttr.decode_step(model, cfg, tok, state))
            steps.append(logits.float().cpu().numpy())
            ticks.append(seconds)
    out.update(decode=np.stack(steps), tick_s=ticks)
    return out


@contextlib.contextmanager
def _fence_out(dtype):
    """Above bf16, the bf16 cotangent fence out, as the CPU tests take it out
    of float32 comparisons: it rounds a cotangent to bf16, so a difference of
    one ulp below it moves a gradient by a bf16 step, which AdamW's
    normalised update then carries (phase 16's note)."""
    fence = ttr.grad_fence_bf16
    if dtype != torch.bfloat16:
        ttr.grad_fence_bf16 = lambda x: x
    try:
        yield
    finally:
        ttr.grad_fence_bf16 = fence


def _timed(dev, fn):
    """``fn()``'s host seconds on one process, ending in a sync."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def sharded_lm_rank(sizes: dict, device: str, workdir: str, decode_x) -> dict:
    """Phase 19 on one rank of the 4 that share the card (gloo).  The main
    path: (a) the tensor-parallel train step on a (2, 2) mesh, counted,
    timed, rank 0's first step traced for phase 20; (a2) the sharded bf16
    prefill and decode of the same config, their logits gathered whole, the
    prefill once more under the op counter.  Then (a2) the same in float32,
    and granite-20b's decode (its cache's sequence on model) in bf16 and
    float32; the step's data-axis collectives timed alone, rank 0's gathered
    weights; (b) the weights saved from (2, 2) and restored onto (4, 1);
    (a3) the control: the same split on a (replica, model) mesh, 4
    microbatches of one row; (a4) the step in float32; (c) the attention
    decode over 4 sequence windows; (d) both collectives, each beside its
    plain collective."""
    import torch.distributed as dist

    from repro_torch.distributed import rank_device
    from repro_torch.distributed.collectives import compressed_psum, ring_allgather_matmul
    from repro_torch.distributed.decode import sharded_decode_attention
    from repro_torch.distributed.sharded_serve import (
        gather_logits,
        serve_param_shardings,
        sharded_decode,
        sharded_prefill,
        windowed_caches,
    )
    from repro_torch.distributed.sharded_step import data_group_axes, sharded_train_step
    from repro_torch.distributed.sharding import (
        P,
        batch_shardings,
        decode_state_shardings,
        gather_state,
        gather_tensors,
        param_shardings,
        shard_state,
        train_state_shardings,
    )
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.perf.op_cost import OpCounter
    from repro_torch.runtime import checkpoint as tckpt

    dev = rank_device(device)
    rank = dist.get_rank()
    cuda = dev.type == "cuda"
    out: dict = {"rank": rank, "times": {}}
    t_mark = [time.perf_counter()]

    def mark(name: str) -> None:  # the rank's seconds in each part, for the phase's breakdown
        now = time.perf_counter()
        out["times"][name] = now - t_mark[0]
        t_mark[0] = now

    # every flash launch's query heads: the rank's H / tp
    heads_seen = collections.Counter()
    launch = fkmod._launch

    def counted_heads(q, *args, **kwargs):
        heads_seen[q.shape[2]] += 1
        return launch(q, *args, **kwargs)

    fkmod._launch = counted_heads

    # -- (a) the tensor-parallel train step ----------------------------------------
    cfg = shard_lm_config(sizes)
    mesh = make_mesh(sizes["mesh"], ("data", "model"), device=device)
    state = init_adamw_state(init_model(cfg, seed=0, device=dev), lr=sizes["lr"])
    ssh = train_state_shardings(state, cfg, mesh)
    sstate = shard_state(state, ssh, mesh)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    batches = shard_lm_batches(cfg, sizes)
    bsh = batch_shardings(batches[0], cfg, mesh)
    step = sharded_train_step(cfg, AdamW(), mesh, ssh, bsh,
                              num_microbatches=sizes["microbatches"])
    mark("set-up")
    fkmod.reset_launch_counts()  # the main path of phase 19 starts here
    step_s, losses = [], []
    for i, batch in enumerate(batches):
        # phase 20 (c): rank 0's first step under torch.profiler, its collectives
        # read back; the phase's step time is the last step's, which runs untraced
        traced = rank == 0 and i == 0
        with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                     record_shapes=True) if traced
              else contextlib.nullcontext()) as prof:
            (sstate, metrics), seconds = _wall(dev, lambda: step(sstate, batch))
        if traced:
            trace = os.path.join(workdir, "step.json")
            prof.export_chrome_trace(trace)
            out["coll_traced"] = tcollb.records_from_trace(trace)
        losses.append(float(metrics["loss"]))
        step_s.append(seconds)
    out["step_launches"] = fkmod.flash_attention_cuda.launches
    out["step_s"], out["losses"] = step_s, losses
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    out["local_gb"] = sum(x.to_local().numel() * x.to_local().element_size()
                          for key in ("params", "m", "v") for x in tree_leaves(sstate[key])) / 1e9
    mark("steps")

    # -- (a2) the tensor-parallel prefill and decode ---------------------------------
    def serve(label: str, which: str, dtype, with_prefill: bool) -> None:
        scfg = shard_serve_config(sizes, which, dtype)
        tree = shard_serve_weights(scfg, dev)
        psh = serve_param_shardings(tree, scfg, mesh)
        params = shard_state(tree, psh, mesh)
        del tree
        sbatch, stokens = shard_serve_inputs(scfg, sizes)
        res: dict = {}
        if with_prefill:
            prefill = sharded_prefill(scfg, mesh, psh, batch_shardings(sbatch, scfg, mesh))
            logits, res["prefill_s"] = _wall(dev, lambda: prefill(params, sbatch))
            res["prefill"] = gather_logits(logits, mesh, ("data",)).float().cpu().numpy()
            del logits
        dstate = shard_serve_state(scfg, sizes, dev)
        dssh = decode_state_shardings(dstate, scfg, mesh)
        dstate = shard_state(dstate, dssh, mesh)
        tsh = batch_shardings({"tokens": stokens[0]}, scfg, mesh)["tokens"]
        serve_step = sharded_decode(scfg, mesh, psh, tsh, dssh)
        dec, tick = [], []
        for tok in stokens:
            (lg, seconds) = _wall(dev, lambda: serve_step(params, torch.from_numpy(tok), dstate))
            dec.append(gather_logits(lg[0], mesh, ("data",)).float().cpu().numpy())
            tick.append(seconds)
        res.update(decode=np.stack(dec), tick_s=tick, windows=sorted(windowed_caches(dssh)))
        if label == "bf16":  # phase 20 (b): the rank's count against the dry run's
            out["launches"] = fkmod.flash_attention_cuda.launches  # ... and ends here
            out["by_variant"] = dict(fkmod.flash_attention_cuda.launches_by_variant)
            out["flash_heads"] = dict(heads_seen)
            with OpCounter() as counter:
                prefill(params, sbatch)
            with OpCounter() as apart:  # the weights' gather: the dry run's collective record
                gather_tensors(tree_leaves(params), axes=("data",))
            out["prefill_flops"] = counter.cost.flops - apart.cost.flops
        out.setdefault("serve", {})[label] = res
        del params, dstate
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    for label, which, dtype, with_prefill in SERVE_CASES:
        serve(label, which, dtype, with_prefill)
    mark("prefill, decode")

    # the step's data-axis collectives alone, at its sizes (the steps warmed
    # them): the weights' gather over the data axes (the step's casts of the
    # shards) and a sum of the model shards' float32 gradients over the data group
    from torch.distributed.tensor import DTensor

    shards = tree_leaves(sstate["params"])
    cast = [DTensor.from_local(tzoo.compute_weight(s.to_local(), cfg), s.device_mesh,
                               s.placements, run_check=False, shape=s.shape, stride=s.stride())
            for s in shards]
    model_local = gather_tensors(cast, axes=("data",))
    flat = torch.zeros(sum(t.numel() for t in model_local) + 1, device=dev)
    del model_local
    group = axis_group(mesh, data_group_axes(bsh))
    _, out["gather_s"] = _wall(dev, lambda: gather_tensors(cast, axes=("data",)))
    _, out["reduce_s"] = _wall(dev, lambda: dist.all_reduce(flat, group=group))
    del cast, flat

    full = gather_state(sstate["params"])
    out["params"] = tree_to_numpy(full) if rank == 0 else None
    mark("gloo alone, gather")

    # -- (b) saved from (2, 2), restored onto (4, 1) ---------------------------------
    ck = os.path.join(workdir, "elastic")
    saved = {"params": sstate["params"], "step": sstate["step"]}
    _, out["save_s"] = _wall(dev, lambda: tckpt.save_checkpoint(ck, len(batches), saved))
    del sstate, saved
    gc.collect()
    mesh41 = make_mesh((SHARD_RANKS, 1), ("data", "model"), device=device)
    target = {"params": full, "step": torch.zeros((), dtype=torch.int32, device=dev)}
    ssh41 = {"params": param_shardings(full, cfg, mesh41), "step": P()}
    (restored, _), out["restore_s"] = _wall(dev, lambda: tckpt.restore_checkpoint(
        ck, target, shardings=ssh41, mesh=mesh41))
    whole = gather_state(restored)
    out["restored_equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(whole["params"]), tree_leaves(full))) and int(whole["step"]) == len(batches)
    out["restored_local_gb"] = sum(x.to_local().numel() * 4
                                   for x in tree_leaves(restored["params"])) / 1e9
    del full, target, restored, whole
    mark("save, restore")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- (a3) the control: the same split, no data group, a row a microbatch -------
    cmesh = make_mesh(sizes["mesh"], ("replica", "model"), device=device)
    state = init_adamw_state(init_model(cfg, seed=0, device=dev), lr=sizes["lr"])
    cssh = train_state_shardings(state, cfg, cmesh)
    cstate = shard_state(state, cssh, cmesh)
    del state
    cstep = sharded_train_step(cfg, AdamW(), cmesh, cssh,
                               batch_shardings(batches[0], cfg, cmesh),
                               num_microbatches=sizes["batch"])
    closses = []
    for batch in batches:
        cstate, metrics = cstep(cstate, batch)
        closses.append(float(metrics["loss"]))
    cfull = gather_state(cstate["params"])
    out["same_split"] = tree_to_numpy(cfull) if rank == 0 else None
    out["same_split_losses"] = closses
    del cstate, cfull
    fkmod._launch = launch
    mark("control")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- (a4) the witnesses: the same steps in float32 and float64, the fence out ----
    for label, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        wcfg = shard_witness_config(cfg, dtype)
        state = init_adamw_state(init_model(wcfg, seed=0, device=dev), lr=sizes["lr"])
        wsh = train_state_shardings(state, wcfg, mesh)
        wstate = shard_state(state, wsh, mesh)
        del state
        wstep = sharded_train_step(wcfg, AdamW(), mesh, wsh,
                                   batch_shardings(batches[0], wcfg, mesh),
                                   num_microbatches=sizes["microbatches"])
        wlosses = []
        for batch in batches:
            with _fence_out(dtype):
                wstate, metrics = wstep(wstate, batch)
            wlosses.append(float(metrics["loss"]))
        wfull = gather_state(wstate["params"])
        out[label] = tree_to_numpy(wfull) if rank == 0 else None
        out[f"{label}_losses"] = wlosses
        del wstate, wfull
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    # ... and one bf16 SGD step: its update is the gradient
    tree = param_tree(init_model(cfg, seed=0, device=dev))
    sgd_sh = {"params": ssh["params"], "lr": P()}
    sgd = shard_state({"params": tree, "lr": torch.tensor(SHARD_SGD_LR, device=dev)}, sgd_sh,
                      mesh)
    del tree
    sgd, _ = sharded_train_step(cfg, None, mesh, sgd_sh, bsh,
                                num_microbatches=sizes["microbatches"])(sgd, batches[0])
    full = gather_state(sgd["params"])
    out["sgd"] = tree_to_numpy(full) if rank == 0 else None
    del sgd, full
    mark("float32 and float64 steps, SGD step")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- (c) the sharded decode --------------------------------------------------
    dcfg = shard_decode_config(sizes)
    mesh4 = make_mesh((SHARD_RANKS,), ("model",), device=device)
    aparams, k_full, v_full, _ = shard_decode_inputs(dcfg, sizes, dev)
    s_local = sizes["decode_cache"] // SHARD_RANKS
    window = slice(rank * s_local, (rank + 1) * s_local)
    k_l, v_l = k_full[:, window].clone(), v_full[:, window].clone()
    del k_full, v_full
    pos = torch.tensor(sizes["decode_pos"], device=dev)
    outs, tick_s = [], []
    for x in torch.from_numpy(decode_x).to(dev):
        (res, seconds) = _wall(dev, lambda: sharded_decode_attention(aparams, dcfg, mesh4, x, k_l,
                                                                      v_l, pos))
        outs.append(res[0].cpu().numpy())
        tick_s.append(seconds)
        pos = pos + 1
    out["decode"], out["tick_s"] = np.stack(outs), tick_s
    del k_l, v_l
    mark("decode")

    # -- (d) the collectives ------------------------------------------------------
    group4 = axis_group(mesh4, "model")
    x = _psum_input(sizes, rank, dev)
    exact = x.clone()
    _, out["allreduce_s"] = _wall(dev, lambda: dist.all_reduce(exact, group=group4))
    comp, out["psum_s"] = _wall(dev, lambda: compressed_psum(x, group4))
    xs = [_psum_input(sizes, r, dev) for r in range(SHARD_RANKS)]
    scale = torch.stack([t.abs().max().float() / 127.0 + 1e-12 for t in xs]).max().reshape(1)
    q_sum = sum(torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8).to(torch.int32)
                for t in xs)
    plain = q_sum.float() * scale
    out["psum_equal_plain"] = bool(torch.equal(comp, plain))
    out["psum_rel"] = float((comp - exact).abs().max() / exact.abs().max())
    del x, exact, comp, xs, q_sum, plain
    xr, w = _ring_inputs(sizes, rank, dev)
    ring, out["ring_s"] = _wall(dev, lambda: ring_allgather_matmul(xr, w, group4, SHARD_RANKS))

    def gather_then_matmul():
        parts = [torch.empty_like(w) for _ in range(SHARD_RANKS)]
        dist.all_gather(parts, w, group=group4)
        return xr @ torch.cat(parts, dim=1)

    dense, out["allgather_matmul_s"] = _wall(dev, gather_then_matmul)
    plain = xr @ torch.cat([_ring_inputs(sizes, r, dev)[1] for r in range(SHARD_RANKS)], dim=1)
    out["ring_rel"] = float((ring - plain).abs().max() / plain.abs().max())
    out["ring_vs_gather_rel"] = float((ring - dense).abs().max() / dense.abs().max())
    out["ring_flops"] = 2 * xr.shape[0] * xr.shape[1] * w.shape[1] * SHARD_RANKS
    mark("collectives")
    return out


def _update_gaps(trees: dict, init: dict, pairs, dev) -> dict:
    """For each ``(got, want)`` of ``pairs`` (keys of ``trees``), per leaf
    ``||(got - init) - (want - init)|| / ||want - init||`` of JAX-layout
    numpy trees, in float64 on ``dev``, each tree's update made once a leaf."""
    out = {f"{a} vs {b}": {} for a, b in pairs}

    def walk(nodes: dict, i, where):
        if isinstance(i, dict):
            for key in i:
                walk({name: t[key] for name, t in nodes.items()}, i[key], f"{where}/{key}")
            return
        i = torch.from_numpy(np.asarray(i)).to(dev, torch.float64)
        delta = {name: torch.from_numpy(np.asarray(t)).to(dev, torch.float64) - i
                 for name, t in nodes.items()}
        for a, b in pairs:
            out[f"{a} vs {b}"][where] = float(torch.linalg.vector_norm(delta[a] - delta[b])
                                              / torch.linalg.vector_norm(delta[b]).clamp_min(1e-30))

    walk(trees, init, "")
    return out


def sharded_lm_phase(dev, card: str, sizes: dict = SHARD_LM) -> dict:
    """Phase 19: the sharded LM paths on 4 gloo ranks sharing the card; the
    references run here first, unsharded, and are freed before the spawn."""
    from repro_torch.distributed import spawn

    phase(f"phase 19: the sharded LM on {SHARD_RANKS} gloo ranks sharing the card ("
          f"{sizes['arch']} at full width, {sizes['layers']} layers, mesh {sizes['mesh']})")
    t_phase = time.perf_counter()
    cfg = shard_lm_config(sizes)
    batches = shard_lm_batches(cfg, sizes)
    cuda = dev.type == "cuda"
    times = {}

    # the unsharded references: the step's microbatches in bf16, an independent
    # control (4 microbatches of one row), the step's microbatches in float32
    init = tree_to_numpy(init_model(cfg, seed=0, device=dev))
    refs = {}
    for label, mb, dtype in (("unsharded", sizes["microbatches"], cfg.dtype),
                             ("control", sizes["batch"], cfg.dtype),
                             ("unsharded f32", sizes["microbatches"], torch.float32),
                             ("unsharded f64", sizes["microbatches"], torch.float64)):
        rcfg = shard_witness_config(cfg, dtype)
        state = init_adamw_state(init_model(rcfg, seed=0, device=dev), lr=sizes["lr"])
        step = tzoo.make_train_step(rcfg, AdamW(), num_microbatches=mb, device=dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for batch in batches:
            _sync(dev)
            t0 = time.perf_counter()
            with _fence_out(dtype):
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
        refs[label] = dict(params=tree_to_numpy(state["params"]), losses=losses, step_s=step_s,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0)
        del state, step
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    for label, dtype in (("sgd", cfg.dtype), ("sgd f32", torch.float32)):
        rcfg = dataclasses.replace(cfg, dtype=dtype)
        state = {"params": init_model(rcfg, seed=0, device=dev), "lr": SHARD_SGD_LR}
        with _fence_out(dtype):
            state, _ = tzoo.make_train_step(rcfg, None, num_microbatches=sizes["microbatches"],
                                            device=dev)(state, batches[0])
        refs[label] = dict(params=tree_to_numpy(state["params"]))
        del state
    times["references: train steps"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    # the tensor-parallel prefill's and decode's unsharded references
    serve_refs = {label: serve_reference(sizes, which, dtype, with_prefill, dev)
                  for label, which, dtype, with_prefill in SERVE_CASES}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    times["references: prefill, decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dcfg = shard_decode_config(sizes)
    aparams, k, v, xs = shard_decode_inputs(dcfg, sizes, dev)
    pos = torch.tensor(sizes["decode_pos"], device=dev)
    want, ref_tick = [], []
    for x in xs:
        _sync(dev)
        t0 = time.perf_counter()
        o, k, v = tattn.decode_attention(aparams, dcfg, x, k, v, pos)
        _sync(dev)
        ref_tick.append(time.perf_counter() - t0)
        want.append(o.cpu().numpy())
        pos = pos + 1
    want = np.stack(want)
    decode_x = xs.cpu().numpy()
    del aparams, k, v, xs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    times["references: decode"] = time.perf_counter() - t0

    workdir = tempfile.mkdtemp(prefix="chip_smoke_phase19_")
    try:
        t0 = time.perf_counter()
        ranks = spawn(sharded_lm_rank, SHARD_RANKS, device=str(dev.type), backend="gloo",
                      args=(sizes, str(dev.type), workdir, decode_x))
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    r0 = ranks[0]
    times["ranks"] = spawn_s
    t0 = time.perf_counter()

    # (a) the sharded step against the controls, the unsharded step and, in
    # float32, the unsharded float32 step
    step_expected = sizes["steps"] * sizes["microbatches"] * cfg.num_layers * 2 if cuda else 0
    expected = step_expected + (cfg.num_layers if cuda else 0)  # and the bf16 prefill's
    tp = sizes["mesh"][1]
    gaps = _update_gaps({"sharded": r0["params"], "unsharded": refs["unsharded"]["params"],
                         "same split": r0["same_split"], "control": refs["control"]["params"],
                         "sharded f32": r0["f32"], "unsharded f32": refs["unsharded f32"]["params"]},
                        init,
                        (("sharded", "same split"), ("sharded", "unsharded"),
                         ("control", "unsharded"), ("sharded", "unsharded f32"),
                         ("unsharded", "unsharded f32")), dev)
    zero = tree_map(np.zeros_like, init)  # the parameters themselves, not their updates
    gaps.update(_update_gaps({"sharded f32": r0["f32"], "sharded f64": r0["f64"],
                              "unsharded f32": refs["unsharded f32"]["params"],
                              "unsharded f64": refs["unsharded f64"]["params"]}, zero,
                             (("sharded f64", "unsharded f64"), ("sharded f32", "unsharded f32")),
                             dev))
    gaps.update({f"SGD {k}": v for k, v in _update_gaps(
        {"sharded": r0["sgd"], "unsharded": refs["sgd"]["params"],
         "unsharded f32": refs["sgd f32"]["params"]}, init,
        (("sharded", "unsharded f32"), ("unsharded", "unsharded f32"),
         ("sharded", "unsharded")), dev).items()})
    times["update gaps"] = time.perf_counter() - t0
    worst = {k: max(g.values()) for k, g in gaps.items()}
    step_s = [max(r["step_s"][i] for r in ranks) for i in range(sizes["steps"])]
    gloo_s = max(r["gather_s"] for r in ranks) + max(r["reduce_s"] for r in ranks)
    tokens = sizes["batch"] * sizes["seq"]
    print(f"  (a) {sizes['arch']}, {cfg.num_layers} of 24 layers, {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters; B={sizes['batch']} S={sizes['seq']}, {sizes['microbatches']} "
          f"microbatches, mesh {sizes['mesh']} (data, model) under '2d', AdamW lr {sizes['lr']}")
    print(f"      tensor parallel over model: {cfg.num_heads // tp} of {cfg.num_heads} query "
          f"heads, {cfg.num_kv_heads // tp} of {cfg.num_kv_heads} KV heads, "
          f"{cfg.num_experts // tp} of {cfg.num_experts} experts, "
          f"{cfg.padded_vocab // tp} of {cfg.padded_vocab} vocabulary rows a rank")
    print(f"      losses: sharded {[round(x, 5) for x in r0['losses']]}, unsharded "
          f"{[round(x, 5) for x in refs['unsharded']['losses']]}, control (unsharded, 4 "
          f"microbatches of one row) {[round(x, 5) for x in refs['control']['losses']]}, the "
          f"same split on a (replica, model) mesh "
          f"{[round(x, 5) for x in r0['same_split_losses']]}; float32: sharded "
          f"{[round(x, 5) for x in r0['f32_losses']]}, unsharded "
          f"{[round(x, 5) for x in refs['unsharded f32']['losses']]}; float64: sharded "
          f"{[round(x, 7) for x in r0['f64_losses']]}, unsharded "
          f"{[round(x, 7) for x in refs['unsharded f64']['losses']]}")
    print(f"      step wall (slowest rank, each ending in a sync; rank 0's first step runs "
          f"under the profiler for phase 20 (c)): sharded "
          f"{[round(x, 3) for x in step_s]} s, unsharded on one process "
          f"{[round(x, 3) for x in refs['unsharded']['step_s']]} s; {tokens / step_s[-1]:.0f} "
          f"tokens/s sharded at the last step  [{card}]")
    print(f"      gloo alone at the step's sizes: the weights' gather over data "
          f"{max(r['gather_s'] for r in ranks):.3f} s, the model shards' float32 gradients "
          f"summed over data {max(r['reduce_s'] for r in ranks):.3f} s; "
          f"{gloo_s / step_s[-1]:.1%} of the last step (the model axis's calls not timed alone)")
    print(f"      peak memory a rank {[round(r['peak_gb'], 2) for r in ranks]} GB (shards of "
          f"params, m, v: {[round(r['local_gb'], 3) for r in ranks]} GB); unsharded peak "
          f"{refs['unsharded']['peak_gb']:.2f} GB; flash launches a rank "
          f"{[r['launches'] for r in ranks]} (expected {expected}: {sizes['steps']} steps x "
          f"{sizes['microbatches']} microbatches x {cfg.num_layers} layers x forward and "
          f"recompute, and the bf16 prefill's {cfg.num_layers}), by variant {r0['by_variant']}, "
          f"query heads a launch {[r['flash_heads'] for r in ranks]} (H / tp = "
          f"{cfg.num_heads // tp})")
    limit = SHARD_UNSHARDED_RATIO * worst["SGD unsharded vs unsharded f32"]
    print(f"      gaps, worst leaf (AdamW updates ||delta - delta_ref|| / ||delta_ref||; "
          f"'sharded f64 (f32) vs unsharded f64 (f32)' the parameters ||p - p_ref|| / "
          f"||p_ref||; 'SGD' one step's update at lr {SHARD_SGD_LR:g}, the gradient): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limits: sharded vs same split {SHARD_CONTROL_TOL:g}, float64 "
          f"{SHARD_WITNESS_TOL:g}, SGD sharded vs unsharded f32 {limit:.3e} = "
          f"{SHARD_UNSHARDED_RATIO} x the unsharded bf16 gradient's)")
    for k, g in gaps.items():
        top = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        print(f"        {k}: largest {[(name, round(val, 5)) for name, val in top]}")
    f32_rest = max(v for k, v in gaps["sharded f32 vs unsharded f32"].items() if "/ffn/" not in k)
    worst["sharded f32 vs unsharded f32, outside the MoE"] = f32_rest
    print(f"        sharded f32 vs unsharded f32 outside the MoE's leaves (no routing decision "
          f"reaches them but through the activations): {f32_rest:.3e}")
    for r in ranks:
        wgmma = r["by_variant"].get("wgmma", 0)
        check(r["launches"] == expected and (wgmma == expected or not cuda),
              f"rank {r['rank']}: {r['launches']} flash launches ({r['by_variant']}), "
              f"expected {expected}")
        check(not cuda or set(r["flash_heads"]) == {cfg.num_heads // tp},
              f"rank {r['rank']}: flash launched on {r['flash_heads']} query heads, not "
              f"{cfg.num_heads // tp}")
        check(r["losses"] == r0["losses"], f"rank {r['rank']} saw other losses {r['losses']}")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], refs["unsharded"]["losses"]))
    check(all(np.isfinite(r0["losses"])) and loss_gap <= 1e-2,
          f"sharded losses {r0['losses']}, unsharded {refs['unsharded']['losses']}")
    check(worst["sharded vs same split"] <= SHARD_CONTROL_TOL,
          f"sharded updates off the same split's: {worst}")
    check(worst["sharded f64 vs unsharded f64"] <= SHARD_WITNESS_TOL,
          f"the float64 sharded step is off the unsharded one: {worst}")
    check(worst["SGD sharded vs unsharded f32"] <= limit,
          f"the bf16 sharded gradient is farther from the float32 one than bf16's own: {worst}")

    # (a2) the tensor-parallel prefill and decode against the unsharded ones
    def scaled(got, want):
        live = want > -1e8  # the padded vocabulary's logits are at -1e9 on both sides
        return float(np.abs(got - want)[live].max() / np.abs(want[live]).max())

    def row_dist(got, want):
        """Each row's (and step's) ||got - want|| / ||want|| over the vocabulary."""
        got = got.reshape(-1, got.shape[-1]).astype(np.float64)
        want = want.reshape(-1, want.shape[-1]).astype(np.float64)
        live = want[0] > -1e8
        return np.linalg.norm((got - want)[:, live], axis=1) / np.linalg.norm(want[:, live],
                                                                             axis=1)

    serve_out = {}
    for label, which, dtype, with_prefill in SERVE_CASES:
        scfg = shard_serve_config(sizes, which, dtype)
        ref = serve_refs[label]
        res = {"tick_ms": float(np.median([max(r["serve"][label]["tick_s"][i] for r in ranks)
                                           for i in range(sizes["decode_steps"])])) * 1e3,
               "ref_tick_ms": float(np.median(ref["tick_s"])) * 1e3,
               "windows": r0["serve"][label]["windows"]}
        if with_prefill:
            res.update(prefill_s=max(r["serve"][label]["prefill_s"] for r in ranks),
                       ref_prefill_s=ref["prefill_s"])
        texts = []
        for part in ("prefill", "decode") if with_prefill else ("decode",):
            gap = max(scaled(r["serve"][label][part], ref[part]) for r in ranks)
            res[f"{part}_gap"] = gap
            what = (f"prefill B={sizes['serve_batch']} S={sizes['serve_seq']}" if part == "prefill"
                    else f"decode B={len(sizes['serve_pos'])}, {sizes['decode_steps']} steps over "
                         f"caches of {sizes['serve_cache']} positions from "
                         f"{list(sizes['serve_pos'])}")
            if dtype == torch.float32:
                tol = SHARD_PREFILL_TOL if part == "prefill" else SHARD_DECODE_TOL
                texts.append(f"{what}: max |sharded - unsharded| {gap:.3e} of the largest "
                             f"|logit| (tol {tol:g})")
                check(gap <= tol, f"the sharded {label} {part} is off by {gap:.3e}")
                continue
            # bf16: each row's distance to the float32 run, sharded against unsharded
            truth = serve_refs[label.replace("bf16", "f32")][part]
            mine = max(float(np.median(row_dist(r["serve"][label][part], truth))) for r in ranks)
            theirs = float(np.median(row_dist(ref[part], truth)))
            res[f"{part}_to_f32"] = [mine, theirs]
            texts.append(f"{what}: max |sharded - unsharded| {gap:.3e} of the largest |logit|"
                         + (f" (tol {BF16_SCALE_TOL:g})" if not scfg.is_moe else "")
                         + f"; median row distance to float32, sharded {mine:.3e}, unsharded "
                         f"{theirs:.3e} (tol {SHARD_UNSHARDED_RATIO} x)")
            check(mine <= SHARD_UNSHARDED_RATIO * theirs,
                  f"the sharded {label} {part} is farther from float32 than the unsharded one: "
                  f"{mine:.3e} against {theirs:.3e}")
            check(scfg.is_moe or gap <= BF16_SCALE_TOL,
                  f"the sharded {label} {part} is off by {gap:.3e}")
        heads = (f"heads {scfg.num_heads // tp} of {scfg.num_heads} a rank, the caches' "
                 + (f"sequence on model ({sizes['serve_cache'] // tp} positions a rank, the "
                    "query heads gathered before the windows combine)" if res["windows"]
                    else f"KV heads {scfg.num_kv_heads // tp} of {scfg.num_kv_heads} a rank"))
        timing = (f"prefill {res['prefill_s']:.3f} s wall (slowest rank; unsharded on one "
                  f"process {res['ref_prefill_s']:.3f} s), " if with_prefill else "")
        print(f"  (a2) {label}: {scfg.name}, {scfg.num_layers} layers, {heads}; "
              + "; ".join(texts) + f"; {timing}a decode tick {res['tick_ms']:.2f} ms wall "
              f"(median, slowest rank; unsharded on one process {res['ref_tick_ms']:.2f} ms)  "
              f"[{card}]")
        check(bool(res["windows"]) == (which == "window"),
              f"the {label} caches held as windows: {res['windows']}")
        serve_out[label] = res

    # (b) the elastic restore
    print(f"  (b) the weights (params, step) saved from (2, 2) in {r0['save_s']:.2f} s (gathered; "
          f"rank 0 writes), restored onto ({SHARD_RANKS}, 1) in "
          f"{max(r['restore_s'] for r in ranks):.2f} s ({[round(r['restored_local_gb'], 3) for r in ranks]} "
          f"GB a rank), gathered back: equal on every rank "
          f"{all(r['restored_equal'] for r in ranks)}")
    check(all(r["restored_equal"] for r in ranks), "the restore onto (4, 1) is not array-equal")

    # (c) the sharded decode
    dec_err = max(float(np.abs(r["decode"] - want).max()) for r in ranks)
    scale = float(np.abs(want).max())
    tick = float(np.median([max(r["tick_s"][i] for r in ranks)
                            for i in range(sizes["decode_steps"])]))
    print(f"  (c) sharded decode, {sizes['decode_arch']}'s attention at full width "
          f"(H {dcfg.num_heads}, KV {dcfg.num_kv_heads}, D {dcfg.head_dim}), float32, B="
          f"{sizes['decode_batch']}, a cache of {sizes['decode_cache']} over {SHARD_RANKS} "
          f"ranks, {sizes['decode_steps']} steps from {list(sizes['decode_pos'])}: max |sharded - "
          f"unsharded| {dec_err:.3e} (tol {SHARD_DECODE_TOL:g} + rel, max |out| {scale:.3f}); "
          f"a tick {tick * 1e3:.2f} ms wall (median, slowest rank), unsharded on one process "
          f"{np.median(ref_tick) * 1e3:.2f} ms")
    off = max(float(np.max(np.abs(r["decode"] - want) - SHARD_DECODE_TOL * np.abs(want)))
              for r in ranks)
    check(off <= SHARD_DECODE_TOL, f"the sharded decode is off the unsharded one by {dec_err:.3e}")

    # (d) the collectives
    m, kdim, n = sizes["ring"]
    print(f"  (d) compressed_psum of {sizes['psum_elems']} float32 a rank: "
          f"{max(r['psum_s'] for r in ranks):.3f} s against all_reduce's "
          f"{max(r['allreduce_s'] for r in ranks):.3f} s; max |compressed - exact| / max |exact| "
          f"{max(r['psum_rel'] for r in ranks):.4f} (tol {SHARD_PSUM_TOL}); equal to the plain "
          f"computation {all(r['psum_equal_plain'] for r in ranks)}")
    print(f"      ring_allgather_matmul, m {m} k {kdim} n {SHARD_RANKS} x {n}: "
          f"{max(r['ring_s'] for r in ranks) * 1e3:.2f} ms against all_gather + matmul "
          f"{max(r['allgather_matmul_s'] for r in ranks) * 1e3:.2f} ms; max rel err vs x @ w "
          f"{max(r['ring_rel'] for r in ranks):.3e} (tol {SHARD_RING_TOL:g})  [{card}]")
    for r in ranks:
        check(r["psum_rel"] < SHARD_PSUM_TOL and r["psum_equal_plain"],
              f"rank {r['rank']}: compressed_psum {r['psum_rel']}, plain {r['psum_equal_plain']}")
        check(r["ring_rel"] <= SHARD_RING_TOL, f"rank {r['rank']}: ring {r['ring_rel']}")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 19 took {seconds:.1f} s ({spawn_s:.1f} s in the ranks): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + "; rank 0's parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in r0["times"].items())
          + f", start-up and the results' return {spawn_s - sum(r0['times'].values()):.1f} s")
    return dict(launches=sum(r["launches"] for r in ranks),
                prefill_flops=r0["prefill_flops"], serve=serve_out,
                launches_by_rank=[r["launches"] for r in ranks],
                step_s=step_s, unsharded_step_s=refs["unsharded"]["step_s"],
                gloo_share=gloo_s / step_s[-1], peak_gb=[r["peak_gb"] for r in ranks],
                update_gaps=worst, decode_tick_ms=tick * 1e3, decode_max_abs=dec_err,
                psum_s=max(r["psum_s"] for r in ranks),
                allreduce_s=max(r["allreduce_s"] for r in ranks),
                ring_ms=max(r["ring_s"] for r in ranks) * 1e3,
                allgather_matmul_ms=max(r["allgather_matmul_s"] for r in ranks) * 1e3,
                gather_s=max(r["gather_s"] for r in ranks),
                reduce_s=max(r["reduce_s"] for r in ranks),
                coll_traced=r0["coll_traced"], seconds=seconds)


# Phase 20: the dry run (launch/dryrun.py) held against the card.
DRY_LAYERS = 2  # (b): internlm2-1.8b's prefill at 2 of 24 layers under the op counter
DRY_FLOPS_RTOL = 1e-9
ONE_CARD = MeshShape((1, 1), ("data", "model"))


def _terms(rec: dict) -> str:
    r = rec["roofline"]
    bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
    return (f"compute {r['compute_s'] * 1e3:.2f} ms, memory {r['memory_s'] * 1e3:.2f} ms, "
            f"collective {r['collective_s'] * 1e3:.3f} ms; dominant {r['dominant']}, bound "
            f"{bound * 1e3:.2f} ms")


def sharded_dryrun_checks(sharded_lm: dict, sizes: dict = SHARD_LM) -> dict:
    """Phase 20 (b)'s tensor-parallel part and (c): phase 19's prefill count
    on rank 0 against the dry run's rank on meta, a (2, 2) mesh; phase 19's
    traced step against the calls the dry run's rank records."""
    out: dict = {}
    mesh22 = MeshShape(sizes["mesh"], ("data", "model"))
    scfg = shard_serve_config(sizes, "lm", torch.bfloat16)
    tspec = ShapeSpec("tp_prefill", "prefill", sizes["serve_seq"], sizes["serve_batch"])
    tp_meta = tdryrun.dryrun_cell(scfg, tspec, mesh22)
    tp_got = sharded_lm["prefill_flops"]
    tp_rel = abs(tp_got - tp_meta["flops_per_chip"]) / tp_meta["flops_per_chip"]
    print(f"      phase 19's tensor-parallel prefill ({sizes['arch']}, {scfg.num_layers} layers, "
          f"B={sizes['serve_batch']} S={sizes['serve_seq']}, bf16) on rank 0 of (2, 2): "
          f"{tp_got:.6e} flops on the card, the dry run's rank on meta "
          f"{tp_meta['flops_per_chip']:.6e}, relative gap {tp_rel:.2e} (tol {DRY_FLOPS_RTOL:g}); "
          f"{tp_meta['port_path']}")
    check(tp_rel <= DRY_FLOPS_RTOL, f"the tensor-parallel count on the card ({tp_got}) differs "
                                    f"from meta ({tp_meta['flops_per_chip']})")
    out.update(tp_counter_flops=tp_got, tp_meta_flops=tp_meta["flops_per_chip"])

    # (c) phase 19's profiled step against the calls the dry run's rank records
    # on meta for the same config, batch and mesh
    traced, meta = sharded_lm["coll_traced"], []
    tdryrun.dryrun_cell(shard_lm_config(sizes),
                        ShapeSpec("tp_train", "train", sizes["seq"], sizes["batch"]),
                        mesh22, calls=meta, num_microbatches=sizes["microbatches"])

    def by_kind(records):
        return {k: (sum(1 for r in records if r["kind"] == k),
                    sum(r["result_bytes"] for r in records if r["kind"] == k))
                for k in sorted({r["kind"] for r in records})}

    def calls(records):
        return sorted((r["kind"], tuple(r["axes"]), r["group"], r["result_bytes"])
                      for r in records)

    print(f"  (c) phase 19's first sharded step on rank 0, traced: {by_kind(traced)}; the dry "
          f"run's rank on meta: {by_kind(meta)} (kind: calls, result bytes); call for call "
          f"equal {calls(traced) == calls(meta)}")
    check(calls(traced) == calls(meta),
          "the traced collectives differ from the calls the dry run's rank records")
    for kind, seconds in (("all-gather", sharded_lm["gather_s"]),
                          ("all-reduce", sharded_lm["reduce_s"])):
        ring = sum(ring_bytes(r["kind"], r["result_bytes"], r["group"]) for r in meta
                   if r["kind"] == kind and tuple(r["axes"]) == ("data",))
        if ring:
            print(f"      {kind} over data: {ring / 1e9:.3f} GB ring bytes a rank; gloo {seconds:.3f} s "
                  f"({seconds / ring * 1e9:.3f} s/GB) against the NVLink term "
                  f"{ring / H100_SXM.link_bw * 1e3:.2f} ms ({1e9 / H100_SXM.link_bw:.4f} s/GB)")
    out["collectives"] = dict(traced=by_kind(traced), meta=by_kind(meta),
                              ici_bytes=collective_stats(meta).ici_bytes_per_chip,
                              gather_s=sharded_lm["gather_s"], reduce_s=sharded_lm["reduce_s"])
    return out


def dryrun_phase(dev, card: str, flash_entry: dict, full: dict, sharded_lm: dict) -> dict:
    """Phase 20: (a) the dry run of phase 7's prefill and phase 16e's train
    step on a (1, 1) mesh, beside what those phases measured; (b) the op
    counter on the card against its count on meta; (c) phase 19's profiled
    collectives against the calls the dry run's rank records on meta; (d)
    the phase's seconds."""
    phase("phase 20: the dry run (launch/dryrun.py) against the card")
    t0 = time.perf_counter()
    out: dict = {}
    # (a) the two cells, priced at the H100 record's peaks
    pcfg, tcfg = get_config(ARCH), get_config(TRAIN_ARCH)
    pspec = ShapeSpec("prefill_32k", "prefill", PREFILL_SEQ, PREFILL_BATCH)
    tspec = ShapeSpec("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    pre = tdryrun.dryrun_cell(pcfg, pspec, ONE_CARD)
    trn = tdryrun.dryrun_cell(tcfg, tspec, ONE_CARD, num_microbatches=TRAIN_MICROBATCHES)
    for label, rec, ms, peak in (
            (f"{ARCH} prefill B={PREFILL_BATCH} S={PREFILL_SEQ}", pre,
             flash_entry["prefill_ms"], flash_entry["prefill_peak_bytes"]),
            (f"{TRAIN_ARCH} train step B={TRAIN_BATCH} S={TRAIN_SEQ}, {TRAIN_MICROBATCHES} "
             f"microbatches, remat {tcfg.remat_policy}", trn, full["median_step_s"] * 1e3,
             full["peak_gb"] * 1e9)):
        r = rec["roofline"]
        bound_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
        print(f"  (a) {label}: {_terms(rec)} at {H100_SXM.name}'s peaks; measured median "
              f"{ms:.2f} ms (share of bound {bound_ms / ms:.3f}); "
              f"modelled peak {r['hbm_gb_per_chip'] * 2**30 / 1e9:.2f} GB beside "
              f"max_memory_allocated {peak / 1e9:.2f} GB; {rec['flops_per_chip']:.4e} flops, "
              f"{rec['bytes_per_chip'] / 1e9:.2f} GB moved; {rec['port_path']}  [{card}]")
    held = flash_entry["prefill_held_bytes"]
    pre_args = pre["memory_analysis"]["argument_size_in_bytes"]
    print(f"      prefill arguments: the dry run's {pre_args} B (bf16 weights, JAX's serving "
          f"rule, and int32 tokens) beside phase 7's {held['weights'] + held['tokens']} B "
          f"(float32 masters {held['weights']} B, cast to bf16 on use, P8; tokens "
          f"{held['tokens']} B): phase 7 holds {held['weights'] + held['tokens'] - pre_args} B more")
    trn_args = trn["memory_analysis"]["argument_size_in_bytes"]
    print(f"      train arguments: the dry run's {trn_args} B, phase 16e's state and batch "
          f"{full['arg_bytes']} B")
    check(trn_args == full["arg_bytes"], f"the train cell's argument bytes {trn_args} differ "
                                         f"from phase 16e's {full['arg_bytes']}")
    out.update(prefill=dict(roofline=pre["roofline"], measured_ms=flash_entry["prefill_ms"],
                            flops=pre["flops_per_chip"], bytes=pre["bytes_per_chip"],
                            args=pre_args),
               train=dict(roofline=trn["roofline"], measured_ms=full["median_step_s"] * 1e3,
                          flops=trn["flops_per_chip"], bytes=trn["bytes_per_chip"],
                          args=trn_args))

    # (b) the counter on the card against its count on meta, 2 layers
    cfg2 = dataclasses.replace(pcfg, num_layers=DRY_LAYERS)
    meta = tdryrun.dryrun_cell(cfg2, pspec, ONE_CARD)["flops_per_chip"]
    model = init_model(cfg2, seed=0, device=dev).to(torch.bfloat16)
    stream = SyntheticLMStream(cfg2.vocab_size, PREFILL_SEQ, PREFILL_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(next(stream)["tokens"]).to(dev)}
    prefill = make_prefill_fn(cfg2, device=dev)
    before = fkmod.flash_attention_cuda.launches
    with OpCounter() as counter:
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    launches = fkmod.flash_attention_cuda.launches - before
    got = counter.cost.flops
    rel = abs(got - meta) / meta
    print(f"  (b) {ARCH} prefill at {DRY_LAYERS} of {pcfg.num_layers} layers on the card under "
          f"the op counter: {got:.6e} flops ({counter.cost.kernel_flops:.4e} of them the flash "
          f"kernel's custom op, {counter.cost.op_counts['kernel']} calls), the meta count "
          f"{meta:.6e}, relative gap {rel:.2e} (tol {DRY_FLOPS_RTOL:g}); flash launches {launches}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits under the op counter")
    check(rel <= DRY_FLOPS_RTOL, f"the counter on the card ({got}) differs from meta ({meta})")
    check(launches == DRY_LAYERS and counter.cost.op_counts["kernel"] == DRY_LAYERS,
          f"the flash kernel ran {launches} times through {counter.cost.op_counts['kernel']} "
          f"custom-op calls, not {DRY_LAYERS}")
    del model, logits, batch
    out.update(counter_flops=got, meta_flops=meta, launches=launches)
    out.update(sharded_dryrun_checks(sharded_lm))
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  (d) phase 20 took {out['seconds']:.1f} s; {time.perf_counter() - T_START:.1f} s "
          f"since the script started")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    # -- phase 1: card, versions, build ------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"tf32: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} libraries from the CUDA sources in {time.perf_counter() - t0:.2f} s wall")
    for lib in built.values():
        print(f"  {lib.name}: nvcc {lib.seconds:.2f} s -> {lib.path.relative_to(REPO)}")
        for kernel, resources in build.ptxas_resources(lib.log).items():
            PTXAS[kernel] = resources
            print(f"    {kernel[:110]}: {resources}")  # the mangled name, ptxas -v

    # Phase 3's tensor is drawn on the host while the LM phases (6-8, 13 and
    # 16) keep the card busy; phase 14's ranks memory-map its files.
    shard_dir = tempfile.mkdtemp(prefix="chip_smoke_nell2_")
    draw = Nell2Draw(shard_dir)
    try:
        # -- phase 2: kernel against plain, small CP-ALS card vs CPU ---------
        phase("phase 2: kernel vs plain version on the card")
        phase_kernel_cases(dev)
        flash_entry = lm_phases(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        decoded = decode_phase(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        trained = training_phase(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        families = families_phase(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        families["trained"] = family_training_phase(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        mttkrp_entry, nell2, lex_fits, eager_fits = cp_als_phases(dev, card, draw)
        # Phase 12's Table II part and phase 10 run here, while phase 3's
        # tensor and lex plans are resident.
        table2 = autotune_table2_phase(dev, card, nell2, lex_fits)
        ordered = ordering_phase(dev, card, nell2, lex_fits)
        return _main_after_phase10(dev, card, mttkrp_entry, nell2, lex_fits, eager_fits, table2,
                                   ordered, draw.paths, flash_entry, decoded, trained, families)
    finally:
        draw.stop()
        shutil.rmtree(shard_dir, ignore_errors=True)


def _main_after_phase10(dev, card, mttkrp_entry, nell2, lex_fits, eager_fits, table2, ordered,
                        paths, flash_entry, decoded, trained, families) -> int:
    nell2_shape = nell2.shape
    del nell2
    gc.collect()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ops.clear_caches()  # the memos pin the NELL-2 plans' device buffers
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory held after the CP-ALS phases: {held_gb:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after clearing the plan memos")
    served = service_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    engine = engine_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    tuned = autotune_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_phase(dev, card, paths, nell2_shape, eager_fits, lex_fits,
                            {t: r["fit"] for t, r in engine["runs"].items()})
    gc.collect()
    torch.cuda.empty_cache()
    contracts = contract_phase(dev, card, [
        *(a for o in ("lex", "blocked") for a in ordered["results"][o]["contracts"]),
        *served["contracts"], *engine["contracts"]])
    gc.collect()
    torch.cuda.empty_cache()
    sharded_lm = sharded_lm_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_phase(dev, card, flash_entry, trained["full"], sharded_lm)
    row_run = ordered["launches"].get("rows", 0)
    mttkrp_entry["launches_by_path"] = {
        "cp_als (phase 3)": mttkrp_entry["launches"], "service (phase 9)": served["launches"],
        "cp_als_fused, lex / secondary-sort / degree (phase 10)": row_run,
        "run_experiments, impl kernel (phase 11)": engine["launches"],
        "Autotuner.tune, the service's band at ranks 8 and 16 (phase 12)": tuned["launches_tune"],
        "DecompositionService(autotuner=) and cp_als_fused(autotune=) (phase 12)":
            tuned["launches_service"],
        "run_experiments(autotune=True), NELL-2@0.026 (phase 12)": tuned["launches_engine"],
        "FusedCPALS(autotune=), Table II, lex / degree (phase 12)": table2["launches"],
        "decode_step, BatchServer (phase 13)": 0,
        **{path: rows for path, (rows, _) in sharded["launches"].items()}}
    mttkrp_entry["launches"] = sum(mttkrp_entry["launches_by_path"].values())
    mttkrp_entry["max_abs_err"] = max(
        [mttkrp_entry["max_abs_err"], served["stacked_max_abs"], engine["max_abs"],
         tuned["max_abs"]]
        + [r["max_abs"] for o, res in ordered["results"].items() if o != "blocked"
           for r in res["rows"]])
    mttkrp_entry["per_ordering"] = {
        o: dict(split_mode=[r["split_mode"] for r in res["rows"]],
                per_mode_ms=[r["ms"] for r in res["rows"]],
                per_mode_ms_b4=[r["ms_b4"] for r in res["rows"]],
                per_mode_tiles_ms=[r["tiles_ms"] for r in res["rows"]],
                per_mode_block_ms=[r["block_ms"] for r in res["rows"]],
                per_mode_plain_ms=[r["plain_ms"] for r in res["rows"]],
                per_mode_bound_ms=[r["bound_ms"] for r in res["rows"]],
                per_mode_bound_ms_b4=[r["bound_ms_b4"] for r in res["rows"]],
                order_device_ms=res["order_ms"], plan_host_s=res["plan_s"],
                fused_fit_gap=res["fit_gap"])
        for o, res in ordered["results"].items()}
    blocked = ordered["results"]["blocked"]["rows"]
    tile_entry = dict(
        name="mttkrp_tile_kernel",
        route="cuda",
        source="src/repro_torch/kernels/mttkrp/csrc/mttkrp_split.cu",
        replaces="src/repro/kernels/mttkrp/kernel.py:44",
        max_abs_err=max(r["max_abs"] for r in blocked),
        ms=sum(r["ms"] for r in blocked),
        previous_ms=sum(r["block_ms"] for r in blocked),
        previous="mttkrp_block_kernel, csrc/mttkrp.cu, on the same blocked plans",
        plain_ms=sum(r["plain_ms"] for r in blocked),
        bound_ms=sum(r["bound_ms"] for r in blocked),
        bound_by=mttkrp_entry["bound_by"],
        library_ms=None,
        per="one CP-ALS sweep of MTTKRPs over the blocked ordering's plans: modes 0-2, one restart",
        per_mode_ms=[r["ms"] for r in blocked],
        per_mode_ms_b4=[r["ms_b4"] for r in blocked],
        ms_b4=sum(r["ms_b4"] for r in blocked),
        bound_ms_b4=sum(r["bound_ms_b4"] for r in blocked),
        per_mode_bound_ms_b4=[r["bound_ms_b4"] for r in blocked],
        per_mode_block_ms=[r["block_ms"] for r in blocked],
        per_mode_ms_on_lex_plans=[r["tiles_ms"] for r in ordered["results"]["lex"]["rows"]],
        grid=ordered["tile_grid"],
        sweep_profile=ordered["results"]["blocked"]["tile_split_ms"],
        launches_by_path={"cp_als_fused, blocked (phase 10)": ordered["launches"].get("tiles", 0),
                          **{path: tiles for path, (_, tiles) in sharded["launches"].items()}},
    )
    tile_entry = {**tile_entry, "launches": sum(tile_entry["launches_by_path"].values())}
    mttkrp_entry["engine"] = {k: engine[k] for k in (
        "runs", "ref", "speedup", "energy", "engine_s", "recon_s", "gates_s", "reorder_s")}
    mttkrp_entry["autotune"] = dict(table2={k: v for k, v in table2.items() if k != "launches"},
                                    **{k: v for k, v in tuned.items() if not k.startswith("launches")})
    fams = families["families"]
    flash_entry["launches_by_path"] = {
        "prefill (phase 7)": flash_entry["launches"], "decode_step, BatchServer (phase 13)": 0,
        f"train(), {TRAIN_ARCH} full width (phase 16)": trained["full"]["launches"],
        "prefill, zamba2-1.2b (phase 17b)": fams["zamba2-1.2b"]["prefill"]["launches"]["flash"],
        "prefill, rwkv6-3b (phase 17c)": fams["rwkv6-3b"]["prefill"]["launches"]["flash"],
        "prefill, whisper-base (phase 17d)": fams["whisper-base"]["prefill"]["launches"]["flash"],
        f"prefill, {VLM_ARCH} {VLM_LAYERS} layers (phase 17e)":
            fams[VLM_ARCH]["prefill"]["launches"]["flash"],
        **decode_launches(fams, "flash"),
        **{f"train steps, {arch} (phase 18{'c' if arch == 'zamba2-1.2b' else 'd'})":
               families["trained"]["train"][arch]["launches"]["flash"]
           for arch in ("zamba2-1.2b", "whisper-base", VLM_ARCH)},
        f"sharded train step, {SHARD_LM['arch']} {SHARD_LM['layers']} layers, {SHARD_RANKS} "
        "gloo ranks (phase 19)": sharded_lm["launches"],
        f"prefill under the op counter, {ARCH} {DRY_LAYERS} layers (phase 20b)": dry["launches"]}
    flash_entry["phase17_shapes"] = families["flash_shapes"]
    flash_entry["sharded_lm"] = {k: v for k, v in sharded_lm.items() if k != "launches"}
    flash_entry["launches"] = sum(flash_entry["launches_by_path"].values())
    flash_entry["lse_max_abs_err"] = trained["lse"]["max_abs_err"]
    flash_entry["training"] = {k: trained[k] for k in ("lse", "grad", "moe", "reduced", "full")}
    flash_entry["decode"] = decoded
    flash_entry["dryrun"] = {k: v for k, v in dry.items() if k != "launches"}
    mttkrp_entry["sharded"] = {k: sharded[k] for k in (
        "fit_gaps", "table2_s", "engine_s", "table2", "timing", "peak_gb")}
    mttkrp_entry["service"] = {k: served[k] for k in (
        "stats", "batch_ms", "profile_ms", "peak_gb", "stage_host_ms", "enqueue_ms", "stacked_ms",
        "stacked_plain_ms", "stacked_bound_ms")}
    total_s = time.perf_counter() - T_START
    print(f"phase 20 took {dry['seconds']:.1f} s; total {total_s:.1f} s (limit 1200 s)")
    kernels = [mttkrp_entry, tile_entry, flash_entry, *scan_entries(families),
               *bwd_entries(families["trained"])]
    print(json.dumps({"phase15": contracts}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)
