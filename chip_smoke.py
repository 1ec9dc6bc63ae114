"""GPU smoke of the PyTorch/CUDA port: builds the kernels, holds each against
its plain version, and drives the tiered serving loop on one GPU at the full
width of ``qwen1_5_4b`` (serially and on the default async media path), of
``qwen3_32b`` (GQA with qk-norm, at reduced depth) and of ``zamba2_1_2b``
(the hybrid family, host tiers on the ``cxl_hw`` expander) and of
``qwen3_moe_235b`` (the MoE family, at reduced depth), takes a few tiered
decode steps of ``internlm2_20b``, ``command_r_35b``, ``dbrx_132b`` and
``qwen2_vl_72b`` (M-RoPE; also a forward on a vision batch), runs the
``hubert_xlarge`` encoder and the pure-SSM ``mamba2_780m``, preempts and
resumes a ``qwen1_5_4b`` request through the host tier, serves a burst
trace through the SLA-aware frontend over two ``qwen1_5_4b`` replicas, one
of which fails, and serves two tenants on one ``qwen1_5_4b`` engine, their
scheduled demand priced by the budget arbiter and the capacity planner;
and first of all trains: full-width ``qwen1_5_4b`` train steps with tiered
Adam, a checkpoint resume and one ``qwen3_moe_235b`` layer's step.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA GPU

Phases (any failure exits non-zero before the result line):
  1. print the card's name and power limit, build the seven CUDA sources
     (the seven ported kernels and the decode step's three glue kernels;
     one ``nvcc`` per source, all started together);
  2. each kernel vs its plain version on the card at the serving paths'
     full-width page shapes (T=16; KV=20, hd=128; KV=32, hd=64; the GQA
     shape KV=8, hd=128 with H=64 (qwen3_32b, command_r_35b) and H=48
     (internlm2_20b, dbrx_132b); and KV=4, hd=128, H=64 (qwen3_moe_235b,
     group 16); quant/transcode/dequant/cxl encode/cxl decode byte-equal,
     fused and per-pool attention within 2e-4, the per-pool one with an
     empty pool and tails past ``n_pages``);
  2j. the training path, on the empty card, before any engine: full-width,
     full-depth ``qwen1_5_4b`` (3.95 B params) on 2 x 512-token batches
     from ``HostLoader``, ``make_train_step`` with tiered Adam under
     ``default_policy`` and remat, the reference example's optimizer (lr
     3e-4 after a 20-step warmup): two steps on one batch descend, then 6
     loader steps with finite losses and grad norms, ``moment_bytes`` equal
     to its formula; prints step ms (mean of steps 2-6), tokens/s and peak
     memory. At 2 layers (full width): 4 steps straight against 2 steps, an
     async save, a restore into fresh state (bit-equal, on the card) and 2
     more, losses within 1e-3 (bit-equal reported). One ``qwen3_moe_235b``
     layer: a step with the int8 wire on, both wires' input gradients
     nonzero and finite, the wire's backward on the card equal to the CPU's
     on the step's cotangent. No kernel is launched (counted from 0);
  2b. ``internlm2_20b`` (group 6), ``command_r_35b`` (group 8, tied 256k
     head), ``dbrx_132b`` (MoE, 16 experts top 4) and ``qwen2_vl_72b``
     (M-RoPE, QKV biases) at full width and depth 4: prefill of one
     500-token prompt, a few tiered decode steps through the fused kernel
     (and the glue kernels: two ``rmsnorm`` a layer and the final one, one
     ``qkv_epilogue`` a layer, one ``silu_mul`` a dense SwiGLU layer, each
     step), the glue kernels held to their plain versions at the step's
     shapes, and one step on the card against the same step on the CPU at
     phase 4's bars; for ``qwen2_vl_72b`` also one forward of a 2 x 512 vision
     batch (the first 64 positions patch embeddings, 3-axis positions), held
     finite, and a 2-slot decode step at unequal lengths whose M-RoPE cos
     and sin, q and k rows in every layer equal 1-D RoPE's at each slot's
     own position;
  2g. ``qwen3_moe_235b`` at full width (128 experts, top 8, 64 heads on 4)
     and 8 of its 94 layers (full depth is ~470 GB of bf16 weights): phase
     3's default path and its checks, phase 4's compares and phase 5's
     timings at its shapes; two MoE layer calls on the same inputs
     byte-equal, and one layer timed at a prefill and the decode shape;
     prints the prefill ``dropped_frac``, the weight bytes and the expert
     bytes a decode step reads (every expert, as the reference's einsum);
     frees the card after;
  2h. ``hubert_xlarge`` at full width and full depth (48 layers, hd 80,
     bidirectional, LayerNorm): a bf16 forward of 2 x 3072 frames (past the
     blockwise-attention threshold; the reference's blocks need a multiple
     of 1024), timed, then in f32 with the same weights, the difference
     reported; the tiered engine must refuse it;
  2c. ``qwen3_32b`` at full width (qk-norm, 64 heads on 8 KV heads) and 32
     of its 64 layers (full depth is ~65.5 GB of bf16 weights beside ~18 GB
     of class buffers), random bf16 weights from a seed: phase 3's default
     path and its checks, phase 4's compares and phase 5's timings at its
     shapes; the engine stays resident for its profile;
  2d. ``mamba2_780m`` at full width (48 SSD layers, d_model 1536, random
     bf16 weights): a batch of 2 prompts of 64-128 tokens (cut: the
     recurrent prefill runs one 48-layer decode step per token) through
     ``Model.prefill`` and 16 greedy decode steps, timed in bf16, then in
     f32 with the same weights, where the decode logits are held to the
     parallel forward over the same tokens within 0.15 (in bf16 both
     packages drift past that bar with depth, ``scripts/mamba2_drift.py``;
     reported); the tiered engine
     must refuse it;
  2e. preemption to the host tier at ``qwen1_5_4b``'s full width (the
     smoke's geometry, a profile window longer than the run): a 400-token
     request preempted after 5 steps, another request churning the vacated
     slot, a resume into the other slot: tokens bit-identical to an
     uninterrupted run, the resumed slot's table rows in its order, zero
     re-prefilled tokens, every parked page resumed, and the demotion billed
     (media queues, kernel dispatches) like a plain pipeline demotion of the
     same pages; prints the host-clock ms of ``preempt_slot`` and
     ``resume_into``;
  2f. ``ContinuousScheduler`` over two full-width ``qwen1_5_4b`` replicas
     sharing one set of weights, on the default path, serving a burst trace
     (64 steps, two SLA classes, interactive bursts) with 64-token prefill
     chunks while replica 0 hard-fails at step 40: every arrival done or
     refused, every done request with its full token count at TBT >= 1, zero
     re-prefill, preemptions, resumes and a failover park; prints the
     summary per class (TTFT/TBT in virtual steps), wall time, ms per
     virtual step and TCO savings per replica. Phases 2e and 2f count their
     launches from 0 and hold them to the cache's calls;
  2i. multi-tenancy at ``qwen1_5_4b``'s full width: (a) the cache at 4
     layers: tenant 0 flooding its slot ends at exactly its warm quota
     while tenant 1 still gets warm rows, a mass promotion of tenant 0 stays
     within its quota with the overflow left cold, a cold quota spills a
     batched demotion to HOST4, the warm and cold tables read back hold no
     row of another slot's pages, and ``tco_usd()`` is the tenants' sum;
     (b) the full engine (40 layers, async + prefetch, 8-step windows)
     serves four requests of tenants 0, 1, 0, 1 on 2 slots: two completed
     per tenant, both tenants' TCO savings, decode/prefill times, the
     pipeline's media bytes and prefetch hit rate; (c) phase 2f's
     scheduled demand fed to a ``BudgetArbiter`` reaches ``fleet_report``
     and the ``CapacityPlanner``; (d) the capacity frontier swept twice on
     the host (byte-equal JSON, monotone, dominating 2T by >= 22 savings
     points; its sha256 and host ms printed) and the README's two-tenant
     ``simulate_multitenant`` timed with each ``end_window``. (a) and (b)
     count their launches from 0 and hold them to the cache's calls;
  2k. the serving example (``repro_torch.serve_tiered_kv.run``, the
     reference example's defaults: 4 requests of 48 tokens, 32 new tokens,
     2 slots, alpha 0.3, 8-token pages, a 16-token recent window) at full
     width on ``zamba2_1_2b`` and ``qwen1_5_4b`` (async + prefetch), and on
     ``qwen1_5_4b`` with ``--serial-migration``: every request served, its
     printed lines and wall time logged, the fused kernel launched once per
     attention layer and step, quant/transcode/dequant as often as the cache
     called them (each of the four at least once over the runs),
     ``overlapped_steps`` > 0 on the async runs; each run stops once after
     step 20 for kernels #1-#4 against their plain versions at the geometry
     its engine gives them (the fused kernel on every attention layer of its
     live state, and at recent-window fills from 0 to full;
     quant/transcode/dequant at its page-out shape), uncounted and
     taken out of its wall time; the dense serve steps at ``qwen1_5_4b``'s
     width (``make_prefill_step`` on 2 x 512 tokens within 0.15 of
     ``Model.prefill``'s last logits, 8 ``make_decode_step`` steps on a
     1024-token cache within 0.15 of the teacher-forced forward);
     after phase 5, ``make_sp_pool_attention`` on layer 0's warm and cold
     pools of phase 3's mid-run state (one device: one per-pool launch and
     the merge, byte-equal to the kernel, timed beside it; two model shards
     in turn: within 2e-4 of the plain version with global slot positions);
     and, after phase 7, on the host in this process, the dry-run of
     ``qwen1_5_4b`` x its cells on ``meta``, with each cell's roofline terms
     on this card;
  3. the full-width engine (40 layers, random bf16 weights from a seed)
     serves 3 requests on 2 slots through ``TieredEngine.submit``/``run``:
     first with serial migration (the blocking executor; at policy weight
     alpha 0.5, then at the async run's), then on the default path
     (async migration + prefetch). Launch counts, reset before and read
     after each path, prove every decode layer ran the fused kernel and that
     page-out, migration and the host sentinels ran the quant, transcode and
     dequant kernels (as often as the cache called them), and every page-out
     reached ``quant_pages`` in the KV cache's bf16 (no f32 upcast); a few
     steps under ``ops.use_fused(False)`` drive the per-pool kernel (2
     launches per layer);
  3b. at reduced depth and full width, the cache's serial and async
     executors land bit-identical placements and payloads, with prefetch on
     and off, and under a ``seeded_storm`` fault plan;
  4. mid-run, one tiered decode step on the same state: the step on the
     card vs the same step on CPU copies of the params and state (the
     kernels' plain versions), and the per-pool step vs the fused step
     (logits, hotness);
  4b. every engine on the card replays its decode step as one CUDA graph,
     captured once per route: in phases 2b, 2c, 2g, 3 and 6 the captured
     step (a replay) on the mid-run state is held to the eager kernel step
     on a copy of it (logits, hotness, new state byte-equal, or, naming the
     outputs that differ, phase 4's bars), and, for the five served
     families, 40 engine steps from one start through the captured engine
     and again with the eager kernel step swapped in must give equal greedy
     tokens (two windows, page-outs, migrations); captures per route are
     printed (one each);
  5. each kernel held to its plain version again and timed at the shapes
     the run gave it (the decode step's glue kernels within one bf16 ulp, at
     its shapes: layer 0's weights on a random hidden state, the live
     lengths and recent window; their launches in the run whole steps of
     the attention layers; the per-pool attention kernel through its unchecked
     launch, so its wrapper's host range check is not timed; ``quant_pages``
     also on f32 pages of the same shape, as the engine handed them over
     when it upcast the cache; ``dequant_pages`` also on int8, in f32 and
     bf16, beside one ``torch.mul``, at the run's largest int8 call or the
     largest call's pages where the run made none), an empty launch
     as the floor under every small one, their bounds,
     both engines' decode/prefill/window times, tokens/s and peak memory;
     the two attention kernels, launched twice on the same inputs, must
     give byte-equal outputs (phases 2 and 5);
  6. the full-width ``zamba2_1_2b`` engine (38 SSM layers, the shared
     attention block's 7 applications over the tiered KV, random bf16
     weights from a seed) serves 3 requests on the default async + prefetch
     path with its host tiers on ``cxl_hw``: HOST8 reads launch
     ``cxl_decode_pages`` (a cohort is driven to HOST8 by hand if the
     policy leaves it empty: counted, but timed apart from the run's wall
     time and tokens/s), ``cxl_encode_pages`` encodes each page-out's
     layer-0 K/V pages (the first prefill's held byte-equal to its plain
     version and to ``quant_pages(., 8)``), launch counts equal the cache's
     calls, one step on the card agrees with the same step on the CPU, and phase
     5's timings are taken again at this run's shapes (hd=64);
  7. a profile of one decode step of each engine, eager and captured, last:
     once the profiler has run, every later launch costs more host time.
The engines that stay resident for the profiles are counted out of the peak
memory of the runs that follow them.
Media busy seconds in the engine are modeled time from the catalog's
parameters, not measurements of this card; they are not printed.
The ``kernels`` line lists all seven ported kernels and the decode step's
three glue kernels (``rmsnorm``, ``qkv_epilogue``, ``silu_mul``; replaces
"none", ``max_bf16_ulps`` in place of ``max_abs_err``) (launches from the main-path
run that drives each, and from the preemption, frontend, MoE, one-step and
multi-tenant runs as ``preempt_launches``/``frontend_launches``/
``moe_launches``/``one_step_launches``/``multitenant_launches`` (the
engine) and ``multitenant_cache_launches``, and from phase 2j as
``train_launches``, and from phase 2k as ``example_launches`` (per run) and
``sp_launches``; kernels 1-5 also carry their times at the
``qwen3_moe_235b`` shapes, ``at_qwen3_moe_235b``). The last line is the JSON result
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from repro_torch import pytree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ParallelConfig, TierScapeRunConfig, cells_for, get  # noqa: E402
from repro_torch.core import arbiter, capacity, simulator  # noqa: E402
from repro_torch.core.manager import ManagerConfig, make_manager  # noqa: E402
from repro_torch.data.pipeline import DataConfig, HostLoader, synthetic_corpus  # noqa: E402
from repro_torch.frontend import ContinuousScheduler, TraceConfig, generate  # noqa: E402
from repro_torch.kernels import build, cxl_line, ops, ref  # noqa: E402
from repro_torch.kernels import dequant_page, quant_page, transcode_page  # noqa: E402
from repro_torch.kernels import decode_glue  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh, make_mesh  # noqa: E402
from repro_torch.media.faults import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.models import Model, attention, inputs, layers, moe  # noqa: E402
from repro_torch.models.transformer import _attn_layer_count, layer_params  # noqa: E402
from repro_torch.optim import tiered_adam  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.runtime.graph import COPIED_FIELDS, GraphedStep, route as graph_route  # noqa: E402
from repro_torch import serve_tiered_kv  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402
from repro_torch.serving.engine import TieredEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ATTN_TOL = 2e-4
SEED = 0
DEV = "cuda"
T, R = 16, 32
# The analytical policy's TCO weight on the default path: low enough that
# pages reach the host tiers (so sentinels, swap-ins and prefetch run).
ASYNC_ALPHA = 0.1
PER_POOL_STEPS = 4  # decode steps driven under ops.use_fused(False)
MODES_LAYERS = 4  # depth of the phase-3b executor comparison
NEW_TOKENS = 48
# Prompt lengths per arch: the hybrid prefill scans the prompt one recurrent
# step per token (host-bound in eager PyTorch), so its prompts are shorter.
PROMPTS = {"qwen1_5_4b": (400, 601), "qwen3_32b": (400, 601), "zamba2_1_2b": (200, 301),
           "qwen3_moe_235b": (400, 601)}
# qwen3_32b at full depth: 64 x 0.975 GB of bf16 layer weights + 3.1 GB of
# embedding and head, beside class buffers that hold every layer's rows in
# each layer's slice (~18 GB at 64 layers): more than one 80 GB card.
QWEN3_LAYERS = 32
ONE_STEP_ARCHS = ("internlm2_20b", "command_r_35b", "dbrx_132b", "qwen2_vl_72b")
ONE_STEP_LAYERS, ONE_STEP_PROMPT, ONE_STEP_DECODE = 4, 500, 4
# qwen2_vl_72b's extras: a vision batch (seq / 8 = 64 patch positions) and a
# second prompt, of another length, for the 2-slot M-RoPE check.
VLM_BATCH, VLM_SEQ, VLM_SECOND_PROMPT = 2, 512, 300
# Phase 2g: qwen3_moe_235b at 8 of 94 layers: 8 x 4.98 GB of bf16 layer
# weights (4.83 GB of experts) + 2.49 GB of embedding and head.
MOE_LAYERS = 8
# Phase 2h: hubert_xlarge at full depth, past CHUNKED_ATTN_THRESHOLD (2048);
# the blockwise path needs a multiple of KV_BLOCK (1024).
HUBERT_BATCH, HUBERT_FRAMES = 2, 3072
HEAD_START_CYCLES = 2_000_000  # ~1 ms of SM clock: the spin before each timed call
HOST8_FORCED_PAGES = 32  # pages driven to HOST8 if the policy leaves it empty
# Phase 2d: mamba2_780m's recurrent prefill runs one decode step (48 SSM
# layers) per prompt token, so its prompts are cut to 64-128 tokens.
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_DECODE = 2, (64, 129), 16
DECODE_VS_FORWARD = 0.15  # tests/test_archs.py::test_smoke_decode_matches_forward
# Phase 2e: a 400-token request preempted after 5 decode steps; a 200-token
# request churns the vacated slot; the first resumes into the other slot.
PREEMPT_PROMPT, PREEMPT_NEW, PREEMPT_AFTER = 400, 24, 5
CHURN_PROMPT, CHURN_NEW = 200, 6
# Phase 2f: the frontend's burst trace over two replicas, replica 0
# hard-failing at virtual step 40 (checked on the SMOKE, whose geometry and
# token accounting are the same: 11 arrivals, 2 preemptions, 3 resumes, 1
# slot parked off the failed replica).
FRONTEND_TRACE = dict(kind="burst", steps=64, rate=0.06, seed=3, sla_mix=(0.85, 0.15),
                      burst_every=24, burst_len=4, burst_mult=8.0, burst_sla=1,
                      prompt_len=(200, 400), new_tokens=(16, 32), n_tenants=2,
                      tenant_mix=(0.8, 0.2), tenant_flip_step=32)
FRONTEND_CHUNK, FRONTEND_FAILURES = 64, {40: 0}
# Phase 2i: multi-tenancy at qwen1_5_4b's full width. (a) The cache's quota
# paths at MODES_LAYERS depth (512 regions: 128 warm rows at warm_frac 0.25,
# 256 at 0.5, 512 cold): tenant 0's warm quota on append, its promotion quota
# and its cold quota. (b) Four requests of tenants 0, 1, 0, 1 on the full
# engine at tests/test_multitenant.py's policy weight. (c) Phase 2f's
# scheduled demand into the arbiter and the planner (tests/test_frontend.py's
# arbiter). (d) benchmarks/capacity_frontier.py's sweep, twice, and the
# README's two-tenant run (2 x 4096 regions, 40 windows) on the host.
MT_WARM_QUOTA, MT_PROMOTE_QUOTA, MT_COLD_QUOTA = 48, 16, 8
MT_TENANTS, MT_PROMPTS, MT_NEW, MT_WINDOW, MT_ALPHA = (0, 1, 0, 1), (400, 601), 32, 8, 0.3
FRONTIER = dict(n_regions=512, accesses=200_000, flip=8, windows=16, warmup=2,
                server="v5e-base", years=3.0, fleet_scale=256, seed=0)
DOMINANCE_FLOOR = 22.0  # savings points over 2T: benchmarks/baseline_guard.py:86
# Phase 2j: training. qwen1_5_4b at full width and depth on 2 x 512-token
# batches from HostLoader, tiered Adam under default_policy (int8 moments on
# embed/lm_head, f32 elsewhere), remat on, and examples/train_tiered_lm.py's
# optimizer (lr 3e-4, cosine_schedule(20, 200): the first steps are warmup;
# a constant 1e-3, tests/test_archs.py's SMOKE rate, raised the full-width
# loss from 12.09 to 15.43 on the same batch on an H100); two steps on one
# batch, then TRAIN_STEPS from the loader. The resume check runs at
# RESUME_LAYERS (full width): RESUME_STEPS straight, against half of them,
# an async save, a restore into fresh state and the rest; the losses agree
# within RESUME_RTOL (they are bit-equal where every kernel of the step is
# deterministic). The MoE step runs one qwen3_moe_235b layer.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 6
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 3e-4, 20, 200
RESUME_LAYERS, RESUME_STEPS, RESUME_RTOL = 2, 4, 1e-3
TRAIN_MOE_LAYERS = 1
# Phase 4b: the captured step (a CUDA graph of the whole tiered step,
# replayed per token) on each run's mid-run state against the eager kernel
# step, and GRAPH_STEPS engine steps (two 16-step windows and more, with
# page-outs and window-boundary migrations) of two GRAPH_PROMPTS-token
# requests from one start, once through the captured engine and once with
# the eager kernel step swapped in: the greedy tokens must be equal. Its
# engines hold GRAPH_MAX_SEQ-token caches, so each fits beside the engines
# left resident.
GRAPH_STEPS, GRAPH_PROMPTS, GRAPH_MAX_SEQ = 40, (48, 72), 256
# The attention wrappers a captured step holds; each one's kernel symbol is
# its name + "_kernel" (phase 7 counts their events inside the replays).
ATTENTION_KERNELS = ("fused_tiered_attention", "paged_quant_attention")
# Phase 2k: the serving example (repro_torch.serve_tiered_kv, the reference
# example's defaults: 4 requests of 48 tokens, 32 new tokens, 2 slots, alpha
# 0.3, analytical, async + prefetch; 8-token pages, a 16-token recent window)
# at full width on its default arch and on qwen1_5_4b, once more serially;
# the dense serve steps on qwen1_5_4b (2 x 512-token prefill, 8 decode steps
# on a 1024-token dense cache, held to the teacher-forced forward at
# tests/test_archs.py's decode-vs-forward bar); the sp pool attention on
# layer SP_LAYER of phase 3's mid-run state; and the dry-run of DRYRUN_ARCH
# on the host, after the card's timed phases. Each example run stops once,
# after EXAMPLE_COMPARE_STEP steps (past its second 8-step window boundary),
# for the kernels' checks at the geometry its engine gives them (uncounted).
EXAMPLE_RUNS = (("zamba2_1_2b", ()), ("qwen1_5_4b", ()), ("qwen1_5_4b", ("--serial-migration",)))
EXAMPLE_COMPARE_STEP = 20
DENSE_BATCH, DENSE_PROMPT, DENSE_DECODE, DENSE_MAX_LEN = 2, 512, 8, 1024
SP_LAYER = 0
DRYRUN_ARCH = "qwen1_5_4b"
# The cxl codec takes hd 64 or 128; the zamba2 run gives the encode hd 64
# pages only, so it is also timed at scripts/row_group_times.py's hd=128
# cxl shape (the qwen1_5_4b page geometry).
CXL_ENCODE_HD128 = (32, 16, 20, 128)
REPLACES = {
    "fused_tiered_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:399"),
    "quant_pages": ("src/repro_torch/csrc/quant_page.cu", "src/repro/kernels/quant_page.py:39"),
    "transcode_pages": ("src/repro_torch/csrc/transcode_page.cu",
                        "src/repro/kernels/transcode_page.py:62"),
    "dequant_pages": ("src/repro_torch/csrc/dequant_page.cu",
                      "src/repro/kernels/dequant_page.py:35"),
    "paged_quant_attention": ("src/repro_torch/csrc/paged_quant_attention.cu",
                              "src/repro/kernels/paged_attention.py:183"),
    "cxl_encode_pages": ("src/repro_torch/csrc/cxl_line.cu", "src/repro/kernels/cxl_line.py:43"),
    "cxl_decode_pages": ("src/repro_torch/csrc/cxl_line.cu", "src/repro/kernels/cxl_line.py:70"),
    # The decode step's glue: no Pallas kernel (XLA fuses these ops in the
    # reference's jitted step).
    "rmsnorm": ("src/repro_torch/csrc/decode_glue.cu", "none"),
    "qkv_epilogue": ("src/repro_torch/csrc/decode_glue.cu", "none"),
    "silu_mul": ("src/repro_torch/csrc/decode_glue.cu", "none"),
}
# The tiered decode step's glue kernels (``kernels/decode_glue.py``): each is
# held to its plain version within one bf16 ulp at the step shapes of every
# engine the smoke drives (phases 2b, 2c, 2g, 3 and 6), and timed at those of
# the four timed engines (phase 5).
GLUE_KERNELS = ("rmsnorm", "qkv_epilogue", "silu_mul")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int = 20, flush_bytes: int = 128 << 20) -> float:
    """Median device time of ``fn`` (CUDA events around each call, the L2
    flushed by a 128 MB write between calls, after 3 warm-up calls). The
    stream is held back by a spin of ~1 ms (``torch.cuda._sleep``) before
    the first event, so the host has queued the call before the device
    reaches it: a wrapper's host overhead is not counted unless it outlasts
    the spin (as a plain version's chain of small operations can)."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    return smi


# ---------------------------------------------------------------- phase 2
def _dequant_err(pk, sk, pp, sp, bits) -> float:
    return float((ref.dequant_kv_page(pk, sk, bits) - ref.dequant_kv_page(pp, sp, bits))
                 .abs().max())


def check_quant(pages: torch.Tensor, bits: int) -> float:
    pk, sk = quant_page.quant_pages(pages, bits)
    pp, sp = ref.quant_kv_page(pages, bits)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        fail(f"quant_pages int{bits}: payload differs from the plain version in "
             f"{int((pk != pp).sum())} bytes")
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)
    return _dequant_err(pk, sk, pp, sp, bits)


def check_transcode(pay, sc, src, dst) -> float:
    pk, sk = transcode_page.transcode_pages(pay, sc, src, dst)
    pp, sp = ref.transcode_kv_page(pay, sc, src, dst)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        fail(f"transcode_pages {src}->{dst}: payload differs in {int((pk != pp).sum())} bytes")
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)
    return _dequant_err(pk, sk, pp, sp, dst)


def attention_operands(g: torch.Generator, b: int, h: int, kv: int, hd: int, mp: int,
                       t: int = T, r: int = R, n_valid=((40, 25, 12), (7, 60, 30)),
                       rlen=(R, 0)):
    """A mixed unified table at the engine's shapes: per sequence, warm
    (int8), cold (int4) and host columns of ``mp`` rows each, with valid
    prefixes ``n_valid`` (invalid tails past them) and ``rlen`` tokens in
    its ``r``-token recent window (by default one full, one empty)."""
    dev = DEV
    p8, p4, hs = 4 * mp, 4 * mp, 2 * mp

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    k8, s8k = ref.quant_kv_page(rn(p8, t, kv, hd), 8)
    v8, s8v = ref.quant_kv_page(rn(p8, t, kv, hd) * 0.5, 8)
    k4, s4k = ref.quant_kv_page(rn(p4, t, kv, hd), 4)
    v4, s4v = ref.quant_kv_page(rn(p4, t, kv, hd) * 0.5, 4)
    summary = rn(hs, kv, hd)
    q = rn(b, h, hd).to(torch.bfloat16)
    rk = rn(b, r, kv, hd).to(torch.bfloat16)
    rv = rn(b, r, kv, hd).to(torch.bfloat16)
    slots, tiers = [], []
    for nw, nc, nh in n_valid[:b]:
        row_s, row_t = [], []
        cols = ((nw, pa.TIER_INT8, p8), (nc, pa.TIER_INT4, p4), (nh, pa.TIER_HOST, hs))
        for n, code, rows in cols:
            s = torch.randint(0, rows, (mp,), generator=g, device=dev, dtype=torch.int32)
            tier = torch.full((mp,), pa.TIER_INVALID, dtype=torch.int32, device=dev)
            tier[:n] = code
            row_s.append(s)
            row_t.append(tier)
        slots.append(torch.cat(row_s))
        tiers.append(torch.cat(row_t))
    rlen = torch.tensor(rlen[:b], dtype=torch.int32, device=dev)
    return (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv,
            torch.stack(slots).contiguous(), torch.stack(tiers).contiguous(), rlen, t)


def check_attention(operands) -> float:
    got = pa.fused_tiered_attention(*operands)
    again = pa.fused_tiered_attention(*operands)
    want = pa.fused_tiered_attention_plain(*operands)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, a2, w in zip(("out", "m", "l", "mass", "base"), got, again, want):
        if not torch.isfinite(a).all():
            fail(f"fused_tiered_attention: non-finite {name}")
        if not torch.equal(a, a2):
            fail(f"fused_tiered_attention: two launches on the same inputs differ in {name}")
        torch.testing.assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL, msg=lambda m: f"{name}: {m}")
        err = max(err, float((a - w).abs().max()))
    return err


def check_dequant(pay, sc, bits, out_dtype) -> float:
    got = dequant_page.dequant_pages(pay, sc, bits, out_dtype)
    want = dequant_page.dequant_pages_plain(pay, sc, bits, out_dtype)
    torch.cuda.synchronize()
    if got.dtype != out_dtype or not torch.equal(got, want):
        fail(f"dequant_pages int{bits} -> {out_dtype}: differs from the plain version in "
             f"{int((got != want).sum())} elements")
    return float((got.float() - want.float()).abs().max())


def check_paged(args) -> float:
    got = pa.paged_quant_attention(*args)
    again = pa.paged_quant_attention_launch(*args)
    want = ref.paged_quant_attention(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, a2, w in zip(("out", "m", "l", "mass", "base"), got, again, want):
        if not torch.isfinite(a).all():
            fail(f"paged_quant_attention: non-finite {name}")
        if not torch.equal(a, a2):
            fail(f"paged_quant_attention: two launches on the same inputs differ in {name}")
        torch.testing.assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL, msg=lambda m: f"{name}: {m}")
        err = max(err, float((a - w).abs().max()))
    return err


def pool_operands(g, b, h, kv, hd, mp, bits, n_valid):
    """One pool of 4*mp rows at the engine's page shape, a random table and
    the valid prefix lengths ``n_valid`` (tails past them stay in the table)."""
    def rn(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    rows = 4 * mp
    kp, ks = ref.quant_kv_page(rn(rows, T, kv, hd), bits)
    vp, vs = ref.quant_kv_page(rn(rows, T, kv, hd) * 0.5, bits)
    q = rn(b, h, hd).to(torch.bfloat16)
    table = torch.randint(0, rows, (b, mp), generator=g, device=DEV, dtype=torch.int32)
    n = torch.tensor(n_valid, dtype=torch.int32, device=DEV)
    return (q, kp, ks, vp, vs, table, n, bits)


def check_cxl_encode(pages: torch.Tensor) -> float:
    """cxl_encode_pages vs its plain version and vs quant_pages(., 8): the
    payload, scales and line widths byte-equal."""
    pk, sk, bk = cxl_line.cxl_encode_pages(pages)
    pp, sp, bp = ref.cxl_encode_kv_page(pages)
    qp, qs = quant_page.quant_pages(pages, 8)
    torch.cuda.synchronize()
    for what, a, b in (("payload", pk, pp), ("scales", sk, sp), ("line widths", bk, bp),
                       ("payload vs quant_pages", pk, qp), ("scales vs quant_pages", sk, qs)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"cxl_encode_pages {tuple(pages.shape)}: {what} differ in "
                 f"{int((a != b).sum())} elements")
    return _dequant_err(pk, sk, pp, sp, 8)


def check_cxl_decode(pay, sc) -> float:
    got = cxl_line.cxl_decode_pages(pay, sc)
    want = ref.cxl_decode_kv_page(pay, sc)
    deq = dequant_page.dequant_pages(pay, sc, 8, torch.float32)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or not torch.equal(got, want) or not torch.equal(got, deq):
        fail(f"cxl_decode_pages: differs from the plain version in {int((got != want).sum())} "
             f"and from dequant_pages in {int((got != deq).sum())} elements")
    return float((got - want).abs().max())


def phase_compare(cfg) -> dict:
    g = torch.Generator(device=DEV).manual_seed(SEED)
    kv, hd, h = cfg.n_kv_heads, cfg.head_dim_(), cfg.n_heads
    la = _attn_layer_count(cfg)
    errs = {}
    # Page-out of a 512-token prompt: K and V of every attention layer x 31
    # pages; the expander's encode of the same pages.
    pages = torch.randn((2 * la * 31, T, kv, hd), generator=g, device=DEV)
    errs["quant_pages"] = max(check_quant(pages, 8), check_quant(pages, 4))
    errs["cxl_encode_pages"] = max(check_cxl_encode(pages),
                                   check_cxl_encode(pages.to(torch.bfloat16)))
    # A migration cohort: K and V of every attention layer x 8 pages, both
    # directions; the same cohort's host sentinels (f32) and per-page
    # fetches (bf16), and its reads from the expander.
    e = d = 0.0
    for src, dst in ((8, 4), (4, 8)):
        pay, sc = ref.quant_kv_page(pages[: 2 * la * 8], src)
        e = max(e, check_transcode(pay, sc, src, dst))
        for out_dtype in (torch.float32, torch.bfloat16):
            d = max(d, check_dequant(pay, sc, src, out_dtype))
        if src == 8:
            errs["cxl_decode_pages"] = check_cxl_decode(pay, sc)
    errs["transcode_pages"] = e
    errs["dequant_pages"] = d
    del pages
    mp = 1024 // T  # the engine's max pages per sequence
    errs["fused_tiered_attention"] = check_attention(attention_operands(g, 2, h, kv, hd, mp))
    # Per-pool partials: int8 and int4 pools with tails past n_pages, and an
    # empty pool (m = l = 0).
    errs["paged_quant_attention"] = max(
        check_paged(pool_operands(g, 2, h, kv, hd, mp, 8, [40, 7])),
        check_paged(pool_operands(g, 2, h, kv, hd, mp, 4, [60, 25])),
        check_paged(pool_operands(g, 2, h, kv, hd, mp, 8, [0, 0])),
    )
    log(f"phase 2 ok ({cfg.name}, page [., {T}, {kv}, {hd}], H={h}): kernels match their "
        f"plain versions, max abs err {errs}")
    return errs


# ---------------------------------------------------------------- phase 3-4
class Spy:
    """Wraps an ops dispatch function: counts the calls the cache makes
    (for ``transcode_pages`` only those that change the codec width, the
    ones that launch) and records the largest operand shape, so phase 5
    times each kernel at the serving path's own shapes. Keeps no tensor."""

    def __init__(self, fn, launches=lambda args: True, key=lambda args: None):
        self.fn = fn
        self.launches = launches
        self.key = key
        self.calls = 0
        self.dtypes = set()  # of the operands of the launching calls
        self.largest_by = {}  # key(args) -> (numel, shape, dtype, other args)

    @property
    def largest(self):
        return max(self.largest_by.values(), key=lambda c: c[0], default=None)

    def __call__(self, x, *args):
        if self.launches(args):
            self.calls += 1
            self.dtypes.add(x.dtype)
        k = self.key(args)
        if k not in self.largest_by or x.numel() > self.largest_by[k][0]:
            self.largest_by[k] = (x.numel(), tuple(x.shape), x.dtype, args)
        return self.fn(x, *args)


SPIED = ("quant_pages", "transcode_pages", "dequant_pages", "cxl_decode_pages")


def install_spies() -> dict:
    spies = {"quant_pages": Spy(ops.quant_pages),
             "transcode_pages": Spy(ops.transcode_pages, lambda a: a[1] != a[2]),
             "dequant_pages": Spy(ops.dequant_pages, key=lambda a: a[1]),  # by bits
             "cxl_decode_pages": Spy(ops.cxl_decode_pages)}
    for name, spy in spies.items():
        setattr(ops, name, spy)
    return spies


def remove_spies(spies) -> None:
    for name, spy in spies.items():
        setattr(ops, name, spy.fn)


def reset_counts(spies) -> None:
    build.reset_launch_counts()
    for spy in spies.values():
        spy.calls = 0


def read_counts(spies) -> dict:
    out = build.launch_counts()
    out.update({f"{n}_calls": spies[n].calls for n in SPIED})
    return out


def _add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def step_tokens(eng: TieredEngine) -> torch.Tensor:
    tokens = torch.zeros((eng.bs, 1), dtype=torch.int64, device=DEV)
    for i, req in enumerate(eng.slots):
        if req is not None and req.out_tokens:
            tokens[i, 0] = req.out_tokens[-1]
    return tokens


def _compare_steps(lk, lp, hk, hp, what: str) -> dict:
    """Logits: the bf16 activations round the attention output, so one
    f32-ulp difference can flip a bf16 rounding and compound over 40 layers;
    the bar is 2% of the logits' largest magnitude. Hotness (normalized
    per-page mass) is held to 2e-4."""
    lk, lp = lk.float(), lp.float()
    if not torch.isfinite(lk).all():
        fail(f"{what}: logits are not finite")
    scale = float(lp.abs().max())
    dl = float((lk - lp).abs().max())
    if dl > 0.02 * scale:
        fail(f"{what}: logits differ by {dl} (> 2% of {scale})")
    dh = {}
    for name in ("warm", "cold", "host"):
        torch.testing.assert_close(hk[name], hp[name], rtol=ATTN_TOL, atol=ATTN_TOL,
                                   msg=lambda m: f"{what} hotness[{name}]: {m}")
        dh[name] = float((hk[name] - hp[name]).abs().max())
    same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    log(f"phase 4 ok: {what}: logits max diff {dl:.4g} (max |logit| {scale:.4g}), "
        f"greedy tokens equal {same}, hotness max diff {dh}")
    return {"logits_max_diff": dl, "hotness_max_diff": dh, "greedy_equal": same}


def step_compare(eng: TieredEngine) -> dict:
    """One decode step on the engine's live state (the hybrid's SSM side
    state included): the eager step on the card against the same step built
    on the CPU and run on CPU copies of the params and the state, where every
    wrapper runs its plain version. The copies are freed after."""
    tokens, st = step_tokens(eng), eng.cache.state
    step = serve.make_tiered_decode_step(eng.model, eng.ts, device=DEV)
    lk, _, _, hk = step(eng.params, tokens, st, eng.ssm_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = serve.make_tiered_decode_step(Model(eng.cfg, eng.model.parallel, device="cpu"),
                                          eng.ts, device="cpu")
    params = pytree.tree_map(lambda t: t.cpu(), eng.params)
    on_cpu = dataclasses.replace(st, **{f.name: getattr(st, f.name).cpu()
                                        for f in dataclasses.fields(st)})
    extra = None if eng.ssm_state is None else tuple(x.cpu() for x in eng.ssm_state)
    lp, _, _, hp = plain(params, tokens.cpu(), on_cpu, extra)
    del params, on_cpu, extra
    out = _compare_steps(lk.cpu(), lp, {k: v.cpu() for k, v in hk.items()}, hp,
                         f"{eng.cfg.name} step on the card vs on the CPU")
    out["cpu_step_s"] = time.perf_counter() - t0
    return out


def per_pool_compare(eng: TieredEngine) -> dict:
    """The per-pool step (``use_fused(False)``: one ``paged_quant_attention``
    launch per pool and layer) vs the fused step on the same state."""
    tokens, st = step_tokens(eng), eng.cache.state
    step = serve.make_tiered_decode_step(eng.model, eng.ts, device=DEV)
    lf, _, _, hf = step(eng.params, tokens, st, eng.ssm_state)
    before = build.launch_counts()
    try:
        ops.use_fused(False)
        lpp, _, _, hpp = step(eng.params, tokens, st, eng.ssm_state)
        torch.cuda.synchronize()
    finally:
        ops.use_fused(True)
    launched = {k: v - before[k] for k, v in build.launch_counts().items()}
    if launched["paged_quant_attention"] != 2 * eng.la or launched["fused_tiered_attention"]:
        fail(f"per-pool step launched {launched}, expected 2 x {eng.la} paged_quant_attention")
    out = _compare_steps(lpp, lf, hpp, hf, f"{eng.cfg.name} per-pool step vs fused step")
    out["launches"] = launched["paged_quant_attention"]
    return out


def graph_compare(eng: TieredEngine) -> dict:
    """Phase 4b: the engine's captured step (a replay, no new capture) on
    its live mid-run state against the eager kernel step on a copy of the
    same state (the operands the step replaces are cloned; the class
    buffers and host summary, which it only reads, are shared): logits,
    telemetry and the new state byte-equal. Where an output is not, it is
    named and the step is held to phase 4's bars; the tables and lengths
    must be equal."""
    what = f"{eng.cfg.name} captured step vs eager kernel step"
    graphed = eng._step_fn
    if not isinstance(graphed, GraphedStep):
        fail(f"{eng.cfg.name}: the engine's step is {type(graphed).__name__}, not the captured one")
    tokens, st = step_tokens(eng), eng.cache.state
    copy = dataclasses.replace(st, **{f: getattr(st, f).clone() for f in COPIED_FIELDS})
    extra = None if eng.ssm_state is None else tuple(x.clone() for x in eng.ssm_state)
    eager = serve.make_tiered_decode_step(eng.model, eng.ts, device=DEV)
    captures = dict(graphed.captures)
    lg, tg, eg, hg = graphed(eng.params, tokens, st, eng.ssm_state)
    lw, tw, ew, hw = eager(eng.params, tokens, copy, extra)
    torch.cuda.synchronize()
    if graphed.captures != captures:
        fail(f"{what}: the compare captured again ({captures} -> {graphed.captures})")
    pairs = {"logits": (lg, lw), **{f"hotness_{k}": (hg[k], hw[k]) for k in hw},
             **{f: (getattr(tg, f), getattr(tw, f)) for f in COPIED_FIELDS},
             **{f"ssm_{i}": ab for i, ab in enumerate(zip(eg or (), ew or ()))}}
    differ = {n: float((a.float() - b.float()).abs().max()) for n, (a, b) in pairs.items()
              if not torch.equal(a, b)}
    out = {"byte_equal": not differ, "differ": differ, "captures": captures,
           "replays": graphed.replays}
    if differ:
        exact = set(differ) & {"recent_len", "total_len", "warm_table", "warm_n", "cold_table",
                               "cold_n", "host_table", "host_n"}
        if exact:
            fail(f"{what}: {sorted(exact)} differ")
        out["bars"] = _compare_steps(lg, lw, hg, hw, what)
    log(f"phase 4b ok: {what}: byte-equal {not differ}"
        + (f", differing outputs {differ}" if differ else "")
        + f"; captures {captures}, replays {graphed.replays}")
    return out


def graph_tokens(cfg, model, params, host_media_device: str = "") -> dict:
    """Phase 4b's token run: GRAPH_STEPS steps of two GRAPH_PROMPTS-token
    requests on the default path (async + prefetch at ASYNC_ALPHA, 16-step
    windows), from one start, through the captured engine and again with
    the eager kernel step swapped in. Greedy tokens must be equal; each run
    must page out, cross two window boundaries and migrate; the captured
    engine captures once. Reports both runs' decode ms/step (host clock, the
    telemetry copy included) in this call, one after the other."""
    runs = {}
    for name in ("captured", "eager"):
        free_device()
        ts = TierScapeRunConfig(enabled=True, alpha=ASYNC_ALPHA, window_steps=16,
                                async_migration=True, prefetch=True, faults=False,
                                host_media_device=host_media_device)
        eng = TieredEngine(model, params, batch_slots=2, page_tokens=T,
                           max_seq_len=GRAPH_MAX_SEQ, recent_window=R, ts=ts, device=DEV)
        if name == "eager":
            eng._step_fn = serve.make_tiered_decode_step(model, ts, device=DEV)
        rng = np.random.default_rng(SEED + 16)
        reqs = [eng.submit(rng.integers(1, cfg.vocab_size, n), max_new_tokens=GRAPH_STEPS + 1)
                for n in GRAPH_PROMPTS]
        eng._fill_slots()
        quant0 = build.launch_counts()["quant_pages"]
        torch.cuda.synchronize()
        for _ in range(GRAPH_STEPS):
            eng.step()
        torch.cuda.synchronize()
        page_outs = build.launch_counts()["quant_pages"] - quant0
        stats = eng.finish()
        runs[name] = {"tokens": [r.out_tokens for r in reqs], "windows": stats.windows,
                      "migrations": stats.migrations, "page_out_launches": page_outs,
                      "decode_ms_per_step": stats.decode_s / stats.steps * 1e3,
                      "captures": dict(getattr(eng._step_fn, "captures", {})),
                      "capture_s": getattr(eng._step_fn, "capture_s", 0.0)}
        if stats.windows < 2 or stats.migrations < 1 or page_outs < 1:
            fail(f"{cfg.name} {name} token run: {stats.windows} windows, {stats.migrations} "
                 f"migrations, {page_outs} page-out launches; expected >= 2, >= 1, >= 1")
        del eng, reqs
    free_device()
    what = f"{cfg.name} greedy tokens, captured vs eager over {GRAPH_STEPS} steps"
    if runs["captured"]["tokens"] != runs["eager"]["tokens"]:
        fail(f"{what}: differ: {runs['captured']['tokens']} vs {runs['eager']['tokens']}")
    if runs["captured"]["captures"] != {"fused": 1}:
        fail(f"{what}: captures {runs['captured']['captures']}, expected one")
    out = {k: {f: v for f, v in r.items() if f != "tokens"} for k, r in runs.items()}
    out["tokens_equal"] = True
    out["first_tokens"] = [t[:8] for t in runs["captured"]["tokens"]]
    log(f"phase 4b ok: {what}: equal; {json.dumps(out)}")
    return out


def submit_requests(eng: TieredEngine, cfg) -> list:
    rng = np.random.default_rng(SEED)
    return [eng.submit(rng.integers(1, cfg.vocab_size, int(n)), max_new_tokens=NEW_TOKENS)
            for n in rng.integers(*PROMPTS[cfg.name], 3)]


def engine_metrics(stats, reqs, wall, peak, steps=None, decode_s=None) -> dict:
    steps = stats.steps if steps is None else steps
    decode_s = stats.decode_s if decode_s is None else decode_s
    gen = sum(len(r.out_tokens) for r in reqs)
    return {
        "decode_steps": steps,
        "windows": stats.windows,
        "migrations": stats.migrations,
        "overlapped_steps": stats.overlapped_steps,
        "prefetch_staged": stats.prefetch_staged,
        "prefetch_hits": stats.prefetch_hits,
        "prefetch_misses": stats.prefetch_misses,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "prefill_ms_per_request": stats.prefill_s / len(reqs) * 1e3,
        "window_ms_per_boundary": stats.window_s / max(stats.windows, 1) * 1e3,
        "tokens_per_s": gen / wall,
        "wall_s": wall,
        "generated_tokens": gen,
        "peak_memory_bytes": peak,
        "tco_savings_pct": stats.tco_savings_pct,
        "prompt_lens": [len(r.prompt) for r in reqs],
    }


def check_bf16_page_out(spies, what: str) -> None:
    """The engine hands its page-outs to ``quant_pages`` in the KV cache's
    own bf16 (the kernel's upcast is exact; an f32 copy would double the
    bytes it reads)."""
    if spies["quant_pages"].dtypes != {torch.bfloat16}:
        fail(f"{what}: page-outs reached quant_pages as {spies['quant_pages'].dtypes}, "
             "expected bf16 only")


def check_counts(counts: dict, what: str) -> None:
    """No plain version ran on the path: every cache call of a kernel's
    dispatch launched the kernel."""
    for n in SPIED:
        if counts[n] != counts[f"{n}_calls"]:
            fail(f"{what}: {n} launched {counts[n]} times for {counts[f'{n}_calls']} calls")


def phase_serial(cfg, model, params, alpha: float = 0.5, compare: bool = True):
    """The serial path: blocking migration, prefetch off (at alpha 0.5, and
    again at the async run's alpha, to compare the modes)."""
    ts = TierScapeRunConfig(enabled=True, alpha=alpha, window_steps=16, async_migration=False,
                            prefetch=False, faults=False)
    torch.cuda.reset_peak_memory_stats()
    eng = TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                       recent_window=R, ts=ts, device=DEV)
    reqs = submit_requests(eng, cfg)
    spies = install_spies()
    reset_counts(spies)
    t0 = time.perf_counter()
    eng.run(max_steps=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(spies)
    step = step_compare(eng) if compare else None
    reset_counts(spies)
    t0 = time.perf_counter()
    stats = eng.run()
    forced = False
    if counts["transcode_pages"] + build.launch_counts()["transcode_pages"] == 0:
        forced = force_migration(eng)
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    counts = _add(counts, read_counts(spies))
    peak = torch.cuda.max_memory_allocated()
    remove_spies(spies)

    if stats.completed != 3 or not all(r.done and len(r.out_tokens) == NEW_TOKENS
                                       for r in reqs):
        fail(f"serial: not every request completed: {stats.completed}/3")
    if counts["fused_tiered_attention"] != cfg.n_layers * stats.steps:
        fail(f"serial: fused_tiered_attention launched {counts['fused_tiered_attention']} "
             f"times, expected {cfg.n_layers} x {stats.steps} decode steps")
    if counts["quant_pages"] < 1 or counts["transcode_pages"] < 1:
        fail(f"serial: page-out/migration kernels not on the path: {counts}")
    if not forced:
        check_counts(counts, "serial")
    check_bf16_page_out(spies, "serial")
    if stats.attn_launches != counts["fused_tiered_attention"]:
        fail(f"serial: billed attention launches {stats.attn_launches} != counted {counts}")
    metrics = engine_metrics(stats, reqs, wall, peak)
    metrics["forced_migration"] = forced
    metrics["alpha"] = alpha
    log(f"phase 3 ok (serial, alpha {alpha}): {json.dumps(metrics)}; launches {counts}")
    return metrics, counts, step


class PageEncoder:
    """Wraps a cache's ``append_pages``: every page-out's layer-0 K and V
    pages (bf16, the KV cache's own type, as the engine hands them over) go
    through ``cxl_encode_pages`` as the expander would store them, before
    the cache takes them. No engine path calls the encode kernel; this is
    where the run gives it real pages. Keeps the first page-out's pages (the
    first prefill's) for the checks and timings, and the line widths of all
    of them."""

    def __init__(self, cache):
        self.fn = cache.append_pages
        self.first = None
        self.calls = 0
        self.line_bits = []
        cache.append_pages = self

    def __call__(self, entries, k, v):
        rows = torch.as_tensor([i for i, e in enumerate(entries) if e[0] == 0], device=k.device)
        if rows.numel():
            pages = torch.cat([k[rows], v[rows]])
            self.calls += 1
            _, _, bits = cxl_line.cxl_encode_pages(pages)
            self.line_bits.append(bits.reshape(-1))
            if self.first is None:
                self.first = pages
        return self.fn(entries, k, v)

    def line_ratio(self) -> float:
        return ref.cxl_page_line_ratio(torch.cat(self.line_bits))


def drive_host8(eng: TieredEngine) -> int:
    """The policy put no page on HOST8 so far: drain the pipeline and drive
    one blocking cohort of device pages there (their sentinel centroids read
    the expander's pages back through ``cxl_decode_pages``)."""
    cache = eng.cache
    cache.drain_migrations()
    dev = np.where(np.isin(cache.physical, (kvc.WARM, kvc.COLD)) & cache._page_exists)[0]
    # Spread over the layers, so every layer keeps device pages to attend.
    rids = np.unique(dev[np.linspace(0, dev.size - 1, min(HOST8_FORCED_PAGES, dev.size))
                         .astype(np.int64)]) if dev.size else dev
    moved = cache.migrate_batch(rids, np.full(rids.size, kvc.HOST8, np.int64))
    log(f"policy left HOST8 empty: drove migrate_batch on {rids.size} device pages to HOST8 "
        f"on {cache._dev_names[kvc.HOST8]} ({moved} page moves)")
    return moved


def phase_async(cfg, model, params, host_media_device: str = "", phase: str = "3"):
    """The default path: async migration + prefetch, the host tiers on
    ``host_media_device`` (host DRAM if empty). Counts are reset before and
    read after each part of the run; the mid-run compares are not counted,
    and the per-pool steps are a path of their own. On ``cxl_hw`` the run
    must read HOST8 pages through ``cxl_decode_pages`` (a cohort is driven
    there if the policy leaves HOST8 empty), and every page-out's layer-0
    K/V pages go through ``cxl_encode_pages`` (``PageEncoder``)."""
    ts = TierScapeRunConfig(enabled=True, alpha=ASYNC_ALPHA, window_steps=16,
                            async_migration=True, prefetch=True, faults=False,
                            host_media_device=host_media_device)
    cxl = host_media_device == "cxl_hw"
    full = get(cfg.name).n_layers
    what = (f"{cfg.name} async" + (f" at {cfg.n_layers} of {full} layers" if cfg.n_layers != full
                                   else "") + (" on cxl_hw" if cxl else ""))
    log(f"phase {phase} ({what}): alpha {ts.alpha}, async_migration {ts.async_migration}, "
        f"prefetch {ts.prefetch}")
    tokens_run = graph_tokens(cfg, model, params, host_media_device)
    torch.cuda.reset_peak_memory_stats()
    eng = TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                       recent_window=R, ts=ts, device=DEV)
    encoder = PageEncoder(eng.cache) if cxl else None
    reqs = submit_requests(eng, cfg)
    spies = install_spies()
    reset_counts(spies)
    t0 = time.perf_counter()
    eng.run(max_steps=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # The forced HOST8 cohort (if any) is counted with the run's launches but
    # timed apart from its wall time: it is a blocking call made by hand.
    forced, host8_ms = 0, None
    if cxl and spies["cxl_decode_pages"].calls == 0:
        t0 = time.perf_counter()
        forced = drive_host8(eng)
        torch.cuda.synchronize()
        host8_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(spies)

    compares = {"kernel_vs_plain": step_compare(eng), "per_pool_vs_fused": per_pool_compare(eng),
                "captured_vs_eager": graph_compare(eng)}
    # Phase 5 times the attention kernels on this mid-run state: keep its
    # tables and recent window (the class buffers are shared and stay valid).
    st = eng.cache.state
    state = dataclasses.replace(st, **{
        f: getattr(st, f).clone() for f in (
            "warm_table", "warm_n", "cold_table", "cold_n", "host_table", "host_n",
            "recent_k", "recent_v", "recent_len")})

    # The per-pool path, driven through the engine.
    d0, tok0 = eng.stats.decode_s, sum(len(r.out_tokens) for r in reqs)
    reset_counts(spies)
    t0 = time.perf_counter()
    try:
        ops.use_fused(False)
        for _ in range(PER_POOL_STEPS):
            eng._fill_slots()
            eng.step()
        torch.cuda.synchronize()
    finally:
        ops.use_fused(True)
    pp_wall = time.perf_counter() - t0
    pp_counts = read_counts(spies)
    pp_decode = eng.stats.decode_s - d0
    pp_tokens = sum(len(r.out_tokens) for r in reqs) - tok0
    if (pp_counts["paged_quant_attention"] != 2 * eng.la * PER_POOL_STEPS
            or pp_counts["fused_tiered_attention"]):
        fail(f"{what}: per-pool path launched {pp_counts}, expected 2 x {eng.la} x "
             f"{PER_POOL_STEPS} paged_quant_attention and no fused launch")

    reset_counts(spies)
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    counts = _add(counts, read_counts(spies))
    peak = torch.cuda.max_memory_allocated()
    remove_spies(spies)

    main_steps = stats.steps - PER_POOL_STEPS
    ring = eng.cache.staging_ring
    if stats.completed != 3 or not all(r.done and len(r.out_tokens) == NEW_TOKENS
                                       for r in reqs):
        fail(f"{what}: not every request completed: {stats.completed}/3")
    # Every staged page met a boundary (hit or miss) or was invalidated
    # while held (a request finished mid-window and freed its pages).
    invalidated = eng.cache.pipeline.prefetch_invalidated
    if stats.prefetch_staged != stats.prefetch_hits + stats.prefetch_misses + invalidated:
        fail(f"{what}: prefetch staged {stats.prefetch_staged}, hits {stats.prefetch_hits}, "
             f"misses {stats.prefetch_misses}, invalidated {invalidated} (alpha {ts.alpha})")
    if stats.overlapped_steps <= 0 or stats.prefetch_staged <= 0:
        fail(f"{what}: overlapped steps {stats.overlapped_steps}, prefetch staged "
             f"{stats.prefetch_staged}: the async path or prefetch did not run")
    if ring.held_slots or ring.free_slots != ring.n_slots:
        fail(f"{what}: {ring.held_slots} ring credits left held")
    if counts["fused_tiered_attention"] != eng.la * main_steps:
        fail(f"{what}: fused_tiered_attention launched {counts['fused_tiered_attention']} "
             f"times, expected {eng.la} x {main_steps} decode steps")
    if any(counts[n] < 1 for n in ("quant_pages", "transcode_pages", "dequant_pages")):
        fail(f"{what}: page-out/migration/dequant kernels not on the path: {counts}")
    if cxl:
        counts["cxl_encode_pages_calls"] = encoder.calls
        if counts["cxl_decode_pages"] < 1 or encoder.calls < 1:
            fail(f"{what}: no HOST8 page was read through cxl_decode_pages or no page-out was "
                 f"encoded: {counts}")
        encoded = counts["cxl_encode_pages"] + pp_counts["cxl_encode_pages"]
        if encoded != encoder.calls:
            fail(f"{what}: cxl_encode_pages launched {encoded} times for {encoder.calls} "
                 "page-outs")
    check_counts(counts, what)
    check_bf16_page_out(spies, what)
    if eng._step_fn.captures != {"fused": 1, "per_pool": 1}:
        fail(f"{what}: captures {eng._step_fn.captures}, expected one per route")
    if stats.attn_launches != counts["fused_tiered_attention"] + pp_counts["paged_quant_attention"]:
        fail(f"{what}: billed attention launches {stats.attn_launches} != counted "
             f"{counts} + {pp_counts}")
    metrics = engine_metrics(stats, reqs, wall, peak, steps=main_steps,
                             decode_s=stats.decode_s - pp_decode)
    metrics["generated_tokens"] -= pp_tokens
    metrics["tokens_per_s"] = metrics["generated_tokens"] / wall
    metrics["alpha"] = ts.alpha
    metrics["layers"] = cfg.n_layers
    metrics["prefetch_invalidated"] = invalidated
    metrics["captures"] = dict(eng._step_fn.captures)
    metrics["replays"] = eng._step_fn.replays
    metrics["capture_s"] = eng._step_fn.capture_s  # inside decode_ms_per_step's sum
    metrics["graph_tokens"] = tokens_run
    metrics["per_pool"] = {"steps": PER_POOL_STEPS, "decode_ms_per_step":
                           pp_decode / PER_POOL_STEPS * 1e3, "wall_s": pp_wall}
    if cxl:
        metrics["host8_forced_pages"] = forced
        metrics["host8_cohort_ms"] = host8_ms  # not in wall_s / tokens_per_s
        metrics["cxl_hw_device_ratio"] = eng.cache.media_queues["cxl_hw"].device.ratio
        metrics["page_out_line_ratio"] = encoder.line_ratio()
    log(f"phase {phase} ok ({what}): {json.dumps(metrics)}; launches {counts}; "
        f"per-pool launches {pp_counts}")
    return eng, counts, pp_counts, metrics, spies, state, compares, encoder


def force_migration(eng: TieredEngine) -> bool:
    """The serial policy moved no page between codecs in this run: drive the
    cohort executor by hand, warm pages to the cold tier and back."""
    cache = eng.cache
    warm = np.where((cache.physical == kvc.WARM) & cache._page_exists)[0][:64]
    if warm.size == 0:
        for i in range(eng.bs):  # everything finished: serve one more request
            if eng.slots[i] is None:
                eng.submit(np.arange(1, 600) % eng.cfg.vocab_size, max_new_tokens=2)
        eng._fill_slots()
        warm = np.where((cache.physical == kvc.WARM) & cache._page_exists)[0][:64]
    moved = cache.migrate_batch(warm, np.full(warm.size, kvc.COLD, np.int64))
    moved += cache.migrate_batch(warm, np.full(warm.size, kvc.WARM, np.int64))
    log(f"policy planned no codec change: drove migrate_batch on {warm.size} warm pages "
        f"to the cold tier and back ({moved} page moves)")
    return True


def _tree_f32(tree):
    if isinstance(tree, dict):
        return {k: _tree_f32(v) for k, v in tree.items()}
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- phase 3b
def _mode_cache(cfg, **kw):
    return kvc.TieredKVCache(cfg, MODES_LAYERS, 2, T, 1024, R,
                             ManagerConfig(policy="analytical", alpha=kw.pop("alpha", 0.5)),
                             device=DEV, **kw)


def _fill(cache, seed: int, n_pages: int):
    g = torch.Generator(device=DEV).manual_seed(seed)
    coords = [(la, sl, pg) for la in range(cache.la) for sl in range(cache.bs)
              for pg in range(cache.max_pages)][:n_pages]
    shape = (len(coords), T, cache.cfg.n_kv_heads, cache.cfg.head_dim_())
    cache.append_pages(coords, torch.randn(shape, generator=g, device=DEV),
                       torch.randn(shape, generator=g, device=DEV))


def _same_state(a, b, what: str) -> None:
    """Bit-identical placements and payloads: physical and desired
    placement, every device page's class-buffer rows, every host page's
    bytes, the tables and the host sentinels."""
    if not (np.array_equal(a.physical, b.physical)
            and np.array_equal(a.manager.placement, b.manager.placement)):
        fail(f"{what}: placements differ in {int((a.physical != b.physical).sum())} pages")
    for level in (kvc.WARM, kvc.COLD):
        rids = np.where((a.physical == level) & a._page_exists)[0]
        if rids.size:
            pool = kvc._POOL[level]
            layers = rids // (a.bs * a.max_pages)
            for x, y in zip(a._gather_rows(pool, layers, a._pool_slot[rids]),
                            b._gather_rows(pool, layers, b._pool_slot[rids])):
                if not torch.equal(x, y):
                    fail(f"{what}: device payloads differ")
    if set(a.host_pages) != set(b.host_pages) or any(
            not np.array_equal(x, y) for r in a.host_pages
            for x, y in zip(a.host_pages[r], b.host_pages[r])):
        fail(f"{what}: host payloads differ")
    for f in ("warm_n", "cold_n", "host_n"):
        if not torch.equal(getattr(a.state, f), getattr(b.state, f)):
            fail(f"{what}: {f} differs")
    # Sentinel slots are allocated in execution order; the centroids per page
    # must agree.
    rids = np.array(sorted(a.host_pages), np.int64)
    if rids.size:
        layers = torch.as_tensor(rids // (a.bs * a.max_pages), device=DEV)
        if not torch.equal(a.state.host_summary[layers, torch.as_tensor(a._host_slot[rids],
                                                                        device=DEV)],
                           b.state.host_summary[layers, torch.as_tensor(b._host_slot[rids],
                                                                        device=DEV)]):
            fail(f"{what}: host sentinel centroids differ")


def _drive_windows(cache, windows: int, ticks: int = 8) -> None:
    for w in range(windows):
        counts = np.zeros(cache.n_regions)
        live = np.where(cache._page_exists)[0]
        counts[live[w % 4::4]] = 500.0
        cache.manager.record_access_counts(counts)
        for _ in range(ticks):
            if cache.pipeline.busy:
                cache.pipeline.tick()
            else:
                cache.prefetch_tick()
        cache.end_window()
        cache.drain_migrations()


def phase_modes(cfg) -> dict:
    """The executors agree on the card (reduced depth, full width), as
    tests/test_media.py, test_prefetch.py and test_faults.py hold them."""
    out = {}
    # (a) Random plans through the serial executor and the pipeline.
    serial, asyn = _mode_cache(cfg), _mode_cache(cfg, async_migration=True)
    for c in (serial, asyn):
        _fill(c, SEED, serial.n_regions * 3 // 4)
    rng = np.random.default_rng(SEED)
    moved = 0
    for _ in range(3):
        live = np.where(serial._page_exists)[0]
        rids = rng.choice(live, size=live.size // 2, replace=False)
        dsts = np.array([rng.choice([t for t in (kvc.WARM, kvc.COLD, kvc.HOST8, kvc.HOST4)
                                     if t != serial.physical[r]]) for r in rids], np.int64)
        moved += serial.migrate_batch(rids, dsts)
        asyn.pipeline.submit(asyn.plan_cohorts(rids, dsts))
        while asyn.pipeline.busy:
            asyn.pipeline.tick()
        _same_state(serial, asyn, "serial vs async")
    out["random_plans_pages_moved"] = moved
    del serial, asyn
    # (b) Prefetch on vs off: the host half warms up; staged pages are
    # claimed at the boundary and commit what the prefetch-free run commits.
    spec, oracle = (_mode_cache(cfg, async_migration=True, prefetch=p, warm_frac=1.0,
                                prefetch_max_pages=16) for p in (True, False))
    for c in (spec, oracle):
        _fill(c, SEED + 1, 32)
        live = np.where(c._page_exists)[0]
        device, host = live[:16], live[16:]
        c.migrate_batch(host, np.full(host.size, kvc.HOST4, np.int64))
    for hot_host in (0.0, 800.0):
        for c in (spec, oracle):
            counts = np.zeros(c.n_regions)
            counts[device] = 500.0
            counts[host] = hot_host
            c.manager.record_access_counts(counts)
            for _ in range(8):
                if c.pipeline.busy:
                    c.pipeline.tick()
                else:
                    c.prefetch_tick()
            c.end_window()
            c.drain_migrations()
    _same_state(spec, oracle, "prefetch on vs off")
    p = spec.pipeline
    if p.prefetch_hits <= 0:
        fail(f"prefetch staged {p.prefetch_staged} pages but none was claimed")
    out["prefetch"] = {"staged": p.prefetch_staged, "hits": p.prefetch_hits,
                       "misses": p.prefetch_misses}
    del spec, oracle
    # (c) A seeded storm plus recoverable faults on every window.
    plan = FaultPlan(FaultPlan.seeded_storm("host_dram_pcie", seed=1, windows=8).events + tuple(
        FaultEvent(k, d, 1, 99) for k in ("transient", "corrupt")
        for d in ("hbm", "host_dram_pcie")))
    runs = []
    for is_async in (False, True):
        c = _mode_cache(cfg, async_migration=is_async, ring_slots=8, fault_plan=plan, alpha=0.0)
        _fill(c, SEED + 2, 48)
        _drive_windows(c, 7)
        runs.append(c)
    if not np.array_equal(runs[0].physical, runs[1].physical):
        fail("storm: serial and async placements differ")
    if runs[0].fault_deferred_pages != runs[1].fault_deferred_pages:
        fail("storm: deferred moves differ between modes")
    p = runs[1].pipeline
    if p.corruptions_detected != p.corruptions_injected or runs[1].staging_ring.held_slots:
        fail("storm: an injected corruption was missed or a ring credit leaked")
    out["storm"] = {"retries": p.fault_retries, "corruptions_repaired": p.corruptions_repaired,
                    "deferred_pages": runs[1].fault_deferred_pages,
                    "pages_moved": p.pages_moved}
    log(f"phase 3b ok: serial and async executors agree at {MODES_LAYERS} layers: "
        f"{json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 5
def attention_work(operands) -> tuple:
    """Bytes and f32 operations the fused kernel needs for these inputs:
    valid pool pages' K/V payload + scales, host centroids, the filled part
    of the recent window, q, the tables and the outputs."""
    (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, rk, rv,
     slot, tier, rlen, t) = operands
    b, h, hd = q.shape
    kv = k8.shape[2]
    n8 = int((tier == pa.TIER_INT8).sum())
    n4 = int((tier == pa.TIER_INT4).sum())
    nh = int((tier == pa.TIER_HOST).sum())
    nr = int(rlen.sum())
    ms = slot.shape[1]
    page8 = 2 * (t * kv * hd + t * kv * 4)
    page4 = 2 * (t * kv * hd // 2 + t * kv * 4)
    n_bytes = (n8 * page8 + n4 * page4 + nh * kv * hd * 4 + nr * 2 * kv * hd * 2
               + q.numel() * q.element_size() + 2 * b * ms * 4 + b * 4
               + b * h * hd * 4 + 2 * b * h * 4 + 2 * b * ms * 4)
    n_ops = (n8 + n4) * (4 * h * t * hd + 2 * t * kv * hd) + nh * 2 * h * hd + nr * 4 * h * hd
    return n_bytes, n_ops


def paged_work(args) -> tuple:
    """Bytes and f32 operations one per-pool launch needs: the valid pages'
    K/V payload + scales, q, the table, n_pages and the partials."""
    q, kp, ks, vp, vs, table, n, bits = args
    b, h, hd = q.shape
    t, kv = kp.shape[1], kp.shape[2]
    valid = int(torch.minimum(n, torch.tensor(table.shape[1], device=n.device)).sum())
    page = 2 * (t * kv * (hd if bits == 8 else hd // 2) + t * kv * 4)
    mp = table.shape[1]
    n_bytes = (valid * page + q.numel() * q.element_size() + b * mp * 4 + b * 4
               + b * h * hd * 4 + 2 * b * h * 4 + 2 * b * mp * 4)
    return n_bytes, valid * (4 * h * t * hd + 2 * t * kv * hd)


def layer_pools(state, layer: int) -> tuple:
    lt = {f: getattr(state, f)[layer] for f in serve.LAYER_FIELDS}
    return lt, {
        "warm": {"k_pages": lt["c8_k"], "k_scales": lt["c8_k_scales"],
                 "v_pages": lt["c8_v"], "v_scales": lt["c8_v_scales"],
                 "page_table": lt["warm_table"], "n_pages": lt["warm_n"], "bits": 8},
        "cold": {"k_pages": lt["c4_k"], "k_scales": lt["c4_k_scales"],
                 "v_pages": lt["c4_v"], "v_scales": lt["c4_v_scales"],
                 "page_table": lt["cold_table"], "n_pages": lt["cold_n"], "bits": 4},
    }


def library_dequant(pay, sc, bits, out_dtype):
    """One PyTorch call computing the int8 payload x scale: ``torch.mul``
    into f32 by type promotion, or into a bf16 ``out`` (the f32 product
    rounded once, as the plain version's cast); int4 has none (None).
    Checked equal to the plain version here; timed, never used by the port."""
    if bits != 8:
        return None
    scales = sc[..., None]
    if out_dtype == torch.float32:
        def fn():
            return torch.mul(pay, scales)
    else:
        out = torch.empty(pay.shape, dtype=out_dtype, device=pay.device)

        def fn():
            return torch.mul(pay, scales, out=out)
    if not torch.equal(fn(), dequant_page.dequant_pages_plain(pay, sc, bits, out_dtype)):
        fail(f"torch.mul int8 -> {out_dtype}: differs from the plain dequant")
    return fn


def dequant_row(g, shape, bits, out_dtype, errs) -> tuple:
    """dequant_pages on a fresh payload of the run's ``shape``: checked,
    then timed beside its plain version and the library call."""
    hd = shape[-1] * (1 if bits == 8 else 2)
    pay, sc = ref.quant_kv_page(torch.randn(shape[:-1] + (hd,), generator=g, device=DEV), bits)
    errs["dequant_pages"] = max(errs["dequant_pages"], check_dequant(pay, sc, bits, out_dtype))
    elems = sc.numel() * hd
    db = bound_ms(pay.numel() + sc.numel() * 4 + elems * out_dtype.itemsize, elems)
    lib = library_dequant(pay, sc, bits, out_dtype)
    return ("dequant_pages",
            time_ms(lambda: dequant_page.dequant_pages(pay, sc, bits, out_dtype)),
            time_ms(lambda: dequant_page.dequant_pages_plain(pay, sc, bits, out_dtype)), db,
            lib and time_ms(lib), f"{tuple(pay.shape)} int{bits} -> {out_dtype}")


def bf16_ulps(got, want) -> float:
    """The largest distance of ``got`` from ``want`` (bf16 both) in units of
    the larger value's bf16 ulp (8 significant bits); 0 for no elements."""
    if not got.numel():
        return 0.0
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def glue_calls(eng, state) -> dict:
    """The glue kernels the engine's decode step runs, each as (args,
    kwargs) at its step shapes: layer 0's norm, QKV and FFN weights (the
    shared block's for the hybrid) on a random hidden state, the step's cos
    and sin (``serve.step_rope``) at the live lengths, and copies of layer
    0's live recent window with the live ``recent_len``."""
    cfg = eng.cfg
    if cfg.norm != "rmsnorm":
        return {}
    g = torch.Generator(device=DEV).manual_seed(SEED + 21)
    blk = (eng.params["shared"] if cfg.family == "hybrid"
           else layer_params(eng.params["blocks"], 0))
    x = (3 * torch.randn((eng.bs, 1, cfg.d_model), generator=g, device=DEV)).to(torch.bfloat16)
    calls = {"rmsnorm": ((blk["norm1"], x, cfg.norm_eps), {})}
    hn = decode_glue.rmsnorm_plain(blk["norm1"], x, cfg.norm_eps)
    p = blk["attn"]
    calls["qkv_epilogue"] = (
        (*attention.qkv_products(p, hn), *serve.step_rope(cfg, state.total_len, DEV),
         state.recent_k[0].clone(), state.recent_v[0].clone(), state.recent_len.clone()),
        {"bias": (p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else None,
         "qk_norm": (p["q_norm"], p["k_norm"]) if cfg.qk_norm else None, "eps": cfg.norm_eps})
    if cfg.family != "moe" and cfg.act == "swiglu":
        f = blk["ffn"]
        calls["silu_mul"] = ((torch.matmul(hn, f["w_gate"]), torch.matmul(hn, f["w_up"])), {})
    return calls


def check_glue(eng, state) -> dict:
    """Each glue kernel the step runs against its plain version at the
    engine's step shapes (``glue_calls``): within one bf16 ulp (q, the
    normed rows, SiLU * up, and the k and v rows the epilogue writes), and
    every other row of the recent windows byte-equal, nothing written for a
    slot whose row is at or beyond the window. Returns the ulps."""
    ulps = {}
    for name, (args, kw) in glue_calls(eng, state).items():
        kern, plain = getattr(decode_glue, name), getattr(decode_glue, f"{name}_plain")
        if name == "qkv_epilogue":
            *qkv, rk, rv, rlen = args
            wk, wp = [w.clone() for w in (rk, rv)], [w.clone() for w in (rk, rv)]
            pairs = [(kern(*qkv, *wk, rlen, **kw), plain(*qkv, *wp, rlen, **kw))]
            row = torch.arange(rk.shape[1], device=DEV)[None] == rlen[:, None].long()
            for a, b, old in zip(wk, wp, (rk, rv)):
                if not torch.equal(a[~row], old[~row]):
                    fail(f"{eng.cfg.name}: qkv_epilogue changed a window row other than "
                         f"recent_len {rlen.tolist()}")
                pairs.append((a[row], b[row]))
        else:
            pairs = [(kern(*args, **kw), plain(*args, **kw))]
        ulps[name] = max(bf16_ulps(a, b) for a, b in pairs)
        if ulps[name] > 1.0:
            fail(f"{eng.cfg.name}: {name} is {ulps[name]} bf16 ulps from its plain version")
    log(f"glue kernels ok ({eng.cfg.name}, B={eng.bs}): within one bf16 ulp of their plain "
        f"versions, ulps {ulps}")
    return ulps


def glue_work(name, args, kw) -> tuple:
    """The bytes a glue kernel's call moves and the operations it makes, at
    least: its operands read once, its outputs written once."""
    if name == "rmsnorm":
        w, x, _ = args
        return 2 * x.numel() * x.element_size() + w.numel() * 4, 4 * x.numel()
    if name == "silu_mul":
        gate, _ = args
        return 3 * gate.numel() * gate.element_size(), 5 * gate.numel()
    q, k, v, cos, sin, rk, _, rlen = args
    rows = int((rlen < rk.shape[1]).sum())  # slots whose k and v land in the window
    params = [t for group in (kw["bias"], kw["qk_norm"]) if group for t in group]
    n_in = q.numel() + k.numel() + v.numel()
    n_out = q.numel() + rows * (k[0].numel() + v[0].numel())
    return ((n_in + n_out) * q.element_size() + (cos.numel() + sin.numel()) * 4
            + rlen.numel() * 4 + sum(t.numel() * t.element_size() for t in params),
            3 * n_in)


def phase_times(eng, counts, pp_counts, spies, state, errs, encoder=None) -> list:
    """Each kernel held to its plain version again and timed at the shapes
    the run gave it (the cxl codec's two as well when ``encoder`` holds the
    run's page-outs); ``quant_pages`` also on f32 pages of the same shape
    (the page-out as the engine handed it over when it upcast the cache),
    and an empty launch as the floor of every row."""
    rows, extra = [], {}
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    floor = time_ms(lambda: quant_page.empty_launch(DEV))
    log(f"  empty launch (the floor): {floor:.4f} ms")
    # quant_pages at the largest page-out batch of the run.
    _, shape, dtype, (bits,) = spies["quant_pages"].largest
    pages = torch.randn(shape, generator=g, device=DEV).to(dtype)
    errs["quant_pages"] = max(errs["quant_pages"], check_quant(pages, bits))
    n = pages.numel()
    out_b = n if bits == 8 else n // 2
    qb = bound_ms(n * pages.element_size() + out_b + n // pages.shape[-1] * 4, 6 * n)
    rows.append(("quant_pages", time_ms(lambda: quant_page.quant_pages(pages, bits)),
                 time_ms(lambda: ref.quant_kv_page(pages, bits)), qb, None,
                 f"{tuple(pages.shape)} {pages.dtype} -> int{bits}"))
    del pages
    pages = torch.randn(shape, generator=g, device=DEV)
    errs["quant_pages"] = max(errs["quant_pages"], check_quant(pages, bits))
    n = pages.numel()
    fb, _ = bound_ms(n * 4 + (n if bits == 8 else n // 2) + n // pages.shape[-1] * 4, 6 * n)
    extra["quant_pages"] = {"f32": {
        "ms": time_ms(lambda: quant_page.quant_pages(pages, bits)), "bound_ms": fb,
        "shape": f"{tuple(pages.shape)} {pages.dtype} -> int{bits}"}}
    log(f"  quant_pages in f32: {extra['quant_pages']['f32']}")
    del pages
    # transcode_pages at the largest migration cohort of the run.
    _, shape, _, (_, src, dst) = spies["transcode_pages"].largest
    hd_src = shape[-1] * (1 if src == 8 else 2)
    pay, sc = ref.quant_kv_page(
        torch.randn(shape[:-1] + (hd_src,), generator=g, device=DEV), src)
    errs["transcode_pages"] = max(errs["transcode_pages"], check_transcode(pay, sc, src, dst))
    in_b = pay.numel() + sc.numel() * 4
    hd = pay.shape[-1] * (1 if src == 8 else 2)
    elems = sc.numel() * hd
    out_b = (elems if dst == 8 else elems // 2) + sc.numel() * 4
    tb = bound_ms(in_b + out_b, 8 * elems)
    rows.append(("transcode_pages",
                 time_ms(lambda: transcode_page.transcode_pages(pay, sc, src, dst)),
                 time_ms(lambda: ref.transcode_kv_page(pay, sc, src, dst)), tb, None,
                 f"{tuple(pay.shape)} int{src} -> int{dst}"))
    # dequant_pages at the largest batch the run gave it (f32 sentinels or
    # the per-page path's fetch); int8 in f32 and bf16 beside torch.mul, at
    # the run's largest int8 batch, or, where the run made none (HOST8 left
    # empty), at the largest batch's pages as int8 codes.
    _, shape, _, (_, bits, out_dtype) = spies["dequant_pages"].largest
    rows.append(dequant_row(g, shape, bits, out_dtype, errs))
    int8 = spies["dequant_pages"].largest_by.get(8)
    shape8 = int8[1] if int8 else shape[:-1] + (shape[-1] * (1 if bits == 8 else 2),)
    extra["dequant_pages"] = {"int8": {"source": "the run's largest int8 call" if int8 else
                                       "the largest call's pages as int8 (no int8 call)"}}
    for od in (torch.float32, torch.bfloat16):
        _, ms, plain_ms, (b_ms, _), lib_ms, what = dequant_row(g, shape8, 8, od, errs)
        extra["dequant_pages"]["int8"][str(od).split(".")[1]] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "library_ms": lib_ms,
            "shape": what}
    log(f"  dequant_pages int8: {extra['dequant_pages']['int8']}")
    # fused_tiered_attention on layer 0 of the live mid-run state.
    cfg = eng.cfg
    layer, pools = layer_pools(state, 0)
    host = {"summary": layer["host_summary"], "table": layer["host_table"],
            "n": layer["host_n"], "page_tokens": T}
    q = torch.randn((eng.bs, cfg.n_heads, cfg.head_dim_()), generator=g,
                    device=DEV).to(torch.bfloat16)
    (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, slot, tier, t, _) = ops._unified_operands(
        q, pools, layer["recent_k"], host)
    rlen = (state.recent_len + 1).to(torch.int32).contiguous()
    operands = (q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, layer["recent_k"],
                layer["recent_v"], slot, tier, rlen, t)
    errs["fused_tiered_attention"] = max(errs["fused_tiered_attention"],
                                         check_attention(operands))
    ab = bound_ms(*attention_work(operands))
    rows.append(("fused_tiered_attention",
                 time_ms(lambda: pa.fused_tiered_attention(*operands)),
                 time_ms(lambda: pa.fused_tiered_attention_plain(*operands)), ab, None,
                 f"B={eng.bs} MS={slot.shape[1]} valid rows int8/int4/host="
                 f"{int((tier == 0).sum())}/{int((tier == 1).sum())}/{int((tier == 2).sum())}, "
                 f"cluster S={pa.LAST_CLUSTER['fused_tiered_attention']}"))
    # paged_quant_attention: one layer's two per-pool launches (warm int8 +
    # cold int4) on the same state and q, timed through the unchecked launch
    # (the public wrapper's range check copies the table to the host).
    pool_args = [(q, p["k_pages"], p["k_scales"], p["v_pages"], p["v_scales"],
                  p["page_table"], p["n_pages"], p["bits"]) for p in pools.values()]
    for args in pool_args:
        errs["paged_quant_attention"] = max(errs["paged_quant_attention"], check_paged(args))
    work = [paged_work(a) for a in pool_args]
    pb = bound_ms(sum(w[0] for w in work), sum(w[1] for w in work))
    per = {name: time_ms(lambda a=a: pa.paged_quant_attention_launch(*a))
           for name, a in zip(pools, pool_args)}
    rows.append(("paged_quant_attention",
                 time_ms(lambda: [pa.paged_quant_attention_launch(*a) for a in pool_args]),
                 time_ms(lambda: [ref.paged_quant_attention(*a) for a in pool_args]), pb, None,
                 f"layer 0, warm int8 + cold int4 launches, B={eng.bs} MP="
                 f"{pool_args[0][5].shape[1]} valid pages warm/cold="
                 f"{int(layer['warm_n'].sum())}/{int(layer['cold_n'].sum())}, cluster S="
                 f"{pa.LAST_CLUSTER['paged_quant_attention']}; alone: "
                 + ", ".join(f"{k} {v:.4f} ms" for k, v in per.items())))
    launches = dict(counts, paged_quant_attention=pp_counts["paged_quant_attention"])
    if encoder is not None:
        # cxl_encode_pages on the first prefill's real layer-0 K/V pages.
        pages = encoder.first
        errs["cxl_encode_pages"] = max(errs["cxl_encode_pages"], check_cxl_encode(pages))
        n = pages.numel()
        eb = bound_ms(n * pages.element_size() + n + n // pages.shape[-1] * 4
                      + n // ref.CXL_LINE_ELEMS * 4, 7 * n)
        rows.append(("cxl_encode_pages", time_ms(lambda: cxl_line.cxl_encode_pages(pages)),
                     time_ms(lambda: ref.cxl_encode_kv_page(pages)), eb, None,
                     f"{tuple(pages.shape)} {pages.dtype}, the first prefill's layer-0 K+V"))
        launches["cxl_encode_pages"] += pp_counts["cxl_encode_pages"]
        # cxl_decode_pages at the largest HOST8 read of the run.
        _, shape, _, _ = spies["cxl_decode_pages"].largest
        pay, sc = ref.quant_kv_page(torch.randn(shape, generator=g, device=DEV), 8)
        errs["cxl_decode_pages"] = max(errs["cxl_decode_pages"], check_cxl_decode(pay, sc))
        n = pay.numel()
        lib = library_dequant(pay, sc, 8, torch.float32)
        rows.append(("cxl_decode_pages", time_ms(lambda: cxl_line.cxl_decode_pages(pay, sc)),
                     time_ms(lambda: ref.cxl_decode_kv_page(pay, sc)),
                     bound_ms(n + sc.numel() * 4 + n * 4, n), time_ms(lib),
                     f"{tuple(pay.shape)} int8 -> f32"))
        launches["cxl_decode_pages"] += pp_counts["cxl_decode_pages"]
    # The glue kernels the step ran, at its shapes; their launches in the run
    # are two norms a layer and the final one, one epilogue a layer, and one
    # SiLU * up a dense SwiGLU layer, each step.
    calls = glue_calls(eng, state)
    epi = counts["qkv_epilogue"]
    if calls and not (epi > 0 and epi % eng.la == 0
                      and counts["rmsnorm"] * eng.la == (2 * eng.la + 1) * epi
                      and counts["silu_mul"] == (epi if "silu_mul" in calls else 0)):
        fail(f"{eng.cfg.name}: glue launches {({n: counts[n] for n in GLUE_KERNELS})} are not "
             f"whole steps of {eng.la} attention layers")
    for name, e in check_glue(eng, state).items():
        errs[name] = max(errs.get(name, 0.0), e)
    for name, (args, kw) in calls.items():
        kern, plain = getattr(decode_glue, name), getattr(decode_glue, f"{name}_plain")
        rows.append((name, time_ms(lambda: kern(*args, **kw)),
                     time_ms(lambda: plain(*args, **kw)), bound_ms(*glue_work(name, args, kw)),
                     None, ", ".join(f"{tuple(a.shape)}" for a in args[:3]
                                     if isinstance(a, torch.Tensor))
                     + f" {args[1].dtype if name == 'rmsnorm' else args[0].dtype}"))
    out = []
    for name, ms, plain_ms, (b_ms, b_by), lib_ms, shape in rows:
        src_path, replaces = REPLACES[name]
        out.append({
            "name": name, "route": "cuda", "source": src_path, "replaces": replaces,
            "launches": launches[name],
            ("max_bf16_ulps" if name in GLUE_KERNELS else "max_abs_err"): errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": shape, "floor_ms": floor, **extra.get(name, {}),
        })
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"library {lib_ms}) at {shape}; launches {launches[name]}")
    return out


def phase_profile(eng, state, captured: bool = False) -> dict:
    """Where one decode step's time goes: 3 decode steps on the
    mid-run state under ``torch.profiler`` (the eager step, or with
    ``captured`` the engine's captured step, replayed); device time by
    kernel and the device's busy share of the host wall time. Only the
    device's own events (kernels, copies) are summed: an operator's self
    device time is the time of the kernels it launched, which appear as
    events of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = (eng._step_fn if captured else
            serve.make_tiered_decode_step(eng.model, eng.ts, device=DEV))
    captures = dict(getattr(step, "captures", {}))
    tokens = torch.ones((eng.bs, 1), dtype=torch.int64, device=DEV)
    step(eng.params, tokens, state, eng.ssm_state)
    torch.cuda.synchronize()
    n = 3
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        begin.record()
        for _ in range(n):
            step(eng.params, tokens, state, eng.ssm_state)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if device_ms <= 0:
        fail(f"the profiler recorded no device time ({'captured' if captured else 'eager'} step)")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    seen = {}
    if captured:
        if step.captures != captures:
            fail(f"phase 7 ({eng.cfg.name}): the captured profile captured again")
        # The replays' launch counts come from the capture's record: hold
        # them to the kernel events the profiler saw inside the replays.
        held = step.graphs[graph_route()].launches
        for name in ATTENTION_KERNELS:
            seen[name] = sum(e.count for e in events if f"{name}_kernel" in e.key)
            if seen[name] != held.get(name, 0) * n:
                fail(f"phase 7 ({eng.cfg.name}): the profiler saw {seen[name]} {name} kernels in "
                     f"{n} replays; the graph holds {held.get(name, 0)} a replay")
        if not any(seen.values()):
            fail(f"phase 7 ({eng.cfg.name}): no attention kernel ran in the replays")
    out = {
        "step": "captured" if captured else "eager",
        "step_wall_ms": wall_ms,
        "step_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "event_ms_per_step": begin.elapsed_time(end) / n,
        "top_device_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top},
    }
    if captured:
        out["attention_kernel_events"] = seen
    log(f"phase 7 profile ({eng.cfg.name}, {out['step']} step): {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 2b-2c
def phase_one_step(name: str) -> dict:
    """Full width at depth ``ONE_STEP_LAYERS`` on the default path: prefill
    of one ``ONE_STEP_PROMPT``-token prompt, ``ONE_STEP_DECODE`` tiered
    decode steps (one fused launch a layer), then one step on the card
    against the same step on the CPU at phase 4's bars. Frees the engine
    after."""
    cfg = dataclasses.replace(get(name), n_layers=ONE_STEP_LAYERS)
    model, params = init_params(cfg)
    ts = TierScapeRunConfig(enabled=True, alpha=ASYNC_ALPHA, window_steps=16,
                            async_migration=True, prefetch=True, faults=False)
    eng = TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                       recent_window=R, ts=ts, device=DEV)
    req = eng.submit(np.random.default_rng(SEED).integers(1, cfg.vocab_size, ONE_STEP_PROMPT),
                     max_new_tokens=NEW_TOKENS)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    eng._fill_slots()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(ONE_STEP_DECODE):
        eng.step()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 - prefill_ms
    counts = build.launch_counts()
    glue = {n: 0 for n in GLUE_KERNELS}
    for n in glue_calls(eng, eng.cache.state):  # two norms a layer and the final one
        glue[n] = ONE_STEP_DECODE * (2 * eng.la + 1 if n == "rmsnorm" else eng.la)
    if (counts["fused_tiered_attention"] != eng.la * ONE_STEP_DECODE or counts["quant_pages"] < 1
            or len(req.out_tokens) != 1 + ONE_STEP_DECODE
            or any(counts[n] != k for n, k in glue.items())):
        fail(f"{name}: {len(req.out_tokens)} tokens, launches {counts}; expected "
             f"{1 + ONE_STEP_DECODE} tokens, {eng.la} x {ONE_STEP_DECODE} fused launches, "
             f"glue launches {glue} and a page-out through quant_pages")
    out = {"layers": cfg.n_layers, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "prompt_tokens": ONE_STEP_PROMPT, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms / ONE_STEP_DECODE, "launches": counts,
           "glue_bf16_ulps": check_glue(eng, eng.cache.state)}
    if cfg.mrope:
        out["vision_forward"] = vlm_forward(model, params)
        out["mrope_two_slots"] = mrope_step_check(eng)
    out["step_compare"] = step_compare(eng)
    out["captured_vs_eager"] = graph_compare(eng)
    if cfg.mrope:
        out["graph_tokens"] = graph_tokens(cfg, model, params)
    log(f"phase 2b ok ({name} at {cfg.n_layers} of {get(name).n_layers} layers, full width): "
        f"{json.dumps(out)}")
    del eng, model, params, req
    free_device()
    return out


def vlm_forward(model, params) -> dict:
    """One forward of a ``VLM_BATCH`` x ``VLM_SEQ`` vision batch (the
    reference's ``make_train_batch``: patch embeddings in the first seq / 8
    positions, 3-axis positions), timed and held finite; the patches must
    change the logits against the same tokens without them."""
    cfg = model.cfg
    batch = inputs.make_train_batch(cfg, VLM_BATCH, VLM_SEQ, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if logits.shape != (VLM_BATCH, VLM_SEQ, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"{cfg.name}: vision forward gave {tuple(logits.shape)} or non-finite logits")
    text = {k: v for k, v in batch.items() if k not in ("embeds", "embeds_mask")}
    effect = float((model.forward(params, text)[0].float() - logits.float()).abs().max())
    if effect == 0.0:
        fail(f"{cfg.name}: the patch embeddings did not change the logits")
    return {"batch": VLM_BATCH, "seq": VLM_SEQ,
            "patch_positions": int(batch["embeds_mask"][0].sum()), "forward_ms": ms,
            "max_abs_logit": float(logits.float().abs().max()), "patch_effect_max_abs": effect}


def mrope_step_check(eng: TieredEngine) -> dict:
    """A second request, of another length, into the free slot, then one
    engine decode step (the eager kernel step, whose QKV epilogue can be
    patched) in which every layer's cos and sin (M-RoPE's, from the
    [3, B, 1] positions the step builds) must equal 1-D RoPE's at each
    slot's own position, and so must its q and its k and v rows."""
    cfg = eng.cfg
    eng.submit(np.random.default_rng(SEED + 3).integers(1, cfg.vocab_size, VLM_SECOND_PROMPT),
               max_new_tokens=NEW_TOKENS)
    eng._fill_slots()
    lens = eng.cache.state.total_len.tolist()
    if len(set(lens)) != eng.bs:
        fail(f"{cfg.name}: slot lengths {lens} are not unequal")
    pos = serve.step_positions(cfg, eng.cache.state.total_len)
    if pos.shape != (3, eng.bs, 1) or pos[:, :, 0].tolist() != [lens] * 3:
        fail(f"{cfg.name}: decode positions {pos.tolist()} for slot lengths {lens}")
    cos1, sin1 = layers.rope_cos_sin(pos[0], cfg.head_dim_(), cfg.rope_theta, DEV)
    epilogue = decode_glue.qkv_epilogue
    diffs = []

    def check(q, k, v, cos, sin, recent_k, recent_v, recent_len, **kw):
        windows = (recent_k.clone(), recent_v.clone())
        q1 = epilogue(q, k, v, cos1, sin1, *windows, recent_len, **kw)
        out = epilogue(q, k, v, cos, sin, recent_k, recent_v, recent_len, **kw)
        diffs.append(max(float((a.float() - b.float()).abs().max())
                         for a, b in ((cos, cos1), (sin, sin1), (out, q1),
                                      (recent_k, windows[0]), (recent_v, windows[1]))))
        return out

    # The patched epilogue runs only in an eager step: the engine's
    # captured step would replay without calling it.
    graphed = eng._step_fn
    eng._step_fn = serve.make_tiered_decode_step(eng.model, eng.ts, device=DEV)
    decode_glue.qkv_epilogue = check
    try:
        eng.step()
        torch.cuda.synchronize()
    finally:
        decode_glue.qkv_epilogue = epilogue
        eng._step_fn = graphed
    if len(diffs) != eng.la or max(diffs) != 0.0:
        fail(f"{cfg.name}: 2-slot M-RoPE q/k differ from 1-D RoPE by {diffs}")
    return {"slot_lengths": lens, "layers_checked": len(diffs), "max_abs_diff": max(diffs)}


class MoeSpy:
    """Wraps ``moe.moe_ffn``: keeps the ``dropped_frac`` of every call with
    more than one token a group (the engine's prefills), as device tensors
    read once at the end."""

    def __init__(self):
        self.fn = moe.moe_ffn
        self.prefill_dropped = []
        moe.moe_ffn = self

    def __call__(self, p, cfg, x, capacity=None):
        y, aux = self.fn(p, cfg, x, capacity)
        if x.shape[1] > 1:
            self.prefill_dropped.append(aux["dropped_frac"])
        return y, aux

    def remove(self) -> list:
        moe.moe_ffn = self.fn
        return [float(d) for d in self.prefill_dropped]


def phase_moe(cfg, errs) -> tuple:
    """``qwen3_moe_235b`` at full width and ``MOE_LAYERS`` layers on the
    default path (phase 3's run and checks, phase 4's compares, phase 5's
    timings at its shapes), two MoE layer calls on the same inputs
    byte-equal and one layer's device time (``time_ms``) at a prefill and the
    decode shape, the prefill ``dropped_frac``, and the expert bytes a decode
    step reads. Frees the card after."""
    model, params = init_params(cfg)
    spy = MoeSpy()
    try:
        (eng, counts, pp_counts, metrics, spies, state, compares,
         _) = phase_async(cfg, model, params, phase="2g")
    finally:
        dropped = spy.remove()
    blk = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    same = {}
    for what, shape in (("prefill", (1, PROMPTS[cfg.name][1] - 1)), ("decode", (2, 1))):
        x = torch.randn(shape + (cfg.d_model,), generator=g, device=DEV).to(torch.bfloat16)
        a, aux_a = moe.moe_ffn(blk, cfg, x)
        b, aux_b = moe.moe_ffn(blk, cfg, x)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)):
            fail(f"{cfg.name}: two MoE calls on the same {what} inputs differ")
        same[what] = {"shape": list(shape), "capacity": moe.route(blk, cfg, x)["capacity"],
                      "dropped_frac": float(aux_a["dropped_frac"]),
                      "layer_ms": time_ms(lambda: moe.moe_ffn(blk, cfg, x))}
    expert_bytes = sum(params["blocks"]["moe"][w].numel() * 2
                       for w in ("w_gate", "w_up", "w_down"))
    same["expert_bytes_floor_ms_per_layer"] = expert_bytes / cfg.n_layers / HBM_BYTES_PER_S * 1e3
    metrics["reckoned"] = reckon_memory(cfg, params, eng)
    metrics["expert_bytes_per_decode_step"] = expert_bytes
    metrics["expert_bytes_floor_ms_per_step"] = expert_bytes / HBM_BYTES_PER_S * 1e3
    metrics["prefill_dropped_frac"] = {"calls": len(dropped), "mean": float(np.mean(dropped)),
                                       "max": max(dropped), "min": min(dropped)}
    metrics["moe_calls_byte_equal"] = same
    metrics["compares"] = compares
    log(f"phase 2g ok ({cfg.name} at {cfg.n_layers} of {get(cfg.name).n_layers} layers, "
        f"full width): {json.dumps(metrics)}")
    rows = {k["name"]: k for k in phase_times(eng, counts, pp_counts, spies, state, errs)}
    del eng, model, params, state, blk
    free_device()
    return metrics, counts, rows


def phase_hubert() -> dict:
    """``hubert_xlarge`` at full width and depth: a bf16 forward of
    ``HUBERT_BATCH`` x ``HUBERT_FRAMES`` audio frames (the reference's
    ``make_train_batch``), timed after one warm-up, through the blockwise
    bidirectional attention; then in f32 with the same weights, the
    difference reported. The tiered engine must refuse it. Frees the card
    after."""
    cfg = get("hubert_xlarge")
    torch.cuda.reset_peak_memory_stats()
    model, params = init_params(cfg)
    try:
        TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                     recent_window=R, device=DEV)
    except ValueError as e:
        refusal = str(e)
    else:
        fail("hubert_xlarge: TieredEngine accepted an encoder")
    if HUBERT_FRAMES <= attention.CHUNKED_ATTN_THRESHOLD:
        fail("hubert_xlarge: the frames do not reach the blockwise attention path")
    batch = inputs.make_train_batch(cfg, HUBERT_BATCH, HUBERT_FRAMES, seed=SEED, device=DEV)
    model.forward(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    bf16_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    params = _tree_f32(params)
    batch = dict(batch, embeds=batch["embeds"].float())
    t0 = time.perf_counter()
    full, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    f32_ms = (time.perf_counter() - t0) * 1e3
    if (logits.shape != (HUBERT_BATCH, HUBERT_FRAMES, cfg.vocab_size)
            or not (torch.isfinite(logits.float()).all() and torch.isfinite(full).all())):
        fail(f"hubert_xlarge: logits {tuple(logits.shape)} or not finite")
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model, "head_dim": cfg.head_dim_(),
           "batch": HUBERT_BATCH, "frames": HUBERT_FRAMES, "bf16_forward_ms": bf16_ms,
           "f32_forward_ms": f32_ms,
           "bf16_vs_f32_max_abs_diff": float((logits.float() - full).abs().max()),
           "max_abs_logit_f32": float(full.abs().max()), "weights_bytes": weights,
           "peak_memory_bytes_bf16": peak, "engine_refusal": refusal}
    log(f"phase 2h ok (hubert_xlarge, full width and depth): {json.dumps(out)}")
    del model, params, logits, full, batch
    free_device()
    return out


# ---------------------------------------------------------------- phase 2d-2f
def _mamba2_run(model, params, tokens, dtype) -> dict:
    """``Model.prefill`` (the recurrent scan for the states, the parallel
    chunked forward for the logits) on a batch of prompts, then
    ``MAMBA_DECODE`` greedy decode steps; the decode logits against the
    parallel forward over the same tokens."""
    b, s = tokens.shape
    t0 = time.perf_counter()
    state = model.init_cache(b, s + MAMBA_DECODE + 1, dtype=dtype)
    logits, state = model.prefill(params, {"tokens": tokens}, state)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    gen = [torch.argmax(logits[:, -1], -1)]
    outs = []
    t0 = time.perf_counter()
    for _ in range(MAMBA_DECODE):
        lg, state = model.decode_step(params, gen[-1][:, None], state)
        outs.append(lg)
        gen.append(torch.argmax(lg[:, 0], -1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    seq = torch.cat([tokens] + [g[:, None] for g in gen[:-1]], 1)
    full = model.forward(params, {"tokens": seq})[0][:, s:].float()
    dec = torch.cat(outs, 1).float()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        fail(f"mamba2_780m ({dtype}): logits are not finite")
    return {"prefill_ms_per_batch": prefill_ms, "prefill_ms_per_request": prefill_ms / b,
            "decode_ms_per_step": decode_ms / MAMBA_DECODE,
            "decode_vs_forward_max_diff": float((full - dec).abs().max()),
            "max_abs_logit": float(full.abs().max())}


def phase_mamba2() -> dict:
    """``mamba2_780m`` at full width (no kernel of the port runs here: the
    SSD blocks are plain PyTorch, as in the reference): a batch of
    ``MAMBA_BATCH`` prompts through prefill and ``MAMBA_DECODE`` greedy
    decode steps in bf16 (timed), then again with the same weights in f32,
    where the decode logits are held to the parallel forward over the same
    tokens at the reference's bar. In bf16 the two drift apart with depth
    in the reference as in the port (``scripts/mamba2_drift.py`` measures
    both on the CPU), so the bf16 difference is reported, not held. The
    tiered engine must refuse the config (no attention, no KV to tier).
    Frees the model after."""
    cfg = get("mamba2_780m")
    torch.cuda.reset_peak_memory_stats()
    model, params = init_params(cfg)
    try:
        TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                     recent_window=R, device=DEV)
    except ValueError as e:
        refusal = str(e)
    else:
        fail("mamba2_780m: TieredEngine accepted an attention-free config")
    rng = np.random.default_rng(SEED)
    s = int(rng.integers(*MAMBA_PROMPT))
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (MAMBA_BATCH, s)), device=DEV)
    bf16 = _mamba2_run(model, params, tokens, torch.bfloat16)
    peak = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    params = _tree_f32(params)
    f32 = _mamba2_run(model, params, tokens, torch.float32)
    if f32["decode_vs_forward_max_diff"] >= DECODE_VS_FORWARD:
        fail(f"mamba2_780m: f32 decode logits differ from the parallel forward by "
             f"{f32['decode_vs_forward_max_diff']} (bar {DECODE_VS_FORWARD})")
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model, "batch": MAMBA_BATCH,
           "prompt_tokens": s, "decode_steps": MAMBA_DECODE, "bf16": bf16, "f32": f32,
           "weights_bytes": weights, "peak_memory_bytes_bf16": peak,
           "engine_refusal": refusal}
    log(f"phase 2d ok (mamba2_780m, full width): {json.dumps(out)}")
    del model, params
    free_device()
    return out


def table_rows(cache, slot: int) -> dict:
    """Logical pages of ``slot``'s rows per (pool, layer), in table order:
    the order the attention kernels merge a sequence's pages in."""
    out = {}
    for pool, levels, owner in (("warm", (kvc.WARM,), cache._pool_slot),
                                ("cold", (kvc.COLD,), cache._pool_slot),
                                ("host", (kvc.HOST8, kvc.HOST4), cache._host_slot)):
        table = getattr(cache.state, f"{pool}_table").cpu().numpy()
        count = getattr(cache.state, f"{pool}_n").cpu().numpy()
        for layer in range(cache.la):
            rids = [cache.rid(layer, slot, p) for p in range(cache.max_pages)]
            lookup = {int(owner[r]): r % cache.max_pages for r in rids
                      if cache._page_exists[r] and int(cache.physical[r]) in levels}
            out[f"{pool}/{layer}"] = [lookup[int(x)]
                                      for x in table[layer, slot, :int(count[layer, slot])]]
    return out


def billing(cache) -> dict:
    return {name: (q.bytes_total, q.ops, q.busy_s) for name, q in cache.media_queues.items()}


def _billed_since(cache, before: dict, dispatches: int) -> tuple:
    after = billing(cache)
    return ({n: tuple(float(a - b) for a, b in zip(after[n], before[n])) for n in after},
            cache.kernel_dispatches - dispatches)


def preempt_engine(model, params) -> TieredEngine:
    """The smoke's geometry on the default path (async + prefetch), with a
    profile window longer than the run: placements never move, so the
    preempted run can be held to the uninterrupted one bit for bit."""
    ts = TierScapeRunConfig(enabled=True, alpha=ASYNC_ALPHA, window_steps=10_000,
                            async_migration=True, prefetch=True, faults=False)
    return TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                        recent_window=R, ts=ts, device=DEV)


def phase_preempt(cfg, model, params) -> dict:
    """Preemption to the host tier at full width: an uninterrupted run of
    one request, then the same request preempted after ``PREEMPT_AFTER``
    steps (its device pages demoted to their same-codec host tiers and
    parked), another request churning the vacated slot, and a resume into
    the other slot. Tokens must equal the uninterrupted run's bit for bit,
    the resumed slot's table rows must be in the uninterrupted order, no
    prompt token is re-prefilled, and the demotion bills like a plain
    pipeline demotion of the same pages. Counts are reset before and read
    after the preempted run."""
    rng = np.random.default_rng(SEED + 2)
    prompt = rng.integers(1, cfg.vocab_size, PREEMPT_PROMPT)
    churn = rng.integers(1, cfg.vocab_size, CHURN_PROMPT)

    eng = preempt_engine(model, params)
    ref_req = eng.make_request(prompt, PREEMPT_NEW)
    eng.start_request(0, ref_req)
    for _ in range(PREEMPT_AFTER):
        eng.step()
    ref_rows = table_rows(eng.cache, 0)
    while not ref_req.done:
        eng.step()
    del eng
    free_device()

    # A plain pipeline demotion of the same pages at the same point.
    eng = preempt_engine(model, params)
    eng.start_request(0, eng.make_request(prompt, PREEMPT_NEW))
    for _ in range(PREEMPT_AFTER):
        eng.step()
    cache = eng.cache
    cache.drain_migrations()
    before, disp = billing(cache), cache.kernel_dispatches
    rids = cache.slot_rids(0)
    dev = rids[np.isin(cache.physical[rids], (kvc.WARM, kvc.COLD))]
    bits = np.array([cache._bits[int(x)] for x in cache.physical[dev]])
    cache.pipeline.submit(cache.plan_cohorts(dev, np.where(bits == 8, kvc.HOST8, kvc.HOST4)))
    cache.pipeline.drain()
    plain_bill = _billed_since(cache, before, disp)
    del eng, cache
    free_device()

    spies = install_spies()
    eng = preempt_engine(model, params)
    cache = eng.cache
    reset_counts(spies)
    req = eng.make_request(prompt, PREEMPT_NEW)
    eng.start_request(0, req)
    for _ in range(PREEMPT_AFTER):
        eng.step()
    cache.drain_migrations()
    before, disp = billing(cache), cache.kernel_dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = eng.preempt_slot(0)
    torch.cuda.synchronize()
    preempt_ms = (time.perf_counter() - t0) * 1e3
    preempt_bill = _billed_since(cache, before, disp)
    other = eng.make_request(churn, CHURN_NEW)
    eng.start_request(0, other)
    while not other.done:
        eng.step()
    t0 = time.perf_counter()
    eng.resume_into(1, pre)
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    rows = table_rows(cache, 1)
    while not req.done:
        eng.step()
    stats = eng.finish()
    torch.cuda.synchronize()
    counts = read_counts(spies)
    remove_spies(spies)

    demoted = sum(pg.restore_level in (kvc.WARM, kvc.COLD) for pg in pre.parked.pages)
    if req.out_tokens != ref_req.out_tokens:
        fail(f"preempt: resumed tokens {req.out_tokens} != uninterrupted {ref_req.out_tokens}")
    if rows != ref_rows:
        fail("preempt: the resumed slot's table rows are not in the uninterrupted run's order")
    if stats.re_prefill_tokens or stats.preemptions != 1 or stats.resumes != 1:
        fail(f"preempt: re-prefilled {stats.re_prefill_tokens} tokens, {stats.preemptions} "
             f"preemptions, {stats.resumes} resumes")
    if stats.resumed_pages != len(pre.parked.pages):
        fail(f"preempt: resumed {stats.resumed_pages} pages of {len(pre.parked.pages)} parked")
    if demoted == 0 or preempt_bill != plain_bill:
        fail(f"preempt: {demoted} device pages demoted; billed {preempt_bill}, a plain "
             f"demotion of the same pages {plain_bill}")
    if (counts["fused_tiered_attention"] != eng.la * stats.steps
            or stats.attn_launches != counts["fused_tiered_attention"]
            or counts["quant_pages"] < 1 or counts["dequant_pages"] < 1):
        fail(f"preempt: launches {counts} for {stats.steps} steps of {eng.la} layers, billed "
             f"{stats.attn_launches}")
    check_counts(counts, "preempt")
    out = {"prompt_tokens": PREEMPT_PROMPT, "new_tokens": PREEMPT_NEW,
           "preempted_after_steps": PREEMPT_AFTER, "parked_pages": len(pre.parked.pages),
           "demoted_pages": int(demoted), "resumed_pages": stats.resumed_pages,
           "preempt_slot_ms": preempt_ms, "resume_into_ms": resume_ms,
           "re_prefill_tokens": stats.re_prefill_tokens, "tokens_equal": True,
           "demotion_billing": {k: list(v) for k, v in preempt_bill[0].items()},
           "demotion_kernel_dispatches": preempt_bill[1], "decode_steps": stats.steps,
           "launches": counts}
    log(f"phase 2e ok (qwen1_5_4b preempt/resume, full width): {json.dumps(out)}")
    del eng, cache, pre
    free_device()
    return out


def phase_frontend(cfg, model, params) -> tuple:
    """The SLA-aware frontend at full width: ``ContinuousScheduler`` over
    two replicas that share one set of weights, on the default path (async
    + prefetch at ``ASYNC_ALPHA``, 16-step windows), the burst trace, and
    replica 0 hard-failing mid-trace (its running slots parked and resumed
    on replica 1). Counts are reset before and read after the run."""
    ts = TierScapeRunConfig(enabled=True, alpha=ASYNC_ALPHA, window_steps=16,
                            async_migration=True, prefetch=True, faults=False)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    engines = [TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                            recent_window=R, ts=ts, device=DEV) for _ in range(2)]
    events = generate(TraceConfig(**FRONTEND_TRACE))
    sched = ContinuousScheduler(engines, events, cfg.vocab_size,
                                prefill_chunk_tokens=FRONTEND_CHUNK)
    spies = install_spies()
    reset_counts(spies)
    t0 = time.perf_counter()
    stats = sched.run(failures=FRONTEND_FAILURES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(spies)
    remove_spies(spies)
    what = "frontend"
    done = stats.done()
    if len(done) + stats.refused != len(events):
        fail(f"{what}: {len(done)} done + {stats.refused} refused != {len(events)} arrivals")
    for rec in done:
        if (len(rec.token_steps) != rec.event.max_new_tokens
                or len(rec.request.out_tokens) != rec.event.max_new_tokens
                or not (rec.tbt() >= 1).all()):
            fail(f"{what}: request {rec.event.seq} has {len(rec.token_steps)} token steps "
                 f"for {rec.event.max_new_tokens} tokens, TBT {rec.tbt().tolist()}")
    if (stats.re_prefill_tokens or stats.preemptions < 1 or stats.resumes < 1
            or stats.replica_failures != 1 or stats.failover_parked < 1):
        fail(f"{what}: {stats.summary()}")
    billed = sum(e.stats.attn_launches for e in engines)
    if counts["fused_tiered_attention"] != billed or any(
            counts[n] < 1 for n in ("fused_tiered_attention", "quant_pages", "transcode_pages",
                                    "dequant_pages")):
        fail(f"{what}: launches {counts}, billed attention launches {billed}")
    check_counts(counts, what)
    check_bf16_page_out(spies, what)
    for i, e in enumerate(engines):
        pipe, ring = e.cache.pipeline, e.cache.staging_ring
        if pipe.prefetch_staged != pipe.prefetch_hits + pipe.prefetch_misses + \
                pipe.prefetch_invalidated or ring.held_slots:
            fail(f"{what}: replica {i}: prefetch staged {pipe.prefetch_staged}, hits "
                 f"{pipe.prefetch_hits}, misses {pipe.prefetch_misses}, invalidated "
                 f"{pipe.prefetch_invalidated}; {ring.held_slots} ring credits held")
    out = {"arrivals": len(events), "summary": stats.summary(), "wall_s": wall,
           "virtual_steps": stats.steps, "ms_per_virtual_step": wall / stats.steps * 1e3,
           "replica_decode_steps": [e.stats.steps for e in engines],
           "replica_windows": [e.stats.windows for e in engines],
           "replica_migrations": [e.stats.migrations for e in engines],
           "tco_savings_pct": [e.stats.tco_savings_pct for e in engines],
           "prefetch_staged": [e.stats.prefetch_staged for e in engines],
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
           "launches": counts}
    log(f"phase 2f ok (frontend over two qwen1_5_4b replicas, full width): {json.dumps(out)}")
    del sched, engines
    free_device()
    return out, stats


# ---------------------------------------------------------------- phase 2i
def _bf16_pages(g, n: int, cfg) -> torch.Tensor:
    shape = (n, T, cfg.n_kv_heads, cfg.head_dim_())
    return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)


def _held(cache, level: int, tenant: int) -> int:
    return int(((cache.physical == level) & cache._page_exists
                & cache.tenant_mask(tenant)).sum())


def check_tenant_tables(cache, what: str) -> int:
    """Read the warm and cold device tables back once: every row (layer,
    slot), the decode kernel's read path, must reference only pool rows that
    hold that slot's pages (tests/test_multitenant.py's no-cross-tenant-reads
    check), and every pooled page must appear. Returns the rows checked."""
    rows = 0
    for pool, level in (("warm", kvc.WARM), ("cold", kvc.COLD)):
        table = getattr(cache.state, f"{pool}_table").cpu().numpy()
        count = getattr(cache.state, f"{pool}_n").cpu().numpy()
        owner = {}
        for rid in np.where((cache.physical == level) & cache._page_exists)[0]:
            layer, slot, _ = cache.rid_coords(int(rid))
            owner[(layer, int(cache._pool_slot[rid]))] = slot
        seen = 0
        for layer in range(cache.la):
            for slot in range(cache.bs):
                for row in table[layer, slot, :int(count[layer, slot])]:
                    got = owner.get((layer, int(row)))
                    if got != slot:
                        fail(f"{what}: {pool} row of layer {layer}, slot {slot} (tenant "
                             f"{cache.slot_tenant[slot]}) references slot {got}'s page")
                    seen += 1
        if seen != len(owner):
            fail(f"{what}: the {pool} tables hold {seen} rows for {len(owner)} pages")
        rows += seen
    return rows


def phase_mt_cache(cfg) -> dict:
    """The cache's tenant paths at full width and MODES_LAYERS depth, as
    tests/test_media.py holds them: a warm quota on append (kernel #2), a
    quota-bounded mass promotion (kernel #3) and a cold quota spilling a
    batched demotion to HOST4; the device tables read back for cross-tenant
    rows; per-tenant TCO adding up. Launches must equal the cache's calls."""
    what = "multitenant cache"
    total = MODES_LAYERS * 2 * (1024 // T)
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    spies = install_spies()
    reset_counts(spies)
    out = {}
    # Warm quota: tenant 0 floods slot 0; tenant 1 still gets warm rows.
    warm_cap = total // 4
    c = _mode_cache(cfg, warm_frac=0.25,
                    tenant_quota={"warm": {0: MT_WARM_QUOTA, 1: warm_cap - MT_WARM_QUOTA}})
    c.set_slot_tenant(0, 0)
    c.set_slot_tenant(1, 1)
    flood = [(la, 0, pg) for la in range(c.la) for pg in range(c.max_pages)]
    k = _bf16_pages(g, len(flood), cfg)
    c.append_pages(flood, k, k * 0.3)
    t0_warm = _held(c, kvc.WARM, 0)
    other = [(la, 1, pg) for la in range(c.la) for pg in range(8)]
    k = _bf16_pages(g, len(other), cfg)
    c.append_pages(other, k, k * 0.3)
    t1_warm = _held(c, kvc.WARM, 1)
    if t0_warm != MT_WARM_QUOTA or c._alloc["warm"].used_by(0) != MT_WARM_QUOTA:
        fail(f"{what}: tenant 0 holds {t0_warm} warm pages, quota {MT_WARM_QUOTA}")
    if t1_warm != len(other):
        fail(f"{what}: tenant 1 got {t1_warm} of {len(other)} pages warm")
    out["warm_quota"] = {"flooded_pages": len(flood), "tenant0_warm": t0_warm,
                         "tenant1_warm": t1_warm, "tables_rows": check_tenant_tables(c, what)}
    del c
    # Promotion quota: everything cold, then a mass promotion of tenant 0.
    c = _mode_cache(cfg, warm_frac=0.5,
                    tenant_quota={"warm": {0: MT_PROMOTE_QUOTA, 1: total // 2 - MT_PROMOTE_QUOTA}})
    c.set_slot_tenant(0, 0)
    c.set_slot_tenant(1, 1)
    coords = [(la, sl, pg) for la in range(c.la) for sl in range(c.bs) for pg in range(24)]
    k, v = _bf16_pages(g, len(coords), cfg), _bf16_pages(g, len(coords), cfg)
    c.append_pages(coords, k, v)
    live = np.where(c._page_exists)[0]
    c.migrate_batch(live, np.full(live.size, kvc.COLD, np.int64))
    mine = np.where(c._page_exists & c.tenant_mask(0))[0]
    c.migrate_batch(mine, np.full(mine.size, kvc.WARM, np.int64))
    promoted, left_cold = _held(c, kvc.WARM, 0), _held(c, kvc.COLD, 0)
    if promoted > MT_PROMOTE_QUOTA or left_cold == 0 or c._alloc["warm"].used_by(0) != promoted:
        fail(f"{what}: promotion left tenant 0 {promoted} warm (quota {MT_PROMOTE_QUOTA}), "
             f"{left_cold} cold")
    # Shuffle every page over the four tiers, then read the tables back.
    dsts = rng.choice([kvc.WARM, kvc.COLD, kvc.HOST8, kvc.HOST4], size=live.size)
    shuffled = c.migrate_batch(live, dsts.astype(np.int64))
    rows = check_tenant_tables(c, what)
    tco = [c.tco_usd(), c.tco_usd(0), c.tco_usd(1)]
    if abs(tco[0] - (tco[1] + tco[2])) > 1e-12 * abs(tco[0]):
        fail(f"{what}: tco_usd() {tco[0]} != tco_usd(0) + tco_usd(1) = {tco[1] + tco[2]}")
    out["promotion_quota"] = {"pages": len(coords), "tenant0_promoted": promoted,
                              "tenant0_left_cold": left_cold, "shuffled_moves": shuffled,
                              "tables_rows": rows, "tco_usd": tco,
                              "levels": np.bincount(c.physical[live], minlength=5).tolist()}
    del c
    # Cold quota: a batched WARM -> COLD demotion spills the overflow to HOST4.
    c = _mode_cache(cfg, warm_frac=1.0,
                    tenant_quota={"cold": {0: MT_COLD_QUOTA, 1: total - MT_COLD_QUOTA}})
    c.set_slot_tenant(0, 0)
    c.set_slot_tenant(1, 0)
    coords = coords[:64]
    c.append_pages(coords, _bf16_pages(g, 64, cfg), _bf16_pages(g, 64, cfg))
    live = np.where(c._page_exists)[0]
    moved = c.migrate_batch(live, np.full(live.size, kvc.COLD, np.int64))
    cold, host4 = _held(c, kvc.COLD, 0), _held(c, kvc.HOST4, 0)
    if moved != live.size or cold != MT_COLD_QUOTA or host4 != live.size - MT_COLD_QUOTA:
        fail(f"{what}: cold quota {MT_COLD_QUOTA}: moved {moved}, cold {cold}, HOST4 {host4}")
    out["cold_quota"] = {"pages": live.size, "cold": cold, "host4": host4,
                         "tables_rows": check_tenant_tables(c, what)}
    del c
    torch.cuda.synchronize()
    counts = read_counts(spies)
    remove_spies(spies)
    if any(counts[n] < 1 for n in ("quant_pages", "transcode_pages", "dequant_pages")):
        fail(f"{what}: quant/transcode/dequant kernels not on the path: {counts}")
    check_counts(counts, what)
    out["launches"] = counts
    free_device()
    return out


def phase_mt_engine(cfg, model, params) -> dict:
    """One engine at full width and depth on the default path (async +
    prefetch) serving four requests of tenants 0, 1, 0, 1 on two slots, as
    tests/test_multitenant.py::test_engine_serves_interleaved_tenants does.
    Counts are reset before and read after the run."""
    what = "multitenant engine"
    ts = TierScapeRunConfig(enabled=True, policy="analytical", alpha=MT_ALPHA,
                            window_steps=MT_WINDOW, async_migration=True, prefetch=True,
                            faults=False)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eng = TieredEngine(model, params, batch_slots=2, page_tokens=T, max_seq_len=1024,
                       recent_window=R, ts=ts, device=DEV)
    rng = np.random.default_rng(SEED + 3)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, int(rng.integers(*MT_PROMPTS))),
                       max_new_tokens=MT_NEW, tenant=t) for t in MT_TENANTS]
    spies = install_spies()
    reset_counts(spies)
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(spies)
    remove_spies(spies)
    pipe, ring = eng.cache.pipeline, eng.cache.staging_ring
    if stats.completed != len(reqs) or not all(r.done and len(r.out_tokens) == MT_NEW
                                               for r in reqs):
        fail(f"{what}: {stats.completed} of {len(reqs)} requests completed")
    if stats.completed_by_tenant != {0: 2, 1: 2} or set(stats.tco_savings_by_tenant) != {0, 1}:
        fail(f"{what}: completed by tenant {stats.completed_by_tenant}, TCO savings by tenant "
             f"{stats.tco_savings_by_tenant}")
    if (counts["fused_tiered_attention"] != eng.la * stats.steps
            or stats.attn_launches != counts["fused_tiered_attention"]
            or counts["quant_pages"] < 1):
        fail(f"{what}: launches {counts} for {stats.steps} steps of {eng.la} layers, billed "
             f"{stats.attn_launches}")
    if (pipe.prefetch_staged != pipe.prefetch_hits + pipe.prefetch_misses
            + pipe.prefetch_invalidated or ring.held_slots):
        fail(f"{what}: prefetch staged {pipe.prefetch_staged}, hits {pipe.prefetch_hits}, "
             f"misses {pipe.prefetch_misses}, invalidated {pipe.prefetch_invalidated}; "
             f"{ring.held_slots} ring credits held")
    check_counts(counts, what)
    check_bf16_page_out(spies, what)
    out = engine_metrics(stats, reqs, wall, torch.cuda.max_memory_allocated() - held)
    out.update(alpha=MT_ALPHA, window_steps=MT_WINDOW, tenants=list(MT_TENANTS),
               completed_by_tenant=stats.completed_by_tenant,
               tco_savings_by_tenant=stats.tco_savings_by_tenant,
               media_bytes=pipe.media_bytes(), prefetch_hit_rate=pipe.prefetch_hit_rate(),
               prefetch_invalidated=pipe.prefetch_invalidated, launches=counts)
    del eng
    free_device()
    return out


def _skewflip(n: int, hot: int, flip: int):
    return [simulator.skew_flip(n_regions=n, accesses_hot=hot, accesses_cold=hot // 10,
                                flip_window=flip, hot_first=first, name=name)
            for first, name in ((True, "early"), (False, "late"))]


def phase_mt_chain(fstats) -> dict:
    """Phase 2f's scheduled demand -> arbiter -> fleet report -> planner,
    on tests/test_frontend.py's arbiter (6T at alpha 0.5, the skew-flip pair
    of 128 regions, 8 windows, seed 7)."""
    what = "multitenant chain"
    names = ("early", "late")
    cfg = capacity.PlannerConfig("6t", alpha=0.5, fast_fraction=0.5)
    arb = capacity.build_arbiter(cfg, [arbiter.TenantSpec(n, sla_weight=1.0) for n in names],
                                 128)
    simulator.simulate_multitenant(_skewflip(128, 50_000, 4), arb, windows=8, warmup_windows=2,
                                   seed=7, prefetch=False)
    synthetic = arb.fleet_report(last_windows=6).tenant_demand_accesses
    windows = fstats.demand_by_window(names)
    fed = fstats.feed_arbiter(arb, names)
    report = arb.fleet_report(last_windows=6)
    want = tuple(float(np.mean([w.get(n, 0.0) for w in windows[-6:]])) for n in names)
    if fed != len(windows) or fed < 1 or report.tenant_demand_accesses != want:
        fail(f"{what}: fed {fed} windows; fleet report demand {report.tenant_demand_accesses}, "
             f"the fed windows' mean {want}")
    point = capacity.CapacityPlanner(capacity.get_server("v5e-base"),
                                     fleet_scale=64).evaluate(cfg.name, report)
    if point.servers < 1 or not 0.0 <= point.savings_pct <= 100.0:
        fail(f"{what}: planner point {point.to_dict()}")
    return {"windows_fed": fed, "tenant_demand_tokens": list(want),
            "synthetic_demand_accesses": list(synthetic), "planner_point": point.to_dict()}


def phase_mt_frontier() -> dict:
    """The capacity frontier twice (byte-equal, monotone, dominating 2T by
    at least DOMINANCE_FLOOR points) and the README's two-tenant run, timed
    on this host's clock. Savings and server counts are model outputs on the
    reference's server catalog, not measurements of this machine."""
    what = "multitenant frontier"
    f = FRONTIER
    planner = capacity.CapacityPlanner(capacity.get_server(f["server"]),
                                       operating_period_years=f["years"],
                                       fleet_scale=f["fleet_scale"])
    specs = [arbiter.TenantSpec(n, sla_weight=1.0) for n in ("early", "late")]
    texts, sweep_ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        res = capacity.sweep_frontier(lambda: _skewflip(f["n_regions"], f["accesses"], f["flip"]),
                                      specs, planner, windows=f["windows"],
                                      warmup_windows=f["warmup"], seed=f["seed"])
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
        texts.append(capacity.frontier_json(res))
    margin = res.get("dominance_margin_pct")
    if texts[0] != texts[1] or not res["monotone"] or not res.get("dominates_2t") \
            or margin is None or margin < DOMINANCE_FLOOR:
        fail(f"{what}: equal {texts[0] == texts[1]}, monotone {res['monotone']}, dominates 2T "
             f"{res.get('dominates_2t')} by {margin} (floor {DOMINANCE_FLOOR})")
    # The README's co-hosting example, each end_window timed.
    arb = arbiter.BudgetArbiter(
        [arbiter.TenantSpec("frontend", sla_weight=2.0, alpha_floor=0.2),
         arbiter.TenantSpec("batch", sla_weight=0.5)],
        [make_manager("6T-AM-0.5", 4096, seed=t) for t in range(2)], alpha=0.5,
        tier_capacity_regions=np.array([4096] + [np.inf] * 5))
    end_ms, end = [], arb.end_window

    def timed_end_window():
        t0 = time.perf_counter()
        plans = end()
        end_ms.append((time.perf_counter() - t0) * 1e3)
        return plans
    arb.end_window = timed_end_window
    t0 = time.perf_counter()
    sim = simulator.simulate_multitenant([simulator.gaussian_kv(n_regions=4096, name="frontend"),
                                          simulator.uniform_scan(n_regions=4096, name="batch")],
                                         arb, windows=40)
    sim_ms = (time.perf_counter() - t0) * 1e3
    return {"frontier_sha256": hashlib.sha256(texts[0].encode()).hexdigest(),
            "frontier_configs": [p["config"] for p in res["frontier"]],
            "dominance_margin_pct": margin, "monotone": res["monotone"],
            "model_outputs": {"baseline_2t": res["baseline_2t"], "frontier": res["frontier"]},
            "sweep_host_ms": sweep_ms, "readme_simulate_multitenant_host_ms": sim_ms,
            "readme_end_window_host_ms": {"mean": float(np.mean(end_ms)),
                                          "max": float(np.max(end_ms)), "windows": len(end_ms)},
            "readme_fleet_savings_pct_model": sim.fleet_savings_pct}


def phase_multitenant(cfg, model, params, fstats) -> dict:
    out = {"cache": phase_mt_cache(cfg), "engine": phase_mt_engine(cfg, model, params),
           "chain": phase_mt_chain(fstats), "frontier": phase_mt_frontier()}
    log(f"phase 2i ok (multi-tenancy, qwen1_5_4b full width): {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 2j
def moment_bytes_formula(params, policy) -> int:
    """The tiered state's bytes from the shapes alone: m and v in their
    codecs (int4's v at int8), each int8/int4 leaf with an f32 scale per
    group of ``group_for(last dim)`` along its padded last axis."""
    total = 0
    for path, p in pytree.leaves_with_path(params):
        for codec in (policy[path], "int8" if policy[path] == "int4" else policy[path]):
            if codec in ("none", "bf16"):
                total += p.numel() * (4 if codec == "none" else 2)
                continue
            last = p.shape[-1] if p.dim() else 1
            grp = tiered_adam.group_for(last)
            padded = -(-last // grp) * grp
            rows = p.numel() // last
            total += rows * padded // (1 if codec == "int8" else 2) + rows * (padded // grp) * 4
    return total


def _device_batch(batch_np) -> dict:
    return {k: torch.as_tensor(v, device=DEV) for k, v in batch_np.items()}


def train_optimizer() -> AdamWConfig:
    """examples/train_tiered_lm.py's optimizer at its default length."""
    return AdamWConfig(lr=TRAIN_LR, schedule=cosine_schedule(TRAIN_WARMUP, TRAIN_TOTAL))


def _train_setup(cfg):
    model = Model(cfg, ParallelConfig(), device=DEV)
    params = model.init(SEED)
    policy = tiered_adam.default_policy(params)
    opt = tiered_adam.init(params, policy)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    example = _device_batch(synthetic_corpus(dcfg, 0))
    step = make_train_step(model, train_optimizer(), ParallelConfig(), example,
                           tiered_policy=policy).fn
    return model, params, policy, opt, dcfg, step


def phase_train() -> dict:
    """Full-width, full-depth qwen1_5_4b train steps (see TRAIN_*)."""
    cfg = get("qwen1_5_4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, policy, opt, dcfg, step = _train_setup(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in pytree.leaves(params))
    want = moment_bytes_formula(params, policy)
    got = tiered_adam.moment_bytes(opt)
    if got != want:
        fail(f"train: moment_bytes {got} != its formula {want}")
    compressed = sorted(k for k, c in policy.items() if c != "none")
    if compressed != ["embed", "lm_head"]:
        fail(f"train: default_policy compresses {compressed}")
    loader = HostLoader(dcfg)
    try:
        same = _device_batch(next(loader))
        first = []
        for _ in range(2):
            params, opt, m = step(params, opt, same)
            first.append({k: float(v) for k, v in m.items()})
        if not first[1]["loss"] < first[0]["loss"]:
            fail(f"train: two steps on one batch did not descend: {first}")
        runs, times = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, _device_batch(next(loader)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            runs.append({k: float(v) for k, v in m.items()})
    finally:
        loader.close()
    bad = [r for r in first + runs if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]))]
    if bad:
        fail(f"train: non-finite loss or grad_norm: {bad}")
    step_ms = float(np.mean(times[1:]))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "setup_s": setup_s,
           "same_batch_losses": [r["loss"] for r in first],
           "losses": [r["loss"] for r in runs], "grad_norms": [r["grad_norm"] for r in runs],
           "step_ms": times, "step_ms_mean_2_n": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "moment_bytes": got, "moment_bytes_f32_baseline": n_params * 8,
           "param_bytes": sum(p.numel() * p.element_size() for p in pytree.leaves(params)),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "stragglers": loader.straggler_events}
    del model, params, opt, step
    free_device()
    return out


def _same_tree(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(pytree.leaves(a), pytree.leaves(b)))


def phase_train_resume() -> dict:
    """RESUME_STEPS straight against a save/restore halfway, at depth
    RESUME_LAYERS; the checkpoint round trip of the card's tensors must be
    bit-equal."""
    cfg = dataclasses.replace(get("qwen1_5_4b"), n_layers=RESUME_LAYERS)
    half = RESUME_STEPS // 2

    def losses(params, opt, step, start, n):
        out = []
        loader = HostLoader(dcfg, start_step=start)
        try:
            for _ in range(n):
                params, opt, m = step(params, opt, _device_batch(next(loader)))
                out.append(float(m["loss"]))
        finally:
            loader.close()
        return params, opt, out

    _, params, _, opt, dcfg, step = _train_setup(cfg)
    _, _, straight = losses(params, opt, step, 0, RESUME_STEPS)
    _, params, _, opt, _, step = _train_setup(cfg)
    params, opt, before = losses(params, opt, step, 0, half)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(half, {"params": params, "opt": opt}, blocking=False)
        save_call_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        _, fresh_params, _, fresh_opt, _, step = _train_setup(cfg)
        t0 = time.perf_counter()
        at, restored = mgr.restore({"params": fresh_params, "opt": fresh_opt})
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = sum(f.stat().st_size for f in Path(root).rglob("*") if f.is_file())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if at != half or not (_same_tree(restored["params"], params)
                          and _same_tree(restored["opt"], opt)
                          and restored["opt"].policy == opt.policy):
        fail("train resume: the restored state is not bit-equal to the saved one")
    if any(t.device.type != torch.device(DEV).type for t in pytree.leaves(restored)):
        fail("train resume: a restored leaf is not on the card")
    del params, opt, fresh_params, fresh_opt
    _, _, after = losses(restored["params"], restored["opt"], step, half, RESUME_STEPS - half)
    resumed = before + after
    worst = max(abs(a - b) / abs(a) for a, b in zip(straight, resumed))
    if not worst <= RESUME_RTOL or not all(np.isfinite(straight + resumed)):
        fail(f"train resume: losses {resumed} against {straight} (rel {worst})")
    out = {"layers": RESUME_LAYERS, "straight": straight, "resumed": resumed,
           "max_rel_diff": worst, "bit_equal": straight == resumed,
           "checkpoint_bytes": ckpt_bytes, "save_call_ms": save_call_ms,
           "save_ms": save_ms, "restore_ms": restore_ms}
    del restored, step
    free_device()
    return out


def phase_train_moe() -> dict:
    """One qwen3_moe_235b layer at full width (128 experts, top 8): a train
    step with the int8 wire on. The gradient reaching each wire's input is
    nonzero and finite, and the wire's backward on the card equals its CPU
    run on the cotangent the step gave the expert outputs' wire."""
    cfg = dataclasses.replace(get("qwen3_moe_235b"), n_layers=TRAIN_MOE_LAYERS)
    if not moe.A2A_WIRE_INT8:
        fail("train moe: the int8 wire is off")
    wire_in, wire_out = [], []
    make = moe.make_wire_transfer

    def spy():
        transfer = make()

        def f(x):
            if x.requires_grad:
                x.register_hook(lambda g: wire_in.append(g.detach()))
            y = transfer(x)
            if y.requires_grad:
                y.register_hook(lambda g: wire_out.append((x.detach(), g.detach())))
            return y
        return f

    moe.make_wire_transfer = spy
    try:
        torch.cuda.reset_peak_memory_stats()
        _, params, policy, opt, dcfg, step = _train_setup(cfg)
        loader = HostLoader(dcfg)
        try:
            batch = _device_batch(next(loader))
        finally:
            loader.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe.make_wire_transfer = make
    metrics = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"train moe: non-finite metrics {metrics}")
    grads_in = [float(g.float().abs().max()) for g in wire_in]
    if len(grads_in) != 2 * TRAIN_MOE_LAYERS or not all(np.isfinite(g) and g > 0
                                                        for g in grads_in):
        fail(f"train moe: expert-input gradients {grads_in}")
    x, g = wire_out[0]
    xc = x.cpu().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    (cpu_g,) = torch.autograd.grad(moe.make_wire_transfer()(xc), xc, g.cpu())
    (gpu_g,) = torch.autograd.grad(moe.make_wire_transfer()(xg), xg, g)
    if not torch.equal(gpu_g.cpu(), cpu_g):
        fail("train moe: the wire's backward on the card differs from the CPU's")
    out = {"arch": cfg.name, "layers": TRAIN_MOE_LAYERS, "metrics": metrics,
           "step_ms": step_ms, "wire_input_grad_max": grads_in,
           "wire_cotangent_shape": list(g.shape), "wire_backward_equal_to_cpu": True,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del params, opt, step, wire_in, wire_out, x, g, xg, gpu_g
    free_device()
    return out


def phase_training() -> dict:
    """Phase 2j: the training path, counting kernel launches from 0 (it
    launches none)."""
    spies = install_spies()
    reset_counts(spies)
    try:
        out = {"train": phase_train(), "resume": phase_train_resume(), "moe": phase_train_moe()}
        counts = read_counts(spies)
    finally:
        remove_spies(spies)
    if any(counts.values()):
        fail(f"train: the training path launched kernels: {counts}")
    out["launches"] = counts
    log(f"phase 2j ok (training): {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 2k
def check_example_kernels(eng: TieredEngine, spies) -> dict:
    """Phase 2 at the geometry the serving example's engine gives the
    kernels: ``eng.pt``-token pages, an ``eng.recent_window``-token window,
    ``eng.max_seq_len // eng.pt`` pages a sequence, ``eng.bs`` slots, the
    arch's heads. The fused kernel cuts the window into ``pt // 2``-token
    chunks, so its fills run 0, 1, one chunk, one chunk + 1, one short of
    full and full. The page kernels run at the run's largest page-out so far
    (bf16, as the cache hands it over, and f32): quant at int8 and int4, and
    its payloads through transcode both ways and dequant to f32 and bf16."""
    cfg, t, r = eng.cfg, eng.pt, eng.recent_window
    mp, kv, hd, h = eng.max_seq_len // t, cfg.n_kv_heads, cfg.head_dim_(), cfg.n_heads
    g = torch.Generator(device=DEV).manual_seed(SEED + 14)
    largest = spies["quant_pages"].largest
    if largest is None:
        fail(f"example {cfg.name}: no page-out by step {eng.stats.steps}")
    shape = largest[1]
    if shape[1:] != (t, kv, hd):
        fail(f"example {cfg.name}: page-out shape {shape}, expected [., {t}, {kv}, {hd}]")
    pages = torch.randn(shape, generator=g, device=DEV)
    errs = {"quant_pages": 0.0, "transcode_pages": 0.0, "dequant_pages": 0.0}
    for x in (pages.to(torch.bfloat16), pages):
        for bits in (8, 4):
            errs["quant_pages"] = max(errs["quant_pages"], check_quant(x, bits))
            pay, sc = ref.quant_kv_page(x, bits)
            errs["transcode_pages"] = max(errs["transcode_pages"],
                                          check_transcode(pay, sc, bits, 12 - bits))
            for out_dtype in (torch.float32, torch.bfloat16):
                errs["dequant_pages"] = max(errs["dequant_pages"],
                                            check_dequant(pay, sc, bits, out_dtype))
    n_valid = ((mp, mp * 2 // 3, mp // 4), (2, mp, mp // 2))
    fills = ((0, r), (1, t // 2), (t // 2 + 1, r - 1))
    errs["fused_tiered_attention"] = max(
        check_attention(attention_operands(g, eng.bs, h, kv, hd, mp, t, r, n_valid, rlen))
        for rlen in fills)
    log(f"phase 2k ok (example {cfg.name} at page [., {t}, {kv}, {hd}], window {r}, "
        f"{mp} pages a sequence, {eng.bs} slots, page-out {list(shape)}): kernels match their "
        f"plain versions, max abs err {errs}")
    return errs


def check_live_attention(eng: TieredEngine) -> float:
    """The fused kernel against its plain version on every attention layer
    of the engine's live state (its class buffers, unified table, host
    summaries and recent window, at its page and window sizes), one random
    q a layer, so no layer's input depends on another layer's output."""
    st, cfg = eng.cache.state, eng.cfg
    g = torch.Generator(device=DEV).manual_seed(SEED + 15)
    rlen = (st.recent_len + 1).to(torch.int32).contiguous()  # the step's new token
    err = 0.0
    for li in range(eng.la):
        layer, pools = layer_pools(st, li)
        host = {"summary": layer["host_summary"], "table": layer["host_table"],
                "n": layer["host_n"], "page_tokens": eng.pt}
        q = torch.randn((eng.bs, cfg.n_heads, cfg.head_dim_()), generator=g,
                        device=DEV).to(torch.bfloat16)
        (k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary, slot, tier, t, _) = \
            ops._unified_operands(q, pools, layer["recent_k"], host)
        err = max(err, check_attention((q, k8, s8k, v8, s8v, k4, s4k, v4, s4v, summary,
                                        layer["recent_k"], layer["recent_v"], slot, tier,
                                        rlen, t)))
    log(f"phase 2k ok (example {cfg.name}, step {eng.stats.steps}): the fused kernel matches "
        f"its plain version on all {eng.la} attention layers of the live state, max abs err "
        f"{err:.3g}")
    return err


def phase_example(cfg, params, extra=()) -> dict:
    """``serve_tiered_kv.run`` at ``cfg``'s width with the example's
    defaults (plus ``extra`` flags): every request served to its full
    length, the fused kernel launched once per attention layer and step (as
    billed), quant/transcode/dequant launched as often as the cache called
    them, page-outs handed over in bf16, and on the async path
    ``overlapped_steps`` above 0. Counts are reset before and read after.
    After EXAMPLE_COMPARE_STEP steps the run stops once for
    ``check_live_attention`` and ``check_example_kernels``; their launches,
    calls and seconds are taken out of the run's."""
    args = serve_tiered_kv.parser().parse_args(["--arch", cfg.name, *extra])
    what = f"example {cfg.name}" + "".join(f" {e}" for e in extra)
    lines = []
    free_device()
    resident = torch.cuda.memory_allocated()
    spies = install_spies()
    reset_counts(spies)
    checks = {}
    engine_step = TieredEngine.step

    def step(eng):
        engine_step(eng)
        if eng.stats.steps == EXAMPLE_COMPARE_STEP:
            t1 = time.perf_counter()
            launches, calls = build.launch_counts(), {n: spies[n].calls for n in SPIED}
            live = check_live_attention(eng)
            checks["kernels"] = check_example_kernels(eng, spies)
            checks["kernels"]["fused_tiered_attention"] = max(
                live, checks["kernels"]["fused_tiered_attention"])
            checks["live_attention_err"] = live
            torch.cuda.synchronize()
            build.LAUNCHES.update(launches)
            for n, c in calls.items():
                spies[n].calls = c
            checks["seconds"] = time.perf_counter() - t1

    torch.cuda.reset_peak_memory_stats()
    TieredEngine.step = step
    t0 = time.perf_counter()
    try:
        stats, reqs, eng, run_wall = serve_tiered_kv.run(cfg, args, DEV, params=params,
                                                         log=lines.append)
        torch.cuda.synchronize()
    finally:
        TieredEngine.step = engine_step
        remove_spies(spies)
    if "seconds" not in checks:
        fail(f"{what}: the run ended before step {EXAMPLE_COMPARE_STEP}; nothing was checked")
    wall = time.perf_counter() - t0 - checks["seconds"]
    run_wall -= checks["seconds"]
    counts = read_counts(spies)
    for line in lines:
        log(f"  [{what}] {line}")
    log(f"  [{what}] the printed wall holds {checks['seconds']:.2f} s of the step-"
        f"{EXAMPLE_COMPARE_STEP} checks, taken out of wall_s and run_wall_s")
    if stats.completed != args.requests or not all(
            r.done and len(r.out_tokens) == args.new_tokens for r in reqs):
        fail(f"{what}: not every request completed: {stats.completed}/{args.requests}")
    check_counts(counts, what)
    check_bf16_page_out(spies, what)
    if counts["fused_tiered_attention"] != stats.attn_launches or \
            stats.attn_launches != eng.la * stats.steps:
        fail(f"{what}: fused_tiered_attention launched {counts['fused_tiered_attention']} times, "
             f"billed {stats.attn_launches}, expected {eng.la} x {stats.steps} steps")
    if (stats.overlapped_steps > 0) == bool(args.serial_migration):
        fail(f"{what}: overlapped steps {stats.overlapped_steps} on the "
             f"{'serial' if args.serial_migration else 'async'} path")
    out = {"arch": cfg.name, "flags": list(extra), "wall_s": wall, "run_wall_s": run_wall,
           "engine_steps": stats.steps, "windows": stats.windows,
           "migrations": stats.migrations, "overlapped_steps": stats.overlapped_steps,
           "prefetch_staged": stats.prefetch_staged, "prefetch_hits": stats.prefetch_hits,
           "decode_ms_per_step": stats.decode_s / max(stats.steps, 1) * 1e3,
           "prefill_ms_per_request": stats.prefill_s / args.requests * 1e3,
           "tco_savings_pct": stats.tco_savings_pct,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "resident_before_bytes": resident, "launches": counts,
           "check_s": checks["seconds"], "live_attention_err": checks["live_attention_err"],
           "kernel_errs": checks["kernels"],
           "first_tokens": [r.out_tokens[:12] for r in reqs[:2]]}
    shown = {k: v for k, v in out.items() if k != "first_tokens"}
    log(f"phase 2k ok ({what}): {json.dumps(shown)}")
    return out


def phase_dense_steps(cfg, model, params) -> dict:
    """The dense serve steps at full width: ``make_prefill_step`` on
    DENSE_BATCH x DENSE_PROMPT tokens (``Model.forward``'s last logits)
    matches ``Model.prefill``'s last logits (its own layer loop, filling a
    DENSE_MAX_LEN dense cache) within DECODE_VS_FORWARD, and DENSE_DECODE
    steps of ``make_decode_step`` on the next tokens match the forward over
    prompt + those tokens within it. No kernel of the port runs (counted)."""
    mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
    par = ParallelConfig()
    g = np.random.default_rng(SEED + 11)
    tokens = torch.as_tensor(g.integers(1, cfg.vocab_size,
                                        (DENSE_BATCH, DENSE_PROMPT + DENSE_DECODE)), device=DEV)
    prompt = {"tokens": tokens[:, :DENSE_PROMPT]}
    build.reset_launch_counts()
    with torch.no_grad():
        fn, _ = serve.make_prefill_step(model, mesh, par)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = fn(params, prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step = serve.make_decode_step(model, mesh, par, DENSE_BATCH, DENSE_MAX_LEN)
        state = model.init_cache(DENSE_BATCH, DENSE_MAX_LEN)
        filled, state = model.prefill(params, prompt, state)
        if not torch.isfinite(last).all():
            fail("prefill step: logits are not finite")
        prefill_err = float((last.float() - filled[:, -1].float()).abs().max())
        if prefill_err >= DECODE_VS_FORWARD:
            fail(f"prefill step vs Model.prefill: max diff {prefill_err} "
                 f"(bar {DECODE_VS_FORWARD})")
        outs, times = [], []
        for i in range(DENSE_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, state = step.fn(params, tokens[:, DENSE_PROMPT + i:DENSE_PROMPT + i + 1], state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(lg)
        forward = model.forward(params, {"tokens": tokens})[0][:, DENSE_PROMPT:]
    dec = torch.cat(outs, 1).float()
    if not torch.isfinite(dec).all():
        fail("decode step: logits are not finite")
    err = float((dec - forward.float()).abs().max())
    launched = sum(build.launch_counts().values())
    if err >= DECODE_VS_FORWARD or launched:
        fail(f"decode step vs teacher-forced forward: max diff {err} (bar {DECODE_VS_FORWARD}), "
             f"{launched} kernel launches")
    out = {"prefill_shape": [DENSE_BATCH, DENSE_PROMPT], "prefill_step_ms": prefill_ms,
           "decode_steps": DENSE_DECODE, "max_len": DENSE_MAX_LEN,
           "prefill_vs_model_prefill_max_diff": prefill_err,
           "decode_ms_per_step": float(np.median(times)), "decode_vs_forward_max_diff": err,
           "max_abs_logit": float(forward.float().abs().max()),
           "greedy_equal": bool((dec.argmax(-1) == forward.float().argmax(-1)).all())}
    log(f"phase 2k ok (dense serve steps): {json.dumps(out)}")
    return out


def _striped(pool: dict, shards: int) -> dict:
    """``pool`` laid out for ``shards`` model shards of its table's columns:
    the pages of shard j's columns copied to shard j's rows of a new pool
    (global id l * shards + j at physical row j * rows + l), the table
    rewritten to those ids. The valid prefix is unchanged."""
    table = pool["page_table"]
    cols = table.shape[1] // shards
    uniq = [torch.unique(table[:, j * cols:(j + 1) * cols]) for j in range(shards)]
    rows = max(u.numel() for u in uniq)
    src = torch.cat([torch.cat([u, u[:1].expand(rows - u.numel())]) for u in uniq])
    new = torch.empty_like(table)
    for j, u in enumerate(uniq):
        part = table[:, j * cols:(j + 1) * cols]
        local = torch.searchsorted(u, part.contiguous()).to(table.dtype)
        new[:, j * cols:(j + 1) * cols] = local * shards + j
    out = {k: pool[k][src.long()] for k in ("k_pages", "k_scales", "v_pages", "v_scales")}
    return dict(out, page_table=new.contiguous(), n_pages=pool["n_pages"])


def phase_sp(state, h: int) -> dict:
    """``make_sp_pool_attention`` on layer SP_LAYER's warm and cold pools of
    a mid-run state: on a one-device mesh one per-pool launch + the merge,
    byte-equal to ``paged_quant_attention`` and timed beside it; on an
    abstract (1, 2) mesh (the pool re-laid for two model shards, run in
    turn) within ATTN_TOL of the plain version of the unsharded pool with
    each shard's global slot positions (masses) and whole (the normalized
    output and log-sum-exp)."""
    _, pools = layer_pools(state, SP_LAYER)
    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    b = pools["warm"]["page_table"].shape[0]
    hd = pools["warm"]["k_pages"].shape[-1]
    q = torch.randn((b, h, hd), generator=g, device=DEV).to(torch.bfloat16)
    one = serve.make_sp_pool_attention(make_mesh((1, 1), ("data", "model"), device=DEV),
                                       ("data",))
    two = serve.make_sp_pool_attention(make_abstract_mesh((1, 2), ("data", "model")),
                                       ("data",))
    out = {}
    build.reset_launch_counts()
    for name, pool in pools.items():
        bits = pool["bits"]
        got = one(q, pool, bits)
        torch.cuda.synchronize()
        launches = build.launch_counts()["paged_quant_attention"]
        want = pa.paged_quant_attention(q, pool["k_pages"], pool["k_scales"], pool["v_pages"],
                                        pool["v_scales"], pool["page_table"], pool["n_pages"],
                                        bits)
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            fail(f"sp attention ({name}, one device): not byte-equal to the per-pool kernel")
        sp2 = _striped(pool, 2)
        o2, m2, l2, mass2, base2 = two(q, sp2, bits)
        cols = pool["page_table"].shape[1] // 2
        errs = []
        for j in range(2):
            sl = slice(j * cols, (j + 1) * cols)
            pos = torch.arange(j * cols, (j + 1) * cols, dtype=torch.int32, device=DEV)
            w = ref.paged_quant_attention(q, pool["k_pages"], pool["k_scales"],
                                          pool["v_pages"], pool["v_scales"],
                                          pool["page_table"][:, sl].contiguous(),
                                          pool["n_pages"], bits, slot_pos=pos[None].expand(b, cols))
            errs += [float((mass2[:, sl] - w[3]).abs().max()), float((base2[:, sl] - w[4]).abs()
                                                                     .max())]
        w = ref.paged_quant_attention(q, pool["k_pages"], pool["k_scales"], pool["v_pages"],
                                      pool["v_scales"], pool["page_table"], pool["n_pages"], bits)
        live = w[2] > 0
        d_out = o2 / l2.clamp_min(1e-30)[..., None] - w[0] / w[2].clamp_min(1e-30)[..., None]
        d_lse = (m2 + l2.clamp_min(1e-30).log()) - (w[1] + w[2].clamp_min(1e-30).log())
        errs += [float(torch.where(live[..., None], d_out, 0.0).abs().max()),
                 float(torch.where(live, d_lse, 0.0).abs().max())]
        if max(errs) > ATTN_TOL:
            fail(f"sp attention ({name}, two shards in turn) vs plain with slot positions: "
                 f"max diff {max(errs)} > {ATTN_TOL}")
        args = (q, pool["k_pages"], pool["k_scales"], pool["v_pages"], pool["v_scales"],
                pool["page_table"], pool["n_pages"], bits)
        out[name] = {"launches": launches, "two_shard_max_diff": max(errs),
                     "valid_pages": int(pool["n_pages"].sum()),
                     "ms": time_ms(lambda: one(q, pool, bits)),
                     "kernel_ms": time_ms(lambda: pa.paged_quant_attention_launch(*args)),
                     "two_shard_ms": time_ms(lambda: two(q, sp2, bits))}
        build.reset_launch_counts()
    launches = sum(o["launches"] for o in out.values())
    if launches != len(pools):
        fail(f"sp attention launched the per-pool kernel {launches} times for {len(pools)} pools")
    log(f"phase 2k ok (sp pool attention, layer {SP_LAYER}): {json.dumps(out)}")
    return {"pools": out, "launches": launches}


def cxl_encode_hd128(errs) -> dict:
    """``cxl_encode_pages`` at CXL_ENCODE_HD128 in bf16 and f32: byte-equal
    to its plain version, timed beside it, with its bound (each input read
    once; payload, scales and line widths written once; 7 operations an
    element), as ``scripts/row_group_times.py`` times it."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        pages = torch.randn(CXL_ENCODE_HD128, generator=g, device=DEV).to(dtype)
        errs["cxl_encode_pages"] = max(errs["cxl_encode_pages"], check_cxl_encode(pages))
        n = pages.numel()
        bound, by = bound_ms(n * pages.element_size() + n + n // pages.shape[-1] * 4
                             + n // ref.CXL_LINE_ELEMS * 4, 7 * n)
        out["bf16" if dtype == torch.bfloat16 else "f32"] = {
            "ms": time_ms(lambda: cxl_line.cxl_encode_pages(pages)),
            "plain_ms": time_ms(lambda: ref.cxl_encode_kv_page(pages)),
            "bound_ms": bound, "bound_by": by, "shape": list(CXL_ENCODE_HD128)}
    log(f"phase 2k ok (cxl_encode_pages at hd=128): {json.dumps(out)}")
    return out


def phase_dryrun() -> dict:
    """The dry-run of DRYRUN_ARCH x its cells, in this process on ``meta``
    after the card's timed phases (no kernel runs): each cell's roofline
    terms on this card's ``analysis.device_spec()``."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    cells = {}
    try:
        for shape in cells_for(DRYRUN_ARCH):
            d = dryrun.run_cell(DRYRUN_ARCH, shape, "h100x1", out_dir)
            cells[shape] = {k: d[k] for k in (
                "kind", "flops_pd", "bytes_pd", "compute_s", "memory_s", "collective_s",
                "bottleneck", "args_bytes_pd", "fits_hbm", "model_flops", "useful_ratio",
                "step_time_s", "roofline_fraction", "device", "build_s", "count_s", "notes")}
            log(f"  dry-run {DRYRUN_ARCH} x {shape}: compute {d['compute_s']:.4e} s, memory "
                f"{d['memory_s']:.4e} s, collective {d['collective_s']} s -> {d['bottleneck']}; "
                f"args {d['args_bytes_pd']:.4e} B (fits {d['fits_hbm']} in {d['device']})")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out = {"cells": cells,
           "build_and_count_s": sum(c["build_s"] + c["count_s"] for c in cells.values())}
    log(f"phase 2k ok (dry-run {DRYRUN_ARCH} on the host: {out['build_and_count_s']:.1f} s of "
        f"building and counting)")
    return out


def reckon_memory(cfg, params, eng) -> dict:
    """Bytes of this run's weights and tiered KV state, from their sizes, and
    what full depth would need: layer weights scale with depth, the class
    buffers with its square (each layer's slice holds every layer's rows)."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    st = eng.cache.state
    kv = sum(t.numel() * t.element_size() for t in (getattr(st, f.name)
                                                    for f in dataclasses.fields(st))
             if isinstance(t, torch.Tensor))
    blocks = nbytes(params["blocks"])
    rest = nbytes(params) - blocks
    scale = get(cfg.name).n_layers / cfg.n_layers
    return {"weights_bytes": blocks + rest, "kv_state_bytes": kv,
            "full_depth_weights_bytes": int(blocks * scale + rest),
            "full_depth_kv_state_bytes": int(kv * scale * scale)}


def init_params(cfg):
    model = Model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    log(f"init {cfg.name}: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params, "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()  # free an engine's class buffers before the next


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls = {}
    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[phase] = time.perf_counter() - t0
        log(f"phase {phase} took {walls[phase]:.1f} s")
        return out

    cfg, zcfg = get("qwen1_5_4b"), get("zamba2_1_2b")
    q3cfg = dataclasses.replace(get("qwen3_32b"), n_layers=QWEN3_LAYERS)
    mcfg = dataclasses.replace(get("qwen3_moe_235b"), n_layers=MOE_LAYERS)
    smi = timed("1", phase_build)
    t0 = time.perf_counter()
    errs = phase_compare(cfg)
    zerrs = phase_compare(zcfg)
    for name in ("cxl_encode_pages", "cxl_decode_pages"):
        zerrs[name] = max(zerrs[name], errs[name])
    # The GQA page shape [., 16, 8, 128] at H=64 (qwen3_32b, command_r_35b)
    # and H=48 (internlm2_20b, dbrx_132b); [., 16, 4, 128] at H=64
    # (qwen3_moe_235b, group 16).
    q3errs = phase_compare(q3cfg)
    for name, e in phase_compare(get("internlm2_20b")).items():
        q3errs[name] = max(q3errs[name], e)
    merrs = phase_compare(mcfg)
    walls["2"] = time.perf_counter() - t0

    # Training first, on an empty card and before any profile (phase 7).
    training = timed("2j", phase_training)

    # The GQA, MoE and VLM archs first, on an empty card (phases 2b, 2g);
    # the encoder, the SSM family, preemption and the frontend (phases 2h,
    # 2d-2f) before the qwen3_32b engine takes its ~40 GB for the rest of
    # the run.
    one_step = timed("2b", lambda: {name: phase_one_step(name) for name in ONE_STEP_ARCHS})
    moe_metrics, moe_counts, mrows = timed("2g", phase_moe, mcfg, merrs)
    hubert = timed("2h", phase_hubert)
    t0 = time.perf_counter()
    mamba2 = phase_mamba2()
    model, params = init_params(cfg)
    preempt = phase_preempt(cfg, model, params)
    frontend, fstats = phase_frontend(cfg, model, params)
    new_phases_s = time.perf_counter() - t0
    walls["2d-2f"] = new_phases_s
    log(f"phases 2d-2f took {new_phases_s:.1f} s")
    multitenant = timed("2i", phase_multitenant, cfg, model, params, fstats)
    del fstats
    free_device()

    # Phase 2k (a, b): the serving example at full width (the qwen1_5_4b
    # weights stay; zamba2_1_2b's are made for its run), the dense steps.
    t0 = time.perf_counter()
    examples = {}
    for arch, extra in EXAMPLE_RUNS:
        if arch == cfg.name:
            examples[arch + "".join(extra)] = phase_example(cfg, params, extra)
        else:
            _, xparams = init_params(get(arch))
            examples[arch + "".join(extra)] = phase_example(get(arch), xparams, extra)
            del xparams
            free_device()
    for e in examples.values():  # the example-geometry checks join phase 2's errors
        into = zerrs if e["arch"] == zcfg.name else errs
        for name, err in e["kernel_errs"].items():
            into[name] = max(into[name], err)
    for name in ("fused_tiered_attention", "quant_pages", "transcode_pages", "dequant_pages"):
        if not sum(e["launches"][name] for e in examples.values()):
            fail(f"serving example: {name} was launched no time in {list(examples)}")
    dense_steps = phase_dense_steps(cfg, model, params)
    del model, params
    free_device()
    walls["2k"] = time.perf_counter() - t0
    log(f"phase 2k (serving example, dense steps) took {walls['2k']:.1f} s")
    t0 = time.perf_counter()
    q3model, q3params = init_params(q3cfg)
    (q3eng, q3counts, q3pp_counts, q3metrics, q3spies, q3state, q3compares,
     _) = phase_async(q3cfg, q3model, q3params, phase="2c")
    q3metrics["reckoned"] = reckon_memory(q3cfg, q3params, q3eng)
    log(f"phase 2c memory (qwen3_32b at {QWEN3_LAYERS} of {get('qwen3_32b').n_layers} layers): "
        f"reckoned {json.dumps(q3metrics['reckoned'])}, measured peak "
        f"{q3metrics['peak_memory_bytes']} bytes on a card of "
        f"{torch.cuda.get_device_properties(0).total_memory} bytes")
    q3rows = {k["name"]: k for k in phase_times(q3eng, q3counts, q3pp_counts, q3spies, q3state,
                                                 q3errs)}
    free_device()
    walls["2c"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # qwen1_5_4b: the dense path, serial and async (phases 3-5), with the
    # qwen3_32b engine resident (counted out of its peak memory).
    held = torch.cuda.memory_allocated()
    model, params = init_params(cfg)
    serial_metrics, serial_counts, serial_step = phase_serial(cfg, model, params)
    free_device()
    same_alpha, _, _ = phase_serial(cfg, model, params, alpha=ASYNC_ALPHA, compare=False)
    free_device()
    eng, counts, pp_counts, async_metrics, spies, state, compares, _ = phase_async(
        cfg, model, params)
    for m in (serial_metrics, same_alpha, async_metrics):
        m["peak_memory_bytes"] -= held
        m["peak_memory_note"] = "above the qwen3_32b engine left resident"
    modes = phase_modes(cfg)
    kernels = phase_times(eng, counts, pp_counts, spies, state, errs)
    t1 = time.perf_counter()
    sp = phase_sp(state, cfg.n_heads)  # phase 2k (c), on phase 3's mid-run state
    cxl128 = cxl_encode_hd128(errs)
    walls["2k_sp"] = time.perf_counter() - t1
    free_device()
    walls["3-5"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # zamba2_1_2b: the hybrid path with its host tiers on cxl_hw (phase 6).
    # The engines stay resident for the profiles, which come last (the
    # profiler's tracing is not to touch any timed run), so the zamba2 run's
    # peak memory is counted above what is allocated before its weights.
    held = torch.cuda.memory_allocated()
    zmodel, zparams = init_params(zcfg)
    zeng, zcounts, zpp_counts, zmetrics, zspies, zstate, zcompares, encoder = phase_async(
        zcfg, zmodel, zparams, host_media_device="cxl_hw", phase="6")
    zmetrics["peak_memory_bytes"] -= held
    zmetrics["peak_memory_note"] = "above the qwen3_32b and qwen1_5_4b engines left resident"
    zrows = {k["name"]: k for k in phase_times(zeng, zcounts, zpp_counts, zspies, zstate,
                                                zerrs, encoder)}
    walls["6"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = phase_profile(eng, state)
    zprof = phase_profile(zeng, zstate)
    q3prof = phase_profile(q3eng, q3state)
    gprof = phase_profile(eng, state, captured=True)
    zgprof = phase_profile(zeng, zstate, captured=True)
    q3gprof = phase_profile(q3eng, q3state, captured=True)
    walls["7"] = time.perf_counter() - t0
    # Phase 2k (d): the dry-run on the host, after every timed phase.
    dryrun_cells = timed("2k_dryrun", phase_dryrun)
    # Kernels 1-5 carry their hd=64 (zamba2), qwen3_32b and qwen3_moe_235b
    # numbers beside the hd=128 (qwen1_5_4b) ones; 6-7 run only on the
    # zamba2 path.
    fields = ("launches", "max_abs_err", "max_bf16_ulps", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "shape", "floor_ms", "f32", "int8")
    for k in kernels:
        for key, rows in (("at_hd64", zrows), ("at_qwen3_32b", q3rows),
                          ("at_qwen3_moe_235b", mrows)):
            z = rows.pop(k["name"], None)  # a glue kernel another step does not run
            if z is not None:
                k[key] = {f: z[f] for f in fields if f in z}
    kernels += list(zrows.values())
    # Launches on the preemption (2e), frontend (2f), MoE (2g), one-step
    # (2b) and multi-tenant (2i) paths, each counted from 0 over its own run.
    for k in kernels:
        k["preempt_launches"] = preempt["launches"][k["name"]]
        k["frontend_launches"] = frontend["launches"][k["name"]]
        k["multitenant_launches"] = multitenant["engine"]["launches"][k["name"]]
        k["multitenant_cache_launches"] = multitenant["cache"]["launches"][k["name"]]
        k["moe_launches"] = moe_counts[k["name"]]
        k["one_step_launches"] = {a: o["launches"][k["name"]] for a, o in one_step.items()}
        k["train_launches"] = training["launches"][k["name"]]
        k["example_launches"] = {r: e["launches"][k["name"]] for r, e in examples.items()}
        k["sp_launches"] = sp["launches"] if k["name"] == "paged_quant_attention" else 0
        if k["name"] == "cxl_encode_pages":
            k["at_hd128"] = cxl128
    log(json.dumps({"card": smi, "engine": {"async": async_metrics, "serial": serial_metrics,
                                            "serial_same_alpha": same_alpha,
                                            "zamba2_cxl_hw": zmetrics,
                                            "qwen3_32b": q3metrics},
                    "launches": {"async": counts, "per_pool": pp_counts,
                                 "serial": serial_counts, "zamba2_cxl_hw": zcounts,
                                 "zamba2_per_pool": zpp_counts, "qwen3_32b": q3counts,
                                 "qwen3_32b_per_pool": q3pp_counts},
                    "step_compare": {"serial": serial_step, **compares,
                                     **{f"zamba2_{k}": v for k, v in zcompares.items()},
                                     **{f"qwen3_32b_{k}": v for k, v in q3compares.items()}},
                    "one_step": one_step, "mamba2_780m": mamba2, "preempt": preempt,
                    "frontend": frontend, "phases_2d_2f_s": new_phases_s,
                    "multitenant": multitenant, "training": training,
                    "qwen3_moe_235b": moe_metrics, "hubert_xlarge": hubert,
                    "serving_example": examples, "dense_serve_steps": dense_steps,
                    "sp_pool_attention": sp, "dryrun": dryrun_cells,
                    "phase_wall_s": walls,
                    "modes": modes, "decode_step_profile": prof,
                    "zamba2_decode_step_profile": zprof,
                    "qwen3_32b_decode_step_profile": q3prof,
                    "decode_step_profile_captured": gprof,
                    "zamba2_decode_step_profile_captured": zgprof,
                    "qwen3_32b_decode_step_profile_captured": q3gprof,
                    "smoke_wall_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
