#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (``--only a,b`` runs a subset, named as in ``PHASES``); any
failure raises and the script exits non-zero:

1. build   -- compile every CUDA kernel of the serving and training paths
              from ``src/repro_torch/csrc`` (one nvcc per source, all
              started together) and print the card's name and power limit.
2. kernels -- each kernel against its plain PyTorch version at its path's
              shapes (serving: f32 and bf16, plus flash at the training
              shape; training: every bucket of the 4-layer llama3-8b plans,
              f32, and bf16 W for each fused update; the power iteration
              also at online_pca's k' = rank on every bucket; the 2-D fused
              projection, which no path runs, at two shapes of its own),
              within the tolerances in ``TOL``; paged decode also on a
              bandwidth case of 32 slots of 1024 + 64 i tokens on shuffled
              pages (264 MB of K/V, more than L2), each paged case
              recording the design and cluster size it took (bf16 must
              take the tensor cores); then its device time per
              call (torch.profiler) beside its plain version's, a PyTorch
              yardstick's (``LIBRARY_CALL`` says what it covers), and its
              bound on the H100 (bytes over 3.35 TB/s or operations over
              the dtype's peak, whichever is larger).  ``call_ms`` adds the
              host's launch time; flash cases record which of its two
              designs ran (bf16 must take the tensor cores).
3. serve   -- full-width llama3-8b (4 of its 32 layers, ``SERVE_LAYERS``,
              bf16, seeded random weights) through
              ``ContinuousEngine(max_slots=4, page_size=16)``: 8 requests,
              prompts of 64..1024 tokens, 32 new tokens each, staggered
              arrivals and a pool too small for four long
              requests, so admission waits, pages recycle and every slot
              turns over.  Checks every request's budget, the drained pool
              and each kernel's launch count; then request 0's prefill and
              first decode-step logits on the paged kernel path against the
              static engine's ring cache with plain exact attention.
4. train   -- full-width llama3-8b cut to 1 layer (``TRAIN_RUN_LAYERS``;
              4, the kernel cases' plans, until the FSDP paths joined, 2
              until the other families' TP and FSDP paths joined; f32
              params, grads and full-rank Adam state for all 32 layers
              come to ~75 GB before activations), bf16 compute, on ``engine="bucketed"`` with
              ``svd_backend="randomized"`` and the launcher's defaults
              (rank 512, tau 200, alpha 0.25, lr 0.01, warmup 100), seq
              512, batch 8, 3 steps through ``train_loop``: a refresh at
              step 0, then 2 hot steps.  Once per optimizer of
              ``TRAIN_RUNS``: ``galore-sara-adam`` (path ``train``),
              ``-msgd``, ``-adam-mini`` and ``-adam8bit`` (paths
              ``train_msgd``, ``train_adam_mini``, ``train_adam8bit``);
              the paper's baselines ``golore-adam``, ``grass-adam`` and
              ``online-pca-adam`` on the same buckets (``train_golore``,
              ``train_grass``, ``train_online_pca``), and ``fira-sara-adam``
              and ``galore-sara-adafactor`` on per-leaf state (``train_fira``,
              ``train_adafactor``) beside ``galore-sara-adam`` on the
              reference engine (``train_adam_reference``), the same per-leaf
              loop.  Checks the bucket plan (sides included) or the per-leaf
              state, finite losses (the first near ln(vocab)), each
              kernel's exact launch count, and on the bucket-native paths,
              on one more hot step, each bucket's R and the inner's update
              (W' and its state) from the kernels against the plain
              versions on the same stacks, one bucket at a time; then
              profiles one hot step (device busy share, time by kernel).
4b. train_recovery -- ``galore-sara-adam`` as in 4, cut to
              ``RECOVERY_LAYERS`` (1) layer, under the launcher's
              default ``RecoveryPolicy`` (no backoff) with heartbeats and a
              ``FaultPlan``, 8 steps: steps 0-2 as in 4, the pinned step-0 save, a NaN
              gradient at step 3 (skipped: per-leaf bit-pattern checksums
              of params and state equal before and after, ``skipped`` 1),
              NaN losses at steps 5-7 (a rollback to the pin with resample:
              the replayed refresh's sara projectors overlap the first's
              by < 1 per bucket), the replay to step 8 (finite losses, one
              skip and one rollback counted, exact launch counts); then
              gated and ungated hot steps in turns from the final state,
              and the check's own device time.
4c. train_rank_schedule -- ``galore-sara-adam`` as in 4 at tau 2 with the schedule
              ``step:512:256@0.5`` over 6 steps: the refresh at step 2
              re-buckets from rank 512 to 256 (one ``rebucket`` record),
              steps 3-5 run at 256; checks the plan at both ranks, the
              launch counts of each geometry, and on one more hot step at
              256 each bucket's R and W', M', V' from kernels 4 and 5
              against the plain versions; prints the hot-step ms at each
              rank and the re-bucket event's ms.  The kernel phase also
              holds kernels 4, 5 and 9 at ranks 256 and 264 (k' 1032 and
              1064; 264 = 8 mod 16 leaves the f32 tile engine a ragged
              last K tile) on the mlp bucket's shape.
5. resume  -- train -> checkpoint -> resume -> serve, on the same model
              cut to ``RESUME_LAYERS`` (1) layer, with ``galore-sara-adam``
              at tau 2 (refreshes at steps 0, 2 and 4) on the zipf corpus, seq 512, batch 8, each run in
              new objects and freeing the card before the next: C trains 5
              steps uninterrupted, prints each low-rank leaf's adjacent
              subspace overlap at refreshes 2 and 4 (``track_subspace``),
              saves a blocking checkpoint at step 3 under ``build/`` (after
              checking that twice its size is free on the disk) and keeps a
              host copy of its step-3 state; B resumes from that checkpoint
              to step 5 (path ``resume``).  Fails unless B's restored state
              equals C's host copy bit for bit, B's batches and step-4 draws
              equal C's bit for bit, and B's losses equal C's within
              ``RESUME_LOSS_RTOL``.  Then ``load_params_latest`` fills a
              bf16 serving skeleton from the checkpoint, which must equal
              ``serving_params`` of C's step-3 f32 params bit for bit, and
              a ``ContinuousEngine`` serves 4
              requests from it (path ``serve_ckpt``) with the same tokens as
              on the in-memory params.  Prints the checkpoint's bytes, save
              and load seconds and GB/s, peak host RSS and each run's
              ``max_memory_allocated``, with the card's name and power limit.
5b. train_dp -- data-parallel training through ``torch.distributed``:
              one process per card (``torch.cuda.device_count()``; 1 on a
              one-card machine) on a file store under ``build/``, NCCL.
              Each runs phase 4's model (at ``DP_LAYERS`` = 2 of its 4
              layers since the tensor-parallel phase joined; seq 512, global batch
              8, ``galore-sara-adam``, rank 512) without clipping
              (``DP_OPT``) for 3 steps, first single-process (the
              reference, its params kept on the host), then through
              ``make_train_step(mesh=..., compressed="flat")`` with
              replicated state, and with ZeRO state (``state_shards`` =
              world) where the world has more than one process: each
              step's params against the reference's (the Adam update's
              ``TOL`` at world 1; ``DP_REFRESH_TOL`` and f32 compute
              above), the bytes handed to the collectives per refresh
              and per hot step equal to ``dp_comm_model``'s, kernels 4
              and 5 once per bucket in each hot step, exact launch
              counts; a NaN gradient in the last process's share,
              skipped by every process with its state unchanged.  In one
              process: a standard step at 4 shards against the
              replicated state's, the 4-shard stacks saved by four
              emulated writers and restored at 2 and 8 shards bit-equal
              (save and load s, GB/s); kernels 4-8 on a ``narrow`` of a
              padded stack, a block of real rows and a block of pad rows
              (``DP_PAD_SHAPE``), each kernel launched once a case.  The
              first process then runs a world of 4 ranks as threads on
              its card (``_dp_emulated``, ``DP_EMU_*``: LLaMA-60M's widths
              at 5 layers), replicated and ZeRO at 4 shards, so the
              shard-local step (reduce-scatter, projector gather, the
              fused update on each rank's rows, pad rows included, the W'
              gather) runs on the card: params equal on every rank, ZeRO
              against replicated and both against the single-process
              step, bytes against ``dp_comm_model``'s, exact launches,
              a NaN in one rank's share skipped by all.
5c. train_tp -- two processes sharing the card over gloo (NCCL refuses
              two ranks on one device), so no time here is a parallel
              speed: llama3-8b at full width cut to 1 layer and
              deepseek-moe-16b cut to 1, first tensor and expert parallel
              on a (1, 2) mesh (paths ``train_tp``, ``train_tp_moe``),
              then FSDP over ``data`` on a (2, 1) mesh of the same
              processes (``train_fsdp``, ``train_fsdp_moe``): each against
              the single-process run and its state (the constants at
              ``TP_WORLD``).
5e. train_tp_families -- the same, for mamba2-370m, hymba-1.5b,
              whisper-medium and llava-next-34b at full width and 1 layer
              (1 + 1): paths ``train_tp_<family>`` at (1, 2) and
              ``train_fsdp_<family>`` at (2, 1), and mamba2's whole-mixer
              route at (1, 2), ``train_tp_ssm_whole`` (the constants at
              ``TPF_RUNS``).
5f. train_tp_inners -- the same two processes' world for qwen2-1.5b at
              full width and 1 layer: every optimizer under tensor
              parallelism at (1, 2) (paths ``train_tp_<optimizer>``), the
              loop under a rank schedule with the spectrum logger and
              ``track_subspace`` (``train_tp_loop``), and ZeRO state on the
              FSDP step at (2, 1) (``train_fsdp_zero``,
              ``train_fsdp_zero_adam8bit``); the constants at ``TPI_RUNS``.
5g. train_fault_world -- the multi-process fault harness: two processes
              sharing the card over gloo train LLaMA-60M at full width (seq
              256, batch 32, rank 128, tau 4) on the compressed step with
              ZeRO state and shard-parallel checkpoints every 4 steps; phase
              1 injects a straggler at step 5, a corrupt shard in the step-8
              save and rank 1's death at step 9 (rank 0 must fail in its next
              collective, naming step 9, within ``FW_EXIT_BAR_S``); phase 2
              restarts the world, which resumes at step 4 past the corrupt
              checkpoint and rolls back once in lockstep on NaN gradients in
              one rank's share at steps 9-11, to step 12; phase 3, at world
              1 in this process, loads step 12 at 1 shard bit-equal to a
              replicated save and takes one compressed step.  Exact launches
              per rank and step call; the seconds of the start-up (during
              the phase before), the steps, the kill's detection, the
              restart, the save and the load.
5h. dryrun -- ``launch/dryrun.py`` on the meta device, held to the paths
              that ran: its state bytes equal ``train``'s (llama3-8b at 1
              layer), a ``train_tp`` rank's and ``train_tp_inners``' ZeRO
              ranks' ``state_memory_bytes``, and its params + gradients +
              state sit at or below each one's max_memory_allocated; then
              whether full-depth llama3-8b and llava-next-34b fit 4 cards
              (TP (1, 4), FSDP (4, 1), FSDP with ZeRO), printed as one
              ``{"dryrun_fit": [...]}`` line.  It runs after ``tables``.
6. families -- the MoE, SSM and hybrid families at full width:
              ``family_kernels`` (flash at hymba's GQA 25/5, D 64, window
              1024, S 2048 and deepseek's MHA 16/16; paged decode at MHA
              16/16; RMSNorm at widths 1600, 2048 and 3200; kernels 4, 5
              and 9 on deepseek-moe-16b's 192-slice expert bucket at rank
              256), ``serve_moe`` (deepseek-moe-16b at 1 of its 28
              layers, ``SERVE_MOE_LAYERS``, bf16 made
              leaf by leaf, through the paged engine on phase 3's trace;
              request 0's logits against the static exact path, the bar
              from the f32 model at the deepest depth that fits; host syncs
              per step), ``train_moe`` (1 layer, rank 256:
              kernel 9 runs),
              ``train_ssm`` and ``serve_ssm`` (mamba2-370m at 16 and 4 of
              its 48 layers, ``SSM_LAYERS``, ``SERVE_SSM_LAYERS``; rank
              512: kernel 9 launches 0 times), ``train_hybrid`` and
              ``serve_hybrid`` (hymba-1.5b cut to 1 of its 32 layers,
              ``HYBRID_LAYERS``; seq 2048; prompts of
              1500 and 1100 tokens past its 1024 window).  The train paths
              run as phase 4 (galore-sara-adam, 3 steps) and first check
              every step-0 gradient finite; the slot-engine paths hold every
              request's tokens to the static engine's, a parting token only
              at a near-tie (``TIE_BAR_SIGMAS``).
7. VLM and enc-dec -- at full width: ``encdec_vlm_kernels`` (RMSNorm at
              7168 and 1024; flash without a mask over whisper's 1500
              frames at B 1 and 8, whisper's cross-attention at Sq 64 and
              at Sq 1 (B 4) against Sk 1500, llava's causal GQA 56/8
              prefill at S 1600; paged decode at GQA 56/8 over
              ``PAGED_FILLS`` + 576; kernels 4, 5 and 9 on llava's mlp
              bucket, 4 and 5 on whisper's 1024 x 1024 bucket),
              ``serve_vlm`` (llava-next-34b at 2 of its 60 layers,
              ``SERVE_VLM_LAYERS``, made
              leaf by leaf in bf16, the init's peak printed; phase 3's trace
              with each request's own 576 seeded patch embeddings ahead of
              its prompt, in a pool of ``VLM_POOL_PAGES``; request 0's
              logits against the static exact path, the bar from the f32
              model at the deepest depth that fits), ``train_vlm`` (1
              layer, 448 text tokens after the patches, batch 4, rank 512),
              ``serve_audio`` (whisper-medium cut to 1 + 1 of its 24 + 24
              layers, ``AUDIO_LAYERS``, slot engine,
              each request's own 1500 frames, prompts of 4-64 tokens, 64
              new tokens, a ring of 448; every token against the static
              engine's or a near-tie) and ``train_audio`` (1 + 1 layers, seq
              448, batch 8, rank 256: kernel 9 launches 0 times).  The
              train paths run as phase 6's, with the patches or frames in
              every batch.
8. tables  -- the paper's experiments through ``repro_torch.benchmarks`` at
              its LLaMA-60M (8 layers, d_model 512, vocab 32100, seq 256,
              batch 32; rank 128, alpha 0.25; ``paper_tables``): kernels
              4, 5, 7, 8 and 9 against their plain versions at the path's
              buckets, then tables 1, 3 and 4 (16 runs of ``TABLES_STEPS``
              steps, bucketed where the inner has a fused update, per leaf
              otherwise) and figures 2, 3 and 4 from table 1's runs.
              Checks finite losses, the first near ln(vocab), the final
              below it, exact launch counts per run, SARA's adjacent
              overlap below GaLore's, the memory ratios and byte counts;
              prints the rows as one ``{"tables": [...]}`` line.
9. report  -- one ``{"kernel_over_library": [...]}`` line (every case's
              kernel time over its yardstick's), one ``{"kernels": [...]}``
              line (``launches`` summed over every path that ran, each
              run's own count
              beside it in
              ``launches_by_path``; 0 for the 2-D projection, which no path
              runs), the ``nvidia-smi`` line, and last
              ``{"ok": true, "device": {...}}``.  Per-case detail goes to
              ``chiprun_out/chip_smoke.json``.

The script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

# deepseek-moe-16b's 8.9 GB expert stacks, made and freed step after step,
# fragment the caching allocator's fixed segments; expandable segments let
# freed blocks merge (read when the allocator starts, so before any tensor
# is made on the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): device memory rate, and the operation
# rate for each input type (bf16 on the tensor cores, f32 on the CUDA cores),
# from the port's ``roofline/hw.py`` (which the dry run's roofline reads).
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline.hw import HBM_BYTES_PER_S, PEAK_OPS_PER_S  # noqa: E402

# Kernel vs plain version, per dtype: |kernel - plain| <= atol + rtol*|plain|.
# f32: both sum in f32 in different orders (2e-5 is the JAX repo's own
# flash-attention tolerance).  bf16: the output rounds to 8 significant
# bits, so one bf16 ulp (2^-7 relative) apart is agreement; attention also
# rounds its probabilities to bf16 in the plain version only.
TOL = {
    "rmsnorm": {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0**-7)},
    "flash_attention_fwd": {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2.0**-7)},
    "paged_decode_attention": {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2.0**-7)},
    # The optimizer kernels sum thousands of f32 products (d = 4096, n =
    # 14336) in another order than cuBLAS: atol is relative to the largest
    # |plain| output of the case (check_close's rel_atol), rtol 1e-4.  The
    # Adam update's bf16 W' may round one bf16 ulp (2^-7) apart.
    "galore_project_batched": {"float32": (1e-5, 1e-4)},
    # the 2-D projection: R as the batched one's; M' and V' to the same bar
    "galore_project": {"float32": (1e-5, 1e-4)},
    "lowrank_adam_update_batched": {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2.0**-7)},
    "power_iter_batched": {"float32": (1e-5, 1e-4)},
    # The other fused updates: W' and f32 moments as Adam's.  Their moments
    # passes round each operation on its own, as the plain version does,
    # but the reductions of the statistics and the product differ in
    # order: adam_mini's v' and adam8bit's scales to rtol 1e-5 ("state");
    # 8-bit codes at most 1 apart on at most 1e-3 of them ("codes",
    # ROADMAP's +-1 allowance).
    "lowrank_msgd_update_batched": {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2.0**-7)},
    "lowrank_adam_mini_update_batched": {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2.0**-7),
                                         "state": (0.0, 1e-5)},
    "lowrank_adam8bit_update_batched": {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2.0**-7),
                                        "state": (0.0, 1e-5), "codes": (1, 1e-3)},
}

KERNELS = {
    "rmsnorm": {
        "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:30",
    },
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:117",
    },
    "paged_decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/flash_attention_decode/kernel.py:111",
    },
    "galore_project_batched": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/galore_project.cu",
        "replaces": "src/repro/kernels/galore_project/kernel.py:153",
    },
    "lowrank_adam_update_batched": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/lowrank_adam.cu",
        "replaces": "src/repro/kernels/lowrank_update/kernel.py:105",
    },
    "power_iter_batched": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/power_iter.cu",
        "replaces": "src/repro/kernels/power_iter/kernel.py:99",
    },
    "lowrank_msgd_update_batched": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/lowrank_msgd.cu",
        "replaces": "src/repro/kernels/lowrank_update/kernel.py:238",
    },
    "lowrank_adam_mini_update_batched": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/lowrank_adam_mini.cu",
        "replaces": "src/repro/kernels/lowrank_update/kernel.py:350",
    },
    "lowrank_adam8bit_update_batched": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/lowrank_adam8bit.cu",
        "replaces": "src/repro/kernels/lowrank_update/kernel.py:562",
    },
    "galore_project": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/galore_project.cu",
        "replaces": "src/repro/kernels/galore_project/kernel.py:73",
    },
}
# Kernels that no path runs: the JAX package calls the 2-D fused projection
# nowhere, so it is held by its kernel case alone and launches 0 times.
NO_PATH = ("galore_project",)
# What each ``library_ms`` times: one PyTorch call where one computes the
# kernel's whole function, else a call that computes the part of it that
# takes the time (no PyTorch call computes a fused optimizer update).
LIBRARY_CALL = {
    "rmsnorm": "torch.nn.functional.rms_norm (whole function)",
    "flash_attention_fwd": "scaled_dot_product_attention (whole function, plain causal only)",
    "paged_decode_attention": None,  # no PyTorch call reads a page table
    "galore_project_batched": "torch.bmm (whole function)",
    "lowrank_adam_update_batched": "torch.baddbmm(W, P, N, beta=keep, alpha=-lr_alpha): "
                                   "the back-projection only, not the moments pass",
    "power_iter_batched": "torch.bmm(G, torch.bmm(G^T, Q)): both products, with Z "
                          "through device memory as in the kernel",
    "lowrank_msgd_update_batched": "torch.baddbmm (back-projection only)",
    "lowrank_adam_mini_update_batched": "torch.baddbmm (back-projection only)",
    "lowrank_adam8bit_update_batched": "torch.baddbmm (back-projection only)",
    "galore_project": "torch.mm(P^T, G): the product only, not the moments",
}
SERVE_KERNELS = ("rmsnorm", "flash_attention_fwd", "paged_decode_attention")
_TRAIN_COMMON = ("rmsnorm", "flash_attention_fwd", "galore_project_batched",
                 "power_iter_batched")
_MODEL_KERNELS = ("rmsnorm", "flash_attention_fwd")
# The inner's fused update kernel, per inner optimizer.
UPDATE_KERNEL = {"adam": "lowrank_adam_update_batched", "msgd": "lowrank_msgd_update_batched",
                 "adam_mini": "lowrank_adam_mini_update_batched",
                 "adam8bit": "lowrank_adam8bit_update_batched"}

SEED = 0
PAGE_SIZE = 16
MAX_SLOTS = 4
NEW_TOKENS = 32
PROMPT_LENS = [1024, 128, 517, 1000, 255, 777, 64, 333]
ARRIVALS = [0, 0, 1, 2, 4, 8, 12, 20]
# llama3-8b serves at 4 of its 32 layers since the fault harness and the dry
# run joined (at full depth the phase took 27.4 s on an H100 80GB HBM3 at
# 700 W, 17 s of it the profile window's key_averages over 32 layers; 11.1
# s at 8)
SERVE_LAYERS = 4
POOL_PAGES = 160  # usable pages: fewer than four 1024-token requests need
# paged-decode kernel cases: the serving case (an empty slot, two ragged
# slots, a full one) and the bandwidth case: 32 slots of 1024 + 64 i tokens
# (64,512 live tokens, 264 MB of bf16 K/V, more than the 50 MB L2), as a
# server decoding 32 concurrent 1-3K-token conversations holds
PAGED_FILLS = [0, 129, 517, 1056]
PAGED_BANDWIDTH_FILLS = [1024 + 64 * i for i in range(32)]

# train phase: llama3-8b at full width, 4 layers, the launcher's defaults
# (the plans below and the kernel cases' shapes); the TRAIN_RUNS paths and
# train_rank_schedule run at TRAIN_RUN_LAYERS since the FSDP paths joined
# (their refreshes were most of their ~12 s each; PERF.md §4): 2 layers,
# 1 since the other families' TP and FSDP paths joined
TRAIN_LAYERS = 4
TRAIN_RUN_LAYERS = 1
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 3, 512, 8
TRAIN_OPT = dict(rank=512, tau=200, alpha=0.25, lr=0.01, grad_clip_norm=1.0,
                 engine="bucketed", svd_backend="randomized")
TRAIN_WARMUP = 100
# (d, n, rank, B, side) of the bucket plans at 4 layers.  Adam and MSGD mix
# sides: k/v, q/o, mlp (gate, up, and down transposed).  Adam-mini and
# 8-bit Adam keep per-leaf-row state, so their plan splits by side: k/v
# (right), q/o (left), mlp-left (gate, up), mlp-right (down).
TRAIN_BUCKETS = [(1024, 4096, 512, 8, "any"), (4096, 4096, 512, 8, "any"),
                 (4096, 14336, 512, 12, "any")]
SPLIT_BUCKETS = [(1024, 4096, 512, 8, "right"), (4096, 4096, 512, 8, "left"),
                 (4096, 14336, 512, 8, "left"), (4096, 14336, 512, 4, "right")]
# The train phases: path name -> (optimizer, its plan at 4 layers or None
# for per-leaf state, the kernels the path launches, TRAIN_OPT overrides).
# The paper's baselines: golore, grass and online_pca on Adam keep
# bucket-native state and the fused hot step (online_pca's refresh is one
# power-iteration product per bucket at k' = rank); Fira and Adafactor have
# no fused update in either package and run the per-leaf loop on per-leaf
# state, plain products in the hot step and a randomized SVD per leaf in
# the refresh, beside Adam on the reference engine, the same loop, timed
# once for comparison.
_PER_LEAF_KERNELS = _MODEL_KERNELS + ("power_iter_batched",)
_ADAM_BUCKETED = _MODEL_KERNELS + ("galore_project_batched", "lowrank_adam_update_batched")
TRAIN_RUNS = {
    "train": ("galore-sara-adam", TRAIN_BUCKETS, _TRAIN_COMMON + (UPDATE_KERNEL["adam"],), {}),
    "train_msgd": ("galore-sara-msgd", TRAIN_BUCKETS,
                   _TRAIN_COMMON + (UPDATE_KERNEL["msgd"],), {}),
    "train_adam_mini": ("galore-sara-adam-mini", SPLIT_BUCKETS,
                        _TRAIN_COMMON + (UPDATE_KERNEL["adam_mini"],), {}),
    "train_adam8bit": ("galore-sara-adam8bit", SPLIT_BUCKETS,
                       _TRAIN_COMMON + (UPDATE_KERNEL["adam8bit"],), {}),
    "train_golore": ("golore-adam", TRAIN_BUCKETS, _ADAM_BUCKETED, {}),
    "train_grass": ("grass-adam", TRAIN_BUCKETS, _ADAM_BUCKETED, {}),
    "train_online_pca": ("online-pca-adam", TRAIN_BUCKETS,
                         _ADAM_BUCKETED + ("power_iter_batched",), {}),
    "train_fira": ("fira-sara-adam", None, _PER_LEAF_KERNELS, {}),
    "train_adafactor": ("galore-sara-adafactor", None, _PER_LEAF_KERNELS, {}),
    "train_adam_reference": ("galore-sara-adam", None, _PER_LEAF_KERNELS,
                             {"engine": "reference"}),
}
# (d, n, r) of the 2-D fused projection's cases: the JAX benchmark's
# (benchmarks/kernels_micro.py) and a full-width mlp leaf's
PROJECT_2D_SHAPES = [(2048, 8192, 512), (4096, 14336, 512)]
# resume phase: galore-sara-adam with tau 2 (refreshes at steps 0, 2, 4) on
# the zipf corpus; run C goes through uninterrupted and saves at RESUME_STOP,
# run B resumes from that checkpoint to RESUME_STEPS
RESUME_STEPS, RESUME_STOP = 5, 3
RESUME_OPT = dict(TRAIN_OPT, tau=2)
# B's losses against C's: a relative bar, because CUDA's embedding backward
# accumulates with atomics, so B's step 3 and C's need not agree bitwise
RESUME_LOSS_RTOL = 1e-4
# serve_ckpt: 4 requests of 64-517 prompt tokens, 16 new tokens each
SERVE_CKPT_PROMPTS = [64, 200, 333, 517]
SERVE_CKPT_NEW_TOKENS = 16
PATH_KERNELS = {"serve": SERVE_KERNELS}
PATH_KERNELS.update({path: run[2] for path, run in TRAIN_RUNS.items()})
PATH_KERNELS["resume"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
PATH_KERNELS["serve_ckpt"] = SERVE_KERNELS
# train_recovery: galore-sara-adam under the launcher's default recovery
# policy (no backoff) with heartbeats; steps 0-2 as in ``train``, then a
# NaN gradient at step 3 (skipped), a good step 4, and NaN losses at 5-7,
# whose streak rolls back to the pinned step-0 checkpoint with resample;
# the run then replays steps 0-7.
RECOVERY_STEPS = 8
RECOVERY_SKIP_AT = 3
RECOVERY_NAN_LOSS = (5, 6, 7)
# the gate's cost within the phase: this many gated and ungated hot steps
# each, in turns (ABBA), from the run's final state
GATE_AB_STEPS = 4
# train_rank_schedule: tau 2 (refreshes at 0, 2, 4) over 6 steps with
# "step:512:256@0.5": the halving ladder [512, 256] over the first half of
# the run, so the refresh at step 2 re-buckets to rank 256, and the refresh
# at step 4 and the hot steps 3 and 5 run at 256 (over 4 steps,
# "step:512:256" would re-bucket at step 2 too, but leave no refresh at 256)
RANK_SCHEDULE = "step:512:256@0.5"
SCHEDULE_STEPS = 6
SCHEDULE_OPT = dict(TRAIN_OPT, tau=2, rank_schedule=RANK_SCHEDULE)
SCHEDULE_RANKS = (512, 256)
# kernels 4, 5 and 9 at the new rank and at a rank of 8 mod 16 (a ragged
# last K tile of the f32 tile engine), on the mlp bucket's shape
RANK_CASES = (256, 264)
PATH_KERNELS["train_recovery"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
# resume and train_recovery run cut to 1 of the 4 layers (the same widths
# and bucket shapes, 2 / 2 / 3 slices): their checkpoints are ~13.7 GB,
# most of it embed's and lm_head's params and Adam moments, and each
# refresh ~2 s instead of ~8; the room goes to train_dp
RESUME_LAYERS = RECOVERY_LAYERS = 1
# train_dp: data-parallel training on torch.distributed, one process per
# card (NCCL; the smoke machine has one card, so world 1): the train
# phase's model, seq, batch and optimizer, without clipping (DP_OPT: the
# compressed step clips by the R-space norm, so a clipped run would not be
# the single-process step), 3 steps (refresh + 2 hot) with
# compressed="flat", replicated and ZeRO state (state_shards = world);
# in one process, a standard step at DP_ZERO_SHARDS shards, a save of its
# stacks by that many emulated writers, restored at DP_RESTORE_SHARDS; and
# kernels 4-8 on a narrow of a padded stack, DP_PAD_SHAPE (d, n, r, B):
# B 6 pads to 8 over 4 shards, so the last block is all pad rows
DP_STEPS = 3
# at 2 of phase 4's 4 layers: the script passed the 900 s it keeps to (half
# its 1200-s limit, with room for the card's spread) once train_tp joined,
# and depth is what this phase can lose (its checks are per bucket and per
# step); 1 since the other families' TP and FSDP paths joined
DP_LAYERS = 1
DP_OPT = dict(TRAIN_OPT, grad_clip_norm=0.0)
DP_ZERO_SHARDS = 4
DP_RESTORE_SHARDS = (2, 8)
DP_PAD_SHAPE = (1024, 4096, 512, 6)
# the phase took 67.7-82.3 s on the H100 (NVIDIA H100 80GB HBM3, 700.00
# W); a hung process or collective fails it after this long, well inside
# the script's limit
DP_TIMEOUT_S = 240
# A one-card machine holds a world of one process, whose ZeRO layout has
# one shard: the shard-local step never runs there.  So the first process
# also runs a world of DP_EMU_RANKS ranks as threads of its own on its card
# (``_ThreadHub``: their collectives exchange through the card's memory),
# replicated and ZeRO (state_shards = DP_EMU_RANKS), 3 steps of the
# paper's LLaMA-60M (``TABLES_PRESET``'s widths) at 5 of its 8 layers, so
# the mlp bucket's 15 slices pad to 16 and the last rank's block of 4 rows
# holds 1 pad row (at 7 layers the phase took 98 s of the 90 it has, on an
# H100 80GB HBM3, 700 W), with f32 compute, seq 256, global batch 32,
# rank 128, the randomized SVD, no clipping.  ZeRO against replicated in
# the same world, whose sums run in the same order: ZERO_TOL of the CPU
# tests (tests/test_torch_distributed.py).  A world of several processes
# against the single-process step: REFRESH_TOL of the same file, the bar
# of those CPU worlds.  The emulated world against it on the card is held
# as those tests hold a trajectory and a hot step: the ranks' f32
# products over 8 rows each round apart from the single process's over
# 32 (cuBLAS picks its kernels by the shapes), the refresh's f32 factors
# turn that into other projectors where singular values crowd, and Adam's
# normalized step magnifies it (1.16e-4 at step 2 at 7 layers on that
# H100, against REFRESH_TOL's 5e-5; 1.2e-7 on the CPU, whose factors are
# f64), so the 3-step trajectory is held by its losses (RESUME_LOSS_RTOL,
# as a resumed run) and its params only under twice the summed learning
# rates (Adam's step taken the other way at every step), and one hot step
# from the single-process state to HOT_LOOP_TOL (1e-6 abs on all but
# 1e-4 of each leaf, those within 1e-4).  A world of one process sums as
# the single-process step does, and is held to the kernels' TOL.
DP_EMU_RANKS = DP_ZERO_SHARDS
DP_EMU_LAYERS = 5
DP_EMU_SEQ, DP_EMU_BATCH = 256, 32
DP_EMU_OPT = dict(rank=128)
DP_EMU_BUCKETS = [(512, 512, 128, 20, "any"), (512, 1376, 128, 15, "any")]
DP_ZERO_TOL = 1e-6
DP_REFRESH_TOL = 5e-5
DP_HOT_TOL = dict(atol=1e-6, share=1e-4, cap=1e-4)
PATH_KERNELS["train_dp"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
PATH_KERNELS["train_rank_schedule"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)

# phase 6: the MoE, SSM and hybrid families at full width.  RMSNorm and
# flash launches per layer of one forward, per family: the block's norms
# (hybrid: attn_norm, mlp_norm and its mixer's norm; ssm: ssm_norm and
# the mixer's) and its flash attentions (none in the SSM).
LAYER_LAUNCHES = {"dense": (2, 1), "moe": (2, 1), "ssm": (2, 0), "hybrid": (3, 1)}
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = "deepseek-moe-16b", "mamba2-370m", "hymba-1.5b"
# hymba's serving trace: two prompts past its 1024-token window, so prefill
# keeps the window's tail and the ring wraps in decode
HYBRID_PROMPT_LENS = [1500, 128, 517, 1100, 255, 777, 64, 333]
# hymba serves and trains cut to HYBRID_LAYERS of its 32 layers (every layer's shapes
# as at full depth): the whole script ran 1038 s of its 1200 s at full
# depth once the VLM and enc-dec paths joined, and hymba's two paths, whose
# host-bound SSD chunk loop costs time per layer, took 147 s of it; 16
# until the tensor-parallel phase joined (the two took 71.7 s at 16), 8
# until the FSDP paths joined (35.4 s at 8), 4 until the other families'
# TP and FSDP paths joined (16.5 s at 4), 2 until every optimizer's TP and
# FSDP paths joined (14.6 s at 2 on a card whose whole script ran 1223 s)
HYBRID_LAYERS = 1
# A continuous-engine token may part from the static engine's only at a
# near-tie.  The two engines run the same bf16 model but batch it
# differently (4 slots against 1 row: other GEMM kernels, other roundings),
# so the static logits' gap between the two tokens at the parting step
# must be within TIE_BAR_SIGMAS times bf16's own per-logit error there:
# the RMS distance between the bf16 and f32 models' logits on the same
# tokens (the prompt and the tokens before the parting step).
TIE_BAR_SIGMAS = 4
# deepseek trains cut to 1 of its 28 layers (4 until the script passed its
# time limit once the data-parallel phase joined: its SARA refresh over the
# 768-slice expert bucket took 52.9 s on the H100, NVIDIA H100 80GB HBM3,
# 700.00 W, and the whole script 1051 s of its 1200; 2 until the
# tensor-parallel phase joined, 37.9 s at 2); it served at full depth
# until the FSDP paths joined (52.2 s), at 14 of 28 layers until the other
# families' TP and FSDP paths joined, at 7 until every optimizer's TP and
# FSDP paths joined (15.5 s at 7, 8.8 s at 4; 19.7 s at 7 on a card whose
# whole script ran 1223 s), at 3 until the fault harness and the dry run
# joined (7.9 s at 3), at 1 since
MOE_TRAIN_LAYERS = 1
SERVE_MOE_LAYERS = 1
# mamba2-370m trains at 16 of its 48 layers since every optimizer's TP and
# FSDP paths joined (24 until then; the two paths took 39.1 s at 48, 28.4 s
# at 24 on a card whose whole script ran 1223 s); not below 16, where
# d_skip's (L, 32) leaf leaves the low-rank plan (min_dim 16).  It serves
# at 4 since the fault harness and the dry run joined (16 until then:
# 11.0 s, NVIDIA H100 80GB HBM3, 700.00 W); serving has no plan to keep.
SSM_LAYERS = 16
SERVE_SSM_LAYERS = 4
# rank 256 for moe and hybrid: SARA's pool (4 r) then leaves k' 1032 below
# the narrow side of their leaves, so kernel 9 runs; at the launcher's 512
# it spans every leaf's narrow side and the power iterations drop (as
# JAX's clamp_sketch); mamba2 keeps 512, where kernel 9 must launch 0 times
FAMILY_TRAIN_RUNS = {
    # path: (arch, layers (None: full depth), seq, batch, rank, bucket plan)
    "train_moe": (MOE_ARCH, MOE_TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, 256,
                  [(1408, 2048, 256, 192, "any"), (2048, 2048, 256, 4, "any"),
                   (2048, 2816, 256, 3, "any")]),
    # d_skip's (L, 32) leaf, then out_proj and in_proj, one a layer
    "train_ssm": (SSM_ARCH, SSM_LAYERS, TRAIN_SEQ, TRAIN_BATCH, 512,
                  [(min(SSM_LAYERS, 32), max(SSM_LAYERS, 32), min(SSM_LAYERS, 32), 1, "any"),
                   (1024, 2048, 512, SSM_LAYERS, "any"), (1024, 4384, 512, SSM_LAYERS, "any")]),
    # seq 2048 so attention reaches past the 1024 window (the same 4096 tokens)
    # per layer: k/v, q/o, out_proj, the mlp, in_proj
    "train_hybrid": (HYBRID_ARCH, HYBRID_LAYERS, 2048, 2, 256,
                     [(d, n, 256, b * HYBRID_LAYERS, "any") for d, n, b in (
                         (320, 1600, 2), (1600, 1600, 2), (1600, 3200, 1), (1600, 5504, 3),
                         (1600, 6482, 1))]),
}
PATH_KERNELS["serve_moe"] = SERVE_KERNELS
PATH_KERNELS["train_moe"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
PATH_KERNELS["serve_ssm"] = ("rmsnorm",)
PATH_KERNELS["train_ssm"] = ("rmsnorm", "galore_project_batched", UPDATE_KERNEL["adam"])
PATH_KERNELS["serve_hybrid"] = ("rmsnorm", "flash_attention_fwd")
PATH_KERNELS["train_hybrid"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
# phase 7: the VLM and enc-dec families at full width.  llava-next-34b's
# requests each carry 576 patch embeddings ahead of their text, in the
# pages: the pool holds 250 usable pages, fewer than the 320 that the first
# four requests reserve ((576 + prompt + 32) / 16 each), so admission waits
# and pages recycle.  whisper-medium's each carry 1500 frames; its decoder
# prompts of 4-64 tokens, 64 new tokens each, in a ring of 448 positions
# (Whisper's text context).
VLM_ARCH, AUDIO_ARCH = "llava-next-34b", "whisper-medium"
VLM_POOL_PAGES = 250
# llava serves at 2 of its 60 layers since the fault harness and the dry
# run joined (6 until then, 15 until every optimizer's TP and FSDP paths
# joined, 30 until the other families' joined; at full depth, 65 GiB of
# bf16 weights, it took 27.3 s; 5.7 s at 8, 11.9 s at 15 on a card whose
# whole script ran 1223 s, 5.4 s at 6)
SERVE_VLM_LAYERS = 2
AUDIO_PROMPT_LENS = [64, 4, 48, 17, 33, 8, 56, 25]
AUDIO_NEW_TOKENS = 64
AUDIO_MAX_SEQ = 448
# whisper serves and trains cut to 6 of its 24 encoder and 24 decoder
# layers (every layer's shapes as at full depth): at full depth its two
# paths took 107 s of the script's 1051 s on the H100 (NVIDIA H100 80GB
# HBM3, 700.00 W), too near the script's 1200-s limit; 6 + 6 since the
# FSDP paths joined (the two took 44.5 s at 12 + 12), 3 + 3 since the other
# families' TP and FSDP paths joined (25.4 s at 6 + 6), 1 + 1 since every
# optimizer's TP and FSDP paths joined (17.3 s at 3 + 3 on a card whose
# whole script ran 1223 s)
AUDIO_LAYERS = 1
LAYER_LAUNCHES["vlm"] = LAYER_LAUNCHES["dense"]
# train_vlm: llava-next-34b cut to 1 layer (2 until the other families' TP
# and FSDP paths joined), 448 text tokens after the 576 patches (1024
# positions), batch 4; rank 512 (k' 2056 < 7168: kernel 9 runs), and the 2-D
# patch_in_proj joins q and o's bucket.  train_audio: whisper-medium at
# ``AUDIO_LAYERS``, 448 decoder tokens and 1500 frames, batch 8; rank 256,
# whose sara sketch k' 1032 spans the 1024-wide narrow side of every leaf,
# so the power iterations drop (kernel 9: 0 launches).
FAMILY_TRAIN_RUNS["train_vlm"] = (
    VLM_ARCH, 1, 448, 4, 512,
    [(1024, 7168, 512, 2, "any"), (7168, 7168, 512, 3, "any"), (7168, 20480, 512, 3, "any")])
# per encoder and decoder layer: q/k/v/o and the cross q/k/v/o; the mlps
FAMILY_TRAIN_RUNS["train_audio"] = (
    AUDIO_ARCH, AUDIO_LAYERS, 448, 8, 256,
    [(1024, 1024, 256, 12 * AUDIO_LAYERS, "any"), (1024, 4096, 256, 6 * AUDIO_LAYERS, "any")])
PATH_KERNELS["serve_vlm"] = SERVE_KERNELS
PATH_KERNELS["train_vlm"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
PATH_KERNELS["serve_audio"] = ("rmsnorm", "flash_attention_fwd")
PATH_KERNELS["train_audio"] = ("rmsnorm", "flash_attention_fwd", "galore_project_batched",
                               UPDATE_KERNEL["adam"])
# paths that must not launch a kernel: the power iterations at a rank whose
# sketch spans every leaf's narrow side (mamba2 at 512, whisper at 256)
PATH_NEVER = {"train_ssm": ("power_iter_batched", "flash_attention_fwd"),
              "train_audio": ("power_iter_batched",)}
# tables: the paper's experiments through ``repro_torch.benchmarks`` at its
# LLaMA-60M (the Table 1 row; pretrain_lm's ``llama-60m`` preset): 8 layers,
# d_model 512, 8 heads of 64, d_ff 1376, vocab 32100, seq 256, batch 32;
# f32 params and bf16 compute as the train paths, rank 128 and alpha 0.25
# as the preset, the randomized SVD.  Every row: TABLES_STEPS steps at lr
# TABLES_LR, a refresh every TABLES_TAU steps (5 refreshes: 4 adjacent
# overlaps, so fig2's first and last three differ).  25 steps, not the
# harness's 150: on the H100 (700 W) full Adam took ~95 ms a hot step and a
# SARA refresh ~1.25 s, and the 16 runs took the phase ~370 s at 150
# steps, 181 s at 60, 118 s at 35, 95-112 s at 25 and 78.8 s at 15 (tau 3).
# Its depth stays 8: at 4 layers embed's and lm_head's full Adam
# state lifts GaLore's state / param ratio to 1.6235, past the path's 1.6
# bar (on the H100, NVIDIA H100 80GB HBM3, 700.00 W).  lr 1e-3, the
# paper's full-Adam rate at this size, not the harness's CPU default of
# 2e-3: at 2e-3 both Adam-mini rows diverge (loss
# 11-12 at step 60, from 10.48) and the 8-bit rows spike after a refresh,
# in JAX too from the same inputs at 8 layers and batch 8 on the CPU
# (tools/tables_cpu.py --trajectory), and on the card with no hand-written
# kernel or in f32 compute as well (tools/fused_trajectory.py; ROADMAP
# queue 3).
# Table 2, the paper's 130M/350M scale row, is not run (ROADMAP).
TABLES_STEPS, TABLES_TAU, TABLES_LR = 25, 5, 1e-3
TABLES_PRESET = "llama-60m"
# the low-rank rows' fused kernels; kernel 9 runs only where the sketch k'
# is narrower than a leaf's narrow side (GaLore's 136 < 512; SARA's pool of
# 4 x 128 + 8 spans 512, so its power iterations drop): its count is held
# exact on every row, but the path does not require it
PATH_KERNELS["tables"] = _MODEL_KERNELS + (
    "galore_project_batched", UPDATE_KERNEL["adam"], UPDATE_KERNEL["adam_mini"],
    UPDATE_KERNEL["adam8bit"])
# the caching allocator rounds each block up to a multiple of 512 bytes
ALLOC_ROUND = 512
# the tables path's bucket plans at LLaMA-60M, rank 128 (d, n, rank, B,
# side): Adam's mixes sides, Adam-mini's and 8-bit Adam's split them (the
# mlp's 1376 = 5 x 256 + 96 leaves the 8-bit rows a ragged last chunk);
# GaLore's sketch k' = rank + 8
TABLES_BUCKETS = [(512, 512, 128, 32, "any"), (512, 1376, 128, 24, "any")]
TABLES_SPLIT_BUCKETS = [(512, 512, 128, 32, "left"), (512, 1376, 128, 16, "left"),
                        (512, 1376, 128, 8, "right")]
TABLES_KP = 136


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[smoke {time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def fresh_dir(name: str) -> Path:
    """An empty directory under ``build/`` (gitignored) for a phase's
    checkpoints; the phase removes it when it ends."""
    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.parent.mkdir(parents=True, exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` between CUDA events around ``iters``
    back-to-back calls: the device time, or the host's launch time where
    that is longer (small kernels launched from Python)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _is_kernel(event) -> bool:
    """Whether a ``key_averages()`` entry is a device activity (a kernel or
    copy).  A host range also carries the device time of the kernels
    launched under it that no aten op claims: the autograd wrappers'
    ``_FlashAttention`` and ``_RMSNorm`` ranges would count the flash and
    RMSNorm kernels a second time."""
    from torch.autograd import DeviceType

    return getattr(event, "device_type", None) == DeviceType.CUDA


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call of ``fn``: the summed durations of every
    kernel (and copy) it ran, from torch.profiler, over ``iters`` calls.
    A profiler session has come back empty on the H100 now and then; it is
    asked again, and after three empty sessions the time is ``call_ms``,
    which bounds the device time from above (and the log says so)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_device_us(e) for e in prof.key_averages())
        if total_us > 0:
            return total_us / 1e3 / iters
    log("torch.profiler recorded no device time three times: CUDA events instead")
    return call_ms(fn, iters, warmup)


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def off_tolerance(got, want, atol: float, rtol: float, rel_atol: bool = False):
    """(|got - want|, mask of the elements outside atol + rtol * |want|,
    atol times max |want| when ``rel_atol``; non-finite ``got`` is off)."""
    got32, want32 = got.float(), want.float()
    if rel_atol:
        atol = atol * float(want32.abs().max())
    err = (got32 - want32).abs()
    return err, ~torch.isfinite(got32) | (err > atol + rtol * want32.abs()), atol


def check_close(what: str, got, want, atol: float, rtol: float,
                rel_atol: bool = False) -> float:
    """Max |got - want|, raising unless every element is within
    atol + rtol * |want| (atol times max |want| when ``rel_atol``)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err, bad, atol = off_tolerance(got, want, atol, rtol, rel_atol)
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} elements off, max abs "
            f"err {max_err:.3e} (atol {atol}, rtol {rtol})"
        )
    return max_err


def check_codes(what: str, got, want, max_step: int, max_share: float):
    """8-bit codes: raising unless they are at most ``max_step`` apart, on
    at most ``max_share`` of them; returns (largest step, share apart)."""
    diff = (got.int() - want.int()).abs()
    worst, share = int(diff.max()), float((diff > 0).float().mean())
    if worst > max_step or share > max_share:
        raise AssertionError(f"{what}: codes up to {worst} apart on {share:.2e} of them "
                             f"(at most {max_step} on {max_share})")
    return worst, share


# ---------------------------------------------------------------------------
# the fused low-rank updates, one calling convention for the four inners
# ---------------------------------------------------------------------------

# An update's outputs after W', per inner optimizer.
UPDATE_PARTS = {"adam": ("M'", "V'"), "msgd": ("M'",), "adam_mini": ("M'", "v'"),
                "adam8bit": ("m codes", "m scales", "v codes", "v scales")}
INNER_KW = {"adam": dict(b1=0.9, b2=0.999, eps=1e-8), "msgd": dict(b1=0.9),
            "adam_mini": dict(b1=0.9, b2=0.95, eps=1e-8),
            "adam8bit": dict(b1=0.9, b2=0.999, eps=1e-8)}


def fused_update(inner: str, kernel: bool):
    """``f(w, p, r_g, state, step, lr_alpha, lr_wd, side, kw)`` -> (W', ...):
    the inner's fused update, its CUDA kernel or its plain version.
    ``state`` holds the bucket's state tensors in the kernel's order
    (``bucket_state``); ``kw`` the inner's hyperparameters."""
    from repro_torch.kernels.lowrank_update import kernel as K
    from repro_torch.kernels.lowrank_update import ref as R

    if inner == "adam" and kernel:
        return lambda w, p, rg, st, step, la, wd, side, kw: K.lowrank_adam_update_batched(
            w, p, rg, *st, step, la, wd, **kw)
    if inner == "adam":
        return lambda w, p, rg, st, step, la, wd, side, kw: R.lowrank_adam_update_ref(
            w, p, rg, *st, step=step, lr_alpha=la, lr_wd=wd, **kw)
    if inner == "msgd" and kernel:
        return lambda w, p, rg, st, step, la, wd, side, kw: K.lowrank_msgd_update_batched(
            w, p, rg, *st, la, wd, **kw)
    if inner == "msgd":
        return lambda w, p, rg, st, step, la, wd, side, kw: R.lowrank_msgd_update_ref(
            w, p, rg, *st, lr_alpha=la, lr_wd=wd, **kw)
    fn = {("adam_mini", True): K.lowrank_adam_mini_update_batched,
          ("adam_mini", False): R.lowrank_adam_mini_update_ref,
          ("adam8bit", True): K.lowrank_adam8bit_update_batched,
          ("adam8bit", False): R.lowrank_adam8bit_update_ref}[(inner, kernel)]
    return lambda w, p, rg, st, step, la, wd, side, kw: fn(
        w, p, rg, *st, step, la, wd, side=side, **kw)


def bucket_state(inner: str, bst):
    """A ``BucketState``'s tensors in the order the inner's update takes."""
    if inner == "adam8bit":
        return (bst.m, bst.m_scale, bst.v, bst.v_scale)
    if inner == "msgd":
        return (bst.m,)
    return (bst.m, bst.v)


def check_update(inner: str, what: str, got, want, dn: str) -> dict:
    """The kernel's outputs against the plain version's: W' to the dtype's
    tolerance, f32 moments, adam_mini's v' and adam8bit's scales to
    "state", 8-bit codes to "codes".  Returns the max abs error per part
    (for codes, (largest step, share apart))."""
    name = UPDATE_KERNEL[inner]
    tol = TOL[name]
    errs = {"W'": check_close(f"{what} W'", got[0], want[0], *tol[dn], rel_atol=True)}
    for part, a, c in zip(UPDATE_PARTS[inner], got[1:], want[1:]):
        if "codes" in part:
            errs[part] = check_codes(f"{what} {part}", a, c, *tol["codes"])
        elif part == "v'" or "scales" in part:
            errs[part] = check_close(f"{what} {part}", a, c, *tol["state"])
        else:
            errs[part] = check_close(f"{what} {part}", a, c, *tol["float32"], rel_atol=True)
    return errs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(results):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import last_design as flash_design
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention_decode.kernel import (
        paged_decode_attention_kernel,
    )
    from repro_torch.kernels.flash_attention_decode.ref import (
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, label, dtype, err, main, timing):
        case = {"kernel": name, "case": label, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tolerance": TOL[name][str(dtype).split(".")[-1]]}
        case.update(timing)
        cases.append(case)
        log(f"{name} {label} {case['dtype']}: max_abs_err {err:.3e} "
            + " ".join(f"{k} {v}" for k, v in timing.items()))
        r = results[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if main:
            r.update(timing)

    # -- rmsnorm: a decode tick's rows and a prefill's rows -----------------
    rms_lib = getattr(F, "rms_norm", None)
    for rows in (4, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            x = randn(rows, 4096, dtype=dtype)
            scale = 1.0 + randn(4096, scale=0.1)
            got = rmsnorm(x, scale, 1e-5)
            want = rmsnorm_ref(x, scale, 1e-5)
            torch.cuda.synchronize()
            err = check_close(f"rmsnorm ({rows},4096) {dn}", got, want, *TOL["rmsnorm"][dn])
            es = x.element_size()
            b_ms, b_by = bound(2 * rows * 4096 * es + 4096 * 4, 4 * rows * 4096, dn)
            scale_lib = scale.to(dtype)  # F.rms_norm takes the weight in x's dtype
            timing = {
                "ms": device_ms(lambda: rmsnorm(x, scale, 1e-5)),
                "call_ms": call_ms(lambda: rmsnorm(x, scale, 1e-5)),
                "plain_ms": device_ms(lambda: rmsnorm_ref(x, scale, 1e-5)),
                "library_ms": (
                    device_ms(lambda: rms_lib(x, (4096,), scale_lib, 1e-5))
                    if rms_lib else None
                ),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            record("rmsnorm", f"({rows},4096)", dtype, err,
                   rows == 4 and dtype == torch.bfloat16, timing)

    # -- flash prefill: llama3-8b heads, causal, ragged lengths -------------
    def pairs(sq, sk, causal, window, q_offset):
        n = 0
        for i in range(sq):
            qpos = i + q_offset
            hi = min(sk - 1, qpos) if causal else sk - 1
            lo = max(0, qpos - window + 1) if window else 0
            n += max(0, hi - lo + 1)
        return n

    def sdpa(q, k, v, causal):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        except TypeError:  # older torch: no enable_gqa
            g = q.shape[2] // k.shape[2]
            kt, vt = kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    # (batch, Sq, Sk, window, q_offset, dtypes): serving prefills, a window,
    # a q_offset, and one training step's attention (B=8, S=512, bf16)
    both = (torch.float32, torch.bfloat16)
    flash_cases = [(1, s, s, 0, 0, both) for s in (128, 517, 1024)]
    flash_cases += [(1, 517, 517, 128, 0, both), (1, 128, 256, 0, 128, both)]
    flash_cases += [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 0, 0, (torch.bfloat16,))]
    for nb, sq, sk, window, q_offset, dtypes in flash_cases:
        for dtype in dtypes:
            dn = str(dtype).split(".")[-1]
            q = randn(nb, sq, 32, 128, dtype=dtype)
            k = randn(nb, sk, 8, 128, dtype=dtype)
            v = randn(nb, sk, 8, 128, dtype=dtype)
            kw = dict(causal=True, window=window, q_offset=q_offset)
            got = flash_attention_fwd(q, k, v, **kw)
            design = flash_design()
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            label = f"B={nb} S={sq} Sk={sk} window={window} q_offset={q_offset}"
            err = check_close(f"flash {label} {dn}", got, want,
                              *TOL["flash_attention_fwd"][dn])
            expect = "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"
            if design != expect:
                raise AssertionError(f"flash {label} {dn} ran on the {design}, not the {expect}")
            del got, want
            es = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            ops = 4 * 128 * 32 * nb * pairs(sq, sk, True, window, q_offset)
            b_ms, b_by = bound(nbytes, ops, dn)
            has_library = window == 0 and q_offset == 0 and sq == sk
            timing = {
                "design": design,
                "ms": device_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
                "call_ms": call_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
                "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, **kw)),
                "library_ms": (device_ms(lambda: sdpa(q, k, v, True))
                               if has_library else None),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            record("flash_attention_fwd", label, dtype, err,
                   nb == 1 and sq == 1024 and dtype == torch.bfloat16, timing)

    # -- paged decode: the serving case (ragged fills incl. an empty slot),
    # and the bandwidth case (more K/V than L2 holds, pages out of order) --
    paged = [(PAGED_FILLS, window, dtype, False)
             for window in (0, 128) for dtype in (torch.float32, torch.bfloat16)]
    paged.append((PAGED_BANDWIDTH_FILLS, 0, torch.bfloat16, True))
    for fills, window, dtype, shuffle in paged:
        dn = str(dtype).split(".")[-1]
        q, pk, pv, table, lens = paged_inputs(randn, fills, dtype, shuffle, gen)
        got = paged_decode_attention_kernel(q, pk, pv, table, lens, window=window)
        want = paged_decode_attention_ref(q, pk, pv, table, lens, window=window)
        torch.cuda.synchronize()
        label = paged_label(fills, window, shuffle)
        err = check_close(f"paged {label} {dn}", got, want,
                          *TOL["paged_decode_attention"][dn])
        del want
        empty = [i for i, n in enumerate(fills) if n == 0]
        if not bool((got[empty] == 0).all()):
            raise AssertionError(f"paged {label} {dn}: empty slot is not exactly 0")
        b_ms, b_by = paged_bound(q, table, fills, window)
        timing = {
            **paged_plan(q, pk, table),
            "ms": device_ms(lambda: paged_decode_attention_kernel(
                q, pk, pv, table, lens, window=window)),
            "call_ms": call_ms(lambda: paged_decode_attention_kernel(
                q, pk, pv, table, lens, window=window)),
            "plain_ms": device_ms(lambda: paged_decode_attention_ref(
                q, pk, pv, table, lens, window=window)),
            "library_ms": None,  # no single PyTorch call reads a page table
            "bound_ms": b_ms, "bound_by": b_by,
        }
        want_design = "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"
        if timing["design"] != want_design:
            raise AssertionError(f"paged {label} {dn} ran on the {timing['design']}")
        record("paged_decode_attention", label, dtype, err,
               fills == PAGED_FILLS and window == 0 and dtype == torch.bfloat16, timing)
        del q, pk, pv, table, lens, got
    return cases


def paged_inputs(randn, fills, dtype, shuffle, gen, dev: str = "cuda", heads=(32, 8)):
    """q, pools, page table and lengths of one paged-decode case at
    ``heads`` (H, KVH; llama3-8b's 32/8 by default), D 128 and ``PAGE_SIZE``.  Pages follow
    the slots in order, or (``shuffle``) a permutation drawn from ``gen``,
    so that no slot's pages are contiguous; a few pages that no table
    references hold garbage at 50 times the data's scale."""
    from repro_torch.serve.kv_cache import pages_needed

    mp = pages_needed(max(fills), PAGE_SIZE)
    counts = [pages_needed(n, PAGE_SIZE) for n in fills]
    n_used = sum(counts)
    ids = torch.arange(1, n_used + 1)
    if shuffle:
        ids = ids[torch.randperm(n_used, generator=gen, device=gen.device).cpu()]
    table = torch.full((len(fills), mp), -1, dtype=torch.int32)
    nxt = 0
    for i, c in enumerate(counts):
        table[i, :c] = ids[nxt:nxt + c]
        nxt += c
    h, kvh = heads
    n_pages = n_used + 4  # the trash page 0 and 3 never-referenced pages
    pk = randn(n_pages, PAGE_SIZE, kvh, 128, scale=50.0)
    pv = randn(n_pages, PAGE_SIZE, kvh, 128, scale=50.0)
    used = table[table >= 0].long().to(dev)
    pk[used] = randn(used.numel(), PAGE_SIZE, kvh, 128)
    pv[used] = randn(used.numel(), PAGE_SIZE, kvh, 128)
    pk, pv = pk.to(dtype), pv.to(dtype)
    lens = torch.tensor(fills, dtype=torch.int32, device=dev)
    q = randn(len(fills), 1, h, 128, dtype=dtype)
    return q, pk, pv, table.to(dev), lens


def paged_label(fills, window, shuffle) -> str:
    if fills == PAGED_BANDWIDTH_FILLS:
        what = f"{len(fills)} slots of 1024+64i"
    else:
        what = f"fills={fills}"
    return f"{what} ps={PAGE_SIZE} window={window}" + (" shuffled pages" if shuffle else "")


def paged_bound(q, table, fills, window, kvh: int = 8):
    """Bytes bound of one paged-decode call: q read and out written once,
    each visible token's K and V rows read once, the table and lengths;
    4 operations per (head, element) of each visible token."""
    live = sum(n - (max(0, n - window) if window else 0) for n in fills)
    es = q.element_size()
    _, _, h, d = q.shape
    nbytes = 2 * q.numel() * es + 2 * live * kvh * d * es + table.numel() * 4 + 4 * len(fills)
    return bound(nbytes, 4 * h * d * live, str(q.dtype).split(".")[-1])


def paged_plan(q, pk, table) -> dict:
    """The design and cluster size the wrapper picks for these inputs, and
    the card's cluster occupancy it picks from (empty for a wrapper that
    has none of them)."""
    from repro_torch.kernels.flash_attention_decode import kernel as pk_mod

    if not hasattr(pk_mod, "card_clusters"):
        return {}
    _, _, h, d = q.shape
    kvh = pk.shape[2]
    how = pk_mod.design(q.dtype, d, h // kvh, True, pk.shape[0] * PAGE_SIZE)
    room = pk_mod.card_clusters(q.dtype, h, kvh, d, how, q.device.index)
    return {"design": how, "max_clusters": room,
            "cluster": pk_mod.cluster_size(q.shape[0], kvh, table.shape[1] * PAGE_SIZE, room)}


def record_case(cases, results, name, label, dtype, err, main, timing,
                relative: bool = True):
    """Log one kernel case, append it to ``cases``, and keep the kernel's
    largest error (and, for its main case, its times) in ``results``.
    ``relative``: the case's atol was relative to its largest |plain|
    output (the optimizer kernels')."""
    dn = str(dtype).split(".")[-1]
    case = {"kernel": name, "case": label, "dtype": dn, "max_abs_err": err,
            "tolerance": TOL[name][dn], "tolerance_atol_relative": relative}
    case.update(timing)
    cases.append(case)
    log(f"{name} {label} {dn}: max_abs_err {err:.3e} "
        + " ".join(f"{k} {v}" for k, v in timing.items()))
    r = results[name]
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
    if main:
        r.update(timing)


def timed_case(kernel, plain, library, b_ms, b_by, iters):
    """Device ms per call of the kernel, its plain version and the library
    yardstick (None where there is none), beside the bound."""
    return {
        "ms": device_ms(kernel, iters=iters, warmup=1),
        "call_ms": call_ms(kernel, iters=iters, warmup=1),
        "plain_ms": device_ms(plain, iters=iters, warmup=1),
        "library_ms": device_ms(library, iters=iters, warmup=1) if library else None,
        "bound_ms": b_ms, "bound_by": b_by,
    }


def optimizer_kernel_cases(results):
    """The training paths' projection and power iteration at the bucket
    shapes of the 4-layer full-width plan (``TRAIN_BUCKETS``; the fused
    updates: ``update_kernel_cases``).  Inputs on the scale of the real
    ones: unit-normal gradient stacks, orthonormal projectors and sketch
    bases."""
    from repro_torch.kernels.galore_project.kernel import galore_project, galore_project_batched
    from repro_torch.kernels.galore_project.ref import galore_project_ref, project_ref
    from repro_torch.kernels.power_iter.kernel import power_iter_batched
    from repro_torch.kernels.power_iter.ref import power_iter_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = []

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def orthonormal(b, d, k):
        return torch.linalg.qr(randn(b, d, k))[0].contiguous()

    def record(name, label, dtype, err, main, timing):
        record_case(cases, results, name, label, dtype, err, main, timing)

    for d, n, r, b, _ in TRAIN_BUCKETS:
        label = f"B={b} d={d} n={n} r={r}"
        main = (d, n) == (4096, 14336)
        iters = 5 if main else 10
        # -- kernel 4: R = P^T G ------------------------------------------
        g = randn(b, d, n)
        p = orthonormal(b, d, r)
        got = galore_project_batched(g, p)
        want = project_ref(g, p)
        torch.cuda.synchronize()
        err = check_close(f"project {label}", got, want,
                          *TOL["galore_project_batched"]["float32"], rel_atol=True)
        del got, want
        b_ms, b_by = bound(4 * (b * d * n + b * d * r + b * r * n), 2 * b * r * d * n, "float32")
        record("galore_project_batched", label, torch.float32, err, main, timed_case(
            lambda: galore_project_batched(g, p), lambda: project_ref(g, p),
            lambda: torch.bmm(p.transpose(1, 2), g), b_ms, b_by, iters))
        del g, p
        torch.cuda.empty_cache()
        # -- kernel 9: Y = G (G^T Q), on the buckets whose sketch k' < d ---
        kp = min(4 * r + 8, d)
        if kp < d:
            g = randn(b, d, n)
            q = orthonormal(b, d, kp)
            got = power_iter_batched(g, q)
            want = power_iter_ref(g, q)
            torch.cuda.synchronize()
            err = check_close(f"power_iter {label} k'={kp}", got, want,
                              *TOL["power_iter_batched"]["float32"], rel_atol=True)
            del got, want
            b_ms, b_by = bound(4 * (b * d * n + 2 * b * d * kp), 4 * b * d * n * kp, "float32")
            record("power_iter_batched", f"{label} k'={kp}", torch.float32, err, main, timed_case(
                lambda: power_iter_batched(g, q), lambda: power_iter_ref(g, q),
                lambda: torch.bmm(g, torch.bmm(g.transpose(1, 2), q)), b_ms, b_by, 3))
            del g, q
            torch.cuda.empty_cache()

    # -- kernel 9 at online_pca's shape: its refresh takes one product
    # G (G^T P) per bucket at k' = rank (train_online_pca), on every bucket
    for d, n, r, b, _ in TRAIN_BUCKETS:
        label = f"B={b} d={d} n={n} r={r} k'={r} (online_pca)"
        g = randn(b, d, n)
        q = orthonormal(b, d, r)
        got = power_iter_batched(g, q)
        want = power_iter_ref(g, q)
        torch.cuda.synchronize()
        err = check_close(f"power_iter {label}", got, want,
                          *TOL["power_iter_batched"]["float32"], rel_atol=True)
        del got, want
        b_ms, b_by = bound(4 * (b * d * n + 2 * b * d * r), 4 * b * d * n * r, "float32")
        record("power_iter_batched", label, torch.float32, err, False, timed_case(
            lambda: power_iter_batched(g, q), lambda: power_iter_ref(g, q),
            lambda: torch.bmm(g, torch.bmm(g.transpose(1, 2), q)), b_ms, b_by, 5))
        del g, q
        torch.cuda.empty_cache()

    # -- kernel 10: the 2-D projection fused with Adam's moments, which no
    # path runs: the JAX benchmark's shape (main case) and an mlp leaf's
    for d, n, r in PROJECT_2D_SHAPES:
        label = f"d={d} n={n} r={r}"
        g = randn(d, n)
        p = orthonormal(1, d, r)[0]
        m = randn(r, n, scale=0.1)
        v = randn(r, n, scale=0.1) ** 2
        got = galore_project(g, p, m, v)
        want = galore_project_ref(g, p, m, v, b1=0.9, b2=0.999)
        torch.cuda.synchronize()
        err = max(check_close(f"project_2d {label} {part}", a, c,
                              *TOL["galore_project"]["float32"], rel_atol=True)
                  for part, a, c in zip(("R", "M'", "V'"), got, want))
        del got, want
        b_ms, b_by = bound(4 * (d * n + d * r + 5 * r * n), 2 * d * r * n + 7 * r * n,
                           "float32")
        record("galore_project", label, torch.float32, err, (d, n) == PROJECT_2D_SHAPES[0][:2],
               timed_case(lambda: galore_project(g, p, m, v),
                          lambda: galore_project_ref(g, p, m, v, b1=0.9, b2=0.999),
                          lambda: torch.mm(p.t(), g), b_ms, b_by, 10))
        del g, p, m, v
        torch.cuda.empty_cache()
    return cases


def update_kernel_cases(results, dev: str = "cuda", plans=None, main_dn=(4096, 14336)):
    """Kernels 5-8, the fused Adam, MSGD, Adam-mini and 8-bit Adam updates,
    against their plain versions at every bucket of their 4-layer
    full-width plans (``plans``: inner -> [(d, n, rank, B, side)]; Adam and
    MSGD on ``TRAIN_BUCKETS``, the others on ``SPLIT_BUCKETS``), f32 W, and
    bf16 W on the (d, n) = ``main_dn`` bucket of side left or any, whose
    f32 case is the kernel's main case.  Inputs on the scale of the real
    ones: orthonormal projectors, unit-normal projected gradients, weights
    ~0.02, moments of a few steps.  Each W' check fails unless its
    tolerance rejects at least a quarter of an unchanged W.  ``dev="cpu"``
    rehearses the cases (plain against plain, no timing) with small
    ``plans``."""
    from repro_torch.kernels.lowrank_update import quantize as qz

    plans = plans or {"adam": TRAIN_BUCKETS, "msgd": TRAIN_BUCKETS,
                      "adam_mini": SPLIT_BUCKETS, "adam8bit": SPLIT_BUCKETS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = []
    # The launcher's peak step size, lr 0.01 x alpha 0.25: the update
    # lr_alpha * |P @ N| is then several bf16 ulps of |W| ~ 0.02, so the
    # bf16 W' tolerance can see a lost or mis-scaled back-projection.
    step, lr_alpha, lr_wd = 3, 0.01 * 0.25, 0.0

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def orthonormal(b, d, k):
        return torch.linalg.qr(randn(b, d, k))[0].contiguous()

    for inner, plan in plans.items():
        name = UPDATE_KERNEL[inner]
        kernel, plain = fused_update(inner, dev == "cuda"), fused_update(inner, False)
        ikw = INNER_KW[inner]
        for d, n, r, b, side in plan:
            label = f"B={b} d={d} n={n} r={r} side={side}"
            main = (d, n) == main_dn and side != "right"
            iters = 5 if n == 14336 else 10
            p = orthonormal(b, d, r)
            rg = randn(b, r, n)
            m = randn(b, r, n, scale=0.1)
            if inner == "adam":
                state = (m, randn(b, r, n, scale=0.1) ** 2)
                state_bytes = 4 * 4 * b * r * n  # M, V read, M', V' written
            elif inner == "msgd":
                state = (m,)
                state_bytes = 4 * 2 * b * r * n  # M read, M' written
            elif inner == "adam_mini":
                rows = r if side == "left" else n
                state = (m, randn(b, rows, scale=0.1) ** 2)
                state_bytes = 4 * (2 * b * r * n + 2 * b * rows)
            else:
                mc, ms = qz.quantize_stacked(m, side, signed=True)
                vc, vs = qz.quantize_stacked(randn(b, r, n, scale=0.1) ** 2, side, signed=False)
                state = (mc, ms, vc, vs)
                state_bytes = 4 * b * r * n + 4 * 4 * ms.numel()  # codes and scales r/w
            del m
            for dtype in (torch.float32, torch.bfloat16) if main else (torch.float32,):
                dn = str(dtype).split(".")[-1]
                w = randn(b, d, n, scale=0.02).to(dtype)
                args = (w, p, rg, state, step, lr_alpha, lr_wd, side, ikw)
                got = kernel(*args)
                want = plain(*args)
                if dev == "cuda":
                    torch.cuda.synchronize()
                errs = check_update(inner, f"{inner} {label} {dn}", got, want, dn)
                err = max(v for v in errs.values() if isinstance(v, float))
                _, off, _ = off_tolerance(w, want[0], *TOL[name][dn], rel_atol=True)
                seen = float(off.float().mean())
                if seen < 0.25:
                    raise AssertionError(f"{inner} {label} {dn}: the W' tolerance rejects "
                                         f"only {seen:.3f} of an unchanged W")
                log(f"{inner} {label} {dn}: {errs}; the W' tolerance rejects {seen:.3f} "
                    "of an unchanged W")
                del got, want, off
                es = w.element_size()
                nbytes = 2 * b * d * n * es + 4 * (b * d * r + b * r * n) + state_bytes
                b_ms, b_by = bound(nbytes, 2 * b * d * r * n + 12 * b * r * n, "float32")
                timing = {"bound_ms": b_ms, "bound_by": b_by}
                if dev == "cuda":
                    timing = timed_case(
                        lambda: kernel(*args), lambda: plain(*args),
                        (lambda: torch.baddbmm(w, p, rg, beta=1.0 - lr_wd, alpha=-lr_alpha))
                        if dtype == torch.float32 else None, b_ms, b_by, iters)
                record_case(cases, results, name, label, dtype, err,
                            main and dtype == torch.float32, timing)
                del w, args
            del p, rg, state
            if dev == "cuda":
                torch.cuda.empty_cache()
    return cases


# Kernel 8 on a block of rows cut over processes (8-bit Adam's free dim
# under tensor parallelism or FSDP): (B, d, local n, r) of 'left' blocks
# whose edges fall inside a chunk -- n 4480 is qwen2-1.5b's mlp block at a
# model extent of 2 (``train_tp_inners``), 192 and 320 the CPU tests'
# widths, two blocks a row
CUT_8BIT_CASES = [(2, 1536, 4480, 384), (2, 128, 192, 64), (2, 128, 320, 64)]


class GivenAbsmax:
    """The ``reduce`` of kernel 8's cut rows in one process: hands back the
    whole chunks' absmax of the new moments (m's, then v's, in the order
    the update asks; the same version's whole-row absmax), after checking
    the pieces it is given against them: never above, and equal on every
    chunk the block holds whole."""

    def __init__(self, m_abs, v_abs, whole):
        self.wants, self.whole, self.seen = [m_abs, v_abs], whole, []

    def __call__(self, am):
        want = self.wants[len(self.seen) % 2]
        self.seen.append(am)
        if bool((am > want).any()) or not torch.equal(am[..., self.whole],
                                                      want[..., self.whole]):
            raise AssertionError("kernel 8's absmax launch: a piece above its chunk's "
                                 "absmax, or a whole chunk's not its own")
        return want.clone()


def cut_adam8bit_cases(results, dev: str = "cuda"):
    """Kernel 8 with a chunk offset and given scales (``CUT_8BIT_CASES``,
    f32 and bf16 W): each block of a row of two against the plain version
    with the same offset and scales, and against the kernel's whole row
    (one process's), whose codes and scales the block's must be (codes
    within one step).  The straddling chunks' absmax comes from
    ``GivenAbsmax``, each version's from its own whole-row update (at
    offset 0 every chunk is whole)."""
    from repro_torch.kernels.lowrank_update import quantize as qz

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    kernel, plain = fused_update("adam8bit", dev == "cuda"), fused_update("adam8bit", False)
    ikw, name = INNER_KW["adam8bit"], UPDATE_KERNEL["adam8bit"]
    step, lr_alpha = 3, 0.01 * 0.25
    cases = []

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for b, d, n, r in CUT_8BIT_CASES:
        total = 2 * n
        p = torch.linalg.qr(randn(b, d, r))[0].contiguous()
        rg = randn(b, r, total)
        mc, ms = qz.quantize_stacked(randn(b, r, total, scale=0.1), "left", signed=True)
        vc, vs = qz.quantize_stacked(randn(b, r, total, scale=0.1) ** 2, "left", signed=False)

        def whole_row(fn, w):
            seen = []
            out = fn(w, p, rg, (mc, ms, vc, vs), step, lr_alpha, 0.0, "left", dict(
                ikw, reduce=lambda am: (seen.append(am.clone()), am)[1]))
            return out, seen

        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            w = randn(b, d, total, scale=0.02).to(dtype)
            whole, k_abs = whole_row(kernel, w)
            _, p_abs = whole_row(plain, w)
            for j in range(2):
                lo, hi = j * n, (j + 1) * n
                c0, c1 = lo // qz.QBLOCK, qz.num_blocks(hi)
                qoff = lo % qz.QBLOCK
                # the chunks this block holds whole
                held = [c for c in range(c0, c1) if c * qz.QBLOCK >= lo
                        and min((c + 1) * qz.QBLOCK, total) <= hi]
                state = (mc[..., lo:hi].contiguous(), ms[..., c0:c1].contiguous(),
                         vc[..., lo:hi].contiguous(), vs[..., c0:c1].contiguous())
                args = [w[..., lo:hi].contiguous(), p, rg[..., lo:hi].contiguous(), state, step,
                        lr_alpha, 0.0, "left"]
                label = f"B={b} d={d} n={n} of {total} r={r} block {j} (offset {qoff})"

                def given(whole_abs):
                    return GivenAbsmax(whole_abs[0][..., c0:c1], whole_abs[1][..., c0:c1],
                                       [c - c0 for c in held])

                got = kernel(*args, dict(ikw, qoff=qoff, reduce=given(k_abs)))
                want = plain(*args, dict(ikw, qoff=qoff, reduce=given(p_abs)))
                if dev == "cuda":
                    torch.cuda.synchronize()
                errs = check_update("adam8bit", f"cut {label} {dn}", got, want, dn)
                # one process's whole row, cut to the block
                one = (whole[0][..., lo:hi], whole[1][..., lo:hi], whole[2][..., c0:c1],
                       whole[3][..., lo:hi], whole[4][..., c0:c1])
                errs["one_process"] = check_update("adam8bit", f"cut {label} {dn} vs one process",
                                                   got, one, dn)
                err = max(v for v in errs.values() if isinstance(v, float))
                es = w.element_size()
                nbytes = 2 * b * d * n * es + 4 * (b * d * r + b * r * n) + 4 * b * r * n \
                    + 4 * 4 * state[1].numel()
                b_ms, b_by = bound(nbytes, 2 * b * d * r * n + 12 * b * r * n, "float32")
                timing = {"bound_ms": b_ms, "bound_by": b_by}
                if dev == "cuda":
                    timing = timed_case(
                        lambda: kernel(*args, dict(ikw, qoff=qoff, reduce=given(k_abs))),
                        lambda: plain(*args, dict(ikw, qoff=qoff, reduce=given(p_abs))),
                        None, b_ms, b_by, 5)
                record_case(cases, results, name, f"cut rows {label}", dtype, err, False, timing)
                log(f"adam8bit cut {label} {dn}: {errs}")
                del got, want, args, state
            del w, whole, k_abs, p_abs
        del p, rg, mc, ms, vc, vs
        if dev == "cuda":
            torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase 3: serve full-width llama3-8b through the continuous engine
# ---------------------------------------------------------------------------


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def request_prefixes(cfg, n: int, dev: str = "cuda", seed: int = SEED + 7):
    """Each of ``n`` requests' own prefix, seeded, normal x 0.1 in the
    activation dtype (as the JAX package's ``configs/specs.py:76-78``): vlm
    ``n_patches`` patch embeddings, audio ``enc_frames`` frames; an empty
    dict for the other families."""
    if cfg.family not in ("vlm", "audio"):
        return [{} for _ in range(n)]
    key, rows = (("patch_embeds", cfg.n_patches) if cfg.family == "vlm"
                 else ("frame_embeds", cfg.enc_frames))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{key: (torch.randn(rows, cfg.d_model, generator=gen, device=dev) * 0.1).to(cfg.dtype)}
            for _ in range(n)]


def prefix_kv(cfg) -> int:
    """KV positions a request's prefix takes: the vlm family's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def with_prefix(batch: dict, extras: dict) -> dict:
    """A batch-1 model batch: ``batch`` and the request's extras with a
    batch axis."""
    return {**batch, **{k: v[None] for k, v in extras.items()}}


class PrefixData:
    """``data.batch_at(step)`` with the family's prefix added to every
    batch (``request_prefixes``' draw, one per row, seeded by the step):
    the train paths of the VLM and enc-dec families."""

    def __init__(self, data, cfg, dev: str = "cuda"):
        self.data, self.cfg, self.dev = data, cfg, dev

    def batch_at(self, step: int) -> dict:
        batch = dict(self.data.batch_at(step))
        rows = request_prefixes(self.cfg, batch["tokens"].shape[0], self.dev,
                                seed=SEED + 100 + step)
        for key in rows[0]:
            batch[key] = torch.stack([r[key] for r in rows])
        return batch


def forward_launches(cfg):
    """((rmsnorm, flash) launches of one forward pass, (rmsnorm, flash)
    launches of the remat recompute in its backward).  The enc-dec model:
    2 norms and 1 attention per encoder layer, 3 norms (self, cross, mlp)
    and 2 attentions (self, cross) per decoder layer, a final norm each."""
    if cfg.family == "audio":
        ne, nd = cfg.n_enc_layers, cfg.n_layers
        return (2 * ne + 3 * nd + 2, ne + 2 * nd), (2 * ne + 3 * nd, ne + 2 * nd)
    norms, attns = LAYER_LAUNCHES[cfg.family]
    nl = cfg.n_layers
    return (norms * nl + 1, attns * nl), (norms * nl, attns * nl)


def serve(cfg, dev: str = "cuda", profile_ticks: int = 8, pool_pages: int = POOL_PAGES):
    """Phase 3 (see the module docstring), or ``serve_moe`` with an MoE
    config, ``serve_vlm`` with a VLM one (each request's patches ahead of
    its prompt, in its pages; ``pool_pages`` usable pages); ``dev="cpu"``
    rehearses it at a small size without a card.  The serving weights are
    made leaf by leaf in bf16 (``init(..., serving=True)``): deepseek-moe-
    16b's f32 tree (65.6 GB) and its bf16 copy would not fit the card
    together, and llava-next-34b's bf16 tree alone takes 65 GiB."""
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.kernels import counters
    from repro_torch.models import build_model, count_params
    from repro_torch.models import moe as moe_lib
    from repro_torch.serve import kv_cache as kvc
    from repro_torch.serve import paged_decode as pgd
    from repro_torch.serve.engine import ContinuousEngine

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), serving=True)
    sync()
    init_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    n_params = count_params(params)
    log(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params made in bf16 in {time.perf_counter() - t0:.1f} s, "
        f"peak {init_peak / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]
    extras = request_prefixes(cfg, len(PROMPT_LENS), dev)
    pre = prefix_kv(cfg)

    eng = ContinuousEngine(
        model, params, max_slots=MAX_SLOTS, page_size=PAGE_SIZE,
        max_seq_len=pre + max(PROMPT_LENS) + NEW_TOKENS, num_pages=pool_pages + 1,
    )
    for p, a, e in zip(prompts, ARRIVALS, extras):
        eng.submit(p, NEW_TOKENS, arrival=a, extras=e or None)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters.reset()
    moe_lib.HOST_SYNCS[0] = 0
    t0 = time.perf_counter()
    results = eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = counters.snapshot()
    syncs = moe_lib.HOST_SYNCS[0]
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    n_req, ticks, nl = len(PROMPT_LENS), eng.decode_steps, cfg.n_layers
    emitted = sum(len(r.tokens) for r in results.values())
    log(f"served {len(results)} requests, {emitted} tokens, {eng.total_ticks} "
        f"ticks ({ticks} decode steps) in {wall:.3f} s: {emitted / wall:.1f} tokens/s; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; MoE group-size host syncs {syncs} "
        f"({syncs / (ticks + n_req):.1f} per prefill or decode step)")
    log(f"launches {launches}")
    if sorted(results) != list(range(n_req)):
        raise AssertionError(f"finished requests {sorted(results)}")
    for rid, r in results.items():
        if len(r.tokens) != NEW_TOKENS or r.finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(r.tokens)} tokens, {r.finish_reason}")
    if eng.kv.allocator.used_pages != 0:
        raise AssertionError(f"pool not drained: {eng.kv.allocator.used_pages} pages in use")
    total_ticks = eng.total_ticks
    del eng  # frees the pool; the serving params stay in ``params``
    profile = profile_serving(model, params, profile_ticks) if dev == "cuda" else None
    waited = [r.admit_tick - r.arrival for r in results.values()]
    reserved = sum(kvc.pages_needed(pre + n + NEW_TOKENS, PAGE_SIZE) for n in PROMPT_LENS)
    if max(waited) <= 0 or reserved <= pool_pages:
        raise AssertionError("scenario did not make admission wait and pages recycle")
    expect = {
        "rmsnorm": (LAYER_LAUNCHES[cfg.family][0] * nl + 1) * (ticks + n_req),
        "paged_decode_attention": nl * ticks,
        "flash_attention_fwd": nl * n_req,
    }
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if syncs != (nl * (ticks + n_req) if cfg.family == "moe" else 0):
        raise AssertionError(f"{syncs} MoE host syncs for {ticks + n_req} steps of {nl} layers")

    # Request 0: paged kernel path vs the static engine's path (ring cache,
    # plain exact attention), both bf16, feeding both the same first token.
    # The bar is the bf16 noise floor: the static path's distance to the
    # same model in f32, at full depth where the f32 params fit the card
    # beside the run's own state, else at the deepest depth that does (the
    # bf16 static path then again at that depth, from the same seed).
    p0 = torch.as_tensor(prompts[0], device=dev)[None]
    b0 = with_prefix({"tokens": p0}, extras[0])
    kv0 = pre + p0.shape[1]  # the prompt's KV positions, patches included
    n0 = kvc.pages_needed(kv0 + 1, PAGE_SIZE)
    kv = kvc.PagedKVCache.build(cfg, 1, PAGE_SIZE, 1 + n0, n0, device=dev)
    row = torch.from_numpy(kv.admit(0, kv0 + 1)).to(dev)
    prefill_k, cache = model.prefill(params, b0)
    pgd.write_prompt(kv.pages_k, kv.pages_v, cache.k[:, 0], cache.v[:, 0], cache.pos[0], row)
    kv.seq_lens[0] = kv0
    tok0 = prefill_k.argmax(dim=-1).to(torch.int32)
    pt, sl = kv.device_tables()
    decode_k, _, _ = pgd.make_paged_step(model)(
        params, kv.pages_k, kv.pages_v, pt, sl,
        torch.ones(1, dtype=torch.bool, device=dev), tok0,
    )
    del kv, cache
    exact = build_model(cfg.with_(attn_impl="exact"), device=dev)
    prefill_s, cache_s = exact.prefill(params, b0, kv0 + 1)
    decode_s, _ = exact.decode(params, cache_s, {"token": tok0[:, None]})
    layer_numel = sum(p.numel() for p in tree_leaves(params["blocks"])) // cfg.n_layers
    del cache_s, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    depth = cfg.n_layers
    if dev == "cuda":
        room = torch.cuda.mem_get_info()[0] - 8 * 2**30 - 4 * (n_params - layer_numel * depth)
        depth = max(1, min(depth, room // (4 * layer_numel)))
    noise_s = (prefill_s, decode_s)
    if depth < cfg.n_layers:  # the bf16 static path again at the f32 model's depth
        cut = build_model(cfg.with_(attn_impl="exact", n_layers=depth), device=dev)
        params_c = cut.init(torch.Generator(device=dev).manual_seed(SEED), serving=True)
        pc, cache_c = cut.prefill(params_c, b0, kv0 + 1)
        noise_s = (pc, cut.decode(params_c, cache_c, {"token": tok0[:, None]})[0])
        del params_c, cache_c
    if dev == "cuda":
        log(f"before the f32 model: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    log(f"bf16 noise floor from the f32 model at depth {depth} of {cfg.n_layers}")
    cfg32 = cfg.with_(attn_impl="exact", dtype=torch.float32, n_layers=depth)
    exact32 = build_model(cfg32, device=dev)
    params32 = exact32.init(torch.Generator(device=dev).manual_seed(SEED))
    prefill_f, cache_f = exact32.prefill(params32, b0, kv0 + 1)
    decode_f, _ = exact32.decode(params32, cache_f, {"token": tok0[:, None]})
    del params32, cache_f
    # The serving bar: twice the static path's distance to the f32 model.  An
    # MoE model's two bf16 paths also route some tokens to other experts
    # than the f32 model does, each path its own tokens, so they lie ~sqrt(2)
    # times that distance apart (1.08 and 1.56 times on deepseek-moe-16b's
    # prefill in two runs on the H100, as the atomics' order moves the
    # near-ties): the same factor of two over that expected distance
    bar_factor = 2.0 * (2.0**0.5 if cfg.family == "moe" else 1.0)
    parity = {"noise_depth": depth, "bar_factor": bar_factor}
    for what, k_, s_, n_, f_ in (("prefill", prefill_k, prefill_s, noise_s[0], prefill_f),
                                 ("decode1", decode_k, decode_s, noise_s[1], decode_f)):
        err, noise = rel_l2(k_, s_), rel_l2(n_, f_)
        tol = max(bar_factor * noise, 1e-3)
        parity[what] = {
            "rel_l2_kernel_vs_static": err, "rel_l2_static_bf16_vs_f32": noise,
            "tolerance": tol, "max_abs_kernel_vs_static": float((k_ - s_).abs().max()),
            "argmax_equal": bool((k_.argmax(-1) == s_.argmax(-1)).all()),
            "finite": bool(torch.isfinite(k_).all()),
        }
        log(f"request 0 {what} logits: {parity[what]}")
        if not parity[what]["finite"] or err > tol:
            raise AssertionError(f"request 0 {what} logits disagree: {parity[what]}")
    if results[0].tokens[0] != int(tok0[0]):
        log("note: the engine's first token for request 0 differs from the lone run")
    return {
        "arch": cfg.arch_id, "params": n_params, "init_peak_bytes": init_peak,
        "requests": n_req, "tokens": emitted, "ticks": total_ticks,
        "decode_steps": ticks, "wall_s": wall, "tokens_per_s": emitted / wall,
        "moe_host_syncs": syncs,
        "max_memory_allocated": peak, "launches": launches, "expected": expect,
        "admission_waits": waited, "pages_reserved": reserved,
        "pool_pages": pool_pages, "request0_parity": parity, "profile": profile,
    }


def profile_serving(model, params, new_tokens: int = 8):
    """Device time by kernel over a short continuous run under
    torch.profiler: 4 requests of 512 tokens (after their patches, for a
    VLM) admitted together, then
    ``new_tokens`` - 1 decode ticks (7; 3 for the MoE model, whose ticks
    hold ~10x the events for the profiler to sum up, and for the 60-layer
    VLM).  Summing the events up takes far longer than the run (on the
    H100, NVIDIA H100 80GB HBM3, 700.00 W: 45 s for llama's 23 ticks and
    69 s for deepseek's 8, where the script summed them twice), so the
    window is short.  Device busy share =
    summed kernel time / host wall time (one stream, so kernels do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ContinuousEngine

    eng = ContinuousEngine(model, params, max_slots=4, page_size=PAGE_SIZE,
                           max_seq_len=prefix_kv(model.cfg) + 512 + new_tokens)
    rng = np.random.default_rng(SEED + 1)
    for e in request_prefixes(model.cfg, 4, seed=SEED + 8):
        eng.submit(rng.integers(0, model.cfg.vocab_size, (512,)), new_tokens, extras=e or None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    groups = {"matmul": 0.0, "flash_attention_fwd": 0.0,
              "paged_decode_attention": 0.0, "rmsnorm": 0.0, "other": 0.0}
    kernels = []
    averages = prof.key_averages()  # summed once: tens of seconds on a deep model
    for e in averages:
        us = _device_us(e)
        if us <= 0 or not _is_kernel(e) or e.key.startswith(("Memcpy", "Memset")):
            continue
        name = e.key
        low = name.lower()
        if "flash_fwd" in low:
            g = "flash_attention_fwd"
        elif "paged_decode" in low:
            g = "paged_decode_attention"
        elif "rmsnorm" in low:
            g = "rmsnorm"
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma")):
            g = "matmul"
        else:
            g = "other"
        groups[g] += us / 1e3
        kernels.append((us / 1e3, e.count, name[:90]))
    kernels.sort(reverse=True)
    host_ops = sorted(
        ((e.self_cpu_time_total / 1e3, e.count, e.key[:60]) for e in averages
         if e.self_cpu_time_total > 0),
        reverse=True,
    )
    busy = sum(groups.values())
    out = {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "decode_steps": eng.decode_steps, "ms_by_group": groups,
        "top_kernels": [{"ms": t, "count": c, "name": n} for t, c, n in kernels[:12]],
        "top_host_ops": [{"self_cpu_ms": t, "count": c, "name": n} for t, c, n in host_ops[:15]],
    }
    log(f"profile: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({out['device_busy_share']:.3f}), {eng.decode_steps} decode steps")
    log("profile by group (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))
    for t, c, n in kernels[:8]:
        log(f"  {t:9.3f} ms  x{c:<6d} {n}")
    log("profile, host self time of the top ops (ms):")
    for t, c, n in host_ops[:10]:
        log(f"  {t:9.3f} ms  x{c:<6d} {n}")
    return out


# ---------------------------------------------------------------------------
# phase 4: pretrain full-width llama3-8b (depth cut) with galore-sara-adam
# ---------------------------------------------------------------------------


def train(cfg, optimizer: str = "galore-sara-adam", expect_buckets=TRAIN_BUCKETS,
          dev: str = "cuda", steps: int = TRAIN_STEPS, seq: int = TRAIN_SEQ,
          batch: int = TRAIN_BATCH, opt_kw=None, check_grads: bool = False,
          profile: bool = True):
    """Phase 4 (see the module docstring) with one optimizer, whose bucket
    plan must be ``expect_buckets`` ((d, n, rank, B, side) per bucket), or
    whose state must be per leaf where ``expect_buckets`` is None (Fira,
    Adafactor and the reference engine: no bucket-native state, and no
    plan beyond the bucketed engine's accounting); ``dev="cpu"`` with a
    smoke config rehearses it without a card.  Any family: the launch
    counts follow ``LAYER_LAUNCHES``; an MoE model's router aux loss must
    be finite at every step, and ``check_grads`` first takes the step-0
    gradient and requires every element finite.  The VLM and enc-dec
    families' batches carry their prefix (``PrefixData``)."""
    import math

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import state_memory_bytes, tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.models import build_model, count_params
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import make_train_step

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    opt_kw = dict(TRAIN_OPT, **(opt_kw or {}))
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    # a directory of the phase's own (train_loop resumes from any that holds
    # checkpoints); 3 steps write none
    ckpt_dir = fresh_dir(f"train_ckpt_{optimizer}")
    tc = TrainConfig(total_steps=steps, seed=SEED, checkpoint_every=0,
                     checkpoint_dir=str(ckpt_dir))
    params = model.init(torch.Generator(device=dev).manual_seed(tc.seed))
    n_params = count_params(params)
    opt = make_optimizer(
        optimizer, params,
        lr_schedule=cosine_with_warmup(opt_kw["lr"], TRAIN_WARMUP, steps), **opt_kw)
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    del params  # train_loop makes the same params from tc.seed and owns them
    inner = opt.config.inner
    if expect_buckets is None:
        if opt.state_layout is not None:
            raise AssertionError(f"{optimizer}: bucket-native state where per-leaf is expected")
        plan = None
    else:
        plan = [(bk.d, bk.n, bk.rank, bk.batch, bk.side) for bk in opt.bucket_plan.buckets]
        if plan != list(expect_buckets) or opt.state_layout is None:
            raise AssertionError(f"bucket plan {plan} != {expect_buckets}")
    data = SyntheticDataset(
        SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
        device=dev)
    if cfg.family in ("vlm", "audio"):  # every batch carries its patches or frames
        data = PrefixData(data, cfg, dev)
    grads_finite = finite_grads(model, tc.seed, data.batch_at(0)) if check_grads else None
    # Memory by phase of each step (``timed`` below opens and closes it):
    # allocated at its start, the peak of forward and backward, the peak of
    # the optimizer update.
    phase_mem = []

    def update_probe(*a, **k):
        if dev == "cuda":
            phase_mem[-1].append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        return opt.update(*a, **k)

    fns = make_train_step(model, opt._replace(update=update_probe), train_cfg=tc)
    sync()
    log(f"train: {cfg.arch_id} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params f32, buckets {plan}, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    step_ms, step_peak, aux = [], [], []

    def timed(fn):
        def run(*a, **k):
            sync()
            if dev == "cuda":
                phase_mem.append([torch.cuda.memory_allocated()])
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if dev == "cuda":
                phase_mem[-1].append(torch.cuda.max_memory_allocated())
                step_peak.append(max(phase_mem[-1][1:]))
            else:
                step_peak.append(0)
            if "aux" in out[1]:
                aux.append(float(out[1]["aux"]))
            return out
        return run

    loop_fns = dict(fns, step=timed(fns["step"]), refresh_step=timed(fns["refresh_step"]))
    counters.reset()
    res = train_loop(model, opt, data, tc, loop_fns, log_every=1)
    sync()
    launches = counters.snapshot()
    peak = max(step_peak)
    state = res.state
    tokens = batch * seq
    hot_ms = sum(step_ms[1:]) / max(len(step_ms) - 1, 1)
    log(f"train {optimizer}: losses {res.losses}; refresh step {step_ms[0]:.1f} ms, hot steps "
        f"{[round(t, 1) for t in step_ms[1:]]} ms: {tokens / hot_ms * 1e3:.1f} tokens/s "
        f"hot; max_memory_allocated per step "
        f"{[round(b / 2**30, 2) for b in step_peak]} GiB")
    log(f"train launches {launches}")
    log("train memory by step, GiB [at start, forward+backward peak, update peak]: "
        f"{[[round(b / 2**30, 2) for b in m] for m in phase_mem]}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"non-finite training loss: {res.losses}")
    # random weights: the normed hidden state has unit mean square and the
    # lm_head is drawn at scale 0.02, so the logits spread as N(0, s^2) with
    # s^2 = 0.02^2 d_model, and the first loss sits near ln(vocab) + s^2 / 2
    # (0.82 above ln(vocab) at llama's 4096, 1.43 at llava's 7168)
    loss0 = math.log(cfg.vocab_size) + 0.02**2 * cfg.d_model / 2
    if abs(res.losses[0] - loss0) > 1.0:
        raise AssertionError(
            f"first loss {res.losses[0]:.3f} is not near ln(vocab) + 0.02^2 d_model / 2 = "
            f"{loss0:.3f} for random weights")
    if cfg.family == "moe" and not (len(aux) == steps and all(map(math.isfinite, aux))):
        raise AssertionError(f"router aux loss not finite at every step: {aux}")
    nl = cfg.n_layers
    (fwd_norms, fwd_attns), (remat_norms, remat_attns) = forward_launches(cfg)
    expect = {
        # per step: the blocks' norms and the final norms forward, the
        # blocks' again in the remat recompute of each block
        "rmsnorm": steps * (fwd_norms + remat_norms),
        "flash_attention_fwd": steps * (fwd_attns + remat_attns),
        # one refresh (step 0): a power-iteration product per bucket, or
        # per low-rank leaf on per-leaf state
        "power_iter_batched": power_iter_calls(opt, shapes),
    }
    if plan is not None:
        nb = len(plan)
        expect["galore_project_batched"] = steps * nb
        expect[UPDATE_KERNEL[inner]] = steps * nb  # the inner's fused update
    expect = {k: v for k, v in expect.items() if v}
    if launches != expect:
        raise AssertionError(f"train launch counts {launches} != expected {expect}")

    # One more hot step's stacks, bucket by bucket: R, then the inner's
    # update (W' and its state) from the kernels against the plain versions
    # on the same inputs (bucket-native paths; the per-leaf paths' hot step
    # is plain products).
    parity = (hot_step_parity("train", model, opt, state, data.batch_at(steps), dev)
              if plan is not None else [])
    profile = (profile_train_step(make_train_step(model, opt, train_cfg=tc), state,
                                  data.batch_at(steps)) if dev == "cuda" and profile else None)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {
        "arch": cfg.arch_id, "optimizer": optimizer, "layers": nl, "params": n_params,
        "buckets": plan, "steps": steps, "seq": seq, "batch": batch,
        "aux_losses": aux, "step0_grads": grads_finite,
        "tokens_per_step": tokens, "losses": res.losses, "history": res.history,
        "refresh_step_ms": step_ms[0], "hot_step_ms": step_ms[1:],
        "hot_tokens_per_s": tokens / hot_ms * 1e3,
        "max_memory_allocated": peak, "max_memory_allocated_per_step": step_peak,
        "memory_by_phase": phase_mem, "state_bytes": state_memory_bytes(state.opt_state),
        "launches": launches, "expected": expect,
        "hot_step_parity": parity, "profile": profile,
    }


PARITY_CHUNK = 64  # slices per plain-version call in hot_step_parity


def hot_step_parity(path: str, model, opt, state, batch, dev: str = "cuda", grads=None,
                    zero_axes=None):
    """One more hot step's stacks from ``state`` (bucket-native), bucket by
    bucket: R from the projection kernel, then the inner's fused update (W'
    and its state) from its kernel, each against its plain version on the
    same inputs.  ``grads`` (flat, this process's) stands for the
    gradients of ``model`` on ``batch``.  ``zero_axes`` (ZeRO state on the
    FSDP step, ``StateLayout.zero_rows``): a bucket of rows has its R
    reduce-scattered into this process's rows as the step does
    (``buckets._zero_rows_r``), and both versions run the split schedule
    (``gather``): W' on every row of the block, the moments on the rows.
    Returns one record per bucket."""
    from repro_torch.core import buckets as buckets_lib
    from repro_torch.core.lowrank import tree_leaves, tree_unflatten
    from repro_torch.kernels.galore_project import kernel as project_kernel
    from repro_torch.kernels.galore_project.ref import project_ref

    inner = opt.config.inner
    step = state.opt_state.step + 1
    lr = opt.config.lr_schedule(state.opt_state.step)
    lr_alpha, lr_wd = lr * opt.config.alpha, lr * opt.config.weight_decay
    ikw = opt.config.inner_kwargs()
    kernel_update = fused_update(inner, dev == "cuda")
    plain_update = fused_update(inner, False)
    flat_p = tree_leaves(state.params)
    if grads is not None:
        flat_g = list(grads)
    else:
        leaves = [p.detach().requires_grad_(True) for p in flat_p]
        loss, _ = model.loss(tree_unflatten(state.params, leaves), batch)
        flat_g = list(torch.autograd.grad(loss, leaves))
        del leaves, loss
    parity = []
    tp = opt.tp
    zero_rows = opt.state_layout.zero_rows if zero_axes is not None else ()
    for bi, (bk, bst) in enumerate(zip(opt.bucket_plan.buckets, state.opt_state.buckets)):
        # a bucket whose n a process axis cuts: Adam-mini's row sums and
        # 8-bit Adam's straddling chunks over it (both versions alike)
        kw = dict(ikw, **buckets_lib._cut_kwargs(
            inner, bk, tp.axes if tp is not None else None,
            tp.data_axes if tp is not None else None))
        w = buckets_lib._gather(bk, flat_p)
        g = buckets_lib._gather(bk, flat_g)
        if dev == "cuda":
            r_k = project_kernel.galore_project_batched(g, bst.projector)
        else:
            r_k = project_ref(g, bst.projector)
        r_p = project_ref(g, bst.projector)
        del g
        label = f"bucket d={bk.d} n={bk.n} r={bk.rank} B={bk.batch} side={bk.side}"
        errs = {"R": check_close(f"{path} {label} R", r_k, r_p,
                                 *TOL["galore_project_batched"]["float32"], rel_atol=True)}
        del r_k
        if zero_rows and zero_rows[bi]:
            r_p, kw["gather"] = buckets_lib._zero_rows_r(
                bk, r_p, tp.axes if tp is not None else None, zero_axes, opt.state_layout)
            label += f" rows {r_p.shape[0]}"
        args = (w, bst.projector, r_p, bucket_state(inner, bst), step, lr_alpha, lr_wd,
                bk.side, kw)
        got = kernel_update(*args)  # on the whole stack
        # the plain version in chunks of slices (each slice's update is its
        # own): its f32 temporaries for all 384 slices of an expert bucket
        # would not fit beside the kernel's output.  The split schedule in
        # one call: its gather spans every row
        chunk = bk.batch if "gather" in kw else PARITY_CHUNK
        for lo in range(0, bk.batch, chunk):
            cut = lambda x: x[lo:lo + chunk] if torch.is_tensor(x) else x  # noqa: E731
            want = plain_update(*(tuple(map(cut, a)) if isinstance(a, tuple) else cut(a)
                                  for a in args))
            for k, e in check_update(inner, f"{path} {label} [{lo}:]", tuple(map(cut, got)),
                                     want, "float32").items():
                # codes' (largest step, share apart) merge part by part
                errs[k] = e if k not in errs else (
                    tuple(map(max, errs[k], e)) if isinstance(e, tuple) else max(errs[k], e))
            del want
        del got, w, r_p, args
        if dev == "cuda":
            torch.cuda.empty_cache()
        log(f"{path} hot-step {label}: kernel vs plain max abs err {errs}")
        parity.append({"bucket": label, "max_abs_err": errs})
    return parity


def power_iter_calls(opt, shapes) -> int:
    """Power-iteration launches of one refresh: per bucket on bucket-native
    state, per low-rank leaf (all its stacked slices in one call) on
    per-leaf state.  The randomized SVD (dominant, sara) iterates
    ``svd_power_iters`` times where its sketch k' is narrower than d;
    online_pca takes one product G (G^T P) at k' = rank, on every unit.
    ``shapes``: the params' shapes in flat order (read on per-leaf state
    only)."""
    from repro_torch.core import projectors as proj_lib
    from repro_torch.core import svd as svd_lib

    cfg = opt.config
    if cfg.method == "online_pca":
        per_unit = lambda d, n, r: 1  # noqa: E731
    elif cfg.method in ("dominant", "sara") and cfg.svd_backend == "randomized":
        def per_unit(d, n, r):
            k = r if cfg.method == "dominant" else min(d, cfg.sara_pool_factor * r)
            _, kp, iters = svd_lib.clamp_sketch(d, n, k, cfg.svd_oversample,
                                                cfg.svd_power_iters)
            return iters if kp < d else 0
    else:
        return 0
    if opt.state_layout is not None:
        # a stack too large for one refresh chain runs in chunks, each
        # with its own power iterations (projectors.refresh_chunk)
        # a tensor-parallel or FSDP bucket refreshes at its global leaves'
        # (d, n) (``Bucket.global_dims``): gathered -- each process of the
        # axis that cuts d its block of the slices, where they divide -- or
        # its columns of the sketch
        def chunks(bk):
            if cfg.method not in ("dominant", "sara") or cfg.svd_backend != "randomized":
                return 1
            d, n = bk.global_dims()
            k = bk.rank if cfg.method == "dominant" else min(d, cfg.sara_pool_factor * bk.rank)
            _, kp, _ = svd_lib.clamp_sketch(d, n, k, cfg.svd_oversample, 0)
            b = bk.batch
            for kind, size in ((bk.split, bk.tp), (bk.dsplit, bk.dp)):
                if kind == "d" and size > 1 and b % size == 0:
                    b //= size
            return -(-b // proj_lib.refresh_chunk(b, d, n, kp))
        return sum(per_unit(*bk.global_dims(), bk.rank) * chunks(bk)
                   for bk in opt.bucket_plan.buckets)
    return sum(per_unit(min(shape[-2:]), max(shape[-2:]), spec.rank)
               for spec, shape in zip(opt.specs, shapes) if spec.lowrank)


def profile_train_step(fns, state, batch):
    """Device time by kernel over one hot step under torch.profiler, after
    one unprofiled hot step (the first profiled step of a run once took
    455 ms against 327 ms unprofiled); busy share = summed kernel time /
    host wall time (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    fns["step"](state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fns["step"](state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"matmul": 0.0, "galore_project_batched": 0.0,
              "fused update": 0.0, "flash_attention_fwd": 0.0,
              "rmsnorm": 0.0, "other": 0.0}
    kernels = []
    for e in prof.key_averages():
        us = _device_us(e)
        if us <= 0 or not _is_kernel(e) or e.key.startswith(("Memcpy", "Memset")):
            continue
        low = e.key.lower()
        if "batched_gemm" in low and "storef32" in low:
            g = "galore_project_batched"
        elif any(w in low for w in ("weightapply", "moments_kernel", "adam8bit_")):
            g = "fused update"  # the inner's moments pass and back-projection
        elif "flash_fwd" in low:
            g = "flash_attention_fwd"
        elif "rmsnorm" in low:
            g = "rmsnorm"
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma")):
            g = "matmul"
        else:
            g = "other"
        groups[g] += us / 1e3
        kernels.append((us / 1e3, e.count, e.key[:90]))
    kernels.sort(reverse=True)
    busy = sum(groups.values())
    log(f"train profile: one hot step, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall_ms:.3f})")
    log("train profile by group (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))
    for t, c, n in kernels[:10]:
        log(f"  {t:9.3f} ms  x{c:<6d} {n}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "ms_by_group": groups,
            "top_kernels": [{"ms": t, "count": c, "name": n} for t, c, n in kernels[:15]]}


# ---------------------------------------------------------------------------
# phase 4b: recovery and rank schedules
# ---------------------------------------------------------------------------


def state_checksums(state):
    """(path, value) per leaf of a train state: for a tensor the int64 sum
    of its bit patterns (f32 read as int32, other dtypes widened), summed on
    the device and fetched at once; the host step and draw key as they
    are."""
    from repro_torch.train import checkpoint as ckpt_lib

    items = ckpt_lib.tree_items(state)
    sums = [(x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x).sum(
        dtype=torch.int64) for _, x in items if isinstance(x, torch.Tensor)]
    host = iter(torch.stack(sums).tolist()) if sums else iter(())
    return [(path, next(host) if isinstance(x, torch.Tensor) else np.asarray(x).tolist())
            for path, x in items]


def train_recovery(cfg, smi: str, train_hot_ms=None, dev: str = "cuda", seq: int = TRAIN_SEQ,
                   batch: int = TRAIN_BATCH, opt_kw=None, expect_buckets=TRAIN_BUCKETS):
    """Phase 4b (path ``train_recovery``): ``galore-sara-adam`` as in
    ``train`` under the launcher's default ``RecoveryPolicy`` (backoff 0)
    and a ``HeartbeatRegistry``, through ``RECOVERY_STEPS`` steps with a
    ``FaultPlan``: the gate's cost (hot steps 1-2 beside ``train``'s
    ``train_hot_ms`` from the same run), the pinned step-0 save, a skipped
    step (params and state bit-equal before and after it, by per-leaf
    checksums on the device, and ``skipped`` 1), then a NaN-loss streak
    that rolls back to the pin with resample: the replayed step-0 refresh
    must draw other sara projectors (each bucket's mean subspace overlap
    with the first refresh's < 1), every final loss is finite, and the
    counters read one skip and one rollback.  Then the gate's own cost:
    ``GATE_AB_STEPS`` gated and ungated hot steps each, in turns, from the
    final state, and the device time of the check alone on tensors of the
    gradients' shapes.  ``dev="cpu"`` with a smoke config rehearses it."""
    import math

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import buckets as buckets_lib
    from repro_torch.core import make_optimizer
    from repro_torch.core import metrics as metrics_lib
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.train.faults import FaultPlan, FaultSpec
    from repro_torch.train.loop import train_loop
    from repro_torch.train.monitor import HeartbeatRegistry
    from repro_torch.train.recovery import RecoveryPolicy
    from repro_torch.train.step import make_train_step

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    opt_kw = dict(TRAIN_OPT, **(opt_kw or {}))
    ckpt_dir = fresh_dir("recovery_ckpt")
    try:
        model = build_model(cfg, device=dev)
        tc = TrainConfig(total_steps=RECOVERY_STEPS, seed=SEED, checkpoint_every=0,
                         checkpoint_dir=str(ckpt_dir), async_checkpoint=False)
        params = model.init(torch.Generator(device=dev).manual_seed(tc.seed))
        # the launcher's schedule: lr is lr * step / warmup over these steps,
        # as in ``train``, so steps 0-2 are train's
        opt = make_optimizer("galore-sara-adam", params,
                             lr_schedule=cosine_with_warmup(opt_kw["lr"], TRAIN_WARMUP,
                                                            TRAIN_STEPS), **opt_kw)
        del params
        plan = [(bk.d, bk.n, bk.rank, bk.batch, bk.side) for bk in opt.bucket_plan.buckets]
        if plan != list(expect_buckets):
            raise AssertionError(f"bucket plan {plan} != {expect_buckets}")
        data = SyntheticDataset(
            SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
            device=dev)
        # the launcher's defaults (launch/train.py) but the backoff sleep; the
        # heartbeat registry runs the loop's per-step beat and check
        policy = RecoveryPolicy(max_bad_steps=3, loss_spike_factor=0.0, max_rollbacks=3,
                                rollback_backoff_s=0.0, stale_worker_action="log")
        heartbeats = HeartbeatRegistry(timeout_s=60.0)
        faults = FaultPlan([FaultSpec("nan_grads", step=RECOVERY_SKIP_AT)]
                           + [FaultSpec("nan_loss", step=s) for s in RECOVERY_NAN_LOSS])
        fns = make_train_step(model, opt, train_cfg=tc, recovery=policy)
        free = shutil.disk_usage(ckpt_dir.parent).free
        log(f"train_recovery: {free / 1e9:.1f} GB free under {ckpt_dir.parent} for the pinned "
            "checkpoint")
        if dev == "cuda" and free < 20e9:
            raise AssertionError(f"{free} bytes free: the pinned checkpoint needs ~14 GB")

        calls, refreshes, skip = [], [], {}

        def timed(fn, is_refresh):
            def run(state, b, **k):
                sync()
                poisoned = "grad_scale" in b
                if poisoned:
                    skip["before"] = state_checksums(state)
                t = time.perf_counter()
                out = fn(state, b, **k)
                sync()
                calls.append({"refresh": is_refresh, "ms": (time.perf_counter() - t) * 1e3,
                              "start": t, "poisoned": poisoned})
                if poisoned:
                    skip["after"] = state_checksums(out[0])
                    skip["skipped"] = float(out[1]["skipped"])
                if is_refresh:  # each refresh's projectors, copied
                    refreshes.append([bst.projector.clone() for bst in out[0].opt_state.buckets])
                return out
            return run

        loop_fns = dict(fns, step=timed(fns["step"], False),
                        refresh_step=timed(fns["refresh_step"], True))
        counters.reset()
        t0 = time.perf_counter()
        res = train_loop(model, opt, data, tc, loop_fns, log_every=1, recovery=policy,
                         fault_plan=faults, heartbeats=heartbeats)
        sync()
        wall_s = time.perf_counter() - t0
        launches = counters.snapshot()
        last = [r for r in res.history if "skip_steps" in r][-1]
        events = [r for r in res.history if "event" in r]
        saved, loaded = res.checkpoints.last_save, res.checkpoints.last_load
        hot_ms = [c["ms"] for c in calls[1:3]]
        gate_ms = (sum(hot_ms) / len(hot_ms) - sum(train_hot_ms) / len(train_hot_ms)
                   if train_hot_ms else None)
        log(f"train_recovery: losses {res.losses}; fired {faults.fired}; events {events}; "
            f"counters skip_steps {last['skip_steps']} rollbacks {last['rollbacks']}; "
            f"{len(calls)} step calls in {wall_s:.1f} s")
        log(f"train_recovery gate: hot steps 1-2 {[round(t, 2) for t in hot_ms]} ms under the "
            f"gate beside train's {[round(t, 2) for t in train_hot_ms or []]} ms (same run): "
            f"{gate_ms if gate_ms is None else round(gate_ms, 2)} ms a hot step; card {smi}")
        log(f"train_recovery: pinned step-0 save {saved['write_s']:.2f} s for {saved['bytes']} "
            f"bytes ({saved['bytes'] / saved['write_s'] / 1e9:.2f} GB/s); rollback load "
            f"{loaded['seconds']:.2f} s for {loaded['bytes']} bytes "
            f"({loaded['bytes'] / loaded['seconds'] / 1e9:.2f} GB/s)")
        if not res.losses or len(res.losses) != RECOVERY_STEPS or not all(
                math.isfinite(x) for x in res.losses):
            raise AssertionError(f"train_recovery losses {res.losses}")
        if (last["skip_steps"], last["rollbacks"]) != (1.0, 1.0):
            raise AssertionError(f"counters {last}: one skip and one rollback expected")
        rollbacks = [(r["step"], r["from_step"], r["attempt"]) for r in events
                     if r["event"] == "rollback"]
        if rollbacks != [(0.0, float(RECOVERY_NAN_LOSS[-1]), 1.0)] or loaded["step"] != 0:
            raise AssertionError(f"rollbacks {rollbacks}, load of step {loaded['step']}")
        if skip.get("skipped") != 1.0 or skip["before"] != skip["after"]:
            raise AssertionError(f"the skipped step changed the state (skipped "
                                 f"{skip.get('skipped')})")
        log(f"train_recovery skip at step {RECOVERY_SKIP_AT}: skipped 1, {len(skip['before'])} "
            "leaf checksums (bit patterns summed on the device) equal before and after")
        if len(refreshes) != 2:
            raise AssertionError(f"{len(refreshes)} refreshes, 2 expected (step 0 and its replay)")
        overlaps = [float(torch.mean(metrics_lib.subspace_overlap(a, b)))
                    for a, b in zip(*refreshes)]
        log(f"train_recovery: the replayed step-0 refresh (resampled draws) against the first, "
            f"mean subspace overlap per bucket {overlaps}")
        if not all(ov < 1.0 - 1e-6 for ov in overlaps):
            raise AssertionError(f"the resampled refresh drew the same subspace: {overlaps}")
        nl, nb = cfg.n_layers, len(plan)
        n_calls = len(calls)  # 8 + the 8 replayed
        expect = {"rmsnorm": n_calls * (4 * nl + 1), "flash_attention_fwd": n_calls * 2 * nl,
                  "galore_project_batched": (n_calls - 1) * nb,  # no update on the skip
                  UPDATE_KERNEL["adam"]: (n_calls - 1) * nb,
                  "power_iter_batched": 2 * power_iter_calls(opt, None)}
        expect = {k: v for k, v in expect.items() if v}
        if n_calls != 2 * RECOVERY_STEPS or launches != expect:
            raise AssertionError(f"train_recovery: {n_calls} calls, launches {launches} != "
                                 f"{expect}")
        # the gate's cost: gated and ungated hot steps in turns (ABBA) from
        # the final state, each output dropped before the next step
        plain_fns = make_train_step(model, opt, train_cfg=tc)
        ab = {"gated": [], "ungated": []}
        hot_batch = data.batch_at(RECOVERY_STEPS)
        for i in range(2 * GATE_AB_STEPS):
            kind = "gated" if i % 4 in (0, 3) else "ungated"
            sync()
            t = time.perf_counter()
            out = (fns if kind == "gated" else plain_fns)["step"](res.state, hot_batch)
            sync()
            ab[kind].append((time.perf_counter() - t) * 1e3)
            del out
        gate_ab_ms = sum(ab["gated"]) / len(ab["gated"]) - sum(ab["ungated"]) / len(ab["ungated"])
        leaves = tree_leaves(res.state.params)  # the gradients' shapes and dtype
        check_ms = device_ms(lambda: buckets_lib.all_finite(leaves), iters=5) \
            if dev == "cuda" else None
        check_bound = bound(sum(x.numel() * x.element_size() for x in leaves), 0, "float32")[0]
        log(f"train_recovery gate, in turns: gated hot steps {[round(t, 2) for t in ab['gated']]}"
            f" ms, ungated {[round(t, 2) for t in ab['ungated']]} ms: {gate_ab_ms:.2f} ms a hot "
            f"step; the check alone {check_ms} ms of device time (bound {check_bound:.3f} ms, "
            f"one read of {sum(x.numel() for x in leaves)} f32 gradients); card {smi}")
        del leaves, plain_fns
        profile = (profile_train_step(fns, res.state, hot_batch) if dev == "cuda" else None)
        out = {
            "optimizer": "galore-sara-adam", "layers": nl, "buckets": plan,
            "steps": RECOVERY_STEPS, "calls": calls, "losses": res.losses,
            "history": res.history, "fired": faults.fired,
            "refresh_step_ms": calls[0]["ms"], "hot_step_ms": hot_ms,
            "train_hot_step_ms": train_hot_ms, "gate_ms_per_hot_step": gate_ms,
            "gate_ab_ms": ab, "gate_ab_ms_per_hot_step": gate_ab_ms,
            "gate_check_ms": check_ms, "gate_check_bound_ms": check_bound,
            "pinned_save": saved, "rollback_load": loaded,
            "skip_checksums_equal": True, "resample_overlap": overlaps,
            "launches": launches, "expected": expect, "profile": profile, "card": smi,
        }
        del res, fns, loop_fns, refreshes, model, opt
        return out
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_rank_schedule(cfg, smi: str, dev: str = "cuda", seq: int = TRAIN_SEQ,
                        batch: int = TRAIN_BATCH, opt_kw=None, expect_buckets=TRAIN_BUCKETS,
                        ranks=SCHEDULE_RANKS):
    """Phase 4c (path ``train_rank_schedule``): ``galore-sara-adam`` with
    ``RANK_SCHEDULE`` at tau 2 over ``SCHEDULE_STEPS`` steps (module
    constants).  Checks the bucket plan at both ranks, the launch counts of
    each geometry, the one ``rebucket`` record, and on one more hot step at
    the new rank each bucket's R and W', M', V' from kernels 4 and 5
    against the plain versions; prints the hot-step ms at each rank and the
    re-bucket event's ms (from the end of the step-2 refresh to the start
    of step 3: the metric flush, the rebuild at the new rank and the state
    migration)."""
    import math

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import make_optimizer
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import make_train_step

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    opt_kw = dict(SCHEDULE_OPT, **(opt_kw or {}))
    model = build_model(cfg, device=dev)
    ckpt_dir = fresh_dir("rank_schedule_ckpt")
    tc = TrainConfig(total_steps=SCHEDULE_STEPS, seed=SEED, checkpoint_every=0,
                     checkpoint_dir=str(ckpt_dir))
    params = model.init(torch.Generator(device=dev).manual_seed(tc.seed))
    opt = make_optimizer("galore-sara-adam", params,
                         lr_schedule=cosine_with_warmup(opt_kw["lr"], TRAIN_WARMUP,
                                                        SCHEDULE_STEPS), **opt_kw)
    del params

    def plan_of(o):
        return [(bk.d, bk.n, bk.rank, bk.batch, bk.side) for bk in o.bucket_plan.buckets]

    want = {r: [(d, n, r, b, side) for d, n, _, b, side in expect_buckets] for r in ranks}
    if plan_of(opt) != want[ranks[0]]:
        raise AssertionError(f"bucket plan {plan_of(opt)} != {want[ranks[0]]}")
    data = SyntheticDataset(
        SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
        device=dev)
    calls, at_rebuild, opts = [], {}, [opt]

    def timed_fns(fns, rank):
        def timed(fn, is_refresh):
            def run(*a, **k):
                sync()
                t = time.perf_counter()
                out = fn(*a, **k)
                sync()
                calls.append({"rank": rank, "refresh": is_refresh, "start": t,
                              "end": time.perf_counter(),
                              "ms": (time.perf_counter() - t) * 1e3})
                return out
            return run

        def rebuild(new_opt):
            # called by the loop's re-bucket event, after the migration
            sync()
            at_rebuild.update(counters.snapshot())
            opts.append(new_opt)
            return timed_fns(fns["rebuild"](new_opt), new_opt.config.rank)

        return dict(fns, step=timed(fns["step"], False),
                    refresh_step=timed(fns["refresh_step"], True), rebuild=rebuild)

    loop_fns = timed_fns(make_train_step(model, opt, train_cfg=tc), opt.config.rank)
    counters.reset()
    res = train_loop(model, opt, data, tc, loop_fns, log_every=1)
    sync()
    launches = counters.snapshot()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rebuckets = [(r["step"], r["rank_from"], r["rank_to"]) for r in res.history
                 if r.get("event") == "rebucket"]
    by_rank = {r: [c for c in calls if c["rank"] == r] for r in ranks}
    hot = {r: [c["ms"] for c in by_rank[r] if not c["refresh"]] for r in ranks}
    event_ms = (by_rank[ranks[1]][0]["start"] - by_rank[ranks[0]][-1]["end"]) * 1e3 \
        if by_rank[ranks[1]] else None
    log(f"train_rank_schedule ({opt_kw['rank_schedule']}, tau {opt_kw['tau']}): losses "
        f"{res.losses}; rebucket records {rebuckets}; hot steps at rank {ranks[0]} {hot[ranks[0]]} "
        f"ms, at rank {ranks[1]} {hot[ranks[1]]} ms; refresh steps "
        f"{[(c['rank'], round(c['ms'], 1)) for c in calls if c['refresh']]} ms; re-bucket event "
        f"{event_ms if event_ms is None else round(event_ms, 2)} ms; card {smi}")
    if rebuckets != [(2.0, float(ranks[0]), float(ranks[1]))] or len(opts) != 2:
        raise AssertionError(f"rebucket records {rebuckets}")
    if plan_of(res.optimizer) != want[ranks[1]]:
        raise AssertionError(f"bucket plan at the new rank {plan_of(res.optimizer)} != "
                             f"{want[ranks[1]]}")
    if len(res.losses) != SCHEDULE_STEPS or not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"train_rank_schedule losses {res.losses}")
    nl, nb = cfg.n_layers, len(expect_buckets)
    after = {k: launches.get(k, 0) - at_rebuild.get(k, 0) for k in launches}
    got = {ranks[0]: dict(at_rebuild), ranks[1]: {k: v for k, v in after.items() if v}}
    expect = {}
    for r, o in zip(ranks, opts):
        n = len(by_rank[r])
        expect[r] = {k: v for k, v in {
            "rmsnorm": n * (4 * nl + 1), "flash_attention_fwd": n * 2 * nl,
            "galore_project_batched": n * nb, UPDATE_KERNEL["adam"]: n * nb,
            "power_iter_batched": sum(c["refresh"] for c in by_rank[r]) * power_iter_calls(o, None),
        }.items() if v}
    log(f"train_rank_schedule launches by rank {got}")
    if got != expect or [len(by_rank[r]) for r in ranks] != [3, 3]:
        raise AssertionError(f"launches by rank {got} != {expect}")
    parity = hot_step_parity("train_rank_schedule", model, res.optimizer, res.state,
                             data.batch_at(SCHEDULE_STEPS), dev)
    out = {
        "optimizer": "galore-sara-adam", "schedule": opt_kw["rank_schedule"],
        "tau": opt_kw["tau"], "steps": SCHEDULE_STEPS, "layers": nl,
        "buckets": {str(r): want[r] for r in ranks}, "losses": res.losses,
        "history": res.history, "calls": calls, "hot_step_ms": {str(r): hot[r] for r in ranks},
        "rebucket_event_ms": event_ms, "launches": launches,
        "launches_by_rank": {str(r): got[r] for r in ranks}, "hot_step_parity": parity,
        "card": smi,
    }
    del res, loop_fns, opts, opt, model
    return out


def rank_kernel_cases(results, ranks=RANK_CASES, shape=None, power: bool = True, kp=None):
    """Kernels 4, 5 and 9 at the ranks of ``ranks`` (the schedule's new
    rank, and one of 8 mod 16: a ragged last K tile of the f32 tile
    engine, which steps K by 16) on the mlp bucket's (B, d, n), or on
    ``shape``'s, against their plain versions at ``TOL``, timed beside
    their bound and library call.  Kernel 9 runs at ``kp``, by default the
    sara sketch's k' = min(4 r + 8, d), unless ``power`` is False (a bucket
    whose sketch spans d, where the path runs no power iteration)."""
    from repro_torch.kernels.galore_project.kernel import galore_project_batched
    from repro_torch.kernels.galore_project.ref import project_ref
    from repro_torch.kernels.power_iter.kernel import power_iter_batched
    from repro_torch.kernels.power_iter.ref import power_iter_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = []
    d, n, _, b, _ = shape or TRAIN_BUCKETS[-1]
    kernel, plain = fused_update("adam", True), fused_update("adam", False)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def orthonormal(bb, dd, k):
        return torch.linalg.qr(randn(bb, dd, k))[0].contiguous()

    for r in ranks:
        label = f"B={b} d={d} n={n} r={r}"
        g = randn(b, d, n)
        p = orthonormal(b, d, r)
        err = check_close(f"project {label}", galore_project_batched(g, p), project_ref(g, p),
                          *TOL["galore_project_batched"]["float32"], rel_atol=True)
        b_ms, b_by = bound(4 * (b * d * n + b * d * r + b * r * n), 2 * b * r * d * n, "float32")
        record_case(cases, results, "galore_project_batched", label, torch.float32, err, False,
                    timed_case(lambda: galore_project_batched(g, p), lambda: project_ref(g, p),
                               lambda: torch.bmm(p.transpose(1, 2), g), b_ms, b_by, 5))
        del g
        w = randn(b, d, n, scale=0.02)
        rg = randn(b, r, n)
        state = (randn(b, r, n, scale=0.1), randn(b, r, n, scale=0.1) ** 2)
        args = (w, p, rg, state, 3, 0.01 * 0.25, 0.0, "any", INNER_KW["adam"])
        errs = check_update("adam", f"adam {label}", kernel(*args), plain(*args), "float32")
        b_ms, b_by = bound(2 * b * d * n * 4 + 4 * (b * d * r + b * r * n) + 4 * 4 * b * r * n,
                           2 * b * d * r * n + 12 * b * r * n, "float32")
        record_case(cases, results, UPDATE_KERNEL["adam"], label, torch.float32,
                    max(errs.values()), False,
                    timed_case(lambda: kernel(*args), lambda: plain(*args),
                               lambda: torch.baddbmm(w, p, rg, beta=1.0, alpha=-0.01 * 0.25),
                               b_ms, b_by, 5))
        del w, rg, state, args, p
        if not power:
            torch.cuda.empty_cache()
            continue
        k_sketch = kp or min(4 * r + 8, d)
        g = randn(b, d, n)
        q = orthonormal(b, d, k_sketch)
        err = check_close(f"power_iter {label} k'={k_sketch}", power_iter_batched(g, q),
                          power_iter_ref(g, q), *TOL["power_iter_batched"]["float32"],
                          rel_atol=True)
        b_ms, b_by = bound(4 * (b * d * n + 2 * b * d * k_sketch), 4 * b * d * n * k_sketch,
                           "float32")
        record_case(cases, results, "power_iter_batched", f"{label} k'={k_sketch}",
                    torch.float32, err, False, timed_case(lambda: power_iter_batched(g, q),
                                      lambda: power_iter_ref(g, q),
                                      lambda: torch.bmm(g, torch.bmm(g.transpose(1, 2), q)),
                                      b_ms, b_by, 3))
        del g, q
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase 5: train -> checkpoint -> resume -> serve from the checkpoint
# ---------------------------------------------------------------------------


def _draw_sample(opt, draws):
    """The sketch and Gumbel noise the next refresh draws for the first
    bucket's first leaf (on the host)."""
    from repro_torch.core.projectors import draw_shapes

    bk = opt.bucket_plan.buckets[0]
    e = bk.entries[0]
    got = draws.split().leaf(e.leaf_idx, (e.batch,),
                             draw_shapes(bk.d, bk.n, opt.config.projector_config(), bk.rank))
    return [None if x is None else x.cpu() for x in got]


def _host_items(state):
    """(path, host copy) of every leaf of a state, through the checkpoint's
    walk: the step and the draw key come as numpy arrays."""
    from repro_torch.train import checkpoint as ckpt_lib

    return [(path, x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
             else np.array(x)) for path, x in ckpt_lib.tree_items(state)]


def _state_equals(state, host_items) -> int:
    """Raises unless ``state`` equals the host copy bit for bit, leaf by
    leaf; returns the number of leaves compared."""
    from repro_torch.train import checkpoint as ckpt_lib

    items = ckpt_lib.tree_items(state)
    if [p for p, _ in items] != [p for p, _ in host_items]:
        raise AssertionError("restored state's leaves differ from the saved state's")
    for (path, x), (_, h) in zip(items, host_items):
        if isinstance(x, torch.Tensor):
            same = x.dtype == h.dtype and x.shape == h.shape and torch.equal(x, h.to(x.device))
        else:
            same = np.array_equal(np.asarray(x), h) and np.asarray(x).dtype == h.dtype
        if not same:
            raise AssertionError(f"restored leaf {path} differs from the saved one")
    return len(items)


def resume(cfg, smi: str, dev: str = "cuda", seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
           opt_kw=None, expect_buckets=TRAIN_BUCKETS):
    """Phase 5 (see the module docstring).  Returns the ``resume`` and
    ``serve_ckpt`` runs.  ``dev="cpu"`` with a smoke config rehearses it."""
    import math

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import flatten_with_path
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.loop import train_loop
    from repro_torch.train.state import checkpoint_converters
    from repro_torch.train.step import make_train_step

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def peak_and_reset():
        if dev != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return peak

    def gib(b):
        return round(b / 2**30, 2)

    opt_kw = dict(RESUME_OPT, **(opt_kw or {}))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                global_batch=batch, dist="zipf"), device=dev)
    ckpt_dir = fresh_dir("resume_ckpt")

    def build(total: int):
        """New model, optimizer, step functions and config: nothing shared
        between the runs but the seed and the directory."""
        model = build_model(cfg, device=dev)
        tc = TrainConfig(total_steps=total, seed=SEED, checkpoint_every=RESUME_STOP,
                         checkpoint_dir=str(ckpt_dir), async_checkpoint=False)
        params = model.init(torch.Generator(device=dev).manual_seed(tc.seed))
        opt = make_optimizer(
            "galore-sara-adam", params,
            lr_schedule=cosine_with_warmup(opt_kw["lr"], TRAIN_WARMUP, RESUME_STEPS), **opt_kw)
        del params  # train_loop makes the same params from tc.seed and owns them
        plan = [(bk.d, bk.n, bk.rank, bk.batch, bk.side) for bk in opt.bucket_plan.buckets]
        if plan != list(expect_buckets):
            raise AssertionError(f"bucket plan {plan} != {expect_buckets}")
        return model, opt, tc, make_train_step(model, opt, train_cfg=tc)

    def recording(fns, opt, batches, draws, first_step, at):
        """Step functions and a batch hook that keep each step's batch and,
        at each refresh, the draws it takes; ``at[s]`` runs on step s's
        input state (the loop's steps run from ``first_step``)."""
        nxt = [first_step]

        def before(state):
            if nxt[0] in at:
                at[nxt[0]](state)
            nxt[0] += 1

        def step(state, b):
            before(state)
            return fns["step"](state, b)

        def refresh_step(state, b, group=0):
            before(state)
            draws.append(((state.opt_state.draws.seed, state.opt_state.draws.refreshes + 1),
                          _draw_sample(opt, state.opt_state.draws)))
            return fns["refresh_step"](state, b, group=group)

        def hook(b):
            batches.append({k: v.cpu() for k, v in b.items()})
            return b

        return dict(fns, step=step, refresh_step=refresh_step), hook

    try:
        # ---- C: uninterrupted, with the subspace tracker; saves at RESUME_STOP ----
        peak_and_reset()
        t0 = time.perf_counter()
        model, opt, tc, fns = build(RESUME_STEPS)
        can, _ = checkpoint_converters(opt)
        c_batches, c_draws, sizes, host_c = [], [], [], []

        def check_disk(state):
            """Twice the checkpoint free on the disk before the save, or stop."""
            items = ckpt_lib.tree_items(can(state))
            sizes.append(sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                             else np.asarray(x).nbytes for _, x in items))
            del items
            free = shutil.disk_usage(ckpt_dir.parent).free
            log(f"checkpoint of {sizes[0]} bytes ({sizes[0] / 1e9:.2f} GB); "
                f"{free / 1e9:.1f} GB free under {ckpt_dir.parent}")
            if free < 2 * sizes[0]:
                raise AssertionError(f"{free} bytes free, under twice the checkpoint's {sizes[0]}")

        loop_fns, hook = recording(fns, opt, c_batches, c_draws, 0, {
            0: check_disk, RESUME_STOP: lambda st: host_c.extend(_host_items(st))})
        res_c = train_loop(model, opt, data, tc, loop_fns, log_every=1, track_subspace=True,
                           batch_hook=hook)
        sync()
        saved = res_c.checkpoints.last_save
        ckpt_bytes = sizes[0]
        overlaps = {name: ov for name, ov in res_c.subspace.adjacent.items()}
        c_losses = res_c.losses
        del res_c, model, opt, fns, loop_fns, can
        c_peak = peak_and_reset()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        log(f"resume C (uninterrupted, {RESUME_STEPS} steps, refreshes at 0, 2, 4, blocking save "
            f"at step {RESUME_STOP}): losses {c_losses}; {time.perf_counter() - t0:.1f} s; save "
            f"{saved['write_s']:.2f} s for {saved['bytes']} bytes "
            f"({saved['bytes'] / saved['write_s'] / 1e9:.2f} GB/s: device -> host, np.save, "
            f"sha256, commit); max_memory_allocated {gib(c_peak)} GiB; peak host RSS "
            f"{rss / 1e9:.2f} GB (C's host copy of its step-{RESUME_STOP} state included); "
            f"card {smi}")
        for name, ov in overlaps.items():
            log(f"  adjacent subspace overlap {name} at refreshes 2, 4: {ov}")
        if len(c_losses) != RESUME_STEPS or not all(math.isfinite(x) for x in c_losses):
            raise AssertionError(f"C's losses {c_losses}")
        if ckpt_lib.checkpoint_dirs(str(ckpt_dir)) != [RESUME_STOP] or saved["step"] != RESUME_STOP:
            raise AssertionError(f"C saved {ckpt_lib.checkpoint_dirs(str(ckpt_dir))}")
        if saved["bytes"] != ckpt_bytes or not host_c:
            raise AssertionError(f"C saved {saved['bytes']} bytes, the state has {ckpt_bytes}")

        # ---- B: resumed in new objects from the same directory ----
        t0 = time.perf_counter()
        model, opt, tc, fns = build(RESUME_STEPS)
        b_batches, b_draws, restored = [], [], []

        def check_restored(state):
            restored.append(_state_equals(state, host_c))

        loop_fns, hook = recording(fns, opt, b_batches, b_draws, RESUME_STOP,
                                   {RESUME_STOP: check_restored})
        sync()
        counters.reset()
        res_b = train_loop(model, opt, data, tc, loop_fns, log_every=1, batch_hook=hook)
        sync()
        launches = counters.snapshot()
        loaded = res_b.checkpoints.last_load
        b_losses = res_b.losses
        nb = len(opt.bucket_plan.buckets)
        power_iters = power_iter_calls(opt, None)  # one refresh, on the buckets
        del res_b, model, opt, fns, loop_fns
        b_peak = peak_and_reset()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        log(f"resume B (from step {loaded['step']} to {RESUME_STEPS}): losses {b_losses}; "
            f"{time.perf_counter() - t0:.1f} s; load {loaded['seconds']:.2f} s for "
            f"{loaded['bytes']} bytes ({loaded['bytes'] / loaded['seconds'] / 1e9:.2f} GB/s: "
            f"read, verify, host -> device); max_memory_allocated {gib(b_peak)} GiB; "
            f"peak host RSS {rss / 1e9:.2f} GB; card {smi}")
        log(f"resume launches {launches}")
        if loaded["step"] != RESUME_STOP or not restored:
            raise AssertionError(f"B restored step {loaded['step']}, compared {restored}")
        log(f"B's restored state equals C's step-{RESUME_STOP} host copy bit for bit "
            f"({restored[0]} leaves)")
        for i, (bb, cb) in enumerate(zip(b_batches, c_batches[RESUME_STOP:])):
            if any(not torch.equal(bb[k], cb[k]) for k in cb):
                raise AssertionError(f"B's batch of step {RESUME_STOP + i} differs from C's")
        if len(b_batches) != RESUME_STEPS - RESUME_STOP:
            raise AssertionError(f"B ran {len(b_batches)} steps")
        (b_src, b_sample), (c_src, c_sample) = b_draws[0], c_draws[-1]
        if b_src != c_src or any(
                (x is None) != (y is None) or (x is not None and not torch.equal(x, y))
                for x, y in zip(b_sample, c_sample)):
            raise AssertionError(f"B's step-4 draws {b_src} differ from C's {c_src}")
        gaps = [abs(b - c) / abs(c) for b, c in zip(b_losses, c_losses[RESUME_STOP:])]
        log(f"B's losses against C's at steps {RESUME_STOP}-{RESUME_STEPS - 1}: relative gaps "
            f"{gaps} (bar {RESUME_LOSS_RTOL}); batches and step-4 draws (seed, refreshes) "
            f"{b_src} bit-equal")
        if len(gaps) != RESUME_STEPS - RESUME_STOP or max(gaps) > RESUME_LOSS_RTOL:
            raise AssertionError(f"B's losses {b_losses} against C's {c_losses[RESUME_STOP:]}")
        nl = cfg.n_layers
        steps = RESUME_STEPS - RESUME_STOP  # a hot step and a refresh
        expect = {
            "rmsnorm": steps * (4 * nl + 1),
            "flash_attention_fwd": steps * 2 * nl,
            "galore_project_batched": steps * nb,
            UPDATE_KERNEL["adam"]: steps * nb,
            "power_iter_batched": power_iters,
        }
        if launches != expect:
            raise AssertionError(f"resume launch counts {launches} != expected {expect}")
        resume_run = {
            "steps": RESUME_STEPS, "stop": RESUME_STOP, "card": smi,
            "losses_uninterrupted": c_losses, "losses_resumed": b_losses, "loss_rel_gaps": gaps, "loss_rtol": RESUME_LOSS_RTOL,
            "adjacent_overlap": overlaps, "checkpoint_bytes": ckpt_bytes,
            "save": saved, "load": loaded, "restored_leaves": restored[0],
            "max_memory_allocated": {"C": c_peak, "B": b_peak},
            "peak_host_rss": rss, "launches": launches, "expected": expect,
        }
        del c_batches, b_batches

        # ---- serve the checkpoint's params ----
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev)
        skeleton = tfm.serving_params(model.init(torch.Generator(device=dev).manual_seed(1)), cfg)
        served_params, step = ckpt_lib.load_params_latest(str(ckpt_dir), skeleton)
        sync()
        load_s = time.perf_counter() - t0
        del skeleton
        c_params = dict((p[len(".params"):], h) for p, h in host_c if p.startswith(".params"))
        del host_c
        in_memory = tfm.serving_params(_unflatten_like(served_params, c_params, dev), cfg)
        del c_params
        for (path, x), (_, y) in zip(flatten_with_path(served_params),
                                     flatten_with_path(in_memory)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"served param {path} differs from serving_params(C's)")
        log(f"serve_ckpt: load_params_latest step {step} into the bf16 serving skeleton in "
            f"{load_s:.2f} s; every leaf equals serving_params(C's step-{RESUME_STOP} f32 params) "
            f"bit for bit")
        rng = np.random.default_rng(SEED + 2)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in SERVE_CKPT_PROMPTS]

        def serve_tokens(params):
            eng = ContinuousEngine(model, params, max_slots=MAX_SLOTS, page_size=PAGE_SIZE,
                                   max_seq_len=max(SERVE_CKPT_PROMPTS) + SERVE_CKPT_NEW_TOKENS)
            for i, p in enumerate(prompts):
                eng.submit(p, SERVE_CKPT_NEW_TOKENS, arrival=i)
            out = eng.run()
            sync()
            return {rid: r.tokens.tolist() for rid, r in out.items()}, eng.decode_steps

        counters.reset()
        tokens, ticks = serve_tokens(served_params)
        serve_launches = counters.snapshot()
        want_tokens, _ = serve_tokens(in_memory)
        serve_peak = peak_and_reset()
        n_req = len(SERVE_CKPT_PROMPTS)
        log(f"serve_ckpt: {n_req} requests, {ticks} decode steps, launches {serve_launches}; "
            f"tokens of request 0 {tokens[0]}; max_memory_allocated {gib(serve_peak)} GiB")
        if tokens != want_tokens:
            raise AssertionError(f"checkpoint-served tokens {tokens} != in-memory {want_tokens}")
        if sorted(tokens) != list(range(n_req)) or any(
                len(t) != SERVE_CKPT_NEW_TOKENS for t in tokens.values()):
            raise AssertionError(f"served {tokens}")
        serve_expect = {
            "rmsnorm": (2 * nl + 1) * (ticks + n_req),
            "paged_decode_attention": nl * ticks,
            "flash_attention_fwd": nl * n_req,
        }
        if serve_launches != serve_expect:
            raise AssertionError(f"serve_ckpt launch counts {serve_launches} != {serve_expect}")
        serve_run = {
            "checkpoint_step": step, "load_s": load_s, "requests": n_req,
            "decode_steps": ticks, "tokens": tokens, "tokens_equal_in_memory": True,
            "max_memory_allocated": serve_peak, "launches": serve_launches,
            "expected": serve_expect,
        }
        del model, served_params, in_memory
        peak_and_reset()
        return resume_run, serve_run
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 6: the MoE, SSM and hybrid families at full width
# ---------------------------------------------------------------------------


def finite_grads(model, seed: int, batch) -> dict:
    """Every gradient of the model's loss at its seed's params on ``batch``
    must be finite (the SSD scan's, on the SSM families); returns the
    count of elements checked."""
    from repro_torch.core.lowrank import flatten_with_path, tree_unflatten

    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    flat = flatten_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in flat]
    loss, _ = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    bad = {path: int((~torch.isfinite(g)).sum()) for (path, _), g in zip(flat, grads)}
    bad = {k: v for k, v in bad.items() if v}
    n = sum(g.numel() for g in grads)
    del params, leaves, grads, loss
    log(f"step-0 gradients of {model.cfg.arch_id}: {n} elements, non-finite {bad or 0}")
    if bad:
        raise AssertionError(f"non-finite step-0 gradients: {bad}")
    return {"elements": n, "non_finite": 0}


def serve_slots(cfg, prompt_lens, dev: str = "cuda", new_tokens: int = NEW_TOKENS,
                max_seq_len: int = 0):
    """``serve_ssm`` / ``serve_hybrid`` / ``serve_audio``: the slot-cache
    continuous engine on the serving trace (``prompt_lens``, ``ARRIVALS``,
    ``MAX_SLOTS`` slots; ``max_seq_len`` ring positions, by default the
    longest prompt and its new tokens; whisper's requests each carry their
    own frames), bf16 weights made leaf by leaf; exact launch counts; then
    each request's tokens against the static engine's, one request at a
    time, where a parting token must be a near-tie (``TIE_BAR_SIGMAS``)."""
    from repro_torch.kernels import counters
    from repro_torch.models import build_model, count_params
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), serving=True)
    sync()
    n_params = count_params(params)
    log(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params made in bf16 in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in prompt_lens]
    extras = request_prefixes(cfg, len(prompt_lens), dev)
    max_seq_len = max_seq_len or max(prompt_lens) + new_tokens
    eng = ContinuousEngine(model, params, max_slots=MAX_SLOTS, max_seq_len=max_seq_len)
    if eng.paged:
        raise AssertionError(f"{cfg.family} took the paged engine")
    for p, a, e in zip(prompts, ARRIVALS, extras):
        eng.submit(p, new_tokens, arrival=a, extras=e or None)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    results = eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = counters.snapshot()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    n_req, ticks, nl = len(prompt_lens), eng.decode_steps, cfg.n_layers
    emitted = sum(len(r.tokens) for r in results.values())
    log(f"{cfg.arch_id} slot engine: {len(results)} requests, {emitted} tokens, "
        f"{eng.total_ticks} ticks ({ticks} decode steps) in {wall:.3f} s: "
        f"{emitted / wall:.1f} tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"launches {launches}")
    if sorted(results) != list(range(n_req)):
        raise AssertionError(f"finished requests {sorted(results)}")
    for rid, r in results.items():
        if len(r.tokens) != new_tokens or r.finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(r.tokens)} tokens, {r.finish_reason}")
    (fwd_norms, fwd_attns), _ = forward_launches(cfg)
    if cfg.family == "audio":
        # per admission the encoder and the decoder prompt (self and cross
        # attention on the flash kernel); per tick the decoder's norms and
        # its cross-attention, Sq 1 against the frames (the self-attention
        # reads the ring with exact attention)
        expect = {"rmsnorm": fwd_norms * n_req + (3 * nl + 1) * ticks,
                  "flash_attention_fwd": fwd_attns * n_req + nl * ticks}
    else:
        expect = {"rmsnorm": fwd_norms * (ticks + n_req),
                  "flash_attention_fwd": fwd_attns * n_req}  # prefill only
    expect = {k: v for k, v in expect.items() if v}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    del eng

    # the ring of a windowed (hybrid) model holds its window by design; the
    # enc-dec ring must hold each request's prompt and new tokens
    static = ServeEngine(model, params, capacity=max_seq_len if cfg.family == "audio" else 0)
    parted, f32 = [], None
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        tok = torch.as_tensor(p, device=dev)[None]
        b1 = with_prefix({"tokens": tok}, extras[rid])
        want = static.generate(b1, new_tokens).tokens[0].cpu().numpy()
        got = results[rid].tokens
        if (want == got).all():
            continue
        j = int(np.argmax(want != got))
        if j == 0:
            logits = model.prefill(static.params, b1)[0][0]
        else:
            logits = static.generate(b1, j).logits_last[0]
        gap = float(logits[int(want[j])] - logits[int(got[j])])
        if f32 is None:  # the same model in f32, from the same seed
            m32 = build_model(cfg.with_(dtype=torch.float32), device=dev)
            f32 = (m32, m32.init(torch.Generator(device=dev).manual_seed(SEED)))
        seq = torch.cat([tok, torch.as_tensor(want[:j], device=dev)[None].to(tok.dtype)], 1)
        bj = with_prefix({"tokens": seq}, extras[rid])
        l16 = model.prefill(static.params, bj)[0][0]
        l32 = f32[0].prefill(f32[1], bj)[0][0]
        sigma = float(torch.sqrt(torch.mean((l16 - l32) ** 2)))
        bar = TIE_BAR_SIGMAS * sigma
        parted.append({"request": rid, "step": j, "gap": gap, "bf16_sigma": sigma, "bar": bar})
        log(f"request {rid} parts from the static engine at token {j}: top-two gap "
            f"{gap:.4g}, bar {bar:.4g} ({TIE_BAR_SIGMAS} x bf16's per-logit RMS error "
            f"{sigma:.4g})")
        if gap > bar:
            raise AssertionError(f"request {rid} parts at token {j} with a gap {gap} > {bar}")
    del f32
    log(f"{n_req - len(parted)} of {n_req} requests equal the static engine's tokens; "
        f"static engine {time.perf_counter() - t0:.1f} s")
    return {
        "arch": cfg.arch_id, "params": n_params, "requests": n_req,
        "prompt_lens": list(prompt_lens), "new_tokens": new_tokens,
        "max_seq_len": max_seq_len, "tokens": emitted, "ticks": ticks,
        "wall_s": wall, "tokens_per_s": emitted / wall, "max_memory_allocated": peak,
        "launches": launches, "expected": expect, "parted": parted,
    }


def family_kernel_cases(results):
    """Kernels 1-5 and 9 at the shapes the new paths give them, each
    against its plain version, timed beside its bound and library call:
    flash at hymba's D 64, GQA 25/5, window 1024, S 2048 (training, B 2)
    and deepseek's MHA 16/16 at D 128 (serving prefill); paged decode at
    MHA 16/16; RMSNorm at widths 1600, 2048 and 3200, and on half of
    mamba2's and hymba's gated-norm rows with the whole row's sum of
    squares (the head-parallel mixer's); kernels 4, 5 and 9
    on deepseek's 384-slice expert bucket (d 1408, n 2048) at rank 256
    (k' 1032)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import last_design as flash_design
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention_decode.kernel import (
        paged_decode_attention_kernel,
    )
    from repro_torch.kernels.flash_attention_decode.ref import paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    cases = []
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, label, dtype, err, timing):
        record_case(cases, results, name, label, dtype, err, False, timing, relative=False)

    for rows, width in ((4, 1600), (4096, 1600), (4, 2048), (4, 3200), (4096, 3200)):
        x = randn(rows, width, dtype=bf16)
        scale = 1.0 + randn(width, scale=0.1)
        err = check_close(f"rmsnorm ({rows},{width})", rmsnorm(x, scale, 1e-5),
                          rmsnorm_ref(x, scale, 1e-5), *TOL["rmsnorm"]["bfloat16"])
        b_ms, b_by = bound(2 * rows * width * 2 + width * 4, 4 * rows * width, "bfloat16")
        scale_lib = scale.to(bf16)
        record("rmsnorm", f"({rows},{width})", bf16, err, {
            "ms": device_ms(lambda: rmsnorm(x, scale, 1e-5)),
            "call_ms": call_ms(lambda: rmsnorm(x, scale, 1e-5)),
            "plain_ms": device_ms(lambda: rmsnorm_ref(x, scale, 1e-5)),
            "library_ms": device_ms(lambda: F.rms_norm(x, (width,), scale_lib, 1e-5)),
            "bound_ms": b_ms, "bound_by": b_by})
    # the gated norm of the SSM mixer on a process's heads at TP 2: its
    # half of the channels with the whole row's f32 sum of squares (mamba2
    # 1024 of 2048, hymba 1600 of 3200; 4096 tokens a step).  No library
    # call takes a given sum of squares
    for rows, width, full in ((4096, 1024, 2048), (4096, 1600, 3200)):
        xf = randn(rows, full, dtype=bf16)
        x = xf[:, :width].contiguous()
        scale = 1.0 + randn(width, scale=0.1)
        ss = torch.sum(xf.float() ** 2, dim=-1, keepdim=True)
        got = rmsnorm(x, scale, 1e-5, ss=ss, width=full)
        want = rmsnorm_ref(x, scale, 1e-5, ss=ss, width=full)
        whole = rmsnorm_ref(xf, torch.cat([scale, torch.ones(full - width, device=dev)]), 1e-5)
        err = check_close(f"rmsnorm ({rows},{width} of {full})", got, want,
                          *TOL["rmsnorm"]["bfloat16"])
        check_close(f"rmsnorm ({rows},{width} of {full}) against the whole row", got,
                    whole[:, :width], *TOL["rmsnorm"]["bfloat16"])
        b_ms, b_by = bound(2 * rows * width * 2 + width * 4 + rows * 4, 3 * rows * width,
                           "bfloat16")
        record("rmsnorm", f"({rows},{width} of {full}, given sum of squares)", bf16, err, {
            "ms": device_ms(lambda: rmsnorm(x, scale, 1e-5, ss=ss, width=full)),
            "call_ms": call_ms(lambda: rmsnorm(x, scale, 1e-5, ss=ss, width=full)),
            "plain_ms": device_ms(lambda: rmsnorm_ref(x, scale, 1e-5, ss=ss, width=full)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})

    # (label, B, S, H, KVH, D, window): SDPA with the window as a boolean
    # mask is the library call that computes the same function
    for label, nb, sq, h, kvh, d, window in (
            ("hymba B=2 S=2048 GQA 25/5 D=64 window=1024", 2, 2048, 25, 5, 64, 1024),
            ("deepseek B=1 S=1024 MHA 16/16 D=128", 1, 1024, 16, 16, 128, 0)):
        q, k, v = (randn(nb, sq, n, d, dtype=bf16) for n in (h, kvh, kvh))
        got = flash_attention_fwd(q, k, v, causal=True, window=window)
        if flash_design() != "tensor_cores":
            raise AssertionError(f"flash {label} ran on the {flash_design()}")
        err = check_close(f"flash {label}", got, flash_attention_ref(
            q, k, v, causal=True, window=window), *TOL["flash_attention_fwd"]["bfloat16"])
        i = torch.arange(sq, device=dev)
        allow = i[None, :] <= i[:, None]
        if window:
            allow &= i[None, :] > i[:, None] - window
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        live = int(allow.sum())
        b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, 4 * d * h * nb * live,
                           "bfloat16")
        record("flash_attention_fwd", label, bf16, err, {
            "design": "tensor_cores",
            "ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True, window=window)),
            "call_ms": call_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                                           window=window)),
            "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                                              window=window)),
            "library_ms": device_ms(lambda: sdpa_masked(qt, kt, vt, allow)),
            "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, got, qt, kt, vt

    q, pk, pv, table, lens = paged_inputs(randn, PAGED_FILLS, bf16, False, gen,
                                          heads=(16, 16))
    got = paged_decode_attention_kernel(q, pk, pv, table, lens)
    err = check_close("paged MHA 16/16", got, paged_decode_attention_ref(q, pk, pv, table, lens),
                      *TOL["paged_decode_attention"]["bfloat16"])
    b_ms, b_by = paged_bound(q, table, PAGED_FILLS, 0, kvh=16)
    timing = {**paged_plan(q, pk, table),
              "ms": device_ms(lambda: paged_decode_attention_kernel(q, pk, pv, table, lens)),
              "call_ms": call_ms(lambda: paged_decode_attention_kernel(q, pk, pv, table, lens)),
              "plain_ms": device_ms(lambda: paged_decode_attention_ref(q, pk, pv, table, lens)),
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    if timing.get("design", "tensor_cores") != "tensor_cores":
        raise AssertionError(f"paged MHA 16/16 ran on the {timing['design']}")
    record("paged_decode_attention", f"MHA 16/16 {paged_label(PAGED_FILLS, 0, False)}", bf16,
           err, timing)
    del q, pk, pv, table, lens, got
    torch.cuda.empty_cache()
    # kernels 4, 5 and 9 on the 192-slice expert bucket (2.2 GB per f32 stack)
    return cases + rank_kernel_cases(results, ranks=(256,),
                                     shape=FAMILY_TRAIN_RUNS["train_moe"][5][0])


def sdpa_masked(qt, kt, vt, allow, is_causal: bool = False):
    """``scaled_dot_product_attention`` over (B, H, S, D) with a boolean
    allow-mask (None: no mask, or SDPA's own causal mask where
    ``is_causal``) and GQA (K/V heads repeated where this torch has no
    ``enable_gqa``)."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allow, is_causal=is_causal,
                                              enable_gqa=True)
    except TypeError:
        g = qt.shape[1] // kt.shape[1]
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1), attn_mask=allow,
            is_causal=is_causal)


def encdec_vlm_kernel_cases(results):
    """Kernels 1-5 and 9 at the shapes the VLM and enc-dec paths give
    them, each against its plain version at ``TOL``, timed beside its
    bound and library call: RMSNorm at widths 7168 and 1024 (4 and 4096
    rows); flash without a mask over whisper's 1500 frames (MHA 16/16, D
    64; 1500 is no multiple of the 64-row tile, and no causal early exit
    may apply), whisper's cross-attention with Sq != Sk (a 64-token prefill,
    and one decode tick of 4 slots at Sq 1, one row of a 64-row tile), and
    llava's longest causal prefill (GQA 56/8, D 128, S 1600); paged decode
    at GQA 56/8 (G = 7, one idle head of the 8-head instance) over
    ``PAGED_FILLS`` + 576 patches; kernels 4, 5 and 9 on llava's mlp bucket
    (B 6 at 2 layers, 7168 x 20480, rank 512, k' 2056) and kernels 4 and 5
    on whisper's 1024 x 1024 bucket (B 288, rank 256: its path runs no
    power iteration)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import last_design as flash_design
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention_decode.kernel import (
        paged_decode_attention_kernel,
    )
    from repro_torch.kernels.flash_attention_decode.ref import paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cases = []
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, label, dtype, err, timing):
        record_case(cases, results, name, label, dtype, err, False, timing, relative=False)

    for rows, width in ((4, 7168), (4096, 7168), (4, 1024), (4096, 1024)):
        x = randn(rows, width, dtype=bf16)
        scale = 1.0 + randn(width, scale=0.1)
        err = check_close(f"rmsnorm ({rows},{width})", rmsnorm(x, scale, 1e-5),
                          rmsnorm_ref(x, scale, 1e-5), *TOL["rmsnorm"]["bfloat16"])
        b_ms, b_by = bound(2 * rows * width * 2 + width * 4, 4 * rows * width, "bfloat16")
        scale_lib = scale.to(bf16)
        record("rmsnorm", f"({rows},{width})", bf16, err, {
            "ms": device_ms(lambda: rmsnorm(x, scale, 1e-5)),
            "call_ms": call_ms(lambda: rmsnorm(x, scale, 1e-5)),
            "plain_ms": device_ms(lambda: rmsnorm_ref(x, scale, 1e-5)),
            "library_ms": device_ms(lambda: F.rms_norm(x, (width,), scale_lib, 1e-5)),
            "bound_ms": b_ms, "bound_by": b_by})

    # (label, B, Sq, Sk, H, KVH, D, causal); the library call is SDPA,
    # with its own causal mask (Sq == Sk) where there is one, no mask
    # elsewhere
    for label, nb, sq, sk, h, kvh, d, causal in (
            ("whisper encoder B=1 S=1500 MHA 16/16 D=64 no mask", 1, 1500, 1500, 16, 16, 64,
             False),
            ("whisper encoder B=8 S=1500 MHA 16/16 D=64 no mask", 8, 1500, 1500, 16, 16, 64,
             False),
            ("whisper cross prefill B=1 Sq=64 Sk=1500 MHA 16/16 D=64", 1, 64, 1500, 16, 16, 64,
             False),
            ("whisper cross decode tick B=4 Sq=1 Sk=1500 MHA 16/16 D=64", 4, 1, 1500, 16, 16, 64,
             False),
            ("llava prefill B=1 S=1600 GQA 56/8 D=128 causal", 1, 1600, 1600, 56, 8, 128, True)):
        q = randn(nb, sq, h, d, dtype=bf16)
        k, v = (randn(nb, sk, kvh, d, dtype=bf16) for _ in range(2))
        got = flash_attention_fwd(q, k, v, causal=causal)
        if flash_design() != "tensor_cores":
            raise AssertionError(f"flash {label} ran on the {flash_design()}")
        err = check_close(f"flash {label}", got, flash_attention_ref(q, k, v, causal=causal),
                          *TOL["flash_attention_fwd"]["bfloat16"])
        live = sq * (sq + 1) // 2 if causal else sq * sk
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, 4 * d * h * nb * live,
                           "bfloat16")
        record("flash_attention_fwd", label, bf16, err, {
            "design": "tensor_cores",
            "ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=causal)),
            "call_ms": call_ms(lambda: flash_attention_fwd(q, k, v, causal=causal)),
            "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, causal=causal)),
            "library_ms": device_ms(lambda: sdpa_masked(qt, kt, vt, None, is_causal=causal)),
            "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, got, qt, kt, vt

    fills = [576 + n for n in PAGED_FILLS]
    q, pk, pv, table, lens = paged_inputs(randn, fills, bf16, False, gen, heads=(56, 8))
    got = paged_decode_attention_kernel(q, pk, pv, table, lens)
    err = check_close("paged GQA 56/8", got, paged_decode_attention_ref(q, pk, pv, table, lens),
                      *TOL["paged_decode_attention"]["bfloat16"])
    b_ms, b_by = paged_bound(q, table, fills, 0, kvh=8)
    timing = {**paged_plan(q, pk, table),
              "ms": device_ms(lambda: paged_decode_attention_kernel(q, pk, pv, table, lens)),
              "call_ms": call_ms(lambda: paged_decode_attention_kernel(q, pk, pv, table, lens)),
              "plain_ms": device_ms(lambda: paged_decode_attention_ref(q, pk, pv, table, lens)),
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    if timing.get("design", "tensor_cores") != "tensor_cores":
        raise AssertionError(f"paged GQA 56/8 ran on the {timing['design']}")
    record("paged_decode_attention", f"GQA 56/8 {paged_label(fills, 0, False)}", bf16, err,
           timing)
    del q, pk, pv, table, lens, got
    torch.cuda.empty_cache()
    return (cases
            + rank_kernel_cases(results, ranks=(512,),
                                shape=FAMILY_TRAIN_RUNS["train_vlm"][5][-1])
            + rank_kernel_cases(results, ranks=(256,),
                                shape=FAMILY_TRAIN_RUNS["train_audio"][5][0], power=False))


def cut_depth(cfg, layers: int):
    """``cfg`` at ``layers`` layers (and as many encoder layers, for an
    encoder-decoder), every layer's shapes unchanged."""
    if cfg.n_enc_layers:
        return cfg.with_(n_layers=layers, n_enc_layers=layers)
    return cfg.with_(n_layers=layers)


def family_train(path: str, smi: str, dev: str = "cuda"):
    """One of ``FAMILY_TRAIN_RUNS`` through ``train`` (galore-sara-adam,
    bucketed, randomized SVD, 3 steps), with the step-0 gradients checked
    finite."""
    from repro_torch.configs.registry import get_config

    arch, layers, seq, batch, rank, plan = FAMILY_TRAIN_RUNS[path]
    cfg = get_config(arch)
    if layers:
        cfg = cut_depth(cfg, layers)
    # the SSM's hot step runs ~1e5 small kernels (the chunk loop), whose
    # profile alone took minutes to sum up: the SSM paths are not profiled
    out = train(cfg, "galore-sara-adam", plan, dev=dev, seq=seq, batch=batch,
                opt_kw=dict(rank=rank), check_grads=True,
                profile=path in ("train_moe", "train_vlm", "train_audio"))
    log(f"{path} ({smi}): {arch} {cfg.n_layers} layers, seq {seq}, batch {batch}, rank "
        f"{rank}: refresh {out['refresh_step_ms']:.1f} ms, hot {out['hot_step_ms']} ms, "
        f"peak {out['max_memory_allocated'] / 2**30:.2f} GiB")
    return out


def _unflatten_like(like, flat_by_path, dev):
    """A params dict shaped like ``like`` from {keystr path: host tensor},
    on ``dev``."""
    from repro_torch.core.lowrank import flatten_with_path, tree_unflatten

    return tree_unflatten(like, [flat_by_path[p].to(dev) for p, _ in flatten_with_path(like)])


def tables_kernel_cases(results):
    """Kernels 4, 5, 7, 8 and 9 against their plain versions at the
    tables path's shapes: 4, 5 and 9 (at GaLore's k') on each bucket of
    Adam's plan, 7 and 8 on each of the side-split plan's, f32 W."""
    cases = []
    for bucket in TABLES_BUCKETS:
        cases += rank_kernel_cases(results, ranks=(bucket[2],), shape=bucket, kp=TABLES_KP)
    return cases + update_kernel_cases(results, main_dn=None, plans={
        "adam_mini": TABLES_SPLIT_BUCKETS, "adam8bit": TABLES_SPLIT_BUCKETS})


def paper_tables(smi: str, results=None, dev: str = "cuda", steps: int = TABLES_STEPS,
                 tau: int = TABLES_TAU, preset=None, cfg_kw=None):
    """The ``tables`` phase: first ``tables_kernel_cases`` (recorded in
    ``results``, the kernels' report), then tables 1, 3 and 4 through
    ``repro_torch.benchmarks.tables`` (table 3 reuses table 1's adam and
    galore-sara-adam runs), figures 2, 3a/b and 4 from table 1's runs
    (``figures.fig2_row`` etc.: no extra runs), at the ``llama-60m`` preset
    (``preset`` overrides its fields and ``cfg_kw`` the model config's: a
    CPU rehearsal's smoke width, ``attn_impl="pallas"``).  The
    fused-eligible low-rank rows run on the bucketed engine, the rest per
    leaf; each row records its engine.  Fails unless every loss is finite,
    the first near ln(vocab) + 0.02^2 d_model / 2 and the final below it;
    each row's kernel launches are exact; SARA's mean adjacent overlap is
    below GaLore's; full Adam's state is > 1.99x its params and every
    low-rank row's < 1.6x; ``state_memory_bytes`` equals the state tensors'
    storage bytes (plus the host's step and key), and on the card the
    allocator's growth over ``opt.init`` exceeds the state's device bytes
    by less than ``ALLOC_ROUND`` per tensor.  The loss ordering and the gap
    reductions are reported, not asserted: they are the experiment's
    result."""
    import math

    from repro_torch.benchmarks import common, figures
    from repro_torch.benchmarks import tables as tables_lib
    from repro_torch.core.lowrank import HOST_STATE_BYTES, state_memory_bytes, state_tensors
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.examples.pretrain_lm import PRESETS
    from repro_torch.kernels import counters

    p = dict(PRESETS[TABLES_PRESET], **(preset or {}))
    model_kw = dict(dict(vocab=p["vocab_size"], n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                         head_dim=p["head_dim"], d_ff=p["d_ff"], dtype=torch.bfloat16,
                         rope_theta=10000.0, loss_chunk=2048), **(cfg_kw or {}))
    shape = dict(d_model=p["d_model"], n_layers=p["n_layers"], seq=p["seq"], batch=p["batch"],
                 device=dev, model_kw=model_kw)
    train_kw = dict(steps=steps, lr=TABLES_LR, rank=p["rank"], tau=tau, alpha=0.25,
                    engine="bucketed", svd_backend="randomized", track_overlap=True)
    t0 = time.perf_counter()
    cases = tables_kernel_cases(results) if dev == "cuda" else []
    log(f"tables: kernel cases in {time.perf_counter() - t0:.1f} s")
    cfg, model = common.bench_model(d_model=p["d_model"], n_layers=p["n_layers"], device=dev,
                                    **model_kw)
    log(f"tables: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, seq {p['seq']}, batch {p['batch']}, rank {p['rank']}, alpha 0.25, "
        f"lr {TABLES_LR}, {steps} steps, tau {tau} ({smi})")
    # a warm-up of two steps (a refresh and a hot step), so that the first
    # row's time per step does not carry the first launches' compiles
    # (Triton's RMSNorm) and library set-up
    warm = dict(train_kw, steps=2, tau=2, track_overlap=False)
    common.train_once(model, common.SharedBatches(
        common.bench_data(cfg, seq=p["seq"], batch=p["batch"], device=dev), 2),
        "galore-adam", **warm)
    t0 = time.perf_counter()
    counters.reset()
    runs, zipf = {}, {}
    rows = tables_lib.table1(results=runs, **shape, **train_kw)
    rows += tables_lib.table3(results=runs, **shape, **train_kw)
    rows += tables_lib.table4(results=zipf, **shape, **train_kw)
    launches = counters.snapshot()
    params0 = model.init(torch.Generator(device=dev).manual_seed(0))
    rows.append(figures.fig2_row(runs["galore-adam"]))
    rows += figures.fig3_rows({n: runs[n] for n in ("galore-adam", "galore-sara-adam")})
    rows += [figures.fig4_row(n, runs[n], params0, p["rank"])
             for n in ("galore-adam", "galore-sara-adam", "adam")]
    seconds = time.perf_counter() - t0

    for table, results in (("bigram", runs), ("zipf", zipf)):
        for name, out in results.items():
            ls = out["losses"]
            log(f"tables {table}/{name} ({out['engine']}): {out['us_per_step'] / 1e3:.1f} ms a "
                f"step; loss {ls[0]:.4f} -> {out['final_loss']:.4f}, max {max(ls):.4f}, every "
                f"4th {[round(x, 3) for x in ls[::4]]}; launches {out['launches']}")
    loss0 = math.log(cfg.vocab_size) + 0.02**2 * cfg.d_model / 2
    (fwd_norms, fwd_attns), (remat_norms, remat_attns) = forward_launches(cfg)
    refreshes = -(-steps // tau)
    report, summed = {}, {}
    for table, results in (("bigram", runs), ("zipf", zipf)):
        for name, out in results.items():
            losses, opt, state = out["losses"], out["optimizer"], out["state"]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"tables {table}/{name}: non-finite loss {losses}")
            if abs(losses[0] - loss0) > 1.0:
                raise AssertionError(f"tables {table}/{name}: first loss {losses[0]:.3f} is not "
                                     f"near ln(vocab) + 0.02^2 d_model / 2 = {loss0:.3f}")
            if not out["final_loss"] < losses[0]:
                raise AssertionError(f"tables {table}/{name}: final loss {out['final_loss']:.4f} "
                                     f"not below the first {losses[0]:.4f}")
            expect = {"rmsnorm": steps * (fwd_norms + remat_norms),
                      "flash_attention_fwd": steps * (fwd_attns + remat_attns)}
            if name != "adam":
                shapes = [tuple(x.shape) for x in tree_leaves(state.params)]
                expect["power_iter_batched"] = power_iter_calls(opt, shapes) * refreshes
            if out["engine"] == "bucketed":
                nb = len(opt.bucket_plan.buckets)
                expect["galore_project_batched"] = steps * nb
                expect[UPDATE_KERNEL[opt.config.inner]] = steps * nb
            expect = {k: v for k, v in expect.items() if v}
            if out["launches"] != expect:
                raise AssertionError(f"tables {table}/{name}: launches {out['launches']} != "
                                     f"expected {expect}")
            for k, v in out["launches"].items():
                summed[k] = summed.get(k, 0) + v
            mem = out["memory"]
            ratio = mem["state_to_param_ratio"]
            if (name == "adam" and not ratio > 1.99) or (name != "adam" and not ratio < 1.6):
                raise AssertionError(f"tables {table}/{name}: state/param ratio {ratio:.4f}")
            tensors = state_tensors(state.opt_state)
            storage = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                       for t in tensors}
            nbytes = state_memory_bytes(state.opt_state)
            if not nbytes == mem["opt_state_bytes"] == sum(storage.values()) + HOST_STATE_BYTES:
                raise AssertionError(
                    f"tables {table}/{name}: state_memory_bytes {nbytes} (at init "
                    f"{mem['opt_state_bytes']:.0f}) != storage {sum(storage.values())} + "
                    f"{HOST_STATE_BYTES}")
            slack = None
            if mem["allocator_growth"] is not None:
                slack = mem["allocator_growth"] - (nbytes - HOST_STATE_BYTES)
                if not 0 <= slack < ALLOC_ROUND * len(tensors):
                    raise AssertionError(
                        f"tables {table}/{name}: allocator grew {mem['allocator_growth']} over "
                        f"opt.init for {nbytes - HOST_STATE_BYTES} state bytes in "
                        f"{len(tensors)} tensors")
            report[f"{table}/{name}"] = {
                "engine": out["engine"], "first_loss": losses[0],
                "final_loss": out["final_loss"], "max_loss": max(losses),
                "us_per_step": out["us_per_step"],
                "overlaps": out["overlaps"], "launches": out["launches"], "expected": expect,
                "state_to_param_ratio": ratio, "opt_state_bytes": nbytes,
                "param_bytes": mem["param_bytes"], "state_tensors": len(tensors),
                "allocator_growth": mem["allocator_growth"], "allocator_slack": slack,
            }
            common.record(f"tables/{table}/{name}", out["us_per_step"], engine=out["engine"],
                          state_layout="bucketed" if out["engine"] == "bucketed" else "perleaf",
                          device=smi, final_loss=out["final_loss"],
                          state_to_param_ratio=ratio)
    if summed != launches:
        raise AssertionError(f"tables: launches {launches} != the rows' sum {summed}")
    adj = {n: sum(runs[n]["overlaps"]) / len(runs[n]["overlaps"])
           for n in ("galore-adam", "galore-sara-adam")}
    if not adj["galore-sara-adam"] < adj["galore-adam"]:
        raise AssertionError(f"tables: SARA's mean adjacent overlap is not below GaLore's: {adj}")
    order = sorted((r["final_loss"], k) for k, r in report.items() if k.startswith("bigram/"))
    log(f"tables: {len(report)} runs in {seconds:.1f} s; mean adjacent overlap {adj}; bigram "
        f"final losses best first {[(k[7:], round(v, 4)) for v, k in order]}")
    for name, us, derived in rows:
        log(f"  {name}: {us / 1e3:.2f} ms/step, {derived}")
    return {
        "preset": p, "steps": steps, "tau": tau, "lr": TABLES_LR, "seconds": seconds,
        "card": smi, "rows": [list(r) for r in rows], "runs": report,
        "records": list(common.JSON_RECORDS), "mean_adjacent_overlap": adj,
        "launches": launches, "cases": cases,
    }


# ---------------------------------------------------------------------------


# every phase in order; ``--only a,b`` runs a subset (a quick check of a
# few paths on the card), no argument runs them all
# ---------------------------------------------------------------------------
# phase 5b: data-parallel training on torch.distributed
# ---------------------------------------------------------------------------


def train_buckets(layers: int, plan=TRAIN_BUCKETS):
    """A plan of ``TRAIN_LAYERS`` layers (``TRAIN_BUCKETS``, or
    ``SPLIT_BUCKETS``) at ``layers`` layers: every bucket's slices scale
    with the depth (k/v and q/o two a layer, the mlp three, or its two
    sides two and one); None (per-leaf state) stays None."""
    if plan is None:
        return None
    return [(d, n, r, b * layers // TRAIN_LAYERS, side) for d, n, r, b, side in plan]


def _count_plain_dispatch() -> None:
    """CPU rehearsal only: count the ops dispatchers' calls as launches, as
    the kernels count theirs on the card (no kernel launches on the CPU)."""
    from repro_torch.kernels import counters
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lowrank_update import ops as up_ops
    from repro_torch.kernels.power_iter import ops as pi_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops

    for mod, fn, name in ((rn_ops, "rmsnorm", "rmsnorm"),
                          (fa_ops, "flash_attention", "flash_attention_fwd"),
                          (up_ops, "bucketed_project", "galore_project_batched"),
                          *((up_ops, f"bucketed_{i}_update", UPDATE_KERNEL[i])
                            for i in ("adam", "msgd", "adam_mini", "adam8bit")),
                          (pi_ops, "power_iter_step", "power_iter_batched")):
        def counted(*a, _f=getattr(mod, fn), _n=name, **k):
            counters.bump(_n)
            return _f(*a, **k)
        setattr(mod, fn, counted)


def _dp_pad_cases(dev: str, rank: int, shape=DP_PAD_SHAPE):
    """Kernels 4-8 on one process's block of rows of a padded ZeRO stack,
    passed as a ``narrow`` of the padded stack (contiguous, its data away
    from the buffer's start): a block of real rows and a block of pad rows
    (zero W, P, R and state; 8-bit scales 0), each against the plain
    version, and the pad block's W' exactly 0 and every output finite.
    ``dev`` places the tensors ("cuda:0", "cpu"); on the card each case
    calls its kernel (its count must rise by one) and on the CPU, the
    rehearsal, the plain version twice."""
    from repro_torch.core.buckets import zero_padded_batch
    from repro_torch.kernels import counters
    from repro_torch.kernels.galore_project import kernel as project_kernel
    from repro_torch.kernels.galore_project.ref import project_ref
    from repro_torch.kernels.lowrank_update import quantize as qz

    on_card = torch.device(dev).type == "cuda"

    def launched(fn, name):
        """fn()'s result, after checking that it launched ``name`` once
        on the card and nothing on the CPU."""
        before = counters.snapshot()
        got = fn()
        now = counters.snapshot()
        delta = {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
        if delta != ({name: 1} if on_card else {}):
            raise AssertionError(f"train_dp pad {name}: launches {delta}")
        return got

    d, n, r, b = shape
    bp = zero_padded_batch(b, DP_ZERO_SHARDS)
    rows = bp // DP_ZERO_SHARDS
    blocks = ((b - 1) // rows, bp // rows - 1)  # the last block of real rows, of pad rows
    if bp == b:
        raise AssertionError(f"train_dp: {shape} leaves no pad rows at {DP_ZERO_SHARDS} shards")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 + rank)

    def padded(*shape, scale=1.0):
        x = torch.zeros((bp,) + shape, device=dev)
        x[:b] = torch.randn((b,) + shape, generator=gen, device=dev) * scale
        return x

    out = {}
    w, p, g = padded(d, n, scale=0.02), padded(d, r), padded(d, n)
    p[:b] = torch.linalg.qr(p[:b])[0]
    rg = padded(r, n)
    for inner in ("adam", "msgd", "adam_mini", "adam8bit"):
        side = "right" if inner in ("adam_mini", "adam8bit") else "any"
        m = padded(r, n, scale=0.1)
        if inner == "adam":
            state = (m, padded(r, n, scale=0.1) ** 2)
        elif inner == "msgd":
            state = (m,)
        elif inner == "adam_mini":
            state = (m, padded(r if side == "left" else n, scale=0.1) ** 2)
        else:
            mc, ms = qz.quantize_stacked(m[:b], side, signed=True)
            vc, vs = qz.quantize_stacked(padded(r, n, scale=0.1)[:b] ** 2, side, signed=False)
            state = tuple(torch.cat([x, x.new_zeros((bp - b,) + tuple(x.shape[1:]))])
                          for x in (mc, ms, vc, vs))
        kernel, plain = fused_update(inner, on_card), fused_update(inner, False)
        for k in blocks:
            view = lambda x: x.narrow(0, k * rows, rows)  # noqa: E731
            args = (view(w), view(p), view(rg), tuple(map(view, state)), 3, 0.01 * 0.25, 0.0,
                    side, INNER_KW[inner])
            got = launched(lambda: kernel(*args), UPDATE_KERNEL[inner])
            want = plain(*args)
            errs = check_update(inner, f"train_dp pad {inner} rows {k * rows}:", got, want,
                                "float32")
            if not all(bool(torch.isfinite(x.float()).all()) for x in got):
                raise AssertionError(f"train_dp pad {inner} block {k}: a non-finite output")
            if k * rows >= b and bool(got[0].any()):
                raise AssertionError(f"train_dp pad {inner}: pad rows' W' is not 0")
            out[f"{inner} rows {k * rows}:{(k + 1) * rows}"] = errs
    for k in blocks:
        gv, pv = g.narrow(0, k * rows, rows), p.narrow(0, k * rows, rows)
        got = launched(lambda: (project_kernel.galore_project_batched(gv, pv) if on_card
                                else project_ref(gv, pv)), "galore_project_batched")
        out[f"project rows {k * rows}:{(k + 1) * rows}"] = check_close(
            f"train_dp pad project block {k}", got, project_ref(gv, pv),
            *TOL["galore_project_batched"]["float32"], rel_atol=True)
    return out


class _ThreadHub:
    """The collectives of ``size`` threads of one process, each one rank of
    a data-parallel world: a call puts its tensor in its slot, waits for
    every rank, combines the slots in rank order (so every rank sums in one
    order) and waits again before a slot is reused.  The threads share the
    card's default stream, so the card runs their work in the order the
    barriers give it on the host.  A rank that fails breaks the barrier,
    and the others raise."""

    def __init__(self, size: int):
        import threading

        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=DP_TIMEOUT_S)

    def exchange(self, index: int, t, combine):
        self.slots[index] = t
        self.barrier.wait()
        out = combine(self.slots)
        self.barrier.wait()
        return out

    def run(self, fn):
        """fn(rank) on every rank, each in a thread of its own; re-raises
        the first failure."""
        import threading

        errors = []

        def target(k):
            try:
                fn(k)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors.append((k, e))
                self.barrier.abort()

        threads = [threading.Thread(target=target, args=(k,)) for k in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # a rank's own failure first, not the broken barrier it left behind
        errors.sort(key=lambda ke: isinstance(ke[1], threading.BrokenBarrierError))
        if errors:
            k, e = errors[0]
            raise AssertionError(f"train_dp emulated rank {k}: {e!r}") from e


def _cloned(x):
    """A copy of every tensor of a tree of dicts, lists and (named) tuples."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_cloned, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_cloned, x))
    return x


def _summed(xs):
    out = xs[0].clone()
    for x in xs[1:]:
        out += x
    return out


class _EmuAxes:
    """``launch/mesh.DPAxes`` over the ranks of a ``_ThreadHub``: the same
    calls, and the same byte counts, into the rank's own ``comm``."""

    def __init__(self, names, size: int, index: int, hub: _ThreadHub, comm):
        self.names, self.size, self.index, self.group, self.comm = names, size, index, hub, comm

    def _count(self, kind: str, nbytes: int) -> None:
        self.comm[kind] += nbytes
        self.comm[kind + "_calls"] += 1

    def all_reduce_(self, t):
        self._count("all_reduce", t.numel() * t.element_size())
        return t.copy_(self.group.exchange(self.index, t, _summed))

    def all_reduce_scalars(self, values):
        self.comm["scalars_calls"] += 1
        return self.group.exchange(self.index, values, _summed)

    def reduce_scatter(self, t):
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows over {self.size} ranks")
        t = t.contiguous()
        rows = t.shape[0] // self.size
        lo = self.index * rows
        self._count("reduce_scatter", t.numel() * t.element_size())
        return self.group.exchange(self.index, t,
                                   lambda xs: _summed([x[lo:lo + rows] for x in xs]))

    def all_gather(self, t):
        t = t.contiguous()
        self._count("all_gather", t.numel() * t.element_size() * self.size)
        return self.group.exchange(self.index, t, torch.cat)


class _EmuMesh:
    """The (ranks, 1) data x model mesh of a ``_ThreadHub``'s ranks, as
    ``launch/mesh.make_mesh`` builds one over processes."""

    axis_names = ("data", "model")
    distributed = True
    tp = 1  # no tensor parallelism: the model axis has extent 1

    def __init__(self, hub: _ThreadHub, index: int):
        from collections import Counter

        self.hub, self.rank, self.size = hub, index, hub.size
        self.shape = {"data": hub.size, "model": 1}
        self.coords = {"data": index, "model": 0}
        self.comm = Counter()

    def axes(self, names):
        if tuple(names) != ("data",):
            raise ValueError(f"the emulated mesh has one data-parallel axis, not {names}")
        return _EmuAxes(("data",), self.size, self.rank, self.hub, self.comm)

    def model_axes(self):
        from repro_torch.launch.mesh import DPAxes

        return DPAxes(("model",), 1, 0)


def _dp_emulated(cfg, dev: str, seq: int, batch: int, opt_kw, expect_buckets,
                 steps: int = DP_STEPS):
    """``DP_EMU_RANKS`` ranks as threads of this process on its device
    (``_ThreadHub``), through ``make_train_step(mesh=..., compressed=
    "flat")`` with replicated and with ZeRO state (state_shards = ranks),
    ``steps`` steps (a refresh, then hot steps) on the global batches.
    Holds every rank's params equal to rank 0's bit for bit, ZeRO's to
    replicated's (``DP_ZERO_TOL``), both to the single-process step's (the
    trajectory's losses and Adam's cap; one hot step from its state to
    ``DP_HOT_TOL``), each rank's bytes to the collectives
    to ``dp_comm_model``'s, ZeRO's rows per bucket, the launches exactly
    (every rank's forward, backward, projection and fused update), and a
    NaN in the last rank's share skipped by every rank, its state kept."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import buckets as buckets_lib
    from repro_torch.core import lowrank as lowrank_lib
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.train.recovery import RecoveryPolicy
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    n = DP_EMU_RANKS
    opt_kw = dict(DP_OPT, **(opt_kw or {}))
    model = build_model(cfg, device=dev)
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                global_batch=batch), device=dev)
    batches = [data.batch_at(s) for s in range(steps + 1)]
    tc = TrainConfig(total_steps=steps, seed=SEED)
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fresh():
        return model.init(torch.Generator(device=dev).manual_seed(SEED))

    def optimizer(params, shards=0):
        zero = dict(state_sharding="zero", state_shards=shards) if shards else {}
        return make_optimizer("galore-sara-adam", params, lr_schedule=cosine_with_warmup(
            opt_kw["lr"], TRAIN_WARMUP, steps), **opt_kw, **zero)

    def run(fns, state, s, batch_s=None):
        return (fns["refresh_step"] if s == 0 else fns["step"])(
            state, batches[s] if batch_s is None else batch_s)

    # the single-process path on the same global batches
    params = fresh()
    opt = optimizer(params)
    plan = [(bk.d, bk.n, bk.rank, bk.batch, bk.side) for bk in opt.bucket_plan.buckets]
    if plan != list(expect_buckets):
        raise AssertionError(f"train_dp emulated: bucket plan {plan} != {expect_buckets}")
    flat_like = [buckets_lib._Like(tuple(p.shape), p.dtype) for p in tree_leaves(params)]
    nb = len(plan)
    (fwd_n, fwd_a), (rem_n, rem_a) = forward_launches(cfg)
    # per rank: ``steps`` steps and the hot step from the reference's state
    per_rank = {"rmsnorm": (steps + 1) * (fwd_n + rem_n),
                "flash_attention_fwd": (steps + 1) * (fwd_a + rem_a),
                "galore_project_batched": (steps + 1) * nb, UPDATE_KERNEL["adam"]: (steps + 1) * nb,
                "power_iter_batched": power_iter_calls(opt, [x.shape for x in flat_like])}
    expect = {k: n * v for k, v in per_rank.items() if v}
    fns = make_train_step(model, opt, train_cfg=tc)
    state, ref, ref_losses = TrainState(params, opt.init(params)), [], []
    del params
    for s in range(steps):
        state, m = run(fns, state, s)
        ref.append([p.clone() for p in tree_leaves(state.params)])
        ref_losses.append(float(m["loss"]))
    lr_sums = np.cumsum([float(opt.config.lr_schedule(s)) for s in range(steps)]).tolist()
    # one more hot step from the final state: what the ranks' hot step
    # from the same state is held to
    ref_state, ref_opt = state, opt
    ref_hot = [p.clone() for p in tree_leaves(run(fns, _cloned(state), steps)[0].params)]
    del state, fns, opt

    out = {"ranks": n, "plan": plan, "runs": {}, "launches": {}, "expected": expect}
    finals = {}
    for kind in ("replicated", "zero"):
        hub = _ThreadHub(n)
        recs = [dict(params=[], comm=[], ms=[], losses=[]) for _ in range(n)]

        def steps_of(k, kind=kind, hub=hub, recs=recs):
            mesh = _EmuMesh(hub, k)
            params = fresh()
            opt = optimizer(params, n if kind == "zero" else 0)
            fns = make_train_step(model, opt, mesh=mesh, train_cfg=tc, compressed="flat")
            state = fns["place_state"](TrainState(params, opt.init(params)))
            del params
            rec = recs[k]
            for s in range(steps):
                mesh.comm.clear()
                t = time.perf_counter()
                state, m = run(fns, state, s)
                sync()
                rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["losses"].append(float(m["loss"]))
                rec["comm"].append(dict(mesh.comm))
                rec["params"].append([p.clone() for p in tree_leaves(state.params)])
            rec.update(state=state, opt=opt, mesh=mesh,
                       model=buckets_lib.dp_comm_model(opt.bucket_plan, flat_like,
                                                       state_shards=opt.state_layout.shards),
                       rows=[b.projector.shape[0] for b in state.opt_state.buckets])
            # one hot step from the single-process state, in this layout
            start = TrainState(_cloned(ref_state.params), lowrank_lib.storage_opt_state(
                opt, lowrank_lib.canonical_opt_state(ref_opt, _cloned(ref_state.opt_state))))
            rec["hot"] = tree_leaves(run(fns, fns["place_state"](start), steps)[0].params)

        before = counters.snapshot()
        hub.run(steps_of)
        now = counters.snapshot()
        launched = {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
        if launched != expect:
            raise AssertionError(f"train_dp emulated {kind}: launches {launched} != {expect}")
        out["launches"] = {k: out["launches"].get(k, 0) + v for k, v in launched.items()}

        shards = recs[0]["opt"].state_layout.shards
        want_rows = [buckets_lib.zero_padded_batch(b, n) // n if kind == "zero" else b
                     for _, _, _, b, _ in plan]
        key = "zero" if kind == "zero" else "compressed"
        errs, ref_errs = [], []
        for k, rec in enumerate(recs):
            if rec["rows"] != want_rows:
                raise AssertionError(f"train_dp emulated {kind} rank {k}: rows {rec['rows']}")
            handed = [sum(c.get(x, 0) for x in ("all_reduce", "reduce_scatter", "all_gather"))
                      for c in rec["comm"]]
            want = [rec["model"][f"{key}_refresh"]["bytes"]] + \
                [rec["model"][f"{key}_hot"]["bytes"]] * (steps - 1)
            if handed != want:
                raise AssertionError(f"train_dp emulated {kind} rank {k}: bytes {handed} != {want}")
            for s in range(steps):
                for a, b in zip(rec["params"][s], recs[0]["params"][s]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"train_dp emulated {kind} step {s}: rank {k}'s "
                                             "params differ from rank 0's")
        shares = []
        for s in range(steps):
            got = recs[0]["params"][s]
            diffs = [(a - b).abs() for a, b in zip(got, ref[s])]
            ref_errs.append(max(float(x.max()) for x in diffs))
            shares.append(max(float((x > DP_HOT_TOL["atol"]).float().mean()) for x in diffs))
            del diffs
            if kind == "zero":
                errs.append(max(float((a - b).abs().max())
                                for a, b in zip(got, finals["replicated"][s])))
        gaps = [abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], ref_losses)]
        caps = [2 * x for x in lr_sums]
        hot = [(a - b).abs() for a, b in zip(recs[0]["hot"], ref_hot)]
        hot_err = max(float(x.max()) for x in hot)
        hot_share = max(float((x > DP_HOT_TOL["atol"]).float().mean()) for x in hot)
        del hot
        if (max(gaps) > RESUME_LOSS_RTOL or any(e > c for e, c in zip(ref_errs, caps))
                or hot_share > DP_HOT_TOL["share"] or hot_err > DP_HOT_TOL["cap"]):
            raise AssertionError(
                f"train_dp emulated {kind} against the single-process step: loss gaps {gaps} "
                f"(bar {RESUME_LOSS_RTOL}), params' max abs err {ref_errs} (caps {caps}); a hot "
                f"step from its state: max abs err {hot_err}, largest share of a leaf off by > "
                f"{DP_HOT_TOL['atol']} {hot_share} (bar {DP_HOT_TOL})")
        if errs and max(errs) > DP_ZERO_TOL:
            raise AssertionError(f"train_dp emulated zero: params against replicated {errs} > "
                                 f"{DP_ZERO_TOL}")
        finals[kind] = recs[0]["params"]
        rec0 = recs[0]
        out["runs"][kind] = {
            "shards": shards, "rows": rec0["rows"], "ms": [r["ms"] for r in recs],
            "bytes": handed, "model_bytes": want, "max_abs_err_vs_single_process": ref_errs,
            "share_off_vs_single_process": shares, "loss_rel_gaps": gaps,
            "hot_step_max_abs_err": hot_err, "hot_step_share_off": hot_share,
            "max_abs_err_vs_replicated": errs or None,
            "comm_calls": {c: v for c, v in rec0["comm"][-1].items() if c.endswith("_calls")}}
        log(f"train_dp emulated {kind} ({n} ranks as threads of one process on {dev}, shards "
            f"{shards}, rows {rec0['rows']}): rank 0 refresh {rec0['ms'][0]:.1f} ms, hot "
            f"{[round(t, 1) for t in rec0['ms'][1:]]} ms (the ranks' work in turn on one "
            f"device); against the single-process step, loss gaps {gaps}, params max abs err "
            f"per step {ref_errs}, largest share of a leaf off by > {DP_HOT_TOL['atol']} "
            f"{shares}; a hot step from its state, max abs err {hot_err}, share off {hot_share}"
            + (f"; params against replicated {errs}" if errs else "")
            + f", equal on every rank; bytes to the collectives per rank {handed} "
            f"(dp_comm_model {want}); collective calls of a hot step "
            f"{out['runs'][kind]['comm_calls']}")
        if kind == "zero":
            # a non-finite gradient in the last rank's share: every rank
            # skips the step and keeps its state
            skips = [None] * n

            def skip_of(k, recs=recs):
                rec = recs[k]
                gated = make_train_step(model, rec["opt"], mesh=rec["mesh"], train_cfg=tc,
                                        compressed="flat",
                                        recovery=RecoveryPolicy(rollback_backoff_s=0.0))
                bad = dict(batches[steps])
                if k == n - 1:
                    bad["grad_scale"] = np.float32("nan")
                before = state_checksums(rec["state"])
                new, m = gated["step"](rec["state"], bad)
                skips[k] = {"skipped": float(m["skipped"]), "bad_step": float(m["bad_step"]),
                            "unchanged": state_checksums(new) == before}

            hub.run(skip_of)
            if any(x != {"skipped": 1.0, "bad_step": 1.0, "unchanged": True} for x in skips):
                raise AssertionError(f"train_dp emulated: the non-finite step {skips}")
            out["skip"] = skips
        del recs
        if on_card:
            torch.cuda.empty_cache()
    log(f"train_dp emulated: every rank skipped the non-finite step; launches {out['launches']}")
    return out


def _dp_worker(rank: int, world: int, out_dir: str, cfg, dev: str, seq: int, batch: int,
               opt_kw, expect_buckets, steps: int, pad_shape, emulated) -> None:
    """One process of ``train_dp``: its summary goes to ``rank<r>.json`` in
    ``out_dir``; a failed check raises (the process exits non-zero).
    ``emulated`` is what rank 0 hands ``_dp_emulated`` (cfg, seq, batch,
    optimizer overrides, bucket plan)."""
    from datetime import timedelta

    import torch.distributed as dist

    # cuBLAS's own reductions fixed, and the deterministic embedding
    # backward: the reference and the data-parallel runs then sum every
    # gradient in one order, and differ only by the reduction itself
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import buckets as buckets_lib
    from repro_torch.core import lowrank as lowrank_lib
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.device import resolve_device
    from repro_torch.kernels import counters
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build_model
    from repro_torch.train.recovery import RecoveryPolicy
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    if dev == "cuda":
        torch.cuda.set_device(rank)
        resolve_device("cuda")
        devname = f"cuda:{rank}"
    else:
        torch.set_num_threads(1)
        _count_plain_dispatch()
        devname = "cpu"
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"file://{out_dir}/store", world_size=world, rank=rank,
                            timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        log(f"train_dp rank {rank}: process group up ({dist.get_backend()}, world {world})")
        torch.use_deterministic_algorithms(True, warn_only=True)

        def sync():
            if dev == "cuda":
                torch.cuda.synchronize()

        opt_kw = dict(DP_OPT, **(opt_kw or {}))
        if world > 1:
            # each process's bf16 products over its own rows round apart
            # from the single-process step's over all of them (2.6e-4 in W
            # at world 2 on the CPU, 3e-8 with f32 compute): a world of
            # several processes computes in f32, as the CPU tests do
            cfg = cfg.with_(dtype=torch.float32)
        model = build_model(cfg, device=devname)
        data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                    global_batch=batch), device=devname)
        batches = [data.batch_at(s) for s in range(steps + 1)]
        mesh = mesh_lib.make_mesh((world, 1))
        tc = TrainConfig(total_steps=steps, seed=SEED)

        def fresh():
            return model.init(torch.Generator(device=devname).manual_seed(SEED))

        def optimizer(params, shards=0):
            zero = dict(state_sharding="zero", state_shards=shards) if shards else {}
            return make_optimizer("galore-sara-adam", params, lr_schedule=cosine_with_warmup(
                opt_kw["lr"], TRAIN_WARMUP, steps), **opt_kw, **zero)

        def run(fns, state, after=None):
            ms, losses = [], []
            for s in range(steps):
                mesh_lib.comm_reset()
                before = counters.snapshot()
                sync()
                t = time.perf_counter()
                state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, batches[s])
                sync()
                ms.append((time.perf_counter() - t) * 1e3)
                losses.append(float(m["loss"]))
                if after is not None:
                    now = counters.snapshot()
                    after(s, state, {k: now.get(k, 0) - before.get(k, 0) for k in now
                                     if now.get(k, 0) != before.get(k, 0)})
            return state, ms, losses

        # the single-process path on the same global batches, its params
        # after each step kept on the host, in page-locked memory on the
        # card's machine (a copy of the 7.7 GB there and back at the link's
        # rate, not at a pageable copy's)
        def host_copy(st):
            out = []
            for p in tree_leaves(st.params):
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=dev == "cuda")
                out.append(h.copy_(p, non_blocking=True))
            sync()
            return out

        params = fresh()
        opt = optimizer(params)
        plan = [(bk.d, bk.n, bk.rank, bk.batch, bk.side) for bk in opt.bucket_plan.buckets]
        if plan != list(expect_buckets):
            raise AssertionError(f"train_dp bucket plan {plan} != {expect_buckets}")
        flat_like = [buckets_lib._Like(tuple(p.shape), p.dtype) for p in tree_leaves(params)]
        power_iters = power_iter_calls(opt, [x.shape for x in flat_like])
        ref_host = []
        state, ref_ms, ref_losses = run(
            make_train_step(model, opt, train_cfg=tc), TrainState(params, opt.init(params)),
            lambda s, st, d: ref_host.append(host_copy(st)))
        del state, params, opt
        if dev == "cuda":
            torch.cuda.empty_cache()
        log(f"train_dp rank {rank}: the single-process path, refresh {ref_ms[0]:.1f} ms, hot "
            f"{[round(t, 1) for t in ref_ms[1:]]} ms, its params kept on the host")
        (fwd_n, fwd_a), (rem_n, rem_a) = forward_launches(cfg)
        nb = len(plan)
        tol = TOL[UPDATE_KERNEL["adam"]]["float32"]
        out = {"rank": rank, "world": world, "plan": plan, "ref_ms": ref_ms,
               "ref_losses": ref_losses, "runs": {}}
        launches = {}  # the main path: the data-parallel runs
        model_bytes = None
        # ZeRO at one process is one shard, the replicated step itself: a
        # world of one runs only the replicated state (its ZeRO step runs in
        # ``_dp_emulated``)
        kinds = ("replicated", "zero") if world > 1 else ("replicated",)
        for kind in kinds:
            params = fresh()
            opt = optimizer(params, world if kind == "zero" else 0)
            fns = make_train_step(model, opt, mesh=mesh, train_cfg=tc, compressed="flat")
            state = fns["place_state"](TrainState(params, opt.init(params)))
            del params
            model_bytes = buckets_lib.dp_comm_model(opt.bucket_plan, flat_like,
                                                    state_shards=opt.state_layout.shards)
            rec = {"comm": [], "launches": [], "err": []}
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()

            def after(s, st, launched, rec=rec):
                rec["comm"].append(mesh_lib.comm_snapshot())
                rec["launches"].append(launched)
                err = 0.0
                for (path, p), want in zip(lowrank_lib.flatten_with_path(st.params), ref_host[s]):
                    want = want.to(p.device, non_blocking=True)
                    if world == 1:  # the same sums as the reference: the kernel's bar
                        err = max(err, check_close(f"train_dp {kind} step {s} {path}", p, want,
                                                   *tol, rel_atol=True))
                        continue
                    # the gradients summed over processes: the CPU tests' bar
                    e = float((p - want).abs().max())
                    if e > DP_REFRESH_TOL:
                        raise AssertionError(f"train_dp {kind} step {s} {path}: max abs err {e} "
                                             f"> {DP_REFRESH_TOL}")
                    err = max(err, e)
                rec["err"].append(err)

            counters.reset()
            state, ms, losses = run(fns, state, after)
            for k, v in counters.snapshot().items():
                launches[k] = launches.get(k, 0) + v
            rec.update(ms=ms, losses=losses, shards=opt.state_layout.shards,
                       rows=[b.projector.shape[0] for b in state.opt_state.buckets],
                       max_memory_allocated=(torch.cuda.max_memory_allocated()
                                             if dev == "cuda" else 0))
            key = "zero_hot" if opt.state_layout.shards > 1 else "compressed_hot"
            want_hot = model_bytes[key]["bytes"]
            want_ref = model_bytes[key.replace("hot", "refresh")]["bytes"]

            def handed(c):
                return sum(c.get(k, 0) for k in ("all_reduce", "reduce_scatter", "all_gather"))

            rec["bytes"] = {"refresh": handed(rec["comm"][0]), "hot": handed(rec["comm"][1]),
                            "model_refresh": want_ref, "model_hot": want_hot}
            if (rec["bytes"]["refresh"], rec["bytes"]["hot"]) != (want_ref, want_hot):
                raise AssertionError(f"train_dp {kind}: bytes to the collectives {rec['bytes']}")
            for s in range(1, steps):  # each hot step: kernels 4 and 5 once per bucket
                hot = rec["launches"][s]
                if (hot.get("galore_project_batched"), hot.get(UPDATE_KERNEL["adam"])) != (nb, nb):
                    raise AssertionError(f"train_dp {kind} hot step {s} launches {hot}")
            out["runs"][kind] = rec
            log(f"train_dp rank {rank} {kind} (shards {rec['shards']}, rows {rec['rows']}): "
                f"refresh {ms[0]:.1f} ms, hot {[round(t, 1) for t in ms[1:]]} ms beside the "
                f"single-process path's {ref_ms[0]:.1f} / {[round(t, 1) for t in ref_ms[1:]]} ms; "
                f"params against it, max abs err per step {rec['err']}; bytes to the "
                f"collectives refresh {rec['bytes']['refresh']} hot {rec['bytes']['hot']} "
                f"(dp_comm_model {want_ref} / {want_hot}); max_memory_allocated "
                f"{rec['max_memory_allocated'] / 2**30:.2f} GiB")
            if kind == "replicated":
                out["in_process"] = _dp_in_process(model, state, opt, optimizer, batches[steps],
                                                   Path(out_dir) / f"rank{rank}", dev)
            if kind == kinds[-1]:
                # a non-finite gradient in the last process's share: every
                # process skips the step and keeps its state
                gated = make_train_step(model, opt, mesh=mesh, train_cfg=tc, compressed="flat",
                                        recovery=RecoveryPolicy(rollback_backoff_s=0.0))
                bad = dict(batches[steps])
                if rank == world - 1:
                    bad["grad_scale"] = np.float32("nan")
                before = state_checksums(state)
                new, m = gated["step"](state, bad)
                out["skip"] = {"skipped": float(m["skipped"]), "bad_step": float(m["bad_step"]),
                               "unchanged": state_checksums(new) == before}
                del new, gated
            del state, fns
            if dev == "cuda":
                torch.cuda.empty_cache()
        per_run = {"rmsnorm": steps * (fwd_n + rem_n), "flash_attention_fwd": steps * (fwd_a + rem_a),
                   "galore_project_batched": steps * nb, UPDATE_KERNEL["adam"]: steps * nb,
                   "power_iter_batched": power_iters}
        expect = {k: len(kinds) * v for k, v in per_run.items() if v}
        if launches != expect:
            raise AssertionError(f"train_dp launches {launches} != {expect}")
        out.update(launches=launches, expected=expect, comm_model=model_bytes)
        out["pad_cases"] = _dp_pad_cases(devname, rank, pad_shape)
        if rank == 0:
            del model, data, batches, ref_host
            if dev == "cuda":
                torch.cuda.empty_cache()
            ecfg, eseq, ebatch, eopt, ebuckets = emulated
            out["emulated"] = _dp_emulated(ecfg, devname, eseq, ebatch, eopt, ebuckets, steps)
        log(f"train_dp rank {rank}: skipped the non-finite step ({out['skip']}), the pad-row "
            "cases held")
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()


def _dp_in_process(model, state, opt, optimizer, batch, out_dir: Path, dev: str):
    """In one process, from the replicated run's final state: one standard
    step with ``state_shards`` 4 against the replicated state's (TOL), then
    the 4-shard state's bucket stacks saved by four emulated writers and
    restored at 2 and 8 shards, bit-equal."""
    from repro_torch.core import buckets as buckets_lib
    from repro_torch.core import lowrank as lowrank_lib
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import state as state_lib
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    opt4 = optimizer(state.params, DP_ZERO_SHARDS)
    st4 = TrainState(state.params, lowrank_lib.storage_opt_state(
        opt4, lowrank_lib.canonical_opt_state(opt, state.opt_state)))
    new, _ = make_train_step(model, opt)["step"](state, batch)
    want = tree_leaves(new.params)
    del new
    new4, _ = make_train_step(model, opt4)["step"](st4, batch)
    tol = TOL[UPDATE_KERNEL["adam"]]["float32"]
    err = max(check_close(f"train_dp shards {DP_ZERO_SHARDS} {i}", a, b, *tol, rel_atol=True)
              for i, (a, b) in enumerate(zip(tree_leaves(new4.params), want)))
    del new4, want
    # the shard-parallel format, four writers emulated by one process
    stacks = TrainState({}, st4.opt_state._replace(leaves=[]))
    base = out_dir / "sharded_ckpt"  # a directory of this process's own
    mgr = ckpt_lib.CheckpointManager(
        str(base), shard_spec=ckpt_lib.ShardSpec(DP_ZERO_SHARDS, tuple(range(DP_ZERO_SHARDS))),
        canonical_rows=state_lib.bucket_canonical_rows(opt4))
    sync()
    t = time.perf_counter()
    mgr.save(stacks, 1)
    save_s = time.perf_counter() - t
    nbytes = mgr.last_save["bytes"]
    if not ckpt_lib.verify_checkpoint(str(base), 1):
        raise AssertionError("train_dp: the sharded checkpoint does not verify")
    want_rows = buckets_lib.zero_unpad_states(opt4.state_layout, st4.opt_state.buckets)
    loads = {}
    for m in DP_RESTORE_SHARDS:
        opt_m = optimizer(state.params, m)
        skel = TrainState({}, lowrank_lib.LowRankOptState(
            step=0, draws=st4.opt_state.draws, leaves=[],
            buckets=buckets_lib.init_bucket_states(opt_m.state_layout, dev)))
        sync()
        t = time.perf_counter()
        got = ckpt_lib.CheckpointManager(str(base)).load(skel, step=1)
        sync()
        loads[m] = time.perf_counter() - t
        rows = [bst.projector.shape[0] for bst in got.opt_state.buckets]
        for gb, wb in zip(buckets_lib.zero_unpad_states(opt_m.state_layout, got.opt_state.buckets),
                          want_rows):
            for x, y in zip(gb, wb):
                if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                    raise AssertionError(f"train_dp: the restore at {m} shards is not bit-equal")
        if got.opt_state.step != st4.opt_state.step or rows != [
                buckets_lib.zero_padded_batch(b.batch, m) for b in opt_m.bucket_plan.buckets]:
            raise AssertionError(f"train_dp: the restore at {m} shards: rows {rows}")
        del got, skel
    shutil.rmtree(base, ignore_errors=True)
    out = {"shards_step_max_abs_err": err, "ckpt_bytes": nbytes, "save_s": save_s,
           "save_gb_s": nbytes / save_s / 1e9, "load_s": loads,
           "load_gb_s": {m: nbytes / s / 1e9 for m, s in loads.items()}}
    log(f"train_dp in one process: a standard step at {DP_ZERO_SHARDS} shards against "
        f"replicated state, max abs err {err:.3e}; the 4-writer sharded save of the bucket "
        f"stacks {nbytes} bytes in {save_s:.2f} s ({out['save_gb_s']:.2f} GB/s), restored at "
        + ", ".join(f"{m} shards in {s:.2f} s ({nbytes / s / 1e9:.2f} GB/s)"
                    for m, s in loads.items()) + ", bit-equal")
    return out


def _emulated_cfg(n_layers: int = DP_EMU_LAYERS):
    """The emulated world's model: ``TABLES_PRESET``'s widths (the paper's
    LLaMA-60M) at ``n_layers`` layers, f32 compute."""
    from repro_torch.configs.registry import get_config
    from repro_torch.examples.pretrain_lm import PRESETS

    p = PRESETS[TABLES_PRESET]
    return get_config("llama3-8b", smoke=True).with_(
        dtype=torch.float32, d_model=p["d_model"], n_layers=n_layers, n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], rope_theta=10000.0, loss_chunk=2048)


def train_dp(cfg, smi: str, dev: str = "cuda", world: int = 0,
             seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH, opt_kw=None,
             expect_buckets=TRAIN_BUCKETS, steps: int = DP_STEPS, pad_shape=DP_PAD_SHAPE,
             emulated=None):
    """Phase 5b (path ``train_dp``): ``world`` processes (default one per
    card) on a file store under ``build/``, NCCL on the card (gloo with
    ``dev="cpu"``, the rehearsal), each running ``_dp_worker``: the
    single-process path (the reference), then ``compressed="flat"`` with
    replicated and with ZeRO state (``state_shards`` = world), each step's
    params against the reference's within the Adam update's ``TOL``, the
    bytes handed to the collectives equal to ``dp_comm_model``'s, exact
    launch counts, a skipped non-finite step, the in-process ZeRO and
    sharded-checkpoint checks and the pad-row kernel cases; the first
    process then runs ``_dp_emulated`` on ``emulated`` = (cfg, seq, batch,
    optimizer overrides, bucket plan), by default ``DP_EMU_*``.  With one
    process the ZeRO state has one shard, so only the replicated run is
    made.  ``DP_OPT`` has no clipping: the compressed step clips by the
    R-space norm, as the reference's (``src/repro/core/lowrank.py:666``),
    so a clipped run would not be the single-process step."""
    world = world or torch.cuda.device_count()
    emulated = emulated or (_emulated_cfg(), DP_EMU_SEQ, DP_EMU_BATCH, DP_EMU_OPT,
                            DP_EMU_BUCKETS)
    out_dir = fresh_dir("train_dp")
    out_dir.mkdir()
    try:
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_dp_worker, args=(r, world, str(out_dir), cfg, dev, seq,
                                                      batch, opt_kw, expect_buckets, steps,
                                                      pad_shape, emulated))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise AssertionError(f"train_dp processes ended with {codes}"
                                 f"{' (killed at the time limit)' if alive else ''}")
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        if r["skip"] != {"skipped": 1.0, "bad_step": 1.0, "unchanged": True}:
            raise AssertionError(f"train_dp rank {r['rank']}: the non-finite step {r['skip']}")
    head = ranks[0]
    # the path's launches: the processes' runs and the emulated world's
    launches = dict(head["launches"])
    for k, v in head["emulated"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    log(f"train_dp: {world} process(es), every one skipped the non-finite step; launches "
        f"{launches} (the emulated world's {head['emulated']['launches']}); pad-row cases "
        f"{head['pad_cases']}; card {smi}")
    return dict(head, launches=launches, card=smi, skips=[r["skip"] for r in ranks])


# phase 5c: tensor (and expert) parallelism over ``model``.  Two processes
# share the one card (``TP_WORLD`` ranks of a (1, 2) data x model mesh, each
# on cuda:0) over gloo, on a file store under ``build/``: NCCL refuses two
# ranks on one device, and ranks as threads of one process would block in
# backward's collectives on the autograd engine's one device thread.  The
# dense run: llama3-8b at full width cut to ``TP_LAYERS`` layer(s), seq 512,
# global batch 8, bf16 compute, ``TRAIN_OPT``, 3 steps; its losses against
# the single-process run of the same steps (made in the parent first)
# within ``TP_LOSS_GAP``: bf16 rounds each process's partial outputs before
# the f32 all-reduce, one rounding the single process does not make (the
# gaps read 1.1e-4 to 2.6e-4 on losses of ~11.8 in the H100 runs that set
# the bar).  From the single-process run's state after step 1 (lr 2e-4 at
# the next step; 0 at step 0, where the trajectory's refresh moves no
# param), in f32 compute, tensor parallel against one process: one hot
# step, each process's blocks within ``DP_HOT_TOL``; and one refresh step
# (both refresh routes, then the update with the new projectors) under
# ``momentum_carry=TP_REFRESH_CARRY``, each block's change within
# ``TP_REFRESH_REL`` of one process's: ||W'_TP - W'_1|| / ||W'_1 - W||.
# The carry: under the trajectory's "keep" a second refresh pairs the kept
# moments with the new projector's columns, whose signs the card's f32 QR
# and SVD pick differently from the two routes' rounding-apart inputs (96%
# of a block over 1e-6 in an H100 run), as they part the packages (ROADMAP
# queue 3); "reproject" turns the moments with the projector, so W' does
# not depend on the signs.  The bar: the card's f32 SVD turns rounding into
# other small singular vectors, which SARA samples and Adam's elementwise
# step does not forgive, so one process against itself with its gradient
# summed in another order (two microbatches) read up to 0.122 and tensor
# parallel against one process 0.023 to 0.147 (H100 runs); an update left
# out reads 1, one along an unrelated projector 1.2 to 1.4.  Kernel 9
# against its plain version on each "n"
# bucket's local block at the path's k', which the global n sets and may
# exceed the block's columns (q: 2056 sketch columns, 2048 local columns).
# The MoE run: deepseek-moe-16b at full width, ``TP_MOE_LAYERS`` layer,
# 32 experts per rank: at capacity factor 8 in f32 the step-0 loss within
# ``TP_MOE_LOSS_TOL`` and every gradient within ``TP_MOE_GRAD_RTOL`` of its
# leaf's largest |g| against the one-process local path, with no pair
# dropped; at the config's 1.25, 3 steps in bf16 with exact launch counts
# per rank (path ``train_tp_moe``), finite, the dropped share printed.
TP_WORLD = 2
TP_LAYERS = 1  # 2 until the other families' TP and FSDP paths joined
TP_STEPS = 3
TP_LOSS_GAP = 1e-3
TP_MOE_LAYERS = 1
TP_MOE_CAPACITY = 8.0
TP_MOE_LOSS_TOL = 1e-5
TP_MOE_GRAD_RTOL = 1e-4
TP_TIMEOUT_S = 600
TP_REFRESH_REL = 0.3
TP_REFRESH_CARRY = "reproject"
# 8-bit Adam has no reproject (its first moment is codes: it keeps the
# moments, as JAX's), so a step after a refresh turns with the new singular
# vectors' signs; under "reset" it does not, and its refresh check resets
# (measured under "keep": 1.04-1.13 of the step on every leaf, the H100)
TP_REFRESH_CARRY_8BIT = "reset"
# qwen2's key bias has a gradient of exactly zero (softmax is invariant to
# a shift of one query's scores), so what reaches it is the rounding of the
# reduction order, and Adam normalizes that to a step of ~lr in any
# direction: there ``_tp_dense``'s f32 hot step from one state is held to
# one step's largest move, lr, instead of DP_HOT_TOL (measured on the CPU:
# 6.2e-5 off at lr 0.01, the optimizer on the same gradients bit-equal)
NOISE_LEAVES = ("['blocks']['k_bias']",)
PATH_KERNELS["train_tp"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
PATH_KERNELS["train_tp_moe"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
# Phase 5d, paths ``train_fsdp`` and ``train_fsdp_moe``: FSDP over ``data``
# (the standard step at a ``data`` extent above 1), run by ``train_tp``'s
# own spawned world after its tensor-parallel runs, on a (TP_WORLD, 1) mesh
# of the same gloo group: llama3-8b at full width cut to TP_LAYERS, the
# runs and checks of ``train_tp``'s dense run against the same
# single-process run and state (its loss gaps, the f32 hot and refresh
# steps from its state, kernels 4, 5 and 9 against plain on every local
# bucket -- kernel 9 on the "n" buckets' column blocks, the sketch route),
# the bytes handed to ``@data`` in each hot step against
# ``core.lowrank.fsdp_hot_comm_bytes``, and each step's
# ``max_memory_allocated`` per process beside the single-process run's;
# then deepseek-moe-16b at 1 layer on the local path with the expert d_ff
# over ``data``: the step-0 loss and reduced gradients in f32 against one
# process's run of the same rows in two microbatches (the router's aux
# loss is per process, as JAX's per-shard pmean), then 3 bf16 steps with
# exact launches.
PATH_KERNELS["train_fsdp"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)
PATH_KERNELS["train_fsdp_moe"] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)


def _launches_since(before) -> dict:
    """The kernels' launches since the counters' snapshot ``before``."""
    from repro_torch.kernels import counters

    now = counters.snapshot()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def _train_expect(cfg, opt, steps: int, shapes=(), refreshes: int = 1) -> dict:
    """Exact launches of ``steps`` steps (the first a refresh) of ``cfg``'s
    model under the optimizer ``opt`` (this process's blocks), as ``train``
    counts them: the model's norms and attention, kernel 4 and the inner's
    update once per bucket a step on bucket-native state (none on per-leaf
    state: plain products), kernel 9 as ``power_iter_calls`` counts
    ``refreshes`` refreshes (``shapes``: the params' global shapes, read on
    per-leaf state only)."""
    (fwd_n, fwd_a), (rem_n, rem_a) = forward_launches(cfg)
    expect = {"rmsnorm": steps * (fwd_n + rem_n), "flash_attention_fwd": steps * (fwd_a + rem_a),
              "power_iter_batched": refreshes * power_iter_calls(opt, shapes)}
    if opt.state_layout is not None:
        nb = len(opt.bucket_plan.buckets)
        expect["galore_project_batched"] = steps * nb
        expect[UPDATE_KERNEL[opt.config.inner]] = steps * nb
    return {k: v for k, v in expect.items() if v}


def _blocks_within(what: str, got, want, tol=DP_HOT_TOL) -> dict:
    """Each pair of blocks (``got``, ``want``) within ``tol``: the share of
    a block's elements over ``atol`` at most ``share``, none over ``cap``.
    Returns the largest error and share."""
    out = {"max_abs_err": 0.0, "share_over_atol": 0.0}
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a - b).abs()
        off, top = float((err > tol["atol"]).float().mean()), float(err.max())
        if off > tol["share"] or top > tol["cap"]:
            raise AssertionError(f"{what}: leaf {i}: {off} of its block over {tol['atol']}, "
                                 f"max {top}")
        out.update(max_abs_err=max(out["max_abs_err"], top),
                   share_over_atol=max(out["share_over_atol"], off))
    return out


def _codes_within(what: str, got_state, want_state) -> dict:
    """8-bit codes of two canonical states (this process's blocks) at most
    one step apart; returns the largest step and the share off by one."""
    worst, off, n = 0, 0, 0
    for a, b in zip(got_state.leaves, want_state.leaves):
        if not hasattr(a.inner, "m_codes"):
            continue
        for x, y in ((a.inner.m_codes, b.inner.m_codes), (a.inner.v_codes, b.inner.v_codes)):
            d = (x.int() - y.int()).abs()
            worst, off, n = max(worst, int(d.max())), off + int((d > 0).sum()), n + d.numel()
    if worst > 1:
        raise AssertionError(f"{what}: 8-bit codes {worst} apart")
    return {"largest_step": worst, "share_off_by_one": off / max(n, 1)}


def _steps_within(what: str, got, want, start, names) -> list:
    """Each block's step (``got`` and ``want`` from the same ``start``)
    within ``TP_REFRESH_REL`` of the reference's own change,
    ||got - want|| / ||want - start||: an update left out reads 1, one
    along an unrelated projector ~1.4.  Every block's reading is logged
    before a miss raises.  Returns one record per block."""
    out = []
    for name, a, b, s0 in zip(names, got, want, start):
        err = (a - b).abs()
        out.append({"leaf": name,
                    "rel": float(torch.linalg.vector_norm(a - b)
                                 / torch.linalg.vector_norm(b - s0)),
                    "max_abs_err": float(err.max()),
                    "share_over_1e-6": float((err > 1e-6).float().mean())})
    log(f"{what}: {out}")
    bad = [r for r in out if not r["rel"] <= TP_REFRESH_REL]
    if bad:
        raise AssertionError(f"{what}: {bad} past {TP_REFRESH_REL} of the step")
    return out


def _tp_refresh_optimizer(params, opt_kw, optimizer: str = "galore-sara-adam"):
    """The dense run's optimizer with ``TP_REFRESH_CARRY`` for the f32
    refresh step from one state (8-bit Adam: ``TP_REFRESH_CARRY_8BIT``;
    see the constants)."""
    from repro_torch.core import make_optimizer
    from repro_torch.core.schedules import cosine_with_warmup

    carry = TP_REFRESH_CARRY_8BIT if "adam8bit" in optimizer else TP_REFRESH_CARRY
    return make_optimizer(optimizer, params, lr_schedule=cosine_with_warmup(
        opt_kw["lr"], TRAIN_WARMUP, TP_STEPS), **dict(opt_kw, momentum_carry=carry))


def _tp_power_cases(opt, dev: str, rank: int, fsdp: bool = False, path=None) -> list:
    """Kernel 9 on each "n" bucket's local block (B, d, n / model; over
    ``data`` with ``fsdp``) with a (B, d, k') basis at the k' of the
    bucket's global leaves (the split refresh's first chunk), against the
    plain ``bmm(G, bmm(G^T, Q))``; each case launches the kernel once (on
    the CPU, the rehearsal, the counted plain dispatch)."""
    from repro_torch.core import projectors as proj_lib
    from repro_torch.core import svd as svd_lib
    from repro_torch.kernels.power_iter import ops as pi_ops
    from repro_torch.kernels.power_iter.ref import power_iter_ref
    from repro_torch.kernels import counters

    cfg = opt.config
    gen = torch.Generator(device=dev).manual_seed(SEED + 13 + rank)
    out = []
    for bk in opt.bucket_plan.buckets:
        if (bk.dsplit if fsdp else bk.split) != "n":
            continue
        d, n = bk.global_dims()
        pool = min(d, cfg.sara_pool_factor * bk.rank)
        _, kp, iters = svd_lib.clamp_sketch(d, n, pool, cfg.svd_oversample, cfg.svd_power_iters)
        if not iters:
            continue
        b = proj_lib.refresh_chunk(bk.batch, d, n, kp)
        g = torch.randn((b, bk.d, bk.n), generator=gen, device=dev)
        q = svd_lib.qr_q(torch.randn((b, bk.d, kp), generator=gen, device=dev))
        before = counters.snapshot()
        got = pi_ops.power_iter_step(g, q)
        launches = _launches_since(before)
        path = path or ("train_fsdp" if fsdp else "train_tp")
        if launches != {"power_iter_batched": 1}:
            raise AssertionError(f"{path} power-iteration case: launches {launches}")
        label = f"B={b} d={bk.d} n={bk.n} (of {n}) k'={kp}"
        err = check_close(f"{path} power_iter {label}", got, power_iter_ref(g, q),
                          *TOL["power_iter_batched"]["float32"], rel_atol=True)
        log(f"{path} rank {rank} power_iter {label}: kernel vs plain max abs err {err}")
        out.append({"case": label, "max_abs_err": err})
        del g, q, got
    return out


def _tp_dense(rank: int, devname: str, mesh, get_shared, cpu_cfg, seq: int, batch: int,
              fsdp: bool = False, opt_kw=None, path=None, optimizer: str = "galore-sara-adam"):
    """The dense run of one process of ``train_tp`` (see the constants), or
    with ``fsdp`` of ``train_fsdp`` (``mesh`` (TP_WORLD, 1)); ``get_shared()``
    returns the single-process run's state after step 1, its params after
    one f32 hot step and its low-rank leaves' params after one f32 refresh
    step from it (it may wait for the parent to make them: the 3 steps run
    first); ``cpu_cfg`` stands for llama3-8b in a CPU rehearsal.
    ``train_tp_families`` and ``train_tp_inners`` run their paths through it
    too (``cpu_cfg`` the model's config, ``optimizer`` with ``opt_kw``,
    ``path`` the path's name).  Bucket-native state takes kernel 4 and the
    inner's update against plain on every local bucket (on ZeRO's rows, the
    split schedule), a SARA refresh kernel 9 on the "n" buckets' blocks, an
    Adam or MSGD hot step its bytes against the shapes' count; per-leaf
    state (the reference engine, Fira, Adafactor) none of those.  8-bit
    Adam's codes after the f32 hot step are held within one step of one
    process's (``shared["hot_state"]``); ZeRO state (``state_sharding=
    "zero"``, FSDP) against the replicated FSDP step from the same state
    and gradients (``DP_ZERO_TOL``), with both states' bytes."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import buckets as buckets_lib
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import (canonical_opt_state, flatten_with_path,
                                          fsdp_hot_comm_bytes, state_memory_bytes,
                                          tp_local_opt_state, tree_leaves, tree_unflatten)
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.models import build_model, tp_hot_comm_bytes
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    on_card = torch.device(devname).type == "cuda"
    path = path or ("train_fsdp" if fsdp else "train_tp")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_now():
        return torch.cuda.max_memory_allocated() if on_card else 0

    cfg = cpu_cfg or get_config("llama3-8b").with_(n_layers=TP_LAYERS)
    model = build_model(cfg, device=devname)
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                global_batch=batch), device=devname)
    if cfg.family in ("vlm", "audio"):
        data = PrefixData(data, cfg, devname)
    batches = [data.batch_at(s) for s in range(TP_STEPS + 1)]
    tc = TrainConfig(total_steps=TP_STEPS, seed=SEED)
    params = model.init(torch.Generator(device=devname).manual_seed(SEED))
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    if opt_kw is None:
        opt_kw = dict(TRAIN_OPT) if on_card else dict(TRAIN_OPT, rank=8, svd_oversample=4)
    zero = opt_kw.get("state_sharding") == "zero"
    rows = mesh.data_axes() if zero else None
    head_tp = cfg.family in ("ssm", "hybrid") and mesh.tp > 1 and ssm_lib.head_parallel(
        cfg, mesh.tp)
    sched = cosine_with_warmup(opt_kw["lr"], TRAIN_WARMUP, TP_STEPS)
    opt = make_optimizer(optimizer, params, lr_schedule=sched, **opt_kw)
    fns = make_train_step(model, opt, mesh=mesh, train_cfg=tc)
    if fns["fsdp"] != fsdp or not fns["tp"]:
        raise AssertionError(f"{path} rank {rank}: the step on {mesh.shape}: fsdp "
                             f"{fns['fsdp']}, blocks {fns['tp']}")
    state = fns["place_state"](TrainState(params, opt.init(params)))
    del params
    state_bytes = state_memory_bytes(state.opt_state)
    lopt = fns["optimizer"]
    native = lopt.state_layout is not None
    plan = ([(bk.d, bk.n, bk.rank, bk.batch, bk.side, bk.split + bk.dsplit)
             for bk in lopt.bucket_plan.buckets] if native else None)
    if on_card:
        torch.cuda.empty_cache()
    ms, losses, comm, per_step, peaks = [], [], [], [], []
    counters.reset()  # the main path's launches: the 3 steps
    for s in range(TP_STEPS):
        mesh_lib.comm_reset()
        before = counters.snapshot()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, batches[s])
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
        peaks.append(peak_now())
        losses.append(float(m["loss"]))
        comm.append(mesh_lib.comm_snapshot())
        per_step.append(_launches_since(before))
        if s == 0:
            # every step-0 gradient finite: their norm over every block is
            grad_norm0 = float(m["grad_norm"])
    launches = counters.snapshot()
    if not all(np.isfinite(losses)) or not np.isfinite(grad_norm0):
        raise AssertionError(f"{path} rank {rank}: losses {losses}, step-0 gradient norm "
                             f"{grad_norm0}")
    expect = _train_expect(cfg, lopt, TP_STEPS, shapes)
    if launches != expect:
        raise AssertionError(f"{path} rank {rank}: launches {launches} != {expect}")
    # the shapes' count covers the hot step of Adam's and MSGD's buckets (no
    # other inner's collectives, no ZeRO rows)
    counted = native and lopt.config.inner in ("adam", "msgd") and not zero
    if fsdp:
        axis, want_bytes = "data", fsdp_hot_comm_bytes(lopt, cfg) if counted else None
        # every parameter leaf cut as param_spec says, over data
        cut = [(p_, tuple(x.shape)) for (p_, x) in flatten_with_path(state.params)]
        for (p_, local), like, (dd, _) in zip(cut, opt.likes, fns["splits"]):
            full = list(like.shape)
            if dd is not None:
                full[dd] //= mesh.dp
            if tuple(full) != local:
                raise AssertionError(f"{path} rank {rank}: {p_} holds {local}, not {full}")
    else:
        act_bytes = torch.empty((), dtype=cfg.dtype).element_size()
        axis, want_bytes = "model", tp_hot_comm_bytes(
            cfg, batch, seq, lopt.bucket_plan, act_bytes, tp=mesh.tp) if counted else None
    got = [sum(v for k, v in c.items() if k.endswith("@" + axis)) for c in comm]
    if counted and any(g != want_bytes for g in got[1:]):
        raise AssertionError(f"{path} rank {rank}: hot-step bytes over {axis} {got[1:]} "
                             f"!= {want_bytes} (the shapes' count)")
    log(f"{path} rank {rank}: {cfg.arch_id} {cfg.n_layers} layers, {optimizer} on "
        f"{mesh.shape}, local plan {plan}; losses {losses}; refresh {ms[0]:.1f} ms, hot "
        f"{[round(x, 1) for x in ms[1:]]} ms; max_memory_allocated per step "
        f"{[round(x / 2**30, 2) for x in peaks]} GiB; state {state_bytes / 2**30:.3f} GiB; "
        f"launches {launches}; hot-step bytes over {axis} {got[1:]} (formula {want_bytes}), "
        f"refresh step {got[0]}")
    # kernel 9 on each "n" bucket's block at the split refresh's shapes
    power = (_tp_power_cases(lopt, devname, rank, fsdp, path)
             if native and lopt.config.method == "sara" else [])
    # from the single-process run's state after step 1, which the parent
    # shares with the processes (CUDA IPC on the card), in f32 compute: one
    # hot step and one refresh step, this process's blocks against the
    # parent's own steps from it, cut to the same blocks.  The parent's two
    # steps take the same state and batch, so the ranks' share one pass:
    # the step's reduced gradients there (which saves passes whose
    # collectives gloo stages through host memory), each local bucket's
    # kernels against plain on them, then each step's update
    del state, fns
    if on_card:
        torch.cuda.empty_cache()
    model32 = build_model(cfg.with_(dtype=torch.float32), device=devname)
    fns32 = make_train_step(model32, opt, mesh=mesh, train_cfg=tc)
    splits, lopt32 = fns32["splits"], fns32["optimizer"]
    shared = get_shared()

    def block(i, x):
        return shd.block_of(x, splits[i], mesh)

    st = fns32["place_state"](TrainState(shared["params"], shared["opt_state"]))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _, _, grads = fns32["grads"](st, batches[TP_STEPS])
    grads, grad_peak = tree_leaves(grads), peak_now()
    parity = (hot_step_parity(path, model32, lopt32, st, None, dev="cuda" if on_card else "cpu",
                              grads=grads, zero_axes=rows) if native else [])
    if on_card:  # each step's peak: its gradients', then its update's
        torch.cuda.reset_peak_memory_stats()
    # on a copy of the gradients: an update may scale its own in place
    mine, mst, _ = lopt32.update(tree_unflatten(st.params, [g.clone() for g in grads]),
                                 st.opt_state, st.params, refresh=False, apply=True,
                                 shard_axes=rows)
    peak32 = {"hot": max(grad_peak, peak_now())}
    mine = tree_leaves(mine)
    noise = [p_ in NOISE_LEAVES for p_, _ in flatten_with_path(shared["params"])]
    want = [block(i, x) for i, x in enumerate(shared["hot"])]
    hot = _blocks_within(f"{path} rank {rank}: the f32 hot step from the single-process state",
                         [x for x, z in zip(mine, noise) if not z],
                         [x for x, z in zip(want, noise) if not z])
    if any(noise):
        hot["noise_leaves"] = _blocks_within(
            f"{path} rank {rank}: the f32 hot step's zero-gradient leaves",
            [x for x, z in zip(mine, noise) if z], [x for x, z in zip(want, noise) if z],
            dict(atol=opt_kw["lr"], share=0.0, cap=opt_kw["lr"]))["max_abs_err"]
    del want
    out = {}
    if "hot_state" in shared:
        if zero:
            mst = mst._replace(buckets=buckets_lib.zero_unpad_states(
                lopt32.state_layout, buckets_lib.zero_gather_states(
                    mst.buckets, rows, lopt32.state_layout)))
        out["codes"] = _codes_within(f"{path} rank {rank}", canonical_opt_state(lopt32, mst),
                                     canonical_opt_state(lopt32, tp_local_opt_state(
                                         lopt32, shared["hot_state"])))
    del mst
    if zero:
        # the replicated FSDP step from the same state and gradients
        ropt = make_optimizer(optimizer, shared["params"], lr_schedule=sched,
                              **{k: v for k, v in opt_kw.items()
                                 if k not in ("state_sharding", "state_shards")})
        rfns = make_train_step(model32, ropt, mesh=mesh, train_cfg=tc)
        rst = rfns["place_state"](TrainState(shared["params"], shared["opt_state"]))
        out.update(zero_state_bytes=state_bytes,
                   replicated_state_bytes=state_memory_bytes(rst.opt_state))
        rep, _, _ = rfns["optimizer"].update(tree_unflatten(rst.params, [g.clone() for g in grads]),
                                            rst.opt_state, rst.params, refresh=False, apply=True)
        out["zero_vs_replicated"] = max(float((a - b).abs().max())
                                        for a, b in zip(mine, tree_leaves(rep)))
        if out["zero_vs_replicated"] > DP_ZERO_TOL:
            raise AssertionError(f"{path} rank {rank}: the ZeRO hot step "
                                 f"{out['zero_vs_replicated']} from the replicated one")
        if not out["zero_state_bytes"] < out["replicated_state_bytes"]:
            raise AssertionError(f"{path} rank {rank}: ZeRO holds {state_bytes} state bytes, "
                                 f"replicated {out['replicated_state_bytes']}")
        del rep, rst, rfns, ropt
    del mine, st, fns32
    ropt = make_train_step(model32, _tp_refresh_optimizer(shared["params"], opt_kw, optimizer),
                           mesh=mesh, train_cfg=tc)
    st = ropt["place_state"](TrainState(shared["params"], shared["opt_state"]))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, _, _ = ropt["optimizer"].update(tree_unflatten(st.params, grads), st.opt_state,
                                         st.params, refresh=True, apply=True, shard_axes=rows)
    peak32["refresh"] = max(grad_peak, peak_now())
    del st, grads, ropt
    mine = tree_leaves(res)
    del res
    want, paths = shared["refreshed"], [p for p, _ in flatten_with_path(shared["params"])]
    low = sorted(want)
    refreshed = _steps_within(
        f"{path} rank {rank}: the f32 refresh step from the single-process state",
        [mine[i] for i in low], [block(i, want[i]) for i in low],
        [block(i, x) for i, x in enumerate(tree_leaves(shared["params"])) if i in low],
        [paths[i] for i in low])
    del mine, shared
    log(f"{path} rank {rank}: from the single-process state in f32, against one process: "
        f"hot step {hot}, refresh step (largest) {max(r['rel'] for r in refreshed)}, {out}; "
        f"max_memory_allocated { {k: round(v / 2**30, 2) for k, v in peak32.items()} } GiB")
    mesh_lib.barrier(mesh)
    if on_card:
        torch.cuda.empty_cache()
    return dict(out, arch=cfg.arch_id, plan=plan, losses=losses, ms=ms,
                max_memory_allocated=max(peaks),
                grad_norm0=grad_norm0, head_tp=head_tp, peaks=peaks, peaks_f32=peak32,
                state_bytes=state_bytes, launches=launches, expected=expect,
                per_step=per_step, hot_bytes=got[1:], refresh_bytes=got[0],
                hot_bytes_formula=want_bytes, parity=parity,
                power_iter_cases=power, hot_from_same_state=hot,
                refresh_from_same_state=refreshed)


def _tp_moe(rank: int, devname: str, mesh, cfg, seq: int, batch: int, opt_kw,
            fsdp: bool = False):
    """The MoE run of one process of ``train_tp`` (see the constants), or
    with ``fsdp`` of ``train_fsdp`` (``mesh`` (TP_WORLD, 1): the local
    path, the expert d_ff over ``data``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import flatten_with_path, tree_leaves, tree_unflatten
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import parallel as par
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    on_card = torch.device(devname).type == "cuda"
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                global_batch=batch), device=devname)

    def loss_and_grads(model, params, axes, batch=None):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with par.use(axes):
            loss, _ = model.loss(tree_unflatten(params, leaves),
                                 data.batch_at(0) if batch is None else batch)
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), tree_unflatten(params, list(grads))

    path = "train_fsdp moe" if fsdp else "train_tp moe"
    # capacity factor 8, f32: the expert-parallel step-0 loss and gradients
    # against one process's local path; under FSDP the step's own reduced
    # gradients and the processes' mean loss against one process's run of
    # the same rows in TP_WORLD microbatches
    model8 = build_model(cfg.with_(moe_capacity_factor=TP_MOE_CAPACITY, dtype=torch.float32),
                         device=devname)
    params = model8.init(torch.Generator(device=devname).manual_seed(SEED))
    moe_lib.reset_ep_drops()
    if fsdp:
        gopt = make_optimizer("galore-sara-adam", params, **dict(TRAIN_OPT, **opt_kw))
        gfns = make_train_step(model8, gopt, mesh=mesh)
        splits = gfns["splits"]
        loss_tp, _, grads_tp = gfns["grads"](TrainState(shd.shard_params(params, mesh, splits),
                                                        None), data.batch_at(0))
        loss_tp = float(mesh.data_axes().all_reduce_scalars(loss_tp.reshape(1))[0]) / mesh.dp
        del gfns, gopt
    else:
        splits = shd.tp_splits(params, mesh)
        loss_tp, grads_tp = loss_and_grads(model8, shd.shard_params(params, mesh, splits),
                                           mesh.model_axes())
    drops8 = moe_lib.ep_drops()
    grads_tp = shd.gather_params(grads_tp, mesh, splits)
    out = {"ep_loss": loss_tp, "drops_cf8": drops8}
    if rank == 0:
        one = mesh_lib.single_device_mesh().model_axes()
        if fsdp:
            # the same rows in microbatches of one process's rows
            rows = batch // mesh.dp
            parts = [loss_and_grads(model8, params, one,
                                    {k: v[i:i + rows] for k, v in data.batch_at(0).items()})
                     for i in range(0, batch, rows)]
            loss_1 = sum(x for x, _ in parts) / len(parts)
            grads_1 = tree_unflatten(params, [sum(gs) / len(parts) for gs in zip(
                *[tree_leaves(g) for _, g in parts])])
            del parts
        else:
            loss_1, grads_1 = loss_and_grads(model8, params, one)
        if abs(loss_1 - loss_tp) > TP_MOE_LOSS_TOL:
            raise AssertionError(f"{path}: loss {loss_tp} against one process's {loss_1}")
        worst = 0.0
        for (leaf, a), b in zip(flatten_with_path(grads_tp), tree_leaves(grads_1)):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            if err > TP_MOE_GRAD_RTOL * scale:
                raise AssertionError(f"{path}: gradient {leaf} {err} apart (largest "
                                     f"|g| {scale})")
            worst = max(worst, err / max(scale, 1e-30))
        out.update(local_loss=loss_1, grad_rel_err=worst)
        del grads_1
    del params, grads_tp, model8
    if on_card:
        torch.cuda.empty_cache()
    # the config's capacity factor, bf16: 3 steps of the train step, with
    # this process's launches counted (path ``train_tp_moe``)
    model = build_model(cfg, device=devname)
    params = model.init(torch.Generator(device=devname).manual_seed(SEED))
    opt = make_optimizer("galore-sara-adam", params, lr_schedule=cosine_with_warmup(
        TRAIN_OPT["lr"], TRAIN_WARMUP, TP_STEPS), **dict(TRAIN_OPT, **opt_kw))
    fns = make_train_step(model, opt, mesh=mesh, train_cfg=TrainConfig(total_steps=TP_STEPS))
    if fns["fsdp"] != fsdp:
        raise AssertionError(f"{path} rank {rank}: the step on {mesh.shape} is FSDP: "
                             f"{fns['fsdp']}")
    state = fns["place_state"](TrainState(params, opt.init(params)))
    del params
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    moe_lib.reset_ep_drops()
    losses, ms = [], []
    counters.reset()
    for s in range(TP_STEPS):
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
    launches = counters.snapshot()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path} rank {rank}: losses {losses}")
    expect = _train_expect(cfg, fns["optimizer"], TP_STEPS)
    if launches != expect:
        raise AssertionError(f"{path} rank {rank}: launches {launches} != {expect}")
    drops = moe_lib.ep_drops()
    out.update(losses=losses, ms=ms, drops=drops, launches=launches, expected=expect,
               max_memory_allocated=torch.cuda.max_memory_allocated() if on_card else 0,
               plan=[(bk.d, bk.n, bk.rank, bk.batch, bk.split + bk.dsplit)
                     for bk in fns["optimizer"].bucket_plan.buckets])
    log(f"{path} rank {rank}: {cfg.arch_id} {cfg.n_layers} layer(s), capacity "
        f"{TP_MOE_CAPACITY}: step-0 loss {loss_tp} (local path {out.get('local_loss')}), "
        f"gradients {out.get('grad_rel_err')} of their largest apart, drops {drops8}; at "
        f"{cfg.moe_capacity_factor}: losses {losses}, {ms} ms, dropped "
        f"{drops['dropped']} of {drops['routed']} pairs, max_memory_allocated "
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB; launches {launches}")
    del state, fns
    return out


def _tp_worker(rank: int, world: int, out_dir: str, dev: str, shared, dense, moe) -> None:
    """One process of ``train_tp``: its summary to ``rank<r>.json``; a failed
    check raises (the process exits non-zero).  ``shared`` as
    ``_tp_dense`` takes it; ``dense`` = (cpu config or None, seq, batch);
    ``moe`` = (cfg, seq, batch, optimizer overrides)."""
    from datetime import timedelta

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib

    if dev == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
        resolve_device("cuda")
        devname = "cuda:0"
    else:
        torch.set_num_threads(1)
        _count_plain_dispatch()
        devname = "cpu"
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", world_size=world,
                            rank=rank, timeout=timedelta(seconds=TP_TIMEOUT_S))
    try:
        mesh = mesh_lib.make_mesh((1, world))
        log(f"train_tp rank {rank}: gloo group up, mesh {mesh.shape} on {devname}")
        out = {"rank": rank, "dense": _tp_dense(rank, devname, mesh, lambda: shared, *dense)}
        out["moe"] = _tp_moe(rank, devname, mesh, *moe)
        # the same processes as FSDP over data (paths train_fsdp, train_fsdp_moe)
        t = time.perf_counter()
        fsdp_mesh = mesh_lib.make_mesh((world, 1))
        out["fsdp"] = _tp_dense(rank, devname, fsdp_mesh, lambda: shared, *dense, fsdp=True)
        out["fsdp_moe"] = _tp_moe(rank, devname, fsdp_mesh, *moe, fsdp=True)
        out["fsdp_s"] = time.perf_counter() - t
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()


def _ipc_tree(x, on_card: bool):
    """A copy of a tree of tensors (dicts, lists, NamedTuples) for CUDA IPC:
    the card's machine lacks the ``pidfd_open`` call that sharing a tensor
    of an expandable segment needs, so on the card the copies go to the
    allocator's fixed segments, and the setting comes back after."""
    def copy(y):
        if torch.is_tensor(y):
            return y.clone()
        if isinstance(y, dict):
            return {k: copy(v) for k, v in y.items()}
        if isinstance(y, list):
            return [copy(v) for v in y]
        if isinstance(y, tuple):
            return type(y)(*map(copy, y)) if hasattr(y, "_fields") else tuple(map(copy, y))
        return y

    expandable = "expandable_segments:True" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    if on_card and expandable:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    try:
        return copy(x)
    finally:
        if on_card and expandable:
            torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def _one_process_ref(cfg, seq: int, batch: int, opt_kw, dev: str, yardstick: bool = False,
                     optimizer: str = "galore-sara-adam", hot_state: bool = False):
    """The single-process run of ``TP_STEPS`` steps of ``cfg``'s model
    (``train_tp``'s, ``train_tp_families``' and ``train_tp_inners``'
    reference) under ``optimizer``, then from its state after step 1 the
    params of one f32 hot step and of one f32 refresh step: (``shared``,
    shared with the ranks by CUDA IPC on the card; the run's losses, ms
    and peaks).  ``hot_state``: ``shared["hot_state"]``, the canonical
    optimizer state after the f32 hot step, too.  ``yardstick``: also one process against
    itself, the same refresh step with its gradient summed in two
    microbatches, read as the ranks' steps are (``_steps_within``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import canonical_opt_state, tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    on_card = torch.device(dev).type == "cuda"
    model = build_model(cfg, device=dev)
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                global_batch=batch), device=dev)
    if cfg.family in ("vlm", "audio"):
        data = PrefixData(data, cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = make_optimizer(optimizer, params, lr_schedule=cosine_with_warmup(
        opt_kw["lr"], TRAIN_WARMUP, TP_STEPS), **opt_kw)
    tc = TrainConfig(total_steps=TP_STEPS, seed=SEED)
    fns = make_train_step(model, opt, train_cfg=tc)
    state = TrainState(params, opt.init(params))
    del params
    ref = {"losses": [], "ms": [], "peaks": []}
    for s in range(TP_STEPS):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, m = (fns["refresh_step"] if s == 0 else fns["step"])(state, data.batch_at(s))
        ref["losses"].append(float(m["loss"]))
        ref["ms"].append((time.perf_counter() - t) * 1e3)
        ref["peaks"].append(torch.cuda.max_memory_allocated() if on_card else 0)
        if s == 1:
            state1 = state
    del state, fns
    # its state after step 1, and the params of one f32 hot step and of one
    # f32 refresh step from it (the low-rank leaves: the refresh changes
    # no other): shared with the processes (CUDA IPC; this process keeps
    # them alive until they are done with them)
    shared = {"params": _ipc_tree(state1.params, on_card),
              "opt_state": _ipc_tree(state1.opt_state, on_card)}
    del state1
    model32 = build_model(cfg.with_(dtype=torch.float32), device=dev)
    st = TrainState(shared["params"], shared["opt_state"])
    one, _ = make_train_step(model32, opt, train_cfg=tc)["step"](st, data.batch_at(TP_STEPS))
    shared["hot"] = _ipc_tree(tree_leaves(one.params), on_card)
    if hot_state:
        shared["hot_state"] = _ipc_tree(canonical_opt_state(opt, one.opt_state), on_card)
    del one
    one, _ = make_train_step(model32, _tp_refresh_optimizer(shared["params"], opt_kw, optimizer),
                             train_cfg=tc)["refresh_step"](st, data.batch_at(TP_STEPS))
    shared["refreshed"] = _ipc_tree({i: x for i, x in enumerate(tree_leaves(one.params))
                                     if opt.specs[i].lowrank}, on_card)
    del one
    ref["self_rel"] = {}
    if yardstick:
        two, _ = make_train_step(model32, _tp_refresh_optimizer(shared["params"], opt_kw),
                                 train_cfg=TrainConfig(total_steps=TP_STEPS, seed=SEED,
                                                       microbatch=batch // 2))["refresh_step"](
            st, data.batch_at(TP_STEPS))
        flat2, flat0 = tree_leaves(two.params), tree_leaves(shared["params"])
        ref["self_rel"] = {i: float(torch.linalg.vector_norm(flat2[i] - x)
                                    / torch.linalg.vector_norm(x - flat0[i]))
                           for i, x in shared["refreshed"].items()}
        del two, flat2, flat0
    del opt, model, model32, st
    if on_card:
        torch.cuda.empty_cache()
    return shared, ref


def _tp_main(out_json: str, dev: str, dense, moe) -> None:
    """The process that ``train_tp`` spawns: the single-process dense run
    and its f32 hot and refresh steps from its state after step 1, then
    ``TP_WORLD`` processes (``_tp_worker``) on the one card, sharing that
    state and those steps' params with them by CUDA IPC; their summaries and its own go to
    ``out_json``.  A process of its own, so that everything it shared is
    freed when it ends (CUDA IPC keeps a producer's shared memory until its
    consumers' references are counted down, which exiting consumers do not
    reliably do).  Fails if a rank fails or outlives ``TP_TIMEOUT_S``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        resolve_device("cuda")
    else:
        torch.set_num_threads(1)
    cfg = dense[0] or get_config("llama3-8b").with_(n_layers=TP_LAYERS)
    seq, batch = dense[1], dense[2]
    opt_kw = dict(TRAIN_OPT) if on_card else dict(TRAIN_OPT, rank=8, svd_oversample=4)
    shared, ref = _one_process_ref(cfg, seq, batch, opt_kw, dev, yardstick=True)
    ref_losses, ref_ms, ref_peaks, self_rel = (ref[k] for k in ("losses", "ms", "peaks",
                                                                 "self_rel"))
    log(f"train_tp: the single-process run, losses {ref_losses}, {ref_ms} ms")
    out_dir = fresh_dir("train_tp")
    out_dir.mkdir()
    try:
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_tp_worker,
                             args=(r, TP_WORLD, str(out_dir), "cuda" if on_card else "cpu",
                                   shared, dense, moe))
                 for r in range(TP_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise AssertionError(f"train_tp processes ended with {codes}"
                                 f"{' (killed at the time limit)' if alive else ''}")
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(TP_WORLD)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    Path(out_json).write_text(json.dumps({"ranks": ranks, "ref_losses": ref_losses,
                                          "ref_ms": ref_ms, "ref_peaks": ref_peaks,
                                          "self_rel": self_rel}, default=str))


def train_tp(smi: str, dev: str = "cuda", dense=None, moe=None):
    """Phases 5c and 5d (paths ``train_tp``, ``train_tp_moe``,
    ``train_fsdp`` and ``train_fsdp_moe``, see the constants): ``_tp_main``
    in a process of its own, then the checks across its ranks.  Returns the
    four paths' runs.  ``dense`` / ``moe`` override the configs for a CPU
    rehearsal."""
    from repro_torch.configs.registry import get_config

    dense = dense or (None, TRAIN_SEQ, TRAIN_BATCH)
    if moe is None:
        arch, _, mseq, mbatch, mrank, _ = FAMILY_TRAIN_RUNS["train_moe"]
        moe = (cut_depth(get_config(arch), TP_MOE_LAYERS), mseq, mbatch, dict(rank=mrank))
    out_json = fresh_dir("train_tp_main.json")
    proc = torch.multiprocessing.get_context("spawn").Process(
        target=_tp_main, args=(str(out_json), dev, dense, moe))
    proc.start()
    proc.join(TP_TIMEOUT_S + 120)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise AssertionError("train_tp: the phase's process was killed at its time limit")
    if proc.exitcode:
        raise AssertionError(f"train_tp: the phase's process ended with {proc.exitcode}")
    got = json.loads(out_json.read_text())
    out_json.unlink()
    ranks, ref_losses, ref_ms = got["ranks"], got["ref_losses"], got["ref_ms"]
    self_rel = sorted(got["self_rel"].values())
    gaps, fsdp_gaps = ([abs(a - b) for a, b in zip(ranks[0][k]["losses"], ref_losses)]
                       for k in ("dense", "fsdp"))
    for k, g in (("dense", gaps), ("fsdp", fsdp_gaps)):
        if max(g) > TP_LOSS_GAP:
            raise AssertionError(f"train_tp {k}: losses {ranks[0][k]['losses']} against the "
                                 f"single-process {ref_losses}: gaps {g} > {TP_LOSS_GAP}")
    for r in ranks[1:]:
        if r["dense"]["losses"] != ranks[0]["dense"]["losses"]:
            raise AssertionError(f"train_tp: the processes' losses differ {r['dense']['losses']}")
    for k in ("fsdp", "fsdp_moe"):
        # each process's loss is its own rows' (the metrics are averaged in
        # the step): the same numbers on every process
        if any(r[k]["losses"] != ranks[0][k]["losses"] for r in ranks[1:]):
            raise AssertionError(f"train_fsdp: the processes' {k} losses differ "
                                 f"{[r[k]['losses'] for r in ranks]}")
    if sum(r["moe"]["drops_cf8"]["dropped"] for r in ranks):
        raise AssertionError(f"train_tp moe: pairs dropped at capacity {TP_MOE_CAPACITY}: "
                             f"{[r['moe']['drops_cf8'] for r in ranks]}")
    routed = sum(r["moe"]["drops"]["routed"] for r in ranks)
    dropped = sum(r["moe"]["drops"]["dropped"] for r in ranks)
    head = ranks[0]
    log(f"train_tp ({smi}; {TP_WORLD} processes sharing one card, so the times are not a "
        f"tensor-parallel speed): loss gaps {gaps} against the single-process run "
        f"({ref_losses}); f32 from one state, per process: hot step "
        f"{[r['dense']['hot_from_same_state'] for r in ranks]}, refresh step "
        f"{[r['dense']['refresh_from_same_state'] for r in ranks]} (one process against "
        f"itself, its gradient in two microbatches: {self_rel}); per process "
        f"max_memory_allocated "
        f"{[round(r['dense']['max_memory_allocated'] / 2**30, 2) for r in ranks]} GiB, hot "
        f"step ms {[r['dense']['ms'][1:] for r in ranks]}; moe dropped share at "
        f"{moe[0].moe_capacity_factor}: {dropped / max(routed, 1):.4f} ({dropped} of {routed}), "
        f"launches per process {[r['moe']['launches'] for r in ranks]}")
    ref_peaks = got["ref_peaks"]
    gib = lambda x: round(x / 2**30, 2)  # noqa: E731
    log(f"train_fsdp ({smi}; {TP_WORLD} processes sharing one card over gloo, so the times "
        f"are not an FSDP speed): {head['fsdp_s']:.1f} s; loss gaps {fsdp_gaps} against the "
        f"single-process run; f32 from one state, per process: hot step "
        f"{[r['fsdp']['hot_from_same_state'] for r in ranks]}, refresh step "
        f"{[r['fsdp']['refresh_from_same_state'] for r in ranks]}; max_memory_allocated per "
        f"step (refresh, hot, hot), per process "
        f"{[[gib(x) for x in r['fsdp']['peaks']] for r in ranks]} GiB against the "
        f"single-process run's {[gib(x) for x in ref_peaks]} GiB; f32 from one state "
        f"{[{k: gib(v) for k, v in r['fsdp']['peaks_f32'].items()} for r in ranks]} GiB; "
        f"hot-step bytes over data {head['fsdp']['hot_bytes']} (formula "
        f"{head['fsdp']['hot_bytes_formula']}); moe step-0 loss {head['fsdp_moe']['ep_loss']} "
        f"(one process in microbatches {head['fsdp_moe'].get('local_loss')}), gradients "
        f"{head['fsdp_moe'].get('grad_rel_err')} of their largest apart; moe losses "
        f"{head['fsdp_moe']['losses']}, launches per process "
        f"{[r['fsdp_moe']['launches'] for r in ranks]}")
    dense_run = {"launches": head["dense"]["launches"], "ranks": ranks, "ref_losses": ref_losses,
                 "ref_ms": ref_ms, "loss_gaps": gaps, "refresh_self_rel": self_rel, "card": smi}
    moe_run = {"launches": head["moe"]["launches"], "moe_drop_share": dropped / max(routed, 1),
               "card": smi}
    fsdp_run = {"launches": head["fsdp"]["launches"], "loss_gaps": fsdp_gaps,
                "ref_peaks": ref_peaks, "seconds": head["fsdp_s"], "card": smi}
    fsdp_moe_run = {"launches": head["fsdp_moe"]["launches"], "card": smi}
    return dense_run, moe_run, fsdp_run, fsdp_moe_run


# Phase 5e, paths ``train_tp_{ssm,ssm_whole,hybrid,audio,vlm}`` and
# ``train_fsdp_{ssm,hybrid,audio,vlm}``: the SSM, hybrid, enc-dec and VLM
# families tensor parallel at (1, TP_WORLD) and FSDP at (TP_WORLD, 1), two
# processes sharing the card over gloo as ``train_tp``'s, each model at
# full width and ``TPF_LAYERS`` layer(s) (whisper 1 + 1), ``TRAIN_OPT``'s
# galore-sara-adam at its ``FAMILY_TRAIN_RUNS`` rank, seq and batch, 3
# steps.  mamba2-370m and hymba-1.5b with ``ssm_head_tp``: 16 and 25 SSD
# heads a process (hymba's 25 attention heads do not divide 2: its
# attention runs gathered and replicated); ``ssm_whole`` is mamba2 as the
# registry configures it (``ssm_head_tp`` off), whose mixer runs whole
# from the gathered ``in_proj`` with ``out_proj`` row-parallel, at TP only
# (at a ``model`` extent of 1 its FSDP path is ``ssm``'s).  Each path runs ``_tp_dense``'s
# checks against one process's run from the same state (``_one_process_ref``,
# made in the phase's process first): the f32 hot step within
# ``DP_HOT_TOL``, the f32 refresh step under ``TP_REFRESH_CARRY`` within
# ``TP_REFRESH_REL`` per block, the step-0 gradients finite (their norm over
# every block), exact launches per rank, the hot step's bytes over
# ``model`` or ``data`` equal to ``tp_hot_comm_bytes`` /
# ``fsdp_hot_comm_bytes``, kernels 4 and 5 against plain on every local
# bucket and kernel 9 on the "n" buckets' column blocks, and the peak
# memory a process beside one process's.  The processes are spawned once
# and take the families in turn (the smallest first) through queues; the
# next family's one-process reference is made while they run a family
# (its step times then share the card with theirs), and each family's
# shared state is freed once they are done with it.
TPF_LAYERS = 1
# family: (its single-card path, config overrides, meshes)
TPF_RUNS = {"ssm": ("train_ssm", dict(ssm_head_tp=True), ("tp", "fsdp")),
            "ssm_whole": ("train_ssm", {}, ("tp",)),
            "hybrid": ("train_hybrid", dict(ssm_head_tp=True), ("tp", "fsdp")),
            "audio": ("train_audio", {}, ("tp", "fsdp")),
            "vlm": ("train_vlm", {}, ("tp", "fsdp"))}
for _fam, (_path, _, _kinds) in TPF_RUNS.items():
    # the SSM's paths launch no flash kernel; kernel 9 where a sketch does
    # not span a leaf's narrow side (counted exactly by power_iter_calls)
    for _kind in _kinds:
        PATH_KERNELS[f"train_{_kind}_{_fam}"] = tuple(
            k for k in PATH_KERNELS[_path] if k != "power_iter_batched")


def tpf_run(fam: str):
    """(config, seq, batch, optimizer overrides) of a family of
    ``train_tp_families`` at full width."""
    from repro_torch.configs.registry import get_config

    path, extra, _ = TPF_RUNS[fam]
    arch, _, seq, batch, rank, _ = FAMILY_TRAIN_RUNS[path]
    return cut_depth(get_config(arch), TPF_LAYERS).with_(**extra), seq, batch, dict(rank=rank)


def _world_worker(rank: int, world: int, out_dir: str, dev: str, run_ranks, inbox,
                  outbox) -> None:
    """One of the ``TP_WORLD`` processes of a two-rank phase
    (``_world_main``): a gloo group, the meshes (1, world) ("tp") and (world,
    1) ("fsdp") on it, then for each (label, spec) from ``inbox`` until None,
    ``run_ranks(rank, devname, meshes, get_shared, label, spec)`` ({path:
    summary}) to ``outbox``, or the failure (then it exits).  The item's
    shared state follows it on ``inbox`` once the parent has made it:
    ``get_shared()`` waits for it."""
    from datetime import timedelta

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib

    if dev == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
        resolve_device("cuda")
        devname = "cuda:0"
    else:
        torch.set_num_threads(1)
        _count_plain_dispatch()
        devname = "cpu"
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", world_size=world,
                            rank=rank, timeout=timedelta(seconds=TP_TIMEOUT_S))
    try:
        meshes = {"tp": mesh_lib.make_mesh((1, world)), "fsdp": mesh_lib.make_mesh((world, 1))}
        while True:
            item = inbox.get()
            if item is None:
                break
            label, spec = item
            held = []

            def get_shared():
                if not held:
                    held.append(inbox.get())
                return held[0]

            try:
                out = run_ranks(rank, devname, meshes, get_shared, label, spec)
                get_shared()  # taken off the inbox where the run did not need it
            except BaseException as e:
                outbox.put((rank, label, None, f"{type(e).__name__}: {e}"))
                raise
            finally:
                del held, item
                if dev == "cuda":
                    torch.cuda.empty_cache()
            outbox.put((rank, label, json.dumps(out, default=str), None))
    finally:
        dist.destroy_process_group()


def _world_main(out_json: str, dev: str, phase: str, run_ranks, reference, items) -> None:
    """The process that ``run_world`` spawns: ``TP_WORLD`` processes
    (``_world_worker``), then for each (label, spec) of ``items`` the ranks
    get the item, this process makes its single-process reference
    (``reference(label, spec, dev)`` -> (shared, ref)) and hands them the
    shared state (CUDA IPC on the card), and while they finish it, the
    next item's; their summaries and the references go to ``out_json``.  A
    process of its own, so that everything it shared is freed when it ends
    (CUDA IPC keeps a producer's shared memory until its consumers'
    references are counted down, which exiting consumers do not reliably
    do).  Fails if a rank fails or an item outlives ``TP_TIMEOUT_S``."""
    import queue

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        resolve_device("cuda")
    else:
        torch.set_num_threads(1)
        _count_plain_dispatch()  # a reference may count its launches
    out_dir = fresh_dir(phase)
    out_dir.mkdir()
    ctx = torch.multiprocessing.get_context("spawn")
    inboxes, outbox = [ctx.Queue() for _ in range(TP_WORLD)], ctx.Queue()
    procs = [ctx.Process(target=_world_worker,
                         args=(r, TP_WORLD, str(out_dir), "cuda" if on_card else "cpu", run_ranks,
                               inboxes[r], outbox))
             for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    got = {}

    def start(label, spec):
        for box in inboxes:
            box.put((label, spec))
        t = time.perf_counter()
        shared, ref = reference(label, spec, dev)
        ref["seconds"] = time.perf_counter() - t
        log(f"{phase} {label}: the single-process run, losses {ref['losses']}, "
            f"{ref['seconds']:.1f} s")
        for box in inboxes:
            box.put(shared)
        return shared, ref

    try:
        nxt = start(*items[0])
        for i, (label, _) in enumerate(items):
            shared, ref = nxt
            # the next item's reference while the ranks finish this one
            nxt = start(*items[i + 1]) if i + 1 < len(items) else None
            ranks = {}
            deadline = time.monotonic() + TP_TIMEOUT_S
            while len(ranks) < TP_WORLD:
                try:
                    r, f, summary, err = outbox.get(timeout=5.0)
                except queue.Empty:
                    if time.monotonic() > deadline or not all(p.is_alive() for p in procs):
                        raise AssertionError(
                            f"{phase} {label}: ranks ended with "
                            f"{[p.exitcode for p in procs]} or outlived {TP_TIMEOUT_S} s")
                    continue
                if err is not None:
                    raise AssertionError(f"{phase} {f} rank {r}: {err}")
                ranks[r] = json.loads(summary)
            del shared
            if on_card:
                torch.cuda.empty_cache()
            got[label] = {"ref": ref, "ranks": [ranks[r] for r in range(TP_WORLD)]}
        for box in inboxes:
            box.put(None)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
    Path(out_json).write_text(json.dumps(got, default=str))


def run_world(phase: str, run_ranks, reference, items, dev: str = "cuda"):
    """A two-rank phase (``train_tp_families``, ``train_tp_inners``):
    ``_world_main`` in a process of its own, then the checks every path
    takes -- each path's losses within ``TP_LOSS_GAP`` of its item's
    single-process run, and the same on every rank.  Returns {path: (its
    item's reference, [each rank's summary], loss gaps)}."""
    out_json = fresh_dir(f"{phase}.json")
    proc = torch.multiprocessing.get_context("spawn").Process(
        target=_world_main, args=(str(out_json), dev, phase, run_ranks, reference, items))
    proc.start()
    proc.join(len(items) * TP_TIMEOUT_S + 120)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise AssertionError(f"{phase}: the phase's process was killed at its limit")
    if proc.exitcode:
        raise AssertionError(f"{phase}: the phase's process ended with {proc.exitcode}")
    got = json.loads(out_json.read_text())
    out_json.unlink()
    out = {}
    for res in got.values():
        ref = res["ref"]
        for path in res["ranks"][0]:
            ranks = [r[path] for r in res["ranks"]]
            gaps = [abs(a - b) for a, b in zip(ranks[0]["losses"], ref["losses"])]
            if max(gaps) > TP_LOSS_GAP:
                raise AssertionError(f"{path}: losses {ranks[0]['losses']} against the "
                                     f"single-process {ref['losses']}: gaps {gaps}")
            if any(r["losses"] != ranks[0]["losses"] for r in ranks[1:]):
                raise AssertionError(f"{path}: the processes' losses differ "
                                     f"{[r['losses'] for r in ranks]}")
            out[path] = (ref, ranks, gaps)
    return out


def _tpf_opt_kw(extra: dict, on_card: bool) -> dict:
    """A family's optimizer keywords (the CPU rehearsal's rank 8)."""
    return dict(TRAIN_OPT, **extra) if on_card else dict(TRAIN_OPT, rank=8, svd_oversample=4)


def _tpf_ranks(rank: int, devname: str, meshes, get_shared, fam: str, run) -> dict:
    """One process's run of a family of ``train_tp_families`` (``run_world``'s
    ``run_ranks``): its paths on their meshes through ``_tp_dense``.  The
    shared state is awaited first, so that a family's single-process run
    (llava's peaks at ~43 GiB) never shares the card with its ranks' steps
    (~21 GiB each)."""
    cfg, seq, batch, extra = run
    opt_kw = _tpf_opt_kw(extra, torch.device(devname).type == "cuda")
    shared = get_shared()
    out = {}
    for kind in TPF_RUNS[fam][2]:
        path = f"train_{kind}_{fam}"
        t = time.perf_counter()
        out[path] = _tp_dense(rank, devname, meshes[kind], lambda: shared, cfg, seq, batch,
                              fsdp=kind == "fsdp", opt_kw=opt_kw, path=path)
        out[path]["seconds"] = time.perf_counter() - t
    return out


def _tpf_reference(fam: str, run, dev: str):
    """A family's single-process reference (``run_world``'s ``reference``)."""
    cfg, seq, batch, extra = run
    return _one_process_ref(cfg, seq, batch, _tpf_opt_kw(extra, torch.device(dev).type == "cuda"),
                            dev)


def train_tp_families(smi: str, dev: str = "cuda", runs=None):
    """Phase 5e (paths ``train_tp_<family>`` and ``train_fsdp_<family>``, see
    the constants) through ``run_world``.  Returns {path: run}.  ``runs``
    overrides the families' (config, seq, batch, optimizer overrides) for a
    CPU rehearsal (its keys those of ``TPF_RUNS``, whose meshes they
    take)."""
    runs = runs or {fam: tpf_run(fam) for fam in TPF_RUNS}
    got = run_world("train_tp_families", _tpf_ranks, _tpf_reference, list(runs.items()), dev)
    gib = lambda x: round(x / 2**30, 2)  # noqa: E731
    out = {}
    for path, (ref, ranks, gaps) in got.items():
        head = ranks[0]
        log(f"{path} ({smi}; {TP_WORLD} processes sharing one card over gloo, so the "
            f"times are not a parallel speed): {head['arch']}, {head['seconds']:.1f} "
            f"s; loss gaps {gaps}; step ms per rank {[r['ms'] for r in ranks]} "
            f"against one process's {ref['ms']}; hot-step bytes {head['hot_bytes']} "
            f"(formula {head['hot_bytes_formula']}); max_memory_allocated per step per "
            f"rank {[[gib(x) for x in r['peaks']] for r in ranks]} GiB against one "
            f"process's {[gib(x) for x in ref['peaks']]}; f32 from one state: hot "
            f"{[r['hot_from_same_state'] for r in ranks]}, refresh (largest) "
            f"{[max(b['rel'] for b in r['refresh_from_same_state']) for r in ranks]}")
        out[path] = {"launches": head["launches"], "loss_gaps": gaps, "card": smi,
                     "seconds": head["seconds"], "ref_ms": ref["ms"],
                     "ref_peaks": ref["peaks"], "ref_seconds": ref["seconds"],
                     "ranks": ranks}
    return out

# Phase 5f, ``train_tp_inners``: every optimizer under tensor parallelism
# and ZeRO state on the FSDP step, on qwen2-1.5b at full width (d_model
# 1536, 12 heads over 2 KV heads of 128, d_ff 8960, vocab 151936) cut to
# TPI_LAYERS, seq 512, batch 8, rank 384 (the launcher's default at this
# width), bf16 compute.  Its d_ff's blocks of 4480 at a model extent of 2
# end 128 columns into 8-bit chunk 17 (llama3-8b's 7168 = 28 * 256 cut
# none), its 2 KV heads leave one to a process, and at 1 layer it holds
# ~0.5 B params.  Two processes share the card over gloo, one world for
# every path: on the (1, 2) mesh the eight optimizers of ``TPI_RUNS``'
# "tp" paths (each 3 steps, then from the single-process state after step
# 1 one f32 gradient pass, an f32 hot step and an f32 refresh step under
# ``TP_REFRESH_CARRY``, as ``_tp_dense``) and ``train_tp_loop`` (the loop
# under a rank schedule 384 -> 192 with the spectrum logger and
# ``track_subspace``, f32, one re-bucket); on the (2, 1) mesh the "fsdp"
# paths with ZeRO state over data, each also held against the replicated
# FSDP step from the same state (``DP_ZERO_TOL``) with both steps' state
# bytes per process.  The process that spawns the world makes each path's
# single-process reference while the ranks run the one before.
TPI_ARCH = "qwen2-1.5b"
TPI_LAYERS = 1
TPI_RANK = 384
TPI_ZERO = dict(state_sharding="zero", state_shards=TP_WORLD)
# path: (optimizer, TRAIN_OPT overrides, mesh kind)
TPI_RUNS = {
    "train_tp_adam_mini": ("galore-sara-adam-mini", {}, "tp"),
    "train_tp_adam8bit": ("galore-sara-adam8bit", {}, "tp"),
    "train_tp_golore": ("golore-adam", {}, "tp"),
    "train_tp_grass": ("grass-adam", {}, "tp"),
    "train_tp_online_pca": ("online-pca-adam", {}, "tp"),
    "train_tp_fira": ("fira-sara-adam", {}, "tp"),
    "train_tp_adafactor": ("galore-sara-adafactor", {}, "tp"),
    "train_tp_adam_reference": ("galore-sara-adam", {"engine": "reference"}, "tp"),
    "train_fsdp_zero": ("galore-sara-adam", TPI_ZERO, "fsdp"),
    "train_fsdp_zero_adam8bit": ("galore-sara-adam8bit", TPI_ZERO, "fsdp"),
}
TPI_LOOP = "train_tp_loop"
TPI_SCHEDULE = f"step:{TPI_RANK}:{TPI_RANK // 2}@0.5"
TPI_LOOP_STEPS = 5  # refreshes at 0, 2 (then the re-bucket) and 4, at tau 2
# the loop's spectrum records against one process's (f32 both), and its
# overlaps: SARA picks among the small singular vectors, which the card's
# f32 SVD moves with the rounding of its input, and one of the r sampled
# columns picked apart moves an overlap ||P1^T P2||^2 / r by up to 2 / r
# (1e-3 relative failed: 4.4e-4, 5.2e-4 and 5.5e-4 apart in three runs on
# an H100, NVIDIA H100 80GB HBM3 at 700 W, none a column apart)
TPI_RECORD_RTOL = 1e-3
TPI_OVERLAP_ATOL = 2.0 / (TPI_RANK // 2)
for _path, (_name, _kw, _) in TPI_RUNS.items():
    _inner = next(i for i in ("adam8bit", "adam-mini", "adafactor") if i in _name) \
        if any(i in _name for i in ("adam8bit", "adam-mini", "adafactor")) else "adam"
    _leaf = _kw.get("engine") == "reference" or "fira" in _name or _inner == "adafactor"
    PATH_KERNELS[_path] = _MODEL_KERNELS + (() if _leaf else (
        "galore_project_batched", UPDATE_KERNEL[_inner.replace("-", "_")])) + (
        ("power_iter_batched",) if "online-pca" in _name else ())
PATH_KERNELS[TPI_LOOP] = _TRAIN_COMMON + (UPDATE_KERNEL["adam"],)


def tpi_cfg():
    from repro_torch.configs.registry import get_config

    return cut_depth(get_config(TPI_ARCH), TPI_LAYERS)


def _tpi_opt_kw(path: str, on_card: bool) -> dict:
    """A path's optimizer keywords (the CPU rehearsal's rank 8)."""
    extra = TPI_RUNS[path][1] if path in TPI_RUNS else {}
    return dict(TRAIN_OPT, rank=TPI_RANK if on_card else 8, **extra,
                **({} if on_card else dict(svd_oversample=4)))


def _tpi_loop(rank: int, devname: str, mesh, cfg, seq: int, batch: int):
    """``train_loop`` of ``galore-sara-adam`` under ``TPI_SCHEDULE`` with
    the spectrum logger and ``track_subspace`` (f32), on ``mesh`` (one
    process where None): losses, the history's events, the tracker's
    summary, the ranks, and the launches of each geometry (the counters
    snapshotted in the re-bucket)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import make_optimizer
    from repro_torch.core.lowrank import tree_leaves
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.synthetic import SyntheticDataConfig, SyntheticDataset
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import make_train_step

    on_card = torch.device(devname).type == "cuda"
    cfg32 = cfg.with_(dtype=torch.float32)
    model = build_model(cfg32, device=devname)
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                global_batch=batch), device=devname)
    ck = fresh_dir(f"train_tp_loop_{rank if mesh is not None else 'one'}")
    tc = TrainConfig(total_steps=TPI_LOOP_STEPS, seed=SEED, checkpoint_every=0,
                     checkpoint_dir=str(ck), log_spectrum=True)
    params = model.init(torch.Generator(device=devname).manual_seed(SEED))
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    kw = dict(_tpi_opt_kw(TPI_LOOP, on_card), tau=2,
              rank_schedule=TPI_SCHEDULE if on_card else "step:16:8@0.5")
    if not on_card:
        kw["rank"] = 16
    opt = make_optimizer("galore-sara-adam", params, lr_schedule=cosine_with_warmup(
        kw["lr"], TRAIN_WARMUP, TPI_LOOP_STEPS), **kw)
    del params
    fns = make_train_step(model, opt, mesh=mesh, train_cfg=tc)
    geometries = []  # (local optimizer, launches before the re-bucket)

    def hooked(f):
        def rebuild(new_opt):
            geometries.append((f["optimizer"], counters.snapshot()))
            counters.reset()
            return hooked(f["rebuild"](new_opt))
        return dict(f, rebuild=rebuild)

    counters.reset()
    t = time.perf_counter()
    res = train_loop(model, opt, data, tc, hooked(fns), log_every=1, handle_signals=False,
                     track_subspace=True)
    seconds = time.perf_counter() - t
    geometries.append((make_train_step(model, res.optimizer, mesh=mesh)["optimizer"],
                       counters.snapshot()))
    shutil.rmtree(ck, ignore_errors=True)
    if len(geometries) != 2:
        raise AssertionError(f"{TPI_LOOP}: {len(geometries) - 1} re-buckets, not one")
    # steps 0-2 at the first rank (refreshes 0 and 2), 3-4 at the second
    # (the refresh at 4)
    (o1, l1), (o2, l2) = geometries
    want = [_train_expect(cfg, o1, 3, shapes, refreshes=2), _train_expect(cfg, o2, 2, shapes)]
    if [l1, l2] != want:
        raise AssertionError(f"{TPI_LOOP} rank {rank}: launches per geometry {[l1, l2]} != "
                             f"{want}")
    launches = {k: l1.get(k, 0) + l2.get(k, 0) for k in set(l1) | set(l2)}
    events = [{k: v for k, v in r.items() if k != "path"} for r in res.history if "event" in r]
    return {"losses": res.losses, "events": events, "subspace": res.subspace.summary(),
            "ranks": [o1.config.rank, o2.config.rank], "launches": launches,
            "launches_by_geometry": [l1, l2], "seconds": seconds,
            "peak": torch.cuda.max_memory_allocated() if on_card else 0}


def _tpi_ranks(rank: int, devname: str, meshes, get_shared, path: str, run) -> dict:
    """One process's run of a path of ``train_tp_inners`` (``run_world``'s
    ``run_ranks``): the loop, or ``_tp_dense`` with the path's optimizer,
    whose steps run while the parent makes the reference."""
    cfg, seq, batch = run
    t = time.perf_counter()
    if path == TPI_LOOP:
        out = _tpi_loop(rank, devname, meshes["tp"], cfg, seq, batch)
    else:
        name, _, kind = TPI_RUNS[path]
        out = _tp_dense(rank, devname, meshes[kind], get_shared, cfg, seq, batch,
                        fsdp=kind == "fsdp", path=path, optimizer=name,
                        opt_kw=_tpi_opt_kw(path, torch.device(devname).type == "cuda"))
    out["seconds"] = time.perf_counter() - t
    return {path: out}


def _tpi_reference(path: str, run, dev: str):
    """A path's single-process reference (``run_world``'s ``reference``):
    the loop on one process (nothing shared), or ``_one_process_ref`` with
    the path's optimizer (replicated state; 8-bit Adam's state after the
    f32 hot step too)."""
    cfg, seq, batch = run
    if path == TPI_LOOP:
        return None, _tpi_loop(0, dev, None, cfg, seq, batch)
    name = TPI_RUNS[path][0]
    opt_kw = {k: v for k, v in _tpi_opt_kw(path, torch.device(dev).type == "cuda").items()
              if k not in TPI_ZERO}
    return _one_process_ref(cfg, seq, batch, opt_kw, dev, optimizer=name,
                            hot_state="adam8bit" in name)


def _tpi_records_close(what: str, got, want, atol: float = 0.0) -> None:
    """The loop's records (numbers, nested) within ``TPI_RECORD_RTOL`` of
    one process's, or ``atol``, everything else equal."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _tpi_records_close(f"{what}.{k}", got[k], want[k], atol)
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} records, one process {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _tpi_records_close(f"{what}[{i}]", a, b, atol)
    elif isinstance(want, float):
        if not abs(got - want) <= max(TPI_RECORD_RTOL * max(abs(want), 1e-6), atol):
            raise AssertionError(f"{what}: {got} against one process's {want}")
    elif got != want:
        raise AssertionError(f"{what}: {got} != {want}")


def train_tp_inners(smi: str, dev: str = "cuda", run=None):
    """Phase 5f (paths of ``TPI_RUNS`` and ``TPI_LOOP``, see the constants)
    through ``run_world``, then the loop's records against one process's.
    Returns {path: run}.  ``run`` = (config, seq, batch) overrides
    qwen2-1.5b's for a CPU rehearsal."""
    run = run or (tpi_cfg(), TRAIN_SEQ, TRAIN_BATCH)
    got = run_world("train_tp_inners", _tpi_ranks, _tpi_reference,
                    [(path, run) for path in list(TPI_RUNS) + [TPI_LOOP]], dev)
    gib = lambda x: round(x / 2**30, 3)  # noqa: E731
    out = {}
    for path, (ref, ranks, gaps) in got.items():
        head = ranks[0]
        if path == TPI_LOOP:
            for r in ranks:
                if r["ranks"] != ref["ranks"]:
                    raise AssertionError(f"{path}: rank trajectory {r['ranks']} != {ref['ranks']}")
                _tpi_records_close(f"{path} events", r["events"], ref["events"])
                _tpi_records_close(f"{path} subspace", r["subspace"], ref["subspace"],
                                   TPI_OVERLAP_ATOL)
            log(f"{path} ({smi}): {head['seconds']:.1f} s; loss gaps {gaps}; ranks "
                f"{head['ranks']}; events {head['events']}; subspace {head['subspace']} against "
                f"one process's {ref['subspace']}; max_memory_allocated per rank "
                f"{[gib(r['peak']) for r in ranks]} GiB against one process's "
                f"{gib(ref['peak'])}")
        else:
            log(f"{path} ({smi}; {TP_WORLD} processes sharing one card over gloo): "
                f"{head['seconds']:.1f} s; loss gaps {gaps}; step ms per rank "
                f"{[r['ms'] for r in ranks]} against one process's {ref['ms']}; "
                f"max_memory_allocated per step per rank {[[gib(x) for x in r['peaks']] for r in ranks]} "
                f"GiB against one process's {[gib(x) for x in ref['peaks']]}; state bytes per "
                f"rank {[r['state_bytes'] for r in ranks]}"
                + (f" (ZeRO) against the replicated FSDP step's "
                   f"{[r['replicated_state_bytes'] for r in ranks]}"
                   if "replicated_state_bytes" in head else "")
                + (f"; 8-bit codes {[r['codes'] for r in ranks]}" if "codes" in head else ""))
        out[path] = {"launches": head["launches"], "loss_gaps": gaps, "card": smi,
                     "seconds": head["seconds"], "ref": ref, "ranks": ranks}
    return out



# Phase 5g, ``train_fault_world``: the multi-process fault harness of
# ``tests/test_torch_multihost.py`` on the card.  Two processes sharing it
# over gloo (as ``train_tp``'s) train LLaMA-60M at full width (the
# ``llama-60m`` preset: 8 layers, d_model 512, vocab 32100; bf16 compute,
# as ``tables``) at seq 256, global batch 32, ``galore-sara-adam`` at rank
# 128, tau 4, on the compressed "flat" step with ZeRO state over ``data``
# (mesh (2, 1), 2 shards) and shard-parallel checkpoints every 4 steps, 12
# steps (16 in the CPU test and in JAX's: the last refresh and its hot
# steps, which no fault touches, paid for the phase's time).  Phase 1: a
# straggler at step 5, one corrupt shard in the step-8 save (save ordinal
# 2), and rank 1 killed at step 9 (``ProcessKilled``): rank 0 must fail in
# its next collective, naming step 9, within ``FW_EXIT_BAR_S`` of rank 1's
# end; checkpoint 8 fails verification, checkpoint 4 passes.  Phase 2: the
# same world again resumes at step 4 past the corrupt step 8, NaN
# gradients at steps 9-11 in rank 1's share make both skip (the summed
# verdict) and roll back once, in lockstep, to the step-8 checkpoint it
# wrote again; the run ends at 12 in the shard-parallel format.  Phase 3,
# in this process at world 1: step 12 loaded at 1 shard equals rank 0's
# replicated save of its gathered state bit for bit, and one compressed
# step on the (1, 1) mesh has a finite loss.  Each rank's launches are exact per step call
# (a skipped hot step projects and updates nothing after; a skipped
# refresh runs none of the optimizer's kernels).  At rank 128 SARA's pool
# sketch (4 r = 512) spans d 512, so kernel 9 launches 0 times, as in
# ``tables``.  Both worlds' processes start during the phase before
# (``fw_prestart``: their imports, CUDA start-up, model and a warm-up
# forward, backward and factorization, ~25 s, off this phase's time) and
# wait: phase 1's until the phase begins, phase 2's until phase 1 ended.
FW_WORLD = 2
FW_PRESET = "llama-60m"
FW_STEPS, FW_EVERY = 12, 4
FW_NAN_STEPS = (9, 10, 11)
FW_OPT = dict(tau=4, lr=1e-3, alpha=0.25, engine="bucketed", svd_backend="randomized")
FW_KILLED = FW_NAN_RANK = 1
FW_SLOW_S = 0.3
FW_FIRED = [("slow_step", 5), ("ckpt_corrupt_shard", 2), ("kill_process", 9)]
FW_GROUP_TIMEOUT_S = 60
FW_TIMEOUT_S = 300  # a world past this has failed (its processes are killed)
FW_WAIT_S = 900  # a process waiting this long for its world gives up
FW_EXIT_BAR_S = 20.0
PATH_KERNELS["train_fault_world"] = _MODEL_KERNELS + ("galore_project_batched",
                                                     UPDATE_KERNEL["adam"])
PATH_NEVER["train_fault_world"] = ("power_iter_batched",)


def fw_setup(devname: str, preset=None, cfg_kw=None):
    """(cfg, model, data, opt, its keywords) of the fault world at
    ``FW_PRESET``'s widths and rank (``preset`` / ``cfg_kw`` override them
    for a CPU rehearsal)."""
    from repro_torch.benchmarks import common
    from repro_torch.core import make_optimizer
    from repro_torch.examples.pretrain_lm import PRESETS

    p = dict(PRESETS[FW_PRESET], **(preset or {}))
    cfg, model = common.bench_model(
        d_model=p["d_model"], n_layers=p["n_layers"], device=devname,
        **dict(dict(vocab=p["vocab_size"], n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                    head_dim=p["head_dim"], d_ff=p["d_ff"], dtype=torch.bfloat16,
                    rope_theta=10000.0, loss_chunk=2048), **(cfg_kw or {})))
    data = common.bench_data(cfg, seq=p["seq"], batch=p["batch"], device=devname)
    params = model.init(torch.Generator(device=devname).manual_seed(SEED))
    opt_kw = dict(FW_OPT, rank=p["rank"], **({} if devname.startswith("cuda")
                                            else dict(svd_oversample=4)))
    opt = make_optimizer("galore-sara-adam", params, state_sharding="zero",
                         state_shards=FW_WORLD, **opt_kw)
    del params
    return cfg, model, data, opt, opt_kw


def _fw_expect(cfg, opt, calls) -> dict:
    """Exact launches of the step calls ``calls`` ([(refresh, skipped)],
    skipped None for a call that failed): the model's norms and attention
    every call (a call that failed ran its forward and backward: on the
    data-parallel mesh the step's first collective follows them); the
    projection every hot call; the update every call that was not skipped,
    the power iterations every refresh that was not."""
    (fwd_n, fwd_a), (rem_n, rem_a) = forward_launches(cfg)
    nb = len(opt.bucket_plan.buckets)
    ran = [(r, sk) for r, sk in calls if sk is not None]
    hot = sum(1 for r, _ in ran if not r)
    refresh_done = sum(1 for r, sk in ran if r and not sk)
    done = sum(1 for _, sk in ran if not sk)
    expect = {"rmsnorm": len(calls) * (fwd_n + rem_n),
              "flash_attention_fwd": len(calls) * (fwd_a + rem_a),
              "galore_project_batched": (hot + refresh_done) * nb,
              UPDATE_KERNEL["adam"]: done * nb,
              "power_iter_batched": refresh_done * power_iter_calls(opt, None)}
    return {k: v for k, v in expect.items() if v}


def _fw_rank(rank: int, phase: int, out_dir: str, dev: str, preset, cfg_kw, go) -> None:
    """One process of the fault world, in phase 1 or 2 (see the constants).
    It sets up its model and optimizer, waits for ``go`` (phase 2's
    processes start beside phase 1's and join their world only when it
    has ended: a restarted world whose processes did their imports
    before), then runs.  It writes what it saw to ``out_dir`` and leaves
    with ``os._exit``: 0 when the phase ran to its end, 3 on
    ``ProcessKilled``, 1 on any other exception (a broken group is not
    torn down)."""
    import numpy as np
    from datetime import timedelta

    import torch.distributed as dist

    rec = {"rank": rank, "t0": time.time()}
    code = 0
    try:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core.lowrank import tree_leaves, tree_unflatten
        from repro_torch.device import resolve_device
        from repro_torch.kernels import counters
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.train import checkpoint as ckpt_lib
        from repro_torch.train import state as state_lib
        from repro_torch.train.faults import FaultPlan, FaultSpec, ProcessKilled
        from repro_torch.train.loop import train_loop
        from repro_torch.train.monitor import CollectiveWatchdog
        from repro_torch.train.recovery import RecoveryPolicy
        from repro_torch.train.state import TrainState
        from repro_torch.train.step import make_train_step

        if dev == "cuda":
            torch.cuda.set_device(0)  # both ranks on the one card
            resolve_device("cuda")
            devname = "cuda:0"
        else:
            torch.set_num_threads(1)
            _count_plain_dispatch()
            devname = "cpu"
        cfg, model, data, opt, _ = fw_setup(devname, preset, cfg_kw)
        # a warm-up: the first forward, backward and factorization set up
        # their libraries (and compile RMSNorm's Triton kernel) while this
        # process waits, not in the phase's first step
        params = model.init(torch.Generator(device=devname).manual_seed(SEED))
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), data.batch_at(0))
        torch.autograd.grad(loss, leaves)
        torch.linalg.svd(torch.linalg.qr(torch.randn(64, 16, device=devname))[0])
        del params, leaves, loss
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        rec["t_setup"] = time.time()
        if not go.wait(FW_WAIT_S):
            raise TimeoutError(f"phase {phase} was never started")
        rec["t_go"] = time.time()
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/store{phase}",
                                world_size=FW_WORLD, rank=rank,
                                timeout=timedelta(seconds=FW_GROUP_TIMEOUT_S))
        rec["t_group"] = time.time()
        mesh = mesh_lib.make_mesh((FW_WORLD, 1))
        pol = RecoveryPolicy()
        wd = CollectiveWatchdog(timeout_s=600.0)
        fns = make_train_step(model, opt, mesh=mesh, compressed="flat", recovery=pol,
                              watchdog=wd)
        calls, losses, call_s = [], [], []

        def recording(name):
            def run(*a, _fn=fns[name], **k):
                t = time.time()
                try:
                    st, m = _fn(*a, **k)
                except Exception:
                    calls.append((name == "refresh_step", None))
                    raise
                calls.append((name == "refresh_step", float(m["skipped"]) >= 1.0))
                losses.append(float(m["loss"]))
                call_s.append(round(time.time() - t, 3))
                return st, m
            return run

        loop_fns = dict(fns, step=recording("step"), refresh_step=recording("refresh_step"))
        ckdir = os.path.join(out_dir, "ck")
        tc = TrainConfig(total_steps=FW_STEPS, checkpoint_every=FW_EVERY, seed=SEED,
                         async_checkpoint=False, checkpoint_dir=ckdir)
        if phase == 1:
            specs = [FaultSpec("slow_step", step=5, value=FW_SLOW_S),
                     FaultSpec("ckpt_corrupt_shard", save_index=2)]
            if rank == FW_KILLED:
                specs.append(FaultSpec("kill_process", step=9))
        else:
            specs = ([FaultSpec("nan_grads", step=s) for s in FW_NAN_STEPS]
                     if rank == FW_NAN_RANK else [])
        plan = FaultPlan(specs)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        counters.reset()
        rec["t_start"] = time.time()
        try:
            res = train_loop(model, opt, data, tc, loop_fns, log_every=1, handle_signals=False,
                             recovery=pol, fault_plan=plan)
        finally:
            if dev == "cuda":
                torch.cuda.synchronize()
            rec.update(t_loop=time.time(), fired=list(plan.fired), calls=calls, losses=losses,
                       call_s=call_s,
                       launches=counters.snapshot(), expected=_fw_expect(cfg, opt, calls),
                       peak=torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
        mesh_lib.barrier(mesh)  # the other writer leaves the loop before the commit
        events = [r for r in res.history if "event" in r]
        rec.update(final_step=res.final_step, events=events,
                   first_step=min(r["step"] for r in res.history if "loss" in r),
                   skips=[r["skip_steps"] for r in res.history if "skip_steps" in r][-1],
                   fallbacks=[s for s, _ in res.checkpoints.fallbacks],
                   latest=ckpt_lib.latest_step(ckdir), watchdog=list(wd.fired),
                   format=ckpt_lib.checkpoint_format(ckdir, FW_STEPS),
                   last_save=res.checkpoints.last_save, last_load=res.checkpoints.last_load,
                   loss_tail=res.losses[-4:])
        full = fns["gather_state"](res.state)  # both processes join the gather
        if rank == 0:
            canon, loc = state_lib.checkpoint_converters(opt)
            ckpt_lib.CheckpointManager(os.path.join(out_dir, "replicated"), canonicalize=canon,
                                       localize=loc).save(full, FW_STEPS)
        del full
        mesh_lib.barrier(mesh)
    except BaseException as e:  # noqa: BLE001 -- what a survivor saw is the result
        code = 3 if type(e).__name__ == "ProcessKilled" else 1
        rec["error"] = (type(e).__name__, str(e)[:300], list(getattr(e, "__notes__", [])))
    rec["t_end"] = time.time()
    Path(out_dir, f"phase{phase}_rank{rank}.json").write_text(json.dumps(rec, default=str))
    if code == 0:
        import torch.distributed as dist

        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def fw_prestart(dev: str = "cuda", preset=None, cfg_kw=None) -> dict:
    """Start both worlds' processes of ``train_fault_world``, each waiting
    for its world's event (daemons: they end with this process)."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = fresh_dir("fault_world")
    out_dir.mkdir()
    go = {phase: ctx.Event() for phase in (1, 2)}
    procs = {phase: [ctx.Process(target=_fw_rank, daemon=True,
                                 args=(r, phase, str(out_dir), dev, preset, cfg_kw, go[phase]))
                     for r in range(FW_WORLD)] for phase in (1, 2)}
    for phase in (1, 2):
        for p in procs[phase]:
            p.start()
    return {"out_dir": out_dir, "go": go, "procs": procs, "t": time.time()}


def _fw_world(out_dir: Path, phase: int, procs, t: float):
    """Join one phase's processes (started, or let go, at ``t``): (exit
    codes, records)."""
    deadline = t + FW_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.time(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"train_fault_world phase {phase}: ranks {hung} outlived "
                             f"{FW_TIMEOUT_S} s")
    recs = []
    for r in range(FW_WORLD):
        f = out_dir / f"phase{phase}_rank{r}.json"
        if not f.exists():
            raise AssertionError(f"train_fault_world phase {phase}: rank {r} wrote no record "
                                 f"(exit {procs[r].exitcode})")
        recs.append(json.loads(f.read_text()))
    return [p.exitcode for p in procs], recs


def _fw_launches(phase: int, recs) -> None:
    for r in recs:
        got = {k: v for k, v in r["launches"].items() if v}
        if got != r["expected"]:
            raise AssertionError(f"train_fault_world phase {phase} rank {r['rank']}: launches "
                                 f"{got} != {r['expected']} (calls {r['calls']})")


def train_fault_world(smi: str, dev: str = "cuda", preset=None, cfg_kw=None, pre=None):
    """Phase 5g (path ``train_fault_world``, see the constants) on the
    processes ``pre`` (``fw_prestart``'s; started here where None).
    Returns the path's run: rank 0's launches over phases 1 and 2 and this
    process's in phase 3, each phase's checks passed; ``preset`` /
    ``cfg_kw`` shrink it for a CPU rehearsal (``dev="cpu"``)."""
    import math

    from repro_torch.core.lowrank import state_tensors, tree_leaves
    from repro_torch.kernels import counters
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import state as state_lib
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step

    pre = pre or fw_prestart(dev, preset, cfg_kw)
    out_dir = pre["out_dir"]
    ckdir = str(out_dir / "ck")
    secs = {}
    try:
        # phase 1: a straggler, a corrupt shard, a killed rank
        t = time.time()
        pre["go"][1].set()
        codes, recs = _fw_world(out_dir, 1, pre["procs"][1], t)
        secs["phase1"] = time.time() - t
        secs["start_up"] = max(r["t_setup"] for r in recs) - pre["t"]
        secs["group"] = max(r["t_group"] for r in recs) - t
        want_codes = [3 if r == FW_KILLED else 1 for r in range(FW_WORLD)]
        errors = [r.get("error") for r in recs]
        if codes != want_codes or errors[FW_KILLED][0] != "ProcessKilled":
            raise AssertionError(f"train_fault_world phase 1: exit codes {codes} (want "
                                 f"{want_codes}), errors {errors}")
        t_kill = recs[FW_KILLED]["t_end"]
        for r in recs:
            if not any("step 9 failed" in n for n in r["error"][2]):
                raise AssertionError(f"train_fault_world rank {r['rank']} did not name step 9: "
                                     f"{r['error']}")
            if r["t_end"] - t_kill > FW_EXIT_BAR_S:
                raise AssertionError(f"train_fault_world rank {r['rank']} ended "
                                     f"{r['t_end'] - t_kill:.1f} s after the killed rank")
        fired = [set(map(tuple, r["fired"])) for r in recs]
        if set().union(*fired) != set(FW_FIRED) or fired[0] != {FW_FIRED[0], FW_FIRED[1]} \
                or fired[FW_KILLED] != {FW_FIRED[0], FW_FIRED[2]}:
            raise AssertionError(f"train_fault_world phase 1 fired {fired}")
        verified = {s: ckpt_lib.verify_checkpoint(ckdir, s) for s in (4, 8)}
        if verified != {4: True, 8: False}:
            raise AssertionError(f"train_fault_world: checkpoints verify as {verified}")
        # steps 0-8 on both ranks, and the survivor's step 9 up to its failed collective
        if [len(r["calls"]) for r in recs] != [9 if r == FW_KILLED else 10
                                                for r in range(FW_WORLD)] \
                or not all(math.isfinite(x) for r in recs for x in r["losses"]) \
                or recs[0]["losses"] != recs[1]["losses"]:
            raise AssertionError(f"train_fault_world phase 1 losses {[r['losses'] for r in recs]}")
        _fw_launches(1, recs)
        secs["detect_kill"] = max(r["t_end"] for r in recs) - t_kill
        secs["steps1"] = max(r["t_loop"] - r["t_start"] for r in recs)
        log(f"train_fault_world phase 1 ({smi}; {FW_WORLD} processes sharing one card over "
            f"gloo): fired {[r['fired'] for r in recs]}; exit codes {codes}; rank 0's error "
            f"{recs[0]['error'][0]}: {recs[0]['error'][2]}; the survivor ended "
            f"{secs['detect_kill']:.2f} s after the killed rank; checkpoints verify {verified}; "
            f"losses {recs[0]['losses']}; step call s per rank {[r['call_s'] for r in recs]}; "
            f"launches per rank {[r['launches'] for r in recs]}")
        # phase 2: the restart, a divergence rolled back in lockstep
        t = time.time()
        pre["go"][2].set()
        codes, recs2 = _fw_world(out_dir, 2, pre["procs"][2], t)
        secs["phase2"] = time.time() - t
        secs["restart"] = max(r["t_start"] for r in recs2) - t
        secs["steps2"] = max(r["t_loop"] - r["t_start"] for r in recs2)
        if codes != [0] * FW_WORLD:
            raise AssertionError(f"train_fault_world phase 2: exit codes {codes}, errors "
                                 f"{[r.get('error') for r in recs2]}")
        for r in recs2:
            rbs = [e for e in r["events"] if e["event"] == "rollback"]
            if (r["final_step"], r["first_step"], r["fallbacks"], r["latest"], r["format"],
                    r["skips"], r["watchdog"]) != (FW_STEPS, 4.0, [8], FW_STEPS, "sharded", 3.0,
                                                   []) \
                    or [(e["step"], e["from_step"]) for e in rbs] != [(8.0, FW_NAN_STEPS[-1])]:
                raise AssertionError(f"train_fault_world phase 2 rank {r['rank']}: {r}")
            if len(rbs) != 1 or "cross-process bad-step verdict" not in rbs[0]["reason"]:
                raise AssertionError(f"train_fault_world phase 2 rank {r['rank']}: rollbacks "
                                     f"{rbs}")
            if not all(math.isfinite(x) for x in r["loss_tail"]):
                raise AssertionError(f"train_fault_world phase 2 losses {r['losses']}")
        if recs2[0]["losses"] != recs2[1]["losses"]:
            raise AssertionError("train_fault_world phase 2: the ranks' losses differ")
        _fw_launches(2, recs2)
        log(f"train_fault_world phase 2 ({smi}): resumed at step {recs2[0]['first_step']} past "
            f"{recs2[0]['fallbacks']}; events {[(e['event'], e.get('step')) for e in recs2[0]['events']]}; "
            f"losses {recs2[0]['losses']}; save {recs2[0]['last_save']}, load "
            f"{recs2[0]['last_load']}; max_memory_allocated per rank "
            f"{[round(r['peak'] / 2**30, 2) for r in recs2]} GiB; step call s per rank "
            f"{[r['call_s'] for r in recs2]}; launches per rank "
            f"{[r['launches'] for r in recs2]}")
        # phase 3, here at world 1: the elastic resume and one live step
        devname = "cuda:0" if dev == "cuda" else "cpu"
        cfg, model, data, opt2, opt_kw = fw_setup(devname, preset, cfg_kw)
        from repro_torch.core import make_optimizer

        t = time.time()
        params = model.init(torch.Generator(device=devname).manual_seed(SEED))
        opt1 = make_optimizer("galore-sara-adam", params, state_sharding="zero", state_shards=1,
                              **opt_kw)
        skel = TrainState(params, opt1.init(params))
        del params
        t_load = time.time()
        got, step = ckpt_lib.CheckpointManager(
            ckdir, canonical_rows=state_lib.bucket_canonical_rows(opt1)).load_latest(skel)
        secs["load_1_shard"] = time.time() - t_load
        canon, loc = state_lib.checkpoint_converters(opt1)
        ref, _ = ckpt_lib.CheckpointManager(str(out_dir / "replicated"), canonicalize=canon,
                                            localize=loc).load_latest(skel)
        ca = state_tensors(state_lib.canonical_train_state(opt1, got).opt_state) \
            + tree_leaves(got.params)
        cb = state_tensors(state_lib.canonical_train_state(opt1, ref).opt_state) \
            + tree_leaves(ref.params)
        if step != FW_STEPS or len(ca) != len(cb) or not all(
                torch.equal(a, b) for a, b in zip(ca, cb)) \
                or got.opt_state.draws.key().tolist() != ref.opt_state.draws.key().tolist():
            raise AssertionError(f"train_fault_world phase 3: step {step}, the 1-shard load "
                                 "differs from the replicated save")
        n_leaves = len(ca)
        del ref, ca, cb, skel
        fns = make_train_step(model, opt1, mesh=mesh_lib.single_device_mesh(),
                              compressed="flat")
        before = counters.snapshot()
        _, m = fns["step"](fns["place_state"](got), data.batch_at(FW_STEPS))
        loss3 = float(m["loss"])
        launches3 = _launches_since(before)
        want3 = _fw_expect(cfg, opt1, [(False, False)])
        if not math.isfinite(loss3) or launches3 != want3:
            raise AssertionError(f"train_fault_world phase 3: loss {loss3}, launches "
                                 f"{launches3} != {want3}")
        secs["phase3"] = time.time() - t
        del got, fns, m
        log(f"train_fault_world phase 3 (this process, world 1): step {step} at 1 shard "
            f"bit-equal to the replicated save ({n_leaves} tensors), loaded in "
            f"{secs['load_1_shard']:.2f} s; a compressed step on the (1, 1) mesh, loss "
            f"{loss3:.4f}; launches {launches3}")
    finally:
        for p in pre["procs"][2]:  # phase 1 failed: its waiting successors go too
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = {}
    for part in (recs[0]["launches"], recs2[0]["launches"], launches3):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    log(f"train_fault_world seconds ({smi}): " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return {"launches": {k: v for k, v in launches.items() if v}, "card": smi, "seconds": secs,
            "launches_by_rank": [[r["launches"] for r in recs], [r["launches"] for r in recs2]],
            "losses": [recs[0]["losses"], recs2[0]["losses"], loss3],
            "events": recs2[0]["events"], "last_save": recs2[0]["last_save"],
            "last_load": recs2[0]["last_load"], "peaks": [r["peak"] for r in recs2]}


# Phase 5h, ``dryrun``: ``launch/dryrun.py`` on the cells of the paths that
# ran, held to what they measured: llama3-8b at 1 layer in one process
# (``train``), a ``train_tp`` rank at (1, 2) and the ZeRO ranks of
# ``train_tp_inners`` (qwen2-1.5b, (2, 1)): the dry run's optimizer-state
# bytes equal each path's ``state_memory_bytes``, and its params +
# gradients + state sit at or below each path's max_memory_allocated
# (which adds the activations).  Then the question of PERF.md §7 at full
# depth: whether llama3-8b and llava-next-34b fit 4 cards (params,
# gradients, state; activations not counted) tensor parallel at (1, 4),
# FSDP at (4, 1), and FSDP with ZeRO state.
DRY_FIT_ARCHS = ("llama3-8b", "llava-next-34b")
DRY_FIT_MESHES = (("tp", "1,4", ""), ("fsdp", "4,1", ""), ("fsdp_zero", "4,1", "zero"))


def _dry_args(**kw):
    from repro_torch.launch import dryrun

    args = dryrun.parser().parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def dryrun_phase(smi: str, runs) -> dict:
    """Phase 5h (see the constants): {"checks": [...], "fit": [...]}.  A
    check runs where its path ran in this script (``runs``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun

    checks = []

    def held(path, arch, cfg, mesh, measured, optimizer="galore-sara-adam", **kw):
        rep = dryrun.run_cell(arch, "train_4k", _dry_args(
            mesh=mesh, optimizer=optimizer, rank=kw.pop("rank", TRAIN_OPT["rank"]), **kw),
            cfg=cfg)
        mem = rep.memory_per_device
        resident = mem["param_bytes"] + mem["grad_bytes"] + mem["opt_state_bytes"]
        for r, (state_bytes, peak) in enumerate(measured):
            if mem["opt_state_bytes"] != state_bytes or resident > peak:
                raise AssertionError(
                    f"dryrun {path} rank {r}: state {mem['opt_state_bytes']:.0f} bytes (measured "
                    f"{state_bytes}), params + gradients + state {resident:.0f} above the "
                    f"measured peak {peak}")
        checks.append({"path": path, "mesh": mesh, "state_bytes": mem["opt_state_bytes"],
                       "resident_bytes": resident, "measured": measured})
        log(f"dryrun {path} at {mesh}: state {mem['opt_state_bytes']:.0f} bytes = measured "
            f"{[m[0] for m in measured]}; params + gradients + state "
            f"{resident / 2**30:.2f} GiB <= measured peaks "
            f"{[round(m[1] / 2**30, 2) for m in measured]} GiB")

    llama1 = get_config("llama3-8b").with_(n_layers=TRAIN_RUN_LAYERS)
    if "train" in runs:
        r = runs["train"]
        held("train", "llama3-8b", llama1, "1,1", [(r["state_bytes"], r["max_memory_allocated"])])
    if "train_tp" in runs:
        held("train_tp", "llama3-8b", get_config("llama3-8b").with_(n_layers=TP_LAYERS), "1,2",
             [(r["dense"]["state_bytes"], r["dense"]["max_memory_allocated"])
              for r in runs["train_tp"]["ranks"]])
    for path in ("train_fsdp_zero", "train_fsdp_zero_adam8bit"):
        if path in runs:
            held(path, TPI_ARCH, tpi_cfg(), "2,1",
                 [(r["state_bytes"], r["max_memory_allocated"]) for r in runs[path]["ranks"]],
                 optimizer=TPI_RUNS[path][0], rank=TPI_RANK, state_sharding="zero")
    fit = []
    for arch in DRY_FIT_ARCHS:
        for name, mesh, zero in DRY_FIT_MESHES:
            rep = dryrun.run_cell(arch, "train_4k", _dry_args(mesh=mesh, state_sharding=zero))
            mem = rep.memory_per_device
            fit.append({"arch": arch, "layers": rep.extra["n_layers"], "layout": name,
                        "mesh": mesh, "param_bytes": mem["param_bytes"],
                        "grad_bytes": mem["grad_bytes"], "state_bytes": mem["opt_state_bytes"],
                        "total_bytes": mem["total_bytes"], "fits_80GB": rep.extra["fits"],
                        "bytes_over_model": rep.collectives.get("model"),
                        "bytes_over_data": rep.collectives.get("data")})
    log(f"dryrun ({smi}): full depth on 4 cards, per process (params + gradients + state; "
        f"activations not counted): " + "; ".join(
            f"{f['arch']} {f['layout']} {f['total_bytes'] / 1e9:.2f} GB "
            f"({'fits' if f['fits_80GB'] else 'does not fit'} 80 GB)" for f in fit))
    print(json.dumps({"dryrun_fit": fit}))
    return {"checks": checks, "fit": fit}


PHASES = ("kernels", "serve", "train", "train_recovery", "train_rank_schedule", "resume",
          "train_dp", "train_tp", "train_tp_families", "train_tp_inners", "train_fault_world",
          "family_kernels", "serve_moe", "train_moe", "serve_ssm", "train_ssm",
          "serve_hybrid", "train_hybrid", "encdec_vlm_kernels", "serve_vlm", "train_vlm",
          "serve_audio", "train_audio", "tables", "dryrun")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="on-card smoke test of the port")
    ap.add_argument("--only", default="", help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p] or list(PHASES)
    if set(only) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(only) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")  # f32 products in full f32 (no TF32), as the port runs
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    from repro_torch.configs.registry import get_config

    results = {name: dict(name=name, **meta) for name, meta in KERNELS.items()}
    cases, runs, phase_s = [], {}, {}

    def phase(name, fn):
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t
        log(f"{name} phase: {phase_s[name]:.1f} s")
        return out

    if "kernels" in only:
        cases += phase("kernels", lambda: kernel_cases(results) + optimizer_kernel_cases(results)
                       + update_kernel_cases(results) + rank_kernel_cases(results)
                       + cut_adam8bit_cases(results))
    if "serve" in only:  # full width, SERVE_LAYERS of 32, bf16
        runs["serve"] = phase("serve", lambda: serve(cut_depth(get_config("llama3-8b"),
                                                               SERVE_LAYERS)))
    cfg_train = get_config("llama3-8b").with_(n_layers=TRAIN_LAYERS)
    cfg_runs = cfg_train.with_(n_layers=TRAIN_RUN_LAYERS)
    if "train" in only:
        for path, (optimizer, plan, _, opt_kw) in TRAIN_RUNS.items():
            runs[path] = phase(path, lambda: train(
                cfg_runs, optimizer, train_buckets(TRAIN_RUN_LAYERS, plan), opt_kw=opt_kw))
    if "train_recovery" in only:
        # at 1 layer: the gate's cost is its in-phase turns, not a
        # difference with train's 4-layer hot steps
        runs["train_recovery"] = phase("train_recovery", lambda: train_recovery(
            cfg_train.with_(n_layers=RECOVERY_LAYERS), smi, None,
            expect_buckets=train_buckets(RECOVERY_LAYERS)))
    if "train_rank_schedule" in only:
        runs["train_rank_schedule"] = phase("train_rank_schedule", lambda: train_rank_schedule(
            cfg_runs, smi, expect_buckets=train_buckets(TRAIN_RUN_LAYERS)))
    if "resume" in only:
        runs["resume"], runs["serve_ckpt"] = phase("resume", lambda: resume(
            cfg_train.with_(n_layers=RESUME_LAYERS), smi,
            expect_buckets=train_buckets(RESUME_LAYERS)))
    if "train_dp" in only:
        runs["train_dp"] = phase("train_dp", lambda: train_dp(
            cfg_train.with_(n_layers=DP_LAYERS), smi, expect_buckets=train_buckets(DP_LAYERS)))
    if "train_tp" in only:
        (runs["train_tp"], runs["train_tp_moe"], runs["train_fsdp"],
         runs["train_fsdp_moe"]) = phase("train_tp", lambda: train_tp(smi))
    if "train_tp_families" in only:
        runs.update(phase("train_tp_families", lambda: train_tp_families(smi)))
    # the fault world's processes start up while the phase before it runs
    fw_pre = fw_prestart() if "train_fault_world" in only else None
    if "train_tp_inners" in only:
        runs.update(phase("train_tp_inners", lambda: train_tp_inners(smi)))
    if "train_fault_world" in only:
        runs["train_fault_world"] = phase("train_fault_world",
                                          lambda: train_fault_world(smi, pre=fw_pre))
    if "family_kernels" in only:
        cases += phase("family_kernels", lambda: family_kernel_cases(results))
    if "serve_moe" in only:  # deepseek-moe-16b at full width and depth
        runs["serve_moe"] = phase("serve_moe", lambda: serve(
            cut_depth(get_config(MOE_ARCH), SERVE_MOE_LAYERS), profile_ticks=4))
    for path in ("train_moe", "train_ssm", "train_hybrid"):
        if path in only:
            runs[path] = phase(path, lambda: family_train(path, smi))
        serve_path = path.replace("train", "serve")
        if path == "train_moe" or serve_path not in only:
            continue
        cfg, lens = (cut_depth(get_config(SSM_ARCH), SERVE_SSM_LAYERS), PROMPT_LENS) \
            if path == "train_ssm" else \
            (get_config(HYBRID_ARCH).with_(n_layers=HYBRID_LAYERS), HYBRID_PROMPT_LENS)
        runs[serve_path] = phase(serve_path, lambda: serve_slots(cfg, lens))
    if "encdec_vlm_kernels" in only:
        cases += phase("encdec_vlm_kernels", lambda: encdec_vlm_kernel_cases(results))
    if "serve_vlm" in only:  # llava-next-34b at full width and depth, bf16
        runs["serve_vlm"] = phase("serve_vlm", lambda: serve(
            cut_depth(get_config(VLM_ARCH), SERVE_VLM_LAYERS), profile_ticks=4,
            pool_pages=VLM_POOL_PAGES))
    if "train_vlm" in only:
        runs["train_vlm"] = phase("train_vlm", lambda: family_train("train_vlm", smi))
    if "serve_audio" in only:  # whisper-medium at full width, AUDIO_LAYERS + AUDIO_LAYERS, bf16
        runs["serve_audio"] = phase("serve_audio", lambda: serve_slots(
            cut_depth(get_config(AUDIO_ARCH), AUDIO_LAYERS), AUDIO_PROMPT_LENS,
            new_tokens=AUDIO_NEW_TOKENS, max_seq_len=AUDIO_MAX_SEQ))
    if "train_audio" in only:
        runs["train_audio"] = phase("train_audio", lambda: family_train("train_audio", smi))
    if "tables" in only:  # the paper's experiments at LLaMA-60M
        runs["tables"] = phase("tables", lambda: paper_tables(smi, results))
        cases += runs["tables"].pop("cases")
    dry = phase("dryrun", lambda: dryrun_phase(smi, runs)) if "dryrun" in only else None
    log(f"phase seconds {phase_s}; all {time.perf_counter() - t_start:.1f} s ({smi})")

    for name, r in results.items():
        r["library_call"] = LIBRARY_CALL[name]
        by_path = {path: run["launches"].get(name, 0) for path, run in runs.items()}
        r["launches_by_path"] = by_path
        r["launches"] = sum(by_path.values())
        for path in runs:
            if name in PATH_KERNELS[path] and by_path[path] <= 0:
                raise AssertionError(f"{name} never launched on the {path} path")
            if name in PATH_NEVER.get(path, ()) and by_path[path] != 0:
                raise AssertionError(f"{name} launched {by_path[path]} times on {path}")
        if only == list(PHASES) and r["launches"] <= 0 and name not in NO_PATH:
            raise AssertionError(f"{name} launched on no path")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "phase_seconds": phase_s, "kernels": list(results.values()),
         "cases": cases, "dryrun": dry, **runs}, indent=1, default=str))
    ratios = [{"kernel": c["kernel"], "case": c["case"], "dtype": c["dtype"],
               "ms": c["ms"], "library_ms": c["library_ms"],
               "ratio": c["ms"] / c["library_ms"]} for c in cases if c.get("library_ms")]
    print(json.dumps({"kernel_over_library": ratios}))
    if "tables" in runs:
        print(json.dumps({"tables": runs["tables"]["rows"]}))
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
