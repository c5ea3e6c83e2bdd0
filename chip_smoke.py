#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tst_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --only rank      # phases 1-2, then the attention kernels vs the library
    python3 chip_smoke.py --only mlp-int4  # phases 1-2, 11-12 (K3, K4), the int4 decode
                                           # and fused train steps of phases 13-14
    python3 chip_smoke.py --only serve     # phases 1-2, the decode attention kernel and 20
    python3 chip_smoke.py --only llama8b   # phases 1-2, the native packer and 22
    python3 chip_smoke.py --only entry     # phases 1-2 and 23
    python3 chip_smoke.py --only bench     # phases 1-2 and 24 (the bench's default steps)
    python3 chip_smoke.py --only widths    # phases 1-2 and 25
    python3 chip_smoke.py --only ring      # phases 1-2, 5b and 21 (the ring through K1)

Every step compared with the plain path (phases 7, 10, 14, 22, 24, 25)
holds its per-fold losses within 1e-3 of the plain loss, relative, and its
LoRA gradients at cosine >= 0.999 (0.99 before phase 25), each averaged
over the path's first batches (GATE_BATCHES: one batch's fold loss is a
handful of answer tokens, where bf16 rounding alone can reach 1e-3); a
``[cosines]`` line gives each phase's lowest cosine.

Phases, each printing one line; any failure raises and exits non-zero:

  1. device  — a CUDA device is present; its name and power limit;
     native-pack — the port's C++ byte packer built with g++ from
               tst_torch/native/csrc, backend="native" bit-equal to the Python
               path on phase 21's long rows and on a 100,000-character context
               (at its bucket and head-truncated to 512); each path's seconds;
  2. build   — nvcc builds every kernel from tst_torch/csrc (sm_90a); each
               kernel's registers and spill bytes; the count of wgmma (HGMMA)
               instructions in the SASS (cuobjdump) of each of the 18
               attention kernels (forward, dK/dV, dQ at D=64 and 128, plain,
               segmented and non-causal) and of the two K4 kernels (gate-up,
               down), which must not be 0; nvcc's seconds in ``[walls]``;
  3. kernel  — the flash-attention forward kernel against its plain PyTorch
               version on the card at the slice's shape, Llama-3-8B heads, a
               128-token case, one tile (S=64) at both head dims, the dry
               run's and the bench's fold-parallel call [20, 512, 14, 64];
               bit-equal on a second call; bad shapes raise; median kernel
               and plain times;
  4. slice   — ``python -m tst_torch eval-blind`` (Qwen2.5-0.5B at full
               width, random weights from the seed, bf16, the synthetic MCQ
               benchmark, n=512) through the CLI entry point; the kernel's
               launch count must be 24 layers x 16 chunks; the same tokens
               and weights scored through the plain attention must give the
               same letter probabilities;
  5. kernel-bwd — the dK/dV and dQ kernels against the plain backward, and
               gradients through the autograd Function against autograd of
               the plain attention, at the shapes of phase 3 and one tile
               (S=64); a second call must give bit-equal results; bad shapes
               raise; median times at the train step's shape, beside
               torch's scaled_dot_product_attention (forward, and its
               backward alone) as the library yardstick;
  5b. kernel-full — the non-causal (causal=False) forward, dK/dV and dQ
               kernels against their plain versions (k1_case, as phases 19
               and 25 hold the causal and packed ones; o also within 2e-2 of
               max|ref|, as a long row's o is ~0.01) at a 128-token case, one
               tile (S=64) at both head dims, S=576 at both, the ring's block
               at the long preset [10, 4096, 14, 64] and Llama-3-8B's heads
               [1, 4096, 32, 128]; each launched once and bit-equal on a
               second call; the autograd Function's gradients the kernels';
               S=100 and
               seg_starts with causal=False raise; at the last two shapes
               each kernel timed beside scaled_dot_product_attention
               (is_causal=False, enable_gqa; forward, and its backward alone)
               and the bound (every (query, key) pair);
  6. train   — ``python -m tst_torch diagnose-sft`` (Qwen2.5-0.5B at full
               width, k=2 folds x 16 rows, 1 epoch, LoRA r16 on q/k/v/o,
               bf16, synthetic:0.5, n=512) through the CLI entry point; the
               three kernels' launch counts must be what the run's own step
               and chunk counts imply; report.json and the s(x) table, with
               the RF cross-check of the default config (a finite
               rf_sft_spearman and rf_blind_accuracy, and its wall); then
               the median train-step time after the first step;
  7. train, kernel vs plain — the fold-parallel step's LoRA gradients and
               losses through the kernels against ``model.use_pallas=false``
               on the same weights, adapters and batches (4 rows per fold,
               averaged over GATE_BATCHES);
  8. kernel-seg — the segmented (packed-row) forward, dK/dV and dQ kernels
               against their plain versions, and gradients through the
               autograd Function against autograd of the plain masked
               attention: at the packed train step's call with the run's own
               segment starts, at Llama-3-8B heads with 8 segments a row at
               S=2048, and at 128- and 64-token cases (64 at both head dims)
               with starts inside tiles and a row of all SEG_PAD, and at the
               bench's packed Llama-3-8B legs' first steps ([2, 1024, 32, 128]
               and [5, 1024, 32, 128], their own starts); forward and
               backward bit-equal on a second call; the segmented kernels
               timed at the [5, 1024, 32, 128] leg beside the library with
               the segment mask and the bound;
               bad starts raise; median times of the segmented kernels, the
               unsegmented ones, the plain versions and scaled_dot_product_
               attention with the boolean segment mask at the train step's
               shape;
  9. train-packed — ``python -m tst_torch diagnose-sft --set optim.pack=true``
               (phase 6's run, train and held-out rows packed three samples
               to a row of 1024): the segmented kernels' launch counts must
               be what the run's steps and scorer chunks imply, and the
               unsegmented kernels must not run; report.json and the s(x)
               table; the median train-step time after the first;
 10. train-packed, kernel vs plain — the packed step's LoRA gradients and
               losses (2 packed rows per fold, averaged over GATE_BATCHES)
               and the packed scorer's letter
               probabilities through the kernels against the plain path;
 11. kernel-int4 — the packed-int4 dequant-matmul (K3) against its plain
               version at decode's M (32, 64), at speculative decode's verify
               chunk (96: 32 rows x 3) and at M=37 for each int4 leaf of
               Qwen2.5-0.5B and of Llama-3-8B, layer 1 of a stacked [2, K, N/2]
               leaf, bit-equal on a second call, one kernel a call (the
               kernel nodes of a CUDA graph of one call);
               at every Qwen shape the device time a call (a CUDA graph of 10
               calls, replayed: no host in it) and the host time a call (the
               public entry, back to back), summed over a decode layer's
               seven projections at M=32 and M=64;
 11b. kernel-dattn — the decode step's attention kernel against its plain
               version at every DATTN_CASES case, one launch, bit-equal on a
               second call, each query of a verify chunk equal to itself
               alone and in a longer cache with masked slots (F1); the same
               invariances across its rank chunks and its one- and two-kernel
               paths at both head dims (dattn_boundary); each case's device
               time beside scaled_dot_product_attention with the mask and the
               bound (the plain version's at the greedy step);
 12. kernel-mlp — the fused SwiGLU MLP (K4) against its plain version at the
               int4 train step's shape, at Llama-3-8B widths and at an M that
               is no tile multiple, bit-equal on a second call; gradients
               through the autograd Function against autograd of the plain
               version; at the train shape the median time of the call and
               of each of its two kernels, with TFLOP/s, the decoder's
               unfused bf16 MLP and the bound;
 13. decode-slice — ``python -m tst_torch eval-blind`` on synthetic-vsi:0.4
               (192 MCQ + 64 numeric rows, n=256) with ``model.quantize=int4``
               through the CLI: launch counts as the run implies (K3 on every
               int4 projection of every decode step); the first decode step's
               logits through K3 against the plain path on the same caches
               (no decisive first-token disagreement);
               decode step times, the device's idle share and K3's share of
               the busy time (profiler);
 14. train-fused — ``python -m tst_torch diagnose-sft`` on synthetic-vsi:0.4
               (128 rows) with ``model.quantize=int4 model.fused_mlp=true``
               through the CLI: launch counts as implied (K4 on every
               train-step MLP, K3 on the held-out decode of both folds' rows
               at once); report.json and the s(x) table; the step's LoRA
               gradients and fold losses against the unfused plain path
               (GATE_BATCHES); median step time fused against unfused, their
               peak device memory, and a profile of the fused step;
 15. diagnose-rf — ``python -m tst_torch diagnose-rf`` (synthetic:0.5, n=128,
               k=5) through the CLI, the port's own forest fit on the host and
               the forests traversed on the card: each fold's forest traversed
               on the host path gives probabilities within 1e-6 and the same
               s(x) ranking; no kernel launches; blind accuracy above chance
               (the benchmark plants a length bias); the fit's wall and the
               traversal's time on the card;
 16. debias-ibp — ``python -m tst_torch debias-ibp`` (Qwen2.5-0.5B at full
               width, 12 of its 24 layers, bf16, synthetic-vsi:0.4, n=512,
               phase 6's training for
               one epoch a round, 2 rounds, stop_epsilon -1) through the CLI: 2 rounds; the audit
               rows, debiased.jsonl + removed.jsonl and sx.jsonl's kept column
               add up; ibp_report.json is strict JSON; the three attention
               kernels launch as the rounds' own steps, scorer chunks and
               decode prefills imply; round 0's held-out MCQ s(x) on its final
               adapters through the plain attention at Spearman >= 0.999; each
               round's stage walls and the peak device memory;
 17. debias-ibp-rf — the same subcommand with ``ibp.diagnostic=rf``
               (synthetic:0.5, n=128, k=3, 2 rounds): each round prunes
               prune_mask's budget, the audit and split add up, no kernel
               launches;
 18. checkpoint-qwen — phase 4's weights written as an HF safetensors
               checkpoint under HF's names (Qwen2.5-0.5B's published
               config.json: 24 layers, tied head, QKV biases) and loaded back
               through ``eval-blind --set model.path=... model.tokenizer=byte``:
               launches as implied, every loaded leaf bit-equal to what was
               written, the letter probabilities equal to phase 4's; the
               write and load walls and GB/s;
 19. llama — a checkpoint at Llama-3-8B's published width (config.json with
               2 of its 32 layers, random weights from a seed, ~2.97 GB in a
               temporary directory, deleted after; read back bit-equal, GB/s):
               (a) ``diagnose-sft --preset sft-mmmu-llama8b`` (k=5, batch 8,
               remat=True) with model.path, the byte tokenizer, a mesh of one,
               synthetic:0.5, n=40, one epoch: K1 at D=128 forward (twice a step
               under remat),
               dK/dV and dQ launches as implied; one step with remat against
               one without (the step gates; bit-equality reported), each one's
               step time, peak memory and profile; the multi-token scorer on
               synthetic [4, 3] option sequences, K1 against the plain path
               (probabilities within 0.05); K1's forward (bit-equal on a
               second call) and backward times at the step's shape beside the
               plain version, the library and the bound; (b) the checkpoint quantized to int4 on arrival
               (``quantizing_put``), ``eval-blind`` on synthetic-vsi:0.4,
               n=64: launches as implied (numeric rows decoded through K3 at
               Llama's widths), the first decode step's logits against the
               plain path (phase 13's gates);
 20. serve — Qwen2.5-0.5B at full width, bf16, random weights from the
               seed: (a) ``diagnose-sft`` at phase 6's geometry for one epoch
               with ``checkpoint_dir`` (the seed_0_epoch_000 layout and its
               stamp; K1 launches as implied), then in process a fit failed
               after step 3 and resumed from its checkpoint against an
               uninterrupted one (bit-equal adapters, AdamW state and fold
               losses); (b) ``eval-blind --adapter --fold 0`` and ``--fold
               mean`` (K1 launches 24 x the chunks; fold 0's letter
               probabilities against the same adapter through the plain
               attention, within 0.05); (c) ``generate --adapter`` on an int4
               base, synthetic-vsi:0.4, n=32, 8 tokens (K1, K3 and decode
               attention launches
               as implied; the first decode step through K3 against the plain
               path, phase 13's gates; tokens/s); (d) the same with the
               target's config as an int4 draft, gamma 2 (launches as
               implied; every row's tokens equal to (c)'s; rounds, acceptance,
               tokens/s), and without the adapter, the draft then the target
               itself (launches, rounds, acceptance, tokens/s; every row equal
               to greedy decode without the adapter); on a bf16 target,
               greedy against speculative decode with the adapter and a bf16
               draft of other weights, and without it and the target as its
               own draft, at gamma 2 and 4 and 32 and 27 rows a call, 8
               tokens a row (every row equal); (e)
               ``warmup`` (the kernels resolved, no launch);
 21. long — the flash kernels' forward, dK/dV and dQ at S=16384 (one KV
               head and its GQA group of 7) and S=32768 (one query head)
               against their plain versions, at the S=512 gates' tolerances;
               the ring at S=16384 (4 blocks, the ranks' step in one process,
               tst_torch.kernels.ring_attention) through K1 (the diagonal
               blocks causal, the past blocks non-causal, the future ones
               skipped: 4 causal and 6 non-causal launches of each kernel,
               and no call of the plain partials) and through the plain
               partials, each against unsplit K1 and against each other,
               output within the forward gate, output and gradients at
               cosine >= 0.999; the ring through K1 at the preset's full call
               against unsplit K1; both rings' walls (forward and backward,
               the median of 3 warmed calls); the forward and the backward
               pair bit-equal on a
               second call at S=16384 (the check and the preset's call); the
               kernels timed at the preset's call q [10, 16384, 14, 64] beside
               scaled_dot_product_attention and the bound;
               ``diagnose-sft --preset sft-videomme-long`` (max_len 16384, k=5,
               batch 2 a fold, model.remat=true, the byte tokenizer) on 6
               synthetic rows of ~16,000 bytes through the CLI with
               ``--profile-dir``: launches as implied, finite fold losses, every
               row's s(x), the step's median ms, samples/s, peak memory and the
               trace's top ops.

Phase 11 also holds K3's rows at M=96 and M=37 bit-equal to the same rows
of an M=32 call, and the decode step's attention kernel (after phase 11)
against its plain version at the greedy step's and the verify chunk's
shapes, Llama-3-8B's heads and a cache of 16,512 slots, bit-equal query by
query and in a longer cache with masked slots between the keys; its device
time from a CUDA graph beside the library's and the bound (the keys and
values of the slots a row's queries see).

 22. llama8b — Llama-3-8B at all 32 of its layers and its published widths,
               random weights from the seed initialized on the card (no
               checkpoint), the byte tokenizer, a mesh of one card: (a)
               ``diagnose-sft --preset sft-mmmu-llama8b`` (k=5, batch 8,
               remat=True) on synthetic:0.5, n=20, one epoch, with
               ``--profile-dir``: launches as implied, finite fold losses, s(x)
               in [0, 1], the RF cross-check; the step's median ms, samples/s,
               TFLOP/s (tst_torch.aux.flops) and its share of 989, peak memory
               and the trace's top ops; the step (4 rows a fold, the first 8 of
               the 32 layers) through the kernels against
               ``model.use_pallas=false`` (the step gates of phase 7,
               GATE_BATCHES); (b) ``debias-ibp --preset ibp-vsibench`` (k=5, remat,
               prune_rate 0.1, the SFT diagnostic) on synthetic-vsi:0.4, n=60,
               1 round: phase 16's gates, then the first decode step of the
               bf16 base with round 0's fold-0 adapter through the kernels
               against the plain path (phase 13's rule); (c) ``eval-blind`` on
               an int4 base (quantized after the init) on synthetic-vsi:0.4,
               n=64: launches as implied (K3 at Llama's widths in every decode
               step), the first decode step through K3 against the plain path,
               decode tokens/s and the step's idle share, the init +
               quantization wall and the peak memory during the build and
               after it.

 23. entry — the entry points of tst_torch.graft_entry: (a)
               ``entry()``, Qwen2.5-0.5B at full width in bf16 from a random
               init on the card, its forward of a [4, 512] batch: K1's forward
               launched once a layer (24) and no other kernel, the logits
               against the plain attention on the same weights within 2e-2 ·
               max|logit|; since a batch of ones gives every position one
               value row, which attention returns whatever its weights, also
               on random tokens against the plain path in f32 (the bf16 plain
               path's distance reported); the first and the median call's
               wall and the peak memory; (b) ``dryrun_multichip(1)``: every leg of the
               reference's dry run on a mesh of one card (``tiny`` with
               d_head 64 for the kernels) through K1 (plain and segmented,
               forward and backward) and the decode attention, each launched,
               K3 and K4 not; its OK line parsed and gated (speculative decode
               exact, the ring within 1e-4); its wall; (c)
               ``dryrun_multichip(4)`` over NCCL when the machine has 4 cards
               (else a line says so): its OK line and wall.

 24. bench — ``tst_torch.bench`` (the port's ``bench.py``) in process, its
               stdout and stderr captured, at the reference's own overrides
               TST_BENCH_STEPS=2 TST_BENCH_WARMUP=1 (``--only bench``: the
               defaults, 12 timed steps after 3; the 8B, long and decode legs
               keep their fixed counts): exactly one JSON line, the contract
               (metric, value > 0, unit, vs_baseline > 0, fine-tunes an hour >
               0, backend cuda, n_chips 1), every leg's key and no leg
               skipped; each kernel's launches as the legs' steps, remat modes
               and decode calls imply (bench_launches_want). Before it, the
               step gates (GATE_BATCHES) for each train path new to the card:
               the fold-parallel step at the bench's shape (Qwen2.5-0.5B, k=5
               x 4 rows, remat="dots"), the int8 Llama-3-8B k=2 leg
               ("dots") and the packed int8 8B leg (k=5, one row of 1024 a
               fold, remat="attn"), both on one 8-layer init of Llama-3-8B
               (LLAMA8B_GATE_LAYERS of its 32 layers).

Cut for phase 25's time (before it: phases 6 and 9 two epochs, phase 13
512 rows, 14 256, 20's generate 64 rows of 16 tokens, 22c 128 rows, step
medians over 3 steps, phase 16 and the step gates of 22a and 24's 8B
legs at full depth, the first decode step gates also compared whole
greedy continuations, reported and never gated): phases 6 and 9 run one
epoch; 13 256 rows; 14 128; 20's generate 32 rows of 8 tokens; 22c 64;
step medians over 2 steps after the first; phase 16 at 12 of 24 layers;
the step gates of 22a and of 24's 8B legs at 8 of the 32 layers
(phase 25's Qwen2.5-7B gate holds its full 28); no continuations; phase
9 without the RF cross-check (phases 6 and 22a run it). Phases 16 and 22b
keep their rows, and 22b its depth: their s(x) rank gates need them.

 25. widths — the JAX package's six other geometries (Qwen2.5-1.5B, -3B,
               -7B, Llama-3.1-8B, Llama-3.2-1B, -3B) at their published widths
               from a random init, and its serving pair: (a) K1's forward,
               dK/dV and dQ at their diagnose-sft step (32 x 512) for each
               head layout no earlier phase holds (12/2, 16/2, 28/4, 24/8 at
               D=128; 32/8 at D=64), at S=576 with 28/4 heads, and packed
               [8, 1024, 28, 128] with the packed step's starts, against the
               plain versions, bit-equal on a second call, timed beside the
               library and the bound; K3 at Qwen2.5-7B's and Llama-3.2-1B's
               seven leaves and Qwen2.5-1.5B's k/v (N=256) and down (K=8960)
               at M=32 and the verify chunk's M=160 (rows bit-equal to M=32);
               K4 at (2048, 3584, 18944); the decode attention at the draft's
               greedy step (32/8, D=64), the target's verify chunk (32/8,
               D=128, T=5), Qwen2.5-7B's (28/4) and Llama-3.2-3B's (24/8)
               steps; (b) ``diagnose-sft --preset sft-cvbench-qwen --bench
               synthetic:0.5 --set model.name=<width> --set
               model.tokenizer=byte`` (48 rows, one epoch, the RF cross-check
               off) for each width: launches as implied, every step's losses
               finite; the step's median ms, tokens/s, TFLOP/s and its share
               of 989, peak memory; the step gates on the run's own weights
               and batches. Qwen2.5-7B runs all 28 of its layers under
               ``model.remat=true`` (its saved activations would not fit the
               card); the other five run 4 of theirs (the cut: every layer of
               a width has the same shapes); (c) Qwen2.5-7B's int4
               ``eval-blind`` (synthetic-vsi:0.4, n=32) at 28 layers, its base
               the step's weights converted as a checkpoint is (each tensor
               quantized on arrival by ``quantizing_put``): launches as
               implied, letter probabilities within 0.05 of the plain
               attention, the first decode step through K3 against the plain
               path (phase 13's rule), samples/s; (d) ``generate`` with an int8
               Llama-3-8B target at 32 layers, ``--draft-model llama3.2-1b
               --draft-quantize int4`` (16 layers, D=64, tied head, x32 llama3
               RoPE scaling) and ``--gamma 4`` on 32 rows x 4 tokens: launches
               as implied, every row's tokens equal to greedy decode's on the
               same target (exact), the rounds and the acceptance.

Phase 11 also times K3 and torch's tinygemm int4 product
(``aten._weight_int4pack_mm``, bf16 scales; its library yardstick) at M=32
over a decode layer's seven projections of Qwen2.5-0.5B and of
Llama-3-8B, the library held to K3's plain version within 2e-2.

Before it, a ``[k1]`` line gives each K1 kernel's ``ratio_to_library``
(kernel ms / library ms) and ``share_of_bound`` (bound ms / kernel ms) at
the main shapes (plain and segmented), Llama-3-8B's step, the long preset's
call and the packed 8B leg, and of the non-causal kernels at the ring's
block and at Llama-3-8B's heads.

The second-to-last line is the per-kernel JSON record (launches on the
main path, error, kernel, plain and library times, and the bound: the
non-causal kernels' launches are phase 21's ring through K1 in one process,
their times phase 5b's at the ring's block; the
larger of the function's bytes over 3.35 TB/s and its operations over
989 TFLOP/s bf16, counted from this run's shapes and masks), the last line
``{"ok": true, "device": {...}}``. Imports nothing of jax or of the JAX
package ``tst``, and neither does the port it drives.
"""

import argparse
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SLICE = ["eval-blind", "--bench", "synthetic:0.5", "--set", "data.n=512",
         "--set", "model.name=qwen2.5-0.5b"]  # default --platform gpu, bf16, use_pallas
N_SAMPLES, N_LAYERS, SCORER_BATCH = 512, 24, 32
#: (B, S, H, KVH, D): the slice's own attention call, Llama-3-8B heads, one tile
KERNEL_SHAPES = [(32, 512, 14, 2, 64), (2, 2048, 32, 8, 128), (4, 128, 14, 2, 64)]
#: the kernels also at one tile (S=64), at both head dims
ONE_TILE = [(3, 64, 14, 2, 64), (2, 64, 8, 2, 128)]
#: and over several tiles with S = 64 (mod 128), where the last 128-row tile
#: of the persistent kernels ends past S (its rows arrive as zeros, unstored)
ODD_TILES = [(2, 576, 14, 2, 64), (2, 576, 8, 2, 128)]
#: and at the dry run's calls (phase 23; tiny with d_head 64): one rank's
#: train step (4/2 heads), a tensor=2 rank's scorer and prefill (2/1 heads)
DRYRUN_SHAPES = [(4, 512, 4, 2, 64), (8, 512, 2, 1, 64)]
#: the non-causal kernels (the ring's past blocks): a 128-token case, one
#: tile (S=64) at both head dims, S=576 at both (a last 128-key tile ends
#: past S, where the forward masks), the ring's block at the long preset (4
#: blocks of 4096 positions: q [10, 4096, 14, 64]) and a block of 4096 at
#: Llama-3-8B's heads
FULL_SHAPES = [(4, 128, 14, 2, 64), (3, 64, 14, 2, 64), (2, 64, 8, 2, 128),
               (2, 576, 14, 2, 64), (2, 576, 8, 2, 128), (10, 4096, 14, 2, 64),
               (1, 4096, 32, 8, 128)]
FULL_RING_SHAPE, FULL_LLAMA_SHAPE = FULL_SHAPES[-2], FULL_SHAPES[-1]
#: the plain versions at those shapes run this many batch rows a call (their
#: [S, S] f32 tensors), their times summed over the calls
FULL_PLAIN_ROWS = 2
#: the card's peaks for the bounds (NVIDIA H100 SXM data sheet: dense bf16,
#: HBM3)
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
#: bf16 output: one rounding of P and of o (|o| < 2) -> 2e-2; f32 lse -> 1e-3
O_TOL, LSE_TOL = 2e-2, 1e-3
#: and K1's o within this of max|ref| (forward_gate): a non-causal row
#: averages thousands of keys, so its |o| is ~0.01 and O_TOL alone cannot see
#: an error of tens of percent
O_REL_TOL = 2e-2
#: letter probabilities of the kernel path vs the plain path, bf16 model
PROB_TOL, ARGMAX_AGREE = 0.05, 0.95
#: the train step's attention call: 2 folds x 16 rows, Qwen2.5-0.5B heads
TRAIN_SHAPE = (32, 512, 14, 2, 64)
#: bf16 gradients against an f32 plain backward: P and dS are rounded to bf16
#: as operands, and dk/dv sum over 7 heads x up to 512 rows, so each gradient
#: is held to max|d - ref| <= 2e-2 * max|ref|
GRAD_TOL = 2e-2
#: phase 6's diagnose-sft (and phase 9's, packed): 1 epoch (3 before
#: phase 24's gates averaged batches, 2 before phase 25 took its time)
TRAIN_EPOCHS = 1
TRAIN = ["diagnose-sft", "--bench", "synthetic:0.5", "--set", "data.n=512",
         "--set", "data.k=2", "--set", "optim.batch_size=16", "--set",
         f"optim.epochs={TRAIN_EPOCHS}",
         "--set", "model.name=qwen2.5-0.5b"]  # the default rf.cross_check=true
#: rows per fold of the kernel-vs-plain step: the plain attention keeps
#: several f32 [rows, 14, 512, 512] tensors per layer for its backward
PLAIN_ROWS = 4
#: one bf16 step, kernel vs plain path: per-leaf LoRA gradient cosine, and
#: per-fold losses within LOSS_RTOL of the plain loss: bf16 rounding through
#: 24 layers moves the logits, and the loss with them, in proportion to
#: their size (~13 nats at random weights: gaps of 5.6e-3 to 7.7e-3, PERF.md).
#: The cosine rule was 0.99 until the sound paths had read >= 0.9999 on
#: every gate and every layer's attention output x 1.01 had read >= 0.9970
#: (PERF.md): 0.99 caught none of those faults
GRAD_COSINE, LOSS_RTOL = 0.999, 1e-3
#: the lowest LoRA gradient cosine each phase's step gates read (_step_gates
#: records it under the running phase; main prints it)
LOWEST_COSINE = {}
_PHASE = ["-"]
#: scale of the drawn LoRA B for that step (nonzero, so A has gradients)
B_SCALE = 0.005
#: steps a median step time is taken over, after the first (8 before phase
#: 24 took its time, 5 before its gates averaged batches, 3 before phase 25
#: took its time)
STEP_SAMPLES = 2
PACKED = ["optim.pack=true"]
#: the packed train step's attention call: 2 folds x 16 rows of 1024 tokens
PACKED_TRAIN_SHAPE = (32, 1024, 14, 2, 64)
#: the other segmented checks: Llama-3-8B heads at S=2048, 8 segments a row
#: (where the TPU dispatches its chunked K2 bodies); 128- and 64-token cases;
#: the dry run's packed step, one rank's (4/2 heads) and a tensor=2 rank's;
#: S = 576 at both head dims (ODD_TILES)
SEG_SHAPES = [(2, 2048, 32, 8, 128), (5, 128, 14, 2, 64), (5, 64, 14, 2, 64),
              (3, 64, 8, 2, 128), (2, 1024, 4, 2, 64), (2, 1024, 2, 1, 64)] + ODD_TILES
#: segment starts a row (kernel layout) and the unused slot
MAX_SEGS, SEG_PAD = 8, 1 << 30
#: packed rows per fold of the kernel-vs-plain step: the plain attention keeps
#: several f32 [rows, 14, 1024, 1024] tensors per layer for its backward
PACKED_PLAIN_ROWS = 2
#: K3 at decode's M: Path A's chunk of 32 rows; Path B's 2 folds x 32 rows
INT4_M = (32, 64)
#: K3 also held (not timed) at speculative decode's verify chunk, 32 rows x
#: (gamma + 1) = 96 at phase 20's gamma of 2, and at an M that is no multiple
#: of 8 or 32
SPEC_GAMMA = 2
#: the decode attention kernel's checks (B, T, H, KVH, D, S): a greedy step
#: of 32 rows at Qwen2.5-0.5B's heads (timed), the verify chunk, Llama-3-8B's
#: heads, a cache of the long preset (16384 slots and a generation pad), and
#: the dry run's decode: one rank's greedy step, a tensor=2 rank's verify chunk
DATTN_CASES = [(32, 1, 14, 2, 64, 640), (32, SPEC_GAMMA + 1, 14, 2, 64, 640),
               (8, SPEC_GAMMA + 1, 32, 8, 128, 640), (2, SPEC_GAMMA + 1, 14, 2, 64, 16512),
               (8, 1, 4, 2, 64, 640), (4, SPEC_GAMMA + 1, 2, 1, 64, 640)]
#: phase 20d on a bf16 target: speculative decode's gammas, rows a call (a
#: full decode chunk, and a count that is no multiple of 8) and tokens a row
BF16_SPEC_GAMMAS, BF16_SPEC_ROWS, BF16_SPEC_MAX_NEW = (2, 4), (32, 27), 8
INT4_CHECK_M = (32 * (SPEC_GAMMA + 1), 37)
#: (K, N) of Qwen2.5-0.5B's seven int4 projections, in a layer's order
QWEN_INT4 = {"wq": (896, 896), "wk": (896, 128), "wv": (896, 128), "wo": (896, 896),
             "w_gate": (896, 4864), "w_up": (896, 4864), "w_down": (4864, 896)}
#: Llama-3-8B's int4 leaves: q/o, k/v, gate/up, down
LLAMA_INT4 = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
#: the int4 group along K (tst_torch.models.quant.INT4_GROUP)
INT4_GROUP_SIZE = 128
#: the same bf16-rounded weights, f32 sums in another order
INT4_TOL = 1e-2
#: how often each of LLAMA_INT4's shapes comes in a layer (q/o, k/v,
#: gate/up, down)
LLAMA_INT4_PER_LAYER = (2, 2, 2, 1)
#: K3's library yardstick, torch's tinygemm int4 product
#: (aten._weight_int4pack_mm), against K3's plain version: its scales and
#: output are bf16 (a scale rounded to 8 bits moves a product by up to
#: 2^-9 of its size, the output's rounding as much again)
LIB_INT4_TOL = 2e-2
#: K4: the int4 train step (2 folds x 16 rows x 512 tokens), Llama-3-8B
#: widths, and an M that is no multiple of the kernel's 32-row tile
MLP_SHAPES = [(16384, 896, 4864), (2048, 4096, 14336), (1000, 896, 4864)]
#: bf16 output and h rounded to bf16 before the down product
MLP_TOL = 2e-2
#: phase 13's eval-blind: 256 rows (512 before phase 25 took its time)
DECODE_N = 256
DECODE = ["eval-blind", "--bench", "synthetic-vsi:0.4", "--set", f"data.n={DECODE_N}",
          "--set", "model.name=qwen2.5-0.5b", "--set", "model.quantize=int4"]
#: synthetic-vsi:0.4 at n=256: 192 MCQ rows and 64 numeric rows
N_MCQ_VSI, N_NUMERIC_VSI = 192, 64
#: greedy tokens of a numeric answer (the reference's max_new), the int4
#: projections of a layer, and the decode step's rows of Path A
MAX_NEW, INT4_PROJ, DECODE_ROWS = 12, 7, 32
#: the first decode step's f32 logits, K3 against the plain path on the same
#: caches: max |Δ| <= 2e-2 max |logit| (a random bf16 model of 24 layers: the
#: plain path with its f32 sums taken in another order moves its logits as
#: far, PERF.md), and no decisive first-token disagreement
#: (decisive_disagreements): the logits are near-tied, so argmax agreement
#: alone fails correct code
LOGIT_TOL = 2e-2
#: phase 14: one epoch of phase 6's geometry on 128 rows of
#: synthetic-vsi:0.4, 96 MCQ and 32 numeric (5 steps; 512 rows and 17 steps
#: before phase 24's gates averaged batches, 256 and 9 before phase 25 took
#: its time); the RF cross-check, which phase 6 runs, off (on before phase 24
#: took its time)
FUSED_ROWS, FUSED_MCQ, FUSED_NUMERIC = 128, 96, 32
TRAIN_FUSED = ([a.replace("synthetic:0.5", "synthetic-vsi:0.4").replace(
                    f"optim.epochs={TRAIN_EPOCHS}", "optim.epochs=1")
                .replace(f"data.n={N_SAMPLES}", f"data.n={FUSED_ROWS}") for a in TRAIN]
               + ["--set", "model.quantize=int4", "--set", "model.fused_mlp=true",
                  "--set", "rf.cross_check=false"])
#: the RF auditor on the planted-bias benchmark (forests traversed on the
#: card), and its IBP loop (phase 17): 128 rows each (512 before phase 24
#: took its time, 256 before its gates averaged batches; the host fit is
#: most of both phases' walls)
RF_ROWS = 128
RF = ["diagnose-rf", "--bench", "synthetic:0.5", "--set", f"data.n={RF_ROWS}", "--k", "5"]
#: the device traversal against the host one: the same trees, f32 mean over
#: trees against sklearn's f64 sum
RF_TOL = 1e-6
#: IBP with the SFT diagnostic on phase 14's mix, the train geometry of phase
#: 6 for one epoch a round (three before phase 22 took its time) on 512 rows
#: (at 256, 192 MCQ rows, round 0's rank gate read 0.99930 against 0.99964
#: at 512); stop_epsilon -1, so the loop at random weights (blind accuracy
#: near chance) still prunes every round
IBP_ROUNDS, IBP_N = 2, 512
#: at 12 of Qwen2.5-0.5B's 24 layers (all 24 before phase 25 took its time)
IBP_LAYERS = 12
IBP = ["debias-ibp", "--bench", "synthetic-vsi:0.4", "--set", f"data.n={IBP_N}", "--k", "2",
       "--set", "optim.batch_size=16", "--set", "optim.epochs=1",
       "--set", f"ibp.rounds={IBP_ROUNDS}", "--set", "ibp.stop_epsilon=-1",
       "--set", "model.name=qwen2.5-0.5b"]
#: round 0's held-out MCQ s(x), kernels against the plain attention on the
#: same adapters: the bf16 rank rule (ROADMAP, "Hold parity on the same inputs")
IBP_SPEARMAN = 0.999
IBP_RF_ROUNDS = 2
IBP_RF = ["debias-ibp", "--bench", "synthetic:0.5", "--set", f"data.n={RF_ROWS}", "--k", "3",
          "--set", "ibp.diagnostic=rf", "--set", f"ibp.rounds={IBP_RF_ROUNDS}",
          "--set", "ibp.stop_epsilon=-1"]
#: prune_mask's floor of survivors
IBP_MIN_KEEP = 8
#: Qwen/Qwen2.5-0.5B's published config.json (phase 18 writes it beside phase
#: 4's weights)
QWEN_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151643, "hidden_act": "silu", "hidden_size": 896,
    "initializer_range": 0.02, "intermediate_size": 4864, "max_position_embeddings": 32768,
    "max_window_layers": 24, "model_type": "qwen2", "num_attention_heads": 14,
    "num_hidden_layers": 24, "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 32768, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "use_cache": True, "use_sliding_window": False,
    "vocab_size": 151936}
#: meta-llama/Meta-Llama-3-8B's published config.json; phase 19 keeps
#: LLAMA_LAYERS of its 32 layers
LLAMA_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 8192,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256}
LLAMA_LAYERS = 2
#: phase 19a's attention call: 5 folds x 8 rows of 512 tokens, Llama-3-8B heads
LLAMA_STEP_SHAPE = (40, 512, 32, 8, 128)
#: phase 19a: the sft-mmmu-llama8b preset (k=5, batch 8, remat=True) from the
#: checkpoint, cut to one chip, the synthetic benchmark and one epoch
LLAMA_TRAIN = ["diagnose-sft", "--preset", "sft-mmmu-llama8b", "--bench", "synthetic:0.5",
               "--set", "model.tokenizer=byte", "--set", "mesh.data=1", "--set", "mesh.tensor=1",
               "--set", "data.n=40", "--set", "optim.epochs=1"]
#: phase 19b: eval-blind int4 through quantizing_put, numeric rows decoded
#: through K3 at Llama-3-8B's widths
LLAMA_BLIND_INT4 = ["eval-blind", "--bench", "synthetic-vsi:0.4", "--set", "data.n=64",
                    "--set", "model.name=llama3-8b", "--set", "model.tokenizer=byte",
                    "--set", "model.quantize=int4"]
#: phase 19c: synthetic [C, T] option sequences for the multi-token scorer,
#: all of T=3 tokens (options of unequal length would let the shortest take
#: nearly all the probability at random weights, about ln(vocab) nats a
#: token, whatever the attention computed), and the rows it scores
MULTI_OPTIONS = [[65, 66, 67], [66, 68, 69], [69, 70, 65], [70, 71, 72]]
MULTI_ROWS = 16
#: the multi-token scorer's rows a chunk (the reference's cap)
MULTI_BATCH = 8
#: phase 20a: phase 6's training (k=2 x 16 rows, LoRA r16 q/k/v/o, n=512) for
#: one epoch, checkpointed under checkpoint_dir (the RF cross-check, which
#: phase 6 runs, is off)
SERVE_TRAIN = ([a.replace(f"optim.epochs={TRAIN_EPOCHS}", "optim.epochs=1") for a in TRAIN]
               + ["--set", "rf.cross_check=false"])
SERVE_EPOCH_DIR = "seed_0_epoch_000"
#: phase 20a's in-process resume: steps, the failure after step 3, a
#: checkpoint every 2 steps; the fallback gate if the resume is not bit-equal
RESUME_STEPS, RESUME_FAIL, RESUME_EVERY, RESUME_COSINE = 6, 3, 2, 0.999
#: phase 20c-d: generate on an int4 base with the trained adapter, and again
#: with the target's own config as an int4 draft
GEN_MAX_NEW, GEN_ROWS = 8, 32
SERVE_GEN = ["generate", "--bench", "synthetic-vsi:0.4", "--set", f"data.n={GEN_ROWS}",
             "--set", "model.name=qwen2.5-0.5b", "--set", "model.quantize=int4",
             "--max-new", str(GEN_MAX_NEW)]
SERVE_SPEC = SERVE_GEN + ["--draft-model", "qwen2.5-0.5b", "--draft-quantize", "int4",
                          "--gamma", str(SPEC_GAMMA)]
#: phase 21: K1 held to its plain version at long S (q [1, S, h, 64], one KV
#: head: its GQA group of 7 at 16384, one query head at 32768, as far as the
#: plain version's [S, S] f32 tensors fit) and timed at the preset's full
#: call, k=5 folds x batch 2 rows of 16384 tokens at Qwen2.5-0.5B's heads
LONG_CHECKS = ((16384, 7), (32768, 1))
LONG_SHAPE = (10, 16384, 14, 2, 64)
#: the ring's arithmetic at S=16384: 4 blocks of 4096, the ranks' step in one
#: process; its output and gradients against K1's at this cosine
LONG_RING_BLOCKS, LONG_RING_COSINE = 4, 0.999
#: each ring's wall: the median of this many warmed calls (forward and
#: backward; CUDA events), after the call that is checked and counted
RING_WALL_SAMPLES = 3
#: the preset through the CLI (BASELINE config 4): synthetic rows with
#: ~16,000-byte transcripts, the byte tokenizer (the preset's HF tokenizer
#: needs a download) and remat (one layer's saves at 163,840 tokens would be
#: ~6.5 GB, ~157 GB over 24 layers); 6 rows (8 before phase 24 took its
#: time), one epoch: 3 steps of 2 rows a fold; the RF cross-check off
LONG_ROWS, LONG_CONTEXT_BYTES = 6, 16000
LONG_TRAIN = ["diagnose-sft", "--preset", "sft-videomme-long", "--set", "model.tokenizer=byte",
              "--set", "model.remat=true", "--set", "optim.epochs=1",
              "--set", "rf.cross_check=false"]
#: phase 22: Llama-3-8B at all 32 of its layers from a random init on the
#: card (no checkpoint), the byte tokenizer (the presets' HF tokenizer needs
#: a download) and the mesh of one card
LLAMA8B_ONE_CARD = ["--set", "model.tokenizer=byte", "--set", "mesh.data=1",
                    "--set", "mesh.tensor=1"]
#: (a) the sft-mmmu-llama8b preset (k=5, batch 8, remat=True): 20 rows (80
#: before phase 24 took its time, 40 before its gates averaged batches), one
#: epoch of fold-parallel steps of 40 rows x 512 tokens; its step gate takes
#: the first 8 batches of 4 rows a fold of the preset at LLAMA8B_GATE_ROWS,
#: at LLAMA8B_GATE_LAYERS of the 32 layers (all 32 before phase 25 took its
#: time; phase 25's Qwen2.5-7B gate runs all 28 of its layers)
LLAMA8B_ROWS, LLAMA8B_GATE_ROWS, LLAMA8B_GATE_LAYERS = 20, 40, 8
LLAMA8B_TRAIN = ["diagnose-sft", "--preset", "sft-mmmu-llama8b", "--bench", "synthetic:0.5",
                 *LLAMA8B_ONE_CARD, "--set", f"data.n={LLAMA8B_ROWS}", "--set",
                 "optim.epochs=1"]
#: (b) the ibp-vsibench preset (k=5, remat=True, prune_rate 0.1, the SFT
#: diagnostic): 60 rows, one epoch, one round that prunes (2 before phase 24
#: took its time; phase 16 runs two), all 32 layers. At 40 rows (30 MCQ
#: rows) round 0's rank gate read 0.99733, at 16 layers 0.99895, against
#: 0.99974 as it stands: too little for the bf16 rank rule
LLAMA8B_IBP_ROUNDS, LLAMA8B_IBP_N = 1, 60
LLAMA8B_IBP = ["debias-ibp", "--preset", "ibp-vsibench", "--bench", "synthetic-vsi:0.4",
               *LLAMA8B_ONE_CARD, "--set", f"data.n={LLAMA8B_IBP_N}", "--set", "optim.epochs=1",
               "--set", f"ibp.rounds={LLAMA8B_IBP_ROUNDS}", "--set", "ibp.stop_epsilon=-1"]
#: (c) eval-blind on an int4 base quantized after the init: 48 MCQ rows and
#: 16 numeric rows decoded through K3 at Llama's widths (96 and 32 before
#: phase 25 took its time)
LLAMA8B_INT4 = ["eval-blind", "--bench", "synthetic-vsi:0.4", "--set", "data.n=64",
                "--set", "model.name=llama3-8b", "--set", "model.quantize=int4"]
LLAMA8B_LAYERS = 32
#: the card's dense bf16 peak, for the step's share of it
PEAK_TFLOPS = PEAK_BF16_FLOPS / 1e12
#: phase 23: the kernels every leg of the dry run goes through on the card
#: (K1's forward and backward, plain and segmented, the decode attention);
#: K3 and K4 are off its path (an unquantized base, no fused MLP)
DRYRUN_KERNELS = ("fwd", "dkv", "dq", "fwd_seg", "dkv_seg", "dq_seg", "dattn")
DRYRUN_OFF_PATH = ("int4", "mlp")
#: the cards the dry run's four-rank run needs
DRYRUN_CARDS = 4
#: entry()'s logits: the kernel path's distance from the f32 plain forward
#: within ENTRY_ERR_RATIO times the bf16 plain path's own distance from it,
#: plus ENTRY_ERR_EPS · max|logit| (K1 no worse than the plain bf16
#: attention, whatever bf16 rounding over 24 random layers amounts to)
ENTRY_ERR_RATIO, ENTRY_ERR_EPS = 1.25, 1e-3
#: phase 24: the bench (tst_torch.bench) in the full run at the reference's
#: own step overrides (its 8B, long and decode legs keep their fixed counts);
#: ``--only bench`` runs its defaults (12 timed steps after 3)
BENCH_ENV = {"TST_BENCH_STEPS": "2", "TST_BENCH_WARMUP": "1"}
#: the step gates (phases 7, 10, 14, 22a, 24) hold a path's per-fold losses
#: and LoRA gradients, averaged over its first batches, to one rule
#: (_step_gates). One batch's fold loss is a handful of answer tokens, where
#: bf16 rounding alone moves it by up to 1.75e-03 (kernels against the plain
#: path). Each gate averages the fewest of 1, 2, 4 or 8 batches at which its
#: largest reading over two adapter seeds is at most half of LOSS_RTOL, and 8
#: where none is (the fused MLP's, 5.48e-04 at 8: K4 against the unfused MLP
#: moves one seed's losses by a steady 5e-04 to 8e-04). The readings, of
#: scripts/torch_step_loss_noise.py, are in PERF.md
GATE_BATCHES = {"train": 8, "packed": 2, "fused": 8, "llama8b": 8,
                "qwen": 4, "llama8b_k2": 8, "llama8b_packed_k5": 4, "widths": 8}
#: the bench's fold-parallel attention call (k=5 x 4 rows, Qwen2.5-0.5B
#: heads), in the kernel checks of phases 3 and 5
BENCH_SHAPES = [(20, 512, 14, 2, 64)]
#: the bench's packed 8B leg whose segmented kernels phase 8 also times
BENCH_SEG_TIMED = (5, 1024, 32, 8, 128)
#: the record's keys that every leg run on the card writes beside the
#: contract's (bench_record_gate)
BENCH_LEG_KEYS = (
    "unpacked_samples_per_sec_per_chip", "fold_sequential_samples_per_sec_per_chip",
    "compile_s_fold_parallel", "compile_cache_hit_fold_parallel", "compile_s_single_fold",
    "step_hbm_gb", "mfu", "tflops_per_s", "packed_samples_per_sec_per_chip", "pack_len",
    "pack_fill_fraction", "pack_batch_rows_per_fold", "packed_mfu",
    "llama3_8b_int8_samples_per_sec_per_chip", "llama3_8b_mfu", "llama3_8b_base_hbm_gb",
    "llama3_8b_step_hbm_gb", "llama3_8b_k5_fold_parallel_samples_per_sec_per_chip",
    "llama3_8b_packed_samples_per_sec_per_chip", "llama3_8b_k5_packed_samples_per_sec_per_chip",
    "llama3_8b_int4_decode_step_tokens_per_s", "longseq_tokens_per_s", "longseq_len",
    "longseq_32k_tokens_per_s", "decode_tokens_per_s", "decode_batch",
    "decode_step_tokens_per_s")
#: phase 25 (widths): the JAX package's six other geometries
#: (tst/models/decoder.py:85-120; tst_torch/models/spec.py), each at its
#: published widths from a random init on the card (no download), the byte
#: tokenizer, sft-cvbench-qwen's diagnose-sft (k=2 x 16 rows of 512)
WIDTHS = ("qwen2.5-1.5b", "qwen2.5-3b", "qwen2.5-7b", "llama3.1-8b", "llama3.2-1b",
          "llama3.2-3b")
#: Qwen2.5-7B, the largest, runs all 28 of its layers (under full remat: its
#: saved activations at 32 x 512 tokens, ~3 GB a layer, would not fit); the
#: others WIDTHS_LAYERS of theirs: every layer of a width has the same
#: shapes, so depth adds no kernel coverage
WIDTHS_FULL, WIDTHS_LAYERS = "qwen2.5-7b", 4
#: their diagnose-sft runs: 48 rows, one epoch (2 steps of 2 x 16 rows; the
#: step gates' 8 batches of 4 rows a fold cut from them), the RF cross-check
#: off
WIDTHS_ROWS = 48
#: K1 at the widths' step (B, S) for each head layout no other phase checks
#: (widths_k1_shapes), S = 576 at group 7 and D=128 (ODD_TILES' case), and
#: packed rows of 1024 at Qwen2.5-7B's heads with the first rows of the
#: packed step's own starts
WIDTHS_STEP_BS = (32, 512)
WIDTHS_ODD = (2, 576, 28, 4, 128)
WIDTHS_PACKED = (8, 1024, 28, 4, 128)
#: the reference's serving pair (tst/cli.py:311-313, scripts/probe_spec_decode.py:13):
#: an int8 Llama-3-8B target at 32 layers, a Llama-3.2-1B draft at 16 layers
#: stored int4 (K3 at its 2048 width), gamma 4, 32 rows, 4 tokens a row (the
#: int8 target's verify chunk runs its products a position at a time, ~0.1 s
#: each, and random weights reject every draft token: one token a round)
PAIR_TARGET, PAIR_DRAFT, PAIR_GAMMA, PAIR_ROWS, PAIR_MAX_NEW = (
    "llama3-8b", "llama3.2-1b", 4, 32, 4)
PAIR_GEN = ["generate", "--bench", "synthetic-vsi:0.4", "--set", f"data.n={PAIR_ROWS}",
            "--set", f"model.name={PAIR_TARGET}", "--set", "model.quantize=int8",
            "--set", "model.tokenizer=byte", "--max-new", str(PAIR_MAX_NEW),
            "--draft-model", PAIR_DRAFT, "--draft-quantize", "int4",
            "--gamma", str(PAIR_GAMMA)]
#: K3 at the new leaves: Qwen2.5-7B's seven, Qwen2.5-1.5B's k/v (N=256) and
#: down (K=8960), Llama-3.2-1B's seven (the pair's draft); at a greedy step's
#: M and the pair's verify chunk's, 32 x (gamma + 1)
WIDTHS_INT4 = {"qwen2.5-7b": None, "qwen2.5-1.5b": ("wk", "wv", "w_down"),
               "llama3.2-1b": None}
WIDTHS_INT4_M = (32, 32 * (PAIR_GAMMA + 1))
#: K4 at Qwen2.5-7B's MLP, at the M of MLP_SHAPES' Llama-3-8B case
WIDTHS_MLP = (2048, 3584, 18944)
#: the decode attention at the draft's greedy step (32/8 heads, D=64), the
#: target's verify chunk (32/8, D=128, T = gamma + 1), Qwen2.5-7B's and
#: Llama-3.2-3B's greedy steps
WIDTHS_DATTN = [(32, 1, 32, 8, 64, 640), (32, PAIR_GAMMA + 1, 32, 8, 128, 640),
                (32, 1, 28, 4, 128, 640), (32, 1, 24, 8, 128, 640)]
#: phase 25's Qwen2.5-7B int4 eval-blind: 24 MCQ rows and 8 numeric rows
WIDTHS_BLIND = ["eval-blind", "--bench", "synthetic-vsi:0.4", "--set", "data.n=32",
                "--set", f"model.name={WIDTHS_FULL}", "--set", "model.tokenizer=byte",
                "--set", "model.quantize=int4"]
#: safetensors' dtype names
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
              torch.int8: "I8", torch.uint8: "U8"}
#: our parameter names → HF's (Llama / Qwen2), and whether HF stores them
#: transposed ([out, in])
_HF_LAYER = {"attn_norm": ("input_layernorm.weight", False),
             "wq": ("self_attn.q_proj.weight", True), "wk": ("self_attn.k_proj.weight", True),
             "wv": ("self_attn.v_proj.weight", True), "wo": ("self_attn.o_proj.weight", True),
             "bq": ("self_attn.q_proj.bias", False), "bk": ("self_attn.k_proj.bias", False),
             "bv": ("self_attn.v_proj.bias", False),
             "mlp_norm": ("post_attention_layernorm.weight", False),
             "w_gate": ("mlp.gate_proj.weight", True), "w_up": ("mlp.up_proj.weight", True),
             "w_down": ("mlp.down_proj.weight", True)}
_HF_TOP = {"embed": ("model.embed_tokens.weight", False),
           "final_norm": ("model.norm.weight", False), "lm_head": ("lm_head.weight", True)}


def median_ms(fn, samples=30, reps=10, warmup=3):
    """Median over ``samples`` CUDA-event timings of ``reps`` back-to-back
    calls, per call: the host's launch overhead hides behind the device
    work, as it does inside the model."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


#: a flash-attention kernel's mangled name: which kernel (``_tiled``: the
#: 64-row forward, dK/dV and dQ, kept where they are faster), D, and its bool
#: template arguments (kSeg, kCausal; the persistent dK/dV and dQ kernels
#: have no kSeg: they serve unsegmented rows only; an absent kCausal is
#: causal)
_FLASH_KERNEL = re.compile(
    r"flash_(?:bwd_)?(fwd|dkv|dq)(_tiled)?_kernelILi(\d+)E((?:Lb[01]E)*)")
#: the attention kernels the C entries launch, one for each of {fwd, dkv, dq}
#: x D {64, 128} x {causal, seg, full (non-causal)}: the 64-row forward for
#: packed rows at D=64, the 64-key dK/dV for packed rows and at D=128, the
#: 64-row dQ for packed rows and non-causal at D=128, the persistent ones
#: elsewhere
ATTENTION_KERNELS = frozenset({
    "fwd<D=64>", "fwd<D=128>", "fwd_tiled<D=64, seg>", "fwd<D=128, seg>",
    "dkv<D=64>", "dkv_tiled<D=128>", "dkv_tiled<D=64, seg>", "dkv_tiled<D=128, seg>",
    "dq<D=64>", "dq<D=128>", "dq_tiled<D=64, seg>", "dq_tiled<D=128, seg>",
    "fwd<D=64, full>", "fwd<D=128, full>", "dkv<D=64, full>", "dkv_tiled<D=128, full>",
    "dq<D=64, full>", "dq_tiled<D=128, full>"})
N_ATTENTION_KERNELS = len(ATTENTION_KERNELS)
#: K4's two kernels, which must run their products on wgmma too
K4_KERNELS = ("swiglu_gate_up_kernel", "swiglu_down_kernel")
_K4_KERNEL = re.compile(r"\d+(" + "|".join(K4_KERNELS) + r")(?=E|I)")


def kernel_name(mangled):
    """A short name for a kernel's mangled name: ``fwd<D=64, seg>`` (or
    ``, full`` when non-causal) for the attention kernels, else the last name
    of the nested name with its int template arguments
    (``fused_mlp_kernel<8>``, ``int4_matmul_kernel<2, 4>``)."""
    m = _FLASH_KERNEL.search(mangled)
    if m:
        kernel = m[1] + (m[2] or "")
        names = ("causal",) if kernel in ("dkv", "dq") else ("seg", "causal")
        flags = dict(zip(names, re.findall(r"Lb([01])E", m[4])))
        return (f"{kernel}<D={m[3]}{', seg' if flags.get('seg') == '1' else ''}"
                f"{', full' if flags.get('causal') == '0' else ''}>")
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while m := re.match(r"\d+", mangled[i:]):
        i += len(m[0])
        name, i = mangled[i:i + int(m[0])], i + int(m[0])
    m = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    return f"{name}<{', '.join(re.findall(r'Li(\d+)E', m[1]))}>" if m else name


def hgmma_counts(sass):
    """HGMMA (wgmma) instructions in each attention kernel and each K4
    kernel of a ``cuobjdump -sass`` listing, by short name."""
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = _FLASH_KERNEL.search(ln)
            k4 = _K4_KERNEL.search(ln)
            name = kernel_name(m[0]) if m else (k4[1] if k4 else None)
            if name:
                counts[name] = 0
        elif name and "HGMMA" in ln:
            counts[name] += 1
    return counts


def check_hgmma(counts):
    """The listing's attention kernels must be exactly those the C entries
    launch (ATTENTION_KERNELS: none built and never launched), and each of
    them and both K4 kernels must run its products on wgmma."""
    attention = {k for k in counts if k not in K4_KERNELS}
    if (attention != ATTENTION_KERNELS or any(k not in counts for k in K4_KERNELS)
            or min(counts.values(), default=0) == 0):
        raise AssertionError(f"the {N_ATTENTION_KERNELS} attention kernels "
                             f"{sorted(ATTENTION_KERNELS)} (and no other) and the K4 kernels "
                             f"{K4_KERNELS} must each run its products on wgmma: {counts}")


def ptxas_usage(log):
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v`` log,
    by short name."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", ln)
        if m:
            name = kernel_name(m[1])
            usage.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if name and m:
            usage[name]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            usage[name]["registers"] = int(m[1])
    return usage


def decisive_disagreements(lk, lp, tol=LOGIT_TOL):
    """First-token disagreements of one chunk's f32 logits [rows, vocab],
    the kernel path ``lk`` against the plain path ``lp``: (rows whose argmax
    differs, the decisive ones among them, the plain path's top-2 gap on each
    differing row). A disagreement is decisive when that gap exceeds twice
    the largest error the logit gate lets through, ``tol · max|lp|``: an
    error within the tolerance could not have flipped the row. (Twice the
    chunk's own max |lk - lp| would count 0 by construction: a row flips only
    where its gap is at most twice its own largest error.)"""
    differ = lk.argmax(-1) != lp.argmax(-1)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decisive = differ & (gap > 2 * tol * lp.abs().max())
    return int(differ.sum()), int(decisive.sum()), gap[differ].tolist()


def fold_losses_agree(loss_k, loss_p):
    """(max over folds of |loss_k - loss_p| / |loss_p|, whether it is within
    LOSS_RTOL); NaN fails."""
    k, p = np.asarray(loss_k, np.float64), np.asarray(loss_p, np.float64)
    gap = float(np.max(np.abs(k - p) / np.abs(p)))
    return gap, bool(gap <= LOSS_RTOL)


def strict_json(text):
    """``json.loads`` that refuses NaN and ±Infinity, which Python's json
    writes and a strict reader rejects."""
    def refuse(name):
        raise ValueError(f"not strict JSON: {name}")

    return json.loads(text, parse_constant=refuse)


def check_audit(report, n):
    """An IBP report's rounds add up: round 0 starts from all ``n`` rows,
    each round's n_alive is the previous round's less what it pruned, and
    the last round's less what it pruned is n_debiased."""
    rows = report["per_round"]
    alive = [row["n_alive"] for row in rows]
    pruned = [row.get("pruned_this_round", 0) for row in rows]
    want = [n] + [a - p for a, p in zip(alive, pruned)]
    if not rows or alive + [report["n_debiased"]] != want:
        raise AssertionError(f"IBP audit does not add up: n_alive {alive}, pruned {pruned}, "
                             f"n_debiased {report['n_debiased']}, n {n}")


def check_split(n, kept_ids, removed_ids, sx_rows):
    """debiased.jsonl and removed.jsonl partition the ``n`` rows, and the
    ``kept`` column of sx.jsonl names the same rows."""
    kept, removed = set(kept_ids), set(removed_ids)
    sx_kept = {r["id"] for r in sx_rows if r["kept"] == 1.0}
    sx_removed = {r["id"] for r in sx_rows if r["kept"] == 0.0}
    if (len(kept_ids) + len(removed_ids) != n or kept & removed or len(sx_rows) != n
            or sx_kept != kept or sx_removed != removed):
        raise AssertionError(f"IBP split: {len(kept_ids)} kept + {len(removed_ids)} removed "
                             f"of {n}; sx.jsonl {len(sx_rows)} rows, {len(sx_kept)} kept, "
                             f"{len(sx_removed)} removed")


def ibp_launches_want(plan, n_layers=N_LAYERS, remat=False):
    """The attention kernels' launches that IBP rounds imply, each round of
    ``plan`` given as its train steps, scorer chunks and decode prefill
    chunks (summed over the round's seeds and scoring passes): one forward a
    layer for each step (two under full remat, as sft_launches_want), chunk
    and prefill, one dK/dV and one dQ a layer for each step, the decode
    attention a layer in each decode step after a prefill's (MAX_NEW
    tokens), and nothing else."""
    steps = sum(p["steps"] for p in plan)
    fwd = (steps * (2 if remat in (True, "full", "dots") else 1)
           + sum(p["scorer_chunks"] + p["decode_chunks"] for p in plan))
    decode = sum(p["decode_chunks"] for p in plan)
    return {"fwd": n_layers * fwd, "dkv": n_layers * steps, "dq": n_layers * steps,
            "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0, "int4": 0, "mlp": 0,
            "dattn": n_layers * (MAX_NEW - 1) * decode}


def check_launches(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")


def same_ranking(s_dev, s_host, tol=2 * RF_TOL):
    """The host s(x)'s order (most biased first, NaN last, ties by index)
    sorts the device s(x) too: NaN in the same rows, and no later row above
    an earlier one by more than ``tol`` (what the traversals' rounding can
    move)."""
    s_dev, s_host = np.asarray(s_dev, np.float64), np.asarray(s_host, np.float64)
    if not np.array_equal(np.isnan(s_dev), np.isnan(s_host)):
        return False
    order = np.argsort(-np.where(np.isnan(s_host), -np.inf, s_host), kind="stable")
    ranked = s_dev[order][np.isfinite(s_dev[order])]
    return bool(np.all(np.diff(ranked) <= tol))


def pruned_as_implied(report, rate, min_keep=IBP_MIN_KEEP):
    """Every round pruned prune_mask's budget, round(rate · n_alive) capped
    at n_alive - min_keep: what a set with a finite s(x) on every row
    implies."""
    return all(row.get("pruned_this_round") == min(int(round(rate * row["n_alive"])),
                                                   row["n_alive"] - min_keep)
               for row in report["per_round"])


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tst_torch.runtime.device import select_device

    device = select_device("gpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)  # name, power limit: exactly as nvidia-smi reports them
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    return device


def phase_build(sass=True):
    """Build the kernels; print each one's registers and spills, and (with
    ``sass``) hold the attention and K4 kernels to wgmma → nvcc's seconds."""
    from tst_torch.kernels import _build

    res = _build.build()
    usage = ptxas_usage(res.log)
    print(f"[build] {res.path.name} nvcc {res.seconds:.1f} s; registers and spill bytes: "
          f"{json.dumps(usage)}")
    for ln in res.log.splitlines():
        if "warning" in ln:
            print(f"[build] ptxas: {ln.strip()}")
    if not sass:
        return res.seconds
    # wgmma in the attention kernels: HGMMA instructions in each one's SASS
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    counts = hgmma_counts(subprocess.run([cuobjdump, "-sass", str(res.path)], check=True,
                                         capture_output=True, text=True).stdout)
    print(f"[build] HGMMA instructions in the attention and K4 kernels' SASS: {counts}")
    check_hgmma(counts)
    return res.seconds


def phase_kernel(device):
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for b, s, h, kvh, d in KERNEL_SHAPES + ONE_TILE + ODD_TILES + DRYRUN_SHAPES + BENCH_SHAPES:
        rng = np.random.default_rng(s + d)
        q, k, v = (torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32))
                   .to(device, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        o, lse = tfa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention(q, k, v), (o, lse), "the forward kernel")
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = o_err <= O_TOL and lse_err <= LSE_TOL and bool(torch.isfinite(o).all())
        print(f"[kernel] B={b} S={s} H={h} KVH={kvh} D={d}: max|o-ref| {o_err:.3e} "
              f"(<= {O_TOL}), max|lse-ref| {lse_err:.3e} (<= {LSE_TOL})")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version "
                                 f"at {(b, s, h, kvh, d)}")
        if (b, s, h, kvh, d) == KERNEL_SHAPES[0]:
            out["max_abs_err"] = o_err
            out["ms"] = median_ms(lambda: tfa.flash_attention(q, k, v))
            out["plain_ms"] = median_ms(lambda: tfa.flash_attention_reference(q, k, v),
                                        samples=10, reps=3, warmup=1)
    bad = torch.zeros(1, 100, 2, 64, device=device, dtype=torch.bfloat16)
    try:
        tfa.flash_attention(bad, bad, bad)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention accepted S=100")
    print(f"[kernel] bit-equal on a second call at every shape; S=100 rejected; slice shape "
          f"{KERNEL_SHAPES[0]}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms "
          f"(median of 30 x 10 calls)")
    return out


def _randn(rng, shape, device):
    """Normal(0, 0.5) of ``shape`` in bf16, drawn on ``device`` by a torch
    generator seeded from ``rng`` (one draw of it a call): the inputs follow
    the phase's seed, with no host pass over them (numpy's f64 draws of
    the long and 8B shapes' inputs were the run's largest host cost)."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 62)))
    return (torch.randn(shape, generator=gen, device=device) * 0.5).to(torch.bfloat16)


def _rel_err(got, want):
    """max |got - want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _bound(flops, nbytes):
    """The least time the card could take: the larger of the operations over
    the bf16 peak and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _attention_bounds(q, k, seg=None, causal=True):
    """Bounds of the forward, the dK/dV and the dQ functions at these
    shapes: products over the (query, key) pairs the mask keeps (causal,
    and packed within each segment: this run's starts; every pair when not
    ``causal``), 2·D operations a pair each: forward Q·Kᵀ, P·V; dK/dV Sᵀ,
    dPᵀ, dV, dK; dQ S, dP, dQ."""
    import tst_torch.kernels.flash_attention as tfa

    b, s, h, d = q.shape
    if not causal:
        pairs = b * h * s * s
    elif seg is None:
        pairs = b * h * s * (s + 1) // 2
    else:
        start = tfa.segment_starts_per_pos(seg, s).long()
        pairs = h * int((torch.arange(s, device=seg.device) - start + 1).sum().item())
    qb, kvb, stat = q.numel() * 2, k.numel() * 2 * 2, b * h * s * 4
    segb = 0 if seg is None else seg.numel() * 4
    return {"fwd": _bound(4 * d * pairs, 2 * qb + kvb + stat + segb),
            "dkv": _bound(8 * d * pairs, 2 * qb + 2 * kvb + 2 * stat + segb),
            "dq": _bound(6 * d * pairs, 3 * qb + kvb + 2 * stat + segb)}


def _sdpa_yardstick(q, k, v, do, o, mask=None, samples=30, reps=10, causal=True):
    """library_ms of the attention function: one call of torch's
    scaled_dot_product_attention on [B, H, S, D] views of the same q, k, v
    (causal, every key when not ``causal``, or the boolean [B, 1, S, S]
    segment mask), and its backward
    (``torch.autograd.grad`` of o on its graph) timed alone. The backend is
    pinned, the first of flash, cuDNN and memory-efficient that runs (flash
    takes no mask); GQA through ``enable_gqa``, else k and v expanded to H
    heads outside the timed region. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = q.shape[2] // k.shape[2]
    backends = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    if mask is None:
        backends.insert(0, SDPBackend.FLASH_ATTENTION)
    for backend in backends:
        for gqa in (True, False):
            qh = q.transpose(1, 2).detach().requires_grad_()
            kh, vh = (t.transpose(1, 2) if gqa else t.transpose(1, 2).repeat_interleave(g, 1)
                      for t in (k, v))
            kh, vh = kh.detach().requires_grad_(), vh.detach().requires_grad_()
            doh = do.transpose(1, 2)
            kw = ({"is_causal": causal} if mask is None else {"attn_mask": mask[:, None]})
            if gqa:
                kw["enable_gqa"] = True
            try:
                with sdpa_kernel(backend):
                    oh = sdpa(qh, kh, vh, **kw)
                    torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            with sdpa_kernel(backend):
                with torch.no_grad():
                    fwd_ms = median_ms(lambda: sdpa(qh, kh, vh, **kw), samples, reps)
                bwd_ms = median_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                                               retain_graph=True), samples, reps)
            err = (oh.detach().transpose(1, 2).float() - o.float()).abs().max().item()
            if err > O_TOL:
                raise AssertionError(f"scaled_dot_product_attention disagrees with the kernel's "
                                     f"o: {err:.3e}")
            return {"backend": backend.name,
                    "gqa": "enable_gqa" if gqa else "k, v expanded to H heads, untimed",
                    "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "max_abs_o_diff": err}
    raise AssertionError("no scaled_dot_product_attention backend ran")


def _check_bitwise(fn, got, what="the backward kernels"):
    """A second call of ``fn`` must give bit-equal outputs (no atomics, one
    fixed summation order)."""
    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: not bit-reproducible")


def clocks_now():
    """The card's SM clock and power draw as nvidia-smi reads them (reading
    only: the spread of a kernel's times between calls, beside its clock)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    return out.strip().splitlines()[0] if out.strip() else None


def k1_summary(rows):
    """Each K1 row's ``ratio_to_library`` (kernel ms / library ms; None where
    no library call was timed) and ``share_of_bound`` (bound ms / kernel
    ms), and the card's SM clock and power draw read just after the row's
    timing where the row holds them (dQ's), by the row's key."""
    return {key: {"ratio_to_library": (None if r.get("library_ms") is None
                                       else r["ms"] / r["library_ms"]),
                  "share_of_bound": r["bound_ms"] / r["ms"],
                  **({"clocks_sm_power": r["clocks_sm_power"]} if "clocks_sm_power" in r
                     else {})} for key, r in rows.items()}


def phase_kernel_bwd(device):
    """The dK/dV and dQ kernels against the plain backward (f32, same o and
    lse), and gradients through the autograd Function against autograd of
    the plain attention, at the forward's three shapes."""
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for b, s, h, kvh, d in KERNEL_SHAPES + ONE_TILE + ODD_TILES + DRYRUN_SHAPES + BENCH_SHAPES:
        rng = np.random.default_rng(s + d + 1)
        q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
        k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
        o, lse = tfa.flash_attention(q, k, v)
        di = tfa.backward_row_stat(o, do)
        got = tfa.flash_attention_backward(q, k, v, lse, di, do)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention_backward(q, k, v, lse, di, do), got)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float())
        errs = [_rel_err(g, w) for g, w in zip(got, want)]

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
        tfa.flash_attention(*leaves)[0].backward(do)
        if (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) != (before[0] + 1, before[1] + 1):
            raise AssertionError("the autograd Function's backward did not launch both kernels")
        plain = [t.detach().requires_grad_() for t in (q, k, v)]
        tfa.masked_attention(*plain, torch.ones(s, s, dtype=torch.bool, device=device).tril()
                             )[0].backward(do)
        torch.cuda.synchronize()
        auto_errs = [_rel_err(a.grad, p.grad) for a, p in zip(leaves, plain)]
        finite = all(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for g in got)
        print(f"[kernel-bwd] B={b} S={s} H={h} KVH={kvh} D={d}: max|d-ref|/max|ref| "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; through autograd vs "
              f"plain attention dq {auto_errs[0]:.3e} dk {auto_errs[1]:.3e} "
              f"dv {auto_errs[2]:.3e} (each <= {GRAD_TOL})")
        if not finite or max(errs + auto_errs) > GRAD_TOL:
            raise AssertionError(f"flash-attention backward disagrees with its plain "
                                 f"version at {(b, s, h, kvh, d)}")
        if (b, s, h, kvh, d) == TRAIN_SHAPE:
            plain_ms = median_ms(lambda: tfa.flash_attention_backward_reference(
                q, k, v, o, lse, do), samples=10, reps=3, warmup=1)
            lib = _sdpa_yardstick(q, k, v, do, o)
            bounds = _attention_bounds(q, k)
            out["dkv"] = {"max_abs_err": (got[1].float() - want[1]).abs().max().item(),
                          "ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di)),
                          "plain_ms": plain_ms, "library_ms": lib["bwd_ms"], **bounds["dkv"]}
            out["dq"] = {"max_abs_err": (got[0].float() - want[0]).abs().max().item(),
                         "ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di)),
                         "plain_ms": plain_ms, "library_ms": lib["bwd_ms"], **bounds["dq"],
                         "clocks_sm_power": clocks_now()}
            out["fwd"] = {"library_ms": lib["fwd_ms"], **bounds["fwd"]}
            both_ms = median_ms(lambda: tfa.flash_attention_backward(
                q, k, v, lse, tfa.backward_row_stat(o, do), do))
    bad = torch.zeros(1, 100, 2, 64, device=device, dtype=torch.bfloat16)
    lse_bad = torch.zeros(1, 2, 100, device=device)
    try:
        tfa.flash_attention_backward(bad, bad, bad, lse_bad, lse_bad, bad)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention_backward accepted S=100")
    dkv, dq = out["dkv"], out["dq"]
    print(f"[kernel-bwd] bit-equal on a second call at every shape; S=100 rejected; train "
          f"shape {TRAIN_SHAPE}: dkv {dkv['ms']:.4f} ms (bound {dkv['bound_ms']:.4f}, "
          f"{dkv['bound_by']}) + dq {dq['ms']:.4f} ms (bound {dq['bound_ms']:.4f}, "
          f"{dq['bound_by']}); wrapper (di, checks, both kernels) {both_ms:.4f} ms; plain "
          f"backward {plain_ms:.4f} ms; scaled_dot_product_attention ({lib['backend']}, "
          f"{lib['gqa']}; max|o-o_kernel| {lib['max_abs_o_diff']:.3e}): backward alone "
          f"{lib['bwd_ms']:.4f} ms, forward {lib['fwd_ms']:.4f} ms (forward kernel bound "
          f"{out['fwd']['bound_ms']:.4f}, {out['fwd']['bound_by']}) (median of 30 x 10 calls)")
    return out


def phase_kernel_full(device):
    """Phase 5b: the non-causal (causal=False) forward, dK/dV and dQ kernels
    at FULL_SHAPES through k1_case (their plain versions over
    FULL_PLAIN_ROWS rows a call); at the ring's block [10, 4096, 14, 64] and
    at Llama-3-8B's heads each timed beside scaled_dot_product_attention
    (is_causal=False, enable_gqa), the bound and the plain version; S=100
    and seg_starts with causal=False raise. → the records' numbers at the
    ring's block (and ``llama_shape``)."""
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for shape in FULL_SHAPES:
        b, s, h, kvh, d = shape
        timed = shape in (FULL_RING_SHAPE, FULL_LLAMA_SHAPE)
        rows = k1_case(device, shape, s + d + 3, causal=False, timed=timed, plain=timed,
                       plain_rows=FULL_PLAIN_ROWS, tag="kernel-full")
        if timed:
            key = "ring" if shape == FULL_RING_SHAPE else "llama_shape"
            out[key] = {n: {"shape": [b, s, h, d], **rows[n]} for n in ("fwd", "dkv", "dq")}
    bad = torch.zeros(1, 100, 2, 64, device=device, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, 100, device=device)
    seg = torch.zeros(1, 1, dtype=torch.int32, device=device)
    good = torch.zeros(1, 128, 2, 64, device=device, dtype=torch.bfloat16)
    for what, call in (("S=100", lambda: tfa.flash_attention(bad, bad, bad, causal=False)),
                       ("S=100 backward", lambda: tfa.flash_attention_backward(
                           bad, bad, bad, stat, stat, bad, causal=False)),
                       ("seg_starts", lambda: tfa.flash_attention(good, good, good, causal=False,
                                                                  seg_starts=seg))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"the non-causal kernels accepted {what}")
    print("[kernel-full] S=100 (forward, backward) and seg_starts with causal=False rejected")
    return out


def _full_launch_counts():
    import tst_torch.kernels.flash_attention as tfa

    return {"fwd": tfa.LAUNCHES_FULL, "dkv": tfa.LAUNCHES_FULL_BWD_DKV,
            "dq": tfa.LAUNCHES_FULL_BWD_DQ}


def ring_launches_want(n, idxs=None, causal=True):
    """K1's launches in one pass of the ring's kernel route over ``n``
    blocks (the forward, or the backward: one dK/dV and one dQ a pair) for
    the Q blocks of ranks ``idxs`` (all n, in one process, by default):
    under ``causal`` one causal launch a Q block (its diagonal) and one
    non-causal launch for each past block (rank idx has idx of them), none
    for a future block; without ``causal`` n non-causal launches a Q block."""
    idxs = list(range(n)) if idxs is None else list(idxs)
    if not causal:
        return {"causal": 0, "full": n * len(idxs)}
    return {"causal": len(idxs), "full": sum(idxs)}


def phase_rank(device, rounds=5):
    """Which attention kernels lose most to the library, interleaved over
    ``rounds`` in one process (medians): at the train step's shape the
    forward kernel against scaled_dot_product_attention's forward and the
    backward pair (dK/dV + dQ kernels) against its backward; at the packed
    train step's shape, with that step's own segment starts, the segmented
    forward against the library's forward with the boolean segment mask.
    The forward is ranked above the pair only if it is slower than the
    library's forward and loses to it by a larger factor than the pair
    loses to the library's backward."""
    import tst_torch.kernels.flash_attention as tfa

    b, s, h, kvh, d = TRAIN_SHAPE
    rng = np.random.default_rng(s + d + 1)
    q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
    k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
    o, lse = tfa.flash_attention(q, k, v)
    di = tfa.backward_row_stat(o, do)

    def pair():
        tfa._launch_bwd_dkv(q, k, v, do, lse, di)
        tfa._launch_bwd_dq(q, k, v, do, lse, di)

    b, s, h, kvh, d = PACKED_TRAIN_SHAPE
    rng = np.random.default_rng(s + d + 2)
    pq, pdo = (_randn(rng, (b, s, h, d), device) for _ in range(2))
    pk, pv = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
    seg = torch.from_numpy(_packed_step_starts()).to(device)
    kseg = tfa.kernel_seg_starts(seg, pq)
    po = tfa.flash_attention(pq, pk, pv, seg_starts=seg)[0]
    mask = tfa.segment_mask(seg, s)

    times = {"fwd": [], "pair": [], "fwd_seg": [], "library_fwd": [], "library_bwd": [],
             "library_fwd_seg": []}
    for _ in range(rounds):
        times["fwd"].append(median_ms(lambda: tfa._launch_fwd(q, k, v)))
        times["pair"].append(median_ms(pair))
        times["fwd_seg"].append(median_ms(lambda: tfa._launch_fwd(pq, pk, pv, kseg)))
        lib = _sdpa_yardstick(q, k, v, do, o)
        times["library_fwd"].append(lib["fwd_ms"])
        times["library_bwd"].append(lib["bwd_ms"])
        lib_seg = _sdpa_yardstick(pq, pk, pv, pdo, po, mask)
        times["library_fwd_seg"].append(lib_seg["fwd_ms"])
    med = {key: statistics.median(val) for key, val in times.items()}
    f_fwd, f_pair = med["fwd"] / med["library_fwd"], med["pair"] / med["library_bwd"]
    f_seg = med["fwd_seg"] / med["library_fwd_seg"]
    first = ("forward" if med["fwd"] > med["library_fwd"] and f_fwd > f_pair
             else "backward pair")
    print(f"[rank] {rounds} interleaved rounds (medians; per round "
          f"{json.dumps({key: [round(x, 4) for x in val] for key, val in times.items()})}): "
          f"train shape {TRAIN_SHAPE}: forward {med['fwd']:.4f} ms vs "
          f"scaled_dot_product_attention ({lib['backend']}, {lib['gqa']}) "
          f"{med['library_fwd']:.4f} ms, factor {f_fwd:.3f}; backward pair "
          f"{med['pair']:.4f} ms vs {med['library_bwd']:.4f} ms, factor {f_pair:.3f}; "
          f"loses most: the {first}; packed shape {PACKED_TRAIN_SHAPE}, "
          f"{int((seg < SEG_PAD).sum())} segment starts: segmented forward "
          f"{med['fwd_seg']:.4f} ms vs the library with the segment mask ({lib_seg['backend']}, "
          f"{lib_seg['gqa']}) {med['library_fwd_seg']:.4f} ms, factor {f_seg:.3f}")


def phase_slice():
    import tst_torch.kernels.flash_attention as tfa
    from tst_torch import cli
    from tst_torch.train.infer import score_all_mcq
    from tst_torch.train.pipeline import prepare_blind_eval

    out_dir = tempfile.mkdtemp(prefix="tst_torch_smoke_")
    tfa.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(SLICE + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES
    want = N_LAYERS * math.ceil(N_SAMPLES / SCORER_BATCH)
    if rc != 0 or launches != want:
        raise AssertionError(f"eval-blind rc={rc}, kernel launches {launches} != {want}")
    with open(os.path.join(out_dir, "blind_eval.json")) as f:
        report = json.load(f)
    acc = report["blind_accuracy"]
    if report["n_mcq"] != N_SAMPLES or not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"bad blind_eval.json: {report}")
    print(f"[slice] eval-blind rc=0, {launches} kernel launches, blind_accuracy {acc:.4f} "
          f"(chance {report['chance_accuracy']:.4f}), wall {wall:.2f} s "
          f"({N_SAMPLES / wall:.1f} samples/s incl. init and tokenization)")

    # the same tokens and weights, scored through the kernel and the plain attention
    cfg, device = cli._resolve(cli.build_parser().parse_args(SLICE))
    tb, tokens, pos, spec, params = prepare_blind_eval(cli._load_dataset(cfg), cfg, device)
    probs, secs = {}, {}
    for use_pallas in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs[use_pallas] = score_all_mcq(params, spec, tokens, pos, tb.option_token_ids,
                                          tb.n_options, use_pallas=use_pallas)
        secs[use_pallas] = time.perf_counter() - t0
    pk, pp = probs[True], probs[False]
    if pk.shape != (N_SAMPLES, 4) or not np.isfinite(pk).all():
        raise AssertionError(f"kernel-path probabilities: shape {pk.shape}, finite "
                             f"{np.isfinite(pk).all()}")
    diff = float(np.abs(pk - pp).max())
    agree = float((pk.argmax(-1) == pp.argmax(-1)).mean())
    acc_k = float((pk.argmax(-1) == tb.gold).mean())
    print(f"[slice] kernel vs plain attention: max|dprob| {diff:.3e} (<= {PROB_TOL}), "
          f"argmax agreement {agree:.4f} (>= {ARGMAX_AGREE}); rescored accuracy {acc_k:.4f}; "
          f"scoring {secs[True]:.3f} s kernel ({N_SAMPLES / secs[True]:.1f} samples/s), "
          f"{secs[False]:.3f} s plain")
    if diff > PROB_TOL or agree < ARGMAX_AGREE or abs(acc_k - acc) > 1.0 / N_SAMPLES:
        raise AssertionError("kernel path and plain path disagree on the slice")
    return launches, pk, report


def _launch_counts():
    import tst_torch.kernels.decode_attention as tda
    import tst_torch.kernels.flash_attention as tfa
    import tst_torch.kernels.fused_mlp as tfm
    import tst_torch.kernels.quant_matmul as tqm

    return {"fwd": tfa.LAUNCHES, "dkv": tfa.LAUNCHES_BWD_DKV, "dq": tfa.LAUNCHES_BWD_DQ,
            "fwd_seg": tfa.LAUNCHES_SEG, "dkv_seg": tfa.LAUNCHES_SEG_BWD_DKV,
            "dq_seg": tfa.LAUNCHES_SEG_BWD_DQ, "int4": tqm.LAUNCHES, "mlp": tfm.LAUNCHES,
            "dattn": tda.LAUNCHES}


def _zero_launch_counts():
    import tst_torch.kernels.decode_attention as tda
    import tst_torch.kernels.flash_attention as tfa
    import tst_torch.kernels.fused_mlp as tfm
    import tst_torch.kernels.quant_matmul as tqm

    tfa.LAUNCHES = tfa.LAUNCHES_BWD_DKV = tfa.LAUNCHES_BWD_DQ = 0
    tfa.LAUNCHES_SEG = tfa.LAUNCHES_SEG_BWD_DKV = tfa.LAUNCHES_SEG_BWD_DQ = 0
    tfa.LAUNCHES_FULL = tfa.LAUNCHES_FULL_BWD_DKV = tfa.LAUNCHES_FULL_BWD_DQ = 0
    tqm.LAUNCHES = tfm.LAUNCHES = tda.LAUNCHES = 0


def _train_state(overrides=(), base=TRAIN):
    """The diagnose-sft run's state (weights, adapters, batches) built as
    the CLI builds it from ``base``, with extra ``--set`` overrides."""
    from tst_torch import cli
    from tst_torch.train.pipeline import _build_sft_state

    argv = base + [a for o in overrides for a in ("--set", o)]
    cfg, device = cli._resolve(cli.build_parser().parse_args(argv))
    return _build_sft_state(cli._load_dataset(cfg), cfg, device)


def phase_train():
    from tst_torch import cli

    out_dir = tempfile.mkdtemp(prefix="tst_torch_train_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(TRAIN + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "sx.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    folds = np.array([r["fold"] for r in rows])
    k, steps = report["k"], report["train_steps"]
    chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / SCORER_BATCH)
    want = sft_launches_want(steps, chunks, N_LAYERS)
    loss = report["final_loss"]
    sx = np.array([r["s_x"] for r in rows], np.float64)
    rf_rho, rf_acc = report.get("rf_sft_spearman"), report.get("rf_blind_accuracy")
    if (rc != 0 or counts != want or report["n_mcq"] != N_SAMPLES or len(rows) != N_SAMPLES
            or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()
            or not all(isinstance(v, float) and math.isfinite(v) for v in (rf_rho, rf_acc))):
        raise AssertionError(f"diagnose-sft rc={rc}, launches {counts} (want {want}), "
                             f"n_mcq {report['n_mcq']}, sx rows {len(rows)}, final_loss {loss}, "
                             f"rf_sft_spearman {rf_rho}, rf_blind_accuracy {rf_acc}")
    print(f"[train] diagnose-sft rc=0, {steps} steps x {k} folds, {chunks} scorer chunks; "
          f"launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as implied); "
          f"final_loss {loss:.4f}, blind_accuracy {report['blind_accuracy']:.4f}, "
          f"fold_accuracies {report['fold_accuracies']}; RF cross-check (rf.cross_check, the "
          f"default): rf_sft_spearman {rf_rho}, rf_blind_accuracy {rf_acc}, wall "
          f"{report['rf_cross_check_wall_seconds']} s; train {report['train_wall_seconds']} s "
          f"({report['train_samples_per_sec']} samples/s incl. the first step "
          f"{report['train_first_step_seconds']} s), scoring "
          f"{report['score_mcq_wall_seconds']} s, CLI wall {wall:.2f} s; peak device memory "
          f"{peak_gb:.2f} GB")

    # steady step time: the same state, one synchronized step at a time
    st = _train_state()
    lora, opt = st.lora, st.opt_state
    times = []
    for t in range(STEP_SAMPLES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, _ = st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                       st.answer_pos, st.batches[t])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    prof = _profile(lambda: st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                            st.answer_pos, st.batches[0]), 2)
    print(f"[train] step ({rows_per_step} rows of {st.tokens.shape[1]} tokens): median "
          f"{step_ms:.2f} ms over {STEP_SAMPLES} steps after the first "
          f"({rows_per_step / step_ms * 1e3:.1f} samples/s); first step {times[0] * 1e3:.1f} ms; "
          f"profile of one step: {_fmt_profile(prof)}; device time by op: "
          f"{'; '.join(prof['ops'])}")
    return counts


def _step_gates(kernel, plain):
    """One step's (per-fold losses, LoRA gradients) through the kernels
    against the plain path: the loss gap (fold_losses_agree), the per-leaf
    gradient cosines and their worst leaf, and whether both gates hold."""
    (loss_k, grads_k), (loss_p, grads_p) = kernel, plain
    cos = {f"{p}.{n}": torch.nn.functional.cosine_similarity(
               grads_k[p][n].float().flatten(), grads_p[p][n].float().flatten(), dim=0).item()
           for p in grads_k for n in grads_k[p]}
    gap, loss_ok = fold_losses_agree(loss_k.tolist(), loss_p.tolist())
    worst = min(cos, key=cos.get)
    LOWEST_COSINE[_PHASE[0]] = min(LOWEST_COSINE.get(_PHASE[0], 1.0), cos[worst])
    line = (f"fold losses {loss_k.tolist()} vs plain {loss_p.tolist()} (max |d|/|loss| "
            f"{gap:.3e} <= {LOSS_RTOL}); LoRA gradient cosine min {cos[worst]:.5f} ({worst}) "
            f"over {len(cos)} leaves (>= {GRAD_COSINE})")
    return line, loss_ok and cos[worst] >= GRAD_COSINE


def mean_loss_and_grads(trainer, params, lora, arrays, batches, segs=None):
    """``trainer``'s per-fold losses [k] and LoRA gradients on each batch
    of ``batches`` from one state, averaged over the batches, in f32."""
    from tst_torch.train.sft import tree_map

    loss_sum, grad_sum = 0.0, None
    for idx in batches:
        loss, grads = trainer.batch_loss_and_grads(params, lora, *arrays, idx, segs)
        grads = tree_map(lambda t: t.float(), grads)
        loss_sum = loss_sum + loss.float()
        grad_sum = grads if grad_sum is None else tree_map(torch.add, grad_sum, grads)
    return loss_sum / len(batches), tree_map(lambda t: t / len(batches), grad_sum)


def gate_adapters(trainer, device, seed=1):
    """``trainer``'s adapters of ``seed``, with B drawn nonzero from seed + 6
    (B starts at 0, which leaves every A-gradient 0)."""
    lora = trainer.init_state(torch.Generator(device).manual_seed(seed))[0]
    rng = torch.Generator(device).manual_seed(seed + 6)
    for ab in lora.values():
        ab["b"] = (B_SCALE * torch.randn(ab["b"].shape, generator=rng, device=device)).to(
            ab["b"].dtype)
    return lora


def gate_case(key, name, make, spec, params, arrays, batches, segs=None):
    """A path a step gate holds: ``make(spec, use_pallas)`` → its
    FoldTrainer, the weights, the arrays (tokens, mask, answer positions)
    and batches its steps take, the packed starts or None; ``key`` names
    its GATE_BATCHES."""
    return {"key": key, "name": name, "make": make, "spec": spec, "params": params,
            "arrays": arrays, "batches": batches, "segs": segs}


def state_gate_case(key, name, st, packed=False):
    """gate_case of a diagnose-sft state (_train_state, kept as "state"):
    its trainer's settings, weights, arrays and batches."""
    from tst_torch.train.sft import FoldTrainer

    tr = st.trainer

    def make(spec, use_pallas):
        return FoldTrainer(spec, dataclasses.replace(tr.lora_spec, dtype=spec.dtype), k=tr.k,
                           use_pallas=use_pallas, remat=tr.remat, t_max=tr.t_max,
                           fused_mlp=tr.fused_mlp, packed=tr.packed)
    arrays = (st.ptokens, st.pmask, st.ppos) if packed else (st.tokens, st.loss_mask,
                                                             st.answer_pos)
    return {**gate_case(key, name, make, st.spec, st.params, arrays, st.batches,
                        st.psegs if packed else None), "state": st}


def step_gate(case, lora=None):
    """_step_gates on ``case``'s first GATE_BATCHES batches through the
    kernels against ``use_pallas=False``, from one state: the weights,
    ``lora`` (gate_adapters by default) and batches; losses and gradients
    averaged over the batches → (line, ok)."""
    n = GATE_BATCHES[case["key"]]
    batches = case["batches"][:n]
    if len(batches) < n:
        raise AssertionError(f"{case['name']}: {len(batches)} batches, the gate averages {n}")
    device = case["arrays"][0].device
    if lora is None:
        lora = gate_adapters(case["make"](case["spec"], True), device)
    got = [mean_loss_and_grads(case["make"](case["spec"], use_pallas), case["params"], lora,
                               case["arrays"], batches, case["segs"])
           for use_pallas in (True, False)]
    torch.cuda.synchronize()
    line, ok = _step_gates(*got)
    return f"{n} batch(es) averaged: {line}", ok


def _train_gate_case():
    return state_gate_case("train", f"Qwen2.5-0.5B k=2 x {PLAIN_ROWS} rows",
                           _train_state([f"optim.batch_size={PLAIN_ROWS}"]))


def _packed_gate_case():
    return state_gate_case(
        "packed", f"Qwen2.5-0.5B k=2 x {PACKED_PLAIN_ROWS} packed rows of 1024",
        _train_state(PACKED + [f"optim.batch_size={PACKED_PLAIN_ROWS}"]), packed=True)


def _fused_gate_case():
    return state_gate_case("fused", f"int4 Qwen2.5-0.5B fused MLP k=2 x {PLAIN_ROWS} rows",
                           _train_state([f"optim.batch_size={PLAIN_ROWS}"], base=TRAIN_FUSED))


def _llama8b_gate_case():
    with _CutDepth("llama3-8b", LLAMA8B_GATE_LAYERS):
        st = _train_state([f"optim.batch_size={PLAIN_ROWS}", f"data.n={LLAMA8B_GATE_ROWS}"],
                          base=LLAMA8B_TRAIN)
    return state_gate_case("llama8b", f"Llama-3-8B ({LLAMA8B_GATE_LAYERS} layers) k=5 x "
                           f"{PLAIN_ROWS} rows, remat", st)


def train_gate_cases(keys=None):
    """The diagnose-sft paths of phases 7, 10, 14 and 22a (those of
    ``keys`` if given), one state at a time (for
    scripts/torch_step_loss_noise.py)."""
    for key, build in (("train", _train_gate_case), ("packed", _packed_gate_case),
                       ("fused", _fused_gate_case), ("llama8b", _llama8b_gate_case)):
        if keys and key not in keys:
            continue
        case = build()
        yield case
        del case
        torch.cuda.empty_cache()


def phase_train_vs_plain():
    """The step's LoRA gradients and fold losses through the kernels and
    through the plain attention (step_gate: same weights, adapters and
    batches)."""
    line, ok = step_gate(_train_gate_case())
    print(f"[train-vs-plain] {PLAIN_ROWS} rows per fold, kernels: {line}")
    if not ok:
        raise AssertionError("the train step through the kernels disagrees with the plain path")


def _seg_starts(b, s, seed):
    """int32 [b, MAX_SEGS] starts. At S <= 1024: starts inside 64-row tiles
    (1, 63, 64, 65 and near the end), a row of all SEG_PAD, one segment, a
    first start after 0, then random rows; longer: MAX_SEGS segments a row."""
    rng = np.random.default_rng(seed)
    fixed = [sorted({0, 1, 63, 64, 65, s // 2 + 1, max(s - 65, 0), s - 1}), [], [0], [7, 70]]
    rows = []
    for i in range(b):
        if s <= 1024 and i < len(fixed):
            starts = fixed[i][:MAX_SEGS]
        else:
            n = MAX_SEGS if s > 1024 else int(rng.integers(1, MAX_SEGS + 1))
            starts = [0] + sorted(rng.choice(np.arange(1, s), n - 1, replace=False).tolist())
        rows.append(starts + [SEG_PAD] * (MAX_SEGS - len(starts)))
    return np.asarray(rows, np.int32)


@functools.lru_cache(maxsize=1)
def _packed_step_starts():
    """The segment starts of the packed run's first train step, fold-major
    [k·B, MAX_SEGS], from the run's own state."""
    st = _train_state(PACKED)
    ka = np.arange(st.batches.shape[1])[:, None]
    seg = st.pack.seg_starts[ka, st.batches[0]]
    return seg.reshape(-1, seg.shape[-1])


def phase_kernel_seg(device):
    """The segmented kernels against their plain versions and autograd of
    the plain masked attention, at the packed train step's call (its own
    starts), Llama-3-8B heads at S=2048 with 8 segments, 128- and 64-token
    cases (SEG_SHAPES), each bit-equal on a second call; then times at the
    train step's shape and at the bench's packed 8B leg (BENCH_SEG_TIMED)."""
    import tst_torch.kernels.flash_attention as tfa

    cases = [(PACKED_TRAIN_SHAPE, _packed_step_starts())]
    cases += [(shape, _seg_starts(shape[0], shape[1], shape[1])) for shape in SEG_SHAPES]
    cases += _bench_seg_cases()
    out = {}
    for (b, s, h, kvh, d), starts in cases:
        rng = np.random.default_rng(s + d + 2)
        q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
        k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
        seg = torch.from_numpy(starts).to(device)
        o, lse = tfa.flash_attention(q, k, v, seg_starts=seg)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention(q, k, v, seg_starts=seg), (o, lse),
                       "the segmented forward kernel")
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, seg_starts=seg)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        di = tfa.backward_row_stat(o, do)
        got = tfa.flash_attention_backward(q, k, v, lse, di, do, seg_starts=seg)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention_backward(q, k, v, lse, di, do, seg_starts=seg),
                       got)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), seg_starts=seg)
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        abs_errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        del want

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ)
        tfa.flash_attention(*leaves, seg_starts=seg)[0].backward(do)
        if (tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ) != (before[0] + 1, before[1] + 1):
            raise AssertionError("the Function's backward did not launch both segmented kernels")
        plain = [t.detach().requires_grad_() for t in (q, k, v)]
        tfa.masked_attention(*plain, tfa.segment_mask(seg, s))[0].backward(do)
        torch.cuda.synchronize()
        auto_errs = [_rel_err(a.grad, p.grad) for a, p in zip(leaves, plain)]
        del leaves, plain
        finite = bool(torch.isfinite(o).all()) and all(
            bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for g in got)
        print(f"[kernel-seg] B={b} S={s} H={h} KVH={kvh} D={d}, "
              f"{int((starts < SEG_PAD).sum())} segment starts: max|o-ref| {o_err:.3e} "
              f"(<= {O_TOL}), max|lse-ref| {lse_err:.3e} (<= {LSE_TOL}); max|d-ref|/max|ref| "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; through autograd vs plain "
              f"masked attention dq {auto_errs[0]:.3e} dk {auto_errs[1]:.3e} "
              f"dv {auto_errs[2]:.3e} (each <= {GRAD_TOL})")
        if (not finite or o_err > O_TOL or lse_err > LSE_TOL
                or max(errs + auto_errs) > GRAD_TOL):
            raise AssertionError(f"segmented flash attention disagrees with its plain version "
                                 f"at {(b, s, h, kvh, d)}")
        if (b, s, h, kvh, d) == PACKED_TRAIN_SHAPE:
            out = {**_time_seg_kernels(q, k, v, do, seg, o, lse), **out}
            out["fwd"]["max_abs_err"] = o_err
            out["dq"]["max_abs_err"], out["dkv"]["max_abs_err"] = abs_errs[0], abs_errs[1]
        elif (b, s, h, kvh, d) == BENCH_SEG_TIMED:
            wide = _time_seg_kernels(q, k, v, do, seg, o, lse)
            wide_lib = wide.pop("library")
            out["llama8b_packed"] = {
                key: {"shape": [b, s, h, kvh, d], "max_abs_err": err, **wide[key],
                      "library": f"{wide_lib['backend']}, {wide_lib['gqa']}"}
                for key, err in (("fwd", o_err), ("dkv", abs_errs[1]), ("dq", abs_errs[0]))}
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    q = torch.zeros(2, 128, 4, 64, device=device, dtype=torch.bfloat16)
    kv = torch.zeros(2, 128, 2, 64, device=device, dtype=torch.bfloat16)
    good = torch.zeros(2, MAX_SEGS, dtype=torch.int32, device=device)
    for bad, causal in ((torch.zeros(2, MAX_SEGS + 1, dtype=torch.int32, device=device), True),
                        (good.long(), True), (good[:1], True), (good, False)):
        try:
            tfa.flash_attention(q, kv, kv, causal=causal, seg_starts=bad)
        except ValueError:
            continue
        raise AssertionError(f"flash_attention accepted seg_starts {tuple(bad.shape)} "
                             f"{bad.dtype} causal={causal}")
    f, dkv, dq, lib = out["fwd"], out["dkv"], out["dq"], out.pop("library")
    wide = out["llama8b_packed"]
    print(f"[kernel-seg] the bench's packed 8B leg {BENCH_SEG_TIMED}, its own starts: forward "
          f"segmented {wide['fwd']['ms']:.4f} ms (bound {wide['fwd']['bound_ms']:.4f}, library "
          f"{wide['fwd']['library_ms']:.4f}, plain {wide['fwd']['plain_ms']:.4f}); dK/dV "
          f"{wide['dkv']['ms']:.4f} ms (bound {wide['dkv']['bound_ms']:.4f}) + dQ "
          f"{wide['dq']['ms']:.4f} ms (bound {wide['dq']['bound_ms']:.4f}) against the "
          f"library's backward {wide['dkv']['library_ms']:.4f} ms ({wide['fwd']['library']})")
    print(f"[kernel-seg] bit-equal on a second call at every shape; bad starts rejected (9 "
          f"columns, int64, wrong batch, causal=False); train shape {PACKED_TRAIN_SHAPE}: "
          f"forward segmented {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, {f['bound_by']}), "
          f"unsegmented {f['unsegmented_ms']:.4f} ms, plain {f['plain_ms']:.4f} ms; dK/dV "
          f"segmented {dkv['ms']:.4f} ms (bound {dkv['bound_ms']:.4f}, {dkv['bound_by']}), "
          f"unsegmented {dkv['unsegmented_ms']:.4f} ms; dQ segmented {dq['ms']:.4f} ms (bound "
          f"{dq['bound_ms']:.4f}, {dq['bound_by']}), unsegmented {dq['unsegmented_ms']:.4f} ms; "
          f"plain backward {dq['plain_ms']:.4f} ms; scaled_dot_product_attention with the "
          f"segment mask ({lib['backend']}, {lib['gqa']}; max|o-o_kernel| "
          f"{lib['max_abs_o_diff']:.3e}): forward {lib['fwd_ms']:.4f} ms, backward alone "
          f"{lib['bwd_ms']:.4f} ms (kernels and library: median of 30 x 10 calls; plain: 10 x 3)")
    return out


def _time_seg_kernels(q, k, v, do, seg, o, lse):
    """Median times of the segmented kernels, the unsegmented ones at the
    same shape, and the plain versions (segment-masked)."""
    import tst_torch.kernels.flash_attention as tfa

    kseg = tfa.kernel_seg_starts(seg, q)
    di = tfa.backward_row_stat(o, do)
    o_u, lse_u = tfa.flash_attention(q, k, v)
    di_u = tfa.backward_row_stat(o_u, do)
    plain_bwd = median_ms(lambda: tfa.flash_attention_backward_reference(
        q, k, v, o, lse, do, seg_starts=seg), samples=10, reps=3, warmup=1)
    lib = _sdpa_yardstick(q, k, v, do, o, tfa.segment_mask(seg, q.shape[1]))
    bounds = _attention_bounds(q, k, seg)
    return {
        "fwd": {"ms": median_ms(lambda: tfa._launch_fwd(q, k, v, kseg)),
                "unsegmented_ms": median_ms(lambda: tfa._launch_fwd(q, k, v)),
                "plain_ms": median_ms(lambda: tfa.flash_attention_reference(
                    q, k, v, seg_starts=seg), samples=10, reps=3, warmup=1),
                "library_ms": lib["fwd_ms"], **bounds["fwd"]},
        "dkv": {"ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di, kseg)),
                "unsegmented_ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse_u, di_u)),
                "plain_ms": plain_bwd, "library_ms": lib["bwd_ms"], **bounds["dkv"]},
        "dq": {"ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di, kseg)),
               "clocks_sm_power": clocks_now(),
               "unsegmented_ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse_u, di_u)),
               "plain_ms": plain_bwd, "library_ms": lib["bwd_ms"], **bounds["dq"]},
        "library": lib,
    }


def phase_train_packed():
    from tst_torch import cli
    from tst_torch.train.infer import pack_heldout_mcq, packed_scorer_batch

    out_dir = tempfile.mkdtemp(prefix="tst_torch_packed_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(TRAIN + ["--set", PACKED[0], "--set", "rf.cross_check=false",
                           "--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "sx.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    st = _train_state(PACKED)
    k, steps = report["k"], report["train_steps"]
    batch = packed_scorer_batch(st.pack.pack_len)
    held_out_rows = pack_heldout_mcq(st.tb, st.fold_id, k, st.pack.pack_len, batch)[0].shape[1]
    chunks = k * held_out_rows // batch
    want = {"fwd": 0, "dkv": 0, "dq": 0, "fwd_seg": N_LAYERS * (steps + chunks),
            "dkv_seg": N_LAYERS * steps, "dq_seg": N_LAYERS * steps, "int4": 0, "mlp": 0,
            "dattn": 0}
    loss = report["final_loss"]
    sx = np.array([r["s_x"] for r in rows], np.float64)
    if (rc != 0 or counts != want or report.get("pack_len") != 1024
            or "pack_fill_fraction" not in report or report["n_mcq"] != N_SAMPLES
            or len(rows) != N_SAMPLES or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()):
        raise AssertionError(f"packed diagnose-sft rc={rc}, launches {counts} (want {want}), "
                             f"pack_len {report.get('pack_len')}, n_mcq {report['n_mcq']}, "
                             f"sx rows {len(rows)}, final_loss {loss}")
    print(f"[train-packed] diagnose-sft optim.pack=true rc=0, pack_len {report['pack_len']}, "
          f"fill {report['pack_fill_fraction']}, packed rows per fold "
          f"{st.pack.n_rows.tolist()}; {steps} steps x {k} folds, {chunks} scorer chunks of "
          f"{batch} rows; segmented launches fwd {counts['fwd_seg']} dkv {counts['dkv_seg']} "
          f"dq {counts['dq_seg']}, unsegmented 0 (as implied); final_loss {loss:.4f}, "
          f"blind_accuracy {report['blind_accuracy']:.4f}, fold_accuracies "
          f"{report['fold_accuracies']}; train {report['train_wall_seconds']} s "
          f"({report['train_samples_per_sec']} samples/s incl. the first step "
          f"{report['train_first_step_seconds']} s), scoring {report['score_mcq_wall_seconds']} s, "
          f"CLI wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB")

    # steady step time: the same state, one synchronized step at a time
    lora, opt = st.lora, st.opt_state
    times = []
    for t in range(STEP_SAMPLES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, _ = st.trainer.step(st.params, lora, opt, st.ptokens, st.pmask, st.ppos,
                                       st.batches[t], st.psegs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    ka = np.arange(st.batches.shape[1])[:, None]
    samples = float(np.mean([st.pack.n_segs[ka, st.batches[t]].sum()
                             for t in range(1, STEP_SAMPLES + 1)]))
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    prof = _profile(lambda: st.trainer.step(st.params, lora, opt, st.ptokens, st.pmask, st.ppos,
                                            st.batches[0], st.psegs), 2)
    print(f"[train-packed] step ({rows_per_step} packed rows of {st.ptokens.shape[-1]} tokens, "
          f"{samples:.1f} samples on average): median {step_ms:.2f} ms over {STEP_SAMPLES} "
          f"steps after the first ({samples / step_ms * 1e3:.1f} train samples/s); first step "
          f"{times[0] * 1e3:.1f} ms; profile of one step: {_fmt_profile(prof)}; device time by "
          f"op: {'; '.join(prof['ops'])}")
    return counts


def phase_train_packed_vs_plain():
    """One packed step's LoRA gradients and losses (step_gate), and the
    packed scorer's letter probabilities, through the kernels and through
    the plain path on one state: the same weights, adapters and rows."""
    from tst_torch.train.infer import score_heldout_mcq_packed

    case = _packed_gate_case()
    st = case["state"]
    lora = gate_adapters(case["make"](case["spec"], True), st.tokens.device)
    line, ok = step_gate(case, lora)
    probs, secs = {}, {}
    for use_pallas in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs[use_pallas] = score_heldout_mcq_packed(
            st.params, lora, st.spec, st.lspec, st.tb, st.fold_id, st.trainer.k,
            pack_len=st.pack.pack_len, use_pallas=use_pallas)
        secs[use_pallas] = time.perf_counter() - t0
    gold = st.tb.gold
    del case, st, lora
    torch.cuda.empty_cache()
    pk, pp = probs[True], probs[False]
    diff = float(np.abs(pk - pp).max())
    agree = float((pk.argmax(-1) == pp.argmax(-1)).mean())
    print(f"[train-packed-vs-plain] {PACKED_PLAIN_ROWS} packed rows per fold, kernels: {line}; "
          f"packed scorer letter probabilities max|dprob| "
          f"{diff:.3e} (<= {PROB_TOL}), argmax agreement {agree:.4f} (>= {ARGMAX_AGREE}), "
          f"accuracy {float((pk.argmax(-1) == gold).mean()):.4f}; scoring {secs[True]:.3f} s "
          f"kernel, {secs[False]:.3f} s plain")
    if (not ok or pk.shape != (N_SAMPLES, 4)
            or not np.isfinite(pk).all() or diff > PROB_TOL or agree < ARGMAX_AGREE):
        raise AssertionError("the packed path through the kernels disagrees with the plain path")


def trace_device_time(events):
    """From a Chrome trace's events: the device's kernels (and copies, sets)
    as (µs, calls, name), and the host ops whose launches took that device
    time, as (µs, name): each kernel is counted under the innermost CPU op
    around the runtime call that launched it (the call and the kernel share
    a ``correlation`` id), as ``key_averages()``'s self device time counts
    it. The trace is read instead of ``key_averages()``, which builds every
    event in Python (tst_torch.aux.profile)."""
    kernels, by_corr = {}, {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            acc = kernels.setdefault(ev["name"], [0.0, 0])
            acc[0] += float(ev.get("dur", 0.0))
            acc[1] += 1
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] = by_corr.get(corr, 0.0) + float(ev.get("dur", 0.0))
    # per host thread, a sweep in time order keeps the stack of open CPU ops
    threads = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"):
            threads.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    ops = {}
    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), e["cat"] != "cpu_op", -float(e.get("dur", 0))))
        stack = []
        for ev in evs:
            ts = float(ev["ts"])
            while stack and float(stack[-1]["ts"]) + float(stack[-1].get("dur", 0)) < ts:
                stack.pop()
            if ev["cat"] == "cpu_op":
                stack.append(ev)
            elif stack:
                us = by_corr.get(ev.get("args", {}).get("correlation"), 0.0)
                if us:
                    ops[stack[-1]["name"]] = ops.get(stack[-1]["name"], 0.0) + us
    return ([(us, n, name) for name, (us, n) in kernels.items()],
            [(us, name) for name, us in ops.items()])


def _profile(fn, steps, match=None):
    """Per call of ``fn``: the synchronized wall ms of ``steps`` calls
    without the profiler, and the device's busy ms from a torch.profiler
    trace of ``steps`` more (the sum of kernel times); the idle share is
    1 - busy / wall. The profiler's own host cost stays out of the wall: a
    launch-bound loop runs several times slower under it. Also the five
    kernels that take the most device time, with their launches per call,
    the twelve host ops whose launches take the most device time (a
    hand-written kernel counts under the op that launched it), and the
    device ms and launches of the kernels whose names hold ``match``. Busy
    and idle are None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            kern_us, op_us = trace_device_time(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)
    kernels = [(us / 1e3 / steps, n / steps, name) for us, n, name in kern_us]
    ops = [(us / 1e3 / steps, name) for us, name in op_us]
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        return {"wall_ms": wall_ms, "busy_ms": None, "idle_share": None, "top": [], "ops": []}
    top = [f"{name[:60]} {ms:.3f} ms x{cnt:g}" for ms, cnt, name in sorted(kernels)[::-1][:5]]
    by_op = [f"{name[:48]} {ms:.3f} ms ({ms / busy:.1%})" for ms, name in sorted(ops)[::-1][:12]]
    out = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms, "top": top,
           "ops": by_op}
    if match:
        mine = [(ms, cnt) for ms, cnt, name in kernels if match in name]
        out["match"] = (match, sum(ms for ms, _ in mine), sum(cnt for _, cnt in mine))
    return out


def _fmt_profile(p):
    if p["busy_ms"] is None:
        return f"wall {p['wall_ms']:.3f} ms; device time not measured (no kernel time in trace)"
    line = (f"wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}")
    if "match" in p:
        name, ms, cnt = p["match"]
        line += (f"; kernels named {name}: {ms:.3f} ms in {cnt:g} launches, "
                 f"{ms / p['busy_ms']:.1%} of busy")
    return line + f"; top kernels: {'; '.join(p['top'])}"


def _capture(fn, calls=1, keep=False):
    """A CUDA graph of ``calls`` calls of ``fn``, after one call on a side
    stream has bound the entries and warmed the allocator outside the
    capture; ``keep`` keeps the graph for libcuda's graph API."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    return graph


def graph_us(fn, calls=10, replays=20):
    """Device µs a call of ``fn``, without the host: ``calls`` calls captured
    in one CUDA graph, the median over ``replays`` CUDA-event timings of a
    replay, per call."""
    graph = _capture(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls * 1e3)
    return statistics.median(times)


def graph_kernels(fn):
    """Kernel launches a call of ``fn``: the kernel nodes of a CUDA graph
    captured around one call, counted through libcuda's graph API (the profiler
    can drop kernel events, so it is no gate)."""
    graph = _capture(fn, keep=True)
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def host_us(fn, calls=300):
    """Host µs a call of ``fn``: ``calls`` calls back to back, no
    synchronization inside the timed loop (the device, faster a call than the
    host here, keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def phase_kernel_int4(device, strict=True):
    """K3 against its plain version at decode's M for every int4 leaf of
    Qwen2.5-0.5B and Llama-3-8B (layer 1 of a 2-layer stack, weights drawn in
    bf16 and quantized as the model's are), bit-equal on a second call; at
    every Qwen shape its device time a call (CUDA graph), its host time a
    call (the public entry) and the plain version's time; one kernel a call
    (``strict``: else only printed, for a parent tree)."""
    import tst_torch.kernels.quant_matmul as tqm
    from tst_torch.models.quant import quantize_leaf

    g = torch.Generator(device=device).manual_seed(11)
    layer = {m: {"device_us": 0.0, "host_us": 0.0, "plain_ms": 0.0} for m in INT4_M}
    worst, timed = 0.0, []
    # K3 and the library at M=32 summed over a decode layer's 7 projections
    lib = {"qwen2.5-0.5b": {"k3_us": 0.0, "library_us": 0.0, "max_rel_err": 0.0},
           "llama3-8b": {"k3_us": 0.0, "library_us": 0.0, "max_rel_err": 0.0}}
    lib_error = None
    cases = [(name, k, n, 1) for name, (k, n) in QWEN_INT4.items()]
    cases += [("llama3-8b", k, n, c) for (k, n), c in zip(LLAMA_INT4, LLAMA_INT4_PER_LAYER)]
    for name, k, n, per_layer in cases:
        w = (torch.randn(2, k, n, device=device, generator=g) / math.sqrt(k)).to(torch.bfloat16)
        leaf = quantize_leaf(w, bits=4)
        q, sc = leaf["q"], leaf["scale"]
        del w, leaf
        for m in INT4_M + INT4_CHECK_M:
            y = torch.randn(m, k, device=device, generator=g).to(torch.bfloat16)
            before = tqm.LAUNCHES
            got = tqm.int4_matmul_stacked(y, q, sc, 1)
            torch.cuda.synchronize()
            want = tqm.int4_matmul_reference(y, q, sc, 1)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if (tqm.LAUNCHES != before + 1 or rel > INT4_TOL
                    or not bool(torch.isfinite(got).all())):
                raise AssertionError(f"int4_matmul disagrees with its plain version at "
                                     f"M={m} K={k} N={n}: max|d|/max|ref| {rel:.3e}")
            _check_bitwise(lambda: (tqm.int4_matmul_stacked(y, q, sc, 1),), (got,), "K3")
            worst = max(worst, err)
            line = f"[kernel-int4] {name} M={m} K={k} N={n}: max|out-ref|/max|ref| {rel:.3e}"
            if m > INT4_M[0]:
                # a row's bits do not depend on the rows beside it (F1)
                head = tqm.int4_matmul_stacked(y[: INT4_M[0]].contiguous(), q, sc, 1)
                if not torch.equal(got[: INT4_M[0]], head):
                    raise AssertionError(f"K3's first {INT4_M[0]} rows at M={m} differ from "
                                         f"the same rows at M={INT4_M[0]} (K={k} N={n})")
                line += f"; rows 0-{INT4_M[0] - 1} bit-equal to an M={INT4_M[0]} call"
            if name in QWEN_INT4 and m in INT4_M:
                timed.append((y, q, sc))
                dev = graph_us(lambda: tqm._launch(y, q, sc, 1))
                host = host_us(lambda: tqm.int4_matmul_stacked(y, q, sc, 1))
                plain = median_ms(lambda: tqm.int4_matmul_reference(y, q, sc, 1))
                layer[m]["device_us"] += dev
                layer[m]["host_us"] += host
                layer[m]["plain_ms"] += plain
                line += (f"; kernel {dev:.2f} µs on the device, {host:.2f} µs on the host; "
                         f"plain {plain:.4f} ms")
            if m == INT4_M[0] and lib_error is None:
                fam = "llama3-8b" if name == "llama3-8b" else "qwen2.5-0.5b"
                try:
                    w4, sz = tinygemm_operands(q, sc, 1)
                    got_lib = torch.ops.aten._weight_int4pack_mm(y, w4, INT4_GROUP_SIZE, sz)
                    torch.cuda.synchronize()
                except (RuntimeError, NotImplementedError, AttributeError) as e:
                    lib_error = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
                else:
                    rel_lib = _rel_err(got_lib, want)
                    if rel_lib > LIB_INT4_TOL or not bool(torch.isfinite(got_lib).all()):
                        raise AssertionError(f"the tinygemm yardstick disagrees with K3's plain "
                                             f"version at M={m} K={k} N={n}: {rel_lib:.3e}")
                    lib_us = graph_us(lambda: torch.ops.aten._weight_int4pack_mm(
                        y, w4, INT4_GROUP_SIZE, sz))
                    k3_us = graph_us(lambda: tqm._launch(y, q, sc, 1))
                    lib[fam]["k3_us"] += per_layer * k3_us
                    lib[fam]["library_us"] += per_layer * lib_us
                    lib[fam]["max_rel_err"] = max(lib[fam]["max_rel_err"], rel_lib)
                    line += (f"; library (aten._weight_int4pack_mm, bf16 scales) {lib_us:.2f} µs "
                             f"vs K3 {k3_us:.2f} µs device, library vs plain {rel_lib:.3e} "
                             f"(<= {LIB_INT4_TOL})")
            print(line + f" (<= {INT4_TOL})")
        del q, sc
    # kernels a call: a CUDA graph of one call at every Qwen shape
    launches = graph_kernels(lambda: [tqm._launch(y, q, sc, 1) for y, q, sc in timed]) / len(timed)
    del timed
    print(f"[kernel-int4] bit-equal on a second call at every shape; kernels a call: "
          f"{launches:g}")
    if strict and launches != 1:
        raise AssertionError(f"K3 must be one launch a call: {launches:g}")
    if lib_error is None:
        for fam, row in lib.items():
            print(f"[kernel-int4] {fam}: one decode layer's 7 projections at M={INT4_M[0]}, "
                  f"device time (CUDA graph): K3 {row['k3_us']:.2f} µs, library "
                  f"(aten._weight_int4pack_mm) {row['library_us']:.2f} µs; library vs K3's "
                  f"plain version max|d|/max|ref| {row['max_rel_err']:.3e}")
    else:
        print(f"[kernel-int4] no library time: aten._weight_int4pack_mm refused K3's "
              f"operands on this build of torch ({lib_error})")
    for m in INT4_M:
        print(f"[kernel-int4] one decode layer's 7 projections at M={m}: device "
              f"{layer[m]['device_us']:.2f} µs (CUDA graph of 10 calls, median of 20 replays), "
              f"host {layer[m]['host_us']:.2f} µs (300 calls back to back), plain (dequantize, "
              f"then product) {layer[m]['plain_ms']:.4f} ms (sums over the projections)")
    m = INT4_M[0]
    return {"max_abs_err": worst, "ms": layer[m]["device_us"] / 1e3,
            "plain_ms": layer[m]["plain_ms"],
            "library_ms": None if lib_error else lib["qwen2.5-0.5b"]["library_us"] / 1e3,
            "library": lib_error or "aten._weight_int4pack_mm (tinygemm), bf16 scales",
            "library_max_rel_err": None if lib_error else lib["qwen2.5-0.5b"]["max_rel_err"],
            "llama_layer": None if lib_error else {
                "k3_ms": lib["llama3-8b"]["k3_us"] / 1e3,
                "library_ms": lib["llama3-8b"]["library_us"] / 1e3,
                "library_max_rel_err": lib["llama3-8b"]["max_rel_err"]},
            **int4_bound(QWEN_INT4.values(), m),
            "host_ms": layer[m]["host_us"] / 1e3,
            "device_us_a_call": {str(mm): layer[mm]["device_us"] / INT4_PROJ for mm in INT4_M},
            "host_us_a_call": {str(mm): layer[mm]["host_us"] / INT4_PROJ for mm in INT4_M},
            "timed": f"device time summed over one Qwen2.5-0.5B layer's 7 projections at M={m} "
                     f"(CUDA graph); host_ms the same sum on the host"}


def tinygemm_weights(q, sc, layer):
    """K3's operands (planar int4 ``q`` [L, K, N/2], f32 g128 scales ``sc``
    [L, K/128, 1, N]), layer ``layer``, as torch's tinygemm int4 product
    (``aten._weight_int4pack_mm``) reads them before packing: the weight
    [N, K] as unsigned nibbles u = v + 8, and bf16 scales and zero points
    [K/128, N, 2] with zeros 0 (tinygemm computes (u - 8) * scale + zero)."""
    ql = q[layer]
    v = torch.cat([(ql & 0xF).to(torch.int16) - 8, (ql >> 4).to(torch.int16)], dim=-1)
    u = (v + 8).to(torch.uint8).t().contiguous()
    scale = sc[layer][:, 0, :]
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
    return u, sz


def tinygemm_operands(q, sc, layer, inner_k_tiles=8):
    """tinygemm_weights packed for the CUDA op: two nibbles a byte, then
    ``_convert_weight_to_int4pack``'s tiled layout."""
    u, sz = tinygemm_weights(q, sc, layer)
    return torch.ops.aten._convert_weight_to_int4pack((u[:, ::2] << 4) | u[:, 1::2],
                                                      inner_k_tiles), sz


def _dattn_case(device, b, t, h, kvh, d, s, seed):
    """q [b, t, h, d], a cache [b, s, kvh, d] and a decode mask [b, t, s]:
    prompts of 5/32 to 25/32 of s slots (100-499 at s=640), 3 generated
    slots from s - 128, then query j's chunk slots up to its own (the verify
    chunk's triangle)."""
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, shape, device) for shape in
               ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    plen = torch.as_tensor(rng.integers(s * 5 // 32, s * 25 // 32, size=b), device=device)
    gen = s - 128
    ar = torch.arange(s, device=device)
    valid = (ar[None] < plen[:, None]) | ((ar[None] >= gen) & (ar[None] < gen + 3))
    tri = (ar[None] >= gen + 3) & (ar[None] - gen - 3 <= torch.arange(t, device=device)[:, None])
    return q, k, v, (valid[:, None] | tri[None]).contiguous()


def dattn_bound(q, k, mask):
    """The decode attention's bound: 4·D operations a (query, head, visible
    slot); bytes of q, the output and the mask, and of the keys and values of
    the slots some query of the row may see (the kernel reads no other)."""
    b, t, h, d = q.shape
    seen = int(mask.any(1).sum().item())  # over rows: slots a query of the row sees
    nbytes = 2 * q.numel() * 2 + mask.numel() + 2 * seen * k.shape[2] * d * 2
    return _bound(4 * d * h * int(mask.sum().item()), nbytes)


def dattn_check(device, case):
    """The decode attention kernel against its plain version at ``case``
    (B, T, H, KVH, D, S): one launch, bit-equal on a second call, each query
    of a verify chunk bit-equal to the same query alone (T=1), and to the
    same keys in a cache 130 slots longer with masked slots between them
    (F1) → (max |out - ref|, q, k, v, mask, the line printed)."""
    import tst_torch.kernels.decode_attention as tda

    b, t, h, kvh, d, s = case
    q, k, v, mask = _dattn_case(device, b, t, h, kvh, d, s, seed=b * t + d)
    before = tda.LAUNCHES
    got = tda.cache_attention(q, k, v, mask)
    torch.cuda.synchronize()
    want = tda.cache_attention_reference(q, k, v, mask)
    err = (got.float() - want.float()).abs().max().item()
    if tda.LAUNCHES != before + 1 or err > O_TOL * want.float().abs().max().item():
        raise AssertionError(f"decode attention disagrees with its plain version at "
                             f"{case}: {err:.3e}")
    _check_bitwise(lambda: (tda.cache_attention(q, k, v, mask),), (got,), "decode attention")
    for j in range(t):
        alone = tda.cache_attention(q[:, j: j + 1].contiguous(), k, v,
                                    mask[:, j: j + 1].contiguous())
        if not torch.equal(alone, got[:, j: j + 1]):
            raise AssertionError(f"decode attention: query {j} of a T={t} call differs "
                                 f"from the same query alone")
    gap, gen = 2, s - 128

    def widen(x, fill, seed):
        return torch.cat([x[:, :gen], fill(seed), x[:, gen:], torch.zeros(
            (b, 128) + tuple(x.shape[2:]), dtype=x.dtype, device=device)], 1)

    def noise(seed):
        return _randn(np.random.default_rng(seed), (b, gap, kvh, d), device)

    k2, v2 = widen(k, noise, 1), widen(v, noise, 2)
    m2 = torch.cat([mask[..., :gen], torch.zeros((b, t, gap), dtype=torch.bool, device=device),
                    mask[..., gen:], torch.zeros((b, t, 128), dtype=torch.bool,
                                                 device=device)], -1)
    if not torch.equal(tda.cache_attention(q, k2, v2, m2.contiguous()), got):
        raise AssertionError("decode attention depends on the cache's length or on where "
                             "masked slots sit")
    line = (f"B={b} T={t} H={h} KVH={kvh} D={d} S={s}: max|out-ref| {err:.3e}; bit-equal on a "
            f"second call, query by query alone, and in a cache of {s + gap + 128} slots with "
            f"masked slots inserted")
    return err, q, k, v, mask, line


def dattn_library_ms(q, k, v, mask, back_to_back=False):
    """scaled_dot_product_attention with the boolean mask on the same q, k,
    v (the first backend that runs: cuDNN, memory-efficient, math) → (device
    ms a call from a CUDA graph, back-to-back ms or None, the backend's
    name); the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, mh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]

    def library():
        return sdpa(qh, kh, vh, attn_mask=mh, enable_gqa=True)

    for choice in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(choice):
                library()
                torch.cuda.synchronize()
                ms = graph_us(library) / 1e3
                b2b = median_ms(library) if back_to_back else None
            return ms, b2b, choice.name
        except RuntimeError:
            continue
    return None, None, None


def dattn_times(q, k, v, mask, back_to_back=True, plain_time=True):
    """The decode attention's device time a call (a CUDA graph), its plain
    version's (unless not ``plain_time``: None), scaled_dot_product_
    attention's with the boolean mask (dattn_library_ms) and the bound; with
    ``back_to_back`` the same back to back with the host → a record's
    numbers and a line's text."""
    import tst_torch.kernels.decode_attention as tda

    def kernel():
        return tda.cache_attention(q, k, v, mask)

    def plain():
        return tda.cache_attention_reference(q, k, v, mask)

    ms = graph_us(kernel) / 1e3
    plain_ms = graph_us(plain, calls=2, replays=10) / 1e3 if plain_time else None
    library_ms, lib_b2b, backend = dattn_library_ms(q, k, v, mask, back_to_back)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **dattn_bound(q, k, mask),
           "library": backend}
    text = (f"device ms: kernel {ms:.5f}, plain "
            f"{plain_ms if plain_ms is None else round(plain_ms, 5)}, library "
            f"{library_ms if library_ms is None else round(library_ms, 5)} ({backend}), bound "
            f"{rec['bound_ms']:.5f} ({rec['bound_by']})")
    if back_to_back:
        rec["back_to_back"] = {"ms": median_ms(kernel), "plain_ms": median_ms(plain, samples=10),
                               "library_ms": lib_b2b}
        text += "; back to back: " + ", ".join(f"{key} {val if val is None else round(val, 5)}"
                                              for key, val in rec["back_to_back"].items())
    return rec, text


def dattn_boundary(device, d, b=2, t=3):
    """F1 across the decode attention's rank chunks and its two paths, at
    head dim ``d`` (Qwen2.5-0.5B's 14/2 heads at 64, Llama-3-8B's 32/8 at
    128): query j of a T=3 call sees the first n + j of a row's visible keys,
    for n just below a chunk (so the three span 64 ranks), just below a
    superchunk (the one-kernel path, the cache exactly that long) and just
    below two. Each query must give the same bits alone (T=1), in a cache
    with masked slots between its keys, and in a cache three superchunks
    longer (the two-kernel path), and be within O_TOL·max|ref| of the plain
    version in the first cache → (worst error, a line)."""
    import tst_torch.kernels.decode_attention as tda

    chunk, sup = tda.rank_plan(d)
    h, kvh = (14, 2) if d == 64 else (32, 8)
    rng = np.random.default_rng(d)
    worst, seen = 0.0, []
    for n in (chunk - 1, sup - t + 1, 2 * sup - 1):
        vis = n + t - 1
        q = _randn(rng, (b, t, h, d), device)
        keys, values = (_randn(rng, (b, vis, kvh, d), device) for _ in range(2))
        outs = []
        for s in (vis if vis == sup else vis + 7, vis + 3 * sup):
            k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
            mask = torch.zeros((b, t, s), dtype=torch.bool, device=device)
            for row in range(b):
                pos = torch.from_numpy(np.sort(rng.choice(s, vis, replace=False))).to(device)
                k[row, pos], v[row, pos] = keys[row], values[row]
                for j in range(t):
                    mask[row, j, pos[:n + j]] = True
            got = tda.cache_attention(q, k, v, mask)
            for j in range(t):
                alone = tda.cache_attention(q[:, j: j + 1].contiguous(), k, v,
                                            mask[:, j: j + 1].contiguous())
                if not torch.equal(alone, got[:, j: j + 1]):
                    raise AssertionError(f"decode attention at D={d}, n={n + j}, S={s}: query "
                                         f"{j} of a T={t} call differs from the same query alone")
            if not outs:  # the longer cache must give these bits: checked below
                want = tda.cache_attention_reference(q, k, v, mask).float()
                err = (got.float() - want).abs().max().item()
                if err > O_TOL * want.abs().max().item():
                    raise AssertionError(f"decode attention at D={d}, n={n}, S={s} disagrees "
                                         f"with its plain version: {err:.3e}")
                worst = max(worst, err)
            outs.append(got)
            seen.append((s, tda.scratch_bytes(b, t, s, h, kvh, d) > 0))
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"decode attention at D={d}, n={n}..{n + t - 1}: a cache of "
                                 f"{seen[-1][0]} slots gives other bits than one of "
                                 f"{seen[-2][0]}")
    line = (f"D={d} rank chunks of {chunk}, superchunks of {sup}: visible counts "
            f"{chunk - 1}..{chunk + 1}, {sup - t + 1}..{sup}, {2 * sup - 1}..{2 * sup + 1} bit-equal "
            f"T=1 vs T={t} and across caches of " + ", ".join(
                f"{s} ({'two kernels' if two else 'one kernel'})" for s, two in seen)
            + f"; max|out-ref| {worst:.3e}")
    return worst, line


def phase_kernel_decode_attention(device):
    """The decode step's attention kernel against its plain version at every
    DATTN_CASES case (dattn_check: the greedy step's shape, Qwen2.5-0.5B
    heads, 32 rows, T=1; the verify chunk's, T = gamma + 1; Llama-3-8B heads;
    a cache of the long preset's length; the dry run's two) and across its
    rank chunks and paths (dattn_boundary at both head dims); each case's
    device time from a CUDA graph beside scaled_dot_product_attention with the
    boolean mask and the bound, and at the greedy step's shape the plain
    version's and the same back to back with the host. The record is the
    greedy step's, every case's under ``cases``."""
    import tst_torch.kernels.decode_attention as tda

    worst, rec, cases = 0.0, None, {}
    for case in DATTN_CASES:
        err, q, k, v, mask, line = dattn_check(device, case)
        worst = max(worst, err)
        b, t, h, kvh, d, s = case
        crec, text = dattn_times(q, k, v, mask, back_to_back=rec is None, plain_time=rec is None)
        cases[str(list(case))] = {"max_abs_err": err, **crec}
        if rec is None:  # the greedy step's shape
            rec = dict(crec)
            rec["timed"] = (f"q [{b}, {t}, {h}, {d}] over a cache of {s} slots (a greedy step's "
                            f"layer), device time a call from a CUDA graph; library: "
                            f"scaled_dot_product_attention with the mask ({rec.pop('library')}); "
                            f"back_to_back: CUDA events around 10 calls, the host's launch "
                            f"overhead included; every DATTN_CASES case under cases")
        print(f"[kernel-dattn] {line}; {text}")
        del q, k, v, mask
    for d in tda.HEAD_DIMS:
        err, line = dattn_boundary(device, d)
        worst = max(worst, err)
        print(f"[kernel-dattn] {line}")
    rec["max_abs_err"] = worst
    rec["cases"] = cases
    return rec


def mlp_case(device, m, d, f, timed=False, tag="kernel-mlp"):
    """K4 at (M, D, F) against its plain version (forward, and gradients of
    all four inputs through the autograd Function against autograd of the
    plain version, MLP_TOL), two launches, bit-equal on a second call;
    ``timed``: the call's and each kernel's times, the plain version's,
    the decoder's unfused bf16 MLP and the bound → that record, else None."""
    import tst_torch.kernels.fused_mlp as tfm

    g = torch.Generator(device=device).manual_seed(m + d)
    x = torch.randn(m, d, device=device, generator=g).to(torch.bfloat16)
    wg, wu = ((torch.randn(d, f, device=device, generator=g) / math.sqrt(d))
              .to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn(f, d, device=device, generator=g) / math.sqrt(f)).to(torch.bfloat16)
    dout = torch.randn(m, d, device=device, generator=g).to(torch.bfloat16)
    before = tfm.LAUNCHES
    got = tfm.fused_mlp_forward(x, wg, wu, wd)
    torch.cuda.synchronize()
    want = tfm.swiglu_reference(x, wg, wu, wd)
    fwd_rel = _rel_err(got, want)
    fwd_abs = (got.float() - want.float()).abs().max().item()
    leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    tfm.fused_swiglu_mlp(*leaves).backward(dout)
    plain = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    tfm.swiglu_reference(*plain).backward(dout)
    torch.cuda.synchronize()
    grad_rel = [_rel_err(a.grad, p.grad) for a, p in zip(leaves, plain)]
    del leaves, plain
    print(f"[{tag}] M={m} D={d} F={f}: forward max|out-ref|/max|ref| {fwd_rel:.3e}; "
          f"through autograd vs plain dx {grad_rel[0]:.3e} dWg {grad_rel[1]:.3e} "
          f"dWu {grad_rel[2]:.3e} dWd {grad_rel[3]:.3e} (each <= {MLP_TOL})")
    if (tfm.LAUNCHES != before + 2 or not bool(torch.isfinite(got).all())
            or max([fwd_rel] + grad_rel) > MLP_TOL):
        raise AssertionError(f"fused_swiglu_mlp disagrees with its plain version at "
                             f"{(m, d, f)}")
    _check_bitwise(lambda: (tfm.fused_mlp_forward(x, wg, wu, wd),), (got,), "K4")
    out = None
    if timed:
        def unfused():
            act = torch.nn.functional.silu((x @ wg).float()).to(x.dtype) * (x @ wu)
            return act @ wd

        by_kernel = None  # a tree with one K4 kernel: the call is the kernel
        if hasattr(tfm, "_gate_up"):
            h = tfm._gate_up(x, wg, wu)
            by_kernel = {K4_KERNELS[0]: median_ms(lambda: tfm._gate_up(x, wg, wu)),
                         K4_KERNELS[1]: median_ms(lambda: tfm._down(h, wd))}
            del h
        out = {"max_abs_err": fwd_abs, "ms": median_ms(lambda: tfm._launch(x, wg, wu, wd)),
               "plain_ms": median_ms(lambda: tfm.swiglu_reference(x, wg, wu, wd),
                                     samples=10, reps=3, warmup=1),
               "library_ms": None,  # no single torch call computes the fused MLP
               "unfused_bf16_ms": median_ms(unfused, samples=10, reps=3, warmup=1),
               "kernels_ms": by_kernel,
               **_bound(3 * 2 * m * d * f, 2 * m * d * 2 + 3 * d * f * 2)}
    del x, wg, wu, wd, dout, got, want
    torch.cuda.empty_cache()
    return out


def phase_kernel_mlp(device):
    """K4 against its plain version and the decoder's unfused bf16 MLP
    (mlp_case) at MLP_SHAPES; times at the train step's shape, each
    kernel's on its own."""
    out = [mlp_case(device, m, d, f, timed=i == 0) for i, (m, d, f) in enumerate(MLP_SHAPES)][0]
    m, d, f = MLP_SHAPES[0]

    def tflops(name, ms):  # gate-up makes two products of the three
        share = 2 if "gate_up" in name else 1 if "down" in name else 3
        return 2 * share * m * d * f / ms / 1e9

    kernels = "; ".join(f"{name} {ms:.4f} ms ({tflops(name, ms):.1f} TFLOP/s)"
                        for name, ms in (out["kernels_ms"] or {}).items()) or "one kernel"
    print(f"[kernel-mlp] bit-equal on a second call at every shape; train shape {MLP_SHAPES[0]}: "
          f"call {out['ms']:.4f} ms ({tflops('', out['ms']):.1f} TFLOP/s; median of 30 x 10 "
          f"calls); by kernel (the same): {kernels}; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); plain (f32 products, the reference's numbers) "
          f"{out['plain_ms']:.4f} ms, the decoder's unfused bf16 MLP "
          f"{out['unfused_bf16_ms']:.4f} ms (10 x 3)")
    return out


def _numeric_rows(ds):
    from tst_torch.train.pipeline import gold_values_of

    return np.flatnonzero(np.isfinite(gold_values_of(ds)))


def _decode_chunks(spec, params, seq_len, fold_of_rows, k):
    """(rows per fold of a decode chunk, decode chunks) as the held-out
    decode sizes them for these rows."""
    from tst_torch.models.quant import quantized_bytes
    from tst_torch.train.infer import decode_chunk_rows

    m = max(int((fold_of_rows == f).sum()) for f in range(k))
    chunk = decode_chunk_rows(spec, seq_len, MAX_NEW, k, base_bytes=quantized_bytes(params))
    mc = min(m, chunk)
    return mc, math.ceil(m / mc)


def phase_decode_slice():
    """Path A through the CLI, then K3 against the plain path on the same
    weights and caches, decode step times and a profile of the step."""
    from tst_torch import cli
    from tst_torch.train.pipeline import prepare_blind_eval

    out_dir = tempfile.mkdtemp(prefix="tst_torch_decode_")
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(DECODE + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    with open(os.path.join(out_dir, "blind_eval.json")) as f:
        report = json.load(f)
    cfg, device = cli._resolve(cli.build_parser().parse_args(DECODE))
    ds = cli._load_dataset(cfg)
    tb, tokens, pos, spec, params = prepare_blind_eval(ds, cfg, device)
    rows = _numeric_rows(ds)
    mc, dchunks = _decode_chunks(spec, params, tokens.shape[1], np.zeros(len(rows)), 1)
    mcq_chunks = math.ceil(DECODE_N / SCORER_BATCH)
    want = blind_int4_launches_want(mcq_chunks, dchunks, N_LAYERS)
    mra = report.get("numeric_blind_mra")
    if (rc != 0 or counts != want or report.get("n_numeric") != N_NUMERIC_VSI
            or report["n_mcq"] != N_MCQ_VSI or mra is None or not math.isfinite(mra)):
        raise AssertionError(f"eval-blind int4 rc={rc}, launches {counts} (want {want}), "
                             f"report {report}")
    print(f"[decode-slice] eval-blind synthetic-vsi:0.4 int4 rc=0: n_mcq {report['n_mcq']}, "
          f"n_numeric {report['n_numeric']} in {dchunks} decode chunks of {mc} rows x "
          f"{MAX_NEW} tokens; launches fwd {counts['fwd']} (24 x ({mcq_chunks} MCQ + {dchunks} "
          f"prefill chunks)), int4 {counts['int4']} (7 x 24 x {MAX_NEW - 1} steps x {dchunks}), "
          f"mlp/dkv/dq 0 (as implied); blind_accuracy {report['blind_accuracy']:.4f}, "
          f"numeric_blind_mra {mra}; CLI wall {wall:.2f} s")

    # the first decode step of every numeric row, chunk by chunk, on the same
    # weights and caches: K3 vs plain
    line, ok, state = first_decode_step_gate(params, spec, tokens, pos, rows)
    print(f"[decode-slice] {line}")
    if not ok:
        raise AssertionError("the decode step through K3 disagrees with the plain path")

    # step times and the device's idle share in the step
    step = decode_step_profiles(state)
    for up, name in ((True, "through K3"), (False, "plain path (dequantize, then product)")):
        print(f"[decode-slice] decode step ({DECODE_ROWS} rows, 24 layers), {name}: "
              f"{DECODE_ROWS / step[up]['wall_ms'] * 1e3:.1f} tokens/s; "
              f"{_fmt_profile(step[up])}")
    return counts


def first_decode_step_gate(params, spec, tokens, pos, rows, lora=None, lspec=None,
                           max_new=MAX_NEW):
    """The first decode step of each of ``rows``, chunk by chunk, on the same
    weights (and ``lora``, a single adapter) and caches, through K3 against
    the plain path: (a line to print, whether the logit bound holds with no
    decisive first-token disagreement, the last chunk's state for
    decode_step_profiles)."""
    from tst_torch.models.decode import chunk_logits, prefill

    device = tokens.device
    rels, differ, decisive, gaps = [], 0, 0, []
    for c0 in range(0, len(rows), DECODE_ROWS):
        sel = torch.as_tensor(rows[c0: c0 + DECODE_ROWS], device=device)
        tok, plen = tokens[sel], pos[sel].long() + 1
        s = tok.shape[1]
        with torch.inference_mode():
            tok0, kc, vc, head, rope = prefill(params, tok, plen, max_new, spec, lora=lora,
                                               lora_spec=lspec, use_pallas=True)
            valid = torch.arange(kc.shape[2], device=device)[None, :] < plen[:, None]
            lk, lp = (chunk_logits(params, lora, lspec, spec, tok0[:, None], plen[:, None], s,
                                   valid, kc.clone(), vc.clone(), use_pallas=up, head=head,
                                   rope=rope)[0][:, 0] for up in (True, False))
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError("non-finite logits through K3")
        rels.append(((lk - lp).abs().max() / lp.abs().max()).item())
        n_differ, n_decisive, chunk_gaps = decisive_disagreements(lk, lp)
        differ, decisive, gaps = differ + n_differ, decisive + n_decisive, gaps + chunk_gaps
    line = (f"first decode step of the {len(rows)} rows ({DECODE_ROWS} a chunk), "
            f"same caches: K3 vs plain max|dlogit|/max|logit| {max(rels):.3e} (<= {LOGIT_TOL}); "
            f"argmax disagreements {differ} of {len(rows)} (the plain path's top-2 gap on each: "
            f"{[round(g, 4) for g in gaps]}), decisive (gap > 2 x {LOGIT_TOL} x max|logit|) "
            f"{decisive} (must be 0)")
    ok = max(rels) <= LOGIT_TOL and not decisive
    return line, ok, (params, spec, tok0, plen, s, kc, vc, head, rope)


def decode_state():
    """Phase 13's model and the caches of its first chunk of numeric rows
    after the prefill: the state one greedy decode step runs on."""
    from tst_torch import cli
    from tst_torch.models.decode import prefill
    from tst_torch.train.pipeline import prepare_blind_eval

    cfg, device = cli._resolve(cli.build_parser().parse_args(DECODE))
    ds = cli._load_dataset(cfg)
    _, tokens, pos, spec, params = prepare_blind_eval(ds, cfg, device)
    sel = torch.as_tensor(_numeric_rows(ds)[:DECODE_ROWS], device=device)
    tok, plen = tokens[sel], pos[sel].long() + 1
    with torch.inference_mode():
        tok0, kc, vc, head, rope = prefill(params, tok, plen, MAX_NEW, spec, use_pallas=True)
    return params, spec, tok0, plen, tok.shape[1], kc, vc, head, rope


def decode_step_profiles(state, steps=3):
    """One greedy decode step through K3 and through the plain path on
    ``state`` (decode_state): _profile of each, K3's kernels matched."""
    from tst_torch.models.decode import _decode_step

    params, spec, tok0, plen, s, kc, vc, head, rope = state
    step = {}
    with torch.inference_mode():
        for up in (True, False):
            def one(up=up):
                _decode_step(params, None, None, spec, tok0, plen, s, plen, s, kc, vc,
                             use_pallas=up, head=head, rope=rope)
            step[up] = _profile(one, steps, match="int4_matmul")
    return step


def step_timing(st, match="swiglu"):
    """A train state's median synchronized step ms over STEP_SAMPLES steps
    after the first, the peak device memory over them, and _profile of two
    more steps (kernels named ``match`` counted)."""
    lora, opt = st.lora, st.opt_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for t in range(STEP_SAMPLES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, _ = st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                       st.answer_pos, st.batches[t % st.batches.shape[0]])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(lambda: st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                            st.answer_pos, st.batches[0]), 2, match=match)
    return statistics.median(times[1:]) * 1e3, peak, prof


def phase_steps():
    """For --only mlp-int4: the int4 decode step through K3 (phase 13's
    profile) and the fused int4 train step (phase 14's timing)."""
    step = decode_step_profiles(decode_state())[True]
    print(f"[steps] int4 decode step ({DECODE_ROWS} rows, 24 layers) through K3: "
          f"{_fmt_profile(step)}")
    ms, peak, prof = step_timing(_train_state(base=TRAIN_FUSED))
    print(f"[steps] int4 train step fused (K4): median {ms:.2f} ms over {STEP_SAMPLES} steps "
          f"after the first, peak device memory {peak:.2f} GB; profile of one step: "
          f"{_fmt_profile(prof)}")
    return {"decode_step_wall_ms": step["wall_ms"], "decode_step_busy_ms": step["busy_ms"],
            "decode_step_k3_ms": step.get("match", (None, None))[1],
            "fused_step_ms": ms, "fused_step_peak_gb": peak, "fused_step_busy_ms": prof["busy_ms"],
            "fused_step_k4_ms": prof.get("match", (None, None))[1]}


def phase_train_fused():
    """Path B through the CLI; one step's gradients fused vs the unfused
    plain path; step times fused vs unfused, peak memory, a profile."""
    from tst_torch import cli

    out_dir = tempfile.mkdtemp(prefix="tst_torch_fused_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(TRAIN_FUSED + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "sx.jsonl")) as f:
        sx_rows = [json.loads(line) for line in f]
    st = _train_state(base=TRAIN_FUSED)
    cfg, _ = cli._resolve(cli.build_parser().parse_args(TRAIN_FUSED))
    rows = _numeric_rows(cli._load_dataset(cfg))
    k, steps = report["k"], report["train_steps"]
    mcq_fold = np.where(st.tb.gold >= 0, st.fold_id, -1)
    chunks = k * math.ceil(max(int((mcq_fold == f).sum()) for f in range(k)) / SCORER_BATCH)
    mc, dchunks = _decode_chunks(st.spec, st.params, st.tokens.shape[1], st.fold_id[rows], k)
    want = {"fwd": N_LAYERS * (steps + chunks + dchunks), "dkv": N_LAYERS * steps,
            "dq": N_LAYERS * steps, "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0,
            "int4": INT4_PROJ * N_LAYERS * (MAX_NEW - 1) * dchunks, "mlp": N_LAYERS * steps,
            "dattn": N_LAYERS * (MAX_NEW - 1) * dchunks}
    loss = report["final_loss"]
    sx = np.array([r["s_x"] for r in sx_rows], np.float64)
    mra = report.get("numeric_blind_mra")
    if (rc != 0 or counts != want or report.get("n_numeric") != FUSED_NUMERIC
            or report["n_mcq"] != FUSED_MCQ or len(sx_rows) != FUSED_ROWS
            or "numeric_decode_wall_seconds" not in report or mra is None
            or not math.isfinite(mra) or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()):
        raise AssertionError(f"diagnose-sft int4 fused rc={rc}, launches {counts} "
                             f"(want {want}), report {report}")
    print(f"[train-fused] diagnose-sft int4 fused_mlp rc=0, {steps} steps x {k} folds, "
          f"{chunks} scorer chunks, {dchunks} decode chunks of {k} x {mc} rows; launches "
          f"mlp {counts['mlp']} fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} "
          f"int4 {counts['int4']} (as implied); CLI wall {wall:.2f} s; peak device memory "
          f"{peak_gb:.2f} GB")
    print(f"[train-fused] report.json {json.dumps(report, sort_keys=True)}")
    top = sorted(sx_rows, key=lambda r: -r["s_x"])[:5]
    print(f"[train-fused] s(x) table: {len(sx_rows)} rows, mean {sx.mean():.4f}, quantiles "
          f"10/50/90% {np.quantile(sx, [0.1, 0.5, 0.9]).round(4).tolist()}; top 5 "
          f"{json.dumps(top)}")

    # the step fused through the kernels vs the unfused plain path
    line, ok = step_gate(_fused_gate_case())
    print(f"[train-fused] {PLAIN_ROWS} rows per fold, fused kernels vs unfused plain path: "
          f"{line}")
    if not ok:
        raise AssertionError("the fused train step disagrees with the unfused plain path")
    torch.cuda.empty_cache()

    # step times fused vs unfused (both int4, flash kernels), peak memory
    timing = {True: step_timing(st)}
    st2 = _train_state(["model.fused_mlp=false"], base=TRAIN_FUSED)
    timing[False] = step_timing(st2)
    del st2
    torch.cuda.empty_cache()
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    for fused, name in ((True, "fused (K4)"), (False, "unfused")):
        ms, peak, prof = timing[fused]
        print(f"[train-fused] int4 step {name} ({rows_per_step} rows of {st.tokens.shape[1]} "
              f"tokens): median {ms:.2f} ms over {STEP_SAMPLES} steps after the first "
              f"({rows_per_step / ms * 1e3:.1f} samples/s), peak device memory {peak:.2f} GB; "
              f"profile of one step: {_fmt_profile(prof)}")
    return counts


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_diagnose_rf(device):
    """``diagnose-rf`` through the CLI, the forests traversed on the card:
    each fold's forest traversed again on the host path (the same trees,
    f64 thresholds) gives the same probabilities and the same s(x) ranking;
    no kernel runs; the planted length bias lifts blind accuracy above
    chance. The fit's wall, and the traversal's time on the card and on the
    host."""
    from tst_torch import cli
    from tst_torch.diagnose.score import bias_scores
    from tst_torch.features import forest as tforest

    folds = []
    fit, full = tforest.RandomForest.fit, tforest.RandomForest.predict_proba_full

    def timed_fit(self, x, y):
        t0 = time.perf_counter()
        out = fit(self, x, y)
        folds.append({"fit_s": time.perf_counter() - t0, "n_train": len(y)})
        return out

    def recorded(self, x, n_classes, backend="jax"):
        probs = full(self, x, n_classes, backend)
        folds[-1].update(forest=self, x=x, n_classes=n_classes, backend=backend, probs=probs)
        return probs

    out_dir = tempfile.mkdtemp(prefix="tst_torch_rf_")
    _zero_launch_counts()
    tforest.RandomForest.fit, tforest.RandomForest.predict_proba_full = timed_fit, recorded
    try:
        t0 = time.perf_counter()
        rc = cli.main(RF + ["--out", out_dir])
        wall = time.perf_counter() - t0
    finally:
        tforest.RandomForest.fit, tforest.RandomForest.predict_proba_full = fit, full
    counts = _launch_counts()
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    rows = _read_jsonl(os.path.join(out_dir, "sx.jsonl"))
    cfg, _ = cli._resolve_k(cli.build_parser().parse_args(RF))
    ds = cli._load_dataset(cfg)
    gold = np.array([s.answer_index for s in ds], np.int32)
    n_opts = np.array([len(s.options) for s in ds], np.int32)
    fold = np.array([r["fold"] for r in rows])
    s_dev = np.array([np.nan if r["s_x"] is None else r["s_x"] for r in rows], np.float64)
    probs_host = np.full((len(ds), folds[0]["n_classes"]), np.nan, np.float32)
    err, host_s = 0.0, 0.0
    for f, rec in enumerate(folds):
        forest = rec["forest"]
        if rec["backend"] != "jax" or forest.packed().feature.device.type != "cuda":
            raise AssertionError(f"fold {f} was not traversed on the card: backend "
                                 f"{rec['backend']}, device {forest.packed().feature.device}")
        t0 = time.perf_counter()
        host = forest.predict_proba_full(rec["x"], rec["n_classes"], backend="sklearn")
        host_s += time.perf_counter() - t0
        err = max(err, float(np.abs(host - rec["probs"]).max()))
        probs_host[(fold == f) & (gold >= 0)] = host
    s_host = bias_scores(np.nan_to_num(probs_host), gold, n_opts, rule=cfg.rf.score_rule)
    s_host = np.where(np.isfinite(probs_host).all(-1), s_host, np.nan)
    packed = folds[0]["forest"].packed()
    xt = torch.as_tensor(folds[0]["x"], device=device)
    dev_ms = median_ms(lambda: tforest.forest_predict_proba(packed, xt), samples=10, reps=3)
    acc, chance = report["blind_accuracy"], report["chance_accuracy"]
    zero = {key: 0 for key in counts}
    print(f"[diagnose-rf] diagnose-rf synthetic:0.5 n={RF_ROWS} k={cfg.data.k} rc={rc}: "
          f"blind_accuracy {acc:.4f} (chance {chance:.4f}), fold_accuracies "
          f"{report['fold_accuracies']}, top features {list(report['top_features'])[:5]}; "
          f"device vs host traversal of the same {len(folds)} forests of {cfg.rf.n_estimators} "
          f"trees: max|dprob| {err:.3e} (<= {RF_TOL}), same s(x) ranking "
          f"{same_ranking(s_dev, s_host)}; kernel launches {sum(counts.values())} (must be 0)")
    print(f"[diagnose-rf] fit (the port's own CART forest, host numpy) "
          f"{sum(r['fit_s'] for r in folds):.2f} s over {len(folds)} folds "
          f"({[round(r['fit_s'], 3) for r in folds]} s at {[r['n_train'] for r in folds]} rows, "
          f"{folds[0]['x'].shape[1]} features); traversal of fold 0 ({len(folds[0]['x'])} rows, "
          f"max depth {packed.max_depth}, {packed.feature.shape[1]} nodes): card {dev_ms:.4f} ms "
          f"(median of 10 x 3 calls), host {host_s / len(folds) * 1e3:.2f} ms a fold; CLI wall "
          f"{wall:.2f} s")
    if (rc != 0 or err > RF_TOL or not same_ranking(s_dev, s_host) or counts != zero
            or not acc > chance or len(rows) != len(ds)):
        raise AssertionError("diagnose-rf on the card failed its gates")
    return {"fit_s": sum(r["fit_s"] for r in folds), "traverse_ms": dev_ms, "max_abs_err": err}


def _ibp_artifacts(out_dir, n):
    """The IBP run's report (strict JSON), audit and split, checked."""
    from tst_torch.data.schema import BlindDataset

    with open(os.path.join(out_dir, "ibp_report.json")) as f:
        report = strict_json(f.read())
    check_audit(report, n)
    kept = [s.id for s in BlindDataset.load_jsonl(os.path.join(out_dir, "debiased.jsonl"))]
    removed = [s.id for s in BlindDataset.load_jsonl(os.path.join(out_dir, "removed.jsonl"))]
    check_split(n, kept, removed, _read_jsonl(os.path.join(out_dir, "sx.jsonl")))
    return report, len(kept), len(removed)


def ibp_round_plan(runner, alive, r):
    """What an SFT round of IBP launches, from the round's own survivors:
    its train steps (the batches it draws), its scorer chunks (each fold's
    held-out MCQ rows in chunks of 32, per scoring pass) and its decode
    prefill chunks (the surviving numeric rows, as the held-out decode
    sizes them), as ``_SftRoundRunner.run_round`` builds them."""
    from tst_torch.data.folds import kfold_assign
    from tst_torch.train.sft import make_fold_batches

    cfg, k, ds = runner.cfg, runner.k, runner.ds
    sub_idx = np.flatnonzero(alive)
    fold = np.full(len(ds), -1, np.int32)
    fold[sub_idx] = kfold_assign(ds.subset(sub_idx), k, cfg.data.seed + 1000 * r)
    seeds = max(int(cfg.optim.n_seeds), 1)
    steps = sum(make_fold_batches(fold, k, cfg.optim.batch_size, cfg.optim.epochs,
                                  cfg.data.seed + r + 31 * s, batch_multiple=cfg.mesh.data,
                                  include_mask=alive).shape[0] for s in range(seeds))
    mcq_fold = np.where(runner.tb.gold >= 0, fold, -1)
    passes = seeds * (len(runner.score_after) + 1)
    chunks = passes * k * math.ceil(max(int((mcq_fold == f).sum()) for f in range(k))
                                    / SCORER_BATCH)
    numeric = _numeric_rows(ds)
    numeric = numeric[alive[numeric]]
    dchunks = 0
    if len(numeric):
        dchunks = seeds * _decode_chunks(runner.spec, runner.params, runner.tokens.shape[1],
                                         fold[numeric], k)[1]
    return {"steps": steps, "scorer_chunks": chunks, "decode_chunks": dchunks}


class _RecordIbp:
    """While a debias-ibp run goes in the block, the list it gives gets each
    SFT round's runner and survivors, and round 0's entry also its last
    held-out scoring call (the call's arguments with its adapters cloned,
    its keywords and the probabilities it gave)."""

    def __enter__(self):
        from tst_torch.debias import ibp as tibp

        rounds = []
        self.saved = run_round, score = tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq

        def recorded_round(runner, r, alive):
            rounds.append({"round": r, "alive": alive.copy(), "runner": runner})
            return run_round(runner, r, alive)

        def recorded_score(*args, **kw):
            probs = score(*args, **kw)
            if len(rounds) == 1:  # round 0: keep its last scoring pass's adapters
                lora = {p: {n: t.clone() for n, t in ab.items()} for p, ab in args[1].items()}
                rounds[0]["score"] = (args[:1] + (lora,) + args[2:], kw, probs)
            return probs

        tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq = recorded_round, recorded_score
        return rounds

    def __exit__(self, *exc):
        from tst_torch.debias import ibp as tibp

        tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq = self.saved


def round0_sx(rounds, f32=False, **kw):
    """(s(x), probabilities, MCQ mask) of round 0's held-out MCQ rows from
    _RecordIbp's rounds: the recorded call's own, or with ``kw`` over
    its keywords (or ``f32``: base weights, adapters and specs in f32) the
    call made again."""
    from tst_torch.diagnose.score import bias_scores
    from tst_torch.train.infer import score_heldout_mcq
    from tst_torch.train.sft import tree_map

    args, rec_kw, probs = rounds[0]["score"]
    if f32:
        def up(tree):
            return tree_map(lambda t: t.float() if t.is_floating_point() else t, tree)

        args = (up(args[0]), up(args[1]), dataclasses.replace(args[2], dtype=torch.float32),
                dataclasses.replace(args[3], dtype=torch.float32)) + args[4:]
    if f32 or kw:
        probs = score_heldout_mcq(*args, **{**rec_kw, **kw})
    runner = rounds[0]["runner"]
    mcq = args[8] >= 0
    s = bias_scores(probs, runner.tb.gold, runner.tb.n_options, rule=runner.cfg.rf.score_rule)
    return s[mcq], probs, mcq


def run_ibp_gated(argv, n, rounds_want, n_layers, remat, tag):
    """``debias-ibp`` with the SFT diagnostic through the CLI: the rounds,
    the audit and the split add up, the report is strict JSON, the attention
    kernels launch as the rounds' own steps, scorer chunks and decode
    prefills imply; round 0's final adapters re-score its held-out MCQ rows
    through the plain attention, and the two s(x) agree in rank. Returns
    (launch counts, the rounds recorded: each one's runner, survivors, plan
    and round 0's scoring call, the report, peak device GB)."""
    from tst_torch import cli
    from tst_torch.eval.parity import spearman

    out_dir = tempfile.mkdtemp(prefix="tst_torch_ibp_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    with _RecordIbp() as rounds:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--out", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, n_kept, n_removed = _ibp_artifacts(out_dir, n)
    for rec in rounds:
        rec["plan"] = ibp_round_plan(rec["runner"], rec["alive"], rec["round"])
    want = ibp_launches_want([r["plan"] for r in rounds], n_layers, remat)
    if rc != 0 or report["rounds_run"] != rounds_want or len(rounds) != rounds_want:
        raise AssertionError(f"debias-ibp rc={rc}, rounds_run {report['rounds_run']}, "
                             f"rounds recorded {len(rounds)}")
    check_launches(counts, want, "debias-ibp")
    walls = [{key: v for key, v in row.items() if key.startswith("round_")}
             for row in report["per_round"]]
    cfg = rounds[0]["runner"].cfg
    print(f"[{tag}] debias-ibp {cfg.data.bench} n={n} k={cfg.data.k}, {rounds_want} rounds "
          f"rc=0: stop {report['stop_reason']}, n_alive "
          f"{[r['n_alive'] for r in report['per_round']]}, "
          f"pruned {[r['pruned_this_round'] for r in report['per_round']]}, n_debiased "
          f"{report['n_debiased']} (debiased.jsonl {n_kept} + removed.jsonl {n_removed}; audit, "
          f"split and kept column agree; strict JSON); blind accuracy by round "
          f"{[round(r['blind_accuracy'], 4) for r in report['per_round']]} (chance "
          f"{[round(r['chance'], 4) for r in report['per_round']]}), numeric MRA "
          f"{[r.get('numeric_mra') for r in report['per_round']]}; rf_sft_spearman "
          f"{report.get('rf_sft_spearman')}; rounds' plans {[r['plan'] for r in rounds]}; "
          f"launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} dattn "
          f"{counts['dattn']} (as implied{', the forward twice a step under remat' if remat else ''}"
          f"); CLI wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB")
    print(f"[{tag}] round walls (s): {json.dumps(walls)}")

    # round 0's final adapters: its held-out MCQ rows through the plain attention
    s_k, probs_k, mcq = round0_sx(rounds)
    t0 = time.perf_counter()
    s_p, probs_p, _ = round0_sx(rounds, use_pallas=False)
    plain_s = time.perf_counter() - t0
    rho = spearman(s_k, s_p)
    print(f"[{tag}] round 0's held-out s(x) on its final adapters, {int(mcq.sum())} MCQ "
          f"rows: kernels vs plain attention Spearman {rho:.6f} (>= {IBP_SPEARMAN}), "
          f"max|dprob| {float(np.abs(probs_k - probs_p)[mcq].max()):.3e}; plain scoring "
          f"{plain_s:.2f} s")
    if not rho >= IBP_SPEARMAN:
        raise AssertionError("IBP round 0's s(x) through the kernels disagrees in rank with "
                             "the plain attention")
    return counts, rounds, report, peak_gb


def phase_debias_ibp():
    """Phase 16: run_ibp_gated on Qwen2.5-0.5B."""
    with _CutDepth("qwen2.5-0.5b", IBP_LAYERS):
        counts, rounds, _, _ = run_ibp_gated(IBP, IBP_N, IBP_ROUNDS, IBP_LAYERS, False,
                                             "debias-ibp")
    del rounds
    torch.cuda.empty_cache()
    return counts


def phase_debias_ibp_rf():
    """``debias-ibp --set ibp.diagnostic=rf`` through the CLI: two rounds,
    each pruning prune_mask's budget, the audit and split adding up, and no
    kernel launched."""
    from tst_torch import cli

    out_dir = tempfile.mkdtemp(prefix="tst_torch_ibp_rf_")
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(IBP_RF + ["--out", out_dir])
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    report, n_kept, n_removed = _ibp_artifacts(out_dir, RF_ROWS)
    cfg, _ = cli._resolve_k(cli.build_parser().parse_args(IBP_RF))
    print(f"[debias-ibp-rf] debias-ibp ibp.diagnostic=rf synthetic:0.5 n={RF_ROWS} k={cfg.data.k} "
          f"rc={rc}: rounds_run {report['rounds_run']}, n_alive "
          f"{[r['n_alive'] for r in report['per_round']]}, pruned "
          f"{[r.get('pruned_this_round') for r in report['per_round']]} (prune_rate "
          f"{cfg.ibp.prune_rate}), n_debiased {report['n_debiased']} ({n_kept} + {n_removed}); "
          f"blind accuracy by round {[round(r['blind_accuracy'], 4) for r in report['per_round']]}"
          f"; round walls {[r['round_wall_s'] for r in report['per_round']]} s; kernel launches "
          f"{sum(counts.values())} (must be 0); CLI wall {wall:.2f} s")
    if (rc != 0 or report["rounds_run"] != IBP_RF_ROUNDS
            or not pruned_as_implied(report, cfg.ibp.prune_rate)
            or counts != {key: 0 for key in counts}):
        raise AssertionError("debias-ibp with the RF diagnostic failed its gates")


def hf_state_dict(params):
    """Our parameter tree → HF's names and layout: name → tensor (views of
    ``params``; transposed where HF stores [out, in])."""
    out = {}
    for key, t in params.items():
        if key == "layers":
            continue
        name, transpose = _HF_TOP[key]
        out[name] = t.T if transpose else t
    for key, stack in params["layers"].items():
        name, transpose = _HF_LAYER[key]
        for i in range(stack.shape[0]):
            out[f"model.layers.{i}.{name}"] = stack[i].T if transpose else stack[i]
    return out


def write_safetensors(path, tensors):
    """A .safetensors file of ``tensors`` (name → tensor, any device): the
    8-byte little-endian header length, the JSON header padded to 8 bytes,
    then each tensor's bytes, moved to the host one tensor at a time.
    Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            host = t.detach().contiguous().cpu().reshape(-1)
            f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(head) + offset


def write_checkpoint(path, params, config):
    """An HF checkpoint directory: model.safetensors of ``params`` under HF
    names, and ``config``. Returns (bytes written, seconds)."""
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    n = write_safetensors(os.path.join(path, "model.safetensors"), hf_state_dict(params))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return n, time.perf_counter() - t0


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def trees_equal(a, b):
    """The leaf paths where two parameter trees differ (shape, dtype or any
    bit); empty when they are equal."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    return sorted(set(la) ^ set(lb)) + [
        p for p in sorted(set(la) & set(lb))
        if la[p].dtype != lb[p].dtype or not torch.equal(la[p], lb[p])]


def sft_launches_want(steps, chunks, n_layers, remat=False):
    """The attention kernels' launches of an unpacked diagnose-sft run: one
    forward a layer for each train step and scorer chunk, and under full
    remat a second for each step (the backward recomputes each layer, the
    kernel's forward with it); one dK/dV and one dQ a layer for each step."""
    fwd = steps * (2 if remat in (True, "full", "dots") else 1) + chunks
    return {"fwd": n_layers * fwd, "dkv": n_layers * steps, "dq": n_layers * steps,
            "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0, "int4": 0, "mlp": 0, "dattn": 0}


def blind_int4_launches_want(mcq_chunks, decode_chunks, n_layers):
    """An int4 eval-blind's launches: one forward a layer for each MCQ chunk
    and each decode chunk's prefill, and K3 on each of a layer's 7 int4
    projections and the decode attention a layer in each decode step after
    the prefill's."""
    return {"fwd": n_layers * (mcq_chunks + decode_chunks), "dkv": 0, "dq": 0, "fwd_seg": 0,
            "dkv_seg": 0, "dq_seg": 0,
            "int4": INT4_PROJ * n_layers * (MAX_NEW - 1) * decode_chunks, "mlp": 0,
            "dattn": n_layers * (MAX_NEW - 1) * decode_chunks}


def multitoken_launches_want(rows, options, n_layers, batch=MULTI_BATCH):
    """The multi-token scorer's forward launches: one a layer for each
    option of each chunk of ``batch`` rows."""
    return n_layers * options * math.ceil(rows / batch)


def generate_launches_want(chunks, max_new, n_layers):
    """A greedy ``generate``'s launches on an int4 base: one forward a layer
    for each chunk's prefill, and K3 on each of a layer's 7 projections in
    each decode step after the prefill's token, and the decode attention a
    layer in each step."""
    return {"fwd": n_layers * chunks, "dkv": 0, "dq": 0, "fwd_seg": 0, "dkv_seg": 0,
            "dq_seg": 0, "int4": INT4_PROJ * n_layers * (max_new - 1) * chunks, "mlp": 0,
            "dattn": n_layers * (max_new - 1) * chunks}


def spec_launches_want(chunks, rounds, gamma, n_layers):
    """A speculative ``generate``'s launches, target and draft on int4
    bases: two forwards a layer for each chunk (the target's prefill and the
    draft's); in each round, gamma + 1 draft steps and the target's verify
    chunk, each with K3 on a layer's 7 projections and the decode attention
    a layer (``rounds`` summed over the chunks)."""
    return {"fwd": 2 * n_layers * chunks, "dkv": 0, "dq": 0, "fwd_seg": 0, "dkv_seg": 0,
            "dq_seg": 0, "int4": INT4_PROJ * n_layers * (gamma + 2) * rounds, "mlp": 0,
            "dattn": n_layers * (gamma + 2) * rounds}


def first_divergence(a, b):
    """Per row of two [rows, T] token arrays, the first column where they
    differ; -1 where the rows are equal."""
    differ = np.asarray(a) != np.asarray(b)
    return np.where(differ.any(-1), differ.argmax(-1), -1)


def spec_token_gate(greedy, spec, lp, tol=LOGIT_TOL):
    """Speculative decode's tokens against greedy decode's: (rows that
    differ, the decisive ones among them, each differing row's margin).
    ``lp`` [rows that differ, vocab] holds the plain path's f32 logits at
    each such row's first divergent position; the margin is the plain
    logit of greedy's token less that of speculative decode's token there.
    A divergence is decisive when its margin exceeds twice the error the
    logit tolerance lets through, ``tol · max|lp|``, as in
    decisive_disagreements: an error within the tolerance (the verify
    chunk's products at another M) could not have flipped it."""
    col = first_divergence(greedy, spec)
    rows = np.flatnonzero(col >= 0)
    if not len(rows):
        return rows, 0, []
    greedy, spec = np.asarray(greedy), np.asarray(spec)
    lp = torch.as_tensor(lp, dtype=torch.float32)
    idx = torch.arange(len(rows))
    margin = (lp[idx, torch.as_tensor(greedy[rows, col[rows]])]
              - lp[idx, torch.as_tensor(spec[rows, col[rows]])])
    decisive = margin.abs() > 2 * tol * lp.abs().max()
    return rows, int(decisive.sum()), margin.tolist()


def _timed_build(cfg, device):
    """(spec, params, seconds): build_model on the run's device, synchronized."""
    from tst_torch.data.tokenize import ByteTokenizer
    from tst_torch.train.pipeline import build_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, params = build_model(cfg, ByteTokenizer(), device)
    torch.cuda.synchronize()
    return spec, params, time.perf_counter() - t0


def same_report(got, want, skip=("wall_seconds",)):
    """The keys where two run reports differ, apart from ``skip``; empty when
    they agree (floats compared exactly)."""
    keys = (set(got) | set(want)) - set(skip)
    return sorted(key for key in keys if got.get(key, got) != want.get(key, want))


def phase_checkpoint_qwen(slice_probs, slice_report):
    """Phase 4's weights written as an HF checkpoint at Qwen2.5-0.5B's full
    depth, loaded back through eval-blind (model.path, byte tokenizer): its
    report equal to phase 4's, apart from the wall; the spec that the run
    builds from config.json equal to phase 4's, apart from max_seq_len;
    every leaf bit-equal to what was written; and the letter probabilities,
    scored with that spec, equal to phase 4's in-memory run."""
    from tst_torch import cli
    from tst_torch.train.infer import score_all_mcq
    from tst_torch.train.pipeline import prepare_blind_eval

    cfg, device = cli._resolve(cli.build_parser().parse_args(SLICE))
    tb, tokens, pos, spec, params = prepare_blind_eval(cli._load_dataset(cfg), cfg, device)
    ckpt = tempfile.mkdtemp(prefix="tst_torch_qwen_ckpt_")
    try:
        nbytes, write_s = write_checkpoint(ckpt, params, QWEN_CONFIG)
        argv = SLICE + ["--set", f"model.path={ckpt}", "--set", "model.tokenizer=byte"]
        out_dir = tempfile.mkdtemp(prefix="tst_torch_qwen_run_")
        _zero_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--out", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        want = sft_launches_want(0, math.ceil(N_SAMPLES / SCORER_BATCH), N_LAYERS)
        with open(os.path.join(out_dir, "blind_eval.json")) as f:
            report = json.load(f)
        cfg2, _ = cli._resolve(cli.build_parser().parse_args(argv))
        spec2, loaded, load_s = _timed_build(cfg2, device)
        differ = trees_equal(loaded, params)
        probs = score_all_mcq(loaded, spec2, tokens, pos, tb.option_token_ids, tb.n_options,
                              use_pallas=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    n_params = sum(t.numel() for _, t in _leaves(loaded))
    same = bool(np.array_equal(probs, slice_probs))
    report_differs = same_report(report, slice_report)
    spec_differs = [f.name for f in dataclasses.fields(spec) if f.name != "max_seq_len"
                    and getattr(spec2, f.name) != getattr(spec, f.name)]
    print(f"[checkpoint-qwen] Qwen2.5-0.5B, {spec.n_layers} layers, {n_params / 1e6:.1f} M "
          f"parameters: "
          f"wrote {nbytes / 1e9:.3f} GB in {write_s:.2f} s; eval-blind model.path rc={rc}, "
          f"launches fwd {counts['fwd']} (want {want['fwd']}), blind_accuracy "
          f"{report['blind_accuracy']:.4f} (phase 4's {slice_report['blind_accuracy']:.4f}; "
          f"report keys differing from phase 4's, the wall aside: {report_differs}), CLI wall "
          f"{wall:.2f} s; spec from config.json: fields differing from phase 4's, max_seq_len "
          f"aside: {spec_differs} (max_seq_len {spec2.max_seq_len} vs {spec.max_seq_len}); "
          f"load {load_s:.3f} s ({nbytes / load_s / 1e9:.2f} GB/s, the file just written: the "
          f"page cache); leaves differing from the written ones: {differ}; letter "
          f"probabilities with that spec equal to phase 4's: {same} "
          f"(max|d| {float(np.abs(probs - slice_probs).max()):.3e})")
    if (rc != 0 or counts != want or differ or not same or report_differs or spec_differs
            or report["n_mcq"] != N_SAMPLES):
        raise AssertionError("the Qwen2.5-0.5B checkpoint round trip failed")
    return {"fwd": counts["fwd"], "load_s": load_s, "gb": nbytes / 1e9}


def _llama_argv(ckpt, base):
    return base + ["--set", f"model.path={ckpt}"]


def _llama_step_gates(ckpt):
    """One step of phase 19a's state with remat (the preset's True) against
    one without: the step gates, bit-equality, and each one's median step,
    peak device memory and profile."""
    out = {}
    for remat in (True, False):
        st = _train_state([f"model.remat={str(remat).lower()}"],
                          base=_llama_argv(ckpt, LLAMA_TRAIN))
        rng = torch.Generator(device=st.tokens.device).manual_seed(7)
        for ab in st.lora.values():
            ab["b"] = (B_SCALE * torch.randn(ab["b"].shape, generator=rng,
                                          device=rng.device)).to(ab["b"].dtype)
        idx = torch.as_tensor(st.batches[0], dtype=torch.long, device=st.tokens.device)
        grads = st.trainer.loss_and_grads(st.params, st.lora, st.tokens[idx], st.loss_mask[idx],
                                          st.answer_pos[idx])
        out[remat] = (grads, step_timing(st, match="flash"))
        rows = (int(np.prod(st.batches.shape[1:])), st.tokens.shape[1])
        if remat:
            multi = _multitoken_gate(st)
        del st
        torch.cuda.empty_cache()
    (gr, tr), (gp, tp) = out[True], out[False]
    line, ok = _step_gates(gr, gp)
    bit_equal = bool(torch.equal(gr[0], gp[0]) and all(
        torch.equal(gr[1][p][n], gp[1][p][n]) for p in gr[1] for n in gr[1][p]))
    return line, ok, bit_equal, tr, tp, multi, rows


def multitoken_agree(pk, pp, ll_k, ll_p):
    """(ok, max|dprob|, max|dll|, the dll bound): the multi-token scorer's
    letter probabilities (K1 ``pk``, plain ``pp``) within PROB_TOL, finite
    and summing to 1, and its summed option log-probs within LOGIT_TOL of
    the plain ones' largest magnitude."""
    diff = float(np.abs(pk - pp).max())
    ll_diff = float(np.abs(ll_k - ll_p).max())
    ll_tol = LOGIT_TOL * float(np.abs(ll_p).max())
    ok = bool(diff <= PROB_TOL and ll_diff <= ll_tol and np.isfinite(ll_k).all()
              and np.isfinite(pk).all() and np.abs(pk.sum(-1) - 1).max() < 1e-4)
    return ok, diff, ll_diff, ll_tol


def _multitoken_gate(st):
    """The multi-token scorer at Llama-3-8B's width on MULTI_OPTIONS for the
    first MULTI_ROWS rows, K1 against the plain attention: the letter
    probabilities through score_heldout_mcq within PROB_TOL, and the summed
    option log-probs the scorer softmaxes within LOGIT_TOL of their largest
    magnitude (the bf16 logit bound of phase 13, here on a sum of T
    tokens' log-probs)."""
    from tst_torch.train.infer import (heldout_index_grid, make_mcq_scorer_multitoken,
                                       score_heldout_mcq)

    opts = np.array(MULTI_OPTIONS, np.int32)
    n = MULTI_ROWS
    tokens, pos = st.tokens[:n], st.answer_pos[:n]
    folds = np.zeros(n, np.int32)
    args = (st.params, None, st.spec, None, tokens, pos, opts[:, 0], np.full(n, len(opts)),
            folds, 1)
    _zero_launch_counts()
    pk = score_heldout_mcq(*args, use_pallas=True, option_seqs=opts)
    launches = _launch_counts()["fwd"]
    pp = score_heldout_mcq(*args, use_pallas=False, option_seqs=opts)
    idx, _ = heldout_index_grid(folds, 1)
    ll = {use: make_mcq_scorer_multitoken(st.spec, use_pallas=use, batch=MULTI_BATCH)(
        st.params, None, tokens, pos, opts, idx)[0].cpu().numpy() for use in (True, False)}
    ok, diff, ll_diff, ll_tol = multitoken_agree(pk, pp, ll[True], ll[False])
    spread = ll[False].max(-1) - ll[False].min(-1)
    want = multitoken_launches_want(n, len(opts), st.spec.n_layers)
    line = (f"multi-token scorer ({n} rows, C={len(opts)} options of {opts.shape[1]} tokens, "
            f"chunks of {MULTI_BATCH}): K1 vs plain max|dprob| {diff:.3e} (<= {PROB_TOL}), "
            f"summed log-probs max|d| {ll_diff:.3e} nats (<= {ll_tol:.3e}: {LOGIT_TOL} x "
            f"max|ll| {float(np.abs(ll[False]).max()):.3f}); the options' log-prob spread a "
            f"row {float(spread.min()):.3f}-{float(spread.max()):.3f} nats, top probability "
            f"a row median {float(np.median(pp.max(-1))):.4f}; fwd launches {launches} (want "
            f"{want}), probabilities finite and summing to 1: {bool(np.isfinite(pk).all())}, "
            f"{float(np.abs(pk.sum(-1) - 1).max()):.1e}")
    return line, ok and launches == want


def _llama_attention_times(device):
    """K1's forward and backward pair at phase 19a's train step (5 folds x 8
    rows of 512 tokens, Llama-3-8B heads): k1_case, the plain versions
    timed too."""
    b, s, h, kvh, d = LLAMA_STEP_SHAPE
    return {"shape": list(LLAMA_STEP_SHAPE),
            **k1_case(device, LLAMA_STEP_SHAPE, s + d + 3, plain=True, tag="llama")}


def phase_llama(device):
    """Llama-3-8B's width, LLAMA_LAYERS of its 32 layers, from a checkpoint
    written here: (a) diagnose-sft under the sft-mmmu-llama8b preset with
    remat, K1 at D=128 forward and backward, the remat step against one
    without and the multi-token scorer; (b) the same checkpoint quantized to
    int4 on arrival, eval-blind with numeric rows decoded through K3."""
    from tst_torch import cli
    from tst_torch.models.decoder import init_params
    from tst_torch.models.hf_load import spec_from_hf_config
    from tst_torch.train.pipeline import prepare_blind_eval

    config = {**LLAMA_CONFIG, "num_hidden_layers": LLAMA_LAYERS}
    ckpt = tempfile.mkdtemp(prefix="tst_torch_llama_ckpt_")
    try:
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(config, f)
        spec = spec_from_hf_config(ckpt, name="llama3-8b")
        params = init_params(torch.Generator(device=device).manual_seed(19), spec)
        nbytes, write_s = write_checkpoint(ckpt, params, config)
        n_params = sum(t.numel() for _, t in _leaves(params))

        # (a) the preset's diagnose-sft, remat=True
        argv = _llama_argv(ckpt, LLAMA_TRAIN)
        out_dir = tempfile.mkdtemp(prefix="tst_torch_llama_sft_")
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--out", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sft_counts = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out_dir, "report.json")) as f:
            report = json.load(f)
        rows = _read_jsonl(os.path.join(out_dir, "sx.jsonl"))
        folds = np.array([r["fold"] for r in rows])
        k, steps = report["k"], report["train_steps"]
        chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / SCORER_BATCH)
        want = sft_launches_want(steps, chunks, spec.n_layers, remat=True)
        cfg, _ = cli._resolve(cli.build_parser().parse_args(argv))
        _, loaded, load_s = _timed_build(cfg, device)
        differ = trees_equal(loaded, params)
        del loaded, params
        torch.cuda.empty_cache()
        if differ:
            raise AssertionError(f"the Llama-width checkpoint read back differs from what was "
                                 f"written: {differ[:8]}")
        sx = np.array([r["s_x"] for r in rows], np.float64)
        loss, rho = report["final_loss"], report.get("rf_sft_spearman")
        print(f"[llama] Llama-3-8B width, {spec.n_layers} of 32 layers, {n_params / 1e6:.1f} M "
              f"parameters: wrote {nbytes / 1e9:.3f} GB in {write_s:.2f} s, load "
              f"{load_s:.3f} s ({nbytes / load_s / 1e9:.2f} GB/s from the page cache), every leaf "
              f"bit-equal to what was written")
        print(f"[llama] diagnose-sft --preset sft-mmmu-llama8b (k={k}, batch "
              f"{cfg.optim.batch_size}, remat={cfg.model.remat}) rc={rc}: {steps} steps, "
              f"{chunks} scorer chunks; launches fwd {sft_counts['fwd']} dkv {sft_counts['dkv']} "
              f"dq {sft_counts['dq']} (want {want['fwd']}/{want['dkv']}/{want['dq']}: the "
              f"forward twice a step under remat); final_loss {loss}, blind_accuracy "
              f"{report['blind_accuracy']:.4f}, rf_sft_spearman {rho}; train "
              f"{report['train_wall_seconds']} s ({report['train_samples_per_sec']} samples/s), "
              f"CLI wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB")
        if (rc != 0 or sft_counts != want or report["n_mcq"] != cfg.data.n
                or len(rows) != cfg.data.n
                or not (loss is not None and math.isfinite(loss))
                or not ((sx >= 0) & (sx <= 1)).all() or not isinstance(rho, float)
                or not math.isfinite(rho)):
            raise AssertionError(f"Llama-width diagnose-sft: rc={rc}, launches {sft_counts} "
                                 f"(want {want}), report {report}")

        line, ok, bit_equal, t_remat, t_plain, (mline, mok), rows = _llama_step_gates(ckpt)
        print(f"[llama] one step remat=True vs remat=false: {line}; bit-equal: {bit_equal}")
        for name, (ms, peak, prof) in (("remat=True", t_remat), ("remat=false", t_plain)):
            print(f"[llama] step {name} ({rows[0]} rows of {rows[1]} tokens): median {ms:.2f} ms "
                  f"over {STEP_SAMPLES} steps after the first, peak device memory {peak:.2f} GB; "
                  f"{_fmt_profile(prof)}")
        print(f"[llama] {mline}")
        if not ok:
            raise AssertionError("the remat step disagrees with the step without remat")
        if not mok:
            raise AssertionError("the multi-token scorer through K1 disagrees with the plain path")
        times = _llama_attention_times(device)

        # (b) the same checkpoint quantized to int4 on arrival; eval-blind
        argv = _llama_argv(ckpt, LLAMA_BLIND_INT4)
        out_dir = tempfile.mkdtemp(prefix="tst_torch_llama_int4_")
        _zero_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--out", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        int4_counts = _launch_counts()
        with open(os.path.join(out_dir, "blind_eval.json")) as f:
            report = json.load(f)
        cfg, _ = cli._resolve(cli.build_parser().parse_args(argv))
        ds = cli._load_dataset(cfg)
        t0 = time.perf_counter()
        tb, tokens, pos, qspec, qparams = prepare_blind_eval(ds, cfg, device)
        torch.cuda.synchronize()
        qload_s = time.perf_counter() - t0
        nrows = _numeric_rows(ds)
        mc, dchunks = _decode_chunks(qspec, qparams, tokens.shape[1], np.zeros(len(nrows)), 1)
        want = blind_int4_launches_want(math.ceil(len(ds) / SCORER_BATCH), dchunks, spec.n_layers)
        mra = report.get("numeric_blind_mra")
        print(f"[llama] eval-blind int4 (quantizing_put) synthetic-vsi:0.4 n={len(ds)} rc={rc}: "
              f"n_mcq {report['n_mcq']}, n_numeric {report.get('n_numeric')} in {dchunks} decode "
              f"chunks of {mc} rows; launches fwd {int4_counts['fwd']} int4 {int4_counts['int4']} "
              f"(want {want['fwd']}/{want['int4']}: K3 at {qspec.d_model} -> {qspec.q_dim}, "
              f"{qspec.kv_dim}, {qspec.d_ff} and {qspec.d_ff} -> {qspec.d_model}); "
              f"blind_accuracy {report['blind_accuracy']:.4f}, "
              f"numeric_blind_mra {mra}; CLI wall {wall:.2f} s; tokenize + load + quantize "
              f"{qload_s:.2f} s")
        if (rc != 0 or int4_counts != want or mra is None or not math.isfinite(mra)
                or not report.get("n_numeric")):
            raise AssertionError(f"Llama-width eval-blind int4: rc={rc}, launches {int4_counts} "
                                 f"(want {want}), report {report}")
        line, ok, _ = first_decode_step_gate(qparams, qspec, tokens, pos, nrows)
        print(f"[llama] {line}")
        if not ok:
            raise AssertionError("the Llama-width decode step through K3 disagrees with the "
                                 "plain path")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"sft": sft_counts, "int4": int4_counts, "times": times, "load_s": load_s,
            "gb": nbytes / 1e9}


def _cli_run(argv, out_dir, report_name):
    """``python -m tst_torch`` through ``cli.main(argv --out out_dir)``, the
    launch counts set to 0 just before it and read just after → (rc,
    counts, the run's report, wall seconds)."""
    from tst_torch import cli

    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    with open(os.path.join(out_dir, report_name)) as f:
        return rc, counts, json.load(f), wall


def _recording(module, name, store):
    """Wrap ``module.name`` so that each call's token output is kept in
    ``store``: the token ids a run generated (its text drops most of them);
    returns the original to restore."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append((out[0] if isinstance(out, tuple) else out).cpu().numpy())
        return out

    setattr(module, name, wrapped)
    return fn


def _resume_gate(st, root):
    """Phase 20a in process: RESUME_STEPS steps of the run's trainer
    uninterrupted, then from the same start with a checkpoint every
    RESUME_EVERY steps and a failure injected after RESUME_FAIL, then
    resumed from the checkpoint: (a line, whether the adapters, AdamW state
    and the resumed steps' fold losses are bit-equal). Where they are not,
    the gate falls back to the fold losses (fold_losses_agree) and each
    LoRA leaf's cosine >= RESUME_COSINE, and prints the largest difference."""
    trainer, batches = st.trainer, st.batches[:RESUME_STEPS]
    args = (st.params, st.lora, st.opt_state, st.tokens, st.loss_mask, batches)
    kw = dict(all_pos=st.answer_pos, log_every=1)
    t0 = time.perf_counter()
    ref_lora, ref_opt, ref_log = trainer.fit(*args, **kw)
    path = os.path.join(root, "resume")
    try:
        trainer.fit(*args, checkpoint_dir=path, checkpoint_every=RESUME_EVERY,
                    fail_after_step=RESUME_FAIL, **kw)
        raise AssertionError("fail_after_step did not fail")
    except RuntimeError as e:
        if f"after step {RESUME_FAIL}" not in str(e):
            raise
    t1 = time.perf_counter()
    lora, opt, log = trainer.fit(*args, checkpoint_dir=path, checkpoint_every=RESUME_EVERY, **kw)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    done = RESUME_FAIL - RESUME_FAIL % RESUME_EVERY  # the last checkpoint's step
    differ = (trees_equal(lora, ref_lora) + trees_equal(opt.mu, ref_opt.mu)
              + trees_equal(opt.nu, ref_opt.nu))
    bitwise = (not differ and opt.count == ref_opt.count == RESUME_STEPS
               and log.fold_losses == ref_log.fold_losses[done:])
    line = (f"in process: {RESUME_STEPS} steps uninterrupted vs failed after step {RESUME_FAIL} "
            f"(checkpoints every {RESUME_EVERY}) and resumed from step {done}: adapters, AdamW "
            f"mu/nu, count and the resumed fold losses bit-equal {bitwise}; resume "
            f"{resume_s:.2f} s for {RESUME_STEPS - done} steps (the three fits "
            f"{time.perf_counter() - t0:.2f} s)")
    if bitwise:
        return line, True
    worst = max((a - b).abs().max().item() for a, b in zip(
        [t for ab in lora.values() for t in ab.values()],
        [t for ab in ref_lora.values() for t in ab.values()]))
    cos = min(torch.nn.functional.cosine_similarity(
        lora[p][n].float().flatten(), ref_lora[p][n].float().flatten(), dim=0).item()
        for p in lora for n in lora[p])
    gap, loss_ok = fold_losses_agree(log.fold_losses[-1], ref_log.fold_losses[-1])
    line += (f"; not bit-equal (leaves differing: {differ}): largest |d| {worst:.3e}, LoRA "
             f"cosine min {cos:.6f} (>= {RESUME_COSINE}), final fold-loss gap {gap:.3e}")
    return line, loss_ok and cos >= RESUME_COSINE


def _plain_logits_at(params, spec, lora, lspec, tokens, plen, prefix, rows, cols):
    """The plain path's f32 logits [len(rows), vocab] after each row's prompt
    and its first ``cols[i]`` generated tokens (``prefix``), one dense
    forward a row."""
    from tst_torch.models.decoder import apply_model, lm_head_weight

    head = lm_head_weight(params, spec).to(spec.dtype).float()
    out = []
    with torch.inference_mode():
        for r, c in zip(rows, cols):
            seq = torch.cat([tokens[r, : int(plen[r])],
                             torch.as_tensor(prefix[r, :c], device=tokens.device).to(tokens.dtype)])
            h = apply_model(params, seq[None], spec, lora=lora, lora_spec=lspec,
                            use_pallas=False, return_hidden=True)[0, -1]
            out.append(h.float() @ head)
    return torch.stack(out).cpu()


def bf16_spec_gate(adapter):
    """Speculative decode on a bf16 target, whose every product but the
    cache attention (LoRA deltas, projections, head) goes through the
    library, not K3: greedy decode with fold 0's adapter against speculative
    decode with a bf16 draft of other weights (rejections: masked slots
    between committed ones), and greedy decode without the adapter against
    speculative decode whose draft is the target (every draft token
    accepted), at each of BF16_SPEC_GAMMAS and BF16_SPEC_ROWS rows a call
    (M = rows · (gamma + 1) in the verify chunk), BF16_SPEC_MAX_NEW tokens
    a row. Every row must be greedy's;
    returns the printout."""
    from tst_torch import cli
    from tst_torch.models.decode import greedy_decode
    from tst_torch.models.decoder import init_params
    from tst_torch.models.spec_decode import speculative_greedy_decode
    from tst_torch.train.pipeline import load_adapter_lora, prepare_blind_eval

    cfg, device = cli._resolve(cli.build_parser().parse_args(
        SERVE_GEN + ["--set", "model.quantize=none"]))
    _, tokens, pos, spec, params = prepare_blind_eval(cli._load_dataset(cfg), cfg, device)
    one, lspec = load_adapter_lora(adapter, cfg, spec, fold="0", keep_fold_axis=False,
                                   device=device)
    other = init_params(torch.Generator(device=device).manual_seed(cfg.data.seed + 1), spec)
    plen, runs = pos.long() + 1, []
    for rows in BF16_SPEC_ROWS:
        for name, draft, lora in (("adapter, other draft", other, one),
                                  ("no adapter, the target as draft", params, None)):
            with torch.inference_mode():
                want = greedy_decode(params, tokens[:rows], plen[:rows], BF16_SPEC_MAX_NEW, spec,
                                     lora=lora, lora_spec=lspec, use_pallas=True)
            for gamma in BF16_SPEC_GAMMAS:
                got, stats = speculative_greedy_decode(
                    draft, spec, params, spec, tokens[:rows], plen[:rows], BF16_SPEC_MAX_NEW,
                    gamma=gamma, lora=lora, lora_spec=lspec, use_pallas=True, return_stats=True)
                differ = int((got != want).any(1).sum().item())
                runs.append(f"{rows} rows, {name}, gamma {gamma}: {stats['rounds']} rounds, "
                            f"{differ} differing")
                if differ:
                    raise AssertionError(f"bf16 speculative decode differs from greedy in "
                                         f"{differ} of {rows} rows ({name}, gamma {gamma})")
    return (f"bf16 target, bf16 drafts: speculative vs greedy tokens, every row equal (must "
            f"be): " + "; ".join(runs))


def phase_serve():
    """Phase 20: train with checkpoints and resume, serve the adapter
    (eval-blind --adapter, fold 0 and mean), generate on an int4 base with
    it, the same by exact speculative decode with an int4 draft, and
    warmup. Every CLI run's launches counted from 0 and held to what it
    implies; returns the launches of each kernel over phase 20's runs."""
    import tst_torch.train.pipeline as tpipe
    from tst_torch import cli
    from tst_torch.models.decode import greedy_decode
    from tst_torch.train.infer import score_heldout_mcq
    from tst_torch.train.pipeline import load_adapter_lora, prepare_blind_eval

    root = tempfile.mkdtemp(prefix="tst_torch_serve_")
    ck = os.path.join(root, "ck")
    adapter = os.path.join(ck, SERVE_EPOCH_DIR)
    total = dict.fromkeys(("fwd", "dkv", "dq", "int4", "dattn"), 0)

    def add(counts):
        for key in total:
            total[key] += counts[key]

    try:
        # (a) train one epoch with checkpoints, then resume in process
        out = os.path.join(root, "sft")
        rc, counts, report, wall = _cli_run(SERVE_TRAIN + ["--set", f"checkpoint_dir={ck}"], out,
                                            "report.json")
        add(counts)
        folds = np.array([json.loads(line)["fold"]
                          for line in open(os.path.join(out, "sx.jsonl"))])
        k, steps = report["k"], report["train_steps"]
        chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / SCORER_BATCH)
        want = sft_launches_want(steps, chunks, N_LAYERS)
        stamp = {"k": 2, "model_name": report["model"], "lora_rank": 16, "lora_alpha": 32.0,
                 "lora_targets": ["q_proj", "k_proj", "v_proj", "o_proj"], "step": steps}
        with open(os.path.join(adapter, "extra.json")) as f:
            extra = json.load(f)
        files = sorted(os.listdir(adapter)) if os.path.isdir(adapter) else []
        if (rc != 0 or counts != want or sorted(os.listdir(ck)) != [SERVE_EPOCH_DIR]
                or files != ["extra.json", "state.safetensors"] or extra != stamp):
            raise AssertionError(f"diagnose-sft with checkpoint_dir rc={rc}, launches {counts} "
                                 f"(want {want}), layout {os.listdir(ck)} {files}, stamp {extra}")
        size = os.path.getsize(os.path.join(adapter, "state.safetensors")) / 1e6
        print(f"[serve] (a) diagnose-sft one epoch with checkpoint_dir rc=0: {steps} steps x {k} "
              f"folds, launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as "
              f"implied); {SERVE_EPOCH_DIR}/ with state.safetensors ({size:.2f} MB) and its stamp "
              f"{extra}; final_loss {report['final_loss']:.4f}; CLI wall {wall:.2f} s")
        st = _train_state(base=SERVE_TRAIN)
        line, ok = _resume_gate(st, root)
        print(f"[serve] (a) {line}")
        if not ok:
            raise AssertionError("a resumed fit disagrees with the uninterrupted one")

        # (b) serve the adapter through eval-blind, fold 0 and the mean
        for fold in ("0", "mean"):
            rc, counts, rep, wall = _cli_run(SLICE + ["--adapter", adapter, "--fold", fold],
                                             os.path.join(root, f"blind_{fold}"),
                                             "blind_eval.json")
            add(counts)
            want = {**dict.fromkeys(counts, 0),
                    "fwd": N_LAYERS * math.ceil(N_SAMPLES / SCORER_BATCH)}
            if (rc != 0 or counts != want or rep["zero_shot"] is not False
                    or rep["adapter"] != adapter or rep["adapter_fold"] != fold
                    or rep["n_mcq"] != N_SAMPLES or not math.isfinite(rep["blind_accuracy"])):
                raise AssertionError(f"eval-blind --adapter --fold {fold} rc={rc}, launches "
                                     f"{counts} (want {want}), report {rep}")
            print(f"[serve] (b) eval-blind --adapter {SERVE_EPOCH_DIR} --fold {fold} rc=0: "
                  f"launches fwd {counts['fwd']} ({N_LAYERS} x {want['fwd'] // max(N_LAYERS, 1)} "
                  f"chunks, as implied), blind_accuracy "
                  f"{rep['blind_accuracy']:.4f}, zero_shot false, adapter_fold {fold}; CLI wall "
                  f"{wall:.2f} s")
            if fold == "0":
                acc0 = rep["blind_accuracy"]
        cfg, device = cli._resolve(cli.build_parser().parse_args(SLICE))
        one, lspec = load_adapter_lora(adapter, cfg, st.spec, fold="0", device=device)
        zeros = np.zeros(st.tb.n, np.int32)
        probs = {up: score_heldout_mcq(st.params, one, st.spec, lspec, st.tokens, st.answer_pos,
                                       st.tb.option_token_ids, st.tb.n_options, zeros, 1,
                                       use_pallas=up) for up in (True, False)}
        diff = float(np.abs(probs[True] - probs[False]).max())
        acc_k = float((probs[True].argmax(-1) == st.tb.gold).mean())
        print(f"[serve] (b) fold 0's adapter served in process, kernel vs plain attention: "
              f"max|dprob| {diff:.3e} (<= {PROB_TOL}); rescored accuracy {acc_k:.4f} (CLI "
              f"{acc0:.4f})")
        if diff > PROB_TOL or abs(acc_k - acc0) > 1.0 / N_SAMPLES:
            raise AssertionError("the served adapter's probabilities disagree with the plain path")
        del st, probs

        # (c) generate on an int4 base with the adapter; (d) the same with an
        # int4 draft of the target's own config, gamma 2; then without the
        # adapter, where the draft is the target
        ids, served = {}, ["--adapter", adapter, "--fold", "0"]
        for name, argv, fn in (("greedy", SERVE_GEN + served, "greedy_decode"),
                               ("spec", SERVE_SPEC + served, "speculative_greedy_decode"),
                               ("self", SERVE_SPEC, "speculative_greedy_decode")):
            ids[name] = []
            original = _recording(tpipe, fn, ids[name])
            try:
                rc, counts, rep, wall = _cli_run(argv, os.path.join(root, name),
                                                 "generate_report.json")
            finally:
                setattr(tpipe, fn, original)
            add(counts)
            chunks = math.ceil(GEN_ROWS / rep["chunk_rows"])
            want = (generate_launches_want(chunks, GEN_MAX_NEW, N_LAYERS) if name == "greedy"
                    else spec_launches_want(chunks, rep["spec_rounds"], SPEC_GAMMA, N_LAYERS))
            ids[name] = np.concatenate(ids[name])[:GEN_ROWS]
            if rc != 0 or counts != want or ids[name].shape != (GEN_ROWS, GEN_MAX_NEW):
                raise AssertionError(f"generate ({name}) rc={rc}, launches {counts} (want "
                                     f"{want}), tokens {ids[name].shape}")
            tps = rep["tokens_generated"] / rep["decode_seconds"]
            what = {"greedy": "greedy int4 + adapter", "spec": "speculative int4 + adapter",
                    "self": "speculative int4, no adapter (the draft is the target)"}[name]
            line = (f"[serve] ({'c' if name == 'greedy' else 'd'}) generate {what} "
                    f"rc=0: {GEN_ROWS} rows x {GEN_MAX_NEW} tokens in {chunks} chunks of "
                    f"{rep['chunk_rows']}; launches fwd {counts['fwd']} int4 {counts['int4']} (as "
                    f"implied); decode {rep['decode_seconds']:.3f} s, {tps:.1f} tokens/s; CLI "
                    f"wall {wall:.2f} s")
            if name != "greedy":
                line += (f"; spec_rounds {rep['spec_rounds']}, committed_per_round "
                         f"{rep['committed_per_round']}, draft_acceptance "
                         f"{rep['draft_acceptance']} (gamma {SPEC_GAMMA}); tokens/s "
                         f"{tps:.1f} vs greedy {greedy_tps:.1f}")
            else:
                greedy_tps = tps
            print(line)

        cfg, device = cli._resolve(cli.build_parser().parse_args(SERVE_GEN))
        tb, tokens, pos, spec, params = prepare_blind_eval(cli._load_dataset(cfg), cfg, device)
        one, lspec = load_adapter_lora(adapter, cfg, spec, fold="0", keep_fold_axis=False,
                                       device=device)
        line, ok, _ = first_decode_step_gate(params, spec, tokens, pos, np.arange(GEN_ROWS),
                                             lora=one, lspec=lspec, max_new=GEN_MAX_NEW)
        print(f"[serve] (c) {line}")
        if not ok:
            raise AssertionError("generate's first decode step through K3 disagrees with the "
                                 "plain path")
        greedy_plain = []
        with torch.inference_mode():
            for c0 in range(0, GEN_ROWS, DECODE_ROWS):
                greedy_plain.append(greedy_decode(params, tokens[c0: c0 + DECODE_ROWS],
                                                  pos[c0: c0 + DECODE_ROWS].long() + 1,
                                                  GEN_MAX_NEW, spec, use_pallas=True).cpu())
        greedy_plain = np.concatenate(greedy_plain)
        for name, greedy in (("spec", ids["greedy"]), ("self", greedy_plain)):
            col = first_divergence(greedy, ids[name])
            rows = np.flatnonzero(col >= 0)
            adapter_on = name == "spec"
            lp = (_plain_logits_at(params, spec, one if adapter_on else None, lspec, tokens,
                                   pos.long() + 1, greedy, rows, col[rows])
                  if len(rows) else None)
            rows, decisive, margins = spec_token_gate(greedy, ids[name], lp)
            print(f"[serve] (d) speculative vs greedy tokens, "
                  f"{'with the adapter' if adapter_on else 'without it'}: rows differing "
                  f"{len(rows)} of {GEN_ROWS} (must be 0; first divergent columns "
                  f"{col[rows].tolist()}, the plain path's logit margin there "
                  f"{[round(m, 4) for m in margins]}, decisive {decisive})")
            if len(rows):
                raise AssertionError("speculative decode's tokens differ from greedy's")
        del params, tokens
        print(f"[serve] (d) {bf16_spec_gate(adapter)}")

        # (e) warmup
        warmup = ["warmup", "--bench", "synthetic:0.5", "--set", "data.n=512", "--set",
                  "model.name=qwen2.5-0.5b", "--k", "2"]
        rc, counts, rep, wall = _cli_run(warmup, os.path.join(root, "warmup"),
                                         "warmup_report.json")
        want_k = tpipe.warmup_entries(cli._resolve(cli.build_parser().parse_args(warmup))[0])
        if rc != 0 or any(counts.values()) or rep["kernels"] != want_k:
            raise AssertionError(f"warmup rc={rc}, launches {counts}, report {rep}")
        print(f"[serve] (e) warmup rc=0: resolved {rep['kernels']} in {rep['library']} (nvcc "
              f"{rep['build_seconds']} s: built earlier in this run), no launches; CLI wall "
              f"{wall:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def long_rows(path, n=LONG_ROWS, nbytes=LONG_CONTEXT_BYTES, seed=0):
    """``n`` four-option rows whose blind input carries a transcript of about
    ``nbytes`` bytes of random words (VideoMME's subtitle channel), written as
    a BlindDataset jsonl."""
    from tst_torch.data.schema import BlindDataset, Sample

    rng = np.random.default_rng(seed)
    words = ["the", "speaker", "shows", "a", "red", "box", "near", "window", "then", "moves",
             "it", "to", "table", "while", "camera", "pans", "left", "and", "right", "again"]
    samples = []
    for i in range(n):
        text, size = [], 0
        while size < nbytes:
            w = words[int(rng.integers(len(words)))]
            text.append(w)
            size += len(w) + 1
        samples.append(Sample(id=f"long-{i}", question=f"What is in clip {i}?",
                              options=["a box", "a cup", "a lamp", "a book"],
                              answer="ABCD"[i % 4], category="long", context=" ".join(text)))
    BlindDataset("video_mme_synthetic", samples).save_jsonl(path)
    return path


def _cosine(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-30))


def _ring_in_one_process(q, k, v, do, n, use_pallas):
    """The ring over ``n`` blocks of (q, k, v) in one process (the ranks'
    step, ``local_rotate``), forward and backward, through K1 (``use_pallas``)
    or the plain partials → (o, [dq, dk, dv] whole, K1's launches {"causal":
    {fwd, dkv, dq}, "full": {...}} and calls of the plain partial and pair
    backward in that first call, then the median ms of RING_WALL_SAMPLES
    warmed calls)."""
    import tst_torch.kernels.ring_attention as tring

    blk = q.shape[1] // n
    blocks = [[t[:, i * blk: (i + 1) * blk].detach().clone().requires_grad_(True)
               for i in range(n)] for t in (q, k, v)]
    plain_calls = []
    real = {name: getattr(tring, name) for name in ("_online_partial", "_pair_backward")}

    def counted(name):
        def call(*a, **kw):
            plain_calls.append(name)
            return real[name](*a, **kw)
        return call

    def run():
        o = torch.cat(tring.ring_blocks(*blocks, list(range(n)), n, tring.local_rotate,
                                        use_pallas=use_pallas), 1)
        return o, torch.autograd.grad(o, [t for group in blocks for t in group], do)

    for name in real:
        setattr(tring, name, counted(name))
    try:
        _zero_launch_counts()
        ring_o, ring_g = run()
        torch.cuda.synchronize()
        counts = _launch_counts()
        launches = {"causal": {key: counts[key] for key in ("fwd", "dkv", "dq")},
                    "full": _full_launch_counts()}
    finally:
        for name, fn in real.items():
            setattr(tring, name, fn)
    grads = [torch.cat(ring_g[j * n: (j + 1) * n], 1) for j in range(3)]
    wall_ms = median_ms(run, samples=RING_WALL_SAMPLES, reps=1, warmup=1)
    return ring_o.detach(), grads, wall_ms, launches, len(plain_calls)


def ring_gate(o, grads, o_ref, grads_ref, what):
    """A ring's output within O_TOL of ``o_ref`` and at cosine >=
    LONG_RING_COSINE to it (the late rows' small o average thousands of
    keys: an error there hides under O_TOL, not under the cosine), and its
    gradients at cosine >= LONG_RING_COSINE and max|d - ref| <=
    GRAD_TOL·max|ref| → the readings."""
    err = (o.float() - o_ref.float()).abs().max().item()
    o_cos = _cosine(o, o_ref)
    cos = [_cosine(a, b) for a, b in zip(grads, grads_ref)]
    rel = [_rel_err(a, b) for a, b in zip(grads, grads_ref)]
    print(f"[long] {what}: max|o - o_ref| {err:.3e} (<= {O_TOL}), o cosine {o_cos:.6f}; "
          f"gradient cosine dq {cos[0]:.6f} dk {cos[1]:.6f} dv {cos[2]:.6f} (each >= "
          f"{LONG_RING_COSINE}), max|d - ref|/max|ref| {rel[0]:.3e} {rel[1]:.3e} {rel[2]:.3e} "
          f"(<= {GRAD_TOL})")
    if (err > O_TOL or min(cos + [o_cos]) < LONG_RING_COSINE or max(rel) > GRAD_TOL):
        raise AssertionError(f"{what}: the ring disagrees")
    return {"max_abs_o_err": err, "o_cosine": o_cos, "grad_cosine": cos, "grad_rel_err": rel}


def check_ring_launches(launches, n, use_pallas, plain_calls):
    """K1's launches of one ring run in one process as ring_launches_want
    implies (none on the plain route), and the kernel route without a call
    of the plain partial or pair backward."""
    want = ring_launches_want(n) if use_pallas else {"causal": 0, "full": 0}
    want = {kind: {key: count for key in ("fwd", "dkv", "dq")} for kind, count in want.items()}
    route = "K1" if use_pallas else "plain"
    check_launches(launches, want, f"the ring over {n} blocks in one process ({route})")
    if use_pallas and plain_calls:
        raise AssertionError(f"the ring's kernel route called the plain partials "
                             f"{plain_calls} times")


def phase_long(device):
    """Phase 21: long context on one card. (a) K1's forward, dK/dV and dQ at
    S=16384 and S=32768 against their plain versions; (b) their times at the
    preset's full call beside scaled_dot_product_attention and the bound;
    (c) the ring at S=16384 (4 blocks, the ranks' step in one process)
    through K1 (causal diagonal blocks, non-causal past blocks, future blocks
    skipped: launches as ring_launches_want implies) and through the plain
    partials, each against unsplit K1 and against each other, forward and
    backward, and the ring through K1 at the preset's full call against
    unsplit K1; (d) ``diagnose-sft --preset
    sft-videomme-long`` at max_len 16384 (k=5, batch 2, remat) through the
    CLI with --profile-dir: launches as implied, finite fold losses, s(x)
    of every row, the step time, samples/s and peak memory, and the trace's
    top ops. Returns the K1 rows' long-S timings and this run's launches."""
    import tst_torch.kernels.flash_attention as tfa
    import tst_torch.train.sft as tsft

    out = {"checks": {}}
    ring_in = None
    for s, h in LONG_CHECKS:
        rng = np.random.default_rng(s)
        q, do = (_randn(rng, (1, s, h, 64), device) for _ in range(2))
        k, v = (_randn(rng, (1, s, 1, 64), device) for _ in range(2))
        o, lse = tfa.flash_attention(q, k, v)
        di = tfa.backward_row_stat(o, do)
        got = tfa.flash_attention_backward(q, k, v, lse, di, do)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention(q, k, v), (o, lse), "the forward kernel")
        _check_bitwise(lambda: tfa.flash_attention_backward(q, k, v, lse, di, do), got)
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        t0 = time.perf_counter()
        want = tfa.flash_attention_backward_reference(q.float(), k.float(), v.float(), o.float(),
                                                      lse, do.float())
        torch.cuda.synchronize()
        plain_bwd_ms = (time.perf_counter() - t0) * 1e3
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        del want
        t0 = time.perf_counter()
        tfa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, *got))
        print(f"[long] K1 at S={s}, q [1, {s}, {h}, 64], one KV head: max|o-ref| {o_err:.3e} "
              f"(<= {O_TOL}), max|lse-ref| {lse_err:.3e} (<= {LSE_TOL}); backward "
              f"max|d-ref|/max|ref| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
              f"(<= {GRAD_TOL}); plain forward {plain_ms:.1f} ms, plain backward "
              f"{plain_bwd_ms:.1f} ms (one call)")
        if not finite or o_err > O_TOL or lse_err > LSE_TOL or max(errs) > GRAD_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at S={s}")
        out["checks"][str(s)] = {"o_err": o_err, "lse_err": lse_err, "grad_rel_errs": errs,
                                 "plain_ms": plain_ms, "plain_bwd_ms": plain_bwd_ms}
        if s == LONG_CHECKS[0][0]:
            ring_in = (q, k, v, do, o, got)
        else:
            del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()

    # (c) the ring over 4 blocks in one process, through K1 and through the
    # plain partials, each against unsplit K1, and against each other
    q, k, v, do, o, got = ring_in
    n, s = LONG_RING_BLOCKS, q.shape[1]
    rings = {}
    for use_pallas in (True, False):
        route = "K1" if use_pallas else "plain"
        ring_o, ring_g, wall, launches, plain_calls = _ring_in_one_process(q, k, v, do, n,
                                                                           use_pallas)
        check_ring_launches(launches, n, use_pallas, plain_calls)
        rings[route] = {"wall_ms": wall, "launches": launches,
                        **ring_gate(ring_o, ring_g, o, got,
                                    f"the ring through {route} at S={s}, {n} blocks of "
                                    f"{s // n} in one process, against unsplit K1"),
                        "o": ring_o, "grads": ring_g}
    rings["K1_vs_plain"] = ring_gate(rings["K1"].pop("o"), rings["K1"].pop("grads"),
                                     rings["plain"].pop("o"), rings["plain"].pop("grads"),
                                     f"the ring through K1 against the plain ring at S={s}")
    print(f"[long] the rings' walls (forward and backward, q [1, {s}, {q.shape[2]}, 64], "
          f"{n} blocks in one process; median of {RING_WALL_SAMPLES} warmed calls): K1 "
          f"{rings['K1']['wall_ms']:.3f} ms, plain {rings['plain']['wall_ms']:.3f} ms; K1's "
          f"launches {json.dumps(rings['K1']['launches'])}"
          f" (as implied: {json.dumps(ring_launches_want(n))} a pass), none on the plain route")
    out["ring"] = rings
    del ring_in, q, k, v, do, o, got
    torch.cuda.empty_cache()

    # (b) times at the preset's full call
    b, s, h, kvh, d = LONG_SHAPE
    rng = np.random.default_rng(1)
    q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
    k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
    o, lse = tfa.flash_attention(q, k, v)
    di = tfa.backward_row_stat(o, do)
    pair = (*tfa._launch_bwd_dkv(q, k, v, do, lse, di), tfa._launch_bwd_dq(q, k, v, do, lse, di))
    torch.cuda.synchronize()
    _check_bitwise(lambda: tfa.flash_attention(q, k, v), (o, lse), "the forward kernel")
    _check_bitwise(lambda: (*tfa._launch_bwd_dkv(q, k, v, do, lse, di),
                            tfa._launch_bwd_dq(q, k, v, do, lse, di)), pair)
    # the ring through K1 at the preset's call, against unsplit K1 (dq, dk, dv)
    ring_o, ring_g, wall, launches, plain_calls = _ring_in_one_process(q, k, v, do, n, True)
    check_ring_launches(launches, n, True, plain_calls)
    out["ring"]["K1_preset_call"] = {"shape": [b, s, h, d], "wall_ms": wall,
                                     "launches": launches,
                                     **ring_gate(ring_o, ring_g, o, (pair[2], *pair[:2]),
                                                 f"the ring through K1 at the preset's call "
                                                 f"q {[b, s, h, d]}, {n} blocks in one "
                                                 f"process, against unsplit K1")}
    print(f"[long] the ring through K1 at the preset's call: forward and backward "
          f"{wall:.3f} ms (median of {RING_WALL_SAMPLES} warmed calls; unsplit K1's kernels "
          f"below); launches {json.dumps(launches)}")
    del pair, ring_o, ring_g
    times = {"fwd": median_ms(lambda: tfa.flash_attention(q, k, v), 5, 3),
             "dkv": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di), 5, 3),
             "dq": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di), 5, 3)}
    dq_clocks = clocks_now()
    lib = _sdpa_yardstick(q, k, v, do, o, samples=5, reps=3)
    bounds = _attention_bounds(q, k)
    plain = out["checks"][str(LONG_CHECKS[0][0])]
    timed = (f"q {list(q.shape)}, the preset's call; plain_ms at the check shape q [1, "
             f"{LONG_CHECKS[0][0]}, {LONG_CHECKS[0][1]}, 64] (the full call's [S, S] f32 "
             "tensors do not fit)")
    out["shape"] = list(q.shape)
    for key in ("fwd", "dkv", "dq"):
        out[key] = {"ms": times[key], **bounds[key],
                    "library_ms": lib["fwd_ms"] if key == "fwd" else lib["bwd_ms"],
                    "plain_ms": plain["plain_ms"] if key == "fwd" else plain["plain_bwd_ms"],
                    "timed": timed}
    out["dq"]["clocks_sm_power"] = dq_clocks
    print(f"[long] K1 at the preset's call q {list(q.shape)}: forward {times['fwd']:.3f} ms "
          f"(bound {bounds['fwd']['bound_ms']:.3f}, {bounds['fwd']['bound_by']}; library "
          f"{lib['fwd_ms']:.3f}), dK/dV {times['dkv']:.3f} ms (bound "
          f"{bounds['dkv']['bound_ms']:.3f}) + dQ {times['dq']:.3f} ms (bound "
          f"{bounds['dq']['bound_ms']:.3f}) against the library's backward {lib['bwd_ms']:.3f} "
          f"ms ({lib['backend']}, {lib['gqa']}); median of 5 x 3 calls; forward and backward "
          f"bit-equal on a second call at this call and at S={LONG_CHECKS[0][0]}")
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()

    # (d) the preset through the CLI, profiled
    root = tempfile.mkdtemp(prefix="tst_torch_long_")
    try:
        bench = long_rows(os.path.join(root, "long.jsonl"))
        prof_dir = os.path.join(root, "prof")
        step_ms, fold_losses = [], []
        real_step = tsft.FoldTrainer.step

        def timed_step(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = real_step(self, *args, **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            fold_losses.append(result[2].float().cpu().tolist())
            return result

        torch.cuda.reset_peak_memory_stats()
        tsft.FoldTrainer.step = timed_step
        try:
            rc, counts, report, wall = _cli_run(
                LONG_TRAIN + ["--bench", bench, "--profile-dir", prof_dir],
                os.path.join(root, "run"), "report.json")
        finally:
            tsft.FoldTrainer.step = real_step
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(root, "run", "sx.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(prof_dir, "op_summary.json")) as f:
            summary = json.load(f)
        from tst_torch.train.infer import scorer_batch

        folds = np.array([r["fold"] for r in rows])
        k, steps = report["k"], report["train_steps"]
        chunk_rows = scorer_batch(16384)
        chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / chunk_rows)
        want = sft_launches_want(steps, chunks, N_LAYERS, remat=True)
        sx = [r["s_x"] for r in rows]
        finite = all(math.isfinite(x) for fl in fold_losses for x in fl)
        if (rc != 0 or counts != want or steps < 3 or len(rows) != LONG_ROWS or not finite
                or not all(0.0 <= x <= 1.0 for x in sx) or not summary["top_ops"]
                or not os.path.exists(os.path.join(prof_dir, "trace.json"))):
            raise AssertionError(f"diagnose-sft --preset sft-videomme-long rc={rc}, launches "
                                 f"{counts} (want {want}), steps {steps}, rows {len(rows)}, "
                                 f"fold losses {fold_losses}, s(x) {sx}")
        median_step = statistics.median(step_ms[1:])
        rows_per_step = k * 2
        top = [f"{op['name'][:60]} {op['total_us'] / 1e3:.1f} ms x{op['calls']}"
               for op in summary["top_ops"][:8]]
        print(f"[long] diagnose-sft --preset sft-videomme-long (max_len 16384, k={k}, batch 2 "
              f"a fold, remat, the byte tokenizer) rc=0 on {LONG_ROWS} rows of "
              f"~{LONG_CONTEXT_BYTES} bytes: {steps} steps, {chunks} scorer chunks of {chunk_rows} "
              f"row(s); launches "
              f"fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as implied: full "
              f"remat runs the forward kernel twice a step); fold losses {fold_losses} "
              f"(finite); s(x) {[round(x, 4) for x in sx]}; step median {median_step:.1f} ms "
              f"after the first ({step_ms[0]:.1f} ms), {rows_per_step / median_step * 1e3:.2f} "
              f"samples/s ({rows_per_step} rows x 16384 tokens a step; report "
              f"train_samples_per_sec {report['train_samples_per_sec']}, the first step "
              f"included); peak device memory {peak_gb:.2f} GB; scoring "
              f"{report['score_mcq_wall_seconds']} s; CLI wall {wall:.2f} s under the profiler")
        print(f"[long] --profile-dir: trace.json and op_summary.json ({summary['time']} time); "
              f"top ops by total time: {'; '.join(top)}")
        out.update(launches=counts, step_ms=median_step, peak_gb=peak_gb)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_native_pack():
    """The port's native byte packer (tst_torch.native, built with g++ from
    the checkout) with backend="native" against the Python path: phase 21's
    long rows at max_len 16384, and a 100,000-character context at its
    bucket and head-truncated to 512; every TokenBatch field bit-equal; the
    seconds each path takes. A failed build raises."""
    from tst_torch.data.schema import BlindDataset
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.native import fast_pack

    root = tempfile.mkdtemp(prefix="tst_torch_pack_")
    try:
        t0 = time.perf_counter()
        if not fast_pack.native_available():
            raise AssertionError("the native packer did not build (g++ on "
                                 f"tst_torch/native/csrc/fast_pack.cpp)")
        build_s = time.perf_counter() - t0
        cases = [("phase 21's rows", long_rows(os.path.join(root, "long.jsonl")), 16384),
                 ("a 100,000-character context", long_rows(os.path.join(root, "ctx.jsonl"), n=1,
                                                           nbytes=100_000, seed=1), None),
                 ("the same, head-truncated", os.path.join(root, "ctx.jsonl"), 512)]
        out = {"build_s": build_s}
        for name, path, max_len in cases:
            ds = BlindDataset.load_jsonl(path)
            secs, batches = {}, {}
            for backend in ("native", "python"):
                t0 = time.perf_counter()
                batches[backend] = tokenize_dataset(ds, ByteTokenizer(), max_len=max_len,
                                                    backend=backend)
                secs[backend] = time.perf_counter() - t0
            nat, py = batches["native"], batches["python"]
            differ = [f.name for f in dataclasses.fields(nat)
                      if not np.array_equal(np.asarray(getattr(nat, f.name)),
                                            np.asarray(getattr(py, f.name)))]
            tail = nat.tokens[np.arange(nat.n), nat.answer_pos + 1]
            print(f"[native-pack] {name}: {nat.n} rows of up to "
                  f"{max(len(s.context) for s in ds)} characters into [{nat.n}, {nat.seq_len}]: "
                  f"native {secs['native'] * 1e3:.2f} ms, python {secs['python'] * 1e3:.2f} ms; "
                  f"fields that differ {differ} (must be none); first target token the gold "
                  f"letter on every row: {bool((tail == nat.option_token_ids[nat.gold]).all())}")
            if differ or not (tail == nat.option_token_ids[nat.gold]).all():
                raise AssertionError(f"the native packer disagrees with the Python path on "
                                     f"{name}: {differ}")
            out[name] = {"native_s": secs["native"], "python_s": secs["python"]}
        print(f"[native-pack] {fast_pack.library_path().name} built or found in {build_s:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def remat_memory_reckoning(spec, rows, seq):
    """What a remat train step must hold, in GB: the bf16 base (every
    weight once) and each layer's saved input [rows, seq, d_model] in the
    base's dtype."""
    d, q, kv, f = spec.d_model, spec.q_dim, spec.kv_dim, spec.d_ff
    layer = d * q + 2 * d * kv + q * d + 3 * d * f + 2 * d
    head = 0 if spec.tie_embeddings else d * spec.vocab_size
    n_params = spec.vocab_size * d + head + spec.n_layers * layer + d
    item = torch.empty((), dtype=spec.dtype).element_size()
    return {"weights_gb": n_params * item / 1e9,
            "saved_inputs_gb": spec.n_layers * rows * seq * d * item / 1e9}


def _llama8b_sft(root):
    """Phase 22a: the sft-mmmu-llama8b preset through the CLI at 32 layers,
    profiled; then one step through the kernels against the plain path."""
    import tst_torch.train.sft as tsft
    from tst_torch.aux.flops import train_step_flops

    prof_dir = os.path.join(root, "prof")
    step_ms, fold_losses, seen = [], [], {}
    real_step = tsft.FoldTrainer.step

    def timed_step(self, *args, **kw):
        torch.cuda.synchronize()
        if not step_ms:  # the set-up's peak (the init), then the steps' own
            seen["setup_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = real_step(self, *args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        fold_losses.append(result[2].float().cpu().tolist())
        seen.update(trainer=self, rows=int(np.prod(np.shape(args[6]))), seq=args[3].shape[1],
                    step_peak=torch.cuda.max_memory_allocated())
        return result

    torch.cuda.reset_peak_memory_stats()
    tsft.FoldTrainer.step = timed_step
    try:
        rc, counts, report, wall = _cli_run(LLAMA8B_TRAIN + ["--profile-dir", prof_dir],
                                            os.path.join(root, "sft"), "report.json")
    finally:
        tsft.FoldTrainer.step = real_step
    peak_gb = max(seen["setup_peak"], torch.cuda.max_memory_allocated()) / 1e9
    rows = _read_jsonl(os.path.join(root, "sft", "sx.jsonl"))
    with open(os.path.join(prof_dir, "op_summary.json")) as f:
        summary = json.load(f)
    trainer = seen["trainer"]
    spec = trainer.spec
    folds = np.array([r["fold"] for r in rows])
    k, steps = report["k"], report["train_steps"]
    chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / SCORER_BATCH)
    want = sft_launches_want(steps, chunks, LLAMA8B_LAYERS, remat=True)
    sx = np.array([r["s_x"] for r in rows], np.float64)
    rho, acc = report.get("rf_sft_spearman"), report.get("rf_blind_accuracy")
    finite = all(math.isfinite(x) for fl in fold_losses for x in fl)
    if (rc != 0 or spec.n_layers != LLAMA8B_LAYERS or counts != want
            or len(rows) != LLAMA8B_ROWS or report["n_mcq"] != LLAMA8B_ROWS or not finite
            or not fold_losses
            or not ((sx >= 0) & (sx <= 1)).all() or not summary["top_ops"]
            or not all(isinstance(v, float) and math.isfinite(v) for v in (rho, acc))):
        raise AssertionError(f"Llama-3-8B diagnose-sft rc={rc}, layers {spec.n_layers}, launches "
                             f"{counts} (want {want}), rows {len(rows)}, fold losses "
                             f"{fold_losses}, rf_sft_spearman {rho}, rf_blind_accuracy {acc}")
    median = statistics.median(step_ms[1:])
    flops = train_step_flops(spec, trainer.lora_spec, seen["rows"], seen["seq"], trainer.t_max,
                             remat=trainer.remat)
    tflops = flops["hardware_flops"] / median * 1e3 / 1e12
    reckon = remat_memory_reckoning(spec, seen["rows"], seen["seq"])
    top = [f"{op['name'][:60]} {op['total_us'] / 1e3:.1f} ms x{op['calls']}"
           for op in summary["top_ops"][:8]]
    print(f"[llama8b] (a) diagnose-sft --preset sft-mmmu-llama8b, Llama-3-8B at "
          f"{spec.n_layers} of 32 layers (random init on the card, vocab {spec.vocab_size}, "
          f"d_model {spec.d_model}, {spec.n_heads}/{spec.n_kv_heads} heads, d_ff {spec.d_ff}; "
          f"k={k}, remat={trainer.remat}) rc=0: {steps} steps of {seen['rows']} rows x "
          f"{seen['seq']} tokens, {chunks} scorer chunks; launches fwd {counts['fwd']} dkv "
          f"{counts['dkv']} dq {counts['dq']} (as implied: the forward twice a step under "
          f"remat); fold losses {fold_losses[-1]} (every step finite); final_loss "
          f"{report['final_loss']}, blind_accuracy {report['blind_accuracy']:.4f}; RF "
          f"cross-check rf_sft_spearman {rho}, rf_blind_accuracy {acc}; CLI wall {wall:.2f} s "
          f"under --profile-dir")
    print(f"[llama8b] (a) step median {median:.1f} ms over {len(step_ms) - 1} steps after the "
          f"first ({step_ms[0]:.1f} ms): {seen['rows'] / median * 1e3:.2f} train samples/s; "
          f"{flops['hardware_flops'] / 1e15:.4f} PFLOP a step with remat's recomputation "
          f"(train_step_flops; model FLOPs {flops['model_flops'] / 1e15:.4f}): {tflops:.1f} "
          f"TFLOP/s, {tflops / PEAK_TFLOPS:.1%} of {PEAK_TFLOPS:g}; peak device memory "
          f"{peak_gb:.2f} GB: the set-up {seen['setup_peak'] / 1e9:.2f} GB (the init), the train "
          f"steps {seen['step_peak'] / 1e9:.2f} GB (reckoned: bf16 weights "
          f"{reckon['weights_gb']:.2f} GB + saved layer inputs {reckon['saved_inputs_gb']:.2f} GB "
          f"+ one layer's recompute and the head)")
    print(f"[llama8b] (a) --profile-dir: top device ops of the run: {'; '.join(top)}")

    # the step gates at full depth: through the kernels against the plain
    # attention (the trainer's use_pallas off), on one state (step_gate)
    t0 = time.perf_counter()
    case = _llama8b_gate_case()
    line, ok = step_gate(case)
    del case
    torch.cuda.empty_cache()
    print(f"[llama8b] (a) at {LLAMA8B_GATE_LAYERS} layers, {PLAIN_ROWS} rows a fold, kernels vs "
          f"model.use_pallas=false: {line}; {time.perf_counter() - t0:.2f} s with the state's "
          f"build")
    if not ok:
        raise AssertionError("the 32-layer Llama-3-8B step through the kernels disagrees with "
                             "the plain path")
    return {"launches": counts, "step_ms": median, "samples_per_s": seen["rows"] / median * 1e3,
            "tflops": tflops, "peak_gb": peak_gb, "step_peak_gb": seen["step_peak"] / 1e9,
            "top_ops": top[:5], **reckon}


def _llama8b_ibp():
    """Phase 22b: the ibp-vsibench preset through the CLI at 32 layers (bf16
    base; numeric rows greedy-decoded through the decode attention kernel),
    phase 16's gates, then the first decode step's logits through the
    kernels against the plain path with round 0's fold-0 adapter."""
    counts, rounds, report, peak_gb = run_ibp_gated(
        LLAMA8B_IBP, LLAMA8B_IBP_N, LLAMA8B_IBP_ROUNDS, LLAMA8B_LAYERS, True, "llama8b")
    runner = rounds[0]["runner"]
    lora_k = rounds[0]["score"][0][1]
    one = {p: {n: t[0] for n, t in ab.items()} for p, ab in lora_k.items()}
    rows = _numeric_rows(runner.ds)
    t0 = time.perf_counter()
    line, ok, _ = first_decode_step_gate(runner.params, runner.spec, runner.tokens,
                                         runner.answer_pos, rows, lora=one, lspec=runner.lspec)
    print(f"[llama8b] (b) bf16 base, round 0's fold-0 adapter, decode attention kernel vs plain: "
          f"{line} ({time.perf_counter() - t0:.2f} s)")
    walls = [{key: v for key, v in row.items() if key.startswith("round_")}
             for row in report["per_round"]]
    del rounds, runner, lora_k, one
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the 8B bf16 decode step through the kernels disagrees with the "
                             "plain path")
    return {"launches": counts, "peak_gb": peak_gb, "round_walls": walls}


def _llama8b_int4(root):
    """Phase 22c: eval-blind on Llama-3-8B's int4 base (quantize_params after
    the init on the card) through the CLI: launches as implied, the first
    decode step through K3 against the plain path, decode tokens/s and the
    step's idle share, the init + quantization wall and peak memory during
    the build and after it."""
    from tst_torch import cli
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.models.quant import quantized_bytes
    from tst_torch.train import pipeline as tpipe

    built = {}
    real_build = tpipe.build_model

    def timed_build(cfg, tokenizer, device, mesh=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = real_build(cfg, tokenizer, device, mesh=mesh)
        torch.cuda.synchronize()
        built.update(seconds=time.perf_counter() - t0, result=result,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        return result

    tpipe.build_model = timed_build
    try:
        rc, counts, report, wall = _cli_run(LLAMA8B_INT4, os.path.join(root, "int4"),
                                            "blind_eval.json")
    finally:
        tpipe.build_model = real_build
    after_gb = torch.cuda.max_memory_allocated() / 1e9
    spec, params = built.pop("result")
    cfg, device = cli._resolve(cli.build_parser().parse_args(LLAMA8B_INT4))
    ds = cli._load_dataset(cfg)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    tokens = torch.from_numpy(tb.tokens).to(device)
    pos = torch.from_numpy(tb.answer_pos).to(device)
    nrows = _numeric_rows(ds)
    mc, dchunks = _decode_chunks(spec, params, tokens.shape[1], np.zeros(len(nrows)), 1)
    want = blind_int4_launches_want(math.ceil(len(ds) / SCORER_BATCH), dchunks, LLAMA8B_LAYERS)
    mra = report.get("numeric_blind_mra")
    print(f"[llama8b] (c) eval-blind int4 Llama-3-8B at {spec.n_layers} layers, "
          f"synthetic-vsi:0.4 n={len(ds)} rc={rc}: n_mcq {report['n_mcq']}, n_numeric "
          f"{report.get('n_numeric')} in {dchunks} decode chunk(s) of {mc} rows; launches fwd "
          f"{counts['fwd']} int4 {counts['int4']} dattn {counts['dattn']} (want {want['fwd']}/"
          f"{want['int4']}/{want['dattn']}: K3 at {spec.d_model} -> {spec.q_dim}, "
          f"{spec.kv_dim}, {spec.d_ff} and {spec.d_ff} -> {spec.d_model}); blind_accuracy "
          f"{report['blind_accuracy']:.4f}, numeric_blind_mra {mra}; init + quantization "
          f"{built['seconds']:.2f} s to a {quantized_bytes(params) / 1e9:.2f} GB base, peak "
          f"device memory during the build {built['peak_gb']:.2f} GB, after it (scoring and "
          f"decode) {after_gb:.2f} GB; CLI wall {wall:.2f} s")
    if (rc != 0 or counts != want or report["n_mcq"] != 48 or report.get("n_numeric") != 16
            or mra is None or not math.isfinite(mra)):
        raise AssertionError(f"Llama-3-8B eval-blind int4 rc={rc}, launches {counts} (want "
                             f"{want}), report {report}")
    t0 = time.perf_counter()
    line, ok, state = first_decode_step_gate(params, spec, tokens, pos, nrows)
    print(f"[llama8b] (c) {line} ({time.perf_counter() - t0:.2f} s)")
    if not ok:
        raise AssertionError("the 32-layer decode step through K3 disagrees with the plain path")
    step = decode_step_profiles(state)
    rows = state[2].shape[0]
    for up, name in ((True, "through K3"), (False, "plain path (dequantize, then product)")):
        print(f"[llama8b] (c) decode step ({rows} rows, 32 layers), {name}: "
              f"{rows / step[up]['wall_ms'] * 1e3:.1f} tokens/s; {_fmt_profile(step[up])}")
    del state, params
    torch.cuda.empty_cache()
    return {"launches": counts, "build_s": built["seconds"], "build_peak_gb": built["peak_gb"],
            "after_build_peak_gb": after_gb,
            "decode_tokens_per_s": rows / step[True]["wall_ms"] * 1e3,
            "decode_idle_share": step[True]["idle_share"]}


def phase_llama8b():
    """Phase 22: Llama-3-8B at all 32 layers on one card through the CLI."""
    root = tempfile.mkdtemp(prefix="tst_torch_llama8b_")
    try:
        out = {"sft": _llama8b_sft(root)}
        torch.cuda.empty_cache()
        out["ibp"] = _llama8b_ibp()
        out["int4"] = _llama8b_int4(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _f32(tree):
    """A weight tree in f32; quantized leaves stay as they are (they
    dequantize to the spec's dtype at use)."""
    if isinstance(tree, dict):
        if "q" in tree and "scale" in tree:
            return tree
        return {key: _f32(t) for key, t in tree.items()}
    return tree.float()


def entry_logit_gate(lk, lp, l32, ratio=ENTRY_ERR_RATIO, eps=ENTRY_ERR_EPS):
    """``entry()``'s f32 logits through the kernel, ``lk``, against the f32
    plain forward's, ``l32``, beside the bf16 plain path's, ``lp``, on the
    same weights and tokens: finite, of one shape, and max|lk - l32| within
    ``ratio`` · max|lp - l32| + ``eps`` · max|l32| → (the kernel path's
    error, the plain path's, the bound, the first decode step's absolute
    rule LOGIT_TOL · max|l32| as a report)."""
    if not lk.shape == lp.shape == l32.shape or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"entry() logits {tuple(lk.shape)} against the plain path's "
                             f"{tuple(lp.shape)} and {tuple(l32.shape)}, finite "
                             f"{bool(torch.isfinite(lk).all())}")
    scale = float(l32.abs().max())
    err_k, err_p = float((lk - l32).abs().max()), float((lp - l32).abs().max())
    bound = ratio * err_p + eps * scale
    if not err_k <= bound:
        raise AssertionError(f"entry() logits: max|lk - l32| {err_k:.4e} > {ratio} x the plain "
                             f"path's {err_p:.4e} + {eps} x max|logit| = {bound:.4e}")
    return err_k, err_p, bound, LOGIT_TOL * scale


def dryrun_gate(result, printed, n, against_plain):
    """``dryrun_multichip(n, against_plain=...)``'s result and what it
    printed: graft_entry's own gate on the result, and its OK line the last
    line printed."""
    from tst_torch.graft_entry import check_result, ok_line

    check_result(result, n, against_plain)
    lines = printed.strip().splitlines()
    if not lines or lines[-1] != ok_line(result):
        raise AssertionError(f"dryrun_multichip({n}) printed {lines[-1:]}, not its OK line "
                             f"{ok_line(result)!r}")


def dryrun_launch_gate(counts):
    """Every kernel of the dry run's path launched in its run, and none off it."""
    missing = [key for key in DRYRUN_KERNELS if counts[key] <= 0]
    off = [key for key in DRYRUN_OFF_PATH if counts[key] != 0]
    if missing or off:
        raise AssertionError(f"dry run launches {counts}: none of {missing}; off its path "
                             f"{off}")


def _dryrun(n, against_plain):
    """``dryrun_multichip(n, against_plain=...)`` on cards, gated
    (dryrun_gate) → (its result, wall s)."""
    import contextlib
    import io

    from tst_torch.graft_entry import dryrun_multichip

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = dryrun_multichip(n, against_plain=against_plain)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(buf.getvalue().strip())
    dryrun_gate(result, buf.getvalue(), n, against_plain)
    return result, wall


def phase_entry():
    """Phase 23: the entry points of tst_torch.graft_entry on the card."""
    from tst_torch.graft_entry import entry
    from tst_torch.models.decoder import apply_model
    from tst_torch.models.spec import spec_by_name

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn, (params, tokens) = entry()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _zero_launch_counts()
    t0 = time.perf_counter()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _launch_counts()
    check_launches(counts, {**{key: 0 for key in counts}, "fwd": N_LAYERS}, "entry()")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    spec = spec_by_name("qwen2.5-0.5b")
    spec32 = dataclasses.replace(spec, dtype=torch.float32)
    # the reference's batch is all ones: every value row of a layer is the
    # same, and attention returns it whatever its weights, so its gate holds
    # trivially; random tokens are where K1's rounding shows
    rand = torch.randint(0, spec.vocab_size, tuple(tokens.shape), device=tokens.device,
                         generator=torch.Generator(tokens.device).manual_seed(1))
    gates = {}
    with torch.inference_mode():
        for name, toks, lk in (("ones", tokens, logits), ("random", rand, None)):
            lk = fn(params, toks) if lk is None else lk
            lp = apply_model(params, toks, spec)
            l32 = apply_model(_f32(params), toks, spec32)
            gates[name] = entry_logit_gate(lk, lp, l32)
            del lk, lp, l32
    fwd_ms = statistics.median(walls) * 1e3
    print(f"[entry] entry(): Qwen2.5-0.5B bf16 forward of {tuple(tokens.shape)} tokens, "
          f"{counts['fwd']} K1 forward launches; init {init_s:.3f} s, first call "
          f"{first_s * 1e3:.2f} ms, then median {fwd_ms:.2f} ms ({walls}); peak "
          f"{peak:.2f} GB; logits against the f32 plain forward, (kernel path's max|dlogit|, "
          f"the bf16 plain path's, bound {ENTRY_ERR_RATIO} x plain + {ENTRY_ERR_EPS} x "
          f"max|logit|, {LOGIT_TOL} x max|logit| reported): {gates}")
    err_k, err_p, bound, abs_rule = gates["random"]
    del fn, params, tokens, logits, rand
    torch.cuda.empty_cache()

    # the launches are the dry run's own; a second run holds legs 1-4 to
    # the plain path from one state (its launches compare, and are not kept)
    _zero_launch_counts()
    dry_result, wall1 = _dryrun(1, against_plain=False)
    dry = _launch_counts()
    dryrun_launch_gate(dry)
    vs_plain = _dryrun(1, against_plain=True)[0]["vs_plain"]
    print(f"[entry] dryrun_multichip(1): every leg through the kernels, wall {wall1:.2f} s, "
          f"launches {json.dumps(dry)}; again with legs 1-4 against the plain path: "
          f"{json.dumps(vs_plain)}")
    out = {"launches": counts, "init_s": init_s, "first_ms": first_s * 1e3, "fwd_ms": fwd_ms,
           "peak_gb": peak, "max_dlogit": err_k, "plain_max_dlogit": err_p,
           "logit_bound": bound, "abs_rule": abs_rule, "max_dlogit_ones": gates["ones"][0],
           "dryrun": {"launches": dry, "wall_s": wall1, **dry_result, "vs_plain": vs_plain}}
    cards = torch.cuda.device_count()
    if cards >= DRYRUN_CARDS:
        result, wall = _dryrun(DRYRUN_CARDS, against_plain=True)
        out[f"dryrun_{DRYRUN_CARDS}"] = {"wall_s": wall, **result}
        print(f"[entry] dryrun_multichip({DRYRUN_CARDS}, against_plain=True) on "
              f"{DRYRUN_CARDS} cards over NCCL: legs 1-4 against the plain path "
              f"{json.dumps(result['vs_plain'])}; wall {wall:.2f} s")
    else:
        print(f"[entry] dryrun_multichip({DRYRUN_CARDS}) not run: {cards} card(s) here")
    return out


def bench_launches_want(steps, warmup, qwen_layers=N_LAYERS, llama_layers=LLAMA8B_LAYERS):
    """The kernels' launches of one ``tst_torch.bench`` run on the card at
    ``steps`` timed and ``warmup`` untimed 0.5B steps → (each leg's, their
    sum). A train step launches one forward a layer ("dots" a second: it
    recomputes the layer in the backward and keeps no kernel output;
    "attn" and "flash" keep the kernel's output and lse), one dK/dV and one
    dQ, segmented on packed rows; a greedy decode call one forward a layer
    in its prefill, then in each step after the prefill's token the decode
    attention a layer, and on an int4 base K3 on each of a layer's 7
    projections. The fold-parallel and packed legs run 1 + (warmup - 1) +
    steps steps, the fold-sequential one 1 + K·(warmup - 1 + steps) one-fold
    steps; the 8B, long and decode legs their fixed counts."""
    from tst_torch import bench as tb

    def train(layers, n_steps, remat, seg=False):
        fwd = n_steps * (2 if remat in (True, "full", "dots") else 1)
        keys = ("fwd_seg", "dkv_seg", "dq_seg") if seg else ("fwd", "dkv", "dq")
        return dict(zip(keys, (layers * fwd, layers * n_steps, layers * n_steps)))

    def decode(layers, int4):
        calls = 1 + tb.DECODE_TIMED
        steps_after = calls * (tb.DECODE_NEW - 1 + tb.DECODE_SHORT - 1)
        out = {"fwd": layers * 2 * calls, "dattn": layers * steps_after}
        if int4:
            out["int4"] = INT4_PROJ * layers * steps_after
        return out

    fixed = tb.FIXED_WARM
    legs = {"fold_parallel": train(qwen_layers, steps + warmup, "dots"),
            "packed": train(qwen_layers, steps + warmup, "dots", seg=True),
            "fold_sequential": train(qwen_layers, 1 + tb.K * (warmup - 1 + steps), "dots"),
            "llama8b_k2": train(llama_layers, fixed + tb.L8_K2_TIMED, "dots"),
            "llama8b_k5": train(llama_layers, fixed + tb.L8_K5_TIMED, "attn")}
    for kk, remat, _ in tb.L8_PACKED:
        legs[f"llama8b_packed_k{kk}"] = train(llama_layers, fixed + tb.L8_PACKED_TIMED, remat,
                                              seg=True)
    legs.update({"llama8b_int4_decode": decode(llama_layers, True),
                 "longseq": train(qwen_layers, fixed + tb.LONG_TIMED, "flash"),
                 "longseq_32k": train(qwen_layers, fixed + tb.LONG32_TIMED, "flash"),
                 "decode": decode(qwen_layers, False)})
    total = dict.fromkeys(("fwd", "dkv", "dq", "fwd_seg", "dkv_seg", "dq_seg", "int4", "mlp",
                           "dattn"), 0)
    for leg in legs.values():
        for key, n in leg.items():
            total[key] += n
    return legs, total


def _positive(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x) and x > 0


def bench_record_gate(stdout, stderr=""):
    """The bench's output on the card: exactly one line, a strict-JSON
    record with the contract (metric, value > 0, unit, vs_baseline > 0,
    fold_finetunes_per_hour_per_chip > 0, backend "cuda", n_chips 1) and
    every leg's key (BENCH_LEG_KEYS), and no leg reported skipped on
    ``stderr`` → the record."""
    lines = stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"tst_torch.bench printed {len(lines)} lines on stdout, not one "
                             f"JSON line: {lines[:3]}")
    rec = strict_json(lines[0])
    bad = [key for key, ok in (
        ("metric", rec.get("metric") == "blind_sft_samples_per_sec_per_chip"),
        ("value", _positive(rec.get("value"))), ("unit", rec.get("unit") == "samples/s/chip"),
        ("vs_baseline", _positive(rec.get("vs_baseline"))),
        ("fold_finetunes_per_hour_per_chip",
         _positive(rec.get("fold_finetunes_per_hour_per_chip"))),
        ("backend", rec.get("backend") == "cuda"), ("n_chips", rec.get("n_chips") == 1)) if not ok]
    missing = [key for key in BENCH_LEG_KEYS if key not in rec]
    skipped = [ln for ln in stderr.splitlines() if " skipped: " in ln]
    if bad or missing or skipped:
        raise AssertionError(f"tst_torch.bench's record: contract keys {bad} wrong, leg keys "
                             f"{missing} missing, legs skipped {skipped}: {rec}")
    return rec


@functools.lru_cache(maxsize=1)
def _bench_workload():
    """The bench's workload on the card (tst_torch.bench.bench_workload),
    built once for phase 24's gates and the segmented kernel checks."""
    from tst_torch import bench

    return bench.bench_workload(True, max(GATE_BATCHES.values()), 1)


def bench_gate_cases(device):
    """The bench's train paths new to the card, as gate_case, one at a
    time: the fold-parallel step at its Qwen2.5-0.5B shape, the int8
    Llama-3-8B k=2 leg, and the packed int8 8B leg under remat="attn" (k=5,
    one row of 1024 a fold, its own starts); both 8B legs at
    LLAMA8B_GATE_LAYERS of the 32 layers (all 32 before phase 25 took its
    time), on one base made once and freed after them."""
    from tst_torch import bench
    from tst_torch.models.decoder import init_params
    from tst_torch.models.lora import LoraSpec
    from tst_torch.models.quant import quantize_params
    from tst_torch.models.spec import spec_by_name
    from tst_torch.train.sft import FoldTrainer

    w = _bench_workload()

    def maker(k, remat, packed=False):
        def make(spec, use_pallas):
            lspec = LoraSpec(rank=bench.LORA_RANK, alpha=bench.LORA_ALPHA, dtype=spec.dtype)
            return FoldTrainer(spec, lspec, k=k, lr=bench.LR, use_pallas=use_pallas,
                               remat=remat, t_max=w.t_max, packed=packed)
        return make

    arrays = bench._to(device, w.tb.tokens, w.tb.loss_mask, w.tb.answer_pos)
    spec = spec_by_name(w.spec_name)
    params = init_params(torch.Generator(device).manual_seed(0), spec)
    yield gate_case("qwen", f"{spec.name} k={bench.K} x {bench.BATCH} rows, dots",
                    maker(bench.K, "dots"), spec, params, arrays, w.batches)
    del params
    spec8 = dataclasses.replace(spec_by_name("llama3-8b"), n_layers=LLAMA8B_GATE_LAYERS)
    params8 = quantize_params(init_params(torch.Generator(device).manual_seed(0), spec8), bits=8)
    cut = spec8.n_layers
    yield gate_case("llama8b_k2", f"int8 {spec8.name} ({cut} layers) k=2 x 2 rows, dots",
                    maker(2, "dots"), spec8, params8, arrays, w.b8)
    fp8, pb8 = w.packed8[5]
    parrays = bench._to(device, fp8.tokens, fp8.loss_mask, fp8.answer_pos)
    (psegs,) = bench._to(device, fp8.seg_starts)
    yield gate_case("llama8b_packed_k5", f"packed int8 {spec8.name} ({cut} layers) k=5 x 1 "
                    f"row of {bench.PACK_LEN}, attn", maker(5, "attn", packed=True),
                    spec8, params8, parrays, pb8, psegs)
    del params8, parrays, psegs
    torch.cuda.empty_cache()


def _bench_step_gates():
    """step_gate on each of bench_gate_cases."""
    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for case in bench_gate_cases(device):
        t0 = time.perf_counter()
        line, ok = step_gate(case)
        print(f"[bench] {case['name']}, kernels vs model.use_pallas=false: {line} "
              f"({time.perf_counter() - t0:.2f} s)")
        if not ok:
            raise AssertionError(f"the bench's {case['name']} step through the kernels "
                                 "disagrees with the plain path")
        out[case["name"]] = line
    return out


def _bench_seg_cases():
    """The segmented kernels at the bench's packed 8B legs' first steps:
    Llama-3-8B heads, k x one row of PACK_LEN a fold, the legs' own starts."""
    from tst_torch import bench

    w = _bench_workload()
    cases = []
    for kk, _, _ in bench.L8_PACKED:
        fp8, pb8 = w.packed8[kk]
        seg = fp8.seg_starts[np.arange(kk)[:, None], pb8[0]]
        cases.append(((kk, bench.PACK_LEN, 32, 8, 128), seg.reshape(-1, seg.shape[-1])))
    return cases


def phase_bench(full=True):
    """Phase 24: ``tst_torch.bench`` on the card, in process with its
    stdout and stderr captured, after the step gates of its new train
    paths; the launches of its run as its legs imply, its record gated."""
    import contextlib
    import io

    from tst_torch import bench

    gates = _bench_step_gates()
    saved = {key: os.environ.get(key) for key in BENCH_ENV}
    if full:
        os.environ.update(BENCH_ENV)
    out, err = io.StringIO(), io.StringIO()
    try:
        steps, warmup = bench.bench_steps()
        torch.cuda.empty_cache()
        _zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        sys.stderr.write(err.getvalue())
        sys.stderr.flush()
    print(out.getvalue().strip())
    record = bench_record_gate(out.getvalue(), err.getvalue())
    legs, want = bench_launches_want(steps, warmup)
    check_launches(counts, want, "tst_torch.bench")
    if rc != 0:
        raise AssertionError(f"tst_torch.bench returned {rc}")
    print(f"[bench] python -m tst_torch.bench in process (TST_BENCH_STEPS={steps}, "
          f"TST_BENCH_WARMUP={warmup}): one JSON line, backend cuda, n_chips 1, every leg's "
          f"key, no leg skipped; wall {wall:.1f} s; launches {json.dumps(counts)} (as the legs "
          f"imply: {json.dumps(legs)})")
    return {"launches": counts, "wall_s": wall, "steps": steps, "warmup": warmup,
            "record": record, "step_gates": gates}


def widths_specs():
    """The ModelSpec of each of WIDTHS, at its published widths and depth."""
    from tst_torch.models.spec import spec_by_name

    return {name: spec_by_name(name) for name in WIDTHS}


def widths_k1_shapes(specs):
    """K1's (B, S, H, KVH, D) at the widths' step for each of their head
    layouts that KERNEL_SHAPES does not hold, in WIDTHS' order."""
    seen = {(h, kvh, d) for _, _, h, kvh, d in KERNEL_SHAPES}
    out = []
    for spec in specs.values():
        layout = (spec.n_heads, spec.n_kv_heads, spec.d_head)
        if layout not in seen:
            seen.add(layout)
            out.append(WIDTHS_STEP_BS + layout)
    return out


def int4_leaves(spec, names=None):
    """(K, N) of a layer's int4 projections (those of ``names``, default all
    seven), in a layer's order."""
    leaves = {"wq": (spec.d_model, spec.q_dim), "wk": (spec.d_model, spec.kv_dim),
              "wv": (spec.d_model, spec.kv_dim), "wo": (spec.q_dim, spec.d_model),
              "w_gate": (spec.d_model, spec.d_ff), "w_up": (spec.d_model, spec.d_ff),
              "w_down": (spec.d_ff, spec.d_model)}
    return {key: kn for key, kn in leaves.items() if names is None or key in names}


def int4_bound(shapes, m):
    """K3's bound over the (K, N) products of ``shapes`` at M rows: 2·M·K·N
    operations each; bytes of y (bf16), the packed nibbles, the f32 g128
    scales and the f32 output."""
    flops = sum(2 * m * k * n for k, n in shapes)
    nbytes = sum(m * k * 2 + k * n // 2 + (k // INT4_GROUP_SIZE) * n * 4 + m * n * 4
                 for k, n in shapes)
    return _bound(flops, nbytes)


def split_batches(batches, rows):
    """[steps, k, B] fold batches → [steps · B / rows, k, rows]: each step's
    fold rows cut into consecutive groups of ``rows`` (the step gates' rows
    a fold, from a run's own batches)."""
    b = batches.shape[2]
    if b % rows:
        raise ValueError(f"{b} rows a fold do not cut into groups of {rows}")
    return np.concatenate([batches[:, :, i: i + rows][:, None] for i in range(0, b, rows)],
                          1).reshape(-1, batches.shape[1], rows)


def pair_launches_want(chunks, rounds, gamma, target_layers, draft_layers):
    """Speculative ``generate``'s launches with an int8 target and an int4
    draft: the prefills' forwards (a layer each, both models, each chunk);
    in each round gamma + 1 draft steps, each with K3 on a draft layer's 7
    projections and the decode attention a draft layer, and the target's
    verify chunk, the decode attention a target layer (its int8 products
    are the library's)."""
    return {"fwd": (target_layers + draft_layers) * chunks, "dkv": 0, "dq": 0, "fwd_seg": 0,
            "dkv_seg": 0, "dq_seg": 0, "int4": INT4_PROJ * draft_layers * (gamma + 1) * rounds,
            "mlp": 0, "dattn": (draft_layers * (gamma + 1) + target_layers) * rounds}


def forward_gate(o, lse, o_ref, lse_ref):
    """K1's forward against its plain version: o finite, max|o - ref| <=
    O_TOL and <= O_REL_TOL·max|ref|, max|lse - ref| <= LSE_TOL → (readings
    {"o_err", "o_rel", "lse_err"}, ok)."""
    o_err = (o.float() - o_ref.float()).abs().max().item()
    got = {"o_err": o_err, "o_rel": o_err / o_ref.float().abs().max().item(),
           "lse_err": (lse - lse_ref).abs().max().item()}
    ok = (bool(torch.isfinite(o).all()) and o_err <= O_TOL and got["o_rel"] <= O_REL_TOL
          and got["lse_err"] <= LSE_TOL)
    return got, ok


def _k1_counts(seg, causal):
    """K1's (forward, dK/dV, dQ) launch counts on the route these take."""
    import tst_torch.kernels.flash_attention as tfa

    if seg is not None:
        return tfa.LAUNCHES_SEG, tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ
    if causal:
        return tfa.LAUNCHES, tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ
    return tfa.LAUNCHES_FULL, tfa.LAUNCHES_FULL_BWD_DKV, tfa.LAUNCHES_FULL_BWD_DQ


def _plain_k1(q, k, v, do, o, lse, causal, seg, rows):
    """K1's plain versions over the batch in calls of ``rows`` rows (their
    [S, S] f32 tensors) → (forward → (o, lse), backward on the kernels' o
    and lse in f32 → (dq, dk, dv)), each concatenated over the calls."""
    import tst_torch.kernels.flash_attention as tfa

    calls = [slice(i, i + rows) for i in range(0, q.shape[0], rows)]

    def kw(sl):
        return {"causal": causal, **({} if seg is None else {"seg_starts": seg[sl]})}

    def fwd():
        return [torch.cat(t) for t in zip(*(tfa.flash_attention_reference(
            q[sl], k[sl], v[sl], **kw(sl)) for sl in calls))]

    def bwd():
        return [torch.cat(t) for t in zip(*(tfa.flash_attention_backward_reference(
            q[sl].float(), k[sl].float(), v[sl].float(), o[sl].float(), lse[sl],
            do[sl].float(), **kw(sl)) for sl in calls))]

    return fwd, bwd


def k1_case(device, shape, seed, starts=None, causal=True, samples=10, reps=5, plain=False,
            timed=True, plain_rows=None, tag="widths"):
    """K1's forward, dK/dV and dQ at ``shape`` (plain rows, or packed with
    ``starts``; non-causal without ``causal``) against their plain versions
    (forward_gate; GRAD_TOL against the f32 plain backward on the same o
    and lse; those over ``plain_rows`` batch rows a call, all by default),
    each launched once and bit-equal on a second call, the autograd
    Function's gradients the kernels'; then, with ``timed``, each kernel's
    median time beside the library's, the bound and, with ``plain``, the
    plain version's → {"fwd", "dkv", "dq"} and the library's backend; the
    line printed under ``tag``."""
    import tst_torch.kernels.flash_attention as tfa

    b, s, h, kvh, d = shape
    rng = np.random.default_rng(seed)
    q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
    k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
    seg = None if starts is None else torch.from_numpy(starts).to(device)
    kw = {"causal": causal, **({} if seg is None else {"seg_starts": seg})}
    before = _k1_counts(seg, causal)
    o, lse = tfa.flash_attention(q, k, v, **kw)
    di = tfa.backward_row_stat(o, do)
    got = tfa.flash_attention_backward(q, k, v, lse, di, do, **kw)
    torch.cuda.synchronize()
    if _k1_counts(seg, causal) != tuple(n + 1 for n in before):
        raise AssertionError(f"K1 at {shape} did not launch each kernel of its route once")
    _check_bitwise(lambda: tfa.flash_attention(q, k, v, **kw), (o, lse), "the forward kernel")
    _check_bitwise(lambda: tfa.flash_attention_backward(q, k, v, lse, di, do, **kw), got)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    tfa.flash_attention(*leaves, **kw)[0].backward(do)
    if not all(torch.equal(a.grad, g) for a, g in zip(leaves, got)):
        raise AssertionError(f"K1 at {shape}: the autograd Function's gradients are not the "
                             f"kernels'")
    del leaves
    plain_fwd, plain_bwd = _plain_k1(q, k, v, do, o, lse, causal, seg, plain_rows or b)
    fwd, fwd_ok = forward_gate(o, lse, *plain_fwd())
    want = plain_bwd()
    rel = [_rel_err(g, w) for g, w in zip(got, want)]
    abs_err = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
    finite = all(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for g in got)
    del want
    what = (f"B={b} S={s} H={h} KVH={kvh} D={d}" + ("" if causal else ", causal=False")
            + ("" if seg is None else f", {int((starts < SEG_PAD).sum())} segment starts"))
    line = (f"{what}: max|o-ref| {fwd['o_err']:.3e} (<= {O_TOL}; /max|ref| "
            f"{fwd['o_rel']:.3e} <= {O_REL_TOL}), max|lse-ref| {fwd['lse_err']:.3e} "
            f"(<= {LSE_TOL}); max|d-ref|/max|ref| dq {rel[0]:.3e} dk {rel[1]:.3e} dv "
            f"{rel[2]:.3e} (<= {GRAD_TOL}); bit-equal on a second call, launched once, the "
            f"autograd Function's gradients the kernels'")
    if not (finite and fwd_ok) or max(rel) > GRAD_TOL:
        raise AssertionError(f"K1 disagrees with its plain version at {shape}: {line}")
    if not timed:
        print(f"[{tag}] K1 {line}")
        return None
    extra = [None if seg is None else tfa.kernel_seg_starts(seg, q), causal]
    lib = _sdpa_yardstick(q, k, v, do, o, None if seg is None else tfa.segment_mask(seg, s),
                          samples, reps, causal)
    bounds = _attention_bounds(q, k, seg, causal)
    out = {"fwd": {"max_abs_err": fwd["o_err"],
                   "ms": median_ms(lambda: tfa._launch_fwd(q, k, v, *extra), samples, reps),
                   "library_ms": lib["fwd_ms"], **bounds["fwd"]},
           "dkv": {"max_abs_err": max(abs_err[1:]),
                   "ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di, *extra),
                                   samples, reps),
                   "library_ms": lib["bwd_ms"], **bounds["dkv"]},
           "dq": {"max_abs_err": abs_err[0],
                  "ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di, *extra),
                                  samples, reps),
                  "clocks_sm_power": clocks_now(), "library_ms": lib["bwd_ms"],
                  **bounds["dq"]}}
    out["fwd"]["max_rel_err"] = fwd["o_rel"]
    out["dkv"]["max_rel_err"], out["dq"]["max_rel_err"] = max(rel[1:]), rel[0]
    if plain:
        out["fwd"]["plain_ms"] = median_ms(plain_fwd, samples=5, reps=2)
        out["dkv"]["plain_ms"] = out["dq"]["plain_ms"] = median_ms(plain_bwd, samples=5, reps=2)
    print(f"[{tag}] K1 {line}; ms " + ", ".join(
        f"{key} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, library {r['library_ms']:.4f}"
        + (f", plain {r['plain_ms']:.4f})" if plain else ")") for key, r in out.items())
        + f" (library {lib['backend']}, {lib['gqa']}; median of {samples} x {reps} calls"
        + (f"; plain over {plain_rows} rows a call" if plain and plain_rows else "") + ")")
    out["library"] = f"{lib['backend']}, {lib['gqa']}"
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()
    return out


def _widths_kernels(device, specs):
    """Phase 25's kernel checks: K1 at the new head layouts, S=576 at group 7
    and packed at Qwen2.5-7B's heads; K3 at the new leaves (rows of the
    verify chunk's M bit-equal to a greedy step's, F1), timed over a
    Qwen2.5-7B and a Llama-3.2-1B layer beside tinygemm and the bound; K4 at
    Qwen2.5-7B's MLP; the decode attention at the four new layouts."""
    import tst_torch.kernels.quant_matmul as tqm
    from tst_torch.models.quant import quantize_leaf

    marks = [time.perf_counter()]
    k1 = {}
    for i, shape in enumerate(widths_k1_shapes(specs) + [WIDTHS_ODD]):
        k1[str(list(shape))] = k1_case(device, shape, seed=100 + i, samples=5)
    starts = _packed_step_starts()[: WIDTHS_PACKED[0]]
    k1[str(list(WIDTHS_PACKED)) + " packed"] = k1_case(device, WIDTHS_PACKED, 99, starts,
                                                       samples=5)
    marks.append(time.perf_counter())

    g = torch.Generator(device=device).manual_seed(12)
    int4, layer = {}, {}
    for name, names in WIDTHS_INT4.items():
        leaves = int4_leaves(specs[name], names)
        counts = {kn: list(leaves.values()).count(kn) for kn in leaves.values()}
        lay = {"k3_ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
               "leaves": {key: list(kn) for key, kn in leaves.items()}}
        for (k, n), per_layer in counts.items():
            w = (torch.randn(2, k, n, device=device, generator=g) / math.sqrt(k)).to(
                torch.bfloat16)
            leaf = quantize_leaf(w, bits=4)
            q, sc = leaf["q"], leaf["scale"]
            del w, leaf
            y = torch.randn(max(WIDTHS_INT4_M), k, device=device, generator=g).to(torch.bfloat16)
            rows = {}
            for m in WIDTHS_INT4_M:
                ym = y[:m].contiguous()
                before = tqm.LAUNCHES
                got = tqm.int4_matmul_stacked(ym, q, sc, 1)
                torch.cuda.synchronize()
                want = tqm.int4_matmul_reference(ym, q, sc, 1)
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                if (tqm.LAUNCHES != before + 1 or rel > INT4_TOL
                        or not bool(torch.isfinite(got).all())):
                    raise AssertionError(f"int4_matmul disagrees with its plain version at "
                                         f"M={m} K={k} N={n}: max|d|/max|ref| {rel:.3e}")
                _check_bitwise(lambda: (tqm.int4_matmul_stacked(ym, q, sc, 1),), (got,), "K3")
                rows[m] = (got, rel)
                lay["max_abs_err"] = max(lay["max_abs_err"], err)
            m0, m1 = WIDTHS_INT4_M
            if not torch.equal(rows[m1][0][:m0], rows[m0][0]):
                raise AssertionError(f"K3's first {m0} rows at M={m1} differ from an M={m0} "
                                     f"call (K={k} N={n})")
            ym = y[:m0].contiguous()
            k3_ms = graph_us(lambda: tqm._launch(ym, q, sc, 1)) / 1e3
            plain_ms = median_ms(lambda: tqm.int4_matmul_reference(ym, q, sc, 1), samples=10,
                                 reps=3, warmup=1)
            try:
                w4, sz = tinygemm_operands(q, sc, 1)
                got_lib = torch.ops.aten._weight_int4pack_mm(ym, w4, INT4_GROUP_SIZE, sz)
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError, AttributeError) as e:
                lib = f"tinygemm refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
                lay["library_ms"] = None
            else:
                rel_lib = _rel_err(got_lib, tqm.int4_matmul_reference(ym, q, sc, 1))
                if rel_lib > LIB_INT4_TOL:
                    raise AssertionError(f"the tinygemm yardstick disagrees with K3's plain "
                                         f"version at K={k} N={n}: {rel_lib:.3e}")
                lib_ms = graph_us(lambda: torch.ops.aten._weight_int4pack_mm(
                    ym, w4, INT4_GROUP_SIZE, sz)) / 1e3
                lib = f"tinygemm {lib_ms:.5f} (vs plain {rel_lib:.3e})"
                if lay["library_ms"] is not None:
                    lay["library_ms"] += per_layer * lib_ms
                del w4, sz, got_lib
            lay["k3_ms"] += per_layer * k3_ms
            lay["plain_ms"] += per_layer * plain_ms
            print(f"[widths] K3 {name} K={k} N={n} (x{per_layer} a layer): max|out-ref|/max|ref| "
                  + ", ".join(f"M={m} {r:.3e}" for m, (_, r) in rows.items())
                  + f" (<= {INT4_TOL}); split plan {tqm.split_plan(k, n // 2)}; bit-equal on a "
                  f"second call, rows 0-{m0 - 1} of M={m1} bit-equal to M={m0}; device ms at "
                  f"M={m0}: K3 {k3_ms:.5f}, {lib}, plain {plain_ms:.4f}")
            del q, sc, y, rows
        lay.update(int4_bound(list(leaves.values()), WIDTHS_INT4_M[0]))
        layer[name] = lay
    int4 = {name: {"ms": r["k3_ms"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "max_abs_err": r["max_abs_err"], "leaves": r["leaves"],
                   "timed": f"the listed leaves of one layer at M={WIDTHS_INT4_M[0]}, device "
                            f"time (CUDA graph), summed"} for name, r in layer.items()}
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    mlp = {str(list(WIDTHS_MLP)): mlp_case(device, *WIDTHS_MLP, timed=True, tag="widths")}
    marks.append(time.perf_counter())
    dattn = {}
    for case in WIDTHS_DATTN:
        err, q, k, v, mask, line = dattn_check(device, case)
        rec, text = dattn_times(q, k, v, mask, back_to_back=False)
        dattn[str(list(case))] = {"max_abs_err": err, **rec}
        print(f"[widths] decode attention {line}; {text}")
    marks.append(time.perf_counter())
    print(f"[widths] kernel checks' seconds: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(("K1", "K3", "K4", "decode attention"),
                                                     marks, marks[1:])))
    return {"k1": k1, "int4": int4, "mlp": mlp, "dattn": dattn}


class _CutDepth:
    """``spec_by_name(name)`` gives ``n_layers`` layers while in the block
    (the depth cut of a width's run through the CLI)."""

    def __init__(self, name, n_layers):
        self.name, self.n_layers = name, n_layers

    def __enter__(self):
        from tst_torch.models import spec as tspec

        self.saved = tspec._SPECS[self.name]
        tspec._SPECS[self.name] = dataclasses.replace(self.saved, n_layers=self.n_layers)

    def __exit__(self, *exc):
        from tst_torch.models import spec as tspec

        tspec._SPECS[self.name] = self.saved


def widths_argv(name):
    """The width's diagnose-sft run through the CLI (remat for the 28-layer
    Qwen2.5-7B)."""
    argv = ["diagnose-sft", "--preset", "sft-cvbench-qwen", "--bench", "synthetic:0.5",
            "--set", f"model.name={name}", "--set", "model.tokenizer=byte",
            "--set", f"data.n={WIDTHS_ROWS}", "--set", "optim.epochs=1",
            "--set", "rf.cross_check=false"]
    return argv + (["--set", "model.remat=true"] if name == WIDTHS_FULL else [])


def _width_step(name, root, keep=False):
    """One width's diagnose-sft through the CLI (launches as implied, finite
    losses, s(x) in [0, 1]), its steps timed (synchronized) with their
    TFLOP/s and peak memory, then the step gates on its own weights and
    batches (PLAIN_ROWS a fold, GATE_BATCHES["widths"]) → (record, the
    run's state if ``keep``)."""
    import tst_torch.train.pipeline as tpipe
    import tst_torch.train.sft as tsft
    from tst_torch.aux.flops import train_step_flops

    step_ms, seen = [], {}
    real_step, real_build = tsft.FoldTrainer.step, tpipe._build_sft_state

    def timed_step(self, *args, **kw):
        torch.cuda.synchronize()
        if not step_ms:
            seen["setup_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = real_step(self, *args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        seen.update(rows=int(np.prod(np.shape(args[6]))), seq=args[3].shape[1],
                    step_peak=torch.cuda.max_memory_allocated(),
                    finite=seen.get("finite", True) and bool(torch.isfinite(result[2]).all()))
        return result

    def build(*args, **kw):
        seen["state"] = real_build(*args, **kw)
        return seen["state"]

    full = name == WIDTHS_FULL
    depth = widths_specs()[name].n_layers if full else WIDTHS_LAYERS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tsft.FoldTrainer.step, tpipe._build_sft_state = timed_step, build
    try:
        with _CutDepth(name, depth):
            rc, counts, report, wall = _cli_run(widths_argv(name), os.path.join(root, name),
                                                "report.json")
    finally:
        tsft.FoldTrainer.step, tpipe._build_sft_state = real_step, real_build
    st = seen.pop("state")
    spec, tr = st.spec, st.trainer
    rows = _read_jsonl(os.path.join(root, name, "sx.jsonl"))
    folds = np.array([r["fold"] for r in rows])
    k, steps = report["k"], report["train_steps"]
    chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / SCORER_BATCH)
    want = sft_launches_want(steps, chunks, depth, remat=tr.remat)
    sx = np.array([r["s_x"] for r in rows], np.float64)
    if (rc != 0 or spec.n_layers != depth or counts != want or len(rows) != WIDTHS_ROWS
            or not seen.get("finite") or not ((sx >= 0) & (sx <= 1)).all()):
        raise AssertionError(f"{name} diagnose-sft rc={rc}, layers {spec.n_layers}, launches "
                             f"{counts} (want {want}), rows {len(rows)}, finite losses "
                             f"{seen.get('finite')}")
    median = statistics.median(step_ms[1:])
    flops = train_step_flops(spec, tr.lora_spec, seen["rows"], seen["seq"], tr.t_max,
                             remat=tr.remat)
    tflops = flops["hardware_flops"] / median * 1e3 / 1e12
    peak = max(seen["setup_peak"], torch.cuda.max_memory_allocated()) / 1e9
    rec = {"layers": depth, "of_layers": widths_specs()[name].n_layers, "remat": tr.remat,
           "heads": [spec.n_heads, spec.n_kv_heads, spec.d_head], "launches": counts,
           "step_ms": median, "first_step_ms": step_ms[0],
           "tokens_per_s": seen["rows"] * seen["seq"] / median * 1e3,
           "samples_per_s": seen["rows"] / median * 1e3, "tflops": tflops,
           "share_of_peak": tflops / PEAK_TFLOPS, "peak_gb": peak,
           "step_peak_gb": seen["step_peak"] / 1e9, "cli_wall_s": wall}
    print(f"[widths] {name} at {depth} of {rec['of_layers']} layers (d_model {spec.d_model}, "
          f"{spec.n_heads}/{spec.n_kv_heads} heads, d_head {spec.d_head}, d_ff {spec.d_ff}, "
          f"vocab {spec.vocab_size}, qkv_bias {spec.qkv_bias}, tied {spec.tie_embeddings}, "
          f"rope_scaling {spec.rope_scaling}; remat={tr.remat}) diagnose-sft rc=0: {steps} "
          f"steps of {seen['rows']} rows x {seen['seq']} tokens, {chunks} scorer chunks; "
          f"launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as implied); "
          f"final_loss {report['final_loss']:.4f}; step median {median:.1f} ms over "
          f"{len(step_ms) - 1} steps after the first ({step_ms[0]:.1f} ms): "
          f"{rec['tokens_per_s']:.0f} tokens/s, {tflops:.1f} TFLOP/s ({rec['share_of_peak']:.1%} "
          f"of {PEAK_TFLOPS:g}); peak device memory {peak:.2f} GB (steps "
          f"{rec['step_peak_gb']:.2f} GB); CLI wall {wall:.2f} s")
    t0 = time.perf_counter()
    case = state_gate_case("widths", f"{name} k=2 x {PLAIN_ROWS} rows", st)
    case["batches"] = split_batches(st.batches, PLAIN_ROWS)
    line, ok = step_gate(case)
    del case
    print(f"[widths] {name} at {depth} layers, {PLAIN_ROWS} rows a fold, kernels vs "
          f"model.use_pallas=false: {line} ({time.perf_counter() - t0:.2f} s)")
    if not ok:
        raise AssertionError(f"the {name} step through the kernels disagrees with the plain "
                             f"path")
    rec["gate"] = line
    if not keep:
        del st
        st = None
        torch.cuda.empty_cache()
    return rec, st


def _width_int4_blind(st, root):
    """Qwen2.5-7B's int4 eval-blind through the CLI at all 28 layers, its
    base the step's bf16 weights under HF's names converted as a checkpoint
    is (hf_load.convert_state_dict, each tensor quantized on arrival by
    quantizing_put): launches as implied (K3 at its widths in every decode
    step), the letter probabilities within PROB_TOL of the plain attention on
    the same int4 base, and the first decode step through K3 against the
    plain path (phase 13's rule); samples/s."""
    import tst_torch.train.pipeline as tpipe
    from tst_torch import cli
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.models.hf_load import convert_state_dict
    from tst_torch.models.quant import quantized_bytes, quantizing_put
    from tst_torch.train.infer import score_all_mcq

    built = {}
    real_build = tpipe.build_model

    def from_state(cfg, tokenizer, device, mesh=None):
        t0 = time.perf_counter()
        params = convert_state_dict(hf_state_dict(st.params), st.spec, torch.bfloat16,
                                    quantizing_put(torch.bfloat16, bits=4), device=device)
        torch.cuda.synchronize()
        built.update(seconds=time.perf_counter() - t0, params=params)
        return st.spec, params

    tpipe.build_model = from_state
    try:
        rc, counts, report, wall = _cli_run(WIDTHS_BLIND, os.path.join(root, "int4"),
                                            "blind_eval.json")
    finally:
        tpipe.build_model = real_build
    params, spec = built.pop("params"), st.spec
    cfg, device = cli._resolve(cli.build_parser().parse_args(WIDTHS_BLIND))
    ds = cli._load_dataset(cfg)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    tokens = torch.from_numpy(tb.tokens).to(device)
    pos = torch.from_numpy(tb.answer_pos).to(device)
    nrows = _numeric_rows(ds)
    mcq = np.flatnonzero(tb.gold >= 0)
    mc, dchunks = _decode_chunks(spec, params, tokens.shape[1], np.zeros(len(nrows)), 1)
    want = blind_int4_launches_want(math.ceil(len(ds) / SCORER_BATCH), dchunks, spec.n_layers)
    if (rc != 0 or counts != want or report["n_mcq"] != len(mcq)
            or report.get("n_numeric") != len(nrows)):
        raise AssertionError(f"{WIDTHS_FULL} eval-blind int4 rc={rc}, launches {counts} (want "
                             f"{want}), report {report}")
    sel = torch.as_tensor(mcq, device=device)
    probs = {up: score_all_mcq(params, spec, tokens[sel], pos[sel], tb.option_token_ids,
                               tb.n_options[mcq], use_pallas=up) for up in (True, False)}
    diff = float(np.abs(probs[True] - probs[False]).max())
    line, ok, _ = first_decode_step_gate(params, spec, tokens, pos, nrows)
    rec = {"launches": counts, "samples_per_s": len(ds) / report["wall_seconds"],
           "wall_s": report["wall_seconds"], "cli_wall_s": wall,
           "convert_s": built["seconds"], "base_gb": quantized_bytes(params) / 1e9,
           "max_dprob": diff}
    print(f"[widths] {WIDTHS_FULL} int4 eval-blind at {spec.n_layers} layers (the step's weights "
          f"through convert_state_dict + quantizing_put, {built['seconds']:.2f} s to a "
          f"{rec['base_gb']:.2f} GB base) rc=0: n_mcq {report['n_mcq']}, n_numeric "
          f"{report['n_numeric']} in {dchunks} decode chunk(s) of {mc} rows; launches fwd "
          f"{counts['fwd']} int4 {counts['int4']} dattn {counts['dattn']} (as implied: K3 at "
          f"{spec.d_model} -> {spec.q_dim}, {spec.kv_dim}, {spec.d_ff} and {spec.d_ff} -> "
          f"{spec.d_model}); {rec['samples_per_s']:.2f} samples/s ({report['wall_seconds']} s); "
          f"letter probabilities, kernels vs plain attention on the int4 base: max|dprob| "
          f"{diff:.3e} (<= {PROB_TOL}); {line}")
    if diff > PROB_TOL or not ok:
        raise AssertionError(f"{WIDTHS_FULL}'s int4 eval-blind disagrees with the plain path")
    del params, probs
    torch.cuda.empty_cache()
    return rec


def _widths_pair(root):
    """The reference's serving pair through ``generate``: an int8 Llama-3-8B
    at 32 layers with a Llama-3.2-1B draft at 16 layers stored int4, gamma
    4, PAIR_ROWS rows: launches as implied, and every row's speculative
    tokens equal to greedy decode's on the same target weights (through the
    kernels, in process, a decode chunk at a time); rounds, acceptance and
    tokens/s."""
    import tst_torch.train.pipeline as tpipe
    from tst_torch import cli
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.models.decode import greedy_decode

    models, ids = [], []
    real_build = tpipe.build_model

    def keep(cfg, tokenizer, device, mesh=None):
        out = real_build(cfg, tokenizer, device, mesh=mesh)
        models.append(out)
        return out

    tpipe.build_model = keep
    original = _recording(tpipe, "speculative_greedy_decode", ids)
    try:
        rc, counts, rep, wall = _cli_run(PAIR_GEN, os.path.join(root, "pair"),
                                         "generate_report.json")
    finally:
        tpipe.build_model = real_build
        setattr(tpipe, "speculative_greedy_decode", original)
    (tspec, tparams), (dspec, dparams) = models
    chunk = rep["chunk_rows"]
    chunks = math.ceil(PAIR_ROWS / chunk)
    want = pair_launches_want(chunks, rep["spec_rounds"], PAIR_GAMMA, tspec.n_layers,
                              dspec.n_layers)
    spec_ids = np.concatenate(ids)[:PAIR_ROWS]
    if (rc != 0 or counts != want or tspec.n_layers != 32 or dspec.n_layers != 16
            or spec_ids.shape != (PAIR_ROWS, PAIR_MAX_NEW)):
        raise AssertionError(f"generate (the pair) rc={rc}, launches {counts} (want {want}), "
                             f"layers {tspec.n_layers}/{dspec.n_layers}, tokens "
                             f"{spec_ids.shape}")
    cfg, device = cli._resolve(cli.build_parser().parse_args(PAIR_GEN))
    tb = tokenize_dataset(cli._load_dataset(cfg), ByteTokenizer(), max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    tokens = torch.from_numpy(tb.tokens).to(device)
    plen = torch.from_numpy(tb.answer_pos).to(device).long() + 1
    greedy = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for lo in range(0, PAIR_ROWS, chunk):  # the run's chunks, the tail padded as it pads
            rows = np.arange(lo, min(lo + chunk, PAIR_ROWS))
            sel = torch.from_numpy(np.pad(rows, (0, chunk - rows.size), mode="edge")).to(device)
            out = greedy_decode(tparams, tokens[sel], plen[sel], PAIR_MAX_NEW, tspec,
                                use_pallas=True)
            greedy.append(out[: rows.size].cpu().numpy())
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    greedy = np.concatenate(greedy)
    col = first_divergence(greedy, spec_ids)
    differ = np.flatnonzero(col >= 0)
    tps = rep["tokens_generated"] / rep["decode_seconds"]
    rec = {"launches": counts, "rounds": rep["spec_rounds"],
           "acceptance": rep["draft_acceptance"],
           "committed_per_round": rep["committed_per_round"], "tokens_per_s": tps,
           "greedy_tokens_per_s": PAIR_ROWS * PAIR_MAX_NEW / greedy_s, "chunk_rows": chunk,
           "rows_differing": int(len(differ))}
    print(f"[widths] the pair: generate {PAIR_TARGET} int8 ({tspec.n_layers} layers, D="
          f"{tspec.d_head}) with --draft-model {PAIR_DRAFT} --draft-quantize int4 "
          f"({dspec.n_layers} layers, D={dspec.d_head}, tied {dspec.tie_embeddings}, "
          f"rope_scaling {dspec.rope_scaling}) --gamma {PAIR_GAMMA}, {PAIR_ROWS} rows x "
          f"{PAIR_MAX_NEW} tokens in {chunks} chunk(s) of {chunk} rc=0: launches fwd "
          f"{counts['fwd']} int4 {counts['int4']} dattn {counts['dattn']} (as implied); "
          f"spec_rounds {rep['spec_rounds']}, committed_per_round {rep['committed_per_round']}, "
          f"draft_acceptance {rep['draft_acceptance']}; {tps:.1f} tokens/s speculative vs "
          f"{rec['greedy_tokens_per_s']:.1f} greedy (in process); speculative vs greedy tokens: "
          f"rows differing {len(differ)} of {PAIR_ROWS} (must be 0; first divergent columns "
          f"{col[differ].tolist()}); CLI wall {wall:.2f} s")
    if len(differ):
        raise AssertionError("the pair's speculative tokens differ from greedy decode's")
    del models, tparams, dparams
    torch.cuda.empty_cache()
    return rec


def phase_widths(device):
    """Phase 25: the JAX package's six other geometries and its serving pair
    on the card, through every kernel their paths reach (_widths_kernels,
    _width_step for each of WIDTHS, Qwen2.5-7B's int4 eval-blind,
    _widths_pair)."""
    specs = widths_specs()
    walls = {}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        walls[key] = round(time.perf_counter() - t0, 1)
        return result

    out = {"kernels": timed("kernels", _widths_kernels, device, specs), "steps": {}}
    root = tempfile.mkdtemp(prefix="tst_torch_widths_")
    try:
        for name in WIDTHS:
            rec, st = timed(name, _width_step, name, root, name == WIDTHS_FULL)
            out["steps"][name] = rec
            if st is not None:
                out["int4_blind"] = timed("int4-blind", _width_int4_blind, st, root)
                del st
                torch.cuda.empty_cache()
        out["pair"] = timed("pair", _widths_pair, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[widths] seconds a part: {json.dumps(walls)}")
    table = {name: {key: r[key] for key in ("layers", "step_ms", "tokens_per_s",
                                            "share_of_peak", "peak_gb")}
             for name, r in out["steps"].items()}
    print(f"[widths] steps: {json.dumps(table, default=float)}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["rank", "mlp-int4", "serve", "long", "llama8b",
                                           "entry", "bench", "widths", "ring"],
                        default=None,
                        help="rank: the attention kernels against the library at the train "
                             "shape; mlp-int4: K3 and K4 against their plain versions, timed "
                             "(either runs on any build of tst_torch, so also a parent "
                             "commit's); serve: phase 20 alone; long: phase 21 alone; "
                             "llama8b: the native packer and phase 22 alone; entry: phase 23 "
                             "alone; bench: phase 24 alone, at the bench's default steps; "
                             "widths: phase 25 alone; ring: the SASS gate, phase 5b (the "
                             "non-causal kernels) and phase 21 (the ring through K1)")
    args = parser.parse_args(argv)
    device = phase_device()
    nvcc_s = phase_build(sass=args.only in (None, "ring"))
    if args.only == "rank":
        phase_rank(device)
        return
    if args.only == "ring":
        print(json.dumps({"full": phase_kernel_full(device), "long": phase_long(device)},
                         default=float))
        return
    if args.only == "serve":
        phase_kernel_decode_attention(device)
        print(json.dumps({"launches_serve": phase_serve()}))
        return
    if args.only == "long":
        print(json.dumps({"long": phase_long(device)}, default=float))
        return
    if args.only == "entry":
        print(json.dumps({"entry": phase_entry()}, default=float))
        return
    if args.only == "bench":
        print(json.dumps({"bench": phase_bench(full=False)}, default=float))
        return
    if args.only == "widths":
        _PHASE[0] = "widths"
        out = phase_widths(device)
        print(f"[cosines] lowest LoRA gradient cosine of each phase's step gates (>= "
              f"{GRAD_COSINE}): {json.dumps(LOWEST_COSINE)}")
        print(json.dumps({"widths": out}, default=float))
        return
    if args.only == "llama8b":
        print(json.dumps({"native_pack": phase_native_pack(), "llama8b": phase_llama8b()},
                         default=float))
        return
    if args.only == "mlp-int4":
        print(json.dumps({"int4": phase_kernel_int4(device, strict=False),
                          "mlp": phase_kernel_mlp(device), "steps": phase_steps()}))
        return
    walls = {"nvcc": round(nvcc_s, 1)}

    def run(name, fn, *a):
        _PHASE[0] = name
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[name] = round(time.perf_counter() - t0, 1)
            print(f"[walls] {name} {walls[name]} s", flush=True)

    run("native-pack", phase_native_pack)
    kern = run("kernel", phase_kernel, device)
    blind_launches, slice_probs, slice_report = run("slice", phase_slice)
    bwd = run("kernel-bwd", phase_kernel_bwd, device)
    full = run("kernel-full", phase_kernel_full, device)
    counts = run("train", phase_train)
    run("train-vs-plain", phase_train_vs_plain)
    seg = run("kernel-seg", phase_kernel_seg, device)
    packed = run("train-packed", phase_train_packed)
    run("train-packed-vs-plain", phase_train_packed_vs_plain)
    int4 = run("kernel-int4", phase_kernel_int4, device)
    dattn = run("kernel-dattn", phase_kernel_decode_attention, device)
    mlp = run("kernel-mlp", phase_kernel_mlp, device)
    decode = run("decode-slice", phase_decode_slice)
    fused = run("train-fused", phase_train_fused)
    run("diagnose-rf", phase_diagnose_rf, device)
    ibp = run("debias-ibp", phase_debias_ibp)
    run("debias-ibp-rf", phase_debias_ibp_rf)
    ckpt = run("checkpoint-qwen", phase_checkpoint_qwen, slice_probs, slice_report)
    llama = run("llama", phase_llama, device)
    serve = run("serve", phase_serve)
    long = run("long", phase_long, device)
    l8 = run("llama8b", phase_llama8b)
    ent = run("entry", phase_entry)
    bench = run("bench", phase_bench)["launches"]
    wid = run("widths", phase_widths, device)
    print(f"[walls] seconds a phase: {json.dumps(walls)}")
    print(f"[cosines] lowest LoRA gradient cosine of each phase's step gates (>= "
          f"{GRAD_COSINE}): {json.dumps(LOWEST_COSINE)}")
    wk, ws = wid["kernels"], wid["steps"]
    launches_widths = {key: sum(r["launches"][key] for r in ws.values())
                       + wid["int4_blind"]["launches"][key] + wid["pair"]["launches"][key]
                       for key in ("fwd", "dkv", "dq", "int4", "dattn")}
    sft, times = llama["sft"], llama["times"]
    long_shape = {key: {"shape": long["shape"], **long[key]} for key in ("fwd", "dkv", "dq")}
    ring_k1 = long["ring"]["K1"]["launches"]["full"]
    ring_preset = long["ring"]["K1_preset_call"]["launches"]["full"]
    records = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_fwd.cu",
         "replaces": "tst/kernels/flash_attention.py:99",
         "launches": counts["fwd"], "launches_eval_blind": blind_launches,
         "launches_debias_ibp": ibp["fwd"], "launches_checkpoint_qwen": ckpt["fwd"],
         "launches_llama_sft": sft["fwd"], "launches_llama_int4": llama["int4"]["fwd"],
         "launches_serve": serve["fwd"], "launches_long": long["launches"]["fwd"],
         "launches_llama8b_sft": l8["sft"]["launches"]["fwd"],
         "launches_llama8b_ibp": l8["ibp"]["launches"]["fwd"],
         "launches_llama8b_int4": l8["int4"]["launches"]["fwd"],
         "launches_entry": ent["launches"]["fwd"],
         "launches_dryrun": ent["dryrun"]["launches"]["fwd"], "launches_bench": bench["fwd"],
         "launches_widths": launches_widths["fwd"],
         "llama_shape": {"shape": times["shape"], **times["fwd"]},
         "long_shape": long_shape["fwd"],
         "widths_shapes": {key: r["fwd"] for key, r in wk["k1"].items()}, **kern, **bwd["fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:553",
         "launches": counts["dkv"], "launches_debias_ibp": ibp["dkv"],
         "launches_llama_sft": sft["dkv"], "launches_serve": serve["dkv"],
         "launches_long": long["launches"]["dkv"],
         "launches_llama8b_sft": l8["sft"]["launches"]["dkv"],
         "launches_llama8b_ibp": l8["ibp"]["launches"]["dkv"],
         "launches_dryrun": ent["dryrun"]["launches"]["dkv"], "launches_bench": bench["dkv"],
         "launches_widths": launches_widths["dkv"],
         "llama_shape": times["dkv"], "long_shape": long_shape["dkv"],
         "widths_shapes": {key: r["dkv"] for key, r in wk["k1"].items()}, **bwd["dkv"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:518",
         "launches": counts["dq"], "launches_debias_ibp": ibp["dq"],
         "launches_llama_sft": sft["dq"], "launches_serve": serve["dq"],
         "launches_long": long["launches"]["dq"],
         "launches_llama8b_sft": l8["sft"]["launches"]["dq"],
         "launches_llama8b_ibp": l8["ibp"]["launches"]["dq"],
         "launches_dryrun": ent["dryrun"]["launches"]["dq"], "launches_bench": bench["dq"],
         "launches_widths": launches_widths["dq"],
         "llama_shape": times["dq"], "long_shape": long_shape["dq"],
         "widths_shapes": {key: r["dq"] for key, r in wk["k1"].items()}, **bwd["dq"]},
        {"name": "flash_attention_fwd_seg", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_fwd.cu",
         "replaces": "tst/kernels/flash_attention.py:464",
         "launches": packed["fwd_seg"], "launches_dryrun": ent["dryrun"]["launches"]["fwd_seg"],
         "launches_bench": bench["fwd_seg"],
         "llama8b_packed_shape": seg["llama8b_packed"]["fwd"], **seg["fwd"]},
        {"name": "flash_attention_bwd_dkv_seg", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:650",
         "launches": packed["dkv_seg"], "launches_dryrun": ent["dryrun"]["launches"]["dkv_seg"],
         "launches_bench": bench["dkv_seg"],
         "llama8b_packed_shape": seg["llama8b_packed"]["dkv"], **seg["dkv"]},
        {"name": "flash_attention_bwd_dq_seg", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:650",
         "launches": packed["dq_seg"], "launches_dryrun": ent["dryrun"]["launches"]["dq_seg"],
         "launches_bench": bench["dq_seg"],
         "llama8b_packed_shape": seg["llama8b_packed"]["dq"], **seg["dq"]},
        {"name": "int4_matmul", "route": "cuda", "source": "tst_torch/csrc/int4_matmul.cu",
         "replaces": "tst/kernels/quant_matmul.py:64", "launches": decode["int4"],
         "launches_diagnose_sft": fused["int4"], "launches_llama_int4": llama["int4"]["int4"],
         "launches_serve": serve["int4"],
         "launches_llama8b_int4": l8["int4"]["launches"]["int4"], "launches_bench": bench["int4"],
         "launches_widths": launches_widths["int4"], "widths_shapes": wk["int4"], **int4},
        {"name": "fused_swiglu_mlp", "route": "cuda", "source": "tst_torch/csrc/fused_mlp.cu",
         "replaces": "tst/kernels/fused_mlp.py:44", "launches": fused["mlp"],
         "widths_shapes": wk["mlp"], **mlp},
        {"name": "decode_attention", "route": "cuda",
         "source": "tst_torch/csrc/decode_attention.cu",
         "replaces": "tst/models/decode.py:196 (jnp, no pallas_call)",
         "launches": decode["dattn"], "launches_diagnose_sft": fused["dattn"],
         "launches_debias_ibp": ibp["dattn"], "launches_llama_int4": llama["int4"]["dattn"],
         "launches_serve": serve["dattn"],
         "launches_llama8b_ibp": l8["ibp"]["launches"]["dattn"],
         "launches_llama8b_int4": l8["int4"]["launches"]["dattn"],
         "launches_dryrun": ent["dryrun"]["launches"]["dattn"], "launches_bench": bench["dattn"],
         "launches_widths": launches_widths["dattn"], "widths_shapes": wk["dattn"], **dattn},
    ]
    # the non-causal kernels: launches in phase 21's ring through K1 (the
    # S=16384 check, and at the preset's call)
    for key, name, line in (("fwd", "flash_attention_fwd_full", 121),
                            ("dkv", "flash_attention_bwd_dkv_full", 570),
                            ("dq", "flash_attention_bwd_dq_full", 536)):
        records.append({"name": name, "route": "cuda",
                        "source": ("tst_torch/csrc/flash_attention_fwd.cu" if key == "fwd" else
                                   "tst_torch/csrc/flash_attention_bwd.cu"),
                        "replaces": f"tst/kernels/flash_attention.py:{line} (causal=False)",
                        "launches": ring_k1[key], "launches_ring_preset_call": ring_preset[key],
                        "llama_shape": full["llama_shape"][key], **full["ring"][key]})
    print("[k1] ratio_to_library (kernel ms / library ms) and share_of_bound (bound ms / "
          "kernel ms) of each K1 kernel, and at each dQ the card's SM clock and power draw "
          "read just after its timing: " + json.dumps({
              "main": k1_summary(dict(zip(("fwd", "dkv", "dq"), records[:3]))),
              "segmented": k1_summary(dict(zip(("fwd", "dkv", "dq"), records[3:6]))),
              "non_causal_ring_block": k1_summary(full["ring"]),
              "non_causal_llama_shape": k1_summary(full["llama_shape"]),
              "llama_shape": k1_summary({key: r["llama_shape"]
                                         for key, r in zip(("fwd", "dkv", "dq"), records[:3])}),
              "long_shape": k1_summary(long_shape),
              "llama8b_packed_shape": k1_summary(seg["llama8b_packed"]),
              "widths": {key: k1_summary({n: r[n] for n in ("fwd", "dkv", "dq")})
                         for key, r in wk["k1"].items()}}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
