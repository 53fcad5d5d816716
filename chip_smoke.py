"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into the
git-ignored ``build/``, one ``nvcc`` per source, all at once), holds each
kernel against its plain PyTorch version on the card, drives the port's
main paths at full width with seeded random weights: requests served
through ``repro_torch.serve.engine.ServingEngine`` on smollm-135m and on
h2o-danube-3-4b (head_dim 120), the Coyote shell (``repro_torch.core``)
with its five apps and smollm-135m served from a vFPGA slot, training steps through
``repro_torch.train.loop.Trainer`` on smollm-135m, and dense-cache serving
(``prefill`` and ``decode_step`` of ``models/transformer.py``) of
mamba2-1.3b, live migration, in-place recovery, the serving gateway and
the fleet controller on smollm-135m, the dense attention cache of
h2o-danube-3-4b and smollm-135m, MoE serving of granite-moe-1b-a400m and
of llama4-scout-17b-a16e (depth cut to 4 layers), the zamba2-2.7b
hybrid, and whisper-medium's encoder-decoder, served and trained, the
training of mamba2-1.3b, zamba2-2.7b and granite-moe-1b-a400m (the SSD
backward kernel), and ``repro_torch.launch.serve``; checks
the card against the CPU on the reduced models, times the kernels and
profiles a decode step, a training step, a mamba prefill and a mamba
decode step.  Every profiler trace opens with PROFILE_PAD_KERNELS empty
spin kernels, which the tracer may drop, and drops them from its sums;
each is held to the count of a kernel it must contain and retaken up to
three times (``padded_trace``).  Phases, in order:

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel, print the build seconds and each kernel's
     registers, shared memory and spills;
  3. kernels vs plain versions on the card (fp32 and bf16): paged
     attention with and without the split of rows over several blocks
     (G 1-10, D 32-128 with 80 and 120, pages of 16-256, a ragged table,
     empty rows, rows ending on a tile or a split, the decode shapes of
     phases 4, 10, 11, 12 and 14); the flash-attention forward, dq and dkv
     kernels (bf16 on the tensor cores, float32 on FMA) on the
     reference's test cases, head dims 32, 64, 80, 120 and 128,
     h2o-danube's with and without its window, the training shape,
     phase 13's dense prefills, zamba2's shared block and whisper's
     shapes (the encoder's 1500 x 1500 and the cross-attention's 448 and
     32 x 1500, non-causal, the decoder's 448 causal, a small ragged one),
     and ``mha_fused``'s gradient against autograd of the plain forward,
     also at whisper's cross shape; the
     SSD scan (bf16 on the tensor cores, float32 on FMA) on the
     reference's cases, the reduced and the main mamba shapes, a ragged S,
     an initial state and zamba2's shape; the SSD backward (bf16 on the
     tensor cores, float32 on FMA) against ``ref.ssd_chunked_bwd`` on
     those cases (G > 1, ragged S, an initial state with a dfinal_state)
     and phase 17's mamba2 and zamba2 training shapes; paged prefill
     attention (bf16 on the tensor cores, float32 on FMA) at h2o-danube's
     chunk shape (rows at positions 0, 2048 and 7168, padded queries, a
     padding row, unmapped pages) and at phase 4's smollm chunk shape
     (9 / 3 heads of 64) against its plain version, bf16 within
     ``ref.bf16_prefill_bound`` elementwise;
  4. serving main path: 24 requests through the engine at full width, bf16,
     every paged-attention call on ``pa_decode_kernel``;
 10. h2o-danube serving: 8 requests of 256-1024 prompt tokens, 32 new
     tokens each, through the engine at full width in bf16 (head_dim 120 on
     the paged kernel built for 128), likewise;
 11. the shell: ``Shell`` with all five services and four vFPGA slots on
     the card (its build allocating nothing); the transfer engine's
     word-granular (64 MiB), chunked and whole (256 MiB) uploads, each
     downloaded and compared; slot 0 ``lm_serving`` at full-width
     smollm-135m, bf16 (phase 4's weights and MMU), serving two tenants
     weighted 3:1, 8 prompts of 64-512 tokens each, 32 new tokens, while
     slot 2 is hot-swapped (hll -> vector_add -> hll), with every paged
     call on ``pa_decode_kernel`` and the billed decode I/O equal to the
     engine's; slot 1 AES (ECB over 64 MiB, CBC with 1 and 64 streams of
     256 blocks, FIPS-197), slot 2 HLL (2^24 items, 2^20 distinct), slot
     3 the NN (262,144 x 593 rows, streamed and staged), each against the
     CPU; ``reconfigure_shell`` dropping the sniffer, ``cold_restart``;
     reduced smollm fp32 through the app on the card and the CPU;
 12. migration, recovery, gateway and fleet: two ``Shell``s (MMU page 16,
     2048 pages, a host pool) with one shell-bound engine each, phase 4's
     weights; groups of 8 requests (64-512 prompt tokens, 64 new, half
     sampled) moved after 16 decode steps by ``migrate`` (stop-and-copy)
     and ``migrate_precopy``, recovered in place by ``Shell.recover_slot``
     after the slot's heartbeat goes stale, and 4 healed by
     ``FleetController.sweep``; each group's streams equal to an unmoved
     control engine's, the destination's KV equal on the card to the
     source's, every decode on ``pa_decode_kernel``; downtime, bytes and
     pages shipped warm and in the freeze by mode; then a continuous
     ``ServingGateway`` with 32 open arrivals: exactly-once streams and
     typed refusals (GATEWAY_FULL, SLO_INFEASIBLE, SLO_EXPIRED);
 13. the dense attention cache: h2o-danube-3-4b fp32, decode after a
     4200-token prefill (past its 4096 window, the ring fill) against a
     4201-token prefill, atol 1e-3; smollm fp32 dense decode against the
     paged engine's logits under teacher forcing, atol 1e-3; bf16 prefill
     s and decode step ms (median, p90) of both models, and 8 more decode
     steps traced: device busy ms and idle share per step;
 14. MoE serving: granite-moe-1b-a400m at full width (32 experts top-8)
     through phase 4's ``main_engine`` with phase 4's traffic, and
     llama4-scout-17b-a16e at full width with its depth cut from 48 to 4
     layers (8 requests of 128-512 prompt tokens, 32 new), bf16, every
     paged call on ``pa_decode_kernel`` and no flash or SSD launch; the
     share of (token, expert) assignments dropped at one prefill call and
     one full decode step; one granite layer's ``moe_apply`` card vs CPU;
  5. training main path: 20 steps of ``Trainer`` at full width, sequence
     2048, batch 8, fp32 masters with bf16 compute, a checkpoint every 5
     steps and an injected failure at step 12 (one restart); its forward,
     dq and dkv launches all on the tensor-core kernels;
  9. mamba serving main path: 12 requests of full-width mamba2-1.3b, bf16
     (8 prompts of 2048 tokens, 4 of 1000), two ``prefill`` calls and 64
     greedy ``decode_step``s for each; then, with fp32 weights, decode
     after a 1000-token prefill against the prefill of 1001 tokens;
 15. the zamba2-2.7b hybrid at full width, bf16: 4 prompts of 2048 and 2
     of 1000 tokens in two ``prefill`` calls (45 SSD calls, all
     tensor-core, and 9 ``fa_fwd_wgmma_kernel`` launches each), 32 greedy
     ``decode_step``s each (no kernel of the port); fp32 decode after a
     1000-token prefill against the prefill of 1001 tokens;
 16. whisper-medium at full width, bf16 (seeded random weights and
     frames): 5 ``prefill`` calls of 8 rows x 32 tokens over 1500 frames
     (72 ``fa_fwd_wgmma_kernel`` launches each: 24 encoder, 24 self, 24
     cross; the cross KV cache (24, 8, 1500, 16, 64)), 64 greedy
     ``decode_step``s (no kernel of the port), a traced prefill and 16
     traced decode steps; fp32 decode after a 200-token prefill against
     the 201-token prefill; 10 ``Trainer`` steps at sequence 448, batch 8
     (forward, dq and dkv each 72 a step, all tensor-core), 3 traced, and
     3 with ``remat="full"`` (each decoder layer's forward again in the
     backward);
  6. card vs CPU on the reduced models, fp32: decode_step_paged of smollm
     and granite, 3 ``Trainer`` steps from the same weights (its forward,
     dq and dkv launches all on the float32 FMA kernels) of smollm, of
     whisper, and of smollm with ``remat`` "full", with "dots" and with
     int8 gradient compression, and of mamba2, zamba2 and granite (their
     SSD forward on the FMA kernel and its float32 FMA backward kernel
     once per mamba layer a step); mamba2, zamba2 and whisper prefill
     and 8 decode steps;
  7. kernel timing at the main paths' shapes (median, p10 and p90), with
     each kernel's bound and a PyTorch library call as yardstick where one
     computes the same function (for flash attention also SDPA's backward
     alone); for paged attention also the h2o-danube decode shape, the
     profiler's device time per call, the wrapper's host time per call and
     a sweep of the split length and the ring depth; the flash forward
     (with SDPA) and the SSD at zamba2's prefill shapes; the flash forward
     at whisper's encoder and cross shapes, dq and dkv at the cross shape
     (with SDPA's forward and backward); the SSD backward at phase 17's
     mamba2 and zamba2 training shapes, bf16 (the tensor-core kernels),
     and at mamba2's in float32 (the FMA kernel; no library call
     computes it); paged prefill attention (bf16) at one h2o-danube
     chunk at position 2048 and at a danube-longdoc chunk step, with its
     operations bound and the plain version's time (no library call
     walks a block table);
 17. every family trains on the card at full width (FAMILY_TRAIN):
     mamba2-1.3b, zamba2-2.7b with ``remat="full"`` and granite-moe-1b-
     a400m, sequence 2048, batch 4, bf16 compute over float32
     masters, FAMILY_STEPS steps: every loss finite, SSD forward launches
     = mamba layers x steps (twice under remat), all tensor-core, SSD
     backward = mamba layers x steps, all tensor-core, flash forward =
     attention layers x steps (twice under remat), dq and dkv =
     attention layers x steps, all wgmma, nothing else; step p50/p90
     ms, tokens/s, peak GB; one more mamba2 step in a padded trace held
     to each backward kernel's 48 launches by name (and 96 of the
     forward's kernels that it reuses);
 18. the serving launcher ``repro_torch.launch.serve.main([])`` on the
     card at its defaults: 16 requests, every one complete, paged
     launches = n_layers x decode steps, no other kernel;
 19. tensor parallel (``repro_torch.launch.mesh.run_ranks``: ranks on
     ``cuda:0`` over gloo, NCCL refusing two ranks on one device):
     full-width smollm-135m at TP 3 (3 query and 1 KV head a rank) and TP
     2 (heads replicated, the MLP split), fp32, phase 4's prompts cut to
     8: each rank's first decode logits against the single-process port
     on the card, greedy tokens identical under teacher forcing over 32
     steps, the engine's paged launches = 30 x decode steps at the local
     head count and 2 x 30 + 1 collectives a TP 3 decode step (30 + 1 at
     TP 2); bf16 TP 3 through the engine (launches, step wall: gloo
     staging through the host, not a TP speed); 8 ranks on a (pod 2,
     data 2, model 2) mesh: hierarchical vs flat all-reduce, context-
     parallel decode attention at smollm's head layout over a 4096-token
     cache vs the dense one, the pod 0 -> pod 1 KV hand-off; the count of
     collective operands copied through the host; at TP 2 a
     ``ServingGateway(admission="slo")`` in front of a fresh fp32 engine
     (8 arrivals in three waves, 16 new tokens each, one expired queued
     and one refused as infeasible): every rank's streams, refusals and
     dispatches equal rank 0's, the greedy streams the gateway-less
     engine's, paged launches = 30 x decode steps at the local heads,
     TTFT/TPOT p50 from arrival (gloo staging);
  8. profiles: where a steady decode step (every slot full), a training
     step, a mamba prefill call and a mamba decode step spend their time
     (host wall untraced and traced, device busy time, the device's idle
     share, launches, the kernels that take the most device time).

Each main path runs with every kernel's launch count set to 0 just before
it and read just after it; each phase's number is printed at the start of
its lines (phases 10-14 run after phase 4, phases 9, 15, 16, 17, 18 and
19 after phase 5).  Any failed phase ends the script with a
non-zero exit and no result line.  The line before the last is a JSON
object describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PA_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
PA_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:47"
PP_SOURCE = "src/repro_torch/csrc/paged_prefill.cu"
PP_REPLACES = ("none: plain jnp gather + einsum in "
               "src/repro/serve/paged_model.py, no pallas_call")
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
# the kernel each dtype runs, by the kernels line's name
VARIANTS = {
    "paged_attention": {
        "bfloat16": "pa_decode_kernel (16-byte cp.async ring, a lane group "
                    "per token, splits merged by the row's last block)",
        "float32": "pa_decode_kernel (the same template, 4 floats a lane)"},
    "paged_prefill": {
        "bfloat16": "pp_fwd_wgmma_kernel (wgmma, a TMA box per page)",
        "float32": "pp_fwd_kernel (float32 FMA)"},
    "flash_attention_fwd": {"bfloat16": "fa_fwd_wgmma_kernel (wgmma, TMA)",
                            "float32": "fa_fwd_kernel (float32 FMA)"},
    "flash_attention_dq": {"bfloat16": "fa_dq_wgmma_kernel (wgmma, TMA)",
                           "float32": "fa_dq_kernel (float32 FMA)"},
    "flash_attention_dkv": {"bfloat16": "fa_dkv_wgmma_kernel (wgmma, TMA)",
                            "float32": "fa_dkv_kernel (float32 FMA)"},
    "ssd": {"bfloat16": "ssd_cb_kernel, ssd_state_kernel, ssd_pass_kernel, "
                        "ssd_scan_kernel (wgmma; float32 operands as bf16 "
                        "hi + lo)",
            "float32": "ssd_kernel (float32 FMA)"},
    "ssd_bwd": {"bfloat16": "ssd_dstate_kernel, ssd_dpass_kernel, "
                            "ssd_bwd_key_kernel, ssd_bwd_query_kernel, "
                            "ssd_dcum_kernel (wgmma, chunk-parallel; the "
                            "decayed scores as bf16 hi + mid + lo, other "
                            "float32 operands hi + lo), after ssd.cu's "
                            "ssd_cb_kernel, ssd_state_kernel, "
                            "ssd_pass_kernel",
                "float32": "ssd_bwd_kernel (float32 FMA)"}}
# the bf16 backward's own kernels, each launched once a call
SSD_BWD_TC_NAMES = ("ssd_dstate_kernel", "ssd_dpass_kernel",
                    "ssd_bwd_key_kernel", "ssd_bwd_query_kernel",
                    "ssd_dcum_kernel")
# the forward's kernels that the bf16 backward launches again, once a call
SSD_REBUILD_NAMES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel")
# the paged-attention kernels by name, for the decode profile
PA_PROFILE_NAMES = sorted({n for v in VARIANTS["paged_attention"].values()
                           for n in re.findall(r"\w+_kernel", v)})
FA_REPLACES = {
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:36",
    "flash_attention_dq":
        "src/repro/kernels/flash_attention/flash_attention_bwd.py:48",
    "flash_attention_dkv":
        "src/repro/kernels/flash_attention/flash_attention_bwd.py:97"}
SSD_SOURCE = "src/repro_torch/csrc/ssd.cu"
SSD_REPLACES = "src/repro/kernels/ssd/ssd.py:34"
# (B, S, H, P, G, N, chunk): tests/test_kernels.py SSD_CASES, the reduced
# mamba2's shape, the main prefill shape and its ragged second batch
SSD_CASES = [(2, 128, 4, 64, 1, 32, 32), (1, 200, 8, 64, 2, 64, 64),
             (2, 256, 4, 32, 4, 16, 128), (2, 77, 8, 32, 1, 16, 32)]
SSD_MAIN = (8, 2048, 64, 64, 1, 128, 256)
SSD_RAGGED = (4, 1000, 64, 64, 1, 128, 256)
# phase 15: zamba2-2.7b at full width (9 cycles of 5 mamba slots and the
# shared attention block), bf16: 4 prompts of 2048 and 2 of 1000 tokens in
# two prefill calls, 32 greedy decode steps each; fp32 decode after the
# 1000-token prefill vs the 1001-token prefill (under the 4096 ring)
ZAMBA2_PROMPTS = ((4, 2048), (2, 1000))
ZAMBA2_DECODE_STEPS = 32
# its two prefill calls' SSD shapes: 80 SSD heads of 64, d_state 64
SSD_ZAMBA2, SSD_ZAMBA2_RAGGED = [(n, s, 80, 64, 1, 64, 256)
                                 for n, s in ZAMBA2_PROMPTS]
# SSD: atol 5e-4 (the reference's SSD tests) plus a relative term.  Both
# versions take the prefix sum cum of dt * A over a chunk in float32 in
# different orders; at L 256 |cum| reaches a few hundred, where float32
# keeps ~1e-5 absolute, so exp(cum_i - cum_j) and every y and state term
# differ by ~1e-4 of their value (rtol 2^-12).  y in bf16 is in addition
# one bf16 rounding (2^-9 of its value) from that float32 sum (rtol 2^-8).
# The bf16 tensor-core path splits each float32 operand into bf16 hi + lo
# (under 2^-16 of each term), which keeps these bounds
# (tests/test_torch_ssd.py emulates it; one bf16 rounding breaks them).
SSD_ATOL = 5e-4
SSD_RTOL = {torch.float32: 2.0 ** -12, torch.bfloat16: 2.0 ** -8}
# The SSD backward (no Pallas counterpart: the reference differentiates its
# jnp scan) against ``ref.ssd_chunked_bwd``.  dx and dinit are held as the
# forward's y and state: atol 5e-4 plus rtol 2^-12 (bf16 dx: 2^-8, one
# rounding of the float32 sum).  ddt, dA, dB and dC are sums whose terms
# cancel: ddt through the suffix sums of dcum, dA over batch and
# positions, dB and dC over the heads of a group (64 or 80 at full
# width).  Summed in float32 in another order they differ by a share of
# the terms' size, not of the result's: at the main path's ragged shape
# an element of dB of 0.05 moved by 7e-4, and there the float32 plain
# version itself is up to 1.8e-5 of each tensor's largest value from the
# same algorithm in float64.  So they are held normwise: atol 5e-4
# plus 2^-12 of the tensor's largest |value| (plus 2^-8 of each element
# for bf16 dB and dC, their one rounding).
SSD_BWD_SOURCE = "src/repro_torch/csrc/ssd_bwd.cu"
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
SSD_BWD_REPLACES = ("jax.grad of src/repro/models/ssm.py:104 (ssd_chunked); "
                    "no Pallas kernel")
# phase 17: every family trains on the card at full width: (arch, batch,
# remat), sequence FAMILY_SEQ, FAMILY_STEPS steps from seeded weights, bf16
# compute over float32 masters.  mamba2 and granite fit batch 4 without
# remat (peaks of 69.3 and 56.9 GB on the H100 in this script); zamba2
# (2.06 B parameters, ~33 GB of masters, gradients and AdamW) takes remat
# "full" at batch 4 (44.6 GB; without remat batch 2 alone peaked at 62.8
# GB).  remat "full" recomputes each hybrid cycle's body in the
# backward, so its forward kernels launch twice a step and its backward
# kernels once
FAMILY_TRAIN = (("mamba2-1.3b", 4, "none"), ("zamba2-2.7b", 4, "full"),
                ("granite-moe-1b-a400m", 4, "none"))
FAMILY_SEQ, FAMILY_STEPS = 2048, 5
# the SSD shapes of phase 17's mamba2 and zamba2 steps (phase 3 and 7)
SSD_TRAIN_MAMBA2 = (FAMILY_TRAIN[0][1], FAMILY_SEQ, 64, 64, 1, 128, 256)
SSD_TRAIN_ZAMBA2 = (FAMILY_TRAIN[1][1], FAMILY_SEQ, 80, 64, 1, 64, 256)
MAMBA_PROMPTS = ((8, 2048), (4, 1000))    # (requests, prompt tokens)
MAMBA_DECODE_STEPS = 64
# decode after prefill vs prefill of one more token, full width, fp32:
# the kernel's chunked scan against the plain recurrence over 48 layers
MAMBA_CONSISTENCY_ATOL = 1e-3
MAMBA_PROFILE_STEPS = 16
# H100 SXM data sheet (NVIDIA), dense rates: HBM3 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s (the
# float32 flash kernels compute float32 FMA: a float32 input held to atol
# 2e-5 cannot go through TF32)
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 500_000        # phase 7: the card's wait for the host's call
PROFILE_PAD_KERNELS = 4000  # phases 7-8: events a trace may drop at its start
PAD_KERNEL = "spin_kernel"  # the kernel of torch.cuda._sleep: the pad
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash-attention gradients: float32 atol 5e-4 (the reference's backward
# tests).  bf16, against the float32 plain version on the same bf16
# values: dq within ``ref.bf16_dq_bound`` and dk, dv within
# ``ref.bf16_dkv_bound``, the elementwise bounds implied by the tensor-core
# kernels' rounding of dS (dq) and of P and dS (dkv) to bf16 before their
# last products (derived beside them)
GRAD_ATOL = 5e-4
# (B, H, K, Sq, Sk, D, causal, window): tests/test_kernels.py FA_CASES and
# BWD_CASES, and the training path's shape
FA_CASES = [(2, 4, 2, 256, 256, 64, True, 0),
            (1, 8, 8, 128, 384, 128, True, 0),
            (2, 4, 1, 200, 200, 64, True, 0),
            (1, 4, 2, 256, 256, 64, True, 128),
            (1, 2, 2, 128, 256, 64, False, 0),
            (1, 4, 2, 128, 128, 64, True, 0),
            (2, 4, 2, 77, 77, 32, True, 0),         # D 32: the reduced model
            (2, 4, 2, 200, 200, 80, True, 0),       # D 80: zamba2's block
            (1, 4, 1, 130, 130, 120, True, 64),     # D 120, window
            (2, 32, 8, 2048, 2048, 120, True, 0),   # h2o-danube-3-4b
            (1, 32, 8, 4200, 4200, 120, True, 4096),  # its window, phase 13
            (4, 9, 3, 300, 300, 64, True, 0),       # phase 13: smollm fp32
            (8, 9, 3, 512, 512, 64, True, 0),       # phase 13: smollm bf16
            (8, 3, 1, 2048, 2048, 64, True, 0),     # phase 20: TP 3 bf16
            (8, 3, 1, 512, 512, 64, True, 0),       # phase 20: TP 3 fp32
            (4, 9, 3, 2048, 2048, 64, True, 0)]     # phase 20: a data rank
# phase 15: zamba2's shared block in its two prefill calls
ZAMBA2_FA, ZAMBA2_FA_RAGGED = [(n, 32, 32, s, s, 80, True, 0)
                               for n, s in ZAMBA2_PROMPTS]
FA_CASES += [ZAMBA2_FA, ZAMBA2_FA_RAGGED]
BWD_CASES = [(1, 4, 2, 128, 128, 64, True, 0),
             (2, 2, 1, 96, 160, 64, True, 0),
             (1, 4, 4, 128, 128, 64, False, 0),
             (1, 2, 2, 128, 128, 64, True, 64),
             (1, 2, 1, 100, 100, 128, True, 0),     # D 128
             (2, 4, 2, 77, 77, 32, True, 0),        # D 32
             (2, 4, 2, 200, 200, 80, True, 0),      # D 80
             (1, 4, 1, 130, 130, 120, True, 64),    # D 120, window
             (2, 32, 8, 2048, 2048, 120, True, 0),  # h2o-danube-3-4b
             (2, 4, 2, 37, 203, 64, False, 0),    # small, ragged, Sq != Sk
             (8, 3, 1, 2048, 2048, 64, True, 0),  # phase 20: TP 3 bf16
             (8, 3, 1, 512, 512, 64, True, 0),    # phase 20: TP 3 fp32
             (4, 9, 3, 2048, 2048, 64, True, 0),  # phase 20: a data rank
             (2, 9, 3, 2048, 2048, 64, True, 0)]  # phase 20: a microbatch
FA_MAIN = (8, 9, 3, 2048, 2048, 64, True, 0)
TRAIN_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 20, 12, 5
TRAIN_PROFILE_STEPS = 5
# (B, H, K, D, page, maxp, n_pages) from tests/test_kernels.py PA_CASES
PA_CASES = [(2, 8, 2, 64, 128, 4, 16), (3, 4, 4, 128, 64, 6, 32),
            (1, 16, 8, 64, 256, 3, 8),
            (2, 8, 2, 80, 16, 9, 40),        # D 80: zamba2's shared block
            (8, 32, 8, 120, 16, 64, 600)]    # D 120: h2o-danube-3-4b
MAIN_SHAPE = (16, 9, 3, 64, 16, 64, 2048)
# phase 7: h2o-danube-3-4b's decode (phase 10's engine: 8 rows, maxp 66 for
# max_len 1056), rows of 256-1056 tokens
H2O_SHAPE = (8, 32, 8, 120, 16, 66, 1024)
# paged prefill at h2o-danube-3-4b's chunk shape (32 / 8 heads of 120,
# page 16, 512 pages a row for max_len 8192, chunks of 512 queries), each
# live row's table mapped to ``prompt_end``.  Phase 3: rows at positions
# 0, 2048 (300 real queries) and 7168, a padding row, and an unmapped page
# in each of the first two rows (row 0's first, so its first queries see no
# key).  Phase 3 also checks phase 4's smollm chunk shape (9 / 3 heads of
# 64, page 16, 64 pages a row for max_len 1024, chunks of 256): rows at 0,
# 256 (100 real queries) and 768, a padding row, row 0's first page and
# one of row 1's unmapped.  Phase 7: one row's chunk at position 2048, and
# a chunk step of the danube-longdoc cell (3 rows at 1024, 2048 and 3584,
# a padding row).
PP_DANUBE = dict(t=512, h=32, kh=8, d=120, page=16, maxp=512, n_pages=1100)
PP_CHECK = {
    "danube": dict(PP_DANUBE, q_starts=(0, 2048, 7168, 0),
                   q_lens=(512, 300, 512, 0),
                   prompt_end=(1500, 3000, 8192, 0),
                   unmapped=((0, 0), (1, 100))),
    "smollm": dict(t=256, h=9, kh=3, d=64, page=16, maxp=64, n_pages=2048,
                   q_starts=(0, 256, 768, 0), q_lens=(256, 100, 256, 0),
                   prompt_end=(300, 700, 1024, 0),
                   unmapped=((0, 0), (1, 5)))}
PP_TIMING = {
    "row": dict(PP_DANUBE, q_starts=(2048,), q_lens=(512,),
                prompt_end=(4096,), unmapped=()),
    "step": dict(PP_DANUBE, q_starts=(1024, 2048, 3584, 0),
                 q_lens=(512, 512, 512, 0), prompt_end=(4096, 4096, 6144, 0),
                 unmapped=())}
# phase 7's sweep of the paged kernel's split and ring depth (both shapes)
PA_SWEEP_PAGES = (2, 4, 8, 16, 32, 64)
PA_SWEEP_STAGES = (1, 2, 3, 4, 6)
PROFILE_STEPS = 32
# phase 10: full-width h2o-danube-3-4b (head_dim 120) through the engine
H2O_REQUESTS, H2O_PROMPT, H2O_NEW_TOKENS = 8, (256, 1024), 32
# phase 11: the shell on the card.  Slot 0 serves two tenants (3:1) of
# SHELL_REQUESTS prompts each; AES over 64 MiB (ECB) and 64 streams of 256
# blocks (CBC); HLL over 2^24 items of 2^20 distinct values; the NN on
# 262,144 rows of 593 features
SHELL_REQUESTS, SHELL_PROMPT, SHELL_NEW_TOKENS = 8, (64, 512), 32
AES_ECB_BYTES, AES_PREFIX_BYTES = 64 << 20, 1 << 20
AES_CBC_STREAMS, AES_CBC_BLOCKS = 64, 256
HLL_ITEMS, HLL_DISTINCT, HLL_PREFIX = 1 << 24, 1 << 20, 1 << 20
NN_ROWS, NN_BATCH = 262_144, 1024
SHELL_BATCH = 4
SHELL_LEN = SHELL_PROMPT[1] + SHELL_NEW_TOKENS
SHELL_SHAPE = (SHELL_BATCH, 9, 3, 64, 16, -(-SHELL_LEN // 16), 2048)
# phase 12: migration, recovery, gateway and fleet at full smollm width.
# Two shells (MMU page 16, 2048 pages, 512 host pages), one shell-bound
# engine each (8 slots); each group of MIG_REQUESTS requests decodes
# MIG_STEPS steps before its move; the gateway takes GW_ARRIVALS open
# arrivals of GW_NEW_TOKENS tokens
MIG_MMU = dict(page_size=16, n_pages=2048, host_pool_pages=512)
MIG_REQUESTS, MIG_PROMPT, MIG_NEW_TOKENS, MIG_STEPS = 8, (64, 512), 64, 16
MIG_BATCH, MIG_LEN = 8, MIG_PROMPT[1] + MIG_NEW_TOKENS
MIG_SHAPE = (MIG_BATCH, 9, 3, 64, MIG_MMU["page_size"],
             -(-MIG_LEN // MIG_MMU["page_size"]), MIG_MMU["n_pages"])
GW_ARRIVALS, GW_NEW_TOKENS, GW_MAX_QUEUE = 32, 32, 4
# phase 13: the dense attention cache.  h2o-danube-3-4b past its 4096
# window (fp32 consistency, bf16 timing); smollm-135m dense vs paged
DENSE_H2O_PROMPT, DENSE_ATOL, DENSE_DECODE_STEPS = 4200, 1e-3, 32
DENSE_PREFILL_REPS, DENSE_TRACE_STEPS = 3, 8
DENSE_SMOLLM = (4, 300, 16)          # rows, prompt, teacher-forced steps
DENSE_SMOLLM_BF16 = (8, 512)         # rows, prompt (bf16 timing)
# phase 14: MoE serving.  granite-moe-1b-a400m at full width through
# ``main_engine`` with phase 4's traffic; llama4-scout-17b-a16e at full
# width with its depth cut from 48 to LLAMA4_LAYERS layers (the 48 layers
# are ~108 B parameters, ~217 GB in bf16: one 80 GB card holds 4 of them,
# ~17.6 GB, beside the 4.1 GB of untied embeddings), LLAMA4_REQUESTS
# requests of 128-512 prompt tokens, 32 new, on its own engine (page 16,
# 1024 pages); one granite layer's ``moe_apply`` card vs CPU on x (8,
# 512, 1024)
LLAMA4_LAYERS, LLAMA4_REQUESTS = 4, 8
LLAMA4_PROMPT, LLAMA4_NEW_TOKENS = (128, 512), 32
LLAMA4_LEN = LLAMA4_PROMPT[1] + LLAMA4_NEW_TOKENS
MOE_LAYER_X = (8, 512, 1024)
MOE_TIE = 1e-5          # k-th and (k+1)-th probabilities this close: a tie
# phase 3: paged decode at phase 14's shapes (granite through main_engine,
# 16 rows, maxp 64; llama4, 8 rows, maxp 34)
GRANITE_SHAPE = (16, 16, 8, 64, 16, 64, 2048)
# phase 16: whisper-medium at full width (24 encoder and 24 decoder layers,
# d 1024, 16 heads of 64, 1500 frames, vocab 51865; ~0.76 B parameters,
# 1.5 GB in bf16, cross KV 1.2 GB at 8 rows; training's float32 masters,
# gradients and AdamW ~12 GB plus activations: one card, no depth cut).
# Serving: WHISPER_PREFILL_REPS prefills of 8 rows x 32 prompt tokens
# (max_len 448, the decoder's context), 64 greedy decode steps, a traced
# prefill and 16 traced decode steps; fp32 decode after a 200-token
# prefill against the 201-token prefill.  Training: sequence 448, batch
# 8, WHISPER_TRAIN_STEPS steps, 3 traced, 3 with remat="full"
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_MAX_LEN = 8, 32, 448
WHISPER_PREFILL_REPS, WHISPER_DECODE_STEPS, WHISPER_TRACE_STEPS = 5, 64, 16
WHISPER_CONSISTENCY_PROMPT = 200
WHISPER_TRAIN = (8, 448)                  # batch, sequence
WHISPER_TRAIN_STEPS, WHISPER_PROFILE_STEPS, WHISPER_REMAT_STEPS = 10, 3, 3
LLAMA4_SHAPE = (LLAMA4_REQUESTS, 40, 8, 128, 16, -(-LLAMA4_LEN // 16), 1024)
# whisper's flash shapes (16 heads of 64, MHA, 1500 encoder frames), every
# one that phase 16 gives the kernels, ragged against the 128-row tiles:
# the encoder's self-attention; training's decoder self-attention (448,
# causal) and cross-attention (448 against 1500), forward and backward;
# the serving prefill's self (32, causal) and cross (32 against 1500)
# attention; and the fp32 consistency check's prefills of 200 and 201
# tokens, self and cross (batch 2)
WHISPER_FRAMES = 1500
WHISPER_ENC_FA = (WHISPER_ROWS, 16, 16, WHISPER_FRAMES, WHISPER_FRAMES, 64,
                  False, 0)
WHISPER_CROSS_FA = (WHISPER_TRAIN[0], 16, 16, WHISPER_TRAIN[1],
                    WHISPER_FRAMES, 64, False, 0)
WHISPER_SELF_FA = (WHISPER_TRAIN[0], 16, 16, WHISPER_TRAIN[1],
                   WHISPER_TRAIN[1], 64, True, 0)
FA_CASES += [WHISPER_ENC_FA, WHISPER_CROSS_FA, WHISPER_SELF_FA,
             (WHISPER_ROWS, 16, 16, WHISPER_PROMPT, WHISPER_FRAMES, 64,
              False, 0),
             (WHISPER_ROWS, 16, 16, WHISPER_PROMPT, WHISPER_PROMPT, 64,
              True, 0),
             (2, 4, 2, 37, 203, 64, False, 0)]
FA_CASES += [(2, 16, 16, n, k, 64, k == n, 0)
             for n in (WHISPER_CONSISTENCY_PROMPT,
                       WHISPER_CONSISTENCY_PROMPT + 1)
             for k in (n, WHISPER_FRAMES)]
BWD_CASES += [WHISPER_CROSS_FA, WHISPER_SELF_FA, WHISPER_ENC_FA]

# phase 19: tensor parallel.  Several ranks share the one card (cuda:0)
# over gloo with CUDA tensors: NCCL refuses two ranks on one device.  So every time here is gloo staging
# each collective through the host on one card, not a TP speed.  Full-width
# smollm-135m (9 query / 3 KV heads of 64, d_ff 1536) at TP 3 (3 query and
# 1 KV head a rank, d_ff 512: both parts shard) and TP 2 (3 % 2 != 0: the
# heads replicate, d_ff 768 shards), fp32, the same seeded weights on every
# rank and in the parent; phase 4's prompts cut to TP_REQUESTS, greedy,
# TP_STEPS new tokens.  First decode logits against the single-process
# port on the card at atol TP_LOGITS_ATOL (fp32; the partial sums meet in
# another order, as phase 13's dense-vs-paged check); tokens identical
# under teacher forcing.  Then bf16 TP 3 on the same traffic for the
# launch counts, the step wall and the collectives a decode step (2 x 30
# all-reduces and one token broadcast).  Then 8 ranks on a (pod 2, data
# 2, model 2) mesh: the hierarchical all-reduce against the flat one at
# atol 1e-5, context-parallel decode attention at smollm's head layout
# over a 4096-token cache (TP_CP) against the dense one at atol 1e-4 (fp32),
# and the pod 0 -> pod 1 KV hand-off, exact.  The fp32 TP 2 ranks also
# put a ``ServingGateway(admission="slo")`` in front of a fresh TP 2
# engine (its backfill decided on model-rank 0, replayed on rank 1): the
# same TP_REQUESTS prompts arrive in three waves, TP_GW_NEW new tokens
# each; the first arrival's deadline passes before its first step
# (SLO_EXPIRED), the one arriving after the first step asks for a
# deadline no service can meet (SLO_INFEASIBLE from the warm EWMAs), and
# the rest of the first wave asks for TP_GW_LOOSE_S.  After the first
# wave's submits rank 1's gateway clock reads TP_GW_AHEAD_S ahead, past
# those deadlines, so rank 1 expires nothing only if it replays rank 0's
# decisions.  Each rank's streams, refusals and dispatches equal rank
# 0's, and its greedy streams the gateway-less TP engine's first
# TP_GW_NEW tokens.
TP_REQUESTS, TP_STEPS, TP_LOGITS_ATOL, TP_SEED = 8, 32, 1e-3, 19
TP_GW_NEW, TP_GW_WAVES, TP_GW_TIGHT_S = 16, {0: [0, 1, 2, 3], 1: [4],
                                             2: [5, 6, 7]}, 1e-6
TP_GW_LOOSE_S, TP_GW_AHEAD_S = 60.0, 100.0
TP_MMU = dict(page_size=16, n_pages=512)
TP_TIMEOUT_S, TP_DEADLINE_S = 60, 240
TP_CP = (4, 9, 3, 64, 4096)                # batch, H, K, head dim, sequence
TP3_SHAPE = (TP_REQUESTS, 3, 1, 64, 16, 64, TP_MMU["n_pages"])
TP2_SHAPE = (TP_REQUESTS, 9, 3, 64, 16, 64, TP_MMU["n_pages"])

# phase 20: the mesh-bound launchers.  ``Trainer(mesh=...)`` on full-width
# smollm-135m, ranks on cuda:0 over gloo as in phase 19 (every time is
# gloo staging through the host on one card, not a TP or DP speed): a
# (data 2, model 1) mesh, a (1, 3) mesh (3 query / 1 KV heads and d_ff 512
# a rank, the flash kernels at the local heads) and (2, 1) with 2
# microbatches; MESH_STEPS bf16 steps at MESH_SEQ x MESH_BATCH (fp32
# masters), losses within MESH_BF16_ATOL of the single-process Trainer's
# on the same card and seed, then MESH_STEPS fp32 steps at MESH_FP32_SEQ x
# MESH_BATCH: losses within 1e-4, every rank's parameter shards within 2
# x the summed learning rates + 1e-6 of the single-process run's (phase
# 6's rule), and the norm of their difference within MESH_PARAM_RTOL of
# the norm of that run's own update (p_end - p_start) on the same
# elements: one AdamW step moves an element by about lr whatever its
# gradient, so the first rule alone misses a wrong gradient.  Each rank's activations at 2048 x 8 are ~5.2 GB a row whole
# (phase 5's 44.3 GB peak over 8 rows), ~42% of that at TP 3's local
# heads and d_ff: ~21 GB a rank at (2, 1), ~19 GB at (1, 3), three ranks
# ~57 GB of the 80.  Then context-parallel decode: the prefill and decode
# bundles (``context_parallel=True``) on a (1, 4) mesh, fp32, MESH_CP_ROWS
# prompts of MESH_CP_PROMPT tokens and MESH_CP_STEPS teacher-forced
# steps, logits within 1e-4 of the single-process ``decode_step``.
MESH_SEQ, MESH_BATCH, MESH_STEPS, MESH_SEED = 2048, 8, 3, 20
MESH_FP32_SEQ = 512
MESH_BF16_ATOL, MESH_FP32_ATOL, MESH_PARAM_RTOL = 2e-2, 1e-4, 1e-2
MESH_TRAIN = [("2x1", 2, 1, 1), ("1x3", 1, 3, 1), ("2x1_mb2", 2, 1, 2)]
MESH_CP_ROWS, MESH_CP_PROMPT, MESH_CP_STEPS, MESH_CP_WORLD = 4, 1024, 32, 4
MESH_TIMEOUT_S, MESH_DEADLINE_S = 120, 300

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def pa_inputs(shape, lens, dtype, gen, tables=None):
    """Random q and pools on the card; random distinct pages per row."""
    b, h, kh, d, page, maxp, n_pages = shape
    dev = gen.device
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, page, kh, d, generator=gen, device=dev)
    vp = torch.randn(n_pages, page, kh, d, generator=gen, device=dev)
    lens = torch.tensor(lens, dtype=torch.int32)
    if tables is None:
        tables = torch.full((b, maxp), -1, dtype=torch.int32)
        pick = torch.Generator().manual_seed(b * 1000 + n_pages)
        for i in range(b):
            need = -(-int(lens[i]) // page)
            tables[i, :need] = torch.randperm(n_pages, generator=pick)[:need]
    return (q, kp.to(dtype), vp.to(dtype), tables.to(dev), lens.to(dev))


def main_lens(b, page, maxp):
    rs = np.random.RandomState(7)
    return [int(x) for x in rs.randint(0, page * maxp + 1, size=b)]


def phase_kernels(pa, ref, gen):
    """Kernel vs plain version; returns the main shape's bf16 error."""
    cases = []
    for i, shape in enumerate(PA_CASES):
        b, page, maxp = shape[0], shape[4], shape[5]
        lens = [min((j + 1) * (page + 7), page * maxp) for j in range(b)]
        cases.append((f"pa{i}", shape, lens, None))
    ragged = torch.full((3, 7), -1, dtype=torch.int32)
    ragged[1, :2] = torch.tensor([5, 9])
    ragged[2, :7] = torch.tensor([1, 2, 3, -1, 4, 6, 7])
    cases.append(("ragged", (3, 4, 2, 64, 16, 7, 32), [0, 32, 100], ragged))
    # G 8 at D 128 (qwen2, chameleon); G 10 (two blocks of heads)
    cases.append(("g8", (2, 16, 2, 128, 16, 20, 64), [300, 77], None))
    cases.append(("g10", (2, 20, 2, 64, 16, 12, 32), [190, 0], None))
    # rows ending on a tile (32 tokens), on a split (8 pages) and on two
    cases.append(("edges", (4, 9, 3, 64, 16, 24, 128), [32, 128, 256, 0],
                  None))
    # enough blocks to fill the card without splitting rows: one pass
    cases.append(("wide", (192, 9, 3, 64, 16, 8, 2048),
                  main_lens(192, 16, 8), None))
    cases.append(("main", MAIN_SHAPE, main_lens(16, 16, 64), None))
    # phase 11's slot-0 engine (4 rows, maxp 34 for max_len 544): one live
    # row at the longest and at a mid-range length, three rows empty
    cases.append(("shell", SHELL_SHAPE, [SHELL_LEN, 0, 0, 0], None))
    cases.append(("shell2", SHELL_SHAPE, [0, 0, 301, 0], None))
    cases.append(("h2o", H2O_SHAPE, h2o_lens(), None))
    # phase 12's engines (8 rows, maxp 36 for max_len 576): rows from empty
    # to the longest, as the groups and the gateway leave them
    cases.append(("mig", MIG_SHAPE, [MIG_LEN, 64, 0, 301, 512, 0, 97,
                                     MIG_LEN - 1], None))
    # phase 19's TP engines (8 rows, maxp 64, 512 pages): TP 3's head
    # slice of 3 query heads and 1 KV head, TP 2's replicated heads
    cases.append(("tp3", TP3_SHAPE, main_lens(8, 16, 64), None))
    cases.append(("tp2", TP2_SHAPE, main_lens(8, 16, 64), None))
    # phase 14's engines: granite (G 2, D 64) and llama4 (G 5, D 128)
    cases.append(("granite", GRANITE_SHAPE, main_lens(16, 16, 64), None))
    cases.append(("llama4", LLAMA4_SHAPE, [int(x) for x in np.random
                  .RandomState(12).randint(128, LLAMA4_LEN + 1,
                                           size=LLAMA4_SHAPE[0])], None))
    main_err = None
    for name, shape, lens, tables in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tab, ln = pa_inputs(shape, lens, dtype, gen, tables)
            out = pa.paged_attention(q, kp, vp, tab, ln)
            want = ref(q.float(), kp.float(), vp.float(), tab, ln)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name} non-finite")
            check(all(bool((out[i] == 0).all())
                      for i, n in enumerate(lens) if n == 0),
                  f"{name}: an empty row is not exactly 0")
            err = float((out.float() - want).abs().max())
            tol = ATOL[dtype]
            pps = pa.plan(shape[0], shape[1], shape[2], shape[5], shape[4],
                          _sms())
            print(f"[3] {name:6s} {str(dtype):14s} G={shape[1] // shape[2]}"
                  f" D={shape[3]} page={shape[4]} pages_per_split={pps} "
                  f"splits={-(-shape[5] // pps):2d} max_abs_err={err:.3e} "
                  f"atol={tol:g}")
            check(err <= tol, f"kernel vs plain {name} {dtype}: {err}")
            if name == "main" and dtype == torch.bfloat16:
                main_err = err
    return main_err


def pp_inputs(spec, dtype, gen):
    """q, one layer's pools, tables, q_starts and q_lens of a paged prefill
    spec on the card: each live row's table maps random distinct pages up
    to its ``prompt_end``, then its ``unmapped`` entries are -1."""
    n, dev = len(spec["q_starts"]), gen.device
    page, maxp, n_pages = spec["page"], spec["maxp"], spec["n_pages"]
    tables = torch.full((n, maxp), -1, dtype=torch.int32)
    pick = torch.Generator().manual_seed(n * 1000 + n_pages)
    for i, end in enumerate(spec["prompt_end"]):
        need = -(-end // page)
        tables[i, :need] = torch.randperm(n_pages, generator=pick)[:need]
    for i, p in spec["unmapped"]:
        tables[i, p] = -1
    q = torch.randn(n, spec["t"], spec["h"], spec["d"], generator=gen,
                    device=dev)
    kv = [torch.randn(n_pages, page, spec["kh"], spec["d"], generator=gen,
                      device=dev) for _ in range(2)]
    i32 = dict(dtype=torch.int32, device=dev)
    return (q.to(dtype), kv[0].to(dtype), kv[1].to(dtype), tables.to(dev),
            torch.tensor(spec["q_starts"], **i32),
            torch.tensor(spec["q_lens"], **i32))


def pp_visible_pairs(spec, tables) -> int:
    """(query, key) pairs of one query head that the mask leaves visible:
    key j < q_start + q_len, j <= q_start + t, on a mapped page."""
    tab = tables.cpu().numpy()
    page, total = spec["page"], 0
    for i, (q0, ql) in enumerate(zip(spec["q_starts"], spec["q_lens"])):
        ok = np.repeat(tab[i] >= 0, page)[:q0 + ql]
        seen = np.cumsum(ok)
        last = np.minimum(q0 + np.arange(spec["t"]), q0 + ql - 1)
        total += int(seen[last].sum()) if q0 + ql > 0 else 0
    return total


def pp_plain(q, kp, vp, tables, q_starts, q_lens, bound=False):
    """The plain version in float32, or with ``bound`` the bf16 kernel's
    elementwise tolerance around it (``ref.bf16_prefill_bound``), a row at
    a time (one danube row's scores are 0.5 GB)."""
    from repro_torch.kernels.paged_attention.ref import (bf16_prefill_bound,
                                                         paged_prefill_ref)
    rows = []
    for i in range(q.shape[0]):
        row = (q[i:i + 1], kp, vp, tables[i:i + 1], q_starts[i:i + 1],
               q_lens[i:i + 1])
        want = paged_prefill_ref(row[0].float(), kp.float(), vp.float(),
                                 *row[3:])
        rows.append(bf16_prefill_bound(*row, want) if bound else want)
    return torch.cat(rows)


def phase_prefill_kernels(gen):
    """The paged prefill kernel against its plain version at each PP_CHECK
    shape, both dtypes: float32 within ATOL, bf16 within
    ``ref.bf16_prefill_bound`` elementwise; a padding row and queries with
    no visible key exactly 0.  Returns the bf16 errors by shape."""
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    err16 = {}
    for name, spec in PP_CHECK.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = pp_inputs(spec, dtype, gen)
            out = pp.paged_prefill(*args)
            want = pp_plain(*args)
            tol = (pp_plain(*args, bound=True) if dtype == torch.bfloat16
                   else torch.full_like(want, ATOL[dtype]))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"paged prefill {name} non-finite")
            check(bool((out[-1] == 0).all()), f"paged prefill {name}: the "
                  "padding row is not exactly 0")
            check(bool((out[0, :spec["page"]] == 0).all()),
                  f"paged prefill {name}: queries with no visible key are "
                  "not exactly 0")
            diff = (out.float() - want).abs()
            err, over = float(diff.max()), float((diff / tol).max())
            tol_is = (f"atol {ATOL[dtype]:g}" if dtype == torch.float32
                      else "bf16_prefill_bound")
            print(f"[3] paged_prefill {name} {str(dtype):14s} "
                  f"N={len(spec['q_starts'])} T={spec['t']} H={spec['h']} "
                  f"K={spec['kh']} D={spec['d']} page={spec['page']} "
                  f"maxp={spec['maxp']} q_starts={spec['q_starts']} "
                  f"q_lens={spec['q_lens']} max_abs_err={err:.3e} "
                  f"max_err_over_tol={over:.3f} ({tol_is})")
            check(over <= 1, f"paged prefill {name} vs plain {dtype}: "
                  f"{over:.3f} x its tolerance")
            if dtype == torch.bfloat16:
                err16[name] = err
            del args, out, want, tol, diff
    return err16


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def h2o_lens():
    """Phase 7's h2o-danube rows: 256-1056 tokens, seeded."""
    rs = np.random.RandomState(11)
    return [int(x) for x in rs.randint(256, 1057, size=H2O_SHAPE[0])]


def main_engine(cfg, params):
    """The main path's MMU and engine: page 16, 2048 pages (0.75 GB of bf16
    KV pools), 16 slots, max_len 1024, prefill chunks of 256."""
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.serve.engine import ServingEngine
    mmu = MMU(MMUConfig(page_size=16, n_pages=2048))
    return mmu, ServingEngine(cfg, params, mmu, max_batch=16, max_len=1024,
                              prefill_chunk=256, device="cuda")


def main_requests(cfg):
    """Phase 4's traffic: 24 (prompt, sampling mode) pairs, prompts of
    64-768 tokens, a third sharing a 128-token prefix, half sampled."""
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, cfg.vocab_size, size=128).tolist()
    reqs = []
    for i in range(24):
        plen = int(rs.randint(64, 769))
        body = rs.randint(0, cfg.vocab_size, size=plen).tolist()
        if i % 3 == 0:     # shares the prefix; short enough for one shot
            prompt = prefix + body[:int(rs.randint(32, 129))]
        else:
            prompt = body
        mode = ({}, {}, {"temperature": 0.8},
                {"temperature": 0.8, "top_k": 40, "top_p": 0.9})[i % 4]
        reqs.append((prompt, mode))
    return reqs


def prefill_launches_wanted(eng, obs0=0):
    """The paged prefill kernels' launches, as ``_launch_counts`` keys them,
    of ``eng``'s prefill calls since it had made ``obs0`` (its
    ``prefill_obs``, one a chunk or batch call): one a layer, on the
    kernel its pools' dtype picks."""
    n = eng.cfg.n_layers * (eng.prefill_obs - obs0)
    tc = eng.pools["k"].dtype == torch.bfloat16
    return {"paged_prefill_wgmma": n if tc else 0,
            "paged_prefill_fma": 0 if tc else n}


def check_prefill_launches(eng, what, obs0=0):
    """``eng``'s prefill calls since ``obs0`` launched the paged prefill
    kernel of its pools' dtype once per layer, and nothing else launched
    it since the counts were zeroed.  Returns the launches."""
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    want = prefill_launches_wanted(eng, obs0)
    got = {"paged_prefill_wgmma": pp.WGMMA_LAUNCHES,
           "paged_prefill_fma": pp.FMA_LAUNCHES}
    check(got == want and pp.LAUNCHES == sum(want.values()),
          f"{what}: paged prefill launches {got} (all {pp.LAUNCHES}), not "
          f"{want} for {eng.cfg.n_layers} layers x "
          f"{eng.prefill_obs - obs0} prefill calls")
    return pp.LAUNCHES


def phase_main_path(card):
    """Returns the main path's paged-attention launches, config and
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models.transformer import init_params

    cfg = get_config("smollm-135m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, dtype=torch.bfloat16,
                         device="cuda")

    # warm-up: CUDA context, cuBLAS handles and the kernel library load
    _, warm = main_engine(cfg, params)
    warm.submit(list(range(3, 40)), max_new_tokens=4)
    warm.submit(list(range(5, 300)), max_new_tokens=4, temperature=0.8,
                top_k=40, top_p=0.9)
    warm.run()
    del warm

    mmu, eng = main_engine(cfg, params)
    reqs = main_requests(cfg)
    _zero_counts()
    for prompt, mode in reqs:
        eng.submit(prompt, max_new_tokens=64, **mode)
    stats = eng.run()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    check(stats["completed"] == 24, f"completed {stats['completed']}/24")
    check(mmu.utilization()["pages_used"] == 0, "pages leaked")
    for r in eng.completed:
        check(len(r.out_tokens) == 64, f"rid {r.rid} has "
              f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"rid {r.rid} token outside the vocabulary")
    check(launches == cfg.n_layers * eng.steps,
          f"LAUNCHES {launches} != {cfg.n_layers} x {eng.steps} steps")
    pp_launches = check_prefill_launches(eng, "main path")
    check(eng.prefill_skipped > 0, "no prompt page was shared")
    st = np.asarray(eng.decode_step_times) * 1e3
    line = {
        "card": card, "model": "smollm-135m (random weights, bf16)",
        "requests": 24, "decode_steps": eng.steps,
        "tokens": stats["tokens"], "wall_s": stats["wall_s"],
        "tokens_per_s": stats["tokens_per_s"],
        "decode_step_ms_mean": float(st.mean()),
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "decode_step_ms_p99": float(np.percentile(st, 99)),
        "prefill_tokens": eng.prefill_computed,
        "prefill_skipped": eng.prefill_skipped,
        "prefill_tokens_per_s": eng.prefill_computed / eng.prefill_s,
        **{k: stats[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                 "tpot_p50_ms", "tpot_p99_ms")},
        "pa_launches": launches, "pa_kernel": "pa_decode_kernel",
        "pp_launches": pp_launches, "pp_kernel": "pp_fwd_wgmma_kernel",
    }
    print("[4] " + json.dumps(line))
    return launches, cfg, params


def phase_h2o_serving(card):
    """Full-width h2o-danube-3-4b in bf16 through ``ServingEngine``: its
    head_dim of 120 runs on the paged kernel built for 128.  H2O_REQUESTS
    requests of 256-1024 prompt tokens and H2O_NEW_TOKENS new tokens each,
    half greedy, half sampled.  Returns its paged-attention launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config("h2o-danube-3-4b")
    check(cfg.head_dim == 120, f"h2o-danube head_dim {cfg.head_dim}")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    max_len = H2O_PROMPT[1] + H2O_NEW_TOKENS

    def engine(n_pages):
        mmu = MMU(MMUConfig(page_size=16, n_pages=n_pages))
        return mmu, ServingEngine(cfg, params, mmu, max_batch=H2O_REQUESTS,
                                  max_len=max_len, prefill_chunk=256,
                                  device="cuda")

    _, warm = engine(256)              # warm-up: cuBLAS, the kernel load
    warm.submit(list(range(3, 300)), max_new_tokens=4)
    warm.run()
    del warm
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, cfg.vocab_size, size=int(rs.randint(
        H2O_PROMPT[0], H2O_PROMPT[1] + 1))).tolist()
        for _ in range(H2O_REQUESTS)]
    mmu, eng = engine(2048)            # 2048 pages of 16: 3.77 GB of KV
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    for i, prompt in enumerate(prompts):
        eng.submit(prompt, max_new_tokens=H2O_NEW_TOKENS,
                   **({"temperature": 0.8} if i % 2 else {}))
    stats = eng.run()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    check(stats["completed"] == H2O_REQUESTS,
          f"h2o completed {stats['completed']}/{H2O_REQUESTS}")
    check(mmu.utilization()["pages_used"] == 0, "h2o pages leaked")
    for r in eng.completed:
        check(len(r.out_tokens) == H2O_NEW_TOKENS,
              f"h2o rid {r.rid} has {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"h2o rid {r.rid} token outside the vocabulary")
    check(launches == cfg.n_layers * eng.steps,
          f"h2o LAUNCHES {launches} != {cfg.n_layers} x {eng.steps} steps")
    pp_launches = check_prefill_launches(eng, "h2o")
    check(all(n == 0 for n in _flash_counts().values())
          and _ssd_count() == 0,
          "the h2o serving path launched a flash or SSD kernel")
    st = np.asarray(eng.decode_step_times) * 1e3
    print("[10] " + json.dumps({
        "card": card, "model": "h2o-danube-3-4b (random weights, bf16)",
        "params": n_params, "head_dim": cfg.head_dim,
        "requests": H2O_REQUESTS,
        "prompt_tokens": [len(p) for p in prompts],
        "decode_steps": eng.steps, "tokens": stats["tokens"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "prefill_tokens_per_s": eng.prefill_computed / eng.prefill_s,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pa_launches": launches, "pa_kernel": "pa_decode_kernel",
        "pp_launches": pp_launches, "pp_kernel": "pp_fwd_wgmma_kernel",
        "first_tokens": [r.out_tokens[:6] for r in eng.completed[:2]]}))
    del eng, mmu, params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- shell
def _gbps(nbytes, seconds):
    return nbytes / seconds / 1e9


def _timed(fn):
    """(fn(), host seconds); the card is idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _flush():
    """A buffer larger than the 50 MB L2, zeroed before each timed call."""
    return torch.empty(256 << 20, dtype=torch.uint8, device="cuda")


def _shell_services():
    from repro_torch.core.services import (AESConfig, CollectiveConfig,
                                           CompressionConfig, MMUConfig,
                                           SnifferConfig)
    return {"mmu": MMUConfig(page_size=16, n_pages=2048),
            "encryption": AESConfig(), "compression": CompressionConfig(),
            "collectives": CollectiveConfig(), "sniffer": SnifferConfig()}


def _transfer_engine(eng, out):
    """Table 2 analogue: word-granular upload of 64 MiB, chunked and
    whole uploads of 256 MiB, each downloaded and compared."""
    rs = np.random.RandomState(21)
    for path, nbytes in (("word_granular", 64 << 20), ("chunked", 256 << 20),
                         ("whole", 256 << 20)):
        src = np.frombuffer(bytearray(rs.bytes(nbytes)), np.uint8)
        fn = {"word_granular": eng.upload_word_granular,
              "chunked": eng.upload, "whole": eng.upload_whole}[path]
        fn(src[:16 << 20])          # warm-up: the pinned ring, the context
        dev, st = fn(src)
        back, _ = eng.download(dev)
        check(np.array_equal(back.reshape(-1), src),
              f"transfer engine {path}: download differs from the source")
        out[f"upload_{path}_gbps"] = _gbps(nbytes, st.seconds)
        out[f"upload_{path}_chunks"] = st.chunks
        del dev, back


def _serve_two_tenants(shell, cfg, out):
    """Slot 0: two tenants (3:1) submit SHELL_REQUESTS prompts each
    through slot 0's port; slot 2 is hot-swapped (hll -> vector_add ->
    hll) while they are in flight."""
    from repro_torch.apps.hll import make_hll_artifact
    from repro_torch.apps.lm_serving import CSR_MAX_NEW_TOKENS
    from repro_torch.apps.vector_add import make_vector_add_artifact
    from repro_torch.core import Invocation, Oper, SgEntry
    from repro_torch.core.interfaces import Packet
    from repro_torch.kernels.paged_attention import paged_attention as pa

    port = shell.attach(0)
    shell.vfpgas[0].iface.csr.set_csr(SHELL_NEW_TOKENS, CSR_MAX_NEW_TOKENS)

    def submit(prompt, tenant, stream):
        inv = Invocation.from_sg(SgEntry(src=prompt, length=prompt.nbytes,
                                         src_stream=stream,
                                         opcode=Oper.KERNEL))
        inv.tenant = tenant
        return port.submit(inv)

    # warm-up: the engine (its KV pools), cuBLAS and the kernel library
    check(submit(np.arange(3, 40, dtype=np.int32), "gold", 0).result(
        timeout=300).ok, "slot 0 warm-up request failed")
    eng = shell.engines[0]
    rs = np.random.RandomState(22)
    prompts = [(t, rs.randint(1, cfg.vocab_size, size=int(rs.randint(
        SHELL_PROMPT[0], SHELL_PROMPT[1] + 1))).astype(np.int32))
        for _ in range(SHELL_REQUESTS) for t in ("gold", "bronze")]
    sched = shell.scheduler
    bytes0 = {t: s["bytes"] for t, s in sched.stats()["tenants"].items()}
    io0, steps0, done0 = eng.io_bytes, eng.steps, len(eng.completed)
    obs0 = eng.prefill_obs
    _zero_counts()
    t_sub, futs = [], []
    for tenant, prompt in prompts:
        t_sub.append(time.perf_counter())
        futs.append(submit(prompt, tenant, 0 if tenant == "gold" else 1))

    # hot-swap slot 2 under slot 0's traffic
    port2 = shell.attach(2)
    swaps = []
    for art in (make_vector_add_artifact(), make_hll_artifact()):
        check(not all(f.done() for f in futs),
              "slot 0's invocations finished before the hot-swap")
        st = shell.reconfigure(2, art)
        swaps.append({"app": art.name, "total_s": st["total_s"],
                      "drain_s": st["drain_s"], "replayed": st["replayed"]})
        if art.name == "vector_add":
            iface = shell.vfpgas[2].iface
            a, b = np.arange(8, dtype=np.float32), np.full(8, 2, np.float32)
            for i, v in enumerate((a, b)):
                iface.host_in[i].push(Packet(tid=0, seq_no=0, payload=v,
                                             nbytes=v.nbytes, last=True))
            comp = port2.submit(Invocation.from_sg(SgEntry(
                src=None, length=a.nbytes, opcode=Oper.KERNEL))).result(60)
            check(comp.ok and np.array_equal(comp.result, a + b),
                  "vector_add on the hot-swapped slot 2")
    comps = [f.result(timeout=600) for f in futs]
    eng.flush_io(timeout=60, strict=True)
    shell.drain()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    check(all(c.ok for c in comps),
          f"slot 0 failures: {[c.result for c in comps if not c.ok][:2]}")
    new = eng.completed[done0:]
    check(len(new) == len(prompts) and len({r.rid for r in new}) == len(new),
          f"slot 0 completed {len(new)} distinct requests, not "
          f"{len(prompts)}: a completion was lost or duplicated")
    pst = port.stats()
    check(pst["submitted"] == pst["completed"],
          f"slot 0 port submitted {pst['submitted']} completed "
          f"{pst['completed']}")
    by_list = {id(r.out_tokens): r for r in new}
    steps = eng.steps - steps0
    check(launches == cfg.n_layers * steps,
          f"slot 0 LAUNCHES {launches} != {cfg.n_layers} x {steps} steps")
    check_prefill_launches(eng, "slot 0", obs0)
    check(all(n == 0 for n in _flash_counts().values())
          and _ssd_count() == 0, "slot 0 launched a flash or SSD kernel")
    lat = {"gold": ([], []), "bronze": ([], [])}
    for (tenant, prompt), t0, c in zip(prompts, t_sub, comps):
        r = by_list[id(c.result)]
        check(r.prompt == prompt.tolist(), "a completion carries another "
              "request's tokens")
        check(len(r.out_tokens) == SHELL_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"rid {r.rid}: {len(r.out_tokens)} tokens or one outside "
              f"the vocabulary")
        lat[tenant][0].append(r.t_first_token - t0)
        lat[tenant][1].append((r.t_done - r.t_first_token)
                              / (len(r.out_tokens) - 1))
    stats = sched.stats()["tenants"]
    billed = {t: s["bytes"] - bytes0.get(t, 0) for t, s in stats.items()}
    io = eng.io_bytes - io0
    check(billed[eng.tenant or "tenant0"] == io,
          f"billed decode I/O {billed} != engine io_bytes {io}")
    for t in ("gold", "bronze"):
        want = sum(p.nbytes for tt, p in prompts if tt == t)
        check(billed[t] == want, f"tenant {t} billed {billed[t]}, its "
              f"prompts are {want} bytes")
    total = sum(billed.values())
    out.update({
        "requests": len(prompts), "decode_steps": steps,
        "pa_launches": launches, "engine_io_bytes": io,
        "billed_bytes": billed,
        "byte_shares": {t: b / total for t, b in billed.items()},
        "ttft_p50_ms": {t: float(np.percentile(v[0], 50) * 1e3)
                        for t, v in lat.items()},
        "tpot_p50_ms": {t: float(np.percentile(v[1], 50) * 1e3)
                        for t, v in lat.items()},
        "decode_step_ms_p50": float(np.percentile(
            eng.decode_step_times[-steps:], 50) * 1e3),
        "hot_swaps_slot2": swaps})


def _aes_slot(shell, out):
    from repro_torch.apps.aes import make_aes_artifact
    from repro_torch.core import Invocation, Oper, SgEntry
    from repro_torch.core.services import encryption as E

    rs = np.random.RandomState(23)
    data = np.frombuffer(bytearray(rs.bytes(AES_ECB_BYTES)), np.uint8)
    port = shell.attach(1)
    key = np.arange(16, dtype=np.uint8)             # the CSR default key
    rk_cpu = torch.from_numpy(E.expand_key(key))
    shell.vfpgas[1].invoke_kernel(data[:AES_PREFIX_BYTES])     # warm-up
    app_s = _timed(lambda: shell.vfpgas[1].invoke_kernel(data))[1]
    comp, ecb_s = _timed(lambda: port.submit(Invocation.from_sg(SgEntry(
        src=data, length=data.size, opcode=Oper.KERNEL))).result(300))
    check(comp.ok, f"AES ECB on slot 1: {comp.result}")
    pre = AES_PREFIX_BYTES
    want = E.aes_ecb(torch.from_numpy(data[:pre].reshape(-1, 16).copy()),
                     rk_cpu).numpy().reshape(-1)
    check(np.array_equal(comp.result[:pre], want),
          "AES ECB on the card differs from the CPU on the 1 MiB prefix")
    blocks = torch.from_numpy(data.reshape(-1, 16)).cuda()
    rk = rk_cpu.cuda()
    dev_ms = time_ms(lambda: E.aes_ecb(blocks, rk), 5, _flush())[0]
    fips_key = np.frombuffer(bytes.fromhex(
        "2b7e151628aed2a6abf7158809cf4f3c"), np.uint8).copy()
    pt = torch.from_numpy(np.frombuffer(bytes.fromhex(
        "3243f6a8885a308d313198a2e0370734"), np.uint8).copy()).cuda()
    ct = E.aes_ecb(pt[None], torch.from_numpy(
        E.expand_key(fips_key)).cuda())[0].cpu().numpy()
    check(ct.tobytes().hex() == "3925841d02dc09fbdc118597196a0b32",
          f"FIPS-197 Appendix B on the card gives {ct.tobytes().hex()}")
    del blocks
    st = shell.reconfigure(1, make_aes_artifact("cbc"))
    out["app_reconfigure_s"]["aes_ecb->aes_cbc"] = st["total_s"]
    vf = shell.vfpgas[1]
    cbc = {}
    for streams in (1, AES_CBC_STREAMS):
        buf = np.frombuffer(bytearray(rs.bytes(streams * AES_CBC_BLOCKS * 16)),
                            np.uint8)
        vf.invoke_kernel(buf, streams)              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = vf.invoke_kernel(buf, streams)
        secs = time.perf_counter() - t0
        blk = torch.from_numpy(buf.reshape(streams, -1, 16).copy())
        want = E.aes_cbc_multistream(
            blk, torch.zeros((streams, 16), dtype=torch.uint8),
            rk_cpu).numpy().reshape(-1)
        check(np.array_equal(got, want),
              f"AES CBC x{streams} on the card differs from the CPU")
        cbc[streams] = (buf.size, secs)
    out.update({
        "aes_ecb_bytes": data.size, "aes_ecb_port_gbps": _gbps(
            data.size, ecb_s), "aes_ecb_app_gbps": _gbps(data.size, app_s),
        "aes_ecb_device_gbps": _gbps(
            data.size, dev_ms / 1e3),
        "aes_cbc_blocks_per_stream": AES_CBC_BLOCKS,
        "aes_cbc_x1_gbps": _gbps(*cbc[1]), "aes_cbc_x1_s": cbc[1][1],
        f"aes_cbc_x{AES_CBC_STREAMS}_gbps": _gbps(*cbc[AES_CBC_STREAMS]),
        f"aes_cbc_x{AES_CBC_STREAMS}_s": cbc[AES_CBC_STREAMS][1]})


def _hll_items():
    """HLL_ITEMS items over exactly HLL_DISTINCT distinct 32-bit values
    (an odd multiplier is a bijection modulo 2^32), shuffled."""
    rs = np.random.RandomState(24)
    base = ((np.arange(HLL_DISTINCT, dtype=np.uint64) * 2654435761 + 12345)
            % (1 << 32)).astype(np.uint32)
    return np.tile(base, HLL_ITEMS // HLL_DISTINCT)[
        rs.permutation(HLL_ITEMS)]


def _hll_slot(shell, out):
    from repro_torch.apps import hll as H
    from repro_torch.core import Invocation, Oper, SgEntry

    items = _hll_items()
    port = shell.attach(2)
    src = items.view(np.uint8)
    shell.vfpgas[2].invoke_kernel(src[:HLL_PREFIX * 4])        # warm-up
    app_s = _timed(lambda: shell.vfpgas[2].invoke_kernel(src))[1]
    comp, secs = _timed(lambda: port.submit(Invocation.from_sg(SgEntry(
        src=src, length=src.size, opcode=Oper.KERNEL))).result(300))
    check(comp.ok, f"HLL on slot 2: {comp.result}")
    err = abs(comp.result - HLL_DISTINCT) / HLL_DISTINCT
    bound = 3 * 1.04 / math.sqrt(4096)
    check(err <= bound, f"HLL estimate {comp.result} is {err:.4f} off "
          f"{HLL_DISTINCT} (bound {bound:.4f})")
    pre = torch.from_numpy(items[:HLL_PREFIX].view(np.int32).copy())
    check(torch.equal(H.hll_sketch(pre.cuda()).cpu(), H.hll_sketch(pre)),
          "HLL registers on the card differ from the CPU's on the prefix")
    dev_items = torch.from_numpy(items.view(np.int32).copy()).cuda()
    dev_ms = time_ms(lambda: H.hll_sketch(dev_items), 5, _flush())[0]
    del dev_items
    out.update({"hll_items": HLL_ITEMS, "hll_distinct": HLL_DISTINCT,
                "hll_estimate": comp.result, "hll_rel_err": err,
                "hll_port_items_per_s": HLL_ITEMS / secs,
                "hll_app_items_per_s": HLL_ITEMS / app_s,
                "hll_device_items_per_s": HLL_ITEMS / (dev_ms / 1e3)})


def _nn_slot(shell, overlay, out):
    from repro_torch.apps.nn_inference import StagedCopyBaseline, mlp_apply

    x = torch.randn((NN_ROWS, 593), generator=torch.Generator().manual_seed(
        25)).numpy()
    want = mlp_apply(overlay.params, torch.from_numpy(x)).numpy()
    overlay.predict(x[:NN_BATCH * 4], batch_size=NN_BATCH)    # warm-up
    got_app, app_s = _timed(lambda: shell.vfpgas[overlay.slot].invoke_kernel(x))
    got, stream_s = _timed(lambda: overlay.predict(x, batch_size=NN_BATCH))
    check(np.array_equal(got_app, got), "NN: the app's stream loop and the "
          "port's predict differ")
    staged = StagedCopyBaseline(overlay.params, device="cuda")
    staged.predict(x[:NN_BATCH * 4], batch_size=NN_BATCH)
    t0 = time.perf_counter()
    got_staged = staged.predict(x, batch_size=NN_BATCH)
    staged_s = time.perf_counter() - t0
    for name, y in (("streamed", got), ("staged", got_staged)):
        err = float(np.abs(y - want).max())
        check(y.shape == (NN_ROWS, 1) and err <= 1e-4,
              f"NN {name} on the card vs the CPU: max_abs_err {err}")
    out.update({"nn_rows": NN_ROWS, "nn_batch": NN_BATCH,
                "nn_streamed_rows_per_s": NN_ROWS / stream_s,
                "nn_streamed_app_rows_per_s": NN_ROWS / app_s,
                "nn_staged_rows_per_s": NN_ROWS / staged_s,
                "nn_max_abs_err": float(np.abs(got - want).max())})


def _reduced_app_card_vs_cpu():
    """Reduced smollm-135m fp32 through the lm_serving app on a one-slot
    shell on the card and on the CPU: identical greedy tokens."""
    from repro_torch.apps.lm_serving import (CSR_MAX_NEW_TOKENS,
                                             make_lm_serving_artifact)
    from repro_torch.configs import get_config
    from repro_torch.core import Oper, SgEntry, Shell, ShellConfig
    from repro_torch.core.services import MMUConfig
    from repro_torch.models.transformer import init_params

    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(26),
                         dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(26)
    prompts = [rs.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 40, 17)]
    runs = {}
    for dev in ("cpu", "cuda"):
        shell = Shell(ShellConfig.make(services={
            "mmu": MMUConfig(page_size=16, n_pages=64)}, n_vfpgas=1),
            device=dev)
        shell.build()
        shell.load_app(0, make_lm_serving_artifact(
            cfg, _to_device(params, dev), max_len=96))
        ct = shell.attach_thread(0, pid=7)
        ct.setCSR(12, CSR_MAX_NEW_TOKENS)
        runs[dev] = []
        for pr in prompts:
            comp = ct.invoke(Oper.KERNEL, SgEntry(src=pr, length=pr.nbytes),
                             timeout=120)
            check(comp.ok, f"reduced lm_serving on {dev}: {comp.result}")
            runs[dev].append(list(comp.result))
        shell.close()
    check(runs["cpu"] == runs["cuda"],
          f"reduced lm_serving tokens differ: {runs}")
    return runs["cuda"]


def _to_device(tree, dev):
    return ({k: _to_device(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(dev))


def phase_shell(card, cfg, params):
    """Phase 11: the Coyote v2 shell on the card.  Builds
    ``Shell(services=<all five>, n_vfpgas=4)``, checks the transfer
    engine, loads lm_serving (full-width smollm-135m, bf16), AES, HLL and
    the NN into slots 0-3, serves two weighted tenants from slot 0 while
    slot 2 is hot-swapped, runs each app against the CPU, reconfigures
    the shell and cold-restarts it.  Returns the paged-attention launches
    of slot 0's run."""
    from repro_torch.apps.aes import make_aes_artifact
    from repro_torch.apps.hll import make_hll_artifact
    from repro_torch.apps.lm_serving import make_lm_serving_artifact
    from repro_torch.apps.nn_inference import CoyoteOverlay
    from repro_torch.core import Invocation, Oper, SgEntry, Shell, ShellConfig

    t_phase = time.perf_counter()
    out = {"card": card, "app_reconfigure_s": {}}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    shell = Shell(ShellConfig.make(services=_shell_services(), n_vfpgas=4),
                  device="cuda")
    report = shell.build()
    out["build_s"] = time.perf_counter() - t0
    out["build_components"] = report.components
    check(torch.cuda.max_memory_allocated() <= mem0,
          f"the shell's build allocated device memory: peak "
          f"{torch.cuda.max_memory_allocated()} > {mem0} bytes")
    check(all(c["compile_s"] == 0.0 for c in report.components.values()),
          "a build reported compile seconds")
    _transfer_engine(shell.static.engine, out)

    shell.register_tenant("gold", 3.0)
    shell.register_tenant("bronze", 1.0)
    for slot, art in ((0, make_lm_serving_artifact(
            cfg, params, max_batch=SHELL_BATCH, max_len=SHELL_LEN)),
            (1, make_aes_artifact("ecb")),
            (2, make_hll_artifact())):
        out["app_reconfigure_s"][art.name] = shell.load_app(
            slot, art)["total_s"]
    overlay = CoyoteOverlay(shell, slot=3, seed=0)
    out["app_reconfigure_s"]["nn_inference"] = overlay.program_fpga(
        warm_batch=NN_BATCH)["total_s"]
    sniffer = shell.services.get("sniffer")
    sniffer.start()

    _serve_two_tenants(shell, cfg, out)
    launches = out["pa_launches"]
    _aes_slot(shell, out)
    _hll_slot(shell, out)
    _nn_slot(shell, overlay, out)
    out["sniffer_records"] = len(sniffer.to_records())
    check(out["sniffer_records"] > 0, "the sniffer captured nothing")

    t0 = time.perf_counter()
    services = _shell_services()
    del services["sniffer"]
    st = shell.reconfigure_shell(ShellConfig.make(services=services,
                                                  n_vfpgas=4))
    out["shell_reconfigure_s"] = time.perf_counter() - t0
    out["shell_reconfigure_kernel_s"] = st["kernel_s"]
    check("sniffer" not in shell.services.names()
          and all(vf.app is not None for vf in shell.vfpgas),
          "reconfigure_shell did not drop the sniffer or lost an app")
    r = shell.cold_restart()
    out["cold_restart_s"] = r["total_s"]
    check([vf.app.name for vf in shell.vfpgas]
          == ["lm_serving", "aes_cbc", "hll", "nn_inference"],
          "cold_restart did not reload every slot")
    items = _hll_items()[:1 << 20]
    comp = shell.attach(2).submit(Invocation.from_sg(SgEntry(
        src=items.view(np.uint8), length=items.nbytes,
        opcode=Oper.KERNEL))).result(120)
    check(comp.ok and comp.result > 0, "HLL after cold_restart")
    shell.close()
    out["reduced_fp32_tokens"] = _reduced_app_card_vs_cpu()
    out["phase_s"] = time.perf_counter() - t_phase
    print("[11] " + json.dumps(out))
    del shell, overlay
    torch.cuda.empty_cache()
    return launches


def _live_kv(eng):
    """{(rid, vpage): {"k", "v"}}: the written KV of every device-resident
    page of the engine's running sequences, gathered on the card.  A
    sequence's last position is the token sampled last, whose KV the next
    decode step writes; a page's tail past the written positions holds
    whatever its previous owner left, so it is cut off."""
    from repro_torch.serve.paged_model import (flat_page_indices,
                                               gather_kv_pages)
    mmu, out, page = eng.mmu, {}, eng.page
    for r in eng.slots:
        if r is None:
            continue
        se = mmu._seqs[r.rid]
        for pte in se.pages:
            n = min(page, se.length - 1 - pte.vpage * page)
            if not pte.on_host and n > 0:
                kv = gather_kv_pages(eng.pools, flat_page_indices(
                    [pte.ppage], eng.cfg.n_layers, mmu.config.n_pages))
                out[(r.rid, pte.vpage)] = {s: t[:, :n]
                                           for s, t in kv.items()}
    return out


def _same_kv(got, want, what):
    check(set(got) == set(want) and len(want) > 0,
          f"{what}: the destination maps other pages")
    check(all(torch.equal(got[k][s], want[k][s]) for k in want
              for s in ("k", "v")), f"{what}: KV bytes differ")


def _mig_requests(cfg, seed, n):
    """n prompts of MIG_PROMPT tokens, every other one sampled."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(1, cfg.vocab_size, size=int(rs.randint(
        MIG_PROMPT[0], MIG_PROMPT[1] + 1))).tolist(),
        {"temperature": 0.8, "top_k": 40} if i % 2 else {})
        for i in range(n)]


def phase_migration(card, cfg, params):
    """Phase 12: full-width smollm-135m (phase 4's bf16 weights) moved
    between two shells on the card: stop-and-copy ``migrate``,
    ``migrate_precopy``, in-place ``Shell.recover_slot`` of a wedged slot
    and a ``FleetController.sweep`` that heals one; then a continuous
    ``ServingGateway`` with open arrivals.  Each group's streams must
    equal a control engine of the same geometry that serves the same
    requests unmoved, stepped beside the source; the written KV on the
    destination must equal, byte for byte on the card, the source's
    (stop-and-copy, recovery) or the control's at the freeze (pre-copy,
    whose source decodes between warm rounds); every decode on
    ``pa_decode_kernel``."""
    from repro_torch.core import Shell, ShellConfig
    from repro_torch.core.migrate import migrate, migrate_precopy
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.fleet import FleetController
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.serve.engine import ServingEngine

    t_phase = time.perf_counter()

    def engine(mmu, **kw):
        return ServingEngine(cfg, params, mmu, max_batch=MIG_BATCH,
                             max_len=MIG_LEN, device="cuda", **kw)

    shells, engines = [], []
    for name, base in (("chip-a", 0), ("chip-b", 1000)):
        sh = Shell(ShellConfig.make(services={"mmu": MMUConfig(**MIG_MMU)},
                                    n_vfpgas=2), name=name, device="cuda")
        sh.build()
        shells.append(sh)
        engines.append(engine(sh.services.get("mmu"), shell=sh, slot=0,
                              tenant="gold", rid_base=base))
    fc = FleetController()
    for sh in shells:
        fc.add_shell(sh)
    out = {"card": card, "model": "smollm-135m (random weights, bf16)"}
    # (mode, source member, requests, new tokens, seed of the prompts)
    groups = (("stop_and_copy", 0, MIG_REQUESTS, MIG_NEW_TOKENS, 40),
              ("pre_copy", 1, MIG_REQUESTS, MIG_NEW_TOKENS, 41),
              ("recover_slot", 0, MIG_REQUESTS, MIG_NEW_TOKENS, 42),
              ("fleet_sweep", 0, MIG_REQUESTS // 2, MIG_NEW_TOKENS // 2, 43))
    _zero_counts()
    steps0, ctrl_steps = [e.steps for e in engines], 0
    for mode, si, n_req, n_new, seed in groups:
        t0 = time.perf_counter()
        src_sh, src = shells[si], engines[si]
        dst_sh, dst = shells[1 - si], engines[1 - si]
        ctrl = engine(MMU(MMUConfig(**MIG_MMU)), seed=src.seed,
                      rid_base=src._rid_next - 1)
        for prompt, kw in _mig_requests(cfg, seed, n_req):
            src.submit(prompt, max_new_tokens=n_new, **kw)
            ctrl.submit(prompt, max_new_tokens=n_new, **kw)
        for _ in range(MIG_STEPS):
            src.step()
            ctrl.step()
        torch.cuda.synchronize()
        t_move = time.perf_counter()
        if mode == "stop_and_copy":
            before = _live_kv(src)
            rep = migrate(src_sh, dst_sh, "gold")
            _same_kv(_live_kv(dst), before, mode)
        elif mode == "pre_copy":
            rep = migrate_precopy(src_sh, dst_sh, "gold", max_rounds=4)
            check(rep.precopy_rounds >= 1, "pre-copy ran no warm round")
            for _ in range(rep.precopy_rounds):    # the source decoded
                ctrl.step()
            _same_kv(_live_kv(dst), _live_kv(ctrl), mode)
        else:                  # the slot goes quiet with work pending
            src_sh.health.heartbeat_timeout_s = 0.05
            time.sleep(0.12)
            before = _live_kv(src)
            if mode == "recover_slot":
                check(0 in src_sh.check_health()["wedged"],
                      "the slot was not flagged wedged")
                rep = src_sh.recover_slot(0)
            else:
                ds = [d for d in fc.sweep() if d.action == "recover"]
                check(len(ds) == 1 and ds[0].ok
                      and ds[0].src == src_sh.name,
                      f"fleet sweep: {[d.to_dict() for d in ds]}")
                rep = ds[0].report
            src_sh.health.heartbeat_timeout_s = 30.0
            dst = src
            _same_kv(_live_kv(dst), before, mode)
        t_moved = time.perf_counter()
        check(rep.n_requests == n_req, f"{mode}: moved {rep.n_requests}")
        while dst.pending() or ctrl.pending():
            for e in (dst, ctrl):
                if e.pending():
                    e.step()
        torch.cuda.synchronize()
        want = {r.rid: r.out_tokens for r in ctrl.completed}
        done = [r for e in engines for r in e.completed if r.rid in want]
        check(len(done) == len(want) == n_req,
              f"{mode}: {len(done)} completions of {n_req} requests")
        check({r.rid: r.out_tokens for r in done} == want,
              f"{mode}: streams differ from the unmoved control")
        check(all(len(t) == n_new for t in want.values()),
              f"{mode}: a stream has the wrong length")
        check(all(sh.services.get("mmu").utilization()["pages_used"] == 0
                  for sh in shells), f"{mode}: pages leaked")
        ctrl_steps += ctrl.steps
        out[mode] = {
            "downtime_ms": rep.downtime_s * 1e3,
            "quiesce_ms": rep.quiesce_s * 1e3,
            "snapshot_ms": rep.snapshot_s * 1e3,
            "restore_ms": (rep.restore_s + getattr(rep, "restart_s", 0.0))
            * 1e3,
            "bytes_shipped": rep.payload_bytes
            + getattr(rep, "precopy_bytes", 0),
            "freeze_bytes": rep.payload_bytes,
            "warm_rounds": getattr(rep, "precopy_rounds", 0),
            "warm_pages": getattr(rep, "precopy_pages", 0),
            "freeze_pages": (rep.delta_pages if mode == "pre_copy"
                             else rep.n_pages),
            "move_wall_s": t_moved - t_move,
            "group_wall_s": time.perf_counter() - t0}
        del ctrl
    launches = pa.LAUNCHES
    steps = ctrl_steps + sum(e.steps - s for e, s in zip(engines, steps0))
    check(launches == cfg.n_layers * steps,
          f"phase 12 LAUNCHES {launches} != {cfg.n_layers} x {steps} steps")
    check(all(n == 0 for n in _flash_counts().values())
          and _ssd_count() == 0, "phase 12 launched a flash or SSD kernel")
    out["pa_launches"], out["decode_steps"] = launches, steps
    out["gateway"] = _gateway_arrivals(cfg, engines[0])
    for sh in shells:
        sh.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print("[12] " + json.dumps(out))
    del engines, shells, fc
    torch.cuda.empty_cache()


def _gateway_arrivals(cfg, eng):
    """A continuous, SLO-admitting gateway over the engine that owns the
    tenant takes GW_ARRIVALS open arrivals (seeded exponential gaps, in
    engine steps); the client retries each retryable GATEWAY_FULL
    refusal after the next step.  One arrival with an infeasible deadline
    and one that expires while queued must be refused, typed; every other
    arrival must complete exactly once with all its tokens."""
    from repro_torch.core import FaultKind, PortError
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.serve.gateway import ServingGateway
    rs = np.random.RandomState(50)
    at = np.cumsum(rs.exponential(1.0, GW_ARRIVALS)).astype(int)
    prompts = [rs.randint(1, cfg.vocab_size, size=int(rs.randint(
        MIG_PROMPT[0], MIG_PROMPT[1] + 1))).tolist()
        for _ in range(GW_ARRIVALS)]
    gw = ServingGateway(eng, mode="continuous", admission="slo",
                        max_queue=GW_MAX_QUEUE, min_obs=1)
    check(gw._service_estimate(64, GW_NEW_TOKENS) is not None,
          "the engine's step-time estimates are cold")
    t0, steps0 = time.perf_counter(), eng.steps
    pa.LAUNCHES = 0
    kinds = {}
    try:
        gw.submit([5, 6, 7], max_new_tokens=GW_NEW_TOKENS, deadline_s=1e-6)
    except PortError as e:
        kinds[e.kind] = 1
    check(kinds == {FaultKind.SLO_INFEASIBLE: 1},
          f"an infeasible deadline was not refused: {kinds}")
    # feasible at the door (3x its estimate), then the client pauses past
    # it before the first step: the request expires in the queue
    dl = 3 * gw._service_estimate(3, 1)
    expiring = gw.submit([5, 6, 7], max_new_tokens=1, deadline_s=dl)
    time.sleep(dl)
    streams, waiting, step = [], list(range(GW_ARRIVALS)), 0
    while waiting or gw.pending():
        while waiting and at[waiting[0]] <= step:
            try:
                streams.append(gw.submit(prompts[waiting[0]],
                                         max_new_tokens=GW_NEW_TOKENS,
                                         priority=5))
            except PortError as e:
                check(e.kind == FaultKind.GATEWAY_FULL and e.retryable,
                      f"an arrival was refused with {e.kind}")
                kinds[e.kind] = kinds.get(e.kind, 0) + 1
                break                    # retried after the next step
            waiting.pop(0)
        gw.step()
        step += 1
    torch.cuda.synchronize()
    check(expiring.error is not None
          and expiring.error.kind == FaultKind.SLO_EXPIRED,
          "the deadlined arrival did not expire in the queue")
    kinds[expiring.error.kind] = 1
    check(kinds.get(FaultKind.GATEWAY_FULL, 0) >= 1,
          "no GATEWAY_FULL back-pressure")
    check(len(streams) == GW_ARRIVALS
          and all(s.done and s.error is None
                  and len(s.tokens) == GW_NEW_TOKENS for s in streams),
          "a gateway stream is missing, failed or has the wrong length")
    gids = [s.gid for s in gw.completed]
    check(len(gids) == len(set(gids)) == GW_ARRIVALS,
          f"{len(gids)} completions for {GW_ARRIVALS} arrivals")
    check(pa.LAUNCHES == cfg.n_layers * (eng.steps - steps0),
          "gateway decode launches")
    st = gw.stats()
    return {"arrivals": GW_ARRIVALS, "completed": st["completed"],
            "refused": {str(k): v for k, v in kinds.items()},
            "steps": eng.steps - steps0, "wall_s": time.perf_counter() - t0,
            **{k: st[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                  "tpot_p50_ms", "tpot_p99_ms")},
            "pa_launches": pa.LAUNCHES}


def _timed_dense(T, params, cfg, toks, n_decode, reps):
    """Median and p90 of ``reps`` prefills of ``toks`` and of ``n_decode``
    greedy decode steps after the last, every kernel waited for; then
    DENSE_TRACE_STEPS more steps in a padded trace (``padded_trace``,
    holding one softmax a layer a step): the device's busy time per step
    (union of the kernel intervals), its idle share against the untraced
    and the traced step, kernels per step."""
    pre, dec = [], []
    n_all = n_decode + 3 * DENSE_TRACE_STEPS       # room for two retakes
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, toks.shape[1] + n_all,
                                  cache_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    b, pos = toks.shape[0], toks.shape[1]
    nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)

    def step(t):
        logits, c = T.decode_step(params, cfg, cache, nxt,
                                  torch.full((b,), pos + t, device="cuda"))
        return logits[:, :cfg.vocab_size].argmax(-1, keepdim=True), c, logits

    for t in range(n_decode):
        t0 = time.perf_counter()
        nxt, cache, logits = step(t)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
    at = [n_decode]

    def traced_steps():
        nonlocal nxt, cache, logits
        for t in range(at[0], at[0] + DENSE_TRACE_STEPS):
            nxt, cache, logits = step(t)
            torch.cuda.synchronize()
        at[0] += DENSE_TRACE_STEPS

    want = cfg.n_layers * DENSE_TRACE_STEPS
    kernels, wall, n_soft, trace = padded_trace(
        traced_steps, named(r"(?i)softmax"), want,
        f"{cfg.arch_id} dense decode softmax kernels")
    traced = wall / DENSE_TRACE_STEPS
    check(bool(torch.isfinite(logits).all()), "non-finite dense logits")
    kernels, busy, _ = _profile_summary(kernels, DENSE_TRACE_STEPS)
    pre, dec = np.asarray(pre), np.asarray(dec) * 1e3
    return {"prefill_s_p50": float(np.percentile(pre, 50)),
            "prefill_s_p90": float(np.percentile(pre, 90)),
            "decode_step_ms_p50": float(np.percentile(dec, 50)),
            "decode_step_ms_p90": float(np.percentile(dec, 90)),
            "prefills": reps, "decode_steps": n_decode,
            "traced_steps": DENSE_TRACE_STEPS,
            "decode_step_ms_traced": traced,
            "device_busy_ms_per_step": busy,
            "device_idle_share_untraced": 1 - busy / float(np.mean(dec)),
            "device_idle_share_traced": 1 - busy / traced,
            "kernels_per_step": len(kernels) / DENSE_TRACE_STEPS,
            "trace": {"number": trace, "softmax_kernels": n_soft,
                      "want": want}}


def phase_dense_cache(card, cfg, params):
    """Phase 13: the dense attention cache (``transformer.init_cache``,
    ``prefill``, ``decode_step``) at full width.  h2o-danube-3-4b, fp32:
    decode after a DENSE_H2O_PROMPT-token prefill (past the 4096 window:
    the ring fill) against the last logits of a prefill one token longer.
    smollm-135m, fp32: dense prefill and DENSE_SMOLLM teacher-forced
    decode steps against the paged engine's prefill and decode logits
    (``serve/paged_model.py``'s), on the same weights.  Then bf16 timing
    of both models' dense prefill and decode.  The dense prefill's
    attention runs on the flash forward kernel (bf16: the tensor-core
    one), the dense decode's is plain PyTorch, the paged decode's
    ``pa_decode_kernel`` and the paged prefill's (float32)
    ``pp_fwd_kernel``."""
    from repro_torch.configs import get_config
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    from repro_torch.models import transformer as T
    from repro_torch.serve.paged_model import (_decode_logits,
                                               _prefill_logits, make_pools)

    t_phase = time.perf_counter()
    out = {"card": card}
    hcfg = get_config("h2o-danube-3-4b")
    gen = torch.Generator(device="cuda")
    s = DENSE_H2O_PROMPT
    toks = torch.randint(3, hcfg.vocab_size, (1, s + 1),
                         generator=gen.manual_seed(5), device="cuda")
    hp = T.init_params(hcfg, generator=gen.manual_seed(3),
                       dtype=torch.float32, device="cuda")
    _zero_counts()
    _, cache = T.prefill(hp, hcfg, toks[:, :s], s + 1,
                         cache_dtype=torch.float32)
    check(cache["k"].shape[2] == hcfg.swa_window, "no ring of the window")
    got, _ = T.decode_step(hp, hcfg, cache, toks[:, s:],
                           torch.full((1,), s, device="cuda"))
    del cache
    want, _ = T.prefill(hp, hcfg, toks, s + 1, cache_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "non-finite h2o decode logits")
    check(err <= DENSE_ATOL, f"h2o decode vs prefill: {err}")
    check(fa.FMA_LAUNCHES == 2 * hcfg.n_layers and pa.LAUNCHES == 0,
          f"h2o fp32 dense path launches: fwd FMA {fa.FMA_LAUNCHES}, "
          f"paged {pa.LAUNCHES}")
    out["h2o_fp32_consistency"] = {
        "prompt": s, "window": hcfg.swa_window, "max_abs_err": err,
        "atol": DENSE_ATOL, "max_abs_logit": float(want.abs().max()),
        "fwd_fma_launches": fa.FMA_LAUNCHES}
    del hp, got, want
    torch.cuda.empty_cache()

    # smollm fp32: dense vs the paged engine's logits, teacher forced
    b, sp, n = DENSE_SMOLLM
    sp32 = T.init_params(cfg, generator=gen.manual_seed(0),
                         dtype=torch.float32, device="cuda")
    seq = torch.randint(3, cfg.vocab_size, (b, sp + n),
                        generator=gen.manual_seed(6), device="cuda")
    mmu = MMU(MMUConfig(page_size=16, n_pages=256))
    pools = make_pools(cfg, 256, 16, dtype=torch.float32, device="cuda")
    rids = list(range(1, b + 1))
    for r in rids:
        mmu.alloc_seq(r, sp)
    maxp = -(-(sp + n) // 16)
    zeros = torch.zeros(b, dtype=torch.int32, device="cuda")
    _zero_counts()
    dl, cache = T.prefill(sp32, cfg, seq[:, :sp], sp + n,
                          cache_dtype=torch.float32)
    pl = _prefill_logits(sp32, pools, seq[:, :sp],
                         torch.full((b,), sp, device="cuda"), zeros, zeros,
                         torch.as_tensor(mmu.block_table(rids, maxp),
                                         device="cuda"),
                         cfg=cfg, page_size=16)
    errs = [float((dl[:, :cfg.vocab_size] - pl).abs().max())]
    for t in range(sp, sp + n - 1):
        for r in rids:
            mmu.extend_seq(r, 1)
        tables = torch.as_tensor(mmu.block_table(rids, maxp), device="cuda")
        dl, cache = T.decode_step(sp32, cfg, cache, seq[:, t:t + 1],
                                  torch.full((b,), t, device="cuda"))
        pl = _decode_logits(sp32, pools, tables,
                            torch.full((b,), t, dtype=torch.int32,
                                       device="cuda"), seq[:, t],
                            cfg=cfg, page_size=16)
        errs.append(float((dl[:, :cfg.vocab_size] - pl).abs().max()))
    torch.cuda.synchronize()
    check(max(errs) <= DENSE_ATOL, f"smollm dense vs paged: {max(errs)}")
    check(pa.LAUNCHES == cfg.n_layers * (n - 1)
          and fa.FMA_LAUNCHES == cfg.n_layers
          and pp.LAUNCHES == pp.FMA_LAUNCHES == cfg.n_layers,
          f"smollm fp32 launches: paged {pa.LAUNCHES}, fwd "
          f"{fa.FMA_LAUNCHES}, paged prefill {pp.LAUNCHES} "
          f"({pp.FMA_LAUNCHES} FMA)")
    out["smollm_fp32_dense_vs_paged"] = {
        "rows": b, "prompt": sp, "decode_steps": n - 1,
        "max_abs_err": max(errs), "atol": DENSE_ATOL,
        "pa_launches": pa.LAUNCHES, "pp_fma_launches": pp.FMA_LAUNCHES}
    del sp32, cache, pools, mmu

    # bf16 timing: smollm (phase 4's weights) and h2o-danube
    b, sp = DENSE_SMOLLM_BF16
    toks = torch.randint(3, cfg.vocab_size, (b, sp),
                         generator=gen.manual_seed(7), device="cuda")
    _zero_counts()
    out["smollm_bf16"] = _timed_dense(T, params, cfg, toks,
                                      DENSE_DECODE_STEPS, DENSE_PREFILL_REPS)
    check(fa.WGMMA_LAUNCHES == cfg.n_layers * DENSE_PREFILL_REPS
          and fa.FMA_LAUNCHES == 0 and pa.LAUNCHES == 0,
          "smollm bf16 dense prefill not on fa_fwd_wgmma_kernel")
    out["smollm_bf16"].update(rows=b, prompt=sp,
                              fwd_wgmma_launches=fa.WGMMA_LAUNCHES)
    hp = T.init_params(hcfg, generator=gen.manual_seed(3),
                       dtype=torch.bfloat16, device="cuda")
    _zero_counts()
    out["h2o_bf16"] = _timed_dense(T, hp, hcfg, toks=torch.randint(
        3, hcfg.vocab_size, (1, s), generator=gen.manual_seed(8),
        device="cuda"), n_decode=DENSE_DECODE_STEPS,
        reps=DENSE_PREFILL_REPS)
    check(fa.WGMMA_LAUNCHES == hcfg.n_layers * DENSE_PREFILL_REPS
          and fa.FMA_LAUNCHES == 0 and pa.LAUNCHES == 0,
          "h2o bf16 dense prefill not on fa_fwd_wgmma_kernel")
    out["h2o_bf16"].update(rows=1, prompt=s,
                           fwd_wgmma_launches=fa.WGMMA_LAUNCHES)
    del hp
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print("[13] " + json.dumps(out))


# ------------------------------------------------------------ MoE serving
def _moe_drop_shares(cfg, eng, reqs, new_tokens):
    """Serves ``reqs`` through ``eng`` with ``moe.dispatch`` wrapped to
    count the dropped (token, expert) assignments (``dest == E*C``), and
    returns their shares: in the first prefill call, in the first decode
    step with every slot live (else the fullest), and over all of each.
    A dispatch of exactly ``max_batch`` tokens is a decode step's (every
    row, one token each); any other is a prefill call's.  The wrapper adds
    a compare and a sum a layer, so this pass is not the timed one; it
    also warms the engine up."""
    from repro_torch.models import moe
    dispatch = moe.dispatch
    calls = []          # (decode?, live rows, dropped, pairs) per layer

    def counted(xg, gates, eidx, n_experts, capacity):
        buf, dest, g = dispatch(xg, gates, eidx, n_experts, capacity)
        live = sum(r is not None and r.prefill_pos < 0 for r in eng.slots)
        calls.append((xg.shape[0] * xg.shape[1] == eng.max_batch, live,
                      (dest == n_experts * capacity).sum(), dest.numel()))
        return buf, dest, g

    moe.dispatch = counted
    try:
        for prompt, mode in reqs:
            eng.submit(prompt, max_new_tokens=new_tokens, **mode)
        eng.run()
    finally:
        moe.dispatch = dispatch
    nl = cfg.n_layers
    dec = [c for c in calls if c[0]]
    pre = [c for c in calls if not c[0]]
    check(len(dec) == nl * eng.steps and len(pre) % nl == 0,
          f"drop meter: {len(dec)} decode and {len(pre)} prefill dispatches "
          f"for {eng.steps} steps of {nl} layers")
    steps = [dec[i:i + nl] for i in range(0, len(dec), nl)]
    full = max(steps, key=lambda st: (st[0][1] >= eng.max_batch, st[0][1]))

    def share(cs):
        return sum(int(c[2]) for c in cs) / sum(c[3] for c in cs)
    return {"prefill_call_pairs_per_layer": pre[0][3],
            "prefill_call_drop_share": share(pre[:nl]),
            "decode_step_live_rows": full[0][1],
            "decode_step_drop_share": share(full),
            "decode_steps_drop_share_mean": share(dec),
            "prefill_calls_drop_share_mean": share(pre)}


def _serve_moe(card, cfg, make_engine, reqs, new_tokens, tag):
    """Serve ``reqs`` twice, each time on a new (mmu, engine) from
    ``make_engine``: first untimed through the drop meter, then with every
    launch count zeroed just before and read just after; the hard checks
    of phase 14.  Returns the paged decode launches and the printed line's
    dict (with the paged prefill launches)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    drops = _moe_drop_shares(cfg, make_engine()[1], reqs, new_tokens)
    mmu, eng = make_engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    for prompt, mode in reqs:
        eng.submit(prompt, max_new_tokens=new_tokens, **mode)
    stats = eng.run()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    pp_launches = check_prefill_launches(eng, tag)
    n = len(reqs)
    check(stats["completed"] == n and len({r.rid for r in eng.completed})
          == n, f"{tag}: completed {stats['completed']}/{n}")
    check(mmu.utilization()["pages_used"] == 0, f"{tag}: pages leaked")
    for r in eng.completed:
        check(len(r.out_tokens) == new_tokens,
              f"{tag} rid {r.rid} has {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"{tag} rid {r.rid} token outside the vocabulary")
    check(launches == cfg.n_layers * eng.steps,
          f"{tag} LAUNCHES {launches} != {cfg.n_layers} x {eng.steps} steps")
    check(all(v == 0 for v in _flash_counts().values())
          and _ssd_count() == 0,
          f"the {tag} serving path launched a flash or SSD kernel")
    st = np.asarray(eng.decode_step_times) * 1e3
    line = {
        "card": card, "requests": n,
        "prompt_tokens": [len(p) for p, _ in reqs],
        "decode_steps": eng.steps, "tokens": stats["tokens"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "prefill_tokens": eng.prefill_computed,
        "prefill_tokens_per_s": eng.prefill_computed / eng.prefill_s,
        **{k: stats[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                 "tpot_p50_ms", "tpot_p99_ms")},
        **drops,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pa_launches": launches, "pa_kernel": "pa_decode_kernel",
        "pp_launches": pp_launches,
        "first_tokens": [r.out_tokens[:6] for r in eng.completed[:2]]}
    return launches, line


def phase_granite_serving(card):
    """granite-moe-1b-a400m at full width (24 layers, d_model 1024, 16 / 8
    heads of 64, 32 experts top-8, capacity factor 1.25) in bf16 through
    ``main_engine`` with phase 4's traffic.  Returns its paged decode and
    paged prefill launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("granite-moe-1b-a400m")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(5), dtype=torch.bfloat16, device="cuda")
    check(params["layers"]["ffn"]["router"].dtype == torch.float32,
          "the router is not float32")
    n_params = sum(v.numel() for v in _leaves(params))
    launches, line = _serve_moe(card, cfg, lambda: main_engine(cfg, params),
                                main_requests(cfg), 64, "granite")
    print("[14] granite " + json.dumps({
        "model": "granite-moe-1b-a400m (random weights, bf16)",
        "params": n_params, "experts": cfg.moe.n_experts,
        "top_k": cfg.moe.top_k, **line}))
    phase_decode_profile(cfg, params, card, "granite-moe-1b-a400m")
    del params
    torch.cuda.empty_cache()
    return launches, line["pp_launches"]


def phase_llama4_serving(card):
    """llama4-scout-17b-a16e at full width (d_model 5120, 40 / 8 heads of
    128, 16 experts top-1 plus a shared expert, vocab 202048, untied) with
    its depth cut from 48 to LLAMA4_LAYERS layers, bf16: LLAMA4_REQUESTS
    requests of 128-512 prompt tokens, LLAMA4_NEW_TOKENS new, half
    sampled.  ``init_params`` casts each layer to bf16 before stacking, so
    the 4 layers' ~35 GB of float32 are never alive at once.  Returns its
    paged decode and paged prefill launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServingEngine

    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, n_layers=LLAMA4_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(6), dtype=torch.bfloat16, device="cuda")
    init_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    n_params = sum(v.numel() for v in _leaves(params))

    def engine():
        mmu = MMU(MMUConfig(page_size=16, n_pages=LLAMA4_SHAPE[6]))
        return mmu, ServingEngine(cfg, params, mmu,
                                  max_batch=LLAMA4_REQUESTS,
                                  max_len=LLAMA4_LEN, prefill_chunk=256,
                                  device="cuda")

    rs = np.random.RandomState(13)
    reqs = [(rs.randint(0, cfg.vocab_size, size=int(rs.randint(
        LLAMA4_PROMPT[0], LLAMA4_PROMPT[1] + 1))).tolist(),
        {"temperature": 0.8} if i % 2 else {})
        for i in range(LLAMA4_REQUESTS)]
    launches, line = _serve_moe(card, cfg, engine, reqs, LLAMA4_NEW_TOKENS,
                                "llama4")
    print("[14] llama4 " + json.dumps({
        "model": "llama4-scout-17b-a16e (random weights, bf16)",
        "n_layers": cfg.n_layers, "n_layers_published": full.n_layers,
        "reduced": "depth 48 -> 4 layers: ~108 B parameters (~217 GB in "
                   "bf16) do not fit one 80 GB card",
        "params": n_params, "init_peak_gb": init_peak,
        "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
        "shared_experts": cfg.moe.n_shared_experts, **line}))
    del params
    torch.cuda.empty_cache()
    return launches, line["pp_launches"]


def phase_moe_layer_card_vs_cpu(card):
    """One granite layer's ``moe_apply`` at fp32 on x MOE_LAYER_X from a
    numpy seed: the card's top-k expert sets equal the CPU's but for
    tokens whose k-th and (k+1)-th probabilities lie within MOE_TIE;
    given the card's routing, dispatch, the expert products and the
    combine on the card equal the CPU's within atol 1e-4 (the
    destinations exactly); the aux loss within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m")
    e = cfg.moe
    p = moe.moe_init(torch.Generator().manual_seed(7), cfg)
    pc = {k: v.cuda() for k, v in p.items()}
    x = torch.from_numpy(np.random.RandomState(8).randn(*MOE_LAYER_X)
                         .astype(np.float32))
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    cg, ci, ca = moe.route(p, cfg, xf)
    gg, gi, ga = moe.route(pc, cfg, xf.cuda())
    top = torch.softmax(xf @ p["router"], -1).topk(e.top_k + 1, -1).values
    near = (top[:, e.top_k - 1] - top[:, e.top_k]).abs() <= MOE_TIE
    differ = (ci.sort(-1).values != gi.cpu().sort(-1).values).any(-1)
    aux_err = abs(float(ca) - float(ga))
    gsz = moe.group_size_for(t)
    ng = t // gsz
    cap = moe._capacity(gsz, e.top_k, e.n_experts, e.capacity_factor)
    res = {}
    for name, dev, prm in (("cpu", "cpu", p), ("card", "cuda", pc)):
        buf, dest, g = moe.dispatch(
            xf.reshape(ng, gsz, d).to(dev),
            gg.reshape(ng, gsz, e.top_k).to(dev),
            gi.reshape(ng, gsz, e.top_k).to(dev), e.n_experts, cap)
        eout = moe.experts(prm, buf[:, :-1].reshape(ng, e.n_experts, cap,
                                                    d))
        res[name] = (dest.cpu(), moe.combine(eout, dest, g).cpu())
    torch.cuda.synchronize()
    err = float((res["card"][1] - res["cpu"][1]).abs().max())
    dropped = float((res["cpu"][0] == e.n_experts * cap).float().mean())
    print(f"[14] granite MoE layer fp32 x={MOE_LAYER_X} (one group of "
          f"{gsz}, capacity {cap}): top-{e.top_k} sets differ for "
          f"{int(differ.sum())} tokens, {int(near.sum())} tokens within "
          f"{MOE_TIE:g} of a tie at the k-th place; given the card's "
          f"routing: destinations equal "
          f"{torch.equal(res['cpu'][0], res['card'][0])}, drop share "
          f"{dropped:.4f}, out max_abs_err={err:.3e} atol=1e-4; aux "
          f"max_abs_err={aux_err:.3e} atol=1e-6 [{card}]")
    check(not bool((differ & ~near).any()),
          "a token's expert set differs on the card without a near-tie")
    check(torch.equal(res["cpu"][0], res["card"][0]),
          "dispatch destinations differ between the card and the CPU")
    check(err <= 1e-4, f"MoE layer card vs CPU: {err}")
    check(aux_err <= 1e-6, f"MoE aux loss card vs CPU: {aux_err}")


# ----------------------------------------------------------- zamba2 hybrid
def zamba2_requests(cfg):
    """ZAMBA2_PROMPTS batches of token ids in [3, vocab_size), seeded."""
    rs = np.random.RandomState(14)
    return [torch.as_tensor(rs.randint(3, cfg.vocab_size, size=(n, s)))
            for n, s in ZAMBA2_PROMPTS]


def phase_zamba2_serving(card):
    """zamba2-2.7b at full width, bf16, through ``transformer.prefill``
    and ``decode_step``.  Returns its SSD calls and flash launches (both
    prefills) and the config."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import transformer as T

    cfg = get_config("zamba2-2.7b")
    nc = cfg.n_layers // len(cfg.block_pattern)
    n_mamba = sum(k != "shared_attn" for k in cfg.block_pattern)
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(9), dtype=torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    warm = torch.randint(3, cfg.vocab_size, (2, 300), device="cuda")
    _, wc = T.prefill(params, cfg, warm, 304)
    T.decode_step(params, cfg, wc, warm[:, -1:], torch.full(
        (2,), 300, device="cuda"))
    del wc
    batches = [t.cuda() for t in zamba2_requests(cfg)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    per_batch, outs, ssd_calls, fa_launches = [], [], 0, 0
    for toks in batches:
        b, s = toks.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, s + ZAMBA2_DECODE_STEPS)
        nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        want = {"tc": nc * n_mamba, "fma": 0, "bwd": 0, "bwd_tc": 0,
                "bwd_fma": 0}
        check(_ssd_paths() == want, f"zamba2 bf16 prefill's SSD calls by "
              f"path are {_ssd_paths()}, not {want}")
        v = _variant_counts()
        check(fa.LAUNCHES == v["fwd_wgmma"] == nc and v["fwd_fma"] == 0,
              f"zamba2 prefill's flash launches {fa.LAUNCHES}, by kernel "
              f"{v}: not {nc} on fa_fwd_wgmma_kernel")
        check(pa.LAUNCHES == 0, "zamba2 prefill launched paged attention")
        ssd_calls += _ssd_count()
        fa_launches += fa.LAUNCHES
        _zero_counts()
        gen_toks, step_ms = [nxt], []
        for i in range(ZAMBA2_DECODE_STEPS):
            t0 = time.perf_counter()
            logits, cache = T.decode_step(params, cfg, cache, nxt,
                                          torch.full((b,), s + i,
                                                     device="cuda"))
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            gen_toks.append(nxt)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(_ssd_count() == 0 and all(n == 0 for n in
                                        _flash_counts().values())
              and pa.LAUNCHES == 0,
              "zamba2 decode launched an SSD, flash or paged kernel")
        _zero_counts()
        out = torch.cat(gen_toks, 1).cpu()
        outs.append(out)
        check(out.shape[1] == ZAMBA2_DECODE_STEPS + 1, "zamba2 decode "
              "length")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "zamba2: a token outside the vocabulary")
        st = np.asarray(step_ms)
        per_batch.append({
            "requests": b, "prompt_tokens": s, "prefill_s": pre_s,
            "prefill_tokens_per_s": b * s / pre_s,
            "kv_ring": int(cache["k"].shape[2]),
            "decode_steps": len(step_ms),
            "decode_step_ms_p50": float(np.percentile(st, 50)),
            "decode_step_ms_p90": float(np.percentile(st, 90))})
        del cache, logits
    print("[15] " + json.dumps({
        "card": card, "model": "zamba2-2.7b (random weights, bf16)",
        "params": n_params, "cycles": nc, "mamba_slots": n_mamba,
        "requests": sum(n for n, _ in ZAMBA2_PROMPTS), "batches": per_batch,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ssd_calls_per_prefill": nc * n_mamba,
        "flash_launches_per_prefill": nc,
        "first_tokens": [o[0, :8].tolist() for o in outs]}))
    phase_mamba_profile(cfg, params, card, batches[0], "zamba2",
                        "zamba2-2.7b")
    del params
    torch.cuda.empty_cache()
    return ssd_calls, fa_launches, cfg


def phase_zamba2_consistency(cfg, card):
    """Full width, fp32: decode_step after the 1000-token prefill gives the
    last logits of the 1001-token prefill (the 4096 ring is not reached,
    so the windowless forward and the ring decode agree)."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(10), dtype=torch.float32, device="cuda")
    toks = zamba2_requests(cfg)[1].cuda()
    extra = torch.randint(3, cfg.vocab_size, (toks.shape[0], 1),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(11), device="cuda")
    s = toks.shape[1]
    _, cache = T.prefill(params, cfg, toks, s + 1, cache_dtype=torch.float32)
    got, _ = T.decode_step(params, cfg, cache, extra,
                           torch.full((toks.shape[0],), s, device="cuda"))
    del cache
    want, _ = T.prefill(params, cfg, torch.cat([toks, extra], 1), s + 1,
                        cache_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[15] zamba2-2.7b fp32, decode after prefill of {s} tokens vs "
          f"prefill of {s + 1}: logits max_abs_err={err:.3e} "
          f"atol={MAMBA_CONSISTENCY_ATOL} (max |logit| "
          f"{float(want.abs().max()):.3f}) [{card}]")
    check(bool(torch.isfinite(got).all()), "zamba2: non-finite decode logits")
    check(err <= MAMBA_CONSISTENCY_ATOL, f"zamba2 decode vs prefill: {err}")
    del params
    torch.cuda.empty_cache()


def phase_card_vs_cpu(arch="smollm-135m", label="smollm"):
    """Reduced ``arch``, fp32: prefill_shared_paged and 8 teacher-forced
    decode_step_paged steps on the CPU and on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.paged_model import (decode_step_paged, make_pools,
                                               prefill_shared_paged)

    cfg = get_config(arch).reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         dtype=torch.float32, device="cpu")
    page, n_pages, maxp = 16, 32, 8
    plens = [5, 17, 16, 30, 0]                  # the last row is inactive
    b = len(plens)
    tables = torch.full((b, maxp), -1, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(plens):
        if n:
            need = -(-(n + 9) // page)
            tables[i, :need] = torch.arange(nxt, nxt + need)
            nxt += need
    rs = np.random.RandomState(3)
    toks = torch.zeros(b, 32, dtype=torch.int32)
    for i, n in enumerate(plens):
        toks[i, :n] = torch.as_tensor(rs.randint(0, cfg.vocab_size, n))
    lens = torch.tensor(plens, dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32)
    temps = torch.zeros(b)
    rids = torch.arange(1, b + 1, dtype=torch.int32)

    def to(tree, dev):
        return ({k: to(v, dev) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))

    runs = {}
    teacher = None
    for dev in ("cpu", "cuda"):
        _zero_counts()
        p = to(params, dev)
        pools = make_pools(cfg, n_pages, page, dtype=torch.float32,
                           device=dev)
        first = prefill_shared_paged(
            p, pools, toks.to(dev), lens.to(dev), zeros.to(dev),
            zeros.to(dev), tables.to(dev), 0, temps.to(dev),
            seq_ids=rids.to(dev), cfg=cfg, page_size=page)
        out, cur_lens = [first.cpu()], lens.to(dev)
        last = first if teacher is None else teacher[0].to(dev)
        for s in range(8):
            nt, cur_lens = decode_step_paged(
                p, pools, tables.to(dev), cur_lens, last, 0, temps.to(dev),
                seq_ids=rids.to(dev), cfg=cfg, page_size=page)
            out.append(nt.cpu())
            # teacher forcing: both devices feed the CPU's tokens
            last = nt if teacher is None else teacher[s + 1].to(dev)
        torch.cuda.synchronize()
        runs[dev] = (out, {k: v[:-1].cpu() for k, v in pools.items()})
        teacher = out
    from repro_torch.kernels.paged_attention import paged_attention as pa
    launches = pa.LAUNCHES                  # the card run's, float32
    check(launches == 8 * cfg.n_layers, f"the float32 decode launched "
          f"pa_decode_kernel {launches} times, not {8 * cfg.n_layers}")
    (ct, cp), (gt, gp) = runs["cpu"], runs["cuda"]
    live = [i for i, n in enumerate(plens) if n]
    for s, (a, g) in enumerate(zip(ct, gt)):
        check(bool((a[live] == g[live]).all()),
              f"greedy tokens differ at step {s}: {a} vs {g}")
    err = max(float((cp[k] - gp[k]).abs().max()) for k in ("k", "v"))
    print(f"[6] reduced {label} fp32, 8 teacher-forced decode steps: tokens "
          f"identical, pool max_abs_err={err:.3e} atol=1e-4; float32 ran "
          f"pa_decode_kernel {launches} times")
    check(err <= 1e-4, f"pools differ by {err}")


def time_ms(fn, reps, flush):
    """CUDA-event times of ``fn`` with L2 flushed before each call, after 3
    warm-up calls: (median, p10, p90) in ms.  The card spins for about a
    quarter of a millisecond between the flush and the first event, so the
    host has enqueued ``fn`` before the card reaches it: a slow host does
    not show up as device time."""
    times = []
    for _ in range(reps + 3):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(z))
    t = np.asarray(times[3:])
    return (float(np.median(t)), float(np.percentile(t, 10)),
            float(np.percentile(t, 90)))


def spread(t) -> str:
    """A (median, p10, p90) triple as printed by phase 7."""
    return f"{t[0]:.4f} (p10 {t[1]:.4f}, p90 {t[2]:.4f})"


def pa_device_ms(fn, reps, flush):
    """Per call, the device time of the paged-attention kernels from a
    ``torch.profiler`` trace of ``reps`` calls, each after an L2 flush:
    {kernel name: median ms}, their sum (each runs once a call), the count
    of pa_decode_kernel launches the trace holds and the trace's number.

    The tracer drops the first device events of a trace, more the longer
    the process has run (on the H100, 4 of 60 after one minute and 40
    after nine, by ``scripts/profile_drop_probe.py``).  So each trace
    opens with PROFILE_PAD_KERNELS empty spin kernels for it to drop, and
    up to three traces are taken until one holds every call; the one that
    holds the most is used, and it must hold at least half."""
    def calls():
        for _ in range(reps):
            flush.zero_()
            fn()

    best = None
    for attempt in range(1, 4):
        events, _, _ = _pad_and_trace(
            calls, [torch.profiler.ProfilerActivity.CUDA])
        per = {n: [] for n in PA_PROFILE_NAMES}
        for e in events or ():
            for n in PA_PROFILE_NAMES:
                if n in e.name:
                    per[n].append(
                        (e.time_range.end - e.time_range.start) / 1e3)
        n_traced = len(per["pa_decode_kernel"])
        if best is None or n_traced > best[1]:
            best = (per, n_traced, attempt)
        if n_traced == reps:
            break
    per, n_traced, attempt = best
    check(n_traced >= reps // 2,
          f"the best of three profiles of {reps} paged calls holds "
          f"{n_traced} pa_decode_kernel launches")
    medians = {n: float(np.median(v)) for n, v in per.items() if v}
    return medians, sum(medians.values()), n_traced, attempt


def host_us(fn, n=100):
    """Host microseconds per call of ``fn`` over ``n`` calls, no sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_timing(pa, ref, gen, card):
    """The paged kernel at the smollm decode shape (bf16 and float32) and
    at h2o-danube's (bf16), L2 flushed before each call: CUDA-event time,
    the kernels' device time from the profiler, the wrapper's host time,
    the plain version's time and the byte bound; then, in bf16 at both
    shapes, a sweep of pages_per_split and the ring depth.  Returns the
    timing of each (shape name, dtype)."""
    launches = pa.LAUNCHES            # timing launches are not main-path
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for name, shape, lens, dtypes in (
            ("main", MAIN_SHAPE, main_lens(16, 16, 64),
             (torch.float32, torch.bfloat16)),
            ("h2o", H2O_SHAPE, h2o_lens(), (torch.bfloat16,))):
        b, h, kh, d, page, maxp, n_pages = shape
        for dtype in dtypes:
            q, kp, vp, tab, ln = pa_inputs(shape, lens, dtype, gen)
            s = q.element_size()
            nbytes = (2 * q.numel() * s + sum(lens) * kh * d * 2 * s
                      + tab.numel() * 4 + ln.numel() * 4)

            def call():
                return pa.paged_attention(q, kp, vp, tab, ln)

            for _ in range(200):           # warm: clocks up, plan cached
                call()
            k_ms = time_ms(call, 50, flush)
            dev, dev_ms, n_traced, tries = pa_device_ms(call, 30, flush)
            h_us = host_us(call)
            p_ms = time_ms(lambda: ref(q, kp, vp, tab, ln), 20, flush)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            res[(name, dtype)] = (k_ms[0], p_ms[0], bound)
            pps = pa.plan(b, h, kh, maxp, page, _sms())
            print(f"[7] paged_attention {name} {str(dtype):14s} B={b} H={h} "
                  f"K={kh} D={d} page={page} maxp={maxp} "
                  f"sum(lens)={sum(lens)} pages_per_split={pps} splits="
                  f"{-(-maxp // pps)} stages={pa.STAGES}: "
                  f"kernel_ms={spread(k_ms)} device_ms={dev_ms:.4f} "
                  f"(profiler, {n_traced} of 30 calls in trace {tries}, by "
                  f"kernel {json.dumps(dev)}) host_us_per_call="
                  f"{h_us:.1f} plain_ms={spread(p_ms)} bound_ms={bound:.4f} "
                  f"(bytes {nbytes}; {bound / k_ms[0]:.1%} of the bound) "
                  f"[{card}]")
            if dtype == torch.bfloat16:
                for pps_s in PA_SWEEP_PAGES:
                    row = []
                    for st in PA_SWEEP_STAGES:
                        t = time_ms(lambda: pa.paged_attention(
                            q, kp, vp, tab, ln, pages_per_split=pps_s,
                            stages=st), 20, flush)
                        row.append(f"stages {st}: {t[0]:.4f}")
                    print(f"[7] paged sweep bf16 {name} pages_per_split="
                          f"{pps_s} (splits {-(-maxp // pps_s)}): "
                          + ", ".join(row) + f" ms [{card}]")
            del q, kp, vp, tab, ln
    pa.LAUNCHES = launches
    return res


def phase_prefill_timing(gen, card):
    """The paged prefill kernel (bf16) at PP_TIMING's shapes, L2 flushed
    before each call, warm: CUDA-event time, the operations bound (4 D H
    flops per visible pair over the tensor cores' 989 TFLOP/s; the bytes
    read are far below it) and the plain version's time.  Returns
    {shape name: (kernel ms, plain ms, bound ms)}."""
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    from repro_torch.kernels.paged_attention.ref import paged_prefill_ref
    launches = (pp.LAUNCHES, pp.WGMMA_LAUNCHES, pp.FMA_LAUNCHES)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for name, spec in PP_TIMING.items():
        args = pp_inputs(spec, torch.bfloat16, gen)
        pairs = pp_visible_pairs(spec, args[3])
        flops = 4 * spec["d"] * spec["h"] * pairs

        def call():
            return pp.paged_prefill(*args)

        for _ in range(20):                # warm: clocks up
            call()
        k_ms = time_ms(call, 50, flush)
        p_ms = time_ms(lambda: paged_prefill_ref(*args), 5, flush)
        bound = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        res[name] = (k_ms[0], p_ms[0], bound)
        print(f"[7] paged_prefill {name} bfloat16 N={len(spec['q_starts'])} "
              f"T={spec['t']} H={spec['h']} K={spec['kh']} D={spec['d']} "
              f"q_starts={spec['q_starts']} visible_pairs_per_head={pairs} "
              f"GFLOP={flops / 1e9:.2f}: kernel_ms={spread(k_ms)} "
              f"({flops / k_ms[0] / 1e9:.1f} TFLOP/s) plain_ms={spread(p_ms)} "
              f"bound_ms={bound:.4f} ({bound / k_ms[0]:.1%} of the bound) "
              f"[{card}]")
        del args
    # timing launches are not main-path
    pp.LAUNCHES, pp.WGMMA_LAUNCHES, pp.FMA_LAUNCHES = launches
    return res


def _pad_and_trace(work, acts):
    """One ``torch.profiler`` trace of ``work()`` led by the pad:
    PROFILE_PAD_KERNELS empty spin kernels, waited for, then the work,
    waited for.  Returns (the device events after the pad's last kernel,
    in start order, or None when no pad kernel survived the tracer's
    drop; the wall ms of ``work``; the names of the trace's first three
    device events)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    pads = [i for i, e in enumerate(events) if PAD_KERNEL in e.name]
    first = [e.name[:40] for e in events[:3]]
    return (events[pads[-1] + 1:] if pads else None), wall, first


def padded_trace(work, count, want, what):
    """``work()`` traced by ``torch.profiler`` (host and device), led by
    PROFILE_PAD_KERNELS empty spin kernels for the tracer to drop: it drops
    a trace's first device events, more the longer the process has run
    (``pa_device_ms``).  The pad and everything before its last kernel are
    dropped from what is returned, so no spin kernel counts in busy ms,
    kernels a call or the idle share.  ``count(kernels)`` counts a kernel
    that the traced work holds ``want`` times; the trace is taken again,
    up to three times, until a pad kernel survives and the count is
    ``want`` (the retake runs ``work`` again).  The best trace must hold
    all ``want``.  Returns (device events after the pad, the traced wall
    ms of ``work``, the count, the trace's number)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for attempt in range(1, 4):
        kernels, wall, first = _pad_and_trace(work, acts)
        n = -1 if kernels is None else count(kernels)
        if best is None or n > best[2]:
            best = (kernels or [], wall, n, attempt, first)
        if n == want:
            break
    kernels, wall, n, attempt, first = best
    check(n == want, f"{what}: the best of three padded traces (trace "
          f"{attempt}) holds {n} of {want} (-1: no pad kernel survived; "
          f"its first events {first})")
    return kernels, wall, n, attempt


def named(pattern):
    """Counter of the traced device events whose name matches."""
    rx = re.compile(pattern)
    return lambda kernels: sum(1 for e in kernels if rx.search(e.name))


def _union_ms(intervals):
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _profile_summary(kernels, steps):
    """Busy ms per step (union of the intervals) and {name: (ms, calls)}
    of a padded trace's device events."""
    check(bool(kernels), "profile: the trace holds no device kernel")
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels]) / steps
    by_name = {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + t, c + 1)
    return kernels, busy, by_name


def phase_decode_profile(cfg, params, card, model="smollm-135m"):
    """Fills every slot of the main path's engine (serving ``model``),
    steps past admission and prefill, times PROFILE_STEPS decode steps
    untraced, then traces as many more (``padded_trace``, which must hold
    n_layers x PROFILE_STEPS ``pa_decode_kernel`` launches, as LAUNCHES
    counts them).  The device's busy time per step is the union of the
    traced kernel intervals; its idle share is given against both the
    untraced and the traced step wall."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    _, eng = main_engine(cfg, params)
    rs = np.random.RandomState(0)
    for i in range(eng.max_batch):
        prompt = rs.randint(0, cfg.vocab_size,
                            size=int(rs.randint(64, 769))).tolist()
        eng.submit(prompt, max_new_tokens=8 + 4 * PROFILE_STEPS + 4,
                   **({"temperature": 0.8} if i % 2 else {}))
    for _ in range(8):                       # admission, prefill, warm-up
        eng.step()
    check(all(r is not None and r.prefill_pos < 0 for r in eng.slots),
          "profile: a slot is not decoding after the warm-up steps")
    walls = []
    for _ in range(PROFILE_STEPS):           # each step ends on its token copy
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    launched = []

    def steps():
        before = pa.LAUNCHES
        for _ in range(PROFILE_STEPS):
            eng.step()
        launched.append(pa.LAUNCHES - before)

    want = cfg.n_layers * PROFILE_STEPS
    kernels, wall, n_pa, trace = padded_trace(
        steps, named(r"pa_decode_kernel"), want,
        f"{model} paged decode steps")
    check(launched[-1] == want, f"profile: {launched[-1]} paged launches "
          f"in {PROFILE_STEPS} steps, not {want}")
    traced = wall / PROFILE_STEPS
    check(all(r is not None for r in eng.slots),
          "profile: a request finished inside the measured steps")
    kernels, busy, by_name = _profile_summary(kernels, PROFILE_STEPS)
    total = sum(t for t, _ in by_name.values())
    pa_ms = sum(t for n, (t, _) in by_name.items()
                if any(k in n for k in PA_PROFILE_NAMES))
    check(pa_ms > 0, f"profile: none of the paged-attention kernels "
          f"{PA_PROFILE_NAMES} is in the decode trace")
    untraced = float(np.mean(walls))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print("[8] decode " + json.dumps({
        "card": card, "model": f"{model} (random weights, bf16)",
        "batch": eng.max_batch, "steps": PROFILE_STEPS,
        "step_wall_ms_untraced_mean": untraced,
        "step_wall_ms_untraced_p50": float(np.percentile(walls, 50)),
        "step_wall_ms_untraced_p90": float(np.percentile(walls, 90)),
        "step_wall_ms_traced_mean": traced,
        "device_busy_ms_per_step": busy,
        "device_idle_share_untraced": 1 - busy / untraced,
        "device_idle_share_traced": 1 - busy / traced,
        "kernels_per_step": len(kernels) / PROFILE_STEPS,
        "trace": {"number": trace, "pa_decode_kernel": n_pa,
                  "want": want},
        "paged_attention_ms_per_step": pa_ms / PROFILE_STEPS,
        "paged_attention_share_of_kernel_time": pa_ms / total,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": t / PROFILE_STEPS,
             "calls": c / PROFILE_STEPS} for n, (t, c) in top]}))



# ------------------------------------------------------------ flash attention
def flash_inputs(case, dtype, gen, n=3):
    b, h, kh, sq, sk, d = case[:6]
    shapes = [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)]
    shapes += [(b, h, sq, d)] * (n - 3)
    return [torch.randn(*sh, generator=gen, device=gen.device).to(dtype)
            for sh in shapes]


def phase_flash_kernels(gen):
    """Forward, dq and dkv kernels vs the plain versions; returns the
    training shape's bf16 errors by kernel name."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref,
                                                         bf16_dkv_bound,
                                                         bf16_dq_bound)
    main_err = {}
    cases = ([(f"fa{i}", c, True, False) for i, c in enumerate(FA_CASES)]
             + [(f"bwd{i}", c, False, True) for i, c in enumerate(BWD_CASES)]
             + [("main", FA_MAIN, True, True)])
    for name, case, fwd, bwd in cases:
        causal, window = case[6], case[7]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(case, dtype, gen, n=4)
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
            errs = {}
            if fwd:
                want_o, want_lse = attention_ref(
                    q.float(), k.float(), v.float(), causal=causal,
                    window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(o).all()), f"{name} non-finite o")
                errs["o"] = float((o.float() - want_o).abs().max())
                errs["lse"] = float((lse - want_lse).abs().max())
                for key in ("o", "lse"):
                    check(errs[key] <= ATOL[dtype],
                          f"forward {name} {dtype} {key}: {errs[key]}")
                del want_o, want_lse
            if bwd:
                got = fab.flash_attention_bwd(q, k, v, o, do, lse,
                                              causal=causal, window=window)
                f32 = [t.float() for t in (q, k, v, o, do)]
                want = attention_bwd_ref(*f32, lse, causal=causal,
                                         window=window)
                kw = dict(causal=causal, window=window)
                bounds = ([torch.full_like(w, GRAD_ATOL) for w in want]
                          if dtype == torch.float32 else
                          [bf16_dq_bound(*f32, lse, **kw),
                           *bf16_dkv_bound(*f32, lse, **kw)])
                torch.cuda.synchronize()
                for key, g, w, bound in zip(("dq", "dk", "dv"), got, want,
                                            bounds):
                    check(bool(torch.isfinite(g).all()),
                          f"{name} non-finite {key}")
                    diff = (g.float() - w).abs()
                    errs[key] = float(diff.max())
                    share = float((diff / bound).max())
                    errs[f"{key}/bound"] = share
                    check(share <= 1, f"backward {name} {dtype} {key}: "
                          f"max_abs_err {errs[key]}, {share:.3f} of its "
                          "bound")
                del got, want, bounds, f32
            print(f"[3] flash {name:5s} {str(dtype):14s} D={case[5]} "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
            if name == "main" and dtype == torch.bfloat16:
                main_err = {"flash_attention_fwd": errs["o"],
                            "flash_attention_dq": errs["dq"],
                            "flash_attention_dkv": max(errs["dk"],
                                                       errs["dv"])}
    for h, kh in ((2, 2), (4, 2)):           # as test_mha_fused_custom_vjp
        q, k, v = (t.requires_grad_(True) for t in flash_inputs(
            (1, h, kh, 128, 128, 64), torch.float32, gen))
        g1 = torch.autograd.grad((ops.mha_fused(q, k, v) ** 2).sum(),
                                 (q, k, v))
        g2 = torch.autograd.grad((attention_ref(q, k, v)[0] ** 2).sum(),
                                 (q, k, v))
        err = max(float((a - b).abs().max()) for a, b in zip(g1, g2))
        print(f"[3] mha_fused grad H={h} K={kh} vs autograd of the plain "
              f"forward: max_abs_err={err:.3e} atol=1e-3")
        check(err <= 1e-3, f"mha_fused gradient H={h} K={kh}: {err}")
    # whisper's training cross-attention: non-causal, Sq != Sk, the
    # backward fed the non-causal forward's lse
    q, k, v = (t.requires_grad_(True) for t in flash_inputs(
        WHISPER_CROSS_FA, torch.float32, gen))
    g1 = torch.autograd.grad((ops.mha_fused(q, k, v, False) ** 2).sum(),
                             (q, k, v))
    g2 = torch.autograd.grad(
        (attention_ref(q, k, v, causal=False)[0] ** 2).sum(), (q, k, v))
    err = max(float((a - b).abs().max()) for a, b in zip(g1, g2))
    print(f"[3] mha_fused grad at whisper's cross shape "
          f"{WHISPER_CROSS_FA[:6]} non-causal vs autograd of the plain "
          f"forward: max_abs_err={err:.3e} atol=1e-3")
    check(err <= 1e-3, f"mha_fused gradient at the cross shape: {err}")
    del q, k, v, g1, g2
    return main_err


def _flash_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_dq": fab.DQ_LAUNCHES,
            "flash_attention_dkv": fab.DKV_LAUNCHES}


def _variant_counts():
    """Launches of the forward, dq and dkv kernels by variant: the
    tensor-core bf16 kernels and the float32 FMA ones."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    return {"fwd_wgmma": fa.WGMMA_LAUNCHES, "fwd_fma": fa.FMA_LAUNCHES,
            "dq_wgmma": fab.DQ_WGMMA_LAUNCHES, "dq_fma": fab.DQ_FMA_LAUNCHES,
            "dkv_wgmma": fab.DKV_WGMMA_LAUNCHES,
            "dkv_fma": fab.DKV_FMA_LAUNCHES}


def _zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    from repro_torch.kernels.ssd import ssd
    pa.LAUNCHES = fa.LAUNCHES = fab.DQ_LAUNCHES = fab.DKV_LAUNCHES = 0
    pp.LAUNCHES = pp.WGMMA_LAUNCHES = pp.FMA_LAUNCHES = 0
    fa.WGMMA_LAUNCHES = fa.FMA_LAUNCHES = 0
    fab.DQ_WGMMA_LAUNCHES = fab.DQ_FMA_LAUNCHES = 0
    fab.DKV_WGMMA_LAUNCHES = fab.DKV_FMA_LAUNCHES = 0
    ssd.LAUNCHES = ssd.TC_LAUNCHES = ssd.FMA_LAUNCHES = 0
    ssd.BWD_LAUNCHES = ssd.BWD_TC_LAUNCHES = ssd.BWD_FMA_LAUNCHES = 0


def _pp_count():
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    return pp.LAUNCHES


def _ssd_count():
    from repro_torch.kernels.ssd import ssd
    return ssd.LAUNCHES


def _ssd_paths():
    """SSD calls by path: the bf16 tensor-core kernels, the float32 FMA
    kernel, and the backward, in all and by path (bf16: tensor cores,
    float32: FMA)."""
    from repro_torch.kernels.ssd import ssd
    return {"tc": ssd.TC_LAUNCHES, "fma": ssd.FMA_LAUNCHES,
            "bwd": ssd.BWD_LAUNCHES, "bwd_tc": ssd.BWD_TC_LAUNCHES,
            "bwd_fma": ssd.BWD_FMA_LAUNCHES}


def phase_train(card):
    """The training main path.  Returns its flash-attention launches by
    kernel, the trainer (for the profile) and its timed step function."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg = get_config("smollm-135m")
    b, s = FA_MAIN[0], FA_MAIN[3]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr = Trainer(cfg, ShapeConfig("chip_smoke_train", "train", s, b),
                     TrainConfig(steps=TRAIN_STEPS, log_every=1,
                                 ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt,
                                 fail_at_step=TRAIN_FAIL_AT, seed=0,
                                 compute_dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 opt=AdamWConfig(warmup_steps=5,
                                                 total_steps=TRAIN_STEPS)),
                     device="cuda")
        step_fn, step_ms = tr.step_fn, []

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr.step_fn = timed
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        res = tr.run()
        torch.cuda.synchronize()
        launches = _flash_counts()
        variants = _variant_counts()
        pa_launches = pa.LAUNCHES
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [m["loss"] for m in tr.metrics_log]
    runs = len(step_ms)
    restored = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    check(res["restarts"] == 1, f"restarts {res['restarts']} != 1")
    check(res["final_step"] == TRAIN_STEPS,
          f"final_step {res['final_step']} != {TRAIN_STEPS}")
    check(runs == len(losses) == TRAIN_FAIL_AT + TRAIN_STEPS - restored,
          f"{runs} steps run, {len(losses)} logged; expected "
          f"{TRAIN_FAIL_AT + TRAIN_STEPS - restored}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    for name, n in launches.items():
        check(n == cfg.n_layers * runs,
              f"{name} launches {n} != {cfg.n_layers} x {runs} steps")
    want = cfg.n_layers * runs              # bf16 compute: tensor cores
    check(variants == {"fwd_wgmma": want, "fwd_fma": 0, "dq_wgmma": want,
                       "dq_fma": 0, "dkv_wgmma": want, "dkv_fma": 0},
          f"the bf16 Trainer's flash launches by kernel are {variants}, "
          f"not {want} tensor-core and 0 FMA each")
    check(pa_launches == 0, "the training path launched paged attention")
    st = np.asarray(step_ms)
    print("[5] " + json.dumps({
        "card": card, "model": "smollm-135m (random weights, fp32 masters, "
        "bf16 compute)", "seq_len": s, "batch": b,
        "steps": TRAIN_STEPS, "steps_run": runs, "restarts": res["restarts"],
        "restored_from_step": restored, "wall_s": res["wall_s"],
        "step_ms_p50": float(np.percentile(st, 50)),
        "step_ms_p90": float(np.percentile(st, 90)),
        "step_ms_first": float(st[0]),
        "tokens_per_s": b * s / float(np.percentile(st, 50)) * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches, "launches_by_kernel": variants}))
    return launches, tr, step_fn


def phase_train_card_vs_cpu(arch="smollm-135m", label="smollm", remat="none",
                            compress=False):
    """Reduced ``arch``, fp32, TF32 off: 3 Trainer steps on each device from
    the same weights (drawn on the CPU for a seed) and the same data (an
    encoder-decoder's frames included), with ``remat`` and, if
    ``compress``, int8 gradient compression with error feedback.  Params
    are held to 2 x the summed learning rates plus 1e-6: AdamW's m /
    sqrt(v) turns a last-bit difference in the sign of a near-zero
    gradient into an update of +lr instead of -lr.  The forward launches
    once per attention a step (an encoder-decoder's encoder, decoder and
    cross attention), and once more per decoder attention under a remat
    policy, which recomputes the layer body in the backward; dq and dkv
    once per attention.  A mamba or hybrid model's SSD forward runs on the
    float32 FMA kernel once per mamba layer a step, and its backward
    kernel as often."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.services.compression import (CompressionConfig,
                                                       GradCompression)
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg = get_config(arch).reduced()
    runs = {}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for dev in ("cpu", "cuda"):
            comp = (GradCompression(CompressionConfig(
                bits=8, error_feedback=True)) if compress else None)
            t = Trainer(cfg, ShapeConfig("t", "train", 128, 2), TrainConfig(
                steps=3, log_every=1, ckpt_every=0, seed=4, ckpt_dir=ckpt,
                remat=remat, compression=comp), device=dev)
            _zero_counts()
            t.run()
            variants = _variant_counts()
            ssd_paths = _ssd_paths()
            runs[dev] = ([m["loss"] for m in t.metrics_log],
                         {k: v.detach().cpu() for k, v in
                          adamw.flatten(t.params).items()},
                         sum(m["lr"] for m in t.metrics_log))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    n_mamba = sum(k == "mamba" for k in cfg.layer_kinds())
    dec = ((cfg.n_layers - n_mamba)
           * (2 if cfg.n_encoder_layers else 1))
    att = cfg.n_encoder_layers + dec        # attentions a step
    fwd = 3 * (att + (dec if remat != "none" else 0))
    want = 3 * att                          # float32: the FMA kernels
    check(variants == {"fwd_wgmma": 0, "fwd_fma": fwd, "dq_wgmma": 0,
                       "dq_fma": want, "dkv_wgmma": 0, "dkv_fma": want},
          f"the float32 {label} Trainer's flash launches by kernel are "
          f"{variants}, not 0 tensor-core and {fwd} forward, {want} dq and "
          f"{want} dkv FMA")
    ssd_want = {"tc": 0, "fma": 3 * n_mamba * (2 if remat != "none" else 1),
                "bwd": 3 * n_mamba, "bwd_tc": 0, "bwd_fma": 3 * n_mamba}
    check(ssd_paths == ssd_want, f"the float32 {label} Trainer's SSD "
          f"launches by path are {ssd_paths}, not {ssd_want}")
    (cl, cp, lr_sum), (gl, gp, _) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(cl, gl))
    p_err = max(float((cp[k] - gp[k]).abs().max()) for k in cp)
    p_tol = 2 * lr_sum + 1e-6
    print(f"[6] reduced {label} fp32, 3 Trainer steps (remat={remat}, "
          f"compression={'int8+ef' if compress else 'off'}): loss "
          f"max_abs_err={loss_err:.3e} atol=1e-4, params max_abs_err="
          f"{p_err:.3e} atol={p_tol:.3e}; card launches by kernel "
          f"{variants}, SSD {ssd_paths}")
    check(loss_err <= 1e-4, f"losses differ: {cl} vs {gl}")
    check(p_err <= p_tol, f"params differ by {p_err}")


def _causal_pairs(sq, sk, causal):
    """(query, key) pairs that the causal mask leaves visible."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def phase_flash_timing(gen, card):
    """Each flash kernel at the training shape, bf16 (tensor-core forward
    and dkv) and fp32 (FMA): its time, its bound, the plain version's time
    and the library yardsticks (``scaled_dot_product_attention`` forward,
    and its backward alone, autograd of a saved forward: dq, dk and dv in
    one call; never on the port's path)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    b, h, kh, sq, sk, d, causal, window = FA_MAIN
    pairs = _causal_pairs(sq, sk, causal) * b * h
    flops = {"flash_attention_fwd": 4 * d * pairs,      # q k^T, p v
             "flash_attention_dq": 6 * d * pairs,       # q k^T, do v^T, ds k
             "flash_attention_dkv": 8 * d * pairs}      # + p^T do, ds^T q
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = flash_inputs(FA_MAIN, dtype, gen, n=4)
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        _, delta = fab.flash_attention_dq(q, k, v, o, do, lse)
        e = q.element_size()
        nq, nk, nl = q.numel() * e, k.numel() * e, lse.numel() * 4
        nbytes = {"flash_attention_fwd": 2 * nq + 2 * nk + nl,
                  "flash_attention_dq": 4 * nq + 2 * nk + 2 * nl,
                  "flash_attention_dkv": 2 * nq + 4 * nk + 2 * nl}
        calls = {
            "flash_attention_fwd":
                lambda: fa.flash_attention(q, k, v, return_lse=True),
            "flash_attention_dq":
                lambda: fab.flash_attention_dq(q, k, v, o, do, lse),
            "flash_attention_dkv":
                lambda: fab.flash_attention_dkv(q, k, v, do, lse, delta)}
        k_ms = {n: time_ms(fn, 20, flush) for n, fn in calls.items()}
        plain_fwd = time_ms(lambda: attention_ref(q, k, v), 5, flush)
        plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, lse),
                            5, flush)
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                  enable_gqa=True)

        lib_fwd = time_ms(sdpa, 20, flush)
        saved = sdpa()
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            saved, (qg, kg, vg), do, retain_graph=True), 20, flush)
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qg, kg, vg), do), 20, flush)
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_dq": plain_bwd,
                 "flash_attention_dkv": plain_bwd}
        res[dtype] = {}
        for n in calls:
            t_ops = flops[n] / PEAK_FLOPS[dtype] * 1e3
            t_bytes = nbytes[n] / HBM_BYTES_PER_S * 1e3
            res[dtype][n] = {
                "ms": k_ms[n][0], "plain_ms": plain[n][0],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_fwd[0] if n == "flash_attention_fwd"
                else None}
            print(f"[7] {n} {str(dtype):14s} B={b} H={h} K={kh} S={sq} "
                  f"D={d} causal: kernel_ms={spread(k_ms[n])} "
                  f"plain_ms={spread(plain[n])} bound_ms="
                  f"{res[dtype][n]['bound_ms']:.4f} (flops {flops[n]}, "
                  f"bytes {nbytes[n]}; "
                  f"{flops[n] / k_ms[n][0] / 1e9:.1f} TFLOP/s) [{card}]")
        print(f"[7] flash library yardstick {str(dtype):14s}: "
              f"scaled_dot_product_attention fwd_ms={spread(lib_fwd)} "
              f"bwd_ms={spread(lib_bwd)} (dq, dk, dv in one call) "
              f"fwd+bwd_ms={spread(lib_fwd_bwd)}; plain backward (dq, dk, "
              f"dv in one call) ms={spread(plain_bwd)} [{card}]")
        del q, k, v, do, o, lse, delta, qg, kg, vg, saved
    return res


def train_trace(tr, step_fn, steps, want, what):
    """``steps`` more steps of a warm trainer in one padded trace, held to
    ``want`` bf16 forward launches; returns the trace's readings a step:
    busy ms, kernels, the flash kernels' ms and the top kernels."""
    from repro_torch.data.pipeline import to_device
    batches = [to_device(tr.corpus.batch(1000 + i), "cuda")
               for i in range(steps)]

    def run():
        for batch in batches:
            tr.params, tr.opt_state, _ = step_fn(tr.params, tr.opt_state,
                                                 batch)

    kernels, wall, n_fwd, trace = padded_trace(
        run, named(r"fa_fwd_wgmma_kernel"), want, what)
    kernels, busy, by_name = _profile_summary(kernels, steps)
    total = sum(t for t, _ in by_name.values())
    fa_ms = {key: sum(t for n, (t, _) in by_name.items() if key in n)
             for key in ("fa_fwd", "fa_dq", "fa_dkv")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    traced = wall / steps
    return {
        "steps": steps, "step_wall_ms_traced_mean": traced,
        "device_busy_ms_per_step": busy,
        "device_idle_share_traced": 1 - busy / traced,
        "kernels_per_step": len(kernels) / steps,
        "trace": {"number": trace, "fa_fwd_wgmma_kernel": n_fwd,
                  "want": want},
        "flash_ms_per_step": {k: v / steps for k, v in fa_ms.items()},
        "flash_share_of_kernel_time": sum(fa_ms.values()) / total,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": t / steps, "calls": c / steps}
            for n, (t, c) in top]}


def phase_train_profile(tr, step_fn, card):
    """TRAIN_PROFILE_STEPS training steps of the main path's trainer timed
    untraced, then as many traced (``train_trace``: 30 bf16 forward
    launches a step)."""
    from repro_torch.data.pipeline import to_device
    walls = []                                # the trainer is warm
    torch.cuda.synchronize()
    for i in range(TRAIN_PROFILE_STEPS):
        batch = to_device(tr.corpus.batch(1000 + i), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.params, tr.opt_state, _ = step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = train_trace(tr, step_fn, TRAIN_PROFILE_STEPS,
                       tr.cfg.n_layers * TRAIN_PROFILE_STEPS,
                       "training steps")
    untraced = float(np.mean(walls))
    print("[8] train " + json.dumps({
        "card": card, "model": "smollm-135m (random weights, fp32 masters, "
        "bf16 compute)", "seq_len": FA_MAIN[3], "batch": FA_MAIN[0],
        "step_wall_ms_untraced_mean": untraced,
        "step_wall_ms_untraced_p50": float(np.percentile(walls, 50)),
        "device_idle_share_untraced":
            1 - prof["device_busy_ms_per_step"] / untraced, **prof}))


# ---------------------------------------------------------------------- SSD
def ssd_inputs(case, dtype, gen, init=False):
    """Random SSD scan inputs on the card, dt after softplus and A < 0."""
    b, s, h, p, g, n = case[:6]
    dev = gen.device
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev))
    a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.5)
    bm = (torch.randn(b, s, g, n, generator=gen, device=dev) * 0.3).to(dtype)
    c = (torch.randn(b, s, g, n, generator=gen, device=dev) * 0.3).to(dtype)
    st = (torch.randn(b, h, p, n, generator=gen, device=dev) if init
          else None)
    return x, dt, a, bm, c, st


def phase_ssd_kernels(gen):
    """The SSD kernel vs ``ref.ssd_chunked`` on the same inputs; returns the
    main shape's bf16 error."""
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.kernels.ssd.ssd import ssd_scan
    cases = ([(f"ssd{i}", c, False) for i, c in enumerate(SSD_CASES)]
             + [("init", SSD_CASES[1], True), ("ragged", SSD_RAGGED, False),
                ("raginit", SSD_RAGGED, True), ("main", SSD_MAIN, False),
                ("zamba2", SSD_ZAMBA2, False),
                ("zragged", SSD_ZAMBA2_RAGGED, False)])
    main_err = None
    for name, case, init in cases:
        chunk = case[6]
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, c, st0 = ssd_inputs(case, dtype, gen, init)
            before = _ssd_paths()
            y, st = ssd_scan(x, dt, a, bm, c, chunk=chunk, init_state=st0)
            tc = dtype == torch.bfloat16
            check(_ssd_paths() == dict(before, tc=before["tc"] + tc,
                                       fma=before["fma"] + (not tc)),
                  f"ssd {name} {dtype} took the wrong path")
            wy, wst = ssd_chunked(x.float(), dt, a, bm.float(), c.float(),
                                  chunk=chunk, init_state=st0)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                  f"ssd {name} non-finite")
            dy, ds = (y.float() - wy).abs(), (st - wst).abs()
            ey, es = float(dy.max()), float(ds.max())
            excess = max(
                float((dy - SSD_ATOL - SSD_RTOL[dtype] * wy.abs()).max()),
                float((ds - SSD_ATOL - SSD_RTOL[torch.float32]
                       * wst.abs()).max()))
            print(f"[3] ssd {name:7s} {str(dtype):14s} B={case[0]} "
                  f"S={case[1]} H={case[2]} P={case[3]} G={case[4]} "
                  f"N={case[5]} L={chunk}: y max_abs_err={ey:.3e} state "
                  f"max_abs_err={es:.3e} (atol {SSD_ATOL} + rtol "
                  f"{SSD_RTOL[dtype]:g} on y, "
                  f"{SSD_RTOL[torch.float32]:g} on the state; max |y| "
                  f"{float(wy.abs().max()):.2f}, max |state| "
                  f"{float(wst.abs().max()):.2f})")
            check(excess <= 0,
                  f"ssd kernel vs plain {name} {dtype}: y {ey}, state {es}")
            if name == "main" and dtype == torch.bfloat16:
                main_err = max(ey, es)
            del x, dt, bm, c, y, st, wy, wst, dy, ds
    return main_err


def ssd_bwd_limits(want, dtype):
    """Per gradient (dx, ddt, dA, dB, dC, dinit) the elementwise limit of
    the kernel's error against the plain version (the comment above
    SSD_BWD_SOURCE)."""
    out = []
    for nm, w in zip(SSD_BWD_NAMES, want):
        w = w.float().abs()
        if nm in ("dx", "dinit"):
            rt = SSD_RTOL[dtype if nm == "dx" else torch.float32]
            out.append(SSD_ATOL + rt * w)
        else:
            own = (SSD_RTOL[dtype] * w if dtype == torch.bfloat16
                   and nm in ("dB", "dC") else 0.0)
            out.append(SSD_ATOL + own
                       + SSD_RTOL[torch.float32] * float(w.max()))
    return out


def phase_ssd_bwd_kernels(gen):
    """The SSD backward kernel vs ``ref.ssd_chunked_bwd`` on the same
    inputs (a random dy, and with an initial state a random dfinal_state),
    at ``ssd_bwd_limits``; returns the largest error of the bf16 main
    training shape's six gradients."""
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd
    from repro_torch.kernels.ssd.ssd import ssd_scan_bwd
    cases = ([(f"ssd{i}", c, False) for i, c in enumerate(SSD_CASES)]
             + [("init", SSD_CASES[1], True), ("rinit", SSD_CASES[3], True),
                ("ragged", SSD_RAGGED, False),
                ("raginit", SSD_RAGGED, True), ("mamba2", SSD_MAIN, False),
                ("main", SSD_TRAIN_MAMBA2, False),
                ("zamba2", SSD_TRAIN_ZAMBA2, False),
                ("zragged", SSD_ZAMBA2_RAGGED, True)])
    main_err = None
    for name, case, init in cases:
        chunk = case[6]
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, c, st0 = ssd_inputs(case, dtype, gen, init)
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            dfin = (torch.randn(st0.shape, generator=gen, device="cuda")
                    if init else None)
            before = _ssd_paths()
            got = ssd_scan_bwd(x, dt, a, bm, c, dy, chunk=chunk,
                               init_state=st0, dfinal_state=dfin)
            tc = dtype == torch.bfloat16
            check(_ssd_paths() == dict(before, bwd=before["bwd"] + 1,
                                       bwd_tc=before["bwd_tc"] + tc,
                                       bwd_fma=before["bwd_fma"] + (not tc)),
                  f"ssd_bwd {name} {dtype}: not one backward launch on "
                  f"its dtype's path")
            want = ssd_chunked_bwd(x.float(), dt, a, bm.float(), c.float(),
                                   dy.float(), chunk=chunk, init_state=st0,
                                   dfinal_state=dfin)
            torch.cuda.synchronize()
            errs, excess = {}, -1.0
            for nm, g, w, lim in zip(SSD_BWD_NAMES, got, want,
                                     ssd_bwd_limits(want, dtype)):
                check(bool(torch.isfinite(g).all()),
                      f"ssd_bwd {name} {dtype}: non-finite {nm}")
                d = (g.float() - w.float()).abs()
                errs[nm] = float(d.max())
                excess = max(excess, float((d - lim).max()))
            print(f"[3] ssd_bwd {name:7s} {str(dtype):14s} B={case[0]} "
                  f"S={case[1]} H={case[2]} P={case[3]} G={case[4]} "
                  f"N={case[5]} L={chunk} init={init}: max_abs_err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (atol {SSD_ATOL}; dx, dinit rtol "
                  f"{max(SSD_RTOL[dtype], SSD_RTOL[torch.float32]):g}; ddt, "
                  f"dA, dB, dC {SSD_RTOL[torch.float32]:g} of their largest "
                  f"|value|"
                  + (f", dB, dC also rtol {SSD_RTOL[dtype]:g}"
                     if dtype == torch.bfloat16 else "")
                  + f"); worst excess over the limit {excess:.3e}")
            check(excess <= 0, f"ssd_bwd kernel vs plain {name} {dtype}: "
                  f"{errs}")
            if name == "main" and dtype == torch.bfloat16:
                main_err = max(errs.values())
            del x, dt, bm, c, dy, got, want
    torch.cuda.empty_cache()
    return main_err


def mamba_requests(cfg):
    """MAMBA_PROMPTS batches of token ids in [3, vocab_size), seeded."""
    rs = np.random.RandomState(0)
    return [torch.as_tensor(rs.randint(3, cfg.vocab_size, size=(n, s)))
            for n, s in MAMBA_PROMPTS]


def phase_mamba_serving(card):
    """The mamba serving main path.  Returns its SSD launches, config and
    bf16 weights (for the profile)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2-1.3b")
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), dtype=torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    # warm-up: cuBLAS handles, the kernel library, the allocator
    warm = torch.randint(3, cfg.vocab_size, (2, 300), device="cuda")
    _, wc = T.prefill(params, cfg, warm, 300)
    T.decode_step(params, cfg, wc, warm[:, -1:], None)
    del wc
    batches = [t.cuda() for t in mamba_requests(cfg)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    per_batch, outs, prefill_launches, decode_launches = [], [], [], 0
    for toks in batches:
        b, s = toks.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, s + MAMBA_DECODE_STEPS)
        nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        prefill_launches.append(_ssd_count())
        check(_ssd_paths() == {"tc": cfg.n_layers, "fma": 0, "bwd": 0,
                               "bwd_tc": 0, "bwd_fma": 0},
              f"the bf16 prefill's SSD calls by path are {_ssd_paths()}, "
              f"not {cfg.n_layers} tensor-core, 0 FMA and 0 backward")
        _zero_counts()
        gen_toks, step_ms = [nxt], []
        for i in range(MAMBA_DECODE_STEPS):
            t0 = time.perf_counter()
            logits, cache = T.decode_step(params, cfg, cache, nxt,
                                          torch.full((b,), s + i,
                                                     device="cuda"))
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            gen_toks.append(nxt)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        decode_launches += _ssd_count()
        _zero_counts()
        out = torch.cat(gen_toks, 1).cpu()
        outs.append(out)
        st = np.asarray(step_ms)
        per_batch.append({
            "requests": b, "prompt_tokens": s, "prefill_s": pre_s,
            "prefill_tokens_per_s": b * s / pre_s,
            "decode_steps": len(step_ms),
            "decode_step_ms_p50": float(np.percentile(st, 50)),
            "decode_step_ms_p90": float(np.percentile(st, 90)),
            "decode_tokens_per_s": b / float(np.percentile(st, 50)) * 1e3})
        del cache, logits
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.paged_attention import paged_attention as pa
    check(pa.LAUNCHES == fa.LAUNCHES == fab.DQ_LAUNCHES
          == fab.DKV_LAUNCHES == 0,
          "the mamba path launched paged or flash attention")
    for out in outs:
        check(out.shape[1] == MAMBA_DECODE_STEPS + 1, "decode length")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "a token outside the vocabulary")
    check(prefill_launches == [cfg.n_layers] * len(batches),
          f"SSD launches per prefill call {prefill_launches} != "
          f"{cfg.n_layers}")
    check(decode_launches == 0, f"decode launched the SSD kernel "
          f"{decode_launches} times")
    print("[9] " + json.dumps({
        "card": card, "model": "mamba2-1.3b (random weights, bf16)",
        "params": n_params, "requests": sum(n for n, _ in MAMBA_PROMPTS),
        "batches": per_batch, "max_memory_allocated_gb": peak,
        "ssd_launches_per_prefill": prefill_launches,
        "ssd_launches_in_decode": decode_launches,
        "first_tokens": [o[0, :8].tolist() for o in outs]}))
    return sum(prefill_launches), cfg, params


def _leaves(tree):
    if isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def phase_mamba_consistency(cfg, card):
    """Full width, fp32 weights: decode_step after prefill of the 1000-token
    prompts gives the logits of prefill over the 1001 tokens."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(1), dtype=torch.float32, device="cuda")
    toks = mamba_requests(cfg)[1].cuda()
    extra = torch.randint(3, cfg.vocab_size, (toks.shape[0], 1),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(2), device="cuda")
    s = toks.shape[1]
    _, cache = T.prefill(params, cfg, toks, s + 1, cache_dtype=torch.float32)
    got, _ = T.decode_step(params, cfg, cache, extra,
                           torch.full((toks.shape[0],), s, device="cuda"))
    del cache
    want, _ = T.prefill(params, cfg, torch.cat([toks, extra], 1), s + 1,
                        cache_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[9] mamba2-1.3b fp32, decode after prefill of {s} tokens vs "
          f"prefill of {s + 1}: logits max_abs_err={err:.3e} "
          f"atol={MAMBA_CONSISTENCY_ATOL} (max |logit| "
          f"{float(want.abs().max()):.3f}) [{card}]")
    check(bool(torch.isfinite(got).all()), "non-finite decode logits")
    check(err <= MAMBA_CONSISTENCY_ATOL, f"decode vs prefill: {err}")


def _cache_leaves(cache, prefix=""):
    """{path: tensor on the CPU} of a dense decode cache."""
    if isinstance(cache, dict):
        return {p: v for k, sub in cache.items()
                for p, v in _cache_leaves(sub, f"{prefix}{k}/").items()}
    return {prefix[:-1]: cache.cpu()}


def phase_mamba_card_vs_cpu(arch="mamba2-1.3b", label="mamba2"):
    """Reduced ``arch`` (mamba2, the zamba2 hybrid or the whisper
    encoder-decoder, given seeded frames), fp32: prefill and 8
    teacher-forced decode steps from the same weights on the CPU (plain
    scan and attention) and the card (the SSD and flash kernels)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                           dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(3)
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, size=(3, 53)))
    frames = (torch.as_tensor(rs.randn(3, cfg.encoder_seq_len, cfg.d_model)
                              .astype(np.float32))
              if cfg.n_encoder_layers else None)
    s = 45
    runs = {}
    for dev in ("cpu", "cuda"):
        p = ssm.cast(params, dev, torch.float32)
        logits, cache = T.prefill(
            p, cfg, toks[:, :s].to(dev), 53, cache_dtype=torch.float32,
            encoder_frames=None if frames is None else frames.to(dev))
        out = [logits.cpu()]
        for t in range(s, 53):
            logits, cache = T.decode_step(p, cfg, cache,
                                          toks[:, t:t + 1].to(dev),
                                          torch.full((3,), t, device=dev))
            out.append(logits.cpu())
        runs[dev] = (out, _cache_leaves(cache))
    (cl, cc), (gl, gc) = runs["cpu"], runs["cuda"]
    v = cfg.vocab_size
    for i, (a, g) in enumerate(zip(cl, gl)):
        check(torch.equal(a[:, :v].argmax(-1), g[:, :v].argmax(-1)),
              f"{label} greedy tokens differ at step {i}")
    lerr = max(float((a - g).abs().max()) for a, g in zip(cl, gl))
    cerr = max(float((cc[k] - gc[k]).abs().max()) for k in cc)
    print(f"[6] reduced {label} fp32, prefill + 8 teacher-forced decode "
          f"steps: tokens identical, logits max_abs_err={lerr:.3e}, caches "
          f"({', '.join(sorted(cc))}) max_abs_err={cerr:.3e} atol=1e-4")
    check(lerr <= 1e-4 and cerr <= 1e-4,
          f"{label} card vs cpu: {lerr} {cerr}")


def ssd_flops_bytes(case, dtype):
    """Visible work of the SSD scan (the lower triangles of C B^T and of
    the scores times x, the off-diagonal C . state and the state update,
    per chunk of real positions) and its least traffic (x, B, C, dt read
    once, y and the final state written once)."""
    b, s, h, p, g, n, chunk = case
    flops = 0
    for c0 in range(0, s, chunk):
        m = min(chunk, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (n + p) + 4 * m * p * n
    flops *= b * h
    e = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * h * p * e + 2 * b * s * g * n * e + b * s * h * 4
              + h * 4 + b * h * p * n * 4)
    return flops, nbytes


def phase_ssd_timing(gen, card):
    """The SSD kernel at the main prefill shape, L2 flushed: its time, its
    bound and its plain version's time (no PyTorch call computes the
    scan, so there is no library yardstick)."""
    from repro_torch.kernels.ssd import ssd as ssd_k
    from repro_torch.kernels.ssd.ref import ssd_chunked
    chunk = SSD_MAIN[6]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, a, bm, c, _ = ssd_inputs(SSD_MAIN, dtype, gen)
        before = ssd_k.LAUNCHES
        k_ms = time_ms(lambda: ssd_k.ssd_scan(x, dt, a, bm, c, chunk=chunk),
                       10, flush)
        ssd_k.LAUNCHES = before        # timing launches are not main-path
        p_ms = time_ms(lambda: ssd_chunked(x, dt, a, bm, c, chunk=chunk), 3,
                       flush)
        flops, nbytes = ssd_flops_bytes(SSD_MAIN, dtype)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[dtype] = {"ms": k_ms[0], "plain_ms": p_ms[0],
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "library_ms": None}
        print(f"[7] ssd {str(dtype):14s} B={SSD_MAIN[0]} S={SSD_MAIN[1]} "
              f"H={SSD_MAIN[2]} P={SSD_MAIN[3]} G={SSD_MAIN[4]} "
              f"N={SSD_MAIN[5]} L={chunk}: kernel_ms={spread(k_ms)} "
              f"plain_ms={spread(p_ms)} bound_ms="
              f"{res[dtype]['bound_ms']:.4f} (flops {flops}, bytes "
              f"{nbytes}; {flops / k_ms[0] / 1e9:.2f} "
              f"TFLOP/s) [{card}]")
        del x, dt, a, bm, c
    return res


def ssd_bwd_flops_bytes(case, dtype):
    """Visible work of the SSD backward, per chunk of m real positions and
    head: the lower triangles (m(m+1)/2 pairs) of C B^T and dy x^T and the
    four products with them (y, g, dC and dB), and six m x P x N products
    (the state's recomputation, y's and dC's terms from the entering state,
    g's and dB's from dh, and dh's update).  Least traffic: x, dy, B, C, dt
    and A read once; dx, dB, dC, ddt and dA written once."""
    b, s, h, p, g, n, chunk = case
    flops = 0
    for c0 in range(0, s, chunk):
        m = min(chunk, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (3 * n + 3 * p) + 12 * m * p * n
    flops *= b * h
    e = torch.finfo(dtype).bits // 8
    nbytes = (3 * b * s * h * p * e + 4 * b * s * g * n * e
              + 2 * b * s * h * 4 + 2 * h * 4)
    return flops, nbytes


def phase_ssd_bwd_timing(gen, card):
    """The SSD backward at phase 17's mamba2 and zamba2 training shapes,
    bf16 (the tensor-core kernels), and at mamba2's in float32 (the FMA
    kernel), L2 flushed: its time, its bound and its plain version's time
    (no PyTorch call computes the SSD backward: no library yardstick).
    Returns {tag: entry of the kernels line}."""
    from repro_torch.kernels.ssd import ssd as ssd_k
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for tag, case, dtype in (("mamba2", SSD_TRAIN_MAMBA2, torch.bfloat16),
                             ("zamba2", SSD_TRAIN_ZAMBA2, torch.bfloat16),
                             ("mamba2_float32", SSD_TRAIN_MAMBA2,
                              torch.float32)):
        x, dt, a, bm, c, _ = ssd_inputs(case, dtype, gen)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        chunk = case[6]
        before = (ssd_k.BWD_LAUNCHES, ssd_k.BWD_TC_LAUNCHES,
                  ssd_k.BWD_FMA_LAUNCHES)
        k_ms = time_ms(lambda: ssd_k.ssd_scan_bwd(x, dt, a, bm, c, dy,
                                                  chunk=chunk), 5, flush)
        # timing launches are not main-path
        (ssd_k.BWD_LAUNCHES, ssd_k.BWD_TC_LAUNCHES,
         ssd_k.BWD_FMA_LAUNCHES) = before
        p_ms = time_ms(lambda: ssd_chunked_bwd(x, dt, a, bm, c, dy,
                                               chunk=chunk), 2, flush)
        flops, nbytes = ssd_bwd_flops_bytes(case, dtype)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[tag] = {"ms": k_ms[0], "plain_ms": p_ms[0],
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes", "library_ms": None,
                    "tflops": flops / k_ms[0] / 1e9}
        print(f"[7] ssd_bwd {tag} {str(dtype):14s} B={case[0]} S={case[1]} "
              f"H={case[2]} P={case[3]} G={case[4]} N={case[5]} L={chunk}: "
              f"kernel_ms={spread(k_ms)} plain_ms={spread(p_ms)} bound_ms="
              f"{res[tag]['bound_ms']:.4f} (flops {flops}, bytes {nbytes}; "
              f"bound by {res[tag]['bound_by']}; "
              f"{res[tag]['tflops']:.2f} TFLOP/s) [{card}]")
        del x, dt, a, bm, c, dy
        torch.cuda.empty_cache()
    return res


def phase_zamba2_timing(gen, card):
    """The flash forward and the SSD at zamba2's prefill shapes, bf16, L2
    flushed: each kernel's time, its bound and its plain version's time;
    for the forward also ``scaled_dot_product_attention`` on the same
    inputs.  Returns {kernel: (ms, bound_ms, plain_ms, library_ms)}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd import ssd as ssd_k
    from repro_torch.kernels.ssd.ref import ssd_chunked
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dtype = torch.bfloat16
    res = {}
    b, h, kh, sq, sk, d, causal, _ = ZAMBA2_FA
    q, k, v = flash_inputs(ZAMBA2_FA, dtype, gen)
    before = fa.LAUNCHES
    k_ms = time_ms(lambda: fa.flash_attention(q, k, v, return_lse=True), 20,
                   flush)
    fa.LAUNCHES = before               # timing launches are not main-path
    p_ms = time_ms(lambda: attention_ref(q, k, v), 3, flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20, flush)
    flops = 4 * d * _causal_pairs(sq, sk, causal) * b * h
    nq, nk = q.numel() * q.element_size(), k.numel() * k.element_size()
    nbytes = 2 * nq + 2 * nk + b * h * sq * 4     # q, o, k, v, lse once
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res["flash_attention_fwd"] = (k_ms[0], max(t_ops, t_bytes), p_ms[0],
                                  lib[0])
    print(f"[7] flash_attention_fwd zamba2 {str(dtype):14s} B={b} H={h} "
          f"K={kh} S={sq} D={d} causal: kernel_ms={spread(k_ms)} "
          f"plain_ms={spread(p_ms)} sdpa_ms={spread(lib)} bound_ms="
          f"{max(t_ops, t_bytes):.4f} (flops {flops}, bytes {nbytes}; "
          f"{flops / k_ms[0] / 1e9:.1f} TFLOP/s) [{card}]")
    del q, k, v
    case = SSD_ZAMBA2
    x, dt, a, bm, c, _ = ssd_inputs(case, dtype, gen)
    before = ssd_k.LAUNCHES, ssd_k.TC_LAUNCHES
    k_ms = time_ms(lambda: ssd_k.ssd_scan(x, dt, a, bm, c, chunk=case[6]),
                   10, flush)
    ssd_k.LAUNCHES, ssd_k.TC_LAUNCHES = before
    p_ms = time_ms(lambda: ssd_chunked(x, dt, a, bm, c, chunk=case[6]), 3,
                   flush)
    flops, nbytes = ssd_flops_bytes(case, dtype)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res["ssd"] = (k_ms[0], max(t_ops, t_bytes), p_ms[0], None)
    print(f"[7] ssd zamba2 {str(dtype):14s} B={case[0]} S={case[1]} "
          f"H={case[2]} P={case[3]} G={case[4]} N={case[5]} L={case[6]}: "
          f"kernel_ms={spread(k_ms)} plain_ms={spread(p_ms)} bound_ms="
          f"{max(t_ops, t_bytes):.4f} (flops {flops}, bytes {nbytes}; bound "
          f"by {'operations' if t_ops >= t_bytes else 'bytes'}; "
          f"{flops / k_ms[0] / 1e9:.2f} TFLOP/s) [{card}]")
    del x, dt, a, bm, c
    return res


def phase_mamba_profile(cfg, params, card, toks=None, tag="mamba",
                        model="mamba2-1.3b"):
    """One full-batch prefill call (``toks``, by default mamba2's 8 x 2048)
    and MAMBA_PROFILE_STEPS steady decode steps after it, each timed
    untraced and then in a padded trace (``padded_trace``).  The prefill
    trace must hold one ``ssd_scan_kernel`` per SSD call (one a mamba
    block); a hybrid's decode trace one softmax per cycle a step (its
    shared attention block); a mamba model's decode runs no kernel of
    the port and no softmax, so its trace is held to its pad alone."""
    from repro_torch.models import transformer as T
    toks = (mamba_requests(cfg)[0] if toks is None else toks).cuda()
    b, s = toks.shape
    n_blocks = sum(k != "shared_attn" for k in cfg.block_pattern) * (
        cfg.n_layers // len(cfg.block_pattern))
    n_attn = cfg.n_layers // len(cfg.block_pattern) if any(
        k == "shared_attn" for k in cfg.block_pattern) else 0

    def prefill():
        return T.prefill(params, cfg, toks, s + 64)

    pos = torch.full((b,), s, device="cuda")

    def decode(cache, n):
        nxt = toks[:, -1:]
        for i in range(n):         # positions matter to the hybrid only
            logits, cache = T.decode_step(params, cfg, cache, nxt, pos)
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            pos.add_(1)
        return cache

    for what, steps in (("prefill", 1), ("decode", MAMBA_PROFILE_STEPS)):
        _, cache = prefill()
        cache = decode(cache, 2)                    # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "prefill":
            _, cache = prefill()
        else:
            cache = decode(cache, steps)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) * 1e3 / steps
        held = [cache]

        def work():
            if what == "prefill":
                held[0] = prefill()[1]
            else:
                held[0] = decode(held[0], steps)

        if what == "prefill":
            count, want, label = named(r"ssd_scan_kernel"), n_blocks, \
                "ssd_scan_kernel"
        else:
            count, want, label = named(r"(?i)softmax"), n_attn * steps, \
                "softmax"
        kernels, wall, n_known, trace = padded_trace(
            work, count, want, f"{tag} {what}")
        traced = wall / steps
        del cache, held
        kernels, busy, by_name = _profile_summary(kernels, steps)
        total = sum(t for t, _ in by_name.values())
        ssd_ms = sum(t for n, (t, _) in by_name.items()
                     if re.search(r"ssd_\w*kernel", n))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        print(f"[8] {tag} {what} " + json.dumps({
            "card": card, "model": f"{model} (random weights, bf16)",
            "batch": b, "prompt_tokens": s, "calls": steps,
            "wall_ms_untraced": untraced, "wall_ms_traced": traced,
            "device_busy_ms": busy,
            "device_idle_share_untraced": 1 - busy / untraced,
            "device_idle_share_traced": 1 - busy / traced,
            "kernels_per_call": len(kernels) / steps,
            "trace": {"number": trace, label: n_known, "want": want},
            "ssd_ms_per_call": ssd_ms / steps,
            "ssd_share_of_kernel_time": ssd_ms / total,
            "top_kernels_ms_per_call": [
                {"name": n[:80], "ms": t / steps, "calls": c / steps}
                for n, (t, c) in top]}))


# ------------------------------------------------------------ whisper
def whisper_inputs(cfg, rows, prompt, seed, dtype):
    """Seeded prompt tokens in [3, vocab_size) and random encoder frames
    (rows, enc_seq, d_model) on the card: the audio frontend is a stub in
    both packages, so frames stand in for its output."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(3, cfg.vocab_size, (rows, prompt), generator=gen,
                         device="cuda")
    frames = torch.randn(rows, cfg.encoder_seq_len, cfg.d_model,
                         generator=gen, device="cuda").to(dtype)
    return toks, frames


def phase_whisper_serving(card):
    """Phase 16, serving: whisper-medium at full width, bf16, through
    ``transformer.prefill`` (encoder over 1500 frames, then the decoder's
    self and cross attention) and greedy ``decode_step``s against the
    cross KV cache.  WHISPER_PREFILL_REPS prefills of WHISPER_ROWS x
    WHISPER_PROMPT tokens (max_len WHISPER_MAX_LEN), then
    WHISPER_DECODE_STEPS decode steps; then a padded trace of one prefill
    and one of WHISPER_TRACE_STEPS decode steps.  Returns the flash
    kernels' launches in the timed prefills (the forward's only)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import transformer as T

    cfg = get_config("whisper-medium")
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(16), dtype=torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    enc_params = sum(v.numel() for v in _leaves(params["encoder"]))
    emb = params["embed"]["table"].numel() + params["lm_head"].numel()
    toks, frames = whisper_inputs(cfg, WHISPER_ROWS, WHISPER_PROMPT, 17,
                                  torch.bfloat16)
    b, s = toks.shape
    per_call = cfg.n_encoder_layers + 2 * cfg.n_layers
    T.prefill(params, cfg, toks[:2], WHISPER_MAX_LEN,
              encoder_frames=frames[:2])              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    pre = []
    for _ in range(WHISPER_PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, WHISPER_MAX_LEN,
                                  encoder_frames=frames)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    v, launches = _variant_counts(), _flash_counts()
    want = per_call * WHISPER_PREFILL_REPS
    check(fa.LAUNCHES == v["fwd_wgmma"] == want and v["fwd_fma"] == 0,
          f"whisper prefill's flash launches {fa.LAUNCHES}, by kernel {v}: "
          f"not {per_call} a call on fa_fwd_wgmma_kernel")
    check(launches["flash_attention_dq"] == launches[
        "flash_attention_dkv"] == 0, f"whisper prefill ran a backward "
          f"kernel: {launches}")
    check(pa.LAUNCHES == 0 and _ssd_count() == 0,
          "whisper prefill launched a paged or SSD kernel")
    xshape = (cfg.n_layers, b, cfg.encoder_seq_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
    check(tuple(cache["xk"].shape) == tuple(cache["xv"].shape) == xshape,
          f"whisper cross cache {tuple(cache['xk'].shape)}, not {xshape}")
    check(tuple(cache["k"].shape[2:3]) == (WHISPER_MAX_LEN,),
          "whisper self-attention cache length")
    _zero_counts()
    nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    gen_toks, step_ms = [nxt], []
    pos = s

    def step():
        nonlocal nxt, cache, logits, pos
        logits, cache = T.decode_step(params, cfg, cache, nxt,
                                      torch.full((b,), pos, device="cuda"))
        nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        pos += 1
        return nxt

    for _ in range(WHISPER_DECODE_STEPS):
        t0 = time.perf_counter()
        gen_toks.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(_ssd_count() == 0 and pa.LAUNCHES == 0
          and all(n == 0 for n in _flash_counts().values()),
          "whisper decode launched a flash, paged or SSD kernel")
    out = torch.cat(gen_toks, 1).cpu()
    check(out.shape == (b, WHISPER_DECODE_STEPS + 1), "whisper decode length")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "whisper: a token outside the vocabulary")
    check(bool(torch.isfinite(logits).all()), "whisper: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre, st = np.asarray(pre), np.asarray(step_ms)

    # padded traces: one prefill (72 forward launches), then decode steps
    # (two softmaxes a layer a step: self and cross attention)
    del cache
    held = {}

    def one_prefill():
        held["out"] = T.prefill(params, cfg, toks, WHISPER_MAX_LEN,
                                encoder_frames=frames)

    traces = {}
    kern, wall, n, tr = padded_trace(one_prefill,
                                     named(r"fa_fwd_wgmma_kernel"), per_call,
                                     "whisper prefill")
    traces["prefill"] = (kern, wall, 1, {"fa_fwd_wgmma_kernel": n,
                                         "want": per_call, "number": tr})
    logits, cache = held.pop("out")
    pos = s
    nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(2):                            # warm
        step()

    def steps():
        for _ in range(WHISPER_TRACE_STEPS):
            step()

    want_soft = 2 * cfg.n_layers * WHISPER_TRACE_STEPS
    kern, wall, n, tr = padded_trace(steps, named(r"(?i)softmax"),
                                     want_soft, "whisper decode")
    traces["decode"] = (kern, wall, WHISPER_TRACE_STEPS,
                        {"softmax": n, "want": want_soft, "number": tr})
    _zero_counts()
    prof = {}
    for what, (kern, wall, calls, tinfo) in traces.items():
        kernels, busy, by_name = _profile_summary(kern, calls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        prof[what] = {
            "calls": calls, "wall_ms_traced": wall / calls,
            "device_busy_ms": busy,
            "device_idle_share_traced": 1 - busy / (wall / calls),
            "kernels_per_call": len(kernels) / calls, "trace": tinfo,
            "top_kernels_ms_per_call": [
                {"name": nm[:80], "ms": t / calls, "calls": c / calls}
                for nm, (t, c) in top]}
    prof["prefill"]["device_idle_share_untraced"] = \
        1 - prof["prefill"]["device_busy_ms"] / (float(np.median(pre)) * 1e3)
    prof["decode"]["device_idle_share_untraced"] = \
        1 - prof["decode"]["device_busy_ms"] / float(np.mean(st))
    print("[16] whisper serving " + json.dumps({
        "card": card, "model": "whisper-medium (random weights, bf16; "
        "frames random, the frontend a stub)", "params": n_params,
        "encoder_params": enc_params, "embedding_params": emb,
        "decoder_params": n_params - enc_params - emb,
        "rows": b, "prompt_tokens": s, "frames": cfg.encoder_seq_len,
        "max_len": WHISPER_MAX_LEN,
        "cross_kv_gb": 2 * cache["xk"].numel() * 2 / 1e9,
        "prefills": WHISPER_PREFILL_REPS,
        "prefill_s_p50": float(np.percentile(pre, 50)),
        "prefill_s_p90": float(np.percentile(pre, 90)),
        "fwd_wgmma_launches_per_prefill": per_call,
        "decode_steps": WHISPER_DECODE_STEPS,
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "decode_tokens_per_s": b / float(np.percentile(st, 50)) * 1e3,
        "max_memory_allocated_gb": peak,
        "first_tokens": out[0, :8].tolist(), "profile": prof}))
    del params, cache, logits
    torch.cuda.empty_cache()
    return launches


def phase_whisper_consistency(card):
    """Phase 16, full width, fp32 weights and frames: decode_step after a
    WHISPER_CONSISTENCY_PROMPT-token prefill gives the last logits of the
    prefill one token longer, on the same frames (atol DENSE_ATOL, as
    phases 9, 13 and 15)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("whisper-medium")
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(18), dtype=torch.float32, device="cuda")
    s = WHISPER_CONSISTENCY_PROMPT
    toks, frames = whisper_inputs(cfg, 2, s + 1, 19, torch.float32)
    _, cache = T.prefill(params, cfg, toks[:, :s], s + 1,
                         encoder_frames=frames, cache_dtype=torch.float32)
    got, _ = T.decode_step(params, cfg, cache, toks[:, s:],
                           torch.full((2,), s, device="cuda"))
    del cache
    want, _ = T.prefill(params, cfg, toks, s + 1, encoder_frames=frames,
                        cache_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[16] whisper-medium fp32, decode after prefill of {s} tokens vs "
          f"prefill of {s + 1} (same 1500 frames): logits max_abs_err="
          f"{err:.3e} atol={DENSE_ATOL} (max |logit| "
          f"{float(want.abs().max()):.3f}) [{card}]")
    check(bool(torch.isfinite(got).all()), "whisper: non-finite decode logits")
    check(err <= DENSE_ATOL, f"whisper decode vs prefill: {err}")
    del params
    torch.cuda.empty_cache()


def _whisper_trainer(cfg, steps, remat, ckpt):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    b, s = WHISPER_TRAIN
    return Trainer(cfg, ShapeConfig("chip_smoke_whisper", "train", s, b),
                   TrainConfig(steps=steps, log_every=1, ckpt_every=0,
                               ckpt_dir=ckpt, seed=0, remat=remat,
                               compute_dtype=torch.bfloat16,
                               param_dtype=torch.float32,
                               opt=AdamWConfig(warmup_steps=5,
                                               total_steps=steps)),
                   device="cuda")


def phase_whisper_train(card):
    """Phase 16, training: ``Trainer`` on whisper-medium at full width
    (sequence 448, batch 8, frames 8 x 1500, fp32 masters, bf16 compute),
    WHISPER_TRAIN_STEPS steps; a padded trace of WHISPER_PROFILE_STEPS
    more; then WHISPER_REMAT_STEPS steps with ``remat="full"`` from the
    same seed.  Returns the first run's launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention as pa
    cfg = get_config("whisper-medium")
    per_step = cfg.n_encoder_layers + 2 * cfg.n_layers
    b, s = WHISPER_TRAIN
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    runs = {}
    try:
        for remat, steps in (("none", WHISPER_TRAIN_STEPS),
                             ("full", WHISPER_REMAT_STEPS)):
            torch.cuda.empty_cache()
            tr = _whisper_trainer(cfg, steps, remat, ckpt)
            step_fn, step_ms = tr.step_fn, []

            def timed(*args, step_fn=step_fn, step_ms=step_ms):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_fn(*args)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            tr.step_fn = timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            tr.run()
            torch.cuda.synchronize()
            runs[remat] = {
                "launches": _flash_counts(), "variants": _variant_counts(),
                "pa": pa.LAUNCHES, "ssd": _ssd_count(),
                "losses": [m["loss"] for m in tr.metrics_log],
                "step_ms": step_ms,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if remat == "none":
                _zero_counts()
                runs["profile"] = train_trace(
                    tr, step_fn, WHISPER_PROFILE_STEPS,
                    per_step * WHISPER_PROFILE_STEPS,
                    "whisper training steps")
                runs["profile"]["device_idle_share_untraced"] = 1 - runs[
                    "profile"]["device_busy_ms_per_step"] / float(
                        np.median(step_ms[1:]))
                _zero_counts()
            # nothing of this trainer may stay alive into the next run's
            # peak memory
            del tr, step_fn, timed
            gc.collect()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    base, rem = runs["none"], runs["full"]
    for key, r in (("none", base), ("full", rem)):
        n = len(r["step_ms"])
        check(all(math.isfinite(x) for x in r["losses"]),
              f"whisper remat={key}: non-finite loss {r['losses']}")
        check(r["pa"] == 0 and r["ssd"] == 0,
              f"whisper training (remat={key}) launched a paged or SSD "
              "kernel")
        # remat recomputes each decoder layer (self and cross attention)
        # in the backward; the encoder, as the reference's, keeps its
        # activations
        fwd = n * (per_step + (2 * cfg.n_layers if key == "full" else 0))
        want = n * per_step
        check(r["variants"] == {"fwd_wgmma": fwd, "fwd_fma": 0,
                                "dq_wgmma": want, "dq_fma": 0,
                                "dkv_wgmma": want, "dkv_fma": 0},
              f"whisper bf16 training (remat={key}, {n} steps): flash "
              f"launches by kernel {r['variants']}, not {fwd} forward and "
              f"{want} dq and dkv on the tensor cores")
    k = WHISPER_REMAT_STEPS
    loss_err = max(abs(a - b) for a, b in zip(base["losses"][:k],
                                              rem["losses"]))
    check(loss_err <= 2e-2, f"whisper remat='full' losses "
          f"{rem['losses']} vs {base['losses'][:k]}")
    st = np.asarray(base["step_ms"][1:])
    print("[16] whisper training " + json.dumps({
        "card": card, "model": "whisper-medium (random weights, fp32 "
        "masters, bf16 compute)", "seq_len": s, "batch": b,
        "frames": cfg.encoder_seq_len, "steps": WHISPER_TRAIN_STEPS,
        "step_ms_first": base["step_ms"][0],
        "step_ms_p50": float(np.percentile(st, 50)),
        "step_ms_p90": float(np.percentile(st, 90)),
        "tokens_per_s": b * s / float(np.percentile(st, 50)) * 1e3,
        "frames_per_s": b * cfg.encoder_seq_len
        / float(np.percentile(st, 50)) * 1e3,
        "max_memory_allocated_gb": base["peak_gb"],
        "loss_first": base["losses"][0], "loss_last": base["losses"][-1],
        "launches": base["launches"], "launches_by_kernel": base["variants"],
        "remat_full": {"steps": k, "losses": rem["losses"],
                       "loss_max_abs_err_vs_none": loss_err, "atol": 2e-2,
                       "step_ms_p50": float(np.percentile(
                           rem["step_ms"][1:], 50)),
                       "max_memory_allocated_gb": rem["peak_gb"],
                       "launches_by_kernel": rem["variants"]},
        "profile": runs["profile"]}))
    torch.cuda.empty_cache()
    return base["launches"]


def _launch_counts():
    """Every kernel's launches: paged decode, paged prefill by kernel,
    flash by variant, SSD by path."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_prefill as pp
    return {"paged": pa.LAUNCHES, "paged_prefill_wgmma": pp.WGMMA_LAUNCHES,
            "paged_prefill_fma": pp.FMA_LAUNCHES, **_variant_counts(),
            **{f"ssd_{k}": v for k, v in _ssd_paths().items()}}


def phase_family_train(card, arch, batch, remat, trace=False):
    """Phase 17: ``Trainer`` on ``arch`` at full width, sequence FAMILY_SEQ,
    ``batch`` rows, bf16 compute over float32 masters, FAMILY_STEPS steps
    from seed 0 with ``remat``.  Every loss finite; the SSD forward
    launches once per mamba layer a step (twice under remat), all on the
    tensor-core kernels, the SSD backward once per mamba layer a step,
    all on the tensor cores; the flash forward once per attention layer a
    step (twice under remat), dq and dkv once, all wgmma; nothing else.
    With ``trace``, one more step in a padded trace held to its SSD
    backward kernels' launches by name.  Returns the
    launches by kernel of the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = get_config(arch)
    kinds = cfg.layer_kinds()
    n_mamba = sum(k == "mamba" for k in kinds)
    n_attn = len(kinds) - n_mamba
    twice = 2 if remat != "none" else 1
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prof = None
    try:
        torch.cuda.empty_cache()
        tr = Trainer(cfg, ShapeConfig(f"chip_smoke_{arch}", "train",
                                      FAMILY_SEQ, batch),
                     TrainConfig(steps=FAMILY_STEPS, log_every=1,
                                 ckpt_every=0, ckpt_dir=ckpt, seed=0,
                                 remat=remat, compute_dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 opt=AdamWConfig(warmup_steps=5,
                                                 total_steps=FAMILY_STEPS)),
                     device="cuda")
        n_params = sum(v.numel() for v in _leaves(tr.params))
        step_fn, step_ms = tr.step_fn, []

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr.step_fn = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        tr.run()
        torch.cuda.synchronize()
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [m["loss"] for m in tr.metrics_log]
        if trace:
            from repro_torch.data.pipeline import to_device
            batch_t = to_device(tr.corpus.batch(1000), "cuda")

            def one_step():
                tr.params, tr.opt_state, _ = step_fn(tr.params, tr.opt_state,
                                                     batch_t)

            kernels, wall, n_bwd, number = padded_trace(
                one_step, named(r"ssd_bwd_key_kernel"), n_mamba,
                f"{arch} training step")
            kernels, busy, by_name = _profile_summary(kernels, 1)
            total = sum(t for t, _ in by_name.values())

            def by_kernel(k):           # (ms, calls) of the names with k
                return tuple(map(sum, zip((0.0, 0), *(
                    v for n, v in by_name.items()
                    if re.search(rf"\b{k}\b", n)))))

            # the backward's own kernels, one a call; the forward's
            # ssd_cb/state/pass run once in the forward (twice under
            # remat) and once more in each backward call
            fwd_calls = n_mamba * twice
            calls = {k: by_kernel(k)[1]
                     for k in SSD_BWD_TC_NAMES + SSD_REBUILD_NAMES}
            want_calls = {k: n_mamba for k in SSD_BWD_TC_NAMES}
            want_calls.update({k: n_mamba + fwd_calls
                               for k in SSD_REBUILD_NAMES})
            check(calls == want_calls, f"{arch} traced step: SSD kernels "
                  f"by name {calls}, not {want_calls}")
            rebuild_ms = sum(by_kernel(k)[0] * n_mamba / want_calls[k]
                             for k in SSD_REBUILD_NAMES)
            bwd_ms = (sum(by_kernel(k)[0] for k in SSD_BWD_TC_NAMES)
                      + rebuild_ms)
            fwd_ms = (sum(by_kernel(k)[0] for k in SSD_REBUILD_NAMES)
                      - rebuild_ms + by_kernel("ssd_scan_kernel")[0])
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
            prof = {"trace": {"number": number, "ssd_bwd_key_kernel": n_bwd,
                              "want": n_mamba, "ssd_calls_by_name": calls},
                    "step_wall_ms_traced": wall,
                    "device_busy_ms": busy,
                    "device_idle_share_traced": 1 - busy / wall,
                    "kernels": len(kernels),
                    "ssd_bwd_ms": bwd_ms, "ssd_bwd_rebuild_ms": rebuild_ms,
                    "ssd_fwd_ms": fwd_ms,
                    "ssd_bwd_ms_by_kernel": {
                        k: by_kernel(k)[0] for k in SSD_BWD_TC_NAMES},
                    "ssd_bwd_share_of_kernel_time": bwd_ms / total,
                    "top_kernels_ms": [{"name": n[:80], "ms": t, "calls": c}
                                       for n, (t, c) in top]}
            _zero_counts()
        # nothing of this trainer may stay alive into the next one's peak
        del tr, step_fn, timed
        gc.collect()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    steps = len(step_ms)
    check(steps == FAMILY_STEPS, f"{arch}: {steps} steps run")
    check(all(math.isfinite(x) for x in losses),
          f"{arch}: non-finite loss {losses}")
    want = {"paged": 0, "paged_prefill_wgmma": 0, "paged_prefill_fma": 0,
            "fwd_wgmma": twice * n_attn * steps, "fwd_fma": 0,
            "dq_wgmma": n_attn * steps, "dq_fma": 0,
            "dkv_wgmma": n_attn * steps, "dkv_fma": 0,
            "ssd_tc": twice * n_mamba * steps, "ssd_fma": 0,
            "ssd_bwd": n_mamba * steps, "ssd_bwd_tc": n_mamba * steps,
            "ssd_bwd_fma": 0}
    check(counts == want, f"{arch} bf16 training (remat={remat}, {steps} "
          f"steps): launches by kernel {counts}, not {want}")
    st = np.asarray(step_ms[1:])
    print("[17] " + json.dumps({
        "card": card, "model": f"{arch} (random weights, fp32 masters, "
        "bf16 compute)", "params": n_params, "seq_len": FAMILY_SEQ,
        "batch": batch, "remat": remat, "steps": steps,
        "mamba_layers": n_mamba, "attention_layers": n_attn,
        "step_ms_first": step_ms[0],
        "step_ms_p50": float(np.percentile(st, 50)),
        "step_ms_p90": float(np.percentile(st, 90)),
        "tokens_per_s": batch * FAMILY_SEQ / float(np.percentile(st, 50))
        * 1e3,
        "max_memory_allocated_gb": peak, "losses": losses,
        "launches_by_kernel": counts, "profile": prof}))
    torch.cuda.empty_cache()
    return {"ssd": counts["ssd_tc"], "ssd_bwd": counts["ssd_bwd"],
            "flash_attention_fwd": counts["fwd_wgmma"],
            "flash_attention_dq": counts["dq_wgmma"],
            "flash_attention_dkv": counts["dkv_wgmma"]}


def phase_serve_launcher(card):
    """Phase 18: ``repro_torch.launch.serve.main([])`` on the card at its
    defaults (the reduced smollm-135m, float32, 16 requests of 16 new
    tokens through 8 slots): every request completes with all its tokens,
    in the vocabulary, the paged kernel launches once per layer a decode
    step and the float32 paged prefill kernel once per layer a prefill
    call, nothing else.  Returns its paged decode and prefill launches."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch_serve
    engines, base = [], launch_serve.ServingEngine

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    out = io.StringIO()
    launch_serve.ServingEngine = Recorded
    try:
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launch_serve.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
    finally:
        launch_serve.ServingEngine = base
    stats = json.loads(out.getvalue())
    check(rc == 0 and len(engines) == 1, f"serve launcher: exit {rc}")
    eng = engines[0]
    cfg = eng.cfg
    check(stats["completed"] == 16 and len(eng.completed) == 16,
          f"serve launcher: {stats['completed']} of 16 requests completed")
    for r in eng.completed:
        check(len(r.out_tokens) == 16 and all(
            0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"serve launcher: rid {r.rid} tokens {r.out_tokens}")
    check(stats["mmu"]["pages_used"] == 0, "serve launcher leaked pages")
    want = dict({k: 0 for k in counts}, paged=cfg.n_layers * eng.steps,
                **prefill_launches_wanted(eng))
    check(counts == want, f"serve launcher: launches {counts}, not {want}")
    pp_launches = counts["paged_prefill_wgmma"] + counts["paged_prefill_fma"]
    print("[18] " + json.dumps({
        "card": card, "model": f"{cfg.arch_id} reduced (random weights, "
        "float32), the launcher's defaults", "wall_s": wall,
        "decode_steps": eng.steps, "paged_launches": counts["paged"],
        "prefill_launches": pp_launches,
        **{k: stats[k] for k in ("completed", "tokens", "tokens_per_s",
                                 "ttft_p50_ms", "tpot_p50_ms")}}))
    return counts["paged"], pp_launches


def phase_whisper_timing(gen, card):
    """Phase 7 at whisper's shapes, bf16, L2 flushed: the forward at the
    encoder's (8 x 16 heads, 1500 x 1500, non-causal) and the training
    cross-attention's (Sq 448 against Sk 1500), each with its bound, its
    plain version and ``scaled_dot_product_attention`` on the same
    tensors; at the cross shape also dq and dkv, with their bounds, the
    plain backward and SDPA's backward (dq, dk and dv in one call).
    Returns {kernel: {shape: {ms, bound_ms, bound_by, plain_ms,
    library_ms}}}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dtype = torch.bfloat16
    counts = (fa.LAUNCHES, fa.WGMMA_LAUNCHES, fab.DQ_LAUNCHES,
              fab.DQ_WGMMA_LAUNCHES, fab.DKV_LAUNCHES,
              fab.DKV_WGMMA_LAUNCHES)
    res = {"flash_attention_fwd": {}, "flash_attention_dq": {},
           "flash_attention_dkv": {}}

    def bound(flops, nbytes):
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    for shape, case in (("encoder", WHISPER_ENC_FA),
                        ("cross", WHISPER_CROSS_FA)):
        b, h, kh, sq, sk, d = case[:6]
        q, k, v, do = flash_inputs(case, dtype, gen, n=4)
        pairs = b * h * sq * sk
        e = q.element_size()
        nq, nk, nl = q.numel() * e, k.numel() * e, b * h * sq * 4
        k_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=False,
                                                  return_lse=True), 20, flush)
        p_ms = time_ms(lambda: attention_ref(q, k, v, causal=False), 3,
                       flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20,
                      flush)
        bnd, by = bound(4 * d * pairs, 2 * nq + 2 * nk + nl)
        res["flash_attention_fwd"][shape] = {
            "ms": k_ms[0], "bound_ms": bnd, "bound_by": by,
            "plain_ms": p_ms[0], "library_ms": lib[0]}
        print(f"[7] flash_attention_fwd whisper {shape} {str(dtype):14s} "
              f"B={b} H={h} K={kh} Sq={sq} Sk={sk} D={d} non-causal: "
              f"kernel_ms={spread(k_ms)} plain_ms={spread(p_ms)} sdpa_ms="
              f"{spread(lib)} bound_ms={bnd:.4f} (flops {4 * d * pairs}; "
              f"{4 * d * pairs / k_ms[0] / 1e9:.1f} TFLOP/s) [{card}]")
        if shape == "cross":
            o, lse = fa.flash_attention(q, k, v, causal=False,
                                        return_lse=True)
            _, delta = fab.flash_attention_dq(q, k, v, o, do, lse,
                                              causal=False)
            calls = {
                "flash_attention_dq": (
                    lambda: fab.flash_attention_dq(q, k, v, o, do, lse,
                                                   causal=False),
                    6 * d * pairs, 4 * nq + 2 * nk + 2 * nl),
                "flash_attention_dkv": (
                    lambda: fab.flash_attention_dkv(q, k, v, do, lse, delta,
                                                    causal=False),
                    8 * d * pairs, 2 * nq + 4 * nk + 2 * nl)}
            plain = time_ms(lambda: attention_bwd_ref(
                q, k, v, o, do, lse, causal=False), 3, flush)
            qg, kg, vg = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            saved = F.scaled_dot_product_attention(qg, kg, vg)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                saved, (qg, kg, vg), do, retain_graph=True), 20, flush)
            for name, (fn, flops, nbytes) in calls.items():
                t = time_ms(fn, 20, flush)
                bnd, by = bound(flops, nbytes)
                res[name][shape] = {
                    "ms": t[0], "bound_ms": bnd, "bound_by": by,
                    "plain_ms": plain[0], "library_ms": None}
                print(f"[7] {name} whisper cross {str(dtype):14s} B={b} "
                      f"H={h} Sq={sq} Sk={sk} D={d} non-causal: kernel_ms="
                      f"{spread(t)} bound_ms={bnd:.4f} (flops {flops}; "
                      f"{flops / t[0] / 1e9:.1f} TFLOP/s) [{card}]")
            both = sum(res[n]["cross"]["ms"] for n in calls)
            print(f"[7] flash whisper cross backward yardsticks: dq+dkv "
                  f"ms={both:.4f} sdpa_bwd_ms={spread(lib_bwd)} (dq, dk, "
                  f"dv in one call) "
                  f"plain_bwd_ms={spread(plain)} [{card}]")
            res["sdpa_bwd_cross_ms"] = lib_bwd[0]
            del o, lse, delta, qg, kg, vg, saved
        del q, k, v, do
    (fa.LAUNCHES, fa.WGMMA_LAUNCHES, fab.DQ_LAUNCHES, fab.DQ_WGMMA_LAUNCHES,
     fab.DKV_LAUNCHES, fab.DKV_WGMMA_LAUNCHES) = counts
    return res


def tp_prompts(cfg):
    """Phase 4's prompts, cut to the first TP_REQUESTS."""
    return [p for p, _ in main_requests(cfg)[:TP_REQUESTS]]


def _tp_weights(cfg, dtype):
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    return init_params(cfg, generator=gen, dtype=dtype, device="cuda")


def _teacher_forced(params, run_cfg, prompts, forced, hooks):
    """Prefill ``prompts`` through ``prefill_shared_paged`` (zero
    coverage, as the engine prefills a fresh admission), then TP_STEPS
    decode steps through the paged model, each fed ``forced[t]`` (the
    step's greedy token when ``forced`` is None).  Returns the first
    decode step's logits and every step's greedy tokens, (TP_STEPS + 1, n)
    with the prefill's first."""
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.serve import paged_model as PM
    page = TP_MMU["page_size"]
    mmu = MMU(MMUConfig(**TP_MMU))
    n = len(prompts)
    longest = max(len(p) for p in prompts) + TP_STEPS + 1
    maxp = -(-longest // page)
    for i, p in enumerate(prompts):
        mmu.alloc_seq(i + 1, len(p) + TP_STEPS + 1)
    dev = torch.device("cuda")
    tables = torch.tensor(mmu.block_table(list(range(1, n + 1)), maxp),
                          device=dev)
    pools = PM.make_pools(run_cfg, TP_MMU["n_pages"], page,
                          dtype=params["embed"]["table"].dtype, device=dev)
    tokens = torch.zeros(n, max(len(p) for p in prompts), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    zeros = torch.zeros_like(lens)
    first = PM.prefill_shared_paged(
        params, pools, tokens.to(dev), lens, zeros, zeros, tables, 0,
        torch.zeros(n, device=dev), cfg=run_cfg, page_size=page,
        filters_on=False, **hooks)
    greedy = [first]
    last = first if forced is None else torch.as_tensor(forced[0],
                                                        device=dev)
    logits0 = None
    for t in range(TP_STEPS):
        logits = PM._decode_logits(params, pools, tables, lens, last,
                                   cfg=run_cfg, page_size=page, **hooks)
        if logits0 is None:
            logits0 = logits.float().cpu().numpy()
        greedy.append(logits.argmax(dim=-1).int())
        last = (greedy[-1] if forced is None
                else torch.as_tensor(forced[t + 1], device=dev))
        lens = lens + 1
    return logits0, torch.stack(greedy).cpu().numpy()


def _tp_serving_engine(cfg, params, mesh, svc, dev):
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(cfg, params, MMU(MMUConfig(**TP_MMU)),
                         max_batch=TP_REQUESTS, max_len=1024, mesh=mesh,
                         collectives=svc, device=dev)


def _tp_drive(eng, drive):
    """Run ``drive()`` with launches counted from 0 and every paged-kernel
    call's head counts recorded; check that the paged kernel launched
    once per layer a decode step at the rank's local heads, the paged
    prefill kernel of the pools' dtype once per layer a prefill call, and
    no other kernel.  Returns the seconds ``drive`` took to the last sync,
    the heads, and the paged decode and prefill launches counted."""
    from repro_torch.serve import paged_model as PM
    heads, base = set(), PM.paged_decode

    def spy(q, k_pages, *args, **kw):
        heads.add((q.shape[1], k_pages.shape[2]))
        return base(q, k_pages, *args, **kw)

    PM.paged_decode = spy
    try:
        _zero_counts()
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
    finally:
        PM.paged_decode = base
    check(eng.mmu.utilization()["pages_used"] == 0, "TP engine leaked pages")
    want = dict({k: 0 for k in counts}, paged=eng.cfg.n_layers * eng.steps,
                **prefill_launches_wanted(eng))
    check(counts == want, f"TP engine launches {counts}, not {want}")
    local = (eng.tp.local_cfg.n_heads, eng.tp.local_cfg.n_kv_heads)
    check(heads == {local}, f"TP engine: paged calls at heads {heads}, "
                            f"not the local {local}")
    return (wall, sorted(heads), counts["paged"],
            counts["paged_prefill_wgmma"] + counts["paged_prefill_fma"])


def _tp_engine(cfg, params, mesh, svc, prompts, dev):
    """The TP engine through its entry point: every prompt submitted,
    stepped to completion with each step's collectives counted (launches
    and heads checked by ``_tp_drive``)."""
    eng = _tp_serving_engine(cfg, params, mesh, svc, dev)
    for p in prompts:
        eng.submit(p, max_new_tokens=TP_STEPS)
    decode_calls = []

    def drive():
        while eng.pending():
            c0, p0, s0 = svc.calls, eng.prefill_obs, eng.steps
            eng.step()
            if eng.steps > s0 and eng.prefill_obs == p0:
                decode_calls.append(svc.calls - c0)

    wall, heads, launches, pp_launches = _tp_drive(eng, drive)
    check(len(eng.completed) == TP_REQUESTS and all(
        len(r.out_tokens) == TP_STEPS for r in eng.completed),
          "TP engine: a request did not complete with all its tokens")
    st = np.asarray(eng.decode_step_times) * 1e3
    return eng, {
        "decode_steps": eng.steps, "paged_launches": launches,
        "prefill_launches": pp_launches, "paged_heads": heads,
        "wall_s": wall,
        "collectives_per_decode_step": sorted(set(decode_calls)),
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "streams": {r.rid: list(r.out_tokens) for r in eng.completed}}


def _tp_gateway(cfg, params, mesh, svc, prompts, dev):
    """A ``ServingGateway(admission="slo")`` in front of a fresh TP engine
    through its entry points (``submit``, ``step``): ``prompts`` arrive in
    the waves of TP_GW_WAVES (by gateway step), TP_GW_NEW new tokens
    each; arrivals 0 and 4 ask for a deadline of TP_GW_TIGHT_S, so the
    first expires queued and the second, once the EWMAs have a sample, is
    refused at the door; arrivals 1-3 ask for TP_GW_LOOSE_S.  From the
    first step on, rank 1's gateway clock reads TP_GW_AHEAD_S ahead.
    ``min_obs=1``: one prefill and one decode sample warm the service
    estimate.  Returns the streams by gid, the refusals and the
    latencies."""
    from repro_torch.core.port import PortError
    from repro_torch.serve import gateway as gateway_module
    from repro_torch.serve.gateway import ServingGateway
    eng = _tp_serving_engine(cfg, params, mesh, svc, dev)
    gw = ServingGateway(eng, admission="slo", min_obs=1)
    deadline = {0: TP_GW_TIGHT_S, 1: TP_GW_LOOSE_S, 2: TP_GW_LOOSE_S,
                3: TP_GW_LOOSE_S, 4: TP_GW_TIGHT_S}

    class AheadClock:
        @staticmethod
        def perf_counter():
            return time.perf_counter() + TP_GW_AHEAD_S

    def drive():
        step = 0
        while step <= max(TP_GW_WAVES) or gw.pending():
            for i in TP_GW_WAVES.get(step, ()):
                try:
                    gw.submit(prompts[i], max_new_tokens=TP_GW_NEW,
                              deadline_s=deadline.get(i))
                except PortError:
                    pass                     # typed; kept in gw.rejected
            if step == 0 and eng.tp.rank == 1:
                gateway_module.time = AheadClock
            gw.step()
            step += 1

    try:
        wall, heads, launches, _ = _tp_drive(eng, drive)
    finally:
        gateway_module.time = time
    st = gw.stats()
    return {"streams": {s.gid: list(s.tokens) for s in gw.completed},
            "expired": [s.gid for s in gw.rejected
                        if s.error.kind == "slo_expired"],
            "rejected": [(s.gid, s.error.kind) for s in gw.rejected],
            "dispatched": gw.dispatched, "decode_steps": eng.steps,
            "paged_launches": launches, "paged_heads": heads,
            "wall_s": wall,
            "ttft_p50_ms": st["ttft_p50_ms"],
            "tpot_p50_ms": st["tpot_p50_ms"]}


def tp_rank(rank, world, dev, forced, bf16):
    """One rank of phase 19's TP 2 or 3 run (``world`` ranks on the
    model dim): the teacher-forced fp32 check through the TP context's
    functions, the fp32 engine, at TP 2 the gateway in front of a fresh
    fp32 engine, and with ``bf16`` the bf16 engine."""
    from repro_torch.configs import get_config
    from repro_torch.core.services.collectives import CollectiveService
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.tp import TPContext
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m")
    mesh = make_host_mesh(1, world, device="cuda")
    prompts = tp_prompts(cfg)
    svc = CollectiveService()
    full = _tp_weights(cfg, torch.float32)
    tp = TPContext(cfg, mesh, full, page_size=TP_MMU["page_size"],
                   collectives=svc)
    logits0, greedy = _teacher_forced(tp.params, tp.local_cfg, prompts,
                                      forced, tp.hooks)
    out = {"rank": rank, "plan": {"shard_heads": tp.shard_heads,
                                  "shard_mlp": tp.shard_mlp},
           "local_heads": (tp.local_cfg.n_heads, tp.local_cfg.n_kv_heads),
           "local_d_ff": int(tp.params["layers"]["ffn"]["w_up"].shape[-1]),
           "logits0": logits0, "greedy": greedy}
    _, out["fp32"] = _tp_engine(cfg, full, mesh, svc, prompts, dev)
    if world == 2:
        out["gateway"] = _tp_gateway(cfg, full, mesh, svc, prompts, dev)
    del tp, full
    if bf16:
        _, out["bf16"] = _tp_engine(cfg, _tp_weights(cfg, torch.bfloat16),
                                    mesh, svc, prompts, dev)
    out["host_copies"] = svc.host_copies
    return out


def mesh8_rank(rank, world, dev):
    """One rank of phase 19's (pod 2, data 2, model 2) mesh: the
    hierarchical against the flat all-reduce, context-parallel decode
    attention against the dense one, and the pod hand-off."""
    from repro_torch.core.services.collectives import (CollectiveConfig,
                                                       CollectiveService)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import attend_decode, attend_decode_cp
    from repro_torch.serve.disaggregated import make_handoff_fn
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cuda")
    pod, data, model = (mesh.get_local_rank(a)
                        for a in ("pod", "data", "model"))
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    # each rank's (pod, data) block has an odd size: the reduce-scatter pads
    x = torch.randn(12, 1365, generator=gen, device=dev)
    local = x.chunk(4)[pod * 2 + data]
    svc = CollectiveService(CollectiveConfig(schedule="hierarchical"))
    flat = CollectiveService(CollectiveConfig(schedule="flat"))
    hier = svc.all_reduce(local, mesh)
    want = flat.all_reduce(local, mesh)
    b, h, k, d, s = TP_CP
    q = torch.randn(b, 1, h, d, generator=gen, device=dev)
    kc = torch.randn(b, s, k, d, generator=gen, device=dev)
    vc = torch.randn(b, s, k, d, generator=gen, device=dev)
    lens = torch.tensor([s, 3001, 2048, 17], dtype=torch.int32, device=dev)
    dense = attend_decode(q, kc, vc, lens).chunk(2)[data]
    rows = [t.chunk(2)[data] for t in (q, kc, vc, lens)]
    rows[1], rows[2] = (t.chunk(2, dim=1)[model] for t in rows[1:3])
    cp = attend_decode_cp(*rows, mesh, collectives=svc)
    cache = {"k": torch.randn(4, 16, k, d, generator=gen, device=dev),
             "v": torch.randn(4, 16, k, d, generator=gen, device=dev)}
    handoff, _ = make_handoff_fn(mesh, svc)
    got = handoff({n: v.chunk(2)[pod] for n, v in cache.items()})
    torch.cuda.synchronize()
    return {"coords": (pod, data, model),
            "hier_err": float((hier - want).abs().max()),
            "flat_err": float((want - x.reshape(4, 3, -1).sum(0)).abs()
                              .max()),
            "cp_err": float((cp - dense).abs().max()),
            "handoff_exact": all(torch.equal(got[n], v.chunk(2)[0])
                                 for n, v in cache.items()),
            "host_copies": svc.host_copies + flat.host_copies}


def _check_tp_gateway(outs, card):
    """Phase 19's gateway on every TP 2 rank: rank 0's refusals and
    streams as designed, every rank's equal to rank 0's, the greedy
    streams equal to the gateway-less engine's first TP_GW_NEW tokens
    (engine rid = prompt index + 1, gateway gid = prompt index)."""
    r0 = outs[0]["gateway"]
    served = [i for i in range(TP_REQUESTS) if i not in (0, 4)]
    check(sorted(r0["streams"]) == served and all(
        len(t) == TP_GW_NEW for t in r0["streams"].values()),
          f"TP gateway served {sorted(r0['streams'])}, not {served} with "
          f"{TP_GW_NEW} tokens each")
    check(r0["rejected"] == [(0, "slo_expired"), (4, "slo_infeasible")],
          f"TP gateway refusals {r0['rejected']}")
    check(r0["dispatched"] == len(served),
          f"TP gateway dispatched {r0['dispatched']}")
    for o in outs:
        g, tag = o["gateway"], f"TP 2 gateway rank {o['rank']}"
        for k in ("streams", "expired", "rejected", "dispatched",
                  "decode_steps"):
            check(g[k] == r0[k], f"{tag}: {k} {g[k]} differ from rank "
                                 f"0's {r0[k]}")
        engine = o["fp32"]["streams"]
        for gid, toks in g["streams"].items():
            check(toks == engine[gid + 1][:TP_GW_NEW],
                  f"{tag}: gid {gid}'s greedy stream differs from the "
                  "engine's without the gateway")
    print("[19] " + json.dumps({
        "card": card, "gateway": "ServingGateway(admission='slo', "
        "min_obs=1) on a TP 2 engine, fp32", "ranks_on": "cuda:0, gloo",
        "arrivals": TP_REQUESTS, "new_tokens": TP_GW_NEW,
        "served": len(r0["streams"]), "refused": r0["rejected"],
        "decode_steps": r0["decode_steps"],
        "paged_launches": r0["paged_launches"],
        "paged_heads": r0["paged_heads"],
        "ttft_p50_ms": r0["ttft_p50_ms"], "tpot_p50_ms": r0["tpot_p50_ms"],
        "wall_s": [o["gateway"]["wall_s"] for o in outs],
        "note": "rank 0's TTFT and TPOT from arrival (rank 1's gateway "
                f"clock runs {TP_GW_AHEAD_S} s ahead), gloo staging "
                "through the host on one card, not a TP speed"}))


def phase_tensor_parallel(card):
    """Phase 19: tensor-parallel serving and the multi-rank collectives on
    the card (see TP_REQUESTS).  Returns rank 0's paged decode and paged
    prefill launches of the fp32 TP 3 engine."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    cfg = get_config("smollm-135m")
    torch.cuda.empty_cache()
    # the single-process port on the card: the teacher-forced reference
    logits0, greedy = _teacher_forced(_tp_weights(cfg, torch.float32), cfg,
                                      tp_prompts(cfg), None, {})
    torch.cuda.empty_cache()
    kw = dict(backend="gloo", device="cuda:0", timeout_s=TP_TIMEOUT_S,
              deadline_s=TP_DEADLINE_S)
    launches = pp_launches = None
    for world in (3, 2):
        t0 = time.perf_counter()
        outs = run_ranks(tp_rank, world, greedy, world == 3, **kw)
        ranks_s = time.perf_counter() - t0
        plan = (world == 3, True)
        for o in outs:
            tag = f"TP {world} rank {o['rank']}"
            check((o["plan"]["shard_heads"], o["plan"]["shard_mlp"]) == plan,
                  f"{tag}: plan {o['plan']}")
            check(o["local_d_ff"] == cfg.d_ff // world, f"{tag}: d_ff")
            err = float(np.abs(o["logits0"] - logits0).max())
            o["logits0_err"] = err
            check(err <= TP_LOGITS_ATOL, f"{tag}: first-step logits {err}")
            check(np.array_equal(o["greedy"], greedy),
                  f"{tag}: teacher-forced greedy tokens differ")
            for dt in ("fp32", "bf16"):
                if dt in o:
                    check(o[dt]["streams"] == outs[0][dt]["streams"],
                          f"{tag}: {dt} streams differ from rank 0's")
                    want = cfg.n_layers * (int(plan[0]) + int(plan[1])) + 1
                    check(o[dt]["collectives_per_decode_step"] == [want],
                          f"{tag} {dt}: collectives a decode step "
                          f"{o[dt]['collectives_per_decode_step']}, not "
                          f"[{want}]")
        r0 = outs[0]
        if world == 3:
            launches = r0["fp32"]["paged_launches"]
            pp_launches = r0["fp32"]["prefill_launches"]
        else:
            _check_tp_gateway(outs, card)
        print("[19] " + json.dumps({
            "card": card, "model": "smollm-135m (random weights)",
            "tp": world, "ranks_on": "cuda:0, gloo",
            "plan": r0["plan"], "local_heads": r0["local_heads"],
            "local_d_ff": r0["local_d_ff"],
            "logits0_max_abs_err": [o["logits0_err"] for o in outs],
            "teacher_forced_steps": TP_STEPS, "requests": TP_REQUESTS,
            "ranks_s": ranks_s,
            "host_copies": [o["host_copies"] for o in outs],
            **{dt: {k: v for k, v in r0[dt].items() if k != "streams"}
               for dt in ("fp32", "bf16") if dt in r0},
            "note": "step times are gloo staging through the host on one "
                    "card, not a TP speed"}))
    t0 = time.perf_counter()
    outs = run_ranks(mesh8_rank, 8, **kw)
    for o in outs:
        tag = f"mesh (2, 2, 2) rank at {o['coords']}"
        check(o["hier_err"] <= 1e-5 and o["flat_err"] <= 1e-5,
              f"{tag}: all-reduce {o['hier_err']}, {o['flat_err']}")
        check(o["cp_err"] <= 1e-4, f"{tag}: cp attention {o['cp_err']}")
        check(o["handoff_exact"], f"{tag}: hand-off not exact")
    print("[19] " + json.dumps({
        "card": card, "mesh": "(pod 2, data 2, model 2), 8 ranks on cuda:0, "
        "gloo", "ranks_s": time.perf_counter() - t0,
        "hier_vs_flat_max_abs_err": max(o["hier_err"] for o in outs),
        "cp_decode_max_abs_err": max(o["cp_err"] for o in outs),
        "cp_shape": dict(zip(("batch", "heads", "kv_heads", "head_dim",
                              "seq"), TP_CP)),
        "handoff_exact": all(o["handoff_exact"] for o in outs),
        "host_copies": sum(o["host_copies"] for o in outs)}))
    return launches, pp_launches


def _smoke_trainer(cfg, seq, bf16, ckpt, mesh=None, dev="cuda", mb=1):
    """Phase 20's Trainer: on ``mesh`` (a rank's), or the single-process
    reference when None."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    return Trainer(
        cfg, ShapeConfig("chip_smoke_mesh", "train", seq, MESH_BATCH),
        TrainConfig(steps=MESH_STEPS, log_every=1, ckpt_every=0,
                    ckpt_dir=ckpt, seed=MESH_SEED, microbatches=mb,
                    compute_dtype=torch.bfloat16 if bf16 else None,
                    param_dtype=torch.float32,
                    opt=AdamWConfig(warmup_steps=1,
                                    total_steps=MESH_STEPS)),
        mesh=mesh, device=dev)


def _timed_steps(tr):
    """Wrap ``tr.step_fn`` so each step's wall (synchronized) is kept."""
    step_fn, ms = tr.step_fn, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr.step_fn = timed
    return ms


def mesh_train_rank(rank, world, dev, meshes, want_path):
    """One rank of phase 20's mesh Trainers, one run of
    :func:`_mesh_train` for each ``(name, data, model, microbatches)`` of
    ``meshes`` (every one of ``world`` ranks, so one start of the ranks
    serves them all).  Returns {name: its result}."""
    return {name: _mesh_train(rank, dev, data, model, mb, want_path)
            for name, data, model, mb in meshes}


def _mesh_train(rank, dev, data, model, mb, want_path):
    """MESH_STEPS bf16 steps at MESH_SEQ (launches by kernel, the flash
    calls' head counts, step walls, collectives and peak memory), then
    MESH_STEPS fp32 steps at MESH_FP32_SEQ, this rank's parameter shards
    held to ``local_shard`` of the single-process run's (read from
    ``want_path``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention
    from repro_torch.models.sharding import flatten_specs, local_shard
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m")
    mesh = make_host_mesh(data, model, device="cuda")
    heads, base = set(), attention.ops.mha_fused

    def spy(q, k, v, *args, **kw):
        heads.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return base(q, k, v, *args, **kw)

    out = {"rank": rank, "coords": tuple(mesh.get_local_rank(d)
                                         for d in ("data", "model"))}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    attention.ops.mha_fused = spy
    try:
        for bf16 in (True, False):
            seq = MESH_SEQ if bf16 else MESH_FP32_SEQ
            tr = _smoke_trainer(cfg, seq, bf16, ckpt, mesh, dev, mb)
            ms = _timed_steps(tr)
            heads.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            tr.run()
            torch.cuda.synchronize()
            res = {"losses": [m["loss"] for m in tr.metrics_log],
                   "lr_sum": sum(m["lr"] for m in tr.metrics_log),
                   "step_ms": ms, "launches": _variant_counts(),
                   "heads": sorted(heads),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "traffic": {f"{op}/{g}": v for (op, g), v in
                               tr.collectives.traffic.items()},
                   "host_copies": tr.collectives.host_copies}
            if not bf16:
                # this rank's shards against the single-process run's:
                # the largest difference, and the difference's norm over
                # the norm of that run's own update on the same elements
                want = torch.load(want_path)
                specs = flatten_specs(tr._pspecs["params"])
                err, diff2, upd2 = 0.0, 0.0, 0.0
                for k, x in adamw.flatten(tr.params).items():
                    end, start = (local_shard(want[w][k], mesh, specs[k])
                                  .to(x.device).double()
                                  for w in ("end", "start"))
                    d = x.double() - end
                    err = max(err, float(d.abs().max()))
                    diff2 += float((d * d).sum())
                    upd2 += float(((end - start) ** 2).sum())
                res["param_err"] = err
                res["param_rel_err"] = math.sqrt(diff2 / upd2)
            out["bf16" if bf16 else "fp32"] = res
            tr.prefetch.stop()
            del tr
            torch.cuda.empty_cache()
    finally:
        attention.ops.mha_fused = base
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def _single_trainer(cfg, seq, bf16, ckpt):
    """The single-process Trainer on the card: phase 20's reference.
    Returns its losses, step walls, and its parameters before and after
    the run (on the host)."""
    from repro_torch.optim import adamw
    tr = _smoke_trainer(cfg, seq, bf16, ckpt)
    ms = _timed_steps(tr)

    def host():
        return {k: v.detach().cpu().clone()
                for k, v in adamw.flatten(tr.params).items()}
    start = host()
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    params = {"start": start, "end": host()}
    tr.prefetch.stop()
    del tr
    torch.cuda.empty_cache()
    return losses, params, ms


def mesh_cp_rank(rank, world, dev, prompts, forced):
    """One rank of phase 20's context-parallel decode: the prefill bundle
    then MESH_CP_STEPS decode-bundle steps (``context_parallel=True``)
    fed the single-process run's tokens, fp32, on a (1, world) mesh.
    Returns this rank's vocabulary block of every step's logits."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.services.collectives import CollectiveService
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_decode_bundle,
                                          make_prefill_bundle)
    from repro_torch.models.sharding import flatten_specs, local_shard
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m")
    mesh = make_host_mesh(1, world, device="cuda")
    svc = CollectiveService()
    max_len = MESH_CP_PROMPT + MESH_CP_STEPS
    kw = dict(param_dtype=torch.float32, cache_dtype=torch.float32,
              collectives=svc)
    rows = prompts.shape[0]
    pre = make_prefill_bundle(cfg, ShapeConfig("p", "prefill", max_len, rows),
                              mesh, **kw)
    dec = make_decode_bundle(cfg, ShapeConfig("d", "decode", max_len, rows),
                             mesh, context_parallel=True, **kw)
    full = _tp_weights(cfg, torch.float32)
    specs = flatten_specs(pre.in_shardings[0])
    params = adamw.unflatten({k: local_shard(x, mesh, specs[k].spec)
                              for k, x in adamw.flatten(full).items()})
    del full
    def traffic():
        """The service's counts so far, then zeroed."""
        out = {f"{op}/{g}": list(v) for (op, g), v in svc.traffic.items()}
        svc.traffic.clear()
        return out

    logits, cache = pre.jitted()(
        params, {"tokens": torch.as_tensor(prompts, device=dev)})
    blocks, ms, moved = [logits.cpu().numpy()], [], {"prefill": traffic()}
    pos = torch.full((rows,), MESH_CP_PROMPT, dtype=torch.int32, device=dev)
    for t in range(MESH_CP_STEPS):
        tok = torch.as_tensor(forced[t], device=dev)[:, None].int()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = dec.jitted()(params, cache, tok, pos)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        blocks.append(logits.cpu().numpy())
        pos = pos + 1
        if t == 0:
            moved["first_decode"] = traffic()
    moved["later_decode"] = traffic()
    return {"rank": rank, "logits": np.stack(blocks), "step_ms": ms,
            "cache_seq": int(cache["k"].shape[2]),
            "logits_spec": tuple(dec.out_shardings[0].spec),
            "traffic": moved}


def _per_step(traffic, steps):
    """Collective result bytes a step by operation, from a service's
    ``traffic`` ({"op/group": [calls, bytes]})."""
    out = {}
    for key, (n, nbytes) in traffic.items():
        op = key.split("/")[0]
        out[op] = out.get(op, 0) + nbytes / steps
    return out


def phase_mesh_launchers(card):
    """Phase 20: ``Trainer(mesh=...)`` on three meshes and the
    context-parallel decode bundle (see MESH_SEQ).  Returns rank 0's flash
    launches by mesh (the bf16 run's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-135m")
    t_phase = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    want_path = os.path.join(ckpt, "fp32_params.pt")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        ref_bf16, _, ref_ms = _single_trainer(cfg, MESH_SEQ, True, ckpt)
        ref_fp32, params32, _ = _single_trainer(cfg, MESH_FP32_SEQ, False,
                                                ckpt)
        torch.save(params32, want_path)
        del params32
        kw = dict(backend="gloo", device="cuda:0", timeout_s=MESH_TIMEOUT_S,
                  deadline_s=MESH_DEADLINE_S)
        launches, report, runs = {}, {}, {}
        for world in sorted({d * m for _, d, m, _ in MESH_TRAIN}):
            meshes = [x for x in MESH_TRAIN if x[1] * x[2] == world]
            t0 = time.perf_counter()
            outs = run_ranks(mesh_train_rank, world, meshes, want_path, **kw)
            for name, *_ in meshes:
                runs[name] = ([o[name] for o in outs],
                              time.perf_counter() - t0)
        for name, data, model, mb in MESH_TRAIN:
            outs, ranks_s = runs[name]
            local = (cfg.n_heads // model, cfg.n_kv_heads // model)
            rows = MESH_BATCH // data // mb
            for o in outs:
                tag = f"mesh {name} rank {o['rank']}"
                b, f = o["bf16"], o["fp32"]
                check(all(math.isfinite(x) for x in b["losses"]),
                      f"{tag}: non-finite bf16 loss {b['losses']}")
                err = max(abs(x - y) for x, y in zip(b["losses"], ref_bf16))
                b["loss_err"] = err
                check(err <= MESH_BF16_ATOL,
                      f"{tag}: bf16 losses {b['losses']} vs {ref_bf16}")
                n = cfg.n_layers * MESH_STEPS * mb
                check(b["launches"] == {
                    "fwd_wgmma": n, "fwd_fma": 0, "dq_wgmma": n, "dq_fma": 0,
                    "dkv_wgmma": n, "dkv_fma": 0},
                    f"{tag}: bf16 flash launches {b['launches']}, not {n} "
                    "tensor-core each")
                check(b["heads"] == [(rows, local[0], local[1], MESH_SEQ)],
                      f"{tag}: flash calls at (rows, H, K, S) {b['heads']}, "
                      f"not {(rows, *local, MESH_SEQ)}")
                ferr = max(abs(x - y) for x, y in zip(f["losses"], ref_fp32))
                f["loss_err"] = ferr
                check(ferr <= MESH_FP32_ATOL,
                      f"{tag}: fp32 losses {f['losses']} vs {ref_fp32}")
                p_tol = 2 * f["lr_sum"] + 1e-6
                check(f["param_err"] <= p_tol,
                      f"{tag}: fp32 params differ by {f['param_err']} > "
                      f"{p_tol}")
                check(f["param_rel_err"] <= MESH_PARAM_RTOL,
                      f"{tag}: fp32 params differ by {f['param_rel_err']} "
                      f"of the single-process update > {MESH_PARAM_RTOL}")
                check(f["launches"]["fwd_fma"] == n
                      and f["launches"]["fwd_wgmma"] == 0,
                      f"{tag}: fp32 flash launches {f['launches']}")
            r0 = outs[0]["bf16"]
            launches[name] = {"flash_attention_fwd": r0["launches"]
                              ["fwd_wgmma"],
                              "flash_attention_dq": r0["launches"]["dq_wgmma"],
                              "flash_attention_dkv": r0["launches"]
                              ["dkv_wgmma"]}
            st = np.asarray(r0["step_ms"])
            report[name] = {
                "ranks": data * model, "microbatches": mb,
                "local_heads": list(local), "rows_per_call": rows,
                "step_ms_p50": float(np.percentile(st, 50)),
                "step_ms": r0["step_ms"],
                "bf16_loss_max_abs_err": max(o["bf16"]["loss_err"]
                                             for o in outs),
                "fp32_loss_max_abs_err": max(o["fp32"]["loss_err"]
                                             for o in outs),
                "fp32_param_max_abs_err": max(o["fp32"]["param_err"]
                                              for o in outs),
                "fp32_param_atol": 2 * outs[0]["fp32"]["lr_sum"] + 1e-6,
                "fp32_param_err_of_update": max(o["fp32"]["param_rel_err"]
                                                for o in outs),
                "fp32_param_rtol": MESH_PARAM_RTOL,
                "collective_bytes_per_step": _per_step(r0["traffic"],
                                                       MESH_STEPS),
                "peak_gb_per_rank": [o["bf16"]["peak_gb"] for o in outs],
                "host_copies": [o["bf16"]["host_copies"] for o in outs],
                "ranks_s": ranks_s}
        print("[20] " + json.dumps({
            "card": card, "model": "smollm-135m (random weights, fp32 "
            "masters, bf16 compute)", "seq_len": MESH_SEQ,
            "global_batch": MESH_BATCH, "steps": MESH_STEPS,
            "ranks_on": "cuda:0, gloo",
            "single_process": {"losses": ref_bf16,
                               "step_ms_p50": float(np.median(ref_ms))},
            "meshes": report,
            "note": "step times are gloo staging through the host on one "
                    "card, with no TP or DP speed"}))

        # context-parallel decode: the single-process reference
        gen = torch.Generator().manual_seed(MESH_SEED)
        prompts = torch.randint(3, cfg.vocab_size,
                                (MESH_CP_ROWS, MESH_CP_PROMPT), generator=gen)
        full = _tp_weights(cfg, torch.float32)
        with torch.no_grad():
            logits, cache = T.prefill(full, cfg, prompts.cuda(),
                                      MESH_CP_PROMPT + MESH_CP_STEPS,
                                      cache_dtype=torch.float32)
            want, forced = [logits.cpu().numpy()], []
            pos = torch.full((MESH_CP_ROWS,), MESH_CP_PROMPT, device="cuda")
            for _ in range(MESH_CP_STEPS):
                tok = logits.argmax(-1)
                forced.append(tok.cpu().numpy())
                logits, cache = T.decode_step(full, cfg, cache, tok[:, None],
                                              pos)
                want.append(logits.cpu().numpy())
                pos = pos + 1
        del full, cache, logits
        torch.cuda.empty_cache()
        want = np.stack(want)
        t0 = time.perf_counter()
        outs = run_ranks(mesh_cp_rank, MESH_CP_WORLD, prompts.numpy(),
                         forced, **kw)
        ranks_s = time.perf_counter() - t0
        blk = cfg.padded_vocab // MESH_CP_WORLD
        got = np.concatenate([o["logits"] for o in outs], axis=-1)
        cp_err = float(np.abs(got[..., :cfg.padded_vocab] - want).max())
        for o in outs:
            check(o["logits_spec"][1] == "model"
                  and o["logits"].shape[-1] == blk,
                  f"cp rank {o['rank']}: logits block {o['logits'].shape}")
            check(o["cache_seq"] == (MESH_CP_PROMPT + MESH_CP_STEPS)
                  // MESH_CP_WORLD,
                  f"cp rank {o['rank']}: cache block {o['cache_seq']}")
        check(cp_err <= 1e-4, f"context-parallel decode logits {cp_err}")
        st = np.asarray(outs[0]["step_ms"])
        print("[20] " + json.dumps({
            "card": card, "cp_decode": "make_decode_bundle("
            "context_parallel=True), (data 1, model 4), fp32",
            "rows": MESH_CP_ROWS, "prompt": MESH_CP_PROMPT,
            "steps": MESH_CP_STEPS, "cache_block": outs[0]["cache_seq"],
            "logits_max_abs_err": cp_err, "atol": 1e-4,
            "step_ms_p50": float(np.percentile(st, 50)),
            "collective_bytes_prefill": _per_step(
                outs[0]["traffic"]["prefill"], 1),
            "collective_bytes_first_decode_step": _per_step(
                outs[0]["traffic"]["first_decode"], 1),
            "collective_bytes_per_later_decode_step": _per_step(
                outs[0]["traffic"]["later_decode"], MESH_CP_STEPS - 1),
            "ranks_s": ranks_s,
            "phase_s": time.perf_counter() - t_phase}))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def _kernel_name(mangled: str) -> str:
    """``name<type,ints>`` (or ``name<ints>`` for the bf16-only tensor-core
    kernels) from a mangled kernel name."""
    k = re.search(r"\d+([a-z]+(?:_[a-z]+)*_kernel)"
                  r"(?:I(f|13__nv_bfloat16)?((?:Li\d+E)+))?", mangled)
    if not k:
        return mangled
    if k.group(3) is None:
        return k.group(1)
    ints = ",".join(re.findall(r"\d+", k.group(3)))
    dtype = {"f": "float,", "13__nv_bfloat16": "bf16,"}.get(k.group(2), "")
    return f"{k.group(1)}<{dtype}{ints}>"


def build_report(build):
    """Print each kernel's registers, spills and shared memory, and every
    ptxas warning (such as wgmma serialised for want of registers), from
    nvcc's ptxas report."""
    for src in sorted(build.sources()):
        name, spill = None, ""
        for line in build.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            w = re.search(r"(\(C\d{4}\)[^']*)'(\S+)'", line)
            if m:
                name = _kernel_name(m.group(1))
            elif w:
                print(f"[2] ptxas warning {src}: {_kernel_name(w.group(2))}:"
                      f" {w.group(1).strip()}")
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "registers" in line:
                print(f"[2] ptxas {src}: {name}: "
                      f"{line.split(':', 1)[1].strip()}; {spill}")
                name = None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    t0 = time.perf_counter()
    took = _build.build()
    print(f"[2] built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: {took})")
    build_report(_build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    pa_err = phase_kernels(pa, paged_attention_ref, gen)
    pp_err = phase_prefill_kernels(gen)
    fa_err = phase_flash_kernels(gen)
    ssd_err = phase_ssd_kernels(gen)
    ssd_bwd_err = phase_ssd_bwd_kernels(gen)
    pa_launches, cfg, params = phase_main_path(card)
    pp_by_path = {"serving_smollm": _pp_count()}
    check(all(n == 0 for n in _flash_counts().values()),
          "the serving path launched a flash-attention kernel")
    check(_ssd_count() == 0, "the serving path launched the SSD kernel")
    phase_h2o_serving(card)
    pp_by_path["serving_h2o"] = _pp_count()
    _zero_counts()
    phase_shell(card, cfg, params)
    phase_migration(card, cfg, params)
    phase_dense_cache(card, cfg, params)
    granite_launches, pp_by_path["serving_granite"] = \
        phase_granite_serving(card)
    llama4_launches, pp_by_path["serving_llama4"] = \
        phase_llama4_serving(card)
    phase_moe_layer_card_vs_cpu(card)
    fa_launches, trainer, step_fn = phase_train(card)
    check(_ssd_count() == 0, "the training path launched the SSD kernel")
    ssd_launches, mcfg, mparams = phase_mamba_serving(card)
    phase_mamba_consistency(mcfg, card)
    zamba2_ssd, zamba2_fa, zcfg = phase_zamba2_serving(card)
    phase_zamba2_consistency(zcfg, card)
    whisper_prefill = phase_whisper_serving(card)
    phase_whisper_consistency(card)
    whisper_train = phase_whisper_train(card)
    family = {arch: phase_family_train(card, arch, batch, remat,
                                       trace=arch == "mamba2-1.3b")
              for arch, batch, remat in FAMILY_TRAIN}
    serve_launches, pp_by_path["serve_launcher"] = \
        phase_serve_launcher(card)
    tp_launches, pp_by_path["serving_smollm_tp3"] = \
        phase_tensor_parallel(card)
    mesh_launches = phase_mesh_launchers(card)
    phase_card_vs_cpu()
    phase_card_vs_cpu("granite-moe-1b-a400m", "granite")
    phase_train_card_vs_cpu()
    phase_train_card_vs_cpu("whisper-medium", "whisper")
    phase_train_card_vs_cpu(label="smollm", remat="full")
    phase_train_card_vs_cpu(label="smollm", remat="dots")
    phase_train_card_vs_cpu(label="smollm", compress=True)
    phase_train_card_vs_cpu("mamba2-1.3b", "mamba2")
    phase_train_card_vs_cpu("zamba2-2.7b", "zamba2")
    phase_train_card_vs_cpu("granite-moe-1b-a400m", "granite")
    phase_mamba_card_vs_cpu()
    phase_mamba_card_vs_cpu("zamba2-2.7b", "zamba2")
    phase_mamba_card_vs_cpu("whisper-medium", "whisper")
    timing = phase_timing(pa, paged_attention_ref, gen, card)
    pp_timing = phase_prefill_timing(gen, card)
    fa_timing = phase_flash_timing(gen, card)
    ssd_timing = phase_ssd_timing(gen, card)
    ssd_bwd_timing = phase_ssd_bwd_timing(gen, card)
    zamba2_timing = phase_zamba2_timing(gen, card)
    whisper_timing = phase_whisper_timing(gen, card)
    phase_decode_profile(cfg, params, card)
    del params
    phase_train_profile(trainer, step_fn, card)
    del trainer, step_fn
    phase_mamba_profile(mcfg, mparams, card)

    # launches: the sum over the main paths that run the kernel, each
    # counted from 0 just before it and read just after; ms, plain_ms,
    # bound_ms and library_ms at phase 7's main shape (zamba2's and
    # whisper's below)
    by_path = {
        "paged_attention": {"serving_smollm": pa_launches,
                            "serving_granite": granite_launches,
                            "serving_llama4": llama4_launches,
                            "serve_launcher": serve_launches,
                            "serving_smollm_tp3": tp_launches},
        "paged_prefill": pp_by_path,
        "flash_attention_fwd": {"train": fa_launches["flash_attention_fwd"],
                                "zamba2_prefill": zamba2_fa},
        "flash_attention_dq": {"train": fa_launches["flash_attention_dq"]},
        "flash_attention_dkv": {"train": fa_launches["flash_attention_dkv"]},
        "ssd": {"mamba2_prefill": ssd_launches,
                "zamba2_prefill": zamba2_ssd},
        "ssd_bwd": {}}
    for mesh, counts in mesh_launches.items():
        for name, n in counts.items():
            by_path[name][f"train_mesh_{mesh}_rank0"] = n
    for path, counts in (("whisper_prefill", whisper_prefill),
                         ("whisper_train", whisper_train)):
        for name, n in counts.items():
            by_path[name][path] = n
    for arch, counts in family.items():     # a path only where it runs
        for name, n in counts.items():
            if n:
                by_path[name][f"{arch.split('-')[0]}_train"] = n
    k_ms, p_ms, bound = timing[("main", torch.bfloat16)]
    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
        "replaces": PA_REPLACES, "max_abs_err": pa_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None}]
    k_ms, p_ms, bound = pp_timing["step"]
    kernels.append({
        "name": "paged_prefill", "route": "cuda", "source": PP_SOURCE,
        "replaces": PP_REPLACES, "max_abs_err": pp_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bound, "bound_by": "operations",
        "library_ms": None,
        "one_row_shape": dict(zip(("ms", "plain_ms", "bound_ms"),
                                  pp_timing["row"]))})
    for name, replaces in FA_REPLACES.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": FA_SOURCE if name.endswith("fwd") else FA_BWD_SOURCE,
            "replaces": replaces, "max_abs_err": fa_err[name],
            **fa_timing[torch.bfloat16][name]})
    kernels.append({
        "name": "ssd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "max_abs_err": ssd_err,
        **ssd_timing[torch.bfloat16]})
    kernels.append({
        "name": "ssd_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": SSD_BWD_REPLACES, "max_abs_err": ssd_bwd_err,
        **ssd_bwd_timing["mamba2"],
        "zamba2_shape": ssd_bwd_timing["zamba2"],
        "float32_fma": ssd_bwd_timing["mamba2_float32"]})
    for k in kernels:
        k["launches"] = sum(by_path[k["name"]].values())
        k["launches_by_path"] = by_path[k["name"]]
        k["variants"] = VARIANTS[k["name"]]
        if k["name"] in zamba2_timing:
            ms, bnd, plain, lib = zamba2_timing[k["name"]]
            k["zamba2_shape"] = {"ms": ms, "bound_ms": bnd, "plain_ms": plain,
                                 "library_ms": lib}
        if k["name"] in whisper_timing:
            k["whisper_shape"] = whisper_timing[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
