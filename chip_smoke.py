#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--sweep]

Phases, each of which must pass (the script exits non-zero otherwise):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off for
   matmul and cuDNN.
2. build: every CUDA kernel of the port (MLA decode attention, dispatch
   quantize, INT8 GEMM, SSD scan), compiled from
   ``src/repro_torch/kernels/csrc`` into ``build/kernels/`` (one ``nvcc``
   per source, all at once), with what ``ptxas`` reports for each kernel
   function (registers, spills).
3. serve: DeepSeek-R1 at full width cut to 4 layers (3 dense + 1 MoE with
   all 256 experts), bf16 random weights from a seed, through
   ``ServingSystem.serve``: 8 requests with prompt lengths drawn uniformly
   from 256-1024 tokens and 32 new tokens each. Every request must finish,
   and the MLA kernel's launch count must equal decode steps x 4 MLA
   layers. Wall-clock prefill time and TTFT per request, TTFT/TPOT p50 and
   decode tokens/s.
4. serve-lep: the same requests served with ``moe_fn=make_lep_moe_fn()``
   at world size 1 (LEP with early INT8 dispatch). Every request must
   finish, and the dispatch-quantize kernel must launch once per MoE call.
   TTFT/TPOT p50 and decode tokens/s beside the serve phase's, and the
   share of served tokens equal to it (reported, not gated).
5. kernel: ``mla_decode_attention`` against its plain PyTorch version at
   DeepSeek-R1 widths (B=8, H=128, R=512, Dr=64), S=2048 and a ragged
   S=1000 with per-row ``cache_len`` including 0, S-1 and S, full rows,
   and the serve phase's own final lengths (the row the kernels line
   reports); median CUDA-event times of the kernel, the same call replayed
   from a CUDA graph (the device's time without the wrapper's host time),
   the plain version and one library call, beside the least time the card
   could take (the operations at a third of the TF32 rate, as the kernel
   runs them in 3xTF32, with the FP32 reading beside it), the kernel's
   piece count and partial (m, l, acc) bytes; the tensor-core
   instructions of each kernel function (``mla-sass:``; the attention
   kernel must use TF32 ones). With ``--sweep``, also the kernel at each
   piece count of SWEEP_PIECES.
6. dispatch_quant: ``dispatch_quantize`` against its plain version at the
   LEP dispatch buffers of the serve-lep phase (decode: 256 slots x 8 rows,
   64 of them filled; the same buffer with every row filled; the longest
   prompt's prefill: 256 x 48) and one 8 x 7168 activation, each with its
   launch plan (``dispatch_quant/plan.py``): kernel times by events and by
   a CUDA-graph replay, and plain times, beside the byte bound and
   ``bound_frac`` (bound over graph time). Then, untimed, at the
   DQ_RAGGED shapes (every plan the kernel has) and at rows planted at
   rounding boundaries (``ref.bf16_boundary_rows``, every bf16 value up to
   absmax for 128 mantissas of absmax; ``ref.f32_boundary_rows``) through
   the ring and the cluster split. Every code must equal the plain
   version's and the packed scale tail be bit-identical.
7. int8: the §4.5 INT8 linear path on the served cut's INT8-policy
   projections (wq_a, wq_b, wkv_a, wo, the dense and shared-expert
   w_gate/w_up/w_down; every K a multiple of 16): ``calibrate_linear`` on
   activations captured from one served prompt's prefill,
   ``quantized_matmul`` on another's at M=8 and at its prompt length;
   relative error against the bf16 product; the INT8 GEMM against its
   plain version (bit-identical), with the kernel's plan (tile, swap-AB,
   K splits), its time beside a CUDA-graph replay of the same call (the
   device's time without the wrapper's host time), the plain version's,
   ``torch._int_mm``'s on the weight as the port stores it (K-major,
   cuBLAS's TN layout) and the bound; no call of the path or of these 20
   cases may take the wrapper's padded path. Then at the INT8_RAGGED
   shapes against its plain version, and the int8 tensor-core
   instructions of each kernel function (``int8-sass:``; every GEMM
   variant must use the warpgroup ``IGMMA`` and none the older ``IMMA``).
8. agreement: requests of three prompt seeds served with
   ``moe_fn=moe_reference`` (no capacity drops) are replayed through
   ``decode_step`` (kernel on) and checked against a full-sequence
   ``prefill`` over prompt + generated tokens (logits within AGREE_ATOL
   where both chose the same experts; served tokens equal to the
   reference's argmax where its margin is clear).
8a. serve-mtp: MTP speculative decoding on the same cut: 8 prompts of 640
   tokens (one length: ``fit_draft_head`` takes one array), 32 new tokens
   each. The draft head (``init_mtp_params`` seed 1) is distilled by
   ``fit_draft_head`` on those prompts (gen_len 64, 300 steps), then the
   traffic is served through ``ServingSystem(use_mtp=True)`` twice: per
   step with the two-decode-step verify (the MLA kernel must launch 2 x
   iterations x 4 layers exactly) and fused in chunks of 4 (no MLA kernel:
   the fused verify is plain ``prefill_continue``, as in JAX). Every
   request must finish, a draft must be accepted, and each served token
   must be the argmax of a teacher-forced prefill over prompt + served
   tokens wherever its margin exceeds MTP_MARGIN (expert flips counted as
   in the agreement phase, via a batch-1 replay). Acceptance, tokens per
   iteration, TTFT/TPOT p50, decode step p50, ``fit_draft_head`` seconds,
   peak memory.
8b. serve-ems: two turns through one ``ServingSystem`` with an
   ``EMSService`` (blocks of 8): the serve traffic, then each prompt + its
   32 served tokens + 64 new. Turn 2 must reuse exactly the first turn's
   whole blocks, run its suffixes through ``prefill_continue``, keep the
   EMS promote/demote bytes equal to its transfer engine's, launch the MLA
   kernel decode steps x 4 times in each turn, and give first tokens that
   agree with a cold prefill of the same prompts that drops no token
   (logits within AGREE_ATOL where the last token's experts agree). Hit
   rate, turn-2 prefill time beside the cold prefill's (timed bare, and
   under turn 2's instrumentation: the device synchronized around it and
   an expert recorder on its MoE call), and the reuse path's parts (fetch,
   suffix, store).
8c. cli: ``repro_torch.launch.serve.main`` in this process on the card
   (``--arch deepseek-r1 --mtp --mtp-fused --fit-draft --decode-chunk 4``,
   EMS on): it must finish, show ``reused>0`` for a later rid and fewer
   iterations than tokens; then the same with ``--arch qwen3-8b``
   (``cli-dense``: GQA attention, no kernel).
8c'. hybrid-prefill, serve-hybrid: a one-rank NCCL process group (file
   rendezvous) and a 1 x 1 ``("data", "model")`` ``DeviceMesh`` over it are
   made once for this and the next phase; every collective of the parallel
   layer is then on an axis of one rank and moves nothing. The serve
   traffic's 8 prompts are prefilled plain and with ``REPRO_MLA_HYBRID`` =
   a2a and rs (the §4.3.1 SP -> TP -> SP MLA prefill on every MLA layer):
   logits within AGREE_ATOL of the plain prefill's, no kernel. Then the R1
   serve with ``REPRO_MLA_HYBRID=a2a``: every prefill's 4 MLA layers
   through the hybrid, the MLA kernel decode steps x 4 times, tokens held
   against the serve phase's by margins (``hold_partings``).
8c'''. sharded-step: over the same mesh, before R1's weights are freed,
   the dry run's sharded steps on real tensors (``launch/sharded_step.py``:
   ``decode-r1``, the served cut's decode step over f32 caches of 8 x
   2048; ``prefill-r1-a2a``, the served cut's prefill of B = 2, S = 512
   with every MLA layer through the §4.3.1 hybrid; ``train-mamba2``,
   Mamba2-780m whole in f32, and ``prefill-mamba2``, the same in bf16,
   at B = 2, S = 512) through ``dryrun.build_step`` on the card, every
   weight drawn from the seed and placed one at a time (R1's bit-equal
   to the serve's): the kernels launched on the DTensor path (4 MLA and
   1 dispatch-quantize; 1 dispatch-quantize; 48 SSD scans; 48), each
   step against the same step unsharded on the card (the hybrid against
   the plain prefill), and the collective bytes the counter sees (0,
   equal to the dry run's 1 x 1 record of the same case, traced in a
   process of its own). Then, R1's weights freed, ``train-r1`` (R1 with
   LEP in a train step at its widths, f32, 12 experts of top-8) cut to
   SHARDED_LAYERS' 2 layers (a dense one, a MoE one) at B = 2, S = 512,
   held and counted alike: 1 dispatch-quantize.
8c''. kimi-lep-agree, serve-kimi, serve-kimi-tokens: with R1's weights
   freed, Kimi K2 at its widths (d_model 7168, 64 heads over 8 KV heads,
   384 experts top-8 of d_ff 2048, 1 shared expert, vocab 163840) cut to
   2 layers (19.615 B parameters, bf16 random weights from a seed). On
   the MoE layer's inputs of one prefill (S = 1019) and one 8-row decode
   step: the production plan (``pick_lep_plan`` at 16 x 16, serving: EP
   over model, the FFN over data) bit-equal to the 1-D LEP at world size
   1, and the token gather with its second hop quantized within
   QUANT_REL_TOL of ``moe_capacity``; event times of each. Then the serve
   traffic through each plan, the experts first cut to the rank's share
   (``keep_local_experts``; on one rank every weight stays as it was):
   every request finishes, the
   dispatch-quantize kernel launches once per MoE call (the production
   plan) or twice (the token gather); decode step p50 beside the experts'
   byte bound; serve-kimi-tokens' tokens held against serve-kimi's by
   margins.
8d. serve-dense: with the Kimi weights freed, Qwen3-8B whole (36
   layers, d_model 4096, 32 heads over 8 KV heads of 128, d_ff 12288,
   vocab 151936, qk-norm; bf16 random weights from a seed) serves the
   serve phase's traffic through the same ``ServingSystem``. GQA attention
   is plain PyTorch (JAX's is plain ``jnp``): every request must finish
   and no kernel may launch. Prefill time per request, TTFT/TPOT p50,
   decode step p50, decode tokens/s, peak memory.
8e. dense-agreement: three served prompts (DENSE_AGREE_RIDS) replayed
   through ``decode_step`` at batch 1 against a full-sequence ``prefill``
   over prompt + served tokens (logits within DENSE_AGREE_ATOL at every
   position; served tokens equal to the prefill's argmax where its margin
   exceeds DENSE_MARGIN); then the ring check at the config's own
   ``sliding_window`` of 8192: two prompts of RING_PROMPT_LEN tokens and 32
   new through ``ServingSystem(capacity=8480, decode_batch=2)``, whose
   decode caches must be rings of 8192 slots, each request replayed from a
   ring prefill and held the same way against a prefill past the window
   (where the window mask applies).
8f. int8-dense: the int8 phase's §4.5 path on Qwen3-8B's seven
   INT8-policy projections of layer 0 (wq, wk, wv, wo, w_gate, w_up,
   w_down) at M=8 and M=940: 14 ``int8-dense:`` rows, bit-identical to the
   plain version, no padded path, and one summary line of their sums.
8f'. serve-faults: with Qwen3-8B still loaded, the same traffic through
   two decode engines of FAULT_DECODE_BATCH slots under the pool
   autoscaler (1 to 3 engines) and a seeded fault plan (an engine crash
   mid-decode, a timeout of the first KV transfer). A crash must fire and
   be recovered by replay re-prefill, the autoscaler must grow or shrink
   the pool, no kernel may launch, every request must finish, and its
   tokens must be a prefill's argmax wherever the margin exceeds
   DENSE_MARGIN and part from serve-dense's only where the margin is below
   it (bf16 rounds a 4-row decode step otherwise than an 8-row one).
   TTFT/TPOT p50, decode step p50 and tokens/s beside serve-dense's.
8g. serve-olmoe, serve-olmoe-lep: with Qwen3's weights freed, OLMoE-1B-7B
   whole (16 layers, d_model 2048, 16 heads, 64 experts x 1024, top-8;
   bf16 random weights from a seed) serves the same traffic with
   ``moe_capacity``, then with ``make_lep_moe_fn()`` at world size 1
   (the dispatch-quantize kernel once per MoE call: 16 a forward). Every
   request must finish; the share of LEP's tokens equal to the capacity
   serve's is reported. Then ``dispatch_quant-olmoe:`` rows, the phase 6
   check and timing at OLMoE's decode, fully filled and longest prefill
   dispatch buffers (D = 2048) and an 8 x 2048 activation.
9. serve-ssm: with the other models' weights freed, Mamba2-780m at full
   width and full depth (48 layers), bf16 random weights from a seed,
   serves the same traffic through the same ``ServingSystem``. Every
   request must finish, and the SSD-scan kernel must launch once per layer
   of every prefill (48 x 8). Wall-clock prefill time per request,
   TTFT/TPOT p50, decode step p50, decode tokens/s and peak memory.
10. ssd_scan: ``ssd_scan`` against its plain PyTorch version at the served
   widths (B=1, H=48, P=64, N=128, Q=128) at S=1019 (ragged) and S=448
   (whole chunks), each timed beside the plain version and the bound (the
   operations at a third of the TF32 rate, as the kernel runs them in
   3xTF32, with the FP32 reading beside it), and the same call replayed
   from a CUDA graph (the device's time without the wrapper's host time)
   and each stage kernel's device time (``torch.profiler``); at S=1019
   each of the kernel's four stages, from the wrapper's scratch, against
   its plain stage; the tensor-core instructions of each kernel function
   in the built library's SASS (``cuobjdump -sass``); then,
   untimed, B=2, S < Q, S=1, and P and N that are not multiples of the
   kernel's tiles; and one small case against the token recurrence
   ``ssd_reference``.
11. ssm-agreement: Mamba2 decode against prefill on three served prompts:
   in float32 from a zero state over their first 192 tokens (logits within
   SSM_F32_ATOL, argmax equal where the margin is clear); in float32 from
   a prefill of the first 160 (the kernel's final state handed to
   ``decode_step``, within SSM_F32_ATOL; two planted faults, a zeroed
   state and a zeroed conv window, far outside); in float32 served through
   ``ServingSystem`` and replayed (logits within SSM_WINDOW_ATOL of the
   prefill, served tokens equal to the replay's argmax where its margin is
   clear); and in bf16, the
   served requests replayed, whose error against the float32 prefill may
   be at most SSM_BF16_RATIO times the bf16 prefill's.
11a. train-ssm: the served Mamba2 model trained in place through
   ``repro_torch.train.train``: TRAIN_STEPS AdamW steps on the seeded
   synthetic corpus at TRAIN_BATCH x TRAIN_SEQ, every weight's gradient
   through ``lm_loss``, the SSD scan's forward on the kernel (by way of its
   autograd Function) and its backward in plain PyTorch. Every loss and
   gradient norm finite, the last loss below the first, exactly one SSD
   scan a layer a forward and no other kernel. Each step's loss, gradient
   norm and learning rate, step time p50, tokens/s, peak memory.
11b. train-ssd-grad: the SSD Function at SSD_GRAD_CASES (Mamba2's training
   widths, Zamba2's heads and state): its outputs against the plain
   version within SSD_TOL, its gradients against autograd through the
   plain ``ssd_chunked`` within SSD_GRAD_TOL of each gradient's max |g|;
   the backward's CUDA-event time beside the plain graph's backward and
   the kernel's forward; the raw wrapper must refuse an input that
   requires grad.
11c. ckpt: the trained model saved (bf16 leaves as raw ``<V2``) and loaded
   into a fresh model: every leaf bit-equal and the next batch's loss
   equal. Shards, bytes, seconds.
12. serve-zamba: with Mamba2's weights freed, Zamba2-1.2B whole (38 Mamba2
   layers in 6 groups of 6, each followed by the one shared attention
   block with its own K/V, then a tail of 2; d_model 2048, 64 SSM heads of
   64, N = 64; bf16 random weights from a seed) serves the same traffic
   through the same ``ServingSystem``. Every request must finish, and the
   SSD-scan kernel must launch once per Mamba layer of every prefill
   (38 x 8), no other kernel. The sizes it holds (``zamba-sizes:``),
   prefill time per request, TTFT/TPOT p50, decode step p50, decode
   tokens/s and peak memory.
13. zamba-agreement: Zamba2 decode against prefill on three served
   prompts, in float32 after a prefill of their first 160 tokens (from
   prefill's state with float32 conv windows within ZAMBA_F32_ATOL, from
   its own bf16 windows within ZAMBA_WINDOW_ATOL; a zeroed group K/V and
   two groups' swapped SSM states planted, far outside); float32 served
   and replayed; bf16 replayed (at most ZAMBA_BF16_RATIO times the bf16
   prefill's error against the float32 one).
14. ssd_scan-zamba: the kernel against its plain version at Zamba2's
   widths (B=1, H=64, P=64, N=64, Q=128) at S=1019 and S=448, timed as in
   phase 10, the first also stage by stage.
15. cli-zamba: the CLI in this process at ``--arch zamba2-1.2b`` (smoke
   width): every request finishes, none reuses a prefix, and the SSD scan
   launches once per layer of every prefill, no other kernel.
16. forward: one model at a time at full width: Zamba2 over the 1019-token
   prompt (``forward``'s logits bit-equal to ``prefill``'s; 2 x 38 SSD
   scans); InternVL2-2B (1.89 B parameters) over 256 patch embeddings and
   512 tokens (bit-equal to ``prefill``, then VLM_DECODE_STEPS decode steps
   within DENSE_AGREE_ATOL of a forward over the longer sequence);
   HuBERT-XLarge (1.26 B) over 1024 audio frames (finite logits). No
   kernel but the SSD scan may launch.
17. examples: the port's examples and dev smoke through their ``main`` on
   the card, at the JAX examples' own sizes (EXAMPLES):
   ``examples/torch_quickstart.py`` (its INT8 linear through the
   dispatch-quantize and INT8 GEMM kernels; the relative error printed),
   ``examples/torch_serve_pdc.py`` on Qwen3 and on R1 with MTP (the MLA
   kernel), ``examples/torch_mtp_speculative.py`` (tokens equal to greedy
   decoding), ``examples/torch_train_moe_100m.py`` for EXAMPLE_TRAIN_STEPS
   steps (the last loss below the first) and ``scripts/torch_dev_smoke.py``
   over every config (the Mamba2 and Zamba2 prefills through the SSD
   scan). One line each with its key numbers and kernel launches; each of
   the four kernels must launch in the phase.
18. dryrun: the port's dry run (``repro_torch.launch.dryrun``), shapes
   only, each pair in a process of its own on a fake process group, all
   started together: the nine pairs of DRYRUN_PRODUCTION (DeepSeek-R1,
   OLMoE and Kimi K2 decode_32k on 16 x 16, Kimi also on 2 x 16 x 16;
   Qwen3-8B, R1, Mamba2 and Zamba2 train_4k; R1 prefill_32k) must be
   ``ok``, with argument bytes equal to JAX's and collective bytes at most
   DRYRUN_COLL_FACTOR times JAX's (OLMoE decode_32k, whose expert
   redundancy is a permute, DRYRUN_OLMOE_FACTOR); their three roofline
   terms, computed from the H100's data-sheet rates, argument GiB a rank
   and collective bytes by kind are printed, each pair's total beside
   JAX's and the CPU sweep's (DRYRUN_CPU_SWEEP: the permute bytes, which
   the port issues itself, equal to the sweep's, the total within
   DRYRUN_SWEEP_TOL of it; OLMoE's collective term below DRYRUN_OLMOE_COLL_S;
   R1 train_4k at most DRYRUN_R1_TRAIN_FACTOR times JAX's; Qwen3-8B
   train_4k's all-gather, K/V projections included, under
   DRYRUN_QWEN3_AG_BYTES); then a 1 x 1
   record of the decode step of each serve config (the R1 and Kimi cuts,
   Qwen3-8B, OLMoE, Mamba2, Zamba2: batch 8, capacity 2048, float32
   caches), whose argument bytes must equal the bytes its serve's engine
   holds for a step, with no collective byte; beside it the roofline
   step, the step measured after the serve (wall p50 and device time
   under ``torch.profiler``) and ``decode_cost_from_roofline``'s step.

Each path phase (serve, serve-lep, int8, serve-mtp's two serves,
serve-ems's two turns, cli, hybrid-prefill, serve-hybrid, kimi-lep-agree's
calls, serve-kimi, serve-kimi-tokens, serve-dense, the ring serve, int8-dense,
serve-faults, serve-olmoe, serve-olmoe-lep, serve-ssm, train-ssm, ckpt,
serve-zamba, cli-zamba, forward, each example)
sets every kernel's launch count to 0 just before it and reads the counts
just after; the kernels line lists each kernel's by path. The last
two lines of standard output are a ``{"kernels": [...]}`` JSON object (one
entry per kernel; ``int8_matmul``'s times are sums over the int8 phase's
cases) and ``{"ok": true, "device": {...}}``. Without CUDA, or without the
port's package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

SEED = 0
KERNEL_TOL = 3e-5        # f32 kernel vs f32 plain version (summation order)
# bf16 agreement of decode replay vs full prefill: logits have unit scale
# (rms-normed state times a fan-in-scaled head), a bf16 ulp near 4 is
# 2^-6, and the absorbed decode and unabsorbed prefill round at different
# places through 4 layers -- 0.1 allows ~6 ulps at the largest logits.
AGREE_ATOL = 0.1
AGREE_SEEDS = (1, 2, 3)      # prompt seeds (offsets of SEED), 3 prompts each
# Where the two forms chose different experts the logits are not compared.
# The three seeds read 3 to 8 flips in 48 positions each (6-17 %) on an
# H100 at 700 W (PERF.md); a quarter is the most the phase lets pass.
MAX_FLIP_SHARE = 0.25
SWEEP_PIECES = (1, 17, 33, 44, 66, 132)     # n_pieces values of --sweep
# The kernel's lse variant: lse within LSE_RTOL of max(|lse|, 1) of the plain
# version's (both f32; the kernel's products in 3xTF32). Empty rows: the
# bounds a rank's block of a sequence-sharded cache gives rows that end
# before it (negative), beside full, frozen and short rows. The sharded
# path's arithmetic: the serve's cache cut into MLA_SPLIT_BLOCKS blocks.
LSE_RTOL = 1e-5
MLA_EMPTY_LENS = [-1, 2047, -300, 1024, 0, -2, 31, 2048]
MLA_SPLIT_BLOCKS = 4
# serve-mtp: 8 prompts of one length (fit_draft_head takes one (n_seq,
# prompt_len) array, as the serve CLI passes it), 32 new tokens each; the
# draft head from seed 1 is distilled on them over MTP_FIT_GEN generated
# tokens with fit_draft_head's default 300 Adam steps.
MTP_N_REQ, MTP_PROMPT_LEN, MTP_NEW = 8, 640, 32
MTP_FIT_GEN = 64
MTP_FIT_STEPS = 300
# Served tokens against the argmax of a teacher-forced prefill over prompt
# + served tokens. The served decode (8 rows a step) and its replay at
# batch 1 round differently, and so do the replay and the prefill (the
# absorbed and unabsorbed forms); where the experts agree each pair lies
# within AGREE_ATOL (the replay-vs-prefill pair is gated here, as in the
# agreement phase), so a served logit lies at most 2 x AGREE_ATOL from the
# prefill's and a top-1/top-2 margin above 4 x AGREE_ATOL cannot flip the
# token. Positions where the replay and the prefill chose different
# experts -- or the prefill's capacity buffer dropped the token -- are
# counted as flips, not checked (at most MAX_FLIP_SHARE of them).
MTP_MARGIN = 4 * AGREE_ATOL
# serve-ems: blocks of 8 tokens (the serve CLI's), and each second turn
# adds the first turn's 32 served tokens and 64 new ones.
EMS_BLOCK = 8
EMS_TURN2_NEW = 64
# Per-row quantization: both versions divide by 127 and by the scale with
# IEEE f32 division and round half to even, so every code must be equal (a
# kernel that truncates, rounds half away from zero or multiplies by a
# reciprocal differs by 1 at some boundary); the scale (one f32 division)
# may differ in its last bit.
DQ_SCALE_RTOL = 1e-6
# Shapes that the served path does not give but the kernels take, for
# their other branches: (name, T, D, dtype, pack, offset) for per-row
# quantization -- a wide f32 row (cluster split, 16-byte loads), an odd
# width (element loads, unaligned packed rows), a misaligned pointer
# (offset in elements), no rows; the same three at T past the split (the
# ring at two stages of 80,000 bytes, one block an SM, and the plain-load
# rows path twice), a row too long for two ring stages (rows path: D has no
# limit), f32 rings with packed and unpacked rows whose code rows start 4
# bytes off an 8-byte boundary, an f32 activation, one row (a cluster of
# 8) and T = 66 (the largest split, a cluster of 2); for the INT8 GEMM,
# (M, K, N, out dtype, x_q's base offset in bytes) -- M, N and K tails,
# K % 16 != 0 and a misaligned x_q (the wrapper's padded path), N % 4 != 0,
# with and without split K, K = 0, M = 33/64/65 around the swap-AB
# threshold, M = 8 with K a multiple of neither the 128-byte block nor
# block x splits, and wkv_a's N = 576 at the served prompt's M = 940.
DQ_RAGGED = (("wide f32", 64, 20000, "float32", False, 0),
             ("odd width bf16", 37, 1001, "bfloat16", True, 0),
             ("misaligned bf16", 16, 7168, "bfloat16", True, 1),
             ("no rows", 0, 7168, "bfloat16", True, 0),
             ("wide f32, many rows", 200, 20000, "float32", False, 0),
             ("odd width bf16, many rows", 300, 1001, "bfloat16", True, 0),
             ("misaligned bf16, many rows", 512, 7168, "bfloat16", True, 1),
             ("past two stages bf16", 160, 131072, "bfloat16", True, 0),
             ("f32 packed", 300, 4096, "float32", True, 0),
             ("f32 D % 8 = 4", 300, 1028, "float32", False, 0),
             ("activation f32", 8, 7168, "float32", False, 0),
             ("one row", 1, 7168, "bfloat16", True, 0),
             ("largest split", 66, 7168, "bfloat16", True, 0))
DQ_BOUNDARY_F32_ROWS = 512
INT8_RAGGED = ((17, 100, 130, "float32", 0), (17, 100, 130, "bfloat16", 0),
               (1, 896, 72, "float32", 0), (100, 200, 130, "float32", 0),
               (1000, 72, 2050, "float32", 0), (3, 0, 5, "float32", 0),
               (33, 2048, 1536, "float32", 0), (64, 2048, 1536, "bfloat16", 0),
               (65, 2048, 1536, "float32", 0), (8, 4112, 1024, "float32", 0),
               (8, 7168, 2048, "float32", 3), (940, 7168, 576, "float32", 0))
INT8_SWAP_MAX_M = 64     # the kernel's swap-AB (decode) threshold
# INT8 GEMM, f32 output: the integer product is exact on both sides and
# the epilogue rounds in the same order, so the kernel equals the plain
# version; 1e-6 leaves one f32 rounding.
INT8_RTOL = 1e-6
INT8_CALIB_RID, INT8_EVAL_RID = 3, 0     # 448- and 940-token served prompts
# SSD scan, f32 kernel vs f32 plain version: sums of up to N = 128 products
# (C.B, C.h) and Q = 128 terms (W.x, the state update) taken in another
# order, and CUDA's expf against PyTorch's exp (each within 2 ulp). The
# relative part is the repository's own SSD-kernel tolerance
# (tests/test_kernels.py:79-80). The absolute part scales with the output's
# largest magnitude: at the served dt (softplus of a unit normal) cum falls
# to about -140 within a chunk, where an f32 ulp of cum is ~1.5e-5, so each
# decay exp(cum_t - cum_s) carries a relative error of that order, and so
# does every term it scales, up to the largest output (|y| of a few
# hundred at S = 1019: the phase's max_abs_y). Such terms cancel into
# outputs near 0, whose error is then of the terms' order. The phase
# reports how far the kernel and the f32 plain version each lie from a
# float64 evaluation of the same inputs, in units of max|y| (a few 1e-6):
# SSD_ATOL_REL allows several times that.
SSD_TOL = 2e-4
SSD_ATOL_REL = 2e-5
# (name, B, S, H, P, N, timed): the served widths at two served prompt
# lengths, both timed -- 1019 (7 chunks of 128 and a ragged one of 123) and
# 448 (3 and a ragged 64) -- then untimed: whole chunks only, and the
# kernel's other branches.
SSD_CASES = (("served S=1019", 1, 1019, 48, 64, 128, True),
             ("served S=448", 1, 448, 48, 64, 128, True),
             ("whole chunks S=512", 1, 512, 48, 64, 128, False),
             ("B=2", 2, 300, 8, 64, 128, False),
             ("S<Q", 1, 50, 8, 64, 128, False),
             ("S=1", 1, 1, 8, 64, 128, False),
             ("P, N off the tiles", 1, 200, 3, 40, 100, False))
SSD_ORACLE_CASE = (1, 200, 2, 64, 128)       # B, S, H, P, N
SSM_AGREE_RIDS = (7, 3, 6)       # the 265-, 448- and 615-token prompts
# Mamba2 decode (the recurrence) against prefill (the chunked scan through
# the kernel). The logits have unit scale (the tied head over an rms-normed
# state; |logit| reaches ~4).
# - In float32, from a zero state, the two forms compute one function in
#   another order: f32 round-off (~1e-7 relative) through 48 layers, which
#   random weights amplify (the bf16 drift below grows ~4x from 12 to 48
#   layers), stays far below 1e-3; SSM_F32_ATOL = 2e-3.
# - In float32 after a prefill (the handoff), the decode starts from the
#   kernel's final state and from a conv window that prefill stored in
#   bf16, as the JAX package does. With the window taken from the
#   recurrence instead, only the kernel's state differs, and the decode
#   must stay within SSM_F32_ATOL. With prefill's own bf16 window, its
#   rounding (2^-9 relative) enters the next three tokens' inputs in every
#   layer, and 48 layers of random weights grow it to a tenth of a logit
#   (0.086-0.164 on an H100, PERF.md; from the kernel's state with the
#   recurrence's window, 3.4e-4): SSM_WINDOW_ATOL is 1.5 times the worst.
#   A lost state -- a zeroed h or conv window, planted on the card -- read
#   4.8-5.1 there, and must err by more than SSM_FAULT_FACTOR x
#   SSM_WINDOW_ATOL.
# - In bf16 the forms see differently rounded inputs in every layer (prefill
#   rounds x, B and C to bf16 after the convolution and stores the conv
#   window in bf16; decode keeps them in f32, as the JAX package does), and
#   48 layers of random weights grow such differences along the decode
#   steps to the logits' own scale, so no fixed atol separates rounding
#   from a fault. The bound is measured instead: against the float32
#   prefill of the same weights and tokens, the bf16 decode may err by at
#   most SSM_BF16_RATIO times what the bf16 prefill errs (if both are as
#   accurate as bf16 allows they differ by at most twice that, by the
#   triangle inequality). A lost or misplaced state is no bf16 rounding and
#   moves the decode much further than the prefill's own error.
SSM_F32_ATOL = 2e-3
SSM_F32_TOKENS = 160         # one chunk of 128 and a ragged one of 32
SSM_HANDOFF_STEPS = 32       # decoded after a prefill of SSM_F32_TOKENS
SSM_WINDOW_ATOL = 0.25
SSM_FAULT_FACTOR = 10.0
SSM_BF16_RATIO = 2.0
# Zamba2-1.2B whole (zamba-agreement): decode after a prefill of the first
# ZAMBA_F32_TOKENS of three served prompts against a full prefill, as
# ssm-agreement's handoff does, over 38 Mamba2 layers and 6 applications
# of the shared attention block.
# - In float32 from prefill's state with float32 conv windows (the state
#   prefill computes, before the bf16 rounding the JAX package stores the
#   windows with): the kernel's SSM state and the shared K/V handed to
#   decode_step compute the prefill's function in another order, f32
#   round-off grown by random weights; SSM_F32_ATOL's derivation holds and
#   ZAMBA_F32_ATOL = SSM_F32_ATOL.
# - From prefill's own state (its conv windows in bf16, as in JAX): the
#   rounding (2^-9 relative) enters the next three tokens' inputs of every
#   Mamba layer, and the layers grow it: on an H100 80GB HBM3 at 700 W it
#   read 0.197 at the handoff and 0.111-0.167 in the served replays
#   (PERF.md); ZAMBA_WINDOW_ATOL is 1.5 times the worst. The same
#   state with float32 windows read 4.2e-4.
# - Planted faults, on the float32-window state: one group's shared K/V
#   zeroed, and groups 0 and 1 holding each other's SSM state (a state
#   restored to the wrong group). Each must err by more than
#   ZAMBA_FAULT_FACTOR x ZAMBA_F32_ATOL, the tolerance of the check that
#   holds the state they are planted in (they read 0.978 and 5.76).
# - float32 served and replayed, and bf16 replayed against the bf16 and the
#   f32 prefill, as ssm-agreement holds Mamba2 (the bf16 bound measured by
#   ZAMBA_BF16_RATIO for the same reason as SSM_BF16_RATIO).
ZAMBA_AGREE_RIDS = (7, 3, 6)     # the 265-, 448- and 615-token prompts
ZAMBA_F32_TOKENS = 160           # one chunk of 128 and a ragged one of 32
ZAMBA_HANDOFF_STEPS = 32
ZAMBA_F32_ATOL = SSM_F32_ATOL
ZAMBA_WINDOW_ATOL = 0.3
ZAMBA_FAULT_FACTOR = 100.0
ZAMBA_BF16_RATIO = 2.0
# (name, B, S, H, P, N): the SSD scan at Zamba2's served widths (64 heads of
# 64, state N = 64: half the kernel's 128-column state tile) at the two
# served prompt lengths that phase 10 times.
ZAMBA_SSD_CASES = (("zamba S=1019", 1, 1019, 64, 64, 64),
                   ("zamba S=448", 1, 448, 64, 64, 64))
# forward: one model at a time at full width. Zamba2 over the longest
# served prompt; InternVL2-2B over 256 patch embeddings (one 448 px tile)
# and 512 tokens, then VLM_DECODE_STEPS greedy decode steps held against a
# forward over the longer sequence within DENSE_AGREE_ATOL (bf16 GQA decode
# against a full-sequence pass, as dense-agreement holds Qwen3-8B over 36
# layers; InternVL2 has 24); HuBERT-XLarge over 1024 audio frames.
FORWARD_RID = 4                  # the 1019-token prompt
VLM_TOKENS, VLM_DECODE_STEPS = 512, 4
AUDIO_FRAMES = 1024
# Qwen3-8B whole in bf16 (dense-agreement): decode replayed at batch 1
# against a full-sequence prefill. Both compute one function; they round
# differently (other matmul shapes, the K/V stored in f32 after a bf16
# projection), and 36 layers of random weights carry the difference to
# the logits, which have unit scale (an rms-normed state times a
# fan-in-scaled head, |logit| up to ~5.4, where a bf16 ulp is 2^-5).
# AGREE_ATOL (0.1, 4 layers) is not assumed to hold at 36: the worst
# replay-vs-prefill error read on an H100 80GB HBM3 at 700 W was 0.0938
# over the three replays and 0.0991 over the two ring requests (3 ulps;
# the median 0.08: PERF.md, PR 19), within 0.1 but by a hair, and
# DENSE_AGREE_ATOL is 1.5 times the worst. A served token (batch 8, or 2
# in the ring check) and its batch-1 replay round differently too, by the
# same order, so a served logit lies within 2 x DENSE_AGREE_ATOL of the
# prefill's and a top-1/top-2 margin above DENSE_MARGIN = 4 x
# DENSE_AGREE_ATOL cannot flip the token.
DENSE_AGREE_ATOL = 0.15
DENSE_MARGIN = 4 * DENSE_AGREE_ATOL
DENSE_AGREE_RIDS = (7, 3, 6)     # the 265-, 448- and 615-token prompts
# Ring check: prompts past Qwen3's sliding_window of 8192 (so the window
# mask applies in prefill and the decode caches are rings that have
# wrapped), 32 new tokens each, two requests in one decode batch.
RING_PROMPT_LEN, RING_NEW, RING_REQS = 8448, 32, 2
# int8-dense: Qwen3-8B's seven INT8-policy projections of layer 0.
DENSE_INT8_PROJECTIONS = (
    ("dense", "attn", "wq"), ("dense", "attn", "wk"), ("dense", "attn", "wv"),
    ("dense", "attn", "wo"), ("dense", "mlp", "w_gate"),
    ("dense", "mlp", "w_up"), ("dense", "mlp", "w_down"),
)
# train-ssm: Mamba2-780m whole, trained through ``train`` for TRAIN_STEPS
# AdamW steps (warmup of one step) on the seeded synthetic corpus, batch
# TRAIN_BATCH x TRAIN_SEQ: four scan chunks, 2,048 tokens a step. Every
# forward launches the SSD scan once a layer; the backward recomputes the
# plain chunked stages and launches no kernel.
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 512
# train-ssd-grad: the SSD Function's gradients against autograd through the
# plain ssd_chunked on the card, (name, B, S, H, P, N): Mamba2's training
# widths, and Zamba2's (64 heads, N = 64) at its 448-token served prompt.
SSD_GRAD_CASES = (("mamba2", 4, 512, 48, 64, 128),
                  ("zamba2", 4, 448, 64, 64, 64))
SSD_GRAD_NAMES = ("x", "dt", "a_log", "B", "C")
# The Function's backward recomputes the same plain stages that the
# reference differentiates, on the same inputs, with the same (TF32-off,
# atomic-free) PyTorch operations: its gradients are expected to be the
# reference's bit for bit, and on an H100 80GB HBM3 at 700 W every one
# read 0 at both widths (PERF.md). SSD_GRAD_TOL (of each gradient's
# max |g|) leaves room for a summation order that a library picks by the
# call alone.
SSD_GRAD_TOL = 1e-6
# serve-faults: Qwen3-8B whole, the serve traffic through two decode
# engines of FAULT_DECODE_BATCH slots (the serve's 8 slots between them)
# under the pool autoscaler (1 to 3 engines) and a seeded fault plan: one
# engine crash (``FaultPlan.random``) and a timeout of the first KV
# transfer. On the virtual clock the traffic's prefills end at 1.19 s and
# engine 1 decodes until 1.44 s; seed 7 crashes engine 1 at 1.287 s, when
# each of its four requests has emitted tokens, so four are replayed and
# wait for a slot.
FAULT_SEED = 7
FAULT_HORIZON_S = 1.5
FAULT_DECODE_BATCH = 4
# Its tokens are held against serve-dense's, which decoded the same
# requests 8 rows to a step. In bf16 the two layouts round differently
# (a product of 4 rows is not a product of 8 rows cut in two), and on an
# H100 6 of the 8 requests parted from serve-dense's tokens, one at its
# first decoded token, before any fault (PERF.md). So, as
# dense-agreement holds a serve: every served token must be the argmax of
# a batch-1 prefill over prompt + served tokens wherever that prefill's
# top-1/top-2 margin exceeds DENSE_MARGIN (the replayed requests' tokens
# after their recovery included), and where a request first parts from
# serve-dense's tokens, the margin there must be under DENSE_MARGIN (a
# rounding flip; beyond it the two continue from other tokens).
# Kernels whose build fails the run if ptxas reports a spill.
# dryrun: the production pairs (arch, shape, multi-pod), each traced by
# ``python -m repro_torch.launch.dryrun`` in a process of its own on a fake
# 256- or 512-rank group; and the serve phases whose decode step gets a
# 1 x 1 record (the config function of each), beside the step measured on
# the card at DRYRUN_STEP_LEN tokens a row.
DRYRUN_PRODUCTION = (("deepseek-r1", "decode_32k", False),
                     ("olmoe-1b-7b", "decode_32k", False),
                     ("kimi-k2-1t-a32b", "decode_32k", False),
                     ("kimi-k2-1t-a32b", "decode_32k", True),
                     ("qwen3-8b", "train_4k", False),
                     ("deepseek-r1", "train_4k", False),
                     ("deepseek-r1", "prefill_32k", False),
                     ("mamba2-780m", "train_4k", False),
                     ("zamba2-1.2b", "train_4k", False))
# JAX's records of the same pairs, printed beside the port's (JAX never
# runs on the card): argument bytes and collective bytes per rank by kind,
# counted with the HLO's ``/*index=N*/`` comments taken out (JAX's own
# count skips tuple-typed collectives that carry one: LEP's all-to-alls),
# as ``python3 scripts/torch_dryrun_jax_reference.py`` prints them (jax
# 0.9.0 on 512 forced host devices).
JAX_DRYRUN = {
    "deepseek-r1 × decode_32k × 16x16": (29052811808, {
        "all-gather": 1958952960, "all-reduce": 533280960,
        "reduce-scatter": 0, "all-to-all": 4257693696,
        "collective-permute": 38397016}),
    "olmoe-1b-7b × decode_32k × 16x16": (1913336352, {
        "all-gather": 16777216, "all-reduce": 35801152,
        "reduce-scatter": 0, "all-to-all": 335675392,
        "collective-permute": 403062864}),
    "kimi-k2-1t-a32b × decode_32k × 16x16": (26113403424, {
        "all-gather": 253928843264, "all-reduce": 337369152,
        "reduce-scatter": 0, "all-to-all": 6606770176,
        "collective-permute": 8005712}),
    "kimi-k2-1t-a32b × decode_32k × 2x16x16": (26113403408, {
        "all-gather": 254053226496, "all-reduce": 48271360,
        "reduce-scatter": 0, "all-to-all": 6606770176,
        "collective-permute": 69425408}),
    "qwen3-8b × train_4k × 16x16": (1052837892, {
        "all-gather": 117146927104, "all-reduce": 872949115996,
        "reduce-scatter": 0, "all-to-all": 45097156608,
        "collective-permute": 178778275840}),
    "deepseek-r1 × train_4k × 16x16": (136740448260, {
        "all-gather": 34931474432, "all-reduce": 76805550420,
        "reduce-scatter": 0, "all-to-all": 160932839424,
        "collective-permute": 0}),
    "deepseek-r1 × prefill_32k × 16x16": (27901736960, {
        "all-gather": 216849711104, "all-reduce": 133043322880,
        "reduce-scatter": 0, "all-to-all": 89411567616,
        "collective-permute": 0}),
    "mamba2-780m × train_4k × 16x16": (810540036, {
        "all-gather": 164599814144, "all-reduce": 227237771320,
        "reduce-scatter": 0, "all-to-all": 2013265920,
        "collective-permute": 840344181760}),
    "zamba2-1.2b × train_4k × 16x16": (92554244, {
        "all-gather": 79817220096, "all-reduce": 291512909992,
        "reduce-scatter": 0, "all-to-all": 2684354560,
        "collective-permute": 488988999680}),
}
# R1 decode_32k on 16 x 16 with its attention through local_map: the
# all-gather per rank below DRYRUN_R1_AG_BYTES (8.208 GB when DTensor
# gathered the softmax's scores) and the collective term below
# DRYRUN_R1_COLL_S (23.95 ms then).
DRYRUN_R1 = "deepseek-r1 × decode_32k × 16x16"
DRYRUN_R1_AG_BYTES, DRYRUN_R1_COLL_S = 0.5e9, 8e-3
# Every production pair's collective bytes a rank at most
# DRYRUN_COLL_FACTOR times JAX's; OLMoE decode_32k, whose expert
# redundancy moves as a permute (a rank receives its slots' experts, JAX's
# ``jnp.repeat`` partitioned), at most DRYRUN_OLMOE_FACTOR times, and its
# collective term below DRYRUN_OLMOE_COLL_S (115 ms when DTensor gathered
# every expert for the repeat).
DRYRUN_OLMOE = "olmoe-1b-7b × decode_32k × 16x16"
DRYRUN_COLL_FACTOR, DRYRUN_OLMOE_FACTOR = 2.0, 1.25
DRYRUN_OLMOE_COLL_S = 2e-3
# Each pair's collective bytes a rank, in all and permuted, in a CPU sweep
# under torch 2.13 (``python -m repro_torch.launch.dryrun``), printed
# beside the card's. The permute is the port's own (LEP's redundancy) and
# must read the same on both versions; the total within DRYRUN_SWEEP_TOL
# of the sweep's, so that a change of a pair's collectives fails here
# until the sweep is taken anew.
DRYRUN_CPU_SWEEP = {
    "deepseek-r1 × decode_32k × 16x16": (2711142960, 0),
    "olmoe-1b-7b × decode_32k × 16x16": (404930688, 201326592),
    "kimi-k2-1t-a32b × decode_32k × 16x16": (130837500384, 0),
    "kimi-k2-1t-a32b × decode_32k × 2x16x16": (131093682560, 0),
    "qwen3-8b × train_4k × 16x16": (79575869444, 0),
    "deepseek-r1 × train_4k × 16x16": (133650205140, 0),
    "deepseek-r1 × prefill_32k × 16x16": (120433426896, 0),
    "mamba2-780m × train_4k × 16x16": (25614242884, 0),
    "zamba2-1.2b × train_4k × 16x16": (30916738628, 0),
}
DRYRUN_SWEEP_TOL = 0.01
# R1 train_4k at most this factor of JAX's bytes; Qwen3-8B train_4k's
# all-gather a rank under this many bytes (9.66 GB when k and v were
# gathered whole for its 8 K/V heads over 16 ranks).
DRYRUN_R1_TRAIN = "deepseek-r1 × train_4k × 16x16"
DRYRUN_R1_TRAIN_FACTOR = 1.3
DRYRUN_QWEN3 = "qwen3-8b × train_4k × 16x16"
DRYRUN_QWEN3_AG_BYTES = 1e9
DRYRUN_SERVES = (("serve-lep", "serve_config"), ("serve-kimi", "kimi_config"),
                 ("serve-dense", "dense_config"),
                 ("serve-olmoe-lep", "olmoe_config"),
                 ("serve-ssm", "ssm_config"), ("serve-zamba", "zamba_config"))
DRYRUN_BATCH, DRYRUN_CAPACITY, DRYRUN_STEP_LEN = 8, 2048, 1000
# examples: (name, file under the repo, arguments of its ``main``) of the
# port's examples and dev smoke, run on the card in this process; the
# training example's steps (the JAX example's default).
EXAMPLE_TRAIN_STEPS = 300
EXAMPLES = (("torch_quickstart", "examples/torch_quickstart.py", []),
            ("torch_serve_pdc", "examples/torch_serve_pdc.py", []),
            ("torch_serve_pdc r1 mtp", "examples/torch_serve_pdc.py",
             ["--arch", "deepseek-r1", "--mtp"]),
            ("torch_mtp_speculative", "examples/torch_mtp_speculative.py",
             []),
            ("torch_train_moe_100m", "examples/torch_train_moe_100m.py",
             ["--steps", str(EXAMPLE_TRAIN_STEPS)]),
            ("torch_dev_smoke", "scripts/torch_dev_smoke.py", []))
DRYRUN_TIMEOUT_S = 300
#: sharded-step: the (B, S) of the train and prefill cases on one card;
#: the decode and prefill cases' tolerance of the reference's largest
#: value (bf16 weights, as TOL of ``scripts/torch_parallel_nccl.py``); the
#: launches each case's step must make on the DTensor path (R1's cut: 4
#: MLA layers, 1 MoE layer, its prefill's MLA plain PyTorch; Mamba2: one
#: SSD scan a layer, the backward plain; train-r1 at 2 layers: 1 MoE
#: layer, its MLA the prefill form), the cases in their order
SHARDED_TRAIN_SHAPE = (2, 512)
SHARDED_DECODE_TOL = 0.02
SHARDED_LAUNCHES = {"decode-r1": {"mla_attention": 4, "dispatch_quant": 1,
                                  "int8_gemm": 0, "ssd_scan": 0},
                    "prefill-r1-a2a": {"mla_attention": 0,
                                       "dispatch_quant": 1, "int8_gemm": 0,
                                       "ssd_scan": 0},
                    "train-mamba2": {"mla_attention": 0, "dispatch_quant": 0,
                                     "int8_gemm": 0, "ssd_scan": 48},
                    "prefill-mamba2": {"mla_attention": 0,
                                       "dispatch_quant": 0, "int8_gemm": 0,
                                       "ssd_scan": 48},
                    "train-r1": {"mla_attention": 0, "dispatch_quant": 1,
                                 "int8_gemm": 0, "ssd_scan": 0}}
#: the cases run at SHARDED_TRAIN_SHAPE (decode-r1 at its own)
SHARDED_REDUCED = ("prefill-r1-a2a", "train-mamba2", "prefill-mamba2",
                   "train-r1")
#: the cases whose weights are the R1 serve's; they run while the serve's
#: weights are held, the others after they are freed
SHARDED_SERVE_WEIGHTS = ("decode-r1", "prefill-r1-a2a")
#: the cases cut to fewer layers on one card: train-r1's unsharded step
#: and its sharded one at 1 x 1 each hold every weight, its gradient and
#: both moments in float32 (3.6 B parameters at its 3 layers, 2.8 B at 2);
#: the 2 x 2 step of ``scripts/torch_parallel_nccl.py`` runs all 3
SHARDED_LAYERS = {"train-r1": 2}
SPILL_GATED = ("int8_gemm", "mla_decode_attention", "dispatch_quant")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet

# kimi-lep-agree: the quantized token gather against ``moe_capacity``, the
# tolerance tests/test_multidevice.py holds quantized LEP modes to.
QUANT_REL_TOL = 0.05
FP32_FLOP_PER_S = 67e12      # H100 SXM data sheet, FP32 outside tensor cores
TF32_FLOP_PER_S = 495e12     # H100 SXM data sheet, dense TF32 tensor cores
INT8_OP_PER_S = 1979e12      # H100 SXM data sheet, dense int8 tensor cores


def log(*args) -> None:
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, reps: int, flush) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    a write of ``flush`` that evicts the L2 cache (a decode step finds the
    latent cache cold: the MoE weights pass through L2 between layers)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def mla_bound(b, h, r, dr, cache_len, s):
    """Least time (ms) for absorbed-MLA decode attention on these inputs,
    what bounds it, and the same count read at the FP32 rate: each input
    read once (the valid cache rows only) and the output written once over
    the HBM rate, against 2*H*n*(2R+Dr) operations per row of n valid
    positions. The kernel takes both products on the tensor cores in
    3xTF32, three TF32 passes, so the operations count at a third of the
    TF32 rate; the FP32 reading (the bound of a kernel without tensor
    cores) stays beside it."""
    n = [0 if int(c) < 0 else min(int(c), s - 1) + 1 for c in cache_len]
    nbytes = 4 * (sum(n) * (r + dr) + b * h * (r + dr) + b + b * h * r)
    flops = 2 * h * sum(n) * (2 * r + dr)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(t_bytes, flops / FP32_FLOP_PER_S))


def kernel_phase(torch, flush, serve_lens, sweep: bool):
    from repro_torch.kernels import build
    from repro_torch.kernels.mla_attention import ops, plan
    from repro_torch.kernels.mla_attention.ref import mla_decode_attention_ref

    b, h, r, dr = 8, 128, 512, 64
    scale = 1.0 / (192 ** 0.5)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("S=2048 edges", 2048, [0, 2047, 2048, 1024, 1, 31, 32, 2015]),
        ("S=1000 ragged", 1000, [999, 1000, 0, 500, 37, 128, 129, 777]),
        ("S=2048 full", 2048, [2047] * b),
        ("serve lengths", 2048, serve_lens),
    ]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, s, lens in cases:
        q_lat = torch.randn(b, h, r, device="cuda", generator=gen)
        q_rope = torch.randn(b, h, dr, device="cuda", generator=gen)
        cache = torch.randn(b, s, r + dr, device="cuda", generator=gen)
        cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = ops.mla_decode_attention(q_lat, q_rope, cache, cache_len, scale)
        torch.cuda.synchronize()
        ref = mla_decode_attention_ref(q_lat, q_rope, cache, cache_len, scale)
        err = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"({name}): max |err| {err:.3e}")
        # Library yardstick (never called by the port): heads as the query
        # rows of one KV head, the latent cache as K and its first R
        # columns as V.
        q = torch.cat([q_lat, q_rope], -1)[:, None]            # (B,1,H,R+Dr)
        k = cache[:, None]                                      # (B,1,S,R+Dr)
        v = cache[:, None, :, :r]
        mask = (torch.arange(s, device="cuda")[None, :]
                <= cache_len.clamp(max=s - 1)[:, None])[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q, k, v, attn_mask=mask, scale=scale)[:, 0]
        lib_err = (lib - ref).abs().max().item()

        def kernel():
            return ops.mla_decode_attention(q_lat, q_rope, cache, cache_len,
                                            scale)

        n_pieces = plan.n_pieces_for(b, h, s, n_sm)
        row = {
            "case": name, "S": s, "cache_len": lens, "max_abs_err": err,
            "n_pieces": n_pieces,
            "partial_bytes": plan.partial_bytes(b, h, r, n_pieces),
            "ms": timed_ms(torch, kernel, 30, flush),
            "graph_ms": timed_ms(torch, graph_of(torch, kernel).replay, 30,
                                 flush),
            "plain_ms": timed_ms(torch, lambda: mla_decode_attention_ref(
                q_lat, q_rope, cache, cache_len, scale), 30, flush),
            "library_ms": timed_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, scale=scale), 30, flush),
            "library_max_abs_err": lib_err,
        }
        row["bound_ms"], row["bound_by"], row["bound_fp32_ms"] = mla_bound(
            b, h, r, dr, lens, s)
        log("kernel:", json.dumps(row))
        rows.append(row)
        for n in (sorted(set(SWEEP_PIECES) | {n_pieces}) if sweep else ()):
            def run(n=n):
                return ops.mla_decode_attention(q_lat, q_rope, cache,
                                                cache_len, scale, n_pieces=n)
            got = run()
            torch.cuda.synchronize()
            if not torch.allclose(got, ref, rtol=KERNEL_TOL,
                                  atol=KERNEL_TOL):
                raise AssertionError(f"kernel at n_pieces={n} disagrees "
                                     f"with its plain version ({name})")
            log("sweep:", json.dumps({
                "case": name, "n_pieces": n, "chosen": n == n_pieces,
                "max_abs_err": (got - ref).abs().max().item(),
                "partial_bytes": plan.partial_bytes(b, h, r, n),
                "graph_ms": timed_ms(torch, graph_of(torch, run).replay, 30,
                                     flush)}))
    sass = tensor_core_ops(build.library_path("mla_decode_attention"))
    log("mla-sass:", json.dumps(sass))
    if not any(op.startswith(("HGMMA", "HMMA")) and op.endswith(".TF32")
               for op in sass.get("mla_split_kernel", {})):
        raise AssertionError(f"no TF32 tensor-core instruction in the MLA "
                             f"attention kernel: {sass}")
    return rows


def merge_blocks_on_card(torch, parts):
    """The blocks' partials (o, lse) of one sequence merged as a cache
    sharded on its sequence merges them (``attention.merge_blocks``'s
    arithmetic, the all-reduces replaced by sums over the stacked
    blocks)."""
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.max(dim=0).values)
    return (o * w[..., None]).sum(0) / w.sum(0)[..., None]


def kernel_lse_phase(torch, serve_lens):
    """The kernel's ``return_lse`` variant against its plain version (o
    within KERNEL_TOL, lse within LSE_RTOL of its size, -inf on exactly
    the empty rows), on the kernel phase's cases and on rows whose bound
    is negative (MLA_EMPTY_LENS); then the sharded path's arithmetic on
    one card: the R1 serve's final cache cut into MLA_SPLIT_BLOCKS blocks
    of positions, each block one kernel call with its offset bound and
    ``return_lse``, merged, against the whole-cache kernel within
    KERNEL_TOL. Comparison launches: not counted on a main path."""
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.kernels.mla_attention.ref import mla_decode_attention_ref

    b, h, r, dr = 8, 128, 512, 64
    scale = 1.0 / (192 ** 0.5)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    cases = (("S=2048 edges", 2048, [0, 2047, 2048, 1024, 1, 31, 32, 2015]),
             ("S=1000 ragged", 1000, [999, 1000, 0, 500, 37, 128, 129, 777]),
             ("empty rows", 2048, MLA_EMPTY_LENS),
             ("every row empty", 2048, [-1] * b),
             ("serve lengths", 2048, serve_lens))
    for name, s, lens in cases:
        q_lat = torch.randn(b, h, r, device="cuda", generator=gen)
        q_rope = torch.randn(b, h, dr, device="cuda", generator=gen)
        cache = torch.randn(b, s, r + dr, device="cuda", generator=gen)
        cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        o, lse = ops.mla_decode_attention(q_lat, q_rope, cache, cache_len,
                                          scale, return_lse=True)
        default = ops.mla_decode_attention(q_lat, q_rope, cache, cache_len,
                                           scale)
        torch.cuda.synchronize()
        ref_o, ref_lse = mla_decode_attention_ref(
            q_lat, q_rope, cache, cache_len, scale, return_lse=True)
        fin = torch.isfinite(ref_lse)
        lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0))[
            fin].max().item() if fin.any() else 0.0
        row = {"case": name, "S": s, "cache_len": lens,
               "o_max_abs_err": (o - ref_o).abs().max().item(),
               "lse_max_rel_err": lse_err,
               "empty_rows": int((~fin).all(dim=1).sum().item()),
               "o_equals_default_call": bool(torch.equal(o, default))}
        if not (torch.allclose(o, ref_o, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                and lse_err <= LSE_RTOL and row["o_equals_default_call"]
                and torch.equal(torch.isneginf(lse), ~fin)
                and not torch.isnan(o).any()):
            raise AssertionError(f"the kernel's lse variant disagrees with "
                                 f"its plain version: {row}")
        if name == "serve lengths":
            blk = s // MLA_SPLIT_BLOCKS
            parts = [ops.mla_decode_attention(
                q_lat, q_rope, cache[:, j * blk:(j + 1) * blk].contiguous(),
                cache_len - j * blk, scale, return_lse=True)
                for j in range(MLA_SPLIT_BLOCKS)]
            merged = merge_blocks_on_card(torch, parts)
            torch.cuda.synchronize()
            row["split_blocks"] = MLA_SPLIT_BLOCKS
            row["split_max_abs_err"] = (merged - default).abs().max().item()
            if not torch.allclose(merged, default, rtol=KERNEL_TOL,
                                  atol=KERNEL_TOL):
                raise AssertionError(f"{MLA_SPLIT_BLOCKS} blocks of the "
                                     f"cache, merged, disagree with the "
                                     f"whole-cache kernel: {row}")
        log("kernel-lse:", json.dumps(row))
        rows.append(row)
    return rows


def dq_bound(t, d, in_bytes):
    """Least time (ms) for per-row INT8 quantization of a (t, d) input and
    what bounds it: the input read once and t*(d + 4) bytes of codes and
    scales written once over the HBM rate, against about 4 FP32 operations
    per element (|x| and max, divide, round, clip) over the FP32 rate."""
    nbytes = t * d * in_bytes + t * (d + 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * t * d / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_dispatch_quant(torch, name, x, pack):
    """``dispatch_quantize`` of ``x`` against its plain version: every code
    equal, scales within DQ_SCALE_RTOL, the packed scale tail
    bit-identical. Returns the error figures."""
    from repro_torch.kernels.dispatch_quant import ops
    from repro_torch.kernels.dispatch_quant.ref import dispatch_quantize_ref

    d = x.shape[1]
    got = ops.dispatch_quantize(x, pack=pack)
    ref = dispatch_quantize_ref(x, pack=pack)
    torch.cuda.synchronize()
    if pack:
        if got.shape != ref.shape or not torch.equal(got[:, d:], ref[:, d:]):
            raise AssertionError(f"{name}: packed scale tail differs")
        q, q_ref = got[:, :d], ref[:, :d]
        s = got[:, d:].contiguous().view(torch.float32)
        s_ref = ref[:, d:].contiguous().view(torch.float32)
    else:
        (q, s), (q_ref, s_ref) = got, ref
    differing = int((q != q_ref).sum())
    scale_rel = ((s - s_ref).abs() / s_ref).max().item() if s.numel() else 0.0
    if differing or scale_rel > DQ_SCALE_RTOL:
        raise AssertionError(f"{name}: {differing} codes differ, scales by "
                             f"{scale_rel:.3e}")
    err = (q.float() * s - q_ref.float() * s_ref).abs()
    return {"codes_differing": differing, "scale_max_rel_err": scale_rel,
            "max_abs_err": err.max().item() if err.numel() else 0.0}


def dq_plan(torch, x, pack):
    """The launch plan ``dispatch_quantize`` takes for ``x``."""
    from repro_torch.kernels.dispatch_quant import ops

    t, d = x.shape
    q = torch.empty((t, d + 4 if pack else d), dtype=torch.int8,
                    device=x.device)
    return ops.plan_for(x, q)._asdict()


def dq_served_rows(torch, flush, cfg, prefill_tokens, gen,
                   tag="dispatch_quant"):
    """``dispatch_quantize`` against its plain PyTorch version at the LEP
    dispatch buffers a LEP serve of ``cfg`` quantizes -- decode (8 tokens),
    the same buffer with every row filled, and the longest prompt's
    prefill, with only the rows that tokens fill non-zero -- and at one
    activation shape (8 tokens, unpacked, as ``quantize_act_per_token``
    calls it), each checked and timed; one ``tag:`` row each. Inputs are
    drawn from the CUDA generator ``gen``."""
    from repro_torch.core.lep import lep_capacity
    from repro_torch.kernels.dispatch_quant import ops
    from repro_torch.kernels.dispatch_quant.ref import dispatch_quantize_ref

    k, e, d = cfg.num_experts_per_tok, cfg.num_experts, cfg.d_model
    cases = []
    for name, tokens in (("decode dispatch", 8),
                         ("prefill dispatch", prefill_tokens)):
        rows = e * lep_capacity(tokens, k, e, cfg.capacity_factor)
        cases.append((name, rows, min(rows, tokens * k), True))
    cases.insert(1, ("full dispatch", cases[0][1], cases[0][1], True))
    cases.append(("activation", 8, 8, False))
    out = []
    for name, rows, filled, pack in cases:
        x = torch.zeros(rows, d, dtype=torch.bfloat16, device="cuda")
        idx = torch.randperm(rows, device="cuda", generator=gen)[:filled]
        x[idx] = torch.randn(filled, d, device="cuda", generator=gen,
                             dtype=torch.bfloat16)
        row = {"case": name, "shape": [rows, d], "filled_rows": filled,
               "pack": pack, "plan": dq_plan(torch, x, pack),
               **check_dispatch_quant(torch, name, x, pack)}

        def kernel():
            return ops.dispatch_quantize(x, pack=pack)

        row["ms"] = timed_ms(torch, kernel, 30, flush)
        row["graph_ms"] = timed_ms(torch, graph_of(torch, kernel).replay, 30,
                                   flush)
        row["plain_ms"] = timed_ms(torch, lambda: dispatch_quantize_ref(
            x, pack=pack), 30, flush)
        row["bound_ms"], row["bound_by"] = dq_bound(rows, d, 2)
        row["bound_frac"] = row["bound_ms"] / row["graph_ms"]
        log(f"{tag}:", json.dumps(row))
        out.append(row)
    return out


def dispatch_quant_phase(torch, flush, cfg, prefill_tokens):
    """:func:`dq_served_rows` at the R1 cut's LEP buffers; then, untimed,
    ``dispatch_quantize`` against its plain version at the DQ_RAGGED
    shapes (the empty one must launch nothing) and at rows planted at
    rounding boundaries."""
    from repro_torch.kernels.dispatch_quant import ops
    from repro_torch.kernels.dispatch_quant.ref import (bf16_boundary_rows,
                                                        f32_boundary_rows)

    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = dq_served_rows(torch, flush, cfg, prefill_tokens, gen)
    ragged = []
    for name, rows, width, dtype, pack, offset in DQ_RAGGED:
        flat = torch.randn(rows * width + offset, device="cuda", generator=gen,
                           dtype=getattr(torch, dtype))
        x = flat[offset:].view(rows, width)
        if rows:
            x[rows // 2] = 0                  # an empty capacity slot
            x *= torch.rand(rows, 1, device="cuda", generator=gen).to(x.dtype) * 8
        before = ops.LAUNCHES
        row = {"case": name, "shape": [rows, width], "dtype": dtype,
               "pack": pack, "misaligned": offset != 0,
               "plan": dq_plan(torch, x, pack),
               **check_dispatch_quant(torch, name, x, pack)}
        if ops.LAUNCHES - before != (1 if rows else 0):
            raise AssertionError(f"{name}: {ops.LAUNCHES - before} launches "
                                 f"counted for {rows} rows")
        log("dispatch_quant-ragged:", json.dumps(row))
        ragged.append(row)
    # Rows at rounding boundaries, through the ring (all rows) and the
    # cluster split (the first 8).
    for name, rows in (("bf16", bf16_boundary_rows(d, SEED)),
                       ("f32", f32_boundary_rows(DQ_BOUNDARY_F32_ROWS, d,
                                                 SEED))):
        rows = rows.to("cuda")
        for x, pack in ((rows, name == "bf16"), (rows[:8], name != "bf16")):
            case = f"{name} boundary rows, T={x.shape[0]}"
            row = {"case": case, "shape": list(x.shape), "pack": pack,
                   "plan": dq_plan(torch, x, pack),
                   **check_dispatch_quant(torch, case, x, pack)}
            log("dispatch_quant-boundary:", json.dumps(row))
            ragged.append(row)
    return out, ragged


# The 2-D INT8-policy projections of the served cut: (segment, module,
# weight); the attention and dense FFN of the first dense layer, the shared
# expert of the MoE layer.
INT8_PROJECTIONS = (
    ("dense_lead", "attn", "wq_a"), ("dense_lead", "attn", "wq_b"),
    ("dense_lead", "attn", "wkv_a"), ("dense_lead", "attn", "wo"),
    ("dense_lead", "mlp", "w_gate"), ("dense_lead", "mlp", "w_up"),
    ("dense_lead", "mlp", "w_down"), ("moe", "moe", "shared_gate"),
    ("moe", "moe", "shared_up"), ("moe", "moe", "shared_down"),
)


def capture_inputs(torch, cfg, params, prompt, weights):
    """The activations each weight in ``weights`` (name -> parameter) is
    multiplied with during a ``prefill`` of ``prompt``: every ``x @ w`` of
    the model is seen through a TorchFunctionMode, so the inputs of inner
    projections (``wq_b`` after the q norm, ``wo`` after attention,
    ``w_down`` after the SwiGLU gate) are the model's own. Returns name ->
    (tokens, K)."""
    from torch.overrides import TorchFunctionMode
    from repro_torch.models import prefill

    by_id = {id(w): name for name, w in weights.items()}
    got = {}

    class Capture(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.matmul, torch.Tensor.__matmul__,
                        torch.matmul) \
                    and len(args) == 2 and id(args[1]) in by_id:
                got[by_id[id(args[1])]] = args[0].reshape(
                    -1, args[0].shape[-1]).detach().clone()
            return func(*args, **(kwargs or {}))

    tokens = torch.tensor([prompt], dtype=torch.int32,
                          device=params.embed.device)
    with torch.no_grad(), Capture():
        prefill(params, cfg, {"tokens": tokens}, len(prompt))
    missing = sorted(set(weights) - set(got))
    if missing:
        raise AssertionError(f"no activations captured for {missing}")
    return got


def int8_times(m, n, k):
    """(operations ms, bytes ms) of an (m, k) x (k, n) int8 GEMM with its
    f32 epilogue: 2*m*n*k int8 tensor-core operations over the int8 rate;
    the operands and scales read once and the f32 output written once over
    the HBM rate. The bound is the larger."""
    nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
    return 1e3 * 2 * m * n * k / INT8_OP_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S


def check_int8_plan(ops, m, k, n, n_sm):
    """The INT8 GEMM's own launch plan for (m, k) x (k, n): swap-AB for
    M <= INT8_SWAP_MAX_M with one tile of tokens that holds M (n = 8, 16,
    32 or 64) against 64 rows of N, else 128 rows of M against 128 or 256
    of N; at most 8 K splits (one thread-block cluster), every K block in
    exactly one split, and no split left empty.
    Returns the plan's fields for the row."""
    plan = ops.launch_plan(m, n, k, n_sm)
    k_blocks = -(-k // plan.block_k)
    tiles = ((min(t for t in (8, 16, 32, 64) if t >= m), 64)
             if plan.swap_ab else (128, plan.tile_n))
    if (plan.swap_ab != (m <= INT8_SWAP_MAX_M)
            or (plan.tile_m, plan.tile_n) != tiles
            or (not plan.swap_ab and plan.tile_n not in (128, 256))
            or not 1 <= plan.splits <= 8
            or plan.splits * plan.k_blocks_per_split < k_blocks
            or (k_blocks and (plan.splits - 1) * plan.k_blocks_per_split
                >= k_blocks)):
        raise AssertionError(f"int8_matmul's plan for M={m}, K={k}, N={n}: "
                             f"{plan}")
    return {"tile": [plan.tile_m, plan.tile_n], "swap_ab": plan.swap_ab,
            "k_splits": plan.splits, "stages": plan.stages}


def int8_path_rows(torch, flush, cfg, params, reqs, projections, tag):
    """The §4.5 INT8 linear path on ``projections`` ((segment, module,
    weight) of layer 0). Activations are captured from prefills of two served
    prompts: ``calibrate_linear`` runs on the first (calibration), and
    ``quantized_matmul`` on the second's first 8 rows (decode-sized) and on
    all of its rows (its prompt length). Relative error against the bf16
    product, for the full pipeline and for plain per-channel/per-token
    quantization. That run is the path whose launches are counted. Then the
    INT8 GEMM at the same inputs against its plain version, with CUDA-event
    times of kernel, plain version and ``torch._int_mm`` plus the same
    epilogue (the library yardstick; it takes M > 16, so decode rows are
    padded with zeros to 32), beside the bound. The weight stays K-major
    for ``_int_mm`` (cuBLAS's TN layout); if it refuses the view, a
    row-major copy made outside the timed region stands in and the row
    says so. One ``tag:`` row per product; returns (rows, the path's
    kernel counts)."""
    from repro_torch.kernels.int8_gemm import ops
    from repro_torch.kernels.int8_gemm.ref import int8_matmul_ref
    from repro_torch.quant import (calibrate_linear, quantize_act_per_token,
                                   quantized_matmul)

    weights = {}
    for seg, part, name in projections:
        label = name if seg == "moe" else f"{part}.{name}"
        weights[label] = getattr(getattr(params.segments[seg][0], part), name)
        if weights[label].shape[0] % ops.TMA_ALIGN:
            raise AssertionError(f"{label}: K = {weights[label].shape[0]} "
                                 f"would take the wrapper's padded path")
    cal_req, eval_req = reqs[INT8_CALIB_RID], reqs[INT8_EVAL_RID]
    x_cal = capture_inputs(torch, cfg, params, cal_req.prompt, weights)
    x_eval = capture_inputs(torch, cfg, params, eval_req.prompt, weights)
    ms_eval = (8, len(eval_req.prompt))

    def rel_err(out, ref):
        return (torch.linalg.norm(out.float() - ref) / torch.linalg.norm(ref)).item()

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    reset_counts()
    ops.PADDED_CALLS = 0
    quality, qls = {}, {}
    for label, w in weights.items():
        ql = calibrate_linear(w, x_cal[label])
        ql_plain = calibrate_linear(w, x_cal[label], equalize=False,
                                    block_clip=False, compensate=False)
        qls[label] = ql
        for m in ms_eval:
            x = x_eval[label][:m]
            ref = (x @ w).float()
            quality[(label, m)] = (rel_err(quantized_matmul(x, ql), ref),
                                   rel_err(quantized_matmul(x, ql_plain), ref))
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["int8_gemm"] == 0 or counts["dispatch_quant"] == 0:
        raise AssertionError(f"the INT8 path launched no kernel: {counts}")

    rows = []
    for label, w in weights.items():
        ql = qls[label]
        for m in ms_eval:
            x = x_eval[label][:m]
            x_q, x_s = quantize_act_per_token(x / ql.eq[None, :].to(x.dtype))
            args = (x_q, ql.w_q, x_s, ql.w_scale, torch.float32)
            got = ops.int8_matmul(*args)
            ref = int8_matmul_ref(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=INT8_RTOL, atol=0.0):
                raise AssertionError(f"int8_matmul disagrees with its plain "
                                     f"version ({label}, M={m}): {err:.3e}")
            pad = 32 - m if m <= 16 else 0
            xq_lib = torch.nn.functional.pad(x_q, (0, 0, 0, pad))
            xs_lib = torch.nn.functional.pad(x_s, (0, 0, 0, pad))
            w_lib, w_layout = ql.w_q, "K-major (as stored)"
            try:
                torch._int_mm(xq_lib, w_lib)
            except RuntimeError as exc:
                w_lib = ql.w_q.contiguous()
                w_layout = f"row-major copy (K-major refused: {exc})"

            def library():
                return torch._int_mm(xq_lib, w_lib).float() * xs_lib * ql.w_scale

            def kernel():
                return ops.int8_matmul(*args)

            k, n = ql.w_q.shape
            row = {
                "case": label, "M": m, "K": k, "N": n,
                **check_int8_plan(ops, m, k, n, n_sm),
                "rel_err_calibrated": quality[(label, m)][0],
                "rel_err_plain": quality[(label, m)][1],
                "max_abs_err": err,
                "ms": timed_ms(torch, kernel, 20, flush),
                "graph_ms": timed_ms(torch, graph_of(torch, kernel).replay,
                                     20, flush),
                "plain_ms": timed_ms(torch, lambda: int8_matmul_ref(*args), 20,
                                     flush),
                "library_ms": timed_ms(torch, library, 20, flush),
                "library_rows": m + pad,
                "library_w_layout": w_layout,
            }
            t_ops, t_bytes = int8_times(m, n, k)
            row["bound_ms"] = max(t_ops, t_bytes)
            row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            log(f"{tag}:", json.dumps(row))
            rows.append(row)
    if ops.PADDED_CALLS:
        raise AssertionError(f"{ops.PADDED_CALLS} served INT8 products took "
                             f"the wrapper's padded path")
    return rows, counts


def int8_phase(torch, flush, cfg, params, reqs):
    """:func:`int8_path_rows` on the R1 cut's INT8_PROJECTIONS (20
    products); then the INT8 GEMM against its plain version at the
    INT8_RAGGED shapes, and the int8 tensor-core instructions of each
    kernel function."""
    from repro_torch.kernels.int8_gemm import ops
    from repro_torch.kernels.int8_gemm.ref import int8_matmul_ref

    rows, counts = int8_path_rows(torch, flush, cfg, params, reqs,
                                  INT8_PROJECTIONS, "int8")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ragged = []
    for m, k, n, dtype, offset in INT8_RAGGED:
        # x_q at `offset` bytes into its buffer; w_q stored K-major.
        x_q = torch.randint(-127, 128, (m * k + offset,), device="cuda",
                            generator=gen, dtype=torch.int8)[offset:].view(m, k)
        w_q = torch.randint(-127, 128, (n, k), device="cuda", generator=gen,
                            dtype=torch.int8).t()
        x_s = torch.rand(m, 1, device="cuda", generator=gen) * 0.01
        w_s = torch.rand(1, n, device="cuda", generator=gen) * 0.01
        args = (x_q, w_q, x_s, w_s, getattr(torch, dtype))
        padded = ops.PADDED_CALLS
        got, ref = ops.int8_matmul(*args).float(), int8_matmul_ref(*args).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=INT8_RTOL, atol=0.0):
            raise AssertionError(f"int8_matmul disagrees with its plain "
                                 f"version at M={m}, K={k}, N={n} ({dtype}, "
                                 f"offset {offset}): {err:.3e}")
        row = {"M": m, "K": k, "N": n, "out_dtype": dtype, "x_offset": offset,
               "padded": ops.PADDED_CALLS > padded,
               **check_int8_plan(ops, m, k, n, n_sm), "max_abs_err": err}
        if row["padded"] != ops.needs_padding(k, x_q.data_ptr(),
                                              w_q.data_ptr()):
            raise AssertionError(f"int8_matmul's padding at M={m}, K={k}, "
                                 f"N={n}, offset {offset}: {row}")
        log("int8-ragged:", json.dumps(row))
        ragged.append(row)

    from repro_torch.kernels import build

    sass = tensor_core_ops(build.library_path("int8_gemm"))
    log("int8-sass:", json.dumps(sass))
    gemms = [c for f, c in sass.items() if f.startswith("int8_gemm_kernel")]
    if not gemms or any(not any(op.startswith("IGMMA") for op in c)
                        or any(op.startswith("IMMA") for op in c)
                        for c in gemms):
        raise AssertionError(f"every int8 GEMM kernel must use IGMMA and no "
                             f"IMMA: {sass}")
    return rows, ragged, counts


def serve_config():
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-r1")
    # Depth cut only: 3 dense MLA layers + 1 MoE layer; widths whole.
    return dataclasses.replace(cfg, name="deepseek-r1-4layer", num_layers=4,
                               first_k_dense=3, dtype="bfloat16")


KERNEL_MODULES = ("mla_attention", "dispatch_quant", "int8_gemm", "ssd_scan")


def kernel_ops():
    """The wrapper module of every kernel, by package name."""
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}.ops")
            for name in KERNEL_MODULES}


def reset_counts() -> None:
    for mod in kernel_ops().values():
        mod.LAUNCHES = 0


def read_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_ops().items()}


def ssm_config():
    from repro_torch.configs import get_config
    # Full width and full depth: 48 Mamba2 layers, d_model 1536.
    return dataclasses.replace(get_config("mamba2-780m"), dtype="bfloat16")


def serve_requests(cfg):
    """The served traffic: 8 requests with prompt lengths drawn uniformly
    from 256-1024 tokens (seed SEED) and 32 new tokens each."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.RandomState(SEED)
    n_req, max_new = 8, 32
    lens = rng.randint(256, 1025, size=n_req)          # uniform on 256..1024
    return [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size, n)],
                    max_new) for i, n in enumerate(lens)]


def serve_phase(torch, cfg, params, moe_fn=None, dev="cuda", *, reqs=None,
                system=None, mla_per_iter=1):
    """Serve ``reqs`` (default ``serve_requests``) through ``system``
    (default a new ``ServingSystem(n_prefill=1, decode_batch=8,
    capacity=2048)``; ``moe_fn=None``: the default ``moe_capacity``), with
    every kernel count set to 0 just before and
    read just after. An MLA model must launch the MLA kernel
    ``mla_per_iter`` times per layer in every decode iteration of this
    serve (1 for plain decode, 2 for MTP's two-step verify, 0 for the fused
    verify, which runs no decode step). Returns (summary, counts, final
    lengths, tokens by rid); with a context cache the summary lists each
    request's reused tokens."""
    from repro_torch.serving import ServingSystem

    reqs = serve_requests(cfg) if reqs is None else reqs
    n_req, max_new = len(reqs), reqs[0].max_new_tokens
    lens = [len(r.prompt) for r in reqs]
    if system is None:
        system = ServingSystem(params, cfg, n_prefill=1, decode_batch=8,
                               capacity=2048, device=dev, moe_fn=moe_fn)

    # Wall-clock instrumentation around the engines' own calls: both end in
    # a host read of the sampled tokens, so the device work is done.
    prefill_start, prefill_done, steps = {}, {}, []
    pre, dec = system.prefills[0], system.decode
    run0, step0 = pre.run, dec.step_chunk
    iters0 = dec.iters

    def run(req):
        prefill_start[req.rid] = time.perf_counter()
        out = run0(req)
        prefill_done[req.rid] = time.perf_counter()
        return out

    def step_chunk(*a, **kw):
        t0 = time.perf_counter()
        finished, log_ = step0(*a, **kw)
        steps.append((t0, time.perf_counter(), [r.rid for r in finished]))
        return finished, log_

    pre.run, dec.step_chunk = run, step_chunk
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    try:
        results = system.serve(reqs)
    finally:
        t_end = time.perf_counter()
        counts = read_counts()
        del pre.run, dec.step_chunk       # the engines' own methods again

    if len(results) != n_req or any(r.shed or len(r.tokens) != max_new
                                    for r in results):
        raise AssertionError("not every request finished: "
                             f"{[(r.rid, r.shed, len(r.tokens)) for r in results]}")
    for r in results:
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"rid {r.rid}: token out of range")
    n_steps = dec.iters - iters0
    # Mamba2: one SSD scan per layer of every prefill; MLA: one decode
    # attention per layer of every decode step. GQA attention is plain
    # PyTorch (as in JAX): no kernel but LEP's dispatch-quantize may launch.
    # A Zamba2 hybrid: one SSD scan per Mamba layer (every layer) of every
    # prefill, and no other kernel (its shared attention is GQA).
    if cfg.is_ssm or cfg.is_hybrid or cfg.attention_kind == "mla":
        ssd = cfg.is_ssm or cfg.is_hybrid
        name, per, what = (("ssd_scan", len(prefill_done), "prefills")
                           if ssd else
                           ("mla_attention", mla_per_iter * n_steps,
                            f"{mla_per_iter} x decode iterations"))
        launches = counts[name]
        if launches != per * cfg.num_layers or (launches == 0) != (per == 0):
            raise AssertionError(f"{name} launches {launches} != {what} "
                                 f"{per} x {cfg.num_layers} layers")
        if ssd and any(counts[k] for k in KERNEL_MODULES if k != name):
            raise AssertionError(f"an SSM serve launched another kernel: "
                                 f"{counts}")
    else:
        quiet = [k for k in KERNEL_MODULES
                 if k != "dispatch_quant" or moe_fn is None]
        if any(counts[k] for k in quiet):
            raise AssertionError(f"a GQA serve launched a kernel: {counts}")
    results = sorted(results, key=lambda r: r.rid)      # prompt_lens order
    finish = {rid: t1 for _, t1, rids in steps for rid in rids}
    ttft = [prefill_done[r.rid] - t_start for r in results]
    tpot = [(finish[r.rid] - prefill_done[r.rid]) / (max_new - 1)
            for r in results]
    decode_s = steps[-1][1] - steps[0][0]
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    step_s = [t1 - t0 for t0, t1, _ in steps]
    summary = {
        "requests": n_req, "prompt_lens": lens,
        "max_new_tokens": max_new, "decode_steps": n_steps,
        "kernel_launches": counts,
        "prefill_s": [prefill_done[r.rid] - prefill_start[r.rid]
                      for r in results],
        "ttft_s": ttft,
        "ttft_p50_s": statistics.median(ttft),
        "tpot_p50_s": statistics.median(tpot),
        "decode_step_p50_s": statistics.median(step_s),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "serve_wall_s": t_end - t_start,
        "decode_args_bytes": engine_step_bytes(torch, params, dec),
    }
    if dev == "cuda":
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if system.cc is not None:
        summary["reused_tokens"] = [r.reused_tokens for r in results]
    final_lens = [n + max_new - 1 for n in lens]
    return summary, counts, final_lens, {r.rid: r.tokens for r in results}


def serve_lep_phase(torch, cfg, params, base_tokens, dev="cuda", *,
                    lep=None, quant_per_call=1):
    """The same traffic served with ``moe_fn=lep`` (default
    ``make_lep_moe_fn()`` at world size 1: early INT8 dispatch through the
    dispatch-quantize kernel). Every request must finish and the kernel
    must run ``quant_per_call`` times per MoE call. The share of served
    tokens equal to ``base_tokens`` (the ``moe_capacity`` serve's) is
    reported, not gated: INT8 dispatch and LEP's deeper prefill capacity
    may flip some; without ``base_tokens`` the tokens are returned in the
    summary."""
    from repro_torch.core import make_lep_moe_fn

    lep = lep or make_lep_moe_fn()
    calls = []

    def moe_fn(p, x, c):
        calls.append(x.shape[0])
        return lep(p, x, c)

    summary, counts, _, tokens = serve_phase(torch, cfg, params, moe_fn, dev)
    if not calls or counts["dispatch_quant"] != quant_per_call * len(calls):
        raise AssertionError(f"dispatch_quantize launches "
                             f"{counts['dispatch_quant']} != {quant_per_call}"
                             f" x moe_fn calls {len(calls)}")
    # One MoE call per MoE layer of every forward (a prefill or a step).
    forwards = summary["requests"] + summary["decode_steps"]
    if len(calls) != (cfg.num_layers - cfg.first_k_dense) * forwards:
        raise AssertionError(f"{len(calls)} moe_fn calls for {forwards} "
                             f"forwards")
    summary["moe_fn_calls"] = len(calls)
    if base_tokens is None:
        summary["tokens"] = tokens
        return summary, counts
    same = sum(a == b for rid in tokens
               for a, b in zip(tokens[rid], base_tokens[rid]))
    total = sum(len(t) for t in tokens.values())
    summary["tokens_identical_to_capacity_serve"] = same / total
    return summary, counts


def agreement_phase(torch, cfg, params, dev="cuda"):
    """Decode (absorbed MLA through the kernel) against full-sequence
    prefill (unabsorbed MLA), both in bf16 with the dense MoE oracle.

    The two forms round differently, and a bf16 difference can flip a
    token's top-8 expert choice, which moves its logits by far more than
    rounding does (on the chip: ~0.2 at flipped positions, <= 0.07
    elsewhere). So every MoE call records each token's expert set, and
    the logit tolerance is held where both forms chose the same experts;
    flips are counted per prompt seed and may reach at most MAX_FLIP_SHARE
    of all positions. Requests are served one at a time (decode_batch=1),
    so the replay through ``decode_step`` repeats the serving computation
    exactly and must reproduce every served token. Where the reference's
    top-1/top-2 margin exceeds 2 x AGREE_ATOL (each logit may move by
    AGREE_ATOL) and the experts agree, the served token must be the
    reference's argmax."""
    import numpy as np
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.moe import moe_reference, route
    from repro_torch.serving import Request, ServingSystem

    n_new, capacity = 16, 512
    n_moe = cfg.num_layers - cfg.first_k_dense
    prompts, seed_of = [], []
    for k in AGREE_SEEDS:
        rng = np.random.RandomState(SEED + k)
        for n in (128, 192, 256):
            prompts.append([int(t) for t in rng.randint(0, cfg.vocab_size, n)])
            seed_of.append(k)
    system = ServingSystem(params, cfg, n_prefill=1, decode_batch=1,
                           capacity=capacity, moe_fn=moe_reference,
                           device=dev)
    results = {r.rid: r.tokens for r in system.serve(
        [Request(i, p, n_new) for i, p in enumerate(prompts)])}

    calls = []

    def recording(p, x, c):
        calls.append(route(p.router, x, c)[0].sort(dim=-1).values.cpu())
        return moe_reference(p, x, c)

    def tok(ids):
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    stats = {"requests": len(prompts), "new_tokens": n_new,
             "atol": AGREE_ATOL, "max_abs_logit_err": 0.0,
             "expert_flips": 0,
             "expert_flips_per_seed": {k: 0 for k in AGREE_SEEDS},
             "max_abs_logit_err_at_flips": 0.0, "tokens_checked": 0}
    for rid, prompt in enumerate(prompts):
        served = results[rid]
        if len(served) != n_new:
            raise AssertionError(f"rid {rid} served {len(served)} tokens")
        # Replay: prefill the prompt, then teacher-force the served tokens
        # through decode_step (the kernel path).
        calls.clear()
        logits, caches = prefill(params, cfg, {"tokens": tok([prompt])},
                                 capacity, recording,
                                 cache_dtype=torch.float32)
        replay = [logits[0, -1].float()]
        experts = [torch.stack([c[-1] for c in calls[-n_moe:]])]
        for i, t in enumerate(served[:-1]):
            lg, caches = decode_step(params, cfg, tok([[t]]), caches,
                                     tok([len(prompt) + i]), recording)
            replay.append(lg[0].float())
            experts.append(torch.stack([c[0] for c in calls[-n_moe:]]))
        replay = torch.stack(replay)
        if replay.argmax(-1).tolist() != served:
            raise AssertionError(f"rid {rid}: decode replay does not "
                                 "reproduce the served tokens")
        calls.clear()
        ref_logits, _ = prefill(params, cfg, {"tokens": tok([prompt + served[:-1]])},
                                capacity, recording, cache_dtype=torch.float32)
        ref = ref_logits[0, len(prompt) - 1:].float()           # (n_new, V)
        top2 = ref.topk(2, dim=-1)
        for i in range(n_new):
            ref_experts = torch.stack([c[len(prompt) - 1 + i]
                                       for c in calls[-n_moe:]])
            err = (replay[i] - ref[i]).abs().max().item()
            if not torch.equal(experts[i], ref_experts):
                stats["expert_flips"] += 1
                stats["expert_flips_per_seed"][seed_of[rid]] += 1
                stats["max_abs_logit_err_at_flips"] = max(
                    stats["max_abs_logit_err_at_flips"], err)
                continue
            stats["max_abs_logit_err"] = max(stats["max_abs_logit_err"], err)
            if err > AGREE_ATOL:
                raise AssertionError(f"rid {rid} position {i}: decode vs "
                                     f"prefill max |dlogit| {err:.4f} > "
                                     f"{AGREE_ATOL}")
            margin = (top2.values[i, 0] - top2.values[i, 1]).item()
            if margin > 2 * AGREE_ATOL:
                stats["tokens_checked"] += 1
                if served[i] != top2.indices[i, 0].item():
                    raise AssertionError(
                        f"rid {rid} token {i}: served {served[i]}, reference "
                        f"argmax {top2.indices[i, 0].item()} (margin "
                        f"{margin:.4f})")
    if stats["expert_flips"] > MAX_FLIP_SHARE * len(prompts) * n_new:
        raise AssertionError(f"expert choice differs at {stats['expert_flips']}"
                             f" of {len(prompts) * n_new} positions")
    if stats["tokens_checked"] == 0:
        raise AssertionError("no position had a margin to check tokens at")
    return stats


# ---------------------------------------------------------------------------
# serve-mtp, serve-ems, cli
# ---------------------------------------------------------------------------


def expert_recorder(torch, when=None, no_drop=False):
    """``moe_capacity`` with each call's effective experts recorded (only
    while ``when()`` is true, if given): per token its K experts, sorted,
    an expert whose capacity buffer dropped the token shifted by
    ``num_experts`` (so a drop reads as a change). ``no_drop`` sizes every
    expert's buffer for all the call's tokens, as a decode step of a few
    rows always has it: the base model of a reference prefill."""
    from repro_torch.models.moe import (capacity_for, dispatch_indices,
                                        moe_capacity, route)
    calls = []

    def moe_fn(p, x, c):
        cap = x.shape[0] if no_drop else capacity_for(c, x.shape[0])
        if when is None or when():
            top_i = route(p.router, x, c)[0]
            _, valid = dispatch_indices(top_i, c.num_experts, cap)
            calls.append(torch.where(valid, top_i, top_i + c.num_experts)
                         .sort(dim=-1).values.cpu())
        return moe_capacity(p, x, c, capacity=cap)

    return moe_fn, calls


def check_served(torch, cfg, params, prompt, served, margin, stats,
                 dev="cuda", capacity=2048):
    """Hold ``served`` (tokens a serve emitted after ``prompt``, with
    ``moe_capacity``) against a teacher-forced prefill of prompt + served
    tokens: the prompt prefilled as the serve prefilled it (capacity drops
    included) and the served tokens replayed through ``decode_step`` at
    batch 1 give the decode path's logits and experts, which must lie
    within AGREE_ATOL of the prefill's where the experts agree; there each
    served token must be the prefill's argmax wherever its top-1/top-2
    margin exceeds ``margin``. The reference prefill drops no token (a
    decode step of 8 rows never does), so a served position whose token
    the serve's prefill dropped reads as a flip. Adds to ``stats``."""
    from repro_torch.models import decode_step, prefill

    moe_fn, calls = expert_recorder(torch)
    ref_fn, ref_calls = expert_recorder(torch, no_drop=True)
    n_moe = cfg.num_layers - cfg.first_k_dense

    def tok(ids):
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    logits, caches = prefill(params, cfg, {"tokens": tok([prompt])},
                             capacity, moe_fn, cache_dtype=torch.float32)
    replay = [logits[0, -1].float()]
    experts = [torch.stack([c[-1] for c in calls[-n_moe:]])]
    del logits
    for i, t in enumerate(served[:-1]):
        lg, caches = decode_step(params, cfg, tok([[t]]), caches,
                                 tok([len(prompt) + i]), moe_fn)
        replay.append(lg[0].float())
        experts.append(torch.stack([c[0] for c in calls[-n_moe:]]))
    del caches
    replay = torch.stack(replay)
    ref_logits, _ = prefill(params, cfg,
                            {"tokens": tok([prompt + served[:-1]])},
                            capacity, ref_fn, cache_dtype=torch.float32)
    ref = ref_logits[0, len(prompt) - 1:].float()
    del ref_logits
    top2 = ref.topk(2, dim=-1)
    stats["positions"] += len(served)
    stats["replay_argmax_equal_served"] += sum(
        a == b for a, b in zip(replay.argmax(-1).tolist(), served))
    for i in range(len(served)):
        ref_experts = torch.stack([c[len(prompt) - 1 + i]
                                   for c in ref_calls[-n_moe:]])
        err = (replay[i] - ref[i]).abs().max().item()
        if not torch.equal(experts[i], ref_experts):
            stats["expert_flips"] += 1
            continue
        stats["max_abs_logit_err"] = max(stats["max_abs_logit_err"], err)
        if err > AGREE_ATOL:
            raise AssertionError(f"position {i}: decode replay vs prefill "
                                 f"max |dlogit| {err:.4f} > {AGREE_ATOL}")
        gap = (top2.values[i, 0] - top2.values[i, 1]).item()
        if gap > margin:
            stats["tokens_checked"] += 1
            if served[i] != top2.indices[i, 0].item():
                raise AssertionError(
                    f"position {i}: served {served[i]}, prefill argmax "
                    f"{top2.indices[i, 0].item()} (margin {gap:.4f})")


def new_check_stats(margin):
    return {"margin": margin, "positions": 0, "tokens_checked": 0,
            "expert_flips": 0, "max_abs_logit_err": 0.0,
            "replay_argmax_equal_served": 0}


def close_check(stats, what):
    if stats["expert_flips"] > MAX_FLIP_SHARE * stats["positions"]:
        raise AssertionError(f"{what}: expert choice differs at "
                             f"{stats['expert_flips']} of "
                             f"{stats['positions']} positions")
    if stats["tokens_checked"] == 0:
        raise AssertionError(f"{what}: no position had a margin to check "
                             "tokens at")
    return stats


def mtp_requests(cfg):
    """serve-mtp's traffic: MTP_N_REQ prompts of MTP_PROMPT_LEN tokens
    (seed SEED + 10), MTP_NEW new tokens each."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.RandomState(SEED + 10)
    return [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                     MTP_PROMPT_LEN)],
                    MTP_NEW) for i in range(MTP_N_REQ)]


def serve_mtp_phase(torch, cfg, params, dev="cuda"):
    """MTP speculative decoding served on the R1 cut. The draft head
    (``init_mtp_params`` seed 1) is distilled by ``fit_draft_head`` on the
    served prompts; then the traffic is served twice through
    ``ServingSystem(use_mtp=True)``: per step with the two-decode-step
    verify (each iteration launches the MLA kernel twice per layer), and
    with the fused verify in chunks of 4 iterations (one two-token
    ``prefill_continue``, plain PyTorch as in JAX: no MLA kernel). Every
    request must finish, some draft must be accepted, and the served tokens
    must be the base model's greedy tokens (``check_served``)."""
    import numpy as np
    from repro_torch.core import fit_draft_head, init_mtp_params
    from repro_torch.serving import ServingSystem

    reqs = mtp_requests(cfg)
    head = init_mtp_params(cfg, seed=1, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    head = fit_draft_head(params, cfg, head,
                          prompts=np.asarray([r.prompt for r in reqs],
                                             np.int32),
                          gen_len=MTP_FIT_GEN, steps=MTP_FIT_STEPS)
    if dev == "cuda":
        torch.cuda.synchronize()
    out = {"requests": len(reqs), "prompt_len": MTP_PROMPT_LEN,
           "max_new_tokens": MTP_NEW,
           "fit_draft_head_s": time.perf_counter() - t0,
           "fit_steps": MTP_FIT_STEPS, "fit_gen_len": MTP_FIT_GEN}
    if dev == "cuda":
        out["fit_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, served = {}, {}
    for name, kw, per_iter in (("unfused", {}, 2),
                               ("fused", {"mtp_fused": True,
                                          "decode_chunk": 4}, 0)):
        system = ServingSystem(params, cfg, n_prefill=1, decode_batch=8,
                               capacity=2048, device=dev, use_mtp=True,
                               mtp_params=head, **kw)
        summary, counts[name], _, served[name] = serve_phase(
            torch, cfg, params, dev=dev, reqs=reqs, system=system,
            mla_per_iter=per_iter)
        if system.decode.mtp_fused != (name == "fused"):
            raise AssertionError(f"{name}: the engine's verify is not {name}")
        recs = system.scheduler.trace_records()
        iters = sum(r["decode_iters"] for r in recs)
        toks = sum(r["decode_tokens"] for r in recs)
        if toks <= iters:
            raise AssertionError(f"{name}: no draft was accepted "
                                 f"({toks} tokens in {iters} iterations)")
        summary.update({"mtp_iterations": iters, "decode_tokens": toks,
                        "tokens_per_iteration": toks / iters,
                        "acceptance": toks / iters - 1,
                        "engine_iterations": system.decode.iters})
        out[name] = summary
        del system
    out["tokens_identical_fused_vs_unfused"] = sum(
        a == b for rid in served["unfused"]
        for a, b in zip(served["unfused"][rid], served["fused"][rid])) / (
        MTP_N_REQ * MTP_NEW)
    for name in ("unfused", "fused"):
        stats = new_check_stats(MTP_MARGIN)
        for r in reqs:
            check_served(torch, cfg, params, r.prompt, served[name][r.rid],
                         MTP_MARGIN, stats, dev)
        out[f"check_{name}"] = close_check(stats, f"serve-mtp {name}")
    del head
    return out, counts


def serve_ems_phase(torch, cfg, params, first_tokens, dev="cuda"):
    """Two turns of the serve traffic through one ``ServingSystem`` with
    an ``EMSService`` context cache (blocks of EMS_BLOCK tokens, tag
    ``cfg.name``): turn 1 the ``serve_requests`` prompts, turn 2 each
    prompt + its 32 served tokens + EMS_TURN2_NEW new ones. Turn 2 must
    reuse exactly the first turn's whole blocks, run its suffixes through
    ``prefill_continue``, and keep the EMS byte books equal to its transfer
    engine's; each turn-2 first token is held against a cold prefill of the
    same prompt, which drops no token (logits within AGREE_ATOL where the
    last token's experts agree, the argmax where the margin exceeds 2 x
    AGREE_ATOL). Reports the hit rate, turn-2 prefill time beside the cold
    prefill's (bare, and under turn 2's instrumentation: part timers that
    synchronize the device, an expert recorder on the suffix's MoE calls),
    and the time of each part of the reuse path."""
    import numpy as np
    from repro_torch.mempool import EMSService, MemoryPool
    from repro_torch.models import prefill
    from repro_torch.serving import Request, ServingSystem, cache_ops

    turn1 = serve_requests(cfg)
    rng = np.random.RandomState(SEED + 20)
    ems = EMSService(MemoryPool(n_nodes=8), block_tokens=EMS_BLOCK,
                     model_tag=cfg.name)
    # moe_capacity, recording experts only inside a suffix run (below).
    in_suffix = [False]
    moe_fn, suffix_calls = expert_recorder(torch, lambda: in_suffix[0])
    n_moe = cfg.num_layers - cfg.first_k_dense
    system = ServingSystem(params, cfg, n_prefill=1, decode_batch=8,
                           capacity=2048, context_cache=ems, moe_fn=moe_fn,
                           device=dev)
    pre = system.prefills[0]
    s1, c1, _, tok1 = serve_phase(torch, cfg, params, dev=dev, reqs=turn1,
                                  system=system)
    if any(tok1[r.rid][:1] != first_tokens[r.rid][:1] for r in turn1):
        raise AssertionError("turn 1's first tokens differ from the serve "
                             "phase's (the same prompts, cache empty)")
    turn2 = [Request(r.rid, r.prompt + tok1[r.rid] + [
        int(t) for t in rng.randint(0, cfg.vocab_size, EMS_TURN2_NEW)],
        r.max_new_tokens) for r in turn1]

    # Times of the reuse path's parts, each ending in a synchronize.
    parts = {"fetch_s": [], "suffix_s": [], "store_s": []}
    fetch0, cont0, pack0 = ems.fetch, pre._continue_chunks, \
        cache_ops.pack_blocks
    last_logits = {}

    def timed(key, fn):
        def wrapped(*a, **kw):
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            parts[key].append(time.perf_counter() - t0)
            return out
        return wrapped

    def suffix(tokens, caches, pos, chunk, fresh):
        # The last token's row in the last call: the calls' widths as
        # _continue_chunks takes them (the chunk, clamped to the headroom).
        st, p0, part = 0, pos, 0
        while st < len(tokens):
            part = min(min(chunk, pre.capacity - p0), len(tokens) - st)
            st, p0 = st + part, p0 + part
        suffix_calls.clear()
        in_suffix[0] = True
        try:
            out = cont0(tokens, caches, pos, chunk, fresh)
        finally:
            in_suffix[0] = False
        last_logits[len(last_logits)] = (
            out[0].float(),
            torch.stack([c[part - 1] for c in suffix_calls[-n_moe:]]))
        return out

    ems.fetch = timed("fetch_s", fetch0)
    pre._continue_chunks = timed("suffix_s", suffix)
    cache_ops.pack_blocks = timed("store_s", pack0)
    suffix0 = pre.suffix_calls
    try:
        s2, c2, _, tok2 = serve_phase(torch, cfg, params, dev=dev,
                                      reqs=turn2, system=system)
    finally:
        del ems.fetch, pre._continue_chunks
        cache_ops.pack_blocks = pack0
    want = [len(r.prompt) // EMS_BLOCK * EMS_BLOCK for r in turn1]
    got = s2["reused_tokens"]
    if got != want:
        raise AssertionError(f"turn-2 reused tokens {got} != whole blocks "
                             f"of turn 1 {want}")
    if pre.suffix_calls <= suffix0 or len(last_logits) != len(turn2):
        raise AssertionError(f"suffix calls {pre.suffix_calls - suffix0}, "
                             f"suffix runs {len(last_logits)}")
    ems.flush()
    st = ems.ems_stats()
    books = (ems.transfer.bytes_promoted, ems.transfer.bytes_demoted)
    if (st["promote_bytes"], st["demote_bytes"]) != books or books[1] == 0:
        raise AssertionError(f"EMS promote/demote bytes "
                             f"{(st['promote_bytes'], st['demote_bytes'])} "
                             f"!= transfer engine's books {books}")

    # Cold prefills of the turn-2 prompts, each timed bare and under turn
    # 2's instrumentation (an expert recorder on every MoE call, the device
    # synchronized before and after); then the first token.
    cold_fn, calls = expert_recorder(torch, no_drop=True)
    inst_fn, inst_calls = expert_recorder(torch)
    stats = {"margin": 2 * AGREE_ATOL, "checked": 0, "expert_flips": 0,
             "max_abs_logit_err": 0.0}

    def cold_time(toks, fn):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(params, cfg, {"tokens": toks}, 2048, fn,
                            cache_dtype=torch.float32)
        int(torch.argmax(logits[0, -1]))          # ends in a host read
        if dev == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    cold_s, cold_inst_s = [], []
    for k, r in enumerate(turn2):
        first = tok2[r.rid][0]
        toks = torch.tensor([r.prompt], dtype=torch.int32, device=dev)
        cold_s.append(cold_time(toks, None))
        cold_inst_s.append(cold_time(toks, inst_fn))
        inst_calls.clear()
        calls.clear()
        logits, _ = prefill(params, cfg, {"tokens": toks}, 2048, cold_fn,
                            cache_dtype=torch.float32)
        cold = logits[0, -1].float()
        del logits
        cold_experts = torch.stack([c[-1] for c in calls[-n_moe:]])
        ems_last, ems_experts = last_logits[k]
        if first != int(ems_last.argmax()):
            raise AssertionError(f"rid {r.rid}: served first token "
                                 f"{first} is not its logits' argmax")
        if not torch.equal(ems_experts, cold_experts):
            stats["expert_flips"] += 1
            continue
        err = (ems_last - cold).abs().max().item()
        stats["max_abs_logit_err"] = max(stats["max_abs_logit_err"], err)
        if err > AGREE_ATOL:
            raise AssertionError(f"rid {r.rid}: EMS path vs cold prefill "
                                 f"max |dlogit| {err:.4f} > {AGREE_ATOL}")
        top2 = cold.topk(2)
        gap = (top2.values[0] - top2.values[1]).item()
        if gap > stats["margin"]:
            stats["checked"] += 1
            if first != top2.indices[0].item():
                raise AssertionError(f"rid {r.rid}: EMS first token "
                                     f"{first}, cold prefill "
                                     f"{top2.indices[0].item()} (margin "
                                     f"{gap:.4f})")
    if stats["expert_flips"] > MAX_FLIP_SHARE * len(turn2):
        raise AssertionError(f"EMS first tokens: expert choice differs at "
                             f"{stats['expert_flips']} of {len(turn2)}")
    s2.update({"turn2_prompt_lens": [len(r.prompt) for r in turn2],
               "suffix_calls": pre.suffix_calls - suffix0,
               "suffix_widths": sorted(pre.suffix_widths),
               "cold_prefill_s": cold_s,
               "cold_prefill_p50_s": statistics.median(cold_s),
               "cold_prefill_instrumented_s": cold_inst_s,
               "cold_prefill_instrumented_p50_s": statistics.median(
                   cold_inst_s),
               "ems_prefill_p50_s": statistics.median(s2["prefill_s"]),
               **parts,
               "first_token_check": stats})
    out = {"turn1": s1, "turn2": s2, "ems": st,
           "pool": ems.pool.stats()}
    return out, {"turn1": c1, "turn2": c2}


def run_cli(argv):
    """``repro_torch.launch.serve.main(argv)`` in this process, every kernel
    count set to 0 just before it and read just after. Returns (printed
    text, counts, wall seconds, per-request rows (rid, reused, computed,
    iterations, tokens))."""
    import contextlib
    import io
    from repro_torch.launch import serve

    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = buf.getvalue()
    rows = re.findall(r"rid=(\d+) prefill@\d+ reused=(\d+) computed=(\d+) "
                      r"iters=(\d+) tokens=\[([^\]]*)\]", text)
    if not rows:
        raise AssertionError(f"cli printed no request line:\n{text}")
    return text, counts, wall, rows


def cli_phase(torch, arch="deepseek-r1", dev="cuda"):
    """``repro_torch.launch.serve.main`` in this process, on the card:
    the arch's smoke variant with fused MTP, a draft head fitted on the
    served prompts, 4 iterations a sync and the EMS cache on (the CLI's
    default). It must finish, reuse the shared prefix in a later request,
    and take fewer iterations than tokens."""
    argv = ["--arch", arch, "--mtp", "--mtp-fused", "--fit-draft",
            "--decode-chunk", "4", "--device", dev]
    text, counts, wall, rows = run_cli(argv)
    reused = {int(r[0]): int(r[1]) for r in rows}
    iters = sum(int(r[3]) for r in rows)
    tokens = sum(len(r[4].split(",")) for r in rows)
    if not any(v > 0 for rid, v in reused.items() if rid > 0):
        raise AssertionError(f"cli: no later request reused a prefix: "
                             f"{reused}")
    if iters >= tokens:
        raise AssertionError(f"cli: {iters} iterations for {tokens} tokens")
    for key in ("SLO summary (virtual clock):", "ems: hit_rate=",
                "transfer:"):
        if key not in text:
            raise AssertionError(f"cli printed no {key!r} line")
    return {"argv": argv, "wall_s": wall, "requests": len(rows),
            "reused": reused, "iterations": iters, "tokens": tokens,
            "kernel_launches": counts,
            "lines": [ln for ln in text.splitlines()
                      if ln.startswith(("SLO summary", "ems:", "transfer:"))]}


# ---------------------------------------------------------------------------
# Qwen3-8B whole (serve-dense, dense-agreement, int8-dense) and OLMoE-1B-7B
# whole (serve-olmoe, serve-olmoe-lep)
# ---------------------------------------------------------------------------


def dense_config():
    from repro_torch.configs import get_config
    # Whole: 36 layers, d_model 4096, 32 heads over 8 KV heads of 128,
    # d_ff 12288, vocab 151936, qk-norm; sliding_window 8192.
    return get_config("qwen3-8b")


def olmoe_config():
    from repro_torch.configs import get_config
    # Whole: 16 layers, d_model 2048, 16 heads, 64 experts x 1024, top-8.
    return get_config("olmoe-1b-7b")


def init_model(torch, cfg, what):
    """``init_params`` of ``cfg`` from SEED on the card, logged as
    ``init-<what>:``."""
    from repro_torch.models import init_params

    ti = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    log(f"init-{what}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f}"
        f" B parameters in {time.perf_counter() - ti:.1f} s")
    return params


def free_model(torch) -> None:
    """Return a freed model's memory to the card, so that the next model's
    peak memory is its own (the engines of earlier serves sit in reference
    cycles through their instrumented methods)."""
    gc.collect()
    torch.cuda.empty_cache()


def dense_replay(torch, cfg, params, prompt, served, capacity, dev="cuda"):
    """The decode path's logits for ``served`` (the prompt's prefill, then
    the served tokens teacher-forced through ``decode_step`` at batch 1)
    and a full-sequence ``prefill`` over prompt + served tokens, both
    (len(served), V) in f32."""
    from repro_torch.models import decode_step, prefill

    def tok(ids):
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    logits, caches = prefill(params, cfg, {"tokens": tok([prompt])},
                             capacity, cache_dtype=torch.float32)
    replay = [logits[0, -1].float()]
    del logits
    for i, t in enumerate(served[:-1]):
        lg, caches = decode_step(params, cfg, tok([[t]]), caches,
                                 tok([len(prompt) + i]))
        replay.append(lg[0].float())
    del caches
    ref_logits, _ = prefill(params, cfg, {"tokens": tok([prompt + served[:-1]])},
                            capacity, cache_dtype=torch.float32)
    ref = ref_logits[0, len(prompt) - 1:].float()
    return torch.stack(replay), ref


def new_dense_stats():
    return {"atol": DENSE_AGREE_ATOL, "margin": DENSE_MARGIN, "positions": 0,
            "max_abs_logit_err": 0.0, "logit_err_p50": None,
            "tokens_checked": 0, "replay_argmax_equal_served": 0,
            "_errs": []}


def hold_dense(stats, what, served, replay, ref):
    """Replay logits within DENSE_AGREE_ATOL of the prefill's at every
    position, and each served token the prefill's argmax wherever its
    top-1/top-2 margin exceeds DENSE_MARGIN. Adds to ``stats``."""
    err = (replay - ref).abs().amax(dim=-1)
    top2 = ref.topk(2, dim=-1)
    gap = (top2.values[:, 0] - top2.values[:, 1]).tolist()
    best = top2.indices[:, 0].tolist()
    stats["positions"] += len(served)
    stats["_errs"] += err.tolist()
    stats["max_abs_logit_err"] = max(stats["_errs"])
    stats["replay_argmax_equal_served"] += sum(
        a == b for a, b in zip(replay.argmax(-1).tolist(), served))
    worst = float(err.max())
    if worst > DENSE_AGREE_ATOL:
        raise AssertionError(f"{what}: decode replay vs prefill max |dlogit| "
                             f"{worst:.4f} > {DENSE_AGREE_ATOL}")
    for i, (g, b) in enumerate(zip(gap, best)):
        if g > DENSE_MARGIN:
            stats["tokens_checked"] += 1
            if served[i] != b:
                raise AssertionError(f"{what} position {i}: served "
                                     f"{served[i]}, prefill argmax {b} "
                                     f"(margin {g:.4f})")


def close_dense(stats, what):
    if stats["tokens_checked"] == 0:
        raise AssertionError(f"{what}: no position had a margin to check "
                             "tokens at")
    stats["logit_err_p50"] = statistics.median(stats.pop("_errs"))
    return stats


def dense_agreement_phase(torch, cfg, params, reqs, served, dev="cuda"):
    """Replay check: DENSE_AGREE_RIDS' served prompts through ``decode_step``
    against a full-sequence ``prefill`` over prompt + served tokens."""
    stats = new_dense_stats()
    for rid in DENSE_AGREE_RIDS:
        prompt, toks = reqs[rid].prompt, served[rid]
        replay, ref = dense_replay(torch, cfg, params, prompt, toks,
                                   len(prompt) + len(toks), dev)
        hold_dense(stats, f"rid {rid}", toks, replay, ref)
    stats["rids"] = list(DENSE_AGREE_RIDS)
    return close_dense(stats, "dense-agreement")


def ring_phase(torch, cfg, params, dev="cuda"):
    """Ring check at the config's own ``sliding_window``: RING_REQS prompts
    of RING_PROMPT_LEN tokens (past the window) and RING_NEW new each,
    served through ``ServingSystem(capacity=RING_PROMPT_LEN + RING_NEW,
    decode_batch=RING_REQS)``. The decode caches must be rings of
    ``sliding_window`` slots and no kernel may launch. Each request is then
    replayed at batch 1 through ``decode_step`` from a ring prefill and held
    with the served tokens against a teacher-forced ``prefill`` over prompt
    + served tokens (s > window: the window mask applies), as in the
    dense-agreement phase."""
    import numpy as np
    from repro_torch.serving import Request, ServingSystem

    rng = np.random.RandomState(SEED + 20)
    reqs = [Request(i, [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                     RING_PROMPT_LEN)],
                    RING_NEW) for i in range(RING_REQS)]
    capacity = RING_PROMPT_LEN + RING_NEW
    system = ServingSystem(params, cfg, n_prefill=1, decode_batch=RING_REQS,
                           capacity=capacity, device=dev)
    slots = sorted({c.k.shape[2] for c in system.decode.caches.values()})
    if slots != [cfg.sliding_window]:
        raise AssertionError(f"decode caches of {slots} slots, not rings of "
                             f"{cfg.sliding_window}")
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = system.serve(reqs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the ring serve launched a kernel: {counts}")
    if len(results) != RING_REQS or any(r.shed or len(r.tokens) != RING_NEW
                                        for r in results):
        raise AssertionError("not every ring request finished")
    out = {"requests": RING_REQS, "prompt_len": RING_PROMPT_LEN,
           "max_new_tokens": RING_NEW, "capacity": capacity,
           "sliding_window": cfg.sliding_window, "ring_slots": slots[0],
           "serve_wall_s": wall, "kernel_launches": counts,
           "depth": cfg.num_layers}
    if dev == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del system
    stats = new_dense_stats()
    for r in sorted(results, key=lambda r: r.rid):
        prompt = reqs[r.rid].prompt
        replay, ref = dense_replay(torch, cfg, params, prompt, r.tokens,
                                   capacity, dev)
        hold_dense(stats, f"ring rid {r.rid}", r.tokens, replay, ref)
    out.update(close_dense(stats, "ring"))
    return out


def ssd_bound(b, s, h, p, n, q):
    """Least time (ms) for the SSD scan on these shapes, what bounds it, and
    the same count read at the FP32 rate: x, dt, a_log, B and C read once
    and y and the final state written once over the HBM rate, against the
    products the function needs. It is causal (y_t reads rows s <= t), so
    per chunk of L rows: C.B^T on and below the diagonal, L(L+1)N, once,
    since every head shares B and C; per head W.x over the same triangle,
    L(L+1)P, the chunk's own state, 2LNP, and C.h, 2LNP, for every chunk
    but the first, whose entering state is zero. The ragged last chunk
    counts at its own L. The state pass's 2PN operations a chunk and head
    (under 0.5 % of the products) are left out, so the bound stays a lower
    one. The kernel takes every product on the tensor cores in 3xTF32,
    three TF32 passes, so the operations count at a third of the TF32 rate;
    the FP32 reading (the bound of a kernel without tensor cores) stays
    beside it."""
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + b * h * p * n)
    lens = [min(q, s - c0) for c0 in range(0, s, q)]
    flops = b * sum(rows * (rows + 1) * (n + h * p) + 2 * h * rows * n * p
                    * (2 if c else 1) for c, rows in enumerate(lens))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(t_bytes, flops / FP32_FLOP_PER_S))


def ssd_stage_rows(torch, ops, args, q):
    """Each stage of the kernel, read from the wrapper's own scratch after
    its launch (``ssd_scan_stages``), against the plain stage on the same
    inputs (``ssd_stages``) within SSD_TOL, so that a fault names its stage.
    C.B^T is compared on and below the diagonal, all the kernel writes."""
    from repro_torch.kernels.ssd_scan.ref import ssd_stages

    got = ops.ssd_scan_stages(*args, chunk=q)
    torch.cuda.synchronize()
    want = ssd_stages(*args, q)
    rows = []
    for stage, keys in zip(ops.STAGES, (("cb",), ("cum", "chunk_states"),
                                        ("states_in", "h_final"), ("y",))):
        row = {"stage": stage}
        for key in keys:
            g, w = got[key], want[key]
            if key == "cb":
                keep = torch.ones(w.shape[-2:], dtype=torch.bool,
                                  device=w.device).tril()
                g, w = g[..., keep], w[..., keep]
            err = (g - w).abs().max().item()
            if not (torch.isfinite(g).all() and torch.allclose(
                    g, w, rtol=SSD_TOL,
                    atol=SSD_ATOL_REL * w.abs().max().item())):
                raise AssertionError(f"ssd_scan stage {stage} disagrees with "
                                     f"its plain stage on {key}: max |err| "
                                     f"{err:.3e}")
            row[key] = {"max_abs_err": err, "max_abs": w.abs().max().item()}
        rows.append(row)
    return rows


SSD_KERNELS = ("cb_kernel", "states_kernel", "pass_kernel", "output_kernel")


def graph_of(torch, fn):
    """``fn`` captured in a CUDA graph (after one run on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def ssd_stage_ms(torch, fn, flush, reps=10) -> dict:
    """Mean device time (ms) of each SSD stage kernel over ``reps`` calls of
    ``fn``, each after an L2 flush, from ``torch.profiler``'s CUDA events;
    empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        name = next((k for k in SSD_KERNELS if k + "(" in event.key), None)
        if name is not None:
            total = getattr(event, "device_time_total", None)
            if total is None:
                total = event.cuda_time_total
            out[name] = total / event.count / 1e3
    return out


MANGLED_TYPES = {"f": "float", "i": "int", "b": "bool", "j": "unsigned"}


def entry_name(mangled: str) -> str:
    """The unqualified name in an Itanium-mangled function name, with its
    template arguments where they are integers or simple types
    (``_ZN12_GLOBAL__N_19cb_kernelE...`` -> ``cb_kernel``;
    ``..16int8_gemm_kernelILi64ELi8ELi8ELb1EEEv..`` ->
    ``int8_gemm_kernel<64,8,8,1>``)."""
    i, parts = 2 + mangled[2:3].count("N"), []
    while mangled.startswith("_Z") and i < len(mangled) \
            and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        k = int(mangled[i:j])
        parts.append(mangled[j:j + k])
        i = j + k
    if not parts:
        return mangled
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            lit = re.match(r"L[a-z](-?\d+)E", mangled[i:])
            name = re.match(r"(\d+)", mangled[i:])
            if lit:
                args.append(lit.group(1))
                i += lit.end()
            elif name:
                j = i + len(name.group(1))
                args.append(mangled[j:j + int(name.group(1))])
                i = j + int(name.group(1))
            elif mangled[i] in MANGLED_TYPES:
                args.append(MANGLED_TYPES[mangled[i]])
                i += 1
            else:
                break
    return parts[-1] + (f"<{','.join(args)}>" if args else "")


def tensor_core_ops(lib_path) -> dict:
    """Tensor-core instructions in each kernel function of a built
    library's SASS, by ``cuobjdump -sass``: floating-point ``HMMA`` and
    warpgroup ``HGMMA``, integer ``IMMA`` and warpgroup ``IGMMA``."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = entry_name(m.group(1))
            counts[func] = {}
        elif func is not None:
            for op in re.findall(r"\b([HI]G?MMA\.[0-9A-Za-z.]+)", line):
                counts[func][op] = counts[func].get(op, 0) + 1
    return counts


def ssd_inputs(torch, gen, b, s, h, p, n, dev="cuda"):
    """Seeded inputs shaped as ``mamba_prefill`` gives them: dt = softplus
    of a unit normal (the model's dt with dt_bias 0), A_log around 0."""
    x = torch.randn(b, s, h, p, device=dev, generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device=dev, generator=gen))
    a_log = 0.1 * torch.randn(h, device=dev, generator=gen)
    bm = torch.randn(b, s, n, device=dev, generator=gen)
    cm = torch.randn(b, s, n, device=dev, generator=gen)
    return x, dt, a_log, bm, cm


def ssd_check(torch, args, q, ref_fn, what, name):
    """``ssd_scan`` on ``args`` against ``ref_fn`` (y and the final state
    within SSD_TOL); raises on a disagreement."""
    from repro_torch.kernels.ssd_scan import ops

    y, hf = ops.ssd_scan(*args, chunk=q)
    torch.cuda.synchronize()
    yr, hr = ref_fn(*args)
    err = max((y - yr).abs().max().item(), (hf - hr).abs().max().item())
    if not (torch.isfinite(y).all() and torch.isfinite(hf).all() and all(
            torch.allclose(got, ref, rtol=SSD_TOL,
                           atol=SSD_ATOL_REL * ref.abs().max().item())
            for got, ref in ((y, yr), (hf, hr)))):
        raise AssertionError(f"ssd_scan disagrees with {what} ({name}): "
                             f"max |err| {err:.3e}")
    return {"max_abs_err": err, "max_abs_y": yr.abs().max().item(),
            "max_abs_h": hr.abs().max().item()}


def ssd_case_row(torch, flush, gen, name, b, s, h, p, n, q, timed):
    """One SSD case on seeded inputs: the kernel against its plain version;
    if ``timed``, the distance of each from a float64 evaluation, median
    CUDA-event times of the kernel, of its CUDA-graph replay and of the
    plain version, and each stage kernel's device time; and the bound.
    Returns (row, inputs)."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    args = ssd_inputs(torch, gen, b, s, h, p, n)
    row = {"case": name, "B": b, "S": s, "H": h, "P": p, "N": n, "Q": q,
           **ssd_check(torch, args, q, lambda *a: ssd_chunked(*a, q),
                       "its plain version", name)}
    if timed:
        # Distance of the kernel and of the plain version from a float64
        # evaluation, per unit of the largest output.
        y64 = ssd_chunked(*(a.double() for a in args), q)[0]
        scale = y64.abs().max().item()
        for key, fn in (("kernel_vs_f64", ops.ssd_scan),
                        ("plain_vs_f64", ssd_chunked)):
            row[key] = ((fn(*args, chunk=q)[0].double() - y64).abs()
                        .max().item() / scale)

        def scan():
            return ops.ssd_scan(*args, chunk=q)

        row["ms"] = timed_ms(torch, scan, 30, flush)
        row["graph_ms"] = timed_ms(torch, graph_of(torch, scan).replay,
                                   30, flush)
        row["stage_ms"] = ssd_stage_ms(torch, scan, flush)
        row["plain_ms"] = timed_ms(torch, lambda: ssd_chunked(
            *args, chunk=q), 10, flush)
    row["bound_ms"], row["bound_by"], row["bound_fp32_ms"] = ssd_bound(
        b, s, h, p, n, q)
    return row, args


def ssd_scan_phase(torch, flush, q):
    """``ssd_scan`` against its plain PyTorch version (y and the final
    state within SSD_TOL) at SSD_CASES, the timed ones with median
    CUDA-event times of kernel and plain version beside the bound, the
    first one also stage by stage (``ssd_stage_rows``); then one small case
    against the token recurrence ``ssd_reference``."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.mamba2 import ssd_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, b, s, h, p, n, timed in SSD_CASES:
        row, args = ssd_case_row(torch, flush, gen, name, b, s, h, p, n, q,
                                 timed)
        log("ssd_scan:", json.dumps(row))
        rows.append(row)
        if len(rows) == 1:                # the served S = 1019, stage by stage
            for stage in ssd_stage_rows(torch, ops, args, q):
                log("ssd_scan-stage:", json.dumps({"case": name, **stage}))
    from repro_torch.kernels import build

    sass = tensor_core_ops(build.library_path("ssd_scan"))
    log("ssd_scan-sass:", json.dumps(sass))
    for name in ("cb_kernel", "states_kernel", "output_kernel"):
        if not sass.get(name):
            raise AssertionError(f"no tensor-core instruction in {name}: "
                                 f"{sass}")
    b, s, h, p, n = SSD_ORACLE_CASE
    row = {"case": "vs ssd_reference", "B": b, "S": s, "H": h, "P": p,
           "N": n, "Q": q, **ssd_check(
               torch, ssd_inputs(torch, gen, b, s, h, p, n), q,
               ssd_reference, "the token recurrence", "vs ssd_reference")}
    log("ssd_scan:", json.dumps(row))
    rows.append(row)
    return rows


def ssd_scan_zamba_phase(torch, flush, q):
    """``ssd_scan`` at Zamba2's served widths (ZAMBA_SSD_CASES: H=64, P=64,
    N=64, half the kernel's 128-column state tile), timed and checked as
    the ssd_scan phase's served rows, the first also stage by stage."""
    from repro_torch.kernels.ssd_scan import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for name, b, s, h, p, n in ZAMBA_SSD_CASES:
        row, args = ssd_case_row(torch, flush, gen, name, b, s, h, p, n, q,
                                 True)
        log("ssd_scan-zamba:", json.dumps(row))
        rows.append(row)
        if len(rows) == 1:
            for stage in ssd_stage_rows(torch, ops, args, q):
                log("ssd_scan-zamba-stage:",
                    json.dumps({"case": name, **stage}))
    return rows


def dev_tokens(torch, ids, dev="cuda"):
    return torch.tensor(ids, dtype=torch.int32, device=dev)


def replay_logits(torch, p, c, prompt, toks, dev="cuda"):
    """Logits of ``prefill(prompt)`` at its last position, then of each
    token of ``toks[:-1]`` teacher-forced through ``decode_step`` (batch 1,
    f32 caches)."""
    from repro_torch.models import decode_step, prefill

    n = len(toks)
    logits, caches = prefill(p, c, {"tokens": dev_tokens(torch, [prompt], dev)},
                             len(prompt) + n, cache_dtype=torch.float32)
    out = [logits[0, -1].float()]
    for i, t_ in enumerate(toks[:-1]):
        lg, caches = decode_step(p, c, dev_tokens(torch, [[t_]], dev), caches,
                                 dev_tokens(torch, [len(prompt) + i], dev))
        out.append(lg[0].float())
    return torch.stack(out)


def whole_logits(torch, p, c, prompt, toks, dev="cuda"):
    """``prefill`` over prompt + toks[:-1], from the prompt's last position
    on: the reference for ``replay_logits``."""
    from repro_torch.models import prefill

    return prefill(p, c, {"tokens": dev_tokens(torch, [prompt + toks[:-1]],
                                               dev)},
                   len(prompt) + len(toks), cache_dtype=torch.float32
                   )[0][0, len(prompt) - 1:].float()


def f32_served_check(torch, cfg32, p32, reqs, rids, atol, window_atol,
                     what, tag, dev="cuda"):
    """The requests ``rids`` served through ``ServingSystem`` in float32,
    each replayed at batch 1: the replay's logits within ``window_atol`` of
    a ``prefill`` over prompt + served tokens, and each served token the
    replay's argmax wherever the replay's margin exceeds 2 x ``atol`` (at
    least one such position over all requests). Logged as ``<tag>:``."""
    from repro_torch.serving import Request, ServingSystem

    system = ServingSystem(p32, cfg32, n_prefill=1, decode_batch=8,
                           capacity=2048, device=dev)
    served32 = {r.rid: r.tokens for r in system.serve(
        [Request(rid, reqs[rid].prompt, reqs[rid].max_new_tokens)
         for rid in rids])}
    del system
    f32s = {"requests": len(rids), "window_atol": window_atol,
            "positions": 0, "per_request": []}
    for rid in rids:
        prompt, toks = reqs[rid].prompt, served32[rid]
        if len(toks) != reqs[rid].max_new_tokens:
            raise AssertionError(f"f32 serve: rid {rid} finished with "
                                 f"{len(toks)} tokens")
        rep = replay_logits(torch, p32, cfg32, prompt, toks, dev)
        ref_w = whole_logits(torch, p32, cfg32, prompt, toks, dev)
        top2 = rep.topk(2, dim=-1)
        clear = (top2.values[:, 0] - top2.values[:, 1]) > 2 * atol
        row = {"rid": rid, "prompt": len(prompt),
               "max_abs_logit_err": (rep - ref_w).abs().max().item(),
               "tokens_checked": int(clear.sum()),
               "tokens_differing": int(
                   (clear & (dev_tokens(torch, toks, dev)
                             != top2.indices[:, 0])).sum())}
        f32s["per_request"].append(row)
        f32s["positions"] += len(toks)
    log(f"{tag}: {json.dumps(f32s)}")
    for row in f32s["per_request"]:
        if not row["max_abs_logit_err"] <= window_atol:
            raise AssertionError(f"rid {row['rid']}: f32 {what} decode after "
                                 f"prefill errs by {row['max_abs_logit_err']:.3e}"
                                 f" > {window_atol}")
        if row["tokens_differing"]:
            raise AssertionError(f"rid {row['rid']}: {row['tokens_differing']}"
                                 " served f32 tokens differ from the replay's "
                                 "argmax at a clear margin")
    if not sum(r["tokens_checked"] for r in f32s["per_request"]):
        raise AssertionError("f32 serve: no position had a margin to check "
                             "tokens at")
    return f32s


def bf16_ratio_check(torch, cfg, params, cfg32, p32, reqs, served, rids,
                     ratio, what, dev="cuda"):
    """Each bf16-served request of ``rids`` replayed at batch 1: against the
    float32 ``prefill`` over prompt + served tokens, the replay's largest
    logit error may be at most ``ratio`` times the bf16 ``prefill``'s."""
    bf = {"requests": len(rids), "ratio": ratio, "positions": 0,
          "per_request": []}
    for rid in rids:
        prompt, toks = reqs[rid].prompt, served[rid]
        rep = replay_logits(torch, params, cfg, prompt, toks, dev)
        ref16, ref32 = (whole_logits(torch, p, c, prompt, toks, dev)
                        for p, c in ((params, cfg), (p32, cfg32)))
        row = {"rid": rid,
               "decode_vs_prefill": (rep - ref16).abs().max().item(),
               "decode_vs_f32": (rep - ref32).abs().max().item(),
               "prefill_vs_f32": (ref16 - ref32).abs().max().item()}
        bf["per_request"].append(row)
        bf["positions"] += len(toks)
        allowed = ratio * row["prefill_vs_f32"]
        if not row["decode_vs_f32"] <= allowed:
            raise AssertionError(f"rid {rid}: bf16 {what} decode errs by "
                                 f"{row['decode_vs_f32']:.4f} against f32, "
                                 f"more than {ratio} x the bf16 prefill's "
                                 f"{row['prefill_vs_f32']:.4f}")
    return bf


def ssm_agreement_phase(torch, cfg, params, reqs, served, dev="cuda"):
    """Mamba2 decode (the recurrence) against full-sequence prefill (the
    chunked scan through the kernel), on the served prompts of
    SSM_AGREE_RIDS.

    float32, from a zero state: the served weights upcast; the first
    SSM_F32_TOKENS + SSM_HANDOFF_STEPS tokens of each prompt (batch 3)
    stepped through ``decode_step`` must give every position's logits within
    SSM_F32_ATOL of a ``prefill`` over the same tokens, and the same argmax
    wherever the prefill's top-1/top-2 margin exceeds 2 x SSM_F32_ATOL (at
    least one position).

    float32, the handoff: ``prefill`` over the first SSM_F32_TOKENS (the
    kernel's final state after a ragged last chunk), then the next
    SSM_HANDOFF_STEPS through ``decode_step``, against that same whole
    prefill: within SSM_F32_ATOL from the kernel's state and the
    recurrence's conv window, within SSM_WINDOW_ATOL from prefill's own
    state (its conv window in bf16). Two planted faults -- a zeroed state,
    a zeroed conv window -- must err by more than SSM_FAULT_FACTOR x
    SSM_WINDOW_ATOL, so that the check would see them.

    float32, served: the same requests served through ``ServingSystem`` in
    float32, then each replayed at batch 1 (``prefill`` of the prompt, its
    served tokens teacher-forced through ``decode_step``). The replay's
    logits must lie within SSM_WINDOW_ATOL of a ``prefill`` over prompt +
    served tokens, and each served token must be the replay's argmax
    wherever the replay's margin exceeds 2 x SSM_F32_ATOL (the serve
    computes the same thing at another batch size). (A margin of 2 x
    SSM_WINDOW_ATOL against the prefill is clear at almost no position.)

    bfloat16, as served: each request is replayed at batch 1 (prefill of
    the prompt, then its served tokens teacher-forced through
    ``decode_step``). Against the float32 ``prefill`` over prompt + served
    tokens, the replay's largest logit error may be at most SSM_BF16_RATIO
    times the bf16 ``prefill``'s over the same tokens. (No served bf16 token
    is checked against an argmax: the margin that bf16 rounding leaves
    clear is above nearly every top-1/top-2 gap; the float32 serve checks
    the served tokens instead.)"""
    import copy
    from repro_torch.models import decode_step, make_caches, prefill
    from repro_torch.models.mamba2 import SSMState

    def tok(ids):
        return dev_tokens(torch, ids, dev)

    # float32, from a zero state, over T + K tokens; the state after T is
    # kept for the handoff below.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = copy.deepcopy(params).float()
    t, k = SSM_F32_TOKENS, SSM_HANDOFF_STEPS
    seqs = tok([reqs[rid].prompt[:t + k] for rid in SSM_AGREE_RIDS])
    caches = make_caches(cfg32, len(SSM_AGREE_RIDS), t + k, torch.float32,
                         dev)
    steps = []
    for i in range(t + k):
        if i == t:
            h_t, conv_t = (caches["mamba"].h.clone(),
                           caches["mamba"].conv.clone())
        lg, caches = decode_step(p32, cfg32, seqs[:, i:i + 1], caches, tok(i))
        steps.append(lg.float())
    rec = torch.stack(steps, 1)                              # (3, t + k, V)
    ref = prefill(p32, cfg32, {"tokens": seqs}, t + k,
                  cache_dtype=torch.float32)[0].float()
    err = (rec - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) > 2 * SSM_F32_ATOL
    same = rec.argmax(-1) == top2.indices[..., 0]
    stats = {"f32": {"sequences": len(SSM_AGREE_RIDS), "tokens": t + k,
                     "atol": SSM_F32_ATOL, "max_abs_logit_err": err,
                     "tokens_checked": int(clear.sum()),
                     "argmax_equal_share": same.float().mean().item()}}
    log(f"ssm-agreement f32: {json.dumps(stats['f32'])}")
    if not err <= SSM_F32_ATOL:
        raise AssertionError(f"Mamba2 f32 recurrence vs prefill max |dlogit| "
                             f"{err:.3e} > {SSM_F32_ATOL}")
    if not clear.any() or not bool(same[clear].all()):
        raise AssertionError(f"Mamba2 f32 recurrence vs prefill: argmax "
                             f"differs at a clear margin: {stats['f32']}")

    # float32, the handoff: prefill over the first T tokens (the kernel's
    # final state after a ragged last chunk), then the next K through
    # decode_step, against the prefill over all T + K.
    st = prefill(p32, cfg32, {"tokens": seqs[:, :t]}, t + k,
                 cache_dtype=torch.float32)[1]["mamba"]

    def handoff_err(h, conv):
        c = {"mamba": SSMState(h.clone(), conv.clone(), st.length)}
        out = []
        for i in range(t, t + k):
            lg, c = decode_step(p32, cfg32, seqs[:, i:i + 1], c, tok(i))
            out.append(lg.float())
        return (torch.stack(out, 1) - ref[:, t:]).abs().max().item()

    conv_f32 = st.conv.to(conv_t.dtype)
    hand = {"prefix": t, "steps": k, "atol": SSM_F32_ATOL,
            "window_atol": SSM_WINDOW_ATOL,
            "h_max_rel_diff": ((st.h - h_t).abs().max()
                               / h_t.abs().max()).item(),
            "kernel_h": handoff_err(st.h, conv_t),
            "prefill_state": handoff_err(st.h, conv_f32),
            "fault_zeroed_h": handoff_err(torch.zeros_like(h_t), conv_t),
            "fault_zeroed_conv": handoff_err(st.h, torch.zeros_like(conv_t))}
    log(f"ssm-agreement f32 handoff: {json.dumps(hand)}")
    if not hand["kernel_h"] <= SSM_F32_ATOL:
        raise AssertionError(f"Mamba2 f32 decode from the kernel's final "
                             f"state errs by {hand['kernel_h']:.3e} > "
                             f"{SSM_F32_ATOL}")
    if not hand["prefill_state"] <= SSM_WINDOW_ATOL:
        raise AssertionError(f"Mamba2 f32 decode from prefill's state errs "
                             f"by {hand['prefill_state']:.3e} > "
                             f"{SSM_WINDOW_ATOL}")
    for key in ("fault_zeroed_h", "fault_zeroed_conv"):
        if not hand[key] > SSM_FAULT_FACTOR * SSM_WINDOW_ATOL:
            raise AssertionError(f"planted fault {key} errs by only "
                                 f"{hand[key]:.3e}: the check cannot see it")
    stats["f32_handoff"] = hand

    # float32, served: the same requests through ServingSystem, each
    # replayed at batch 1.
    stats["f32_served"] = f32_served_check(
        torch, cfg32, p32, reqs, SSM_AGREE_RIDS, SSM_F32_ATOL,
        SSM_WINDOW_ATOL, "Mamba2", "ssm-agreement f32 served", dev)

    # bfloat16, replaying the served requests.
    stats["bf16"] = bf16_ratio_check(torch, cfg, params, cfg32, p32, reqs,
                                     served, SSM_AGREE_RIDS, SSM_BF16_RATIO,
                                     "Mamba2", dev)
    return stats


# ---------------------------------------------------------------------------
# Zamba2-1.2B whole (serve-zamba, zamba-agreement, ssd_scan-zamba,
# cli-zamba) and the forward phase (Zamba2, InternVL2-2B, HuBERT-XLarge)
# ---------------------------------------------------------------------------


def zamba_config():
    from repro_torch.configs import get_config
    # Whole: 38 Mamba2 layers (6 groups of 6 and a tail of 2), d_model
    # 2048, 64 SSM heads of 64, N = 64; one shared block of 32 heads of 64,
    # d_ff 8192, sliding window 8192; vocab 32000, tied embeddings.
    return get_config("zamba2-1.2b")


def zamba_sizes(cfg, params, batch=8, capacity=2048) -> dict:
    """Bytes the served Zamba2 holds on the card, from its shapes: bf16
    weights, and the decode engine's f32 caches at ``batch`` slots
    (the group SSM state, the tail's, the shared K/V of every group)."""
    from repro_torch.models import build_plan

    din = cfg.d_model * cfg.ssm_expand
    h_layer = batch * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    conv_layer = batch * (cfg.ssm_conv - 1) * (din + 2 * cfg.ssm_state) * 4
    out = {"weights_bytes": sum(p.numel() * p.element_size()
                                for p in params.parameters())}
    for seg in build_plan(cfg):
        out[f"{seg.name}_state_bytes"] = seg.n_layers * (h_layer + conv_layer)
        if seg.kind == "mamba_groups":
            out["shared_kv_bytes"] = (2 * seg.n_groups * batch * capacity
                                      * cfg.num_kv_heads * cfg.head_dim * 4)
    return out


def exact_window_prefill(torch, params, cfg, batch, capacity):
    """``prefill`` with float32 conv windows: the state prefill computes,
    without the bf16 rounding the JAX package stores the windows with (its
    ``make_caches`` patched for the call)."""
    from repro_torch.models import model as model_mod

    make = model_mod.make_caches

    def f32_windows(*args, **kw):
        caches = make(*args, **kw)
        for seg in model_mod.build_plan(cfg):
            c = caches[seg.name]
            if seg.kind == "mamba_groups":
                c["ssm"]["conv"] = c["ssm"]["conv"].float()
            elif seg.kind == "mamba_tail":
                caches[seg.name] = c._replace(conv=c.conv.float())
        return caches

    model_mod.make_caches = f32_windows
    try:
        return model_mod.prefill(params, cfg, batch, capacity,
                                 cache_dtype=torch.float32)
    finally:
        model_mod.make_caches = make


def zamba_agreement_phase(torch, cfg, params, reqs, served, dev="cuda"):
    """Zamba2 decode (the recurrence and the shared block's one-token
    attention) against full-sequence prefill (the SSD kernel and the
    block's prefill attention), on the served prompts of ZAMBA_AGREE_RIDS.

    float32, the handoff: ``prefill`` over the first ZAMBA_F32_TOKENS, then
    the next ZAMBA_HANDOFF_STEPS through ``decode_step``, against a prefill
    over all of them: within ZAMBA_F32_ATOL from prefill's state with
    float32 conv windows (``exact_window_prefill``), within
    ZAMBA_WINDOW_ATOL from prefill's own state (bf16 windows, as in JAX).
    Two planted faults on the float32-window state -- group 1's shared K/V
    zeroed, groups 0 and 1 holding each other's SSM state -- must err by
    more than ZAMBA_FAULT_FACTOR x ZAMBA_F32_ATOL.

    float32, served, and bfloat16, replayed: as ssm-agreement
    (``f32_served_check``, ``bf16_ratio_check``) with ZAMBA_F32_ATOL,
    ZAMBA_WINDOW_ATOL and ZAMBA_BF16_RATIO."""
    import copy
    from repro_torch.models import decode_step, prefill
    from repro_torch.tree import tree_map

    def tok(ids):
        return dev_tokens(torch, ids, dev)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = copy.deepcopy(params).float()
    t, k = ZAMBA_F32_TOKENS, ZAMBA_HANDOFF_STEPS
    seqs = tok([reqs[rid].prompt[:t + k] for rid in ZAMBA_AGREE_RIDS])
    ref = prefill(p32, cfg32, {"tokens": seqs}, t + k,
                  cache_dtype=torch.float32)[0].float()
    head = {"tokens": seqs[:, :t]}
    own = prefill(p32, cfg32, head, t + k, cache_dtype=torch.float32)[1]
    exact = exact_window_prefill(torch, p32, cfg32, head, t + k)[1]

    def handoff_err(caches, plant=None):
        c = tree_map(lambda x: x.clone(), caches)
        if plant is not None:
            plant(c["mamba_groups"])
        out = []
        for i in range(t, t + k):
            lg, c = decode_step(p32, cfg32, seqs[:, i:i + 1], c, tok(i))
            out.append(lg.float())
        return (torch.stack(out, 1) - ref[:, t:]).abs().max().item()

    def zero_group_kv(g):
        g["shared_kv"].k[1].zero_()
        g["shared_kv"].v[1].zero_()

    def swap_group_state(g):
        for x in (g["ssm"]["h"], g["ssm"]["conv"]):
            x[[0, 1]] = x[[1, 0]]

    hand = {"prefix": t, "steps": k, "atol": ZAMBA_F32_ATOL,
            "window_atol": ZAMBA_WINDOW_ATOL,
            "f32_windows": handoff_err(exact),
            "prefill_state": handoff_err(own),
            "fault_zeroed_group_kv": handoff_err(exact, zero_group_kv),
            "fault_swapped_group_state": handoff_err(exact,
                                                     swap_group_state)}
    log(f"zamba-agreement f32 handoff: {json.dumps(hand)}")
    if not hand["f32_windows"] <= ZAMBA_F32_ATOL:
        raise AssertionError(f"Zamba2 f32 decode from prefill's state with "
                             f"f32 windows errs by {hand['f32_windows']:.3e}"
                             f" > {ZAMBA_F32_ATOL}")
    if not hand["prefill_state"] <= ZAMBA_WINDOW_ATOL:
        raise AssertionError(f"Zamba2 f32 decode from prefill's state errs "
                             f"by {hand['prefill_state']:.3e} > "
                             f"{ZAMBA_WINDOW_ATOL}")
    for key in ("fault_zeroed_group_kv", "fault_swapped_group_state"):
        if not hand[key] > ZAMBA_FAULT_FACTOR * ZAMBA_F32_ATOL:
            raise AssertionError(f"planted fault {key} errs by only "
                                 f"{hand[key]:.3e}: the check cannot see it")
    stats = {"f32_handoff": hand}
    stats["f32_served"] = f32_served_check(
        torch, cfg32, p32, reqs, ZAMBA_AGREE_RIDS, ZAMBA_F32_ATOL,
        ZAMBA_WINDOW_ATOL, "Zamba2", "zamba-agreement f32 served", dev)
    stats["bf16"] = bf16_ratio_check(
        torch, cfg, params, cfg32, p32, reqs, served, ZAMBA_AGREE_RIDS,
        ZAMBA_BF16_RATIO, "Zamba2", dev)
    return stats


def cli_zamba_phase(torch, dev="cuda"):
    """The CLI at ``--arch zamba2-1.2b`` (its smoke variant) in this
    process, on the card: every request must finish with nothing reused
    (a hybrid has no token-sliceable cache), and the SSD-scan kernel must
    launch once per Mamba layer of every prefill, no other kernel."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config("zamba2-1.2b"))
    argv = ["--arch", "zamba2-1.2b", "--decode-chunk", "4", "--device", dev]
    text, counts, wall, rows = run_cli(argv)
    n_req = len(rows)
    if f"completed={n_req}," not in text or n_req != 6:
        raise AssertionError(f"cli-zamba: not every request finished:\n"
                             f"{text}")
    if any(int(r[1]) for r in rows):
        raise AssertionError(f"cli-zamba reused a prefix: {rows}")
    if counts["ssd_scan"] != n_req * cfg.num_layers or any(
            counts[k] for k in KERNEL_MODULES if k != "ssd_scan"):
        raise AssertionError(f"cli-zamba launches {counts} != ssd_scan "
                             f"{n_req} prefills x {cfg.num_layers} layers")
    return {"argv": argv, "wall_s": wall, "requests": n_req,
            "tokens": sum(len(r[4].split(",")) for r in rows),
            "kernel_launches": counts,
            "lines": [ln for ln in text.splitlines()
                      if ln.startswith(("SLO summary", "transfer:"))]}


def forward_row(torch, name, logits, ref=None):
    """What a forward phase reports of ``logits`` (finite, and its largest
    difference from ``ref`` when given)."""
    row = {"model": name, "shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all())}
    if not row["finite"]:
        raise AssertionError(f"forward {name}: non-finite logits")
    if ref is not None:
        row["max_abs_vs_prefill"] = (logits.float() - ref.float()).abs(
            ).max().item()
    return row


def forward_zamba(torch, cfg, params, prompt, dev="cuda"):
    """``forward`` over one served prompt, against ``prefill``'s logits
    (the same code path without the cache writes: bit-equal)."""
    from repro_torch.models import forward, prefill

    batch = {"tokens": dev_tokens(torch, [prompt], dev)}
    t0 = time.perf_counter()
    logits, aux = forward(params, cfg, batch)
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = prefill(params, cfg, batch, len(prompt))[0]
    row = {**forward_row(torch, cfg.name, logits, ref), "tokens": len(prompt),
           "forward_s": wall, "aux_loss": float(aux["aux_loss"])}
    if row["max_abs_vs_prefill"] != 0:
        raise AssertionError(f"Zamba2 forward differs from prefill: {row}")
    return row


def forward_vlm(torch, dev="cuda"):
    """InternVL2-2B whole: ``forward`` over VLM prefix embeddings + tokens
    against ``prefill`` (bit-equal), then VLM_DECODE_STEPS greedy
    ``decode_step``s, each step's logits within DENSE_AGREE_ATOL of a
    ``forward`` over the longer sequence."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, prefill

    cfg = get_config("internvl2-2b")
    params = init_model(torch, cfg, "vlm")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = cfg.num_prefix_embeddings
    prefix = torch.randn(1, p, cfg.d_model, device=dev, generator=gen
                         ).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, VLM_TOKENS), device=dev,
                         generator=gen, dtype=torch.int32)
    batch = {"prefix_emb": prefix, "tokens": toks}
    s = p + VLM_TOKENS
    logits = forward(params, cfg, batch)[0]
    ref, caches = prefill(params, cfg, batch, s + VLM_DECODE_STEPS)
    row = {**forward_row(torch, cfg.name, logits, ref),
           "parameters": sum(x.numel() for x in params.parameters()),
           "prefix_embeddings": p, "tokens": VLM_TOKENS}
    if row["max_abs_vs_prefill"] != 0:
        raise AssertionError(f"InternVL2 forward differs from prefill: {row}")
    nxt = ref[:, -1].argmax(-1).to(torch.int32)
    gen_toks, steps = [], []
    for i in range(VLM_DECODE_STEPS):
        gen_toks.append(int(nxt))
        lg, caches = decode_step(params, cfg, nxt[:, None], caches,
                                 dev_tokens(torch, s + i, dev))
        steps.append(lg[0].float())
        nxt = lg.argmax(-1).to(torch.int32)
    longer = forward(params, cfg, {"prefix_emb": prefix, "tokens": torch.cat(
        [toks, dev_tokens(torch, [gen_toks], dev)], 1)})[0][0, s:].float()
    row["decode_steps"] = VLM_DECODE_STEPS
    row["decode_vs_forward"] = (torch.stack(steps) - longer).abs().max(
        ).item()
    row["atol"] = DENSE_AGREE_ATOL
    del params, caches
    free_model(torch)
    if not row["decode_vs_forward"] <= DENSE_AGREE_ATOL:
        raise AssertionError(f"InternVL2 decode vs forward: {row}")
    return row


def forward_audio(torch, dev="cuda"):
    """HuBERT-XLarge whole, encoder-only: ``forward`` over AUDIO_FRAMES
    frame embeddings; finite logits over its 504 targets."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward

    cfg = get_config("hubert-xlarge")
    params = init_model(torch, cfg, "audio")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randn(1, AUDIO_FRAMES, cfg.d_model, device=dev,
                         generator=gen).to(torch.bfloat16)
    logits = forward(params, cfg, {"frames": frames})[0]
    row = {**forward_row(torch, cfg.name, logits),
           "parameters": sum(x.numel() for x in params.parameters()),
           "frames": AUDIO_FRAMES}
    if row["shape"] != [1, AUDIO_FRAMES, cfg.vocab_size]:
        raise AssertionError(f"HuBERT logits of shape {row['shape']}")
    del params
    free_model(torch)
    return row


def train_ssm_phase(torch, cfg, params, dev="cuda"):
    """Mamba2 trained through ``repro_torch.train.train`` for TRAIN_STEPS
    steps (``OptConfig(total_steps=TRAIN_STEPS, warmup_steps=1)``) on
    ``make_batch_iter(vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)``, in place,
    with every kernel count set to 0 just before and read just after. Every
    loss and gradient norm must be finite, the last step's loss below the
    first's, and the SSD scan must launch once a layer of every forward
    (the backward launches none), no other kernel. Each step's loss,
    gradient norm and learning rate, its wall time (each step ends in the
    host read of its metrics), tokens/s at the median step, peak memory."""
    import math

    from repro_torch.data import make_batch_iter
    from repro_torch.train import OptConfig, train

    batches = make_batch_iter(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                              seed=SEED)
    starts, ends = [], []

    def timed_batches():
        while True:
            ends.append(time.perf_counter())   # the previous step has synced
            batch = next(batches)
            starts.append(time.perf_counter())
            yield batch

    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, history = train(params, cfg, timed_batches(), TRAIN_STEPS,
                            OptConfig(total_steps=TRAIN_STEPS,
                                      warmup_steps=1),
                            log_every=1, device=dev)
    ends.append(time.perf_counter())
    counts = read_counts()
    step_s = [e - s for s, e in zip(starts, ends[1:])]
    losses = [r["loss"] for r in history]
    gnorms = [r["grad_norm"] for r in history]
    if len(history) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"train-ssm: a loss or gradient norm is not "
                             f"finite: {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-ssm: loss did not fall: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    if counts["ssd_scan"] != want or any(
            counts[k] for k in KERNEL_MODULES if k != "ssd_scan"):
        raise AssertionError(f"train-ssm launched {counts}, not {want} SSD "
                             "scans alone")
    p50 = statistics.median(step_s)
    summary = {
        "steps": [{key: r[key] for key in ("step", "loss", "nll",
                                           "grad_norm", "lr")}
                  for r in history],
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "step_s": step_s,
        "step_p50_s": p50, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / p50,
        "kernel_launches": counts,
        "ssd_scan_per_forward": counts["ssd_scan"] / TRAIN_STEPS,
        "ssd_scan_per_backward": 0,
    }
    if dev == "cuda":
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return params, summary, counts


def ssd_grad_rows(torch, flush, dev="cuda"):
    """The SSD Function (``ops.ssd_scan_autograd``) at SSD_GRAD_CASES:
    its outputs (the kernel's) against the plain ``ssd_chunked`` within
    SSD_TOL, and its gradients for x, dt, a_log, B and C, from seeded
    upstream gradients of y and h_final, against autograd through the
    plain ``ssd_chunked`` on the same inputs, each within SSD_GRAD_TOL of
    its largest |g|. Median CUDA-event times of the Function's backward
    (which recomputes the plain stages) and of autograd's backward over a
    kept plain graph. Also: the raw wrapper refuses an input that requires
    grad, so a gradient cannot be dropped silently."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, b, s, h, p, n in SSD_GRAD_CASES:
        q = 128
        args = ssd_inputs(torch, gen, b, s, h, p, n, dev)
        g_out = (torch.randn(b, s, h, p, device=dev, generator=gen),
                 torch.randn(b, h, p, n, device=dev, generator=gen))

        def leaves():
            return [a.detach().clone().requires_grad_(True) for a in args]

        fn_in, ref_in = leaves(), leaves()
        y, hf = ops.ssd_scan_autograd(*fn_in, q)
        yr, hr = ssd_chunked(*ref_in, q)
        grads = torch.autograd.grad((y, hf), fn_in, g_out,
                                    retain_graph=True)
        ref = torch.autograd.grad((yr, hr), ref_in, g_out, retain_graph=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        for got, want in ((y, yr), (hf, hr)):
            if not torch.allclose(got, want, rtol=SSD_TOL,
                                  atol=SSD_ATOL_REL * want.abs().max().item()):
                raise AssertionError(f"train-ssd-grad {name}: the Function's "
                                     "forward disagrees with ssd_chunked")
        rel = {}
        for nm, g, r in zip(SSD_GRAD_NAMES, grads, ref):
            scale = r.abs().max().item()
            rel[nm] = (g - r).abs().max().item() / max(scale, 1e-30)
            if not (torch.isfinite(g).all() and rel[nm] <= SSD_GRAD_TOL):
                raise AssertionError(f"train-ssd-grad {name}: d{nm} off by "
                                     f"{rel[nm]:.3e} of max |g| {scale:.3e}")
        row = {"case": name, "B": b, "S": s, "H": h, "P": p, "N": n, "Q": q,
               "max_rel_err": rel,
               "max_abs_err_y": (y - yr).abs().max().item()}
        if dev == "cuda":
            row["backward_ms"] = timed_ms(torch, lambda: torch.autograd.grad(
                (y, hf), fn_in, g_out, retain_graph=True), 10, flush)
            row["plain_backward_ms"] = timed_ms(
                torch, lambda: torch.autograd.grad(
                    (yr, hr), ref_in, g_out, retain_graph=True), 10, flush)
            with torch.no_grad():
                row["forward_ms"] = timed_ms(
                    torch, lambda: ops.ssd_scan(*args, chunk=q), 10, flush)
        log("train-ssd-grad:", json.dumps(row))
        rows.append(row)
        del y, hf, yr, hr, grads, ref
    try:
        ops.ssd_scan(args[0].detach().clone().requires_grad_(True),
                     *args[1:], chunk=128)
    except RuntimeError:
        pass
    else:
        raise AssertionError("the raw ssd_scan wrapper accepted an input "
                             "that requires grad")
    return rows


def _bits(torch, t):
    return t.contiguous().view(torch.uint8)


def ckpt_phase(torch, cfg, params, dev="cuda"):
    """The trained model saved with ``save_checkpoint`` (bf16 leaves as raw
    ``<V2``), loaded into a fresh ``Model`` with ``load_checkpoint``: every
    leaf bit-equal, and ``lm_loss`` on the batch after the training ones
    equal on both models (counts set to 0 just before the two forwards and
    read just after). Shards, bytes and seconds."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.convert import param_tree
    from repro_torch.data import make_batch_iter
    from repro_torch.models import lm_loss
    from repro_torch.tree import tree_leaves

    root = HERE / "build" / "ckpt"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as d:
        t0 = time.perf_counter()
        manifest = save_checkpoint(d, params, TRAIN_STEPS,
                                   meta={"arch": cfg.name}, device=dev)
        t1 = time.perf_counter()
        nbytes = sum(f.stat().st_size for f in Path(d).iterdir())
        loaded, step = load_checkpoint(d, cfg, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    ours, theirs = (tree_leaves(param_tree(m)) for m in (params, loaded))
    if step != TRAIN_STEPS or len(ours) != len(theirs) or not all(
            a.dtype == b.dtype and torch.equal(_bits(torch, a),
                                               _bits(torch, b))
            for a, b in zip(ours, theirs)):
        raise AssertionError("ckpt: a loaded leaf differs from the saved one")
    del ours, theirs
    batches = make_batch_iter(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                              seed=SEED)
    for _ in range(TRAIN_STEPS):
        next(batches)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(batches).items()}
    reset_counts()
    with torch.no_grad():
        losses = [lm_loss(m, cfg, batch)[0].item() for m in (params, loaded)]
    counts = read_counts()
    if losses[0] != losses[1]:
        raise AssertionError(f"ckpt: loss {losses[1]} after loading, "
                             f"{losses[0]} before")
    del loaded
    return {"shards": len(manifest["shards"]),
            "leaves": manifest["n_leaves"], "bytes": nbytes,
            "save_s": t1 - t0, "load_s": t2 - t1,
            "loss_next_batch": losses, "kernel_launches": counts}, counts


def serve_faults_phase(torch, cfg, params, reqs, base_tokens, dev="cuda"):
    """The serve traffic through ``ServingSystem(decode_engines=2,
    decode_batch=FAULT_DECODE_BATCH, autoscale=True, min_engines=1,
    max_engines=3)`` with a seeded fault
    plan (one engine crash inside FAULT_HORIZON_S, a timeout of the first
    KV transfer), every kernel count set to 0 just before and read just
    after. A crash must fire, a crashed request must be recovered by replay
    re-prefill, the autoscaler must grow or shrink the pool, no kernel may
    launch (GQA), every request must finish, and its tokens must hold
    against a prefill and against ``base_tokens`` (serve-dense's) as
    ``hold_fault_tokens`` says. Wall-clock TTFT/TPOT p50 (a recovered
    request's TPOT includes its recovery), decode step p50 (one engine's
    chunk), decode tokens/s, the fault and scale counts and peak
    memory."""
    from repro_torch.serving import (FaultInjector, FaultPlan,
                                     ServingSystem)

    plan = (FaultPlan.random(FAULT_SEED, n_engines=2,
                             horizon_s=FAULT_HORIZON_S, n_transfer_faults=0,
                             n_stragglers=0)
            + FaultPlan.parse('[{"kind": "transfer_timeout", "count": 1}]'))
    system = ServingSystem(params, cfg, n_prefill=1,
                           decode_batch=FAULT_DECODE_BATCH,
                           capacity=2048, decode_engines=2, autoscale=True,
                           min_engines=1, max_engines=3,
                           fault_injector=FaultInjector(plan, seed=FAULT_SEED),
                           device=dev)
    first_token, steps = {}, []
    pre, pool = system.prefills[0], system.pool
    run0, step0 = pre.run, pool.step_engine

    def run(req):
        out = run0(req)
        first_token.setdefault(req.rid, time.perf_counter())
        return out

    def step_engine(*a, **kw):
        t0 = time.perf_counter()
        finished, log_ = step0(*a, **kw)
        steps.append((t0, time.perf_counter(), [r.rid for r in finished]))
        return finished, log_

    pre.run, pool.step_engine = run, step_engine
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    try:
        results = system.serve(reqs)
    finally:
        t_end = time.perf_counter()
        counts = read_counts()
        del pre.run, pool.step_engine
    sched = system.scheduler
    s = sched.summary()
    done = sorted((r for r in results if not r.shed), key=lambda r: r.rid)
    held = hold_fault_tokens(torch, cfg, params, reqs, done, base_tokens,
                             dev)
    finish = {rid: t1 for _, t1, rids in steps for rid in rids}
    max_new = reqs[0].max_new_tokens
    ttft = [first_token[r.rid] - t_start for r in done]
    tpot = [(finish[r.rid] - first_token[r.rid]) / (max_new - 1)
            for r in done]
    summary = {
        "requests": len(reqs), "completed": len(done),
        "shed": len(results) - len(done),
        "crashes_fired": system.faults.crashes_fired,
        "timeouts_injected": system.faults.timeouts_injected,
        "recoveries": s["recoveries"],
        "tokens_replayed": sum(t.tokens_replayed
                               for t in sched.traces.values()),
        "scale_events": [{k: e[k] for k in ("t", "action", "engine")}
                         for e in sched.scale_events],
        "engine_count_timeline": sched.engine_count_timeline,
        "plan": json.loads(plan.to_json())["events"],
        "tokens_equal_serve_dense": sum(r.tokens == base_tokens[r.rid]
                                        for r in done),
        **held,
        "kernel_launches": counts,
        "ttft_p50_s": statistics.median(ttft),
        "tpot_p50_s": statistics.median(tpot),
        "decode_step_p50_s": statistics.median(t1 - t0
                                               for t0, t1, _ in steps),
        "decode_tokens_per_s": sum(len(r.tokens) - 1 for r in done)
        / (steps[-1][1] - steps[0][0]),
        "serve_wall_s": t_end - t_start,
    }
    if dev == "cuda":
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return summary


def hold_fault_tokens(torch, cfg, params, reqs, done, base_tokens, dev):
    """The token checks of serve-faults (see FAULT_DECODE_BATCH): each
    completed request's served tokens against a batch-1 ``prefill`` over
    prompt + served tokens, and its first parting from ``base_tokens``.
    Returns the counts and every margin that breaks a rule (the gates)."""
    prompts = {r.rid: list(r.prompt) for r in reqs}
    out = {"tokens_checked": 0, "first_parting": {}, "clear_margin_faults": []}
    for r in done:
        ref = whole_logits(torch, params, cfg, prompts[r.rid], list(r.tokens),
                           dev)
        top2 = ref.topk(2, dim=-1)
        gap = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        best = top2.indices[:, 0].tolist()
        del ref, top2
        for i, (g, b) in enumerate(zip(gap, best)):
            if g > DENSE_MARGIN:
                out["tokens_checked"] += 1
                if r.tokens[i] != b:
                    out["clear_margin_faults"].append(
                        {"rid": r.rid, "position": i, "served": r.tokens[i],
                         "prefill_argmax": b, "margin": g})
        base = base_tokens[r.rid]
        i = next((i for i, (a, b) in enumerate(zip(r.tokens, base))
                  if a != b), None)
        if i is not None:
            out["first_parting"][r.rid] = {"position": i, "margin": gap[i]}
            if gap[i] > DENSE_MARGIN:
                out["clear_margin_faults"].append(
                    {"rid": r.rid, "position": i, "served": r.tokens[i],
                     "serve_dense": base[i], "margin": gap[i]})
    return out


def check_serve_faults(summary) -> None:
    """The gates of serve-faults (see ``serve_faults_phase``)."""
    if summary["crashes_fired"] < 1 or summary["recoveries"] < 1:
        raise AssertionError(f"serve-faults: no crash recovered by replay: "
                             f"{summary}")
    if not any(e["action"] in ("grow", "shrink")
               for e in summary["scale_events"]):
        raise AssertionError(f"serve-faults: the autoscaler logged no "
                             f"grow or shrink: {summary}")
    if any(summary["kernel_launches"].values()):
        raise AssertionError(f"serve-faults: a GQA serve launched a kernel: "
                             f"{summary['kernel_launches']}")
    if summary["completed"] != summary["requests"] \
            or summary["tokens_checked"] < 1:
        raise AssertionError(f"serve-faults: a request did not finish or no "
                             f"token had a margin to check: {summary}")
    if summary["clear_margin_faults"]:
        raise AssertionError(f"serve-faults: a token disagrees at a clear "
                             f"margin: {summary['clear_margin_faults']}")


# ---------------------------------------------------------------------------
# The parallel layer over a 1 x 1 mesh: hybrid-prefill, serve-hybrid (R1),
# kimi-lep-agree, serve-kimi, serve-kimi-tokens (Kimi K2)
# ---------------------------------------------------------------------------


def one_rank_mesh(torch, dev="cuda"):
    """A one-rank process group (NCCL on the card, gloo on the CPU; file
    rendezvous in a fresh temporary directory) and the 1 x 1
    ``("data", "model")`` mesh over it. Every collective on it is on an
    axis of one rank, so none is issued."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    path = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "rendezvous"
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"file://{path}", rank=0,
                            world_size=1)
    return make_debug_mesh(1, 1, dev)


def sharded_step_phase(torch, params, mesh, cases, dev="cuda") -> list:
    """The dry run's sharded steps ``cases`` on real tensors over the 1 x 1
    NCCL mesh (of ``launch/sharded_step.py``'s: ``decode-r1``, then
    ``prefill-r1-a2a`` -- R1's prefill with every MLA layer through the
    §4.3.1 hybrid --, ``train-mamba2``, ``prefill-mamba2`` and
    ``train-r1`` at SHARDED_TRAIN_SHAPE, the last at SHARDED_LAYERS'
    depth), each through ``dryrun.build_step`` on the card
    with its weights drawn from SEED and placed one at a time: the
    kernels' launches on the DTensor path (counts set to 0 just before the
    step and read just after: MLA once and dispatch-quantize once a layer
    of theirs, 48 SSD scans), the collective bytes the counter sees (0,
    equal to the dry run's 1 x 1 record of the same case, traced in a
    process of its own while the steps run), and the step against the same
    step unsharded on the card (``sharded_step.compare``: decode and
    prefill within SHARDED_DECODE_TOL, the hybrid against the plain
    prefill; the train step at its tolerances). R1's sharded weights must
    equal the serve's ``params`` bit for bit, which are its reference's;
    the hybrid case's step raises unless each of its 4 MLA layers entered
    the hybrid (``dryrun.hybrid_prefill``). Returns one row per case."""
    from repro_torch.launch import sharded_step as ss

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def peak_gib():
        """The peak allocated GiB since the last call (0 off the card)."""
        if dev != "cuda":
            return 0.0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return peak

    b, s = SHARDED_TRAIN_SHAPE
    records = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sharded_step", "--cases",
         ",".join(cases), "--mesh", "1x1",
         *(f"--shape={name}={b}x{s}" for name in SHARDED_REDUCED
           if name in cases),
         *(f"--layers={name}={n}" for name, n in SHARDED_LAYERS.items()
           if name in cases)], cwd=HERE,
        env={**os.environ, "PYTHONPATH": str(SRC)}, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    rows = []
    try:
        for name in cases:
            shape = ss.case_shape(name, batch=b, seq_len=s) \
                if name in SHARDED_REDUCED else None
            cfg = ss.case_config(name, layers=SHARDED_LAYERS.get(name))
            peak_gib()
            t0 = time.perf_counter()
            _, shape, step, args = ss.case_step(name, mesh, dev, seed=SEED,
                                                shape=shape, cfg=cfg)
            sync()
            build_s = time.perf_counter() - t0
            row = {"case": name, "mesh": "1x1", "B": shape.global_batch,
                   "S": shape.seq_len}
            if name in SHARDED_SERVE_WEIGHTS:
                row["weights_equal_serve"] = all(
                    torch.equal(w.to_local(), p) for w, p in
                    zip(args[0].parameters(), params.parameters()))
            reset_counts()
            t0 = time.perf_counter()
            out, counts = ss.run_counted(step, args)
            sync()
            step_s = time.perf_counter() - t0
            row["kernel_launches"] = read_counts()
            row["peak_gib"] = peak_gib()
            got = ss.step_results(shape.kind, out)
            del out, step, args
            free_model(torch)
            t0 = time.perf_counter()
            want = ss.reference(name, dev, seed=SEED, shape=shape,
                                params=params if name in
                                SHARDED_SERVE_WEIGHTS else None, cfg=cfg)
            sync()
            row.update(ss.compare(shape.kind, got, want, SHARDED_DECODE_TOL))
            row.update(counter_bytes=ss.bytes_by_kind(counts),
                       counter_count=counts["count"], build_s=build_s,
                       step_s=step_s,
                       reference_s=time.perf_counter() - t0,
                       reference_peak_gib=peak_gib())
            del want, got
            free_model(torch)
            rows.append(row)
        stdout, err = records.communicate(timeout=DRYRUN_TIMEOUT_S)
        if records.returncode:
            raise AssertionError(f"sharded-step records: {err[-3000:]}")
        recs = json.loads(stdout.strip().splitlines()[-1])
    finally:
        if records.poll() is None:
            records.kill()
            records.wait()
    for row in rows:
        row["record_bytes"] = ss.bytes_by_kind(recs[row["case"]])
        need = SHARDED_LAUNCHES[row["case"]]
        if not (row["ok"] and row.get("weights_equal_serve", True)
                and row["counter_bytes"] == row["record_bytes"]
                and not any(row["counter_bytes"].values())
                and not row["counter_count"]
                and all(row["kernel_launches"][k] == n
                        for k, n in need.items())):
            raise AssertionError(f"sharded-step {row['case']}: {row}")
    return rows


@contextlib.contextmanager
def hybrid_mode(mesh, mode):
    """Within the block ``REPRO_MLA_HYBRID`` is ``mode`` ("" for the plain
    prefill) and ``mesh`` is current; yields a list that holds, after the
    block, the o-proj mode of each MLA layer run through
    ``mla_prefill_hybrid`` (``hybrid_parallel.CALLS``)."""
    import os
    from repro_torch.core import hybrid_parallel
    from repro_torch.core.parallel import mesh_context

    calls, before = [], dict(hybrid_parallel.CALLS)
    os.environ["REPRO_MLA_HYBRID"] = mode
    try:
        with mesh_context(mesh):
            yield calls
    finally:
        os.environ.pop("REPRO_MLA_HYBRID", None)
        for m, n in hybrid_parallel.CALLS.items():
            calls += [m] * (n - before[m])


def hybrid_prefill_phase(torch, cfg, params, mesh, dev="cuda"):
    """The serve traffic's 8 prompts prefilled plain, then with
    ``REPRO_MLA_HYBRID`` = a2a and rs over ``mesh`` (the §4.3.1 SP -> TP ->
    SP MLA prefill on every MLA layer): each hybrid form's logits within
    AGREE_ATOL of the plain prefill's, every layer through the hybrid,
    no kernel launched (the prefill's MLA is plain PyTorch)."""
    from repro_torch.models import prefill

    out = {"atol": AGREE_ATOL, "prompts": 0, "hybrid_layer_calls": 0}
    times = {"plain": [], "a2a": [], "rs": []}
    reset_counts()
    for req in serve_requests(cfg):
        toks = {"tokens": dev_tokens(torch, [req.prompt], dev)}
        logits = {}
        for mode in times:
            with hybrid_mode(mesh, "" if mode == "plain" else mode) as calls:
                t0 = time.perf_counter()
                lg, _ = prefill(params, cfg, toks, len(req.prompt))
                if dev == "cuda":
                    torch.cuda.synchronize()
                times[mode].append(time.perf_counter() - t0)
            if calls != ([] if mode == "plain" else [mode] * cfg.num_layers):
                raise AssertionError(f"hybrid-prefill {mode}: hybrid calls "
                                     f"{calls}")
            out["hybrid_layer_calls"] += len(calls)
            logits[mode] = lg[0].float()
            del lg
        for mode in ("a2a", "rs"):
            err = (logits[mode] - logits["plain"]).abs().max().item()
            key = f"max_abs_logit_err_{mode}"
            out[key] = max(out.get(key, 0.0), err)
            if not err <= AGREE_ATOL:
                raise AssertionError(f"hybrid-prefill {mode}: rid {req.rid} "
                                     f"logits {err:.4f} from the plain "
                                     "prefill")
        out["prompts"] += 1
        del logits
    out["kernel_launches"] = read_counts()
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"hybrid-prefill launched a kernel: {out}")
    for mode, ts in times.items():
        out[f"prefill_p50_s_{mode}"] = statistics.median(ts)
    return out


def hold_partings(torch, cfg, params, reqs, tokens, base_tokens, what,
                  dev="cuda"):
    """``tokens`` held against ``base_tokens`` by margins: where a request's
    tokens first part from the base's, the top-two margin of a prefill
    over prompt + served tokens must be within DENSE_MARGIN
    (``hold_fault_tokens``). Served tokens that are not that prefill's
    argmax at a clear margin are counted, not gated: the prefill's
    ``moe_capacity`` drops other tokens than a serve's prefill and decode
    steps do."""
    import types

    done = [types.SimpleNamespace(rid=rid, tokens=toks)
            for rid, toks in sorted(tokens.items())]
    held = hold_fault_tokens(torch, cfg, params, reqs, done, base_tokens, dev)
    faults = held.pop("clear_margin_faults")
    partings = [f for f in faults if "serve_dense" in f]
    if partings:
        raise AssertionError(f"{what}: tokens part from the base serve's at "
                             f"a clear margin: {partings}")
    held["prefill_argmax_disagreements"] = len(faults)
    held["tokens_equal_base"] = sum(tokens[r] == base_tokens[r]
                                    for r in tokens)
    return held


def serve_hybrid_phase(torch, cfg, params, mesh, base_tokens, dev="cuda"):
    """The R1 serve with ``REPRO_MLA_HYBRID=a2a`` over ``mesh``: every
    prefill's MLA layers through the hybrid, the MLA kernel decode steps x
    4 times (``serve_phase``'s gate); tokens held against the serve
    phase's by margins (``hold_partings``)."""
    reqs = serve_requests(cfg)
    with hybrid_mode(mesh, "a2a") as calls:
        summary, counts, _, tokens = serve_phase(torch, cfg, params, dev=dev,
                                                 reqs=reqs)
    if calls != ["a2a"] * (len(reqs) * cfg.num_layers):
        raise AssertionError(f"serve-hybrid: {len(calls)} hybrid layers for "
                             f"{len(reqs)} prefills")
    summary["hybrid_layer_calls"] = len(calls)
    summary.update(hold_partings(torch, cfg, params, reqs, tokens,
                                 base_tokens, "serve-hybrid", dev))
    return summary, counts


def kimi_config():
    from repro_torch.configs import get_config
    # Widths whole (d_model 7168, 64 heads over 8 KV heads of 128, 384
    # experts top-8 of d_ff 2048, 1 shared expert, vocab 163840); depth cut
    # to first_k_dense 1 + 1 MoE layer: 19.615 B parameters, 39.2 GB bf16.
    return dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                               name="kimi-k2-2layer", num_layers=2,
                               first_k_dense=1, dtype="bfloat16")


def kimi_plans():
    """The production plan (``pick_lep_plan`` at 16 x 16, serving) and the
    decode-optimized token gather with its second hop quantized."""
    from repro_torch.configs import get_config
    from repro_torch.core.lep import pick_lep_plan
    from repro_torch.launch.mesh import PRODUCTION_SHAPE

    # The plan of the whole model (61 layers), which the cut serves.
    prod = pick_lep_plan(get_config("kimi-k2-1t-a32b"), PRODUCTION_SHAPE,
                         serving=True)
    if prod != dict(ep_axes=("model",), redundancy=1, ffn_shard_axis="data"):
        raise AssertionError(f"Kimi K2's production plan is {prod}")
    return prod, dict(prod, ffn_gather="tokens", quantize_gather=True)


def moe_inputs(torch, cfg, params, dev="cuda"):
    """The MoE layer's inputs (normed hidden states) of one prefill of the
    longest serve prompt and of one 8-row decode step after a prefill of
    the 8 prompts' first 64 tokens."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.moe import moe_capacity

    got = []

    def recording(p, x, c):
        got.append(x.detach().clone())
        return moe_capacity(p, x, c)

    reqs = serve_requests(cfg)
    longest = max(reqs, key=lambda r: len(r.prompt))
    with torch.no_grad():
        prefill(params, cfg, {"tokens": dev_tokens(torch, [longest.prompt],
                                                   dev)},
                len(longest.prompt), recording)
        heads = [r.prompt[:64] for r in reqs]
        _, caches = prefill(params, cfg, {"tokens": dev_tokens(torch, heads,
                                                               dev)},
                            128, recording)
        decode_step(params, cfg, dev_tokens(torch, [[r.prompt[64]]
                                                    for r in reqs], dev),
                    caches, dev_tokens(torch, [64] * len(reqs), dev),
                    recording)
    return {"prefill": got[0], "decode": got[-1]}


def kimi_lep_agree_phase(torch, cfg, params, mesh, dev="cuda"):
    """At Kimi K2's MoE layer on captured inputs (S = 1019 and an 8-row
    decode step): the production plan over ``mesh`` bit-equal (outputs and
    dropped) to the 1-D LEP at world size 1; the quantized token gather
    within QUANT_REL_TOL of ``moe_capacity`` relative to its largest value;
    the dispatch buffers' shapes; event times of each form."""
    from repro_torch.core.lep import lep_capacity, make_lep_moe_fn
    from repro_torch.models.moe import moe_capacity

    prod, tok = kimi_plans()
    fns = {"lep_1d": make_lep_moe_fn(),
           "production": make_lep_moe_fn(mesh=mesh, **prod),
           "tokens_quantized": make_lep_moe_fn(mesh=mesh, **tok),
           "moe_capacity": moe_capacity}
    p = params.segments["moe"][0].moe
    out = {"production_plan": prod}
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for name, x in moe_inputs(torch, cfg, params, dev).items():
        t = x.shape[0]
        cap = lep_capacity(t, cfg.num_experts_per_tok, cfg.num_experts,
                           cfg.capacity_factor)
        res, ms = {}, {}
        for key, fn in fns.items():
            reset_counts()
            res[key] = fn(p, x, cfg)
            launches = read_counts()["dispatch_quant"]
            if dev == "cuda":
                ms[key] = timed_ms(torch, lambda: fn(p, x, cfg), 3, flush)
            res[key] += (launches,)
        (a, aux_a, n_a), (b, aux_b, n_b) = res["lep_1d"], res["production"]
        if not (torch.equal(a, b) and int(aux_a["dropped"])
                == int(aux_b["dropped"])):
            raise AssertionError(f"kimi-lep-agree {name}: the production "
                                 f"plan differs from the 1-D LEP: max "
                                 f"{(a.float() - b.float()).abs().max()}")
        ref = res["moe_capacity"][0].float()
        rel = ((res["tokens_quantized"][0].float() - ref).abs().max()
               / ref.abs().max()).item()
        if not rel <= QUANT_REL_TOL:
            raise AssertionError(f"kimi-lep-agree {name}: the token gather "
                                 f"is {rel:.4f} from moe_capacity")
        want = {"lep_1d": 1, "production": 1, "tokens_quantized": 2,
                "moe_capacity": 0}
        got = {k: v[-1] for k, v in res.items()}
        if got != want:
            raise AssertionError(f"kimi-lep-agree {name}: dispatch-quantize "
                                 f"launches {got}, want {want}")
        out[name] = {
            "tokens": t, "capacity": cap,
            "dispatch_buffer": [cfg.num_experts * cap, cfg.d_model],
            "dropped": int(aux_a["dropped"]),
            "production_bit_equal_1d": True,
            "tokens_quantized_rel_err_vs_capacity": rel,
            "dispatch_quant_launches": got,
            "ms": ms}
    return out


def serve_kimi_phase(torch, cfg, params, plan, mesh, quant_per_call,
                     base_tokens=None, dev="cuda"):
    """The serve traffic through Kimi K2's cut with ``moe_fn`` = LEP over
    ``mesh`` under ``plan``: every request finishes, the dispatch-quantize
    kernel launches ``quant_per_call`` times per MoE call; decode step p50
    beside the experts' byte bound (every expert read every step); with
    ``base_tokens`` (serve-kimi's), the tokens held against them by
    margins (``hold_partings``). The experts are cut to the rank's share
    first (``keep_local_experts``), as a serve across cards holds them: on
    the one-rank mesh that cut must keep every weight as it was."""
    from repro_torch.core.lep import keep_local_experts, make_lep_moe_fn
    from repro_torch.models.moe import MoE

    def expert_weights():
        return [w for layer in params.modules() if isinstance(layer, MoE)
                for w in (layer.w_gate, layer.w_up, layer.w_down)]

    experts = expert_weights()
    keep_local_experts(params, mesh=mesh, **plan)
    held = expert_weights()
    if len(held) != len(experts) or any(a is not b
                                        for a, b in zip(held, experts)):
        raise AssertionError("keep_local_experts replaced an expert weight "
                             "on a one-rank mesh")
    lep = make_lep_moe_fn(mesh=mesh, **plan)
    summary, counts = serve_lep_phase(torch, cfg, params, None, dev, lep=lep,
                                      quant_per_call=quant_per_call)
    expert_bytes = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 2 \
        * (cfg.num_layers - cfg.first_k_dense)
    summary["expert_bytes_held"] = sum(w.numel() * w.element_size()
                                       for w in held)
    summary["expert_bytes_per_step"] = expert_bytes
    summary["decode_step_bound_ms"] = 1e3 * expert_bytes / HBM_BYTES_PER_S
    if base_tokens is not None:
        summary.update(hold_partings(torch, cfg, params, serve_requests(cfg),
                                     summary.pop("tokens"), base_tokens,
                                     "serve-kimi-tokens", dev))
    return summary, counts


# ---------------------------------------------------------------------------
# dryrun: the port's dry run on production meshes, and 1 x 1 records of the
# serves' decode steps held against what the serves allocated
# ---------------------------------------------------------------------------


def step_args_bytes(torch, *trees) -> int:
    """Bytes of every distinct storage among the tensors of ``trees`` (a
    model's parameters, cache trees, tensors), leaving out the caches'
    ``length`` leaves: bookkeeping that a decode step does not read (it
    takes ``cache_len``), as a dry-run record leaves them out."""
    seen = {}

    def walk(node):
        if isinstance(node, torch.nn.Module):
            node = list(node.parameters())
        if isinstance(node, dict):
            node = [v for k, v in node.items() if k != "length"]
        elif hasattr(node, "_fields"):
            node = [getattr(node, k) for k in node._fields if k != "length"]
        if isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        elif isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    for tree in trees:
        walk(tree)
    return sum(seen.values())


def engine_step_bytes(torch, params, engine) -> int:
    """The bytes a decode engine's step takes as its arguments: the
    weights, its caches' buffers and its token and length rows."""
    return step_args_bytes(torch, params, engine.caches, engine.cur_tok,
                           engine.cache_len)


def serve_step_row(torch, cfg, params, summary, moe_fn=None):
    """One decode step of the serve's shape on the card -- DRYRUN_BATCH
    rows, float32 caches of DRYRUN_CAPACITY slots made as the engine makes
    them, every row at DRYRUN_STEP_LEN tokens -- timed on the wall (p50 of
    five synchronized steps) and under ``torch.profiler`` (the device's
    kernel time); with the serve's own p50 and the bytes its engine took
    as a step's arguments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_mod

    b = DRYRUN_BATCH
    cache_len = torch.full((b,), DRYRUN_STEP_LEN, dtype=torch.int32,
                           device="cuda")
    caches = model_mod._with_lengths(cfg, model_mod.decode_ready_caches(
        cfg, model_mod.make_caches(cfg, b, DRYRUN_CAPACITY, torch.float32,
                                   "cuda")), cache_len)
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")

    def step():
        model_mod.decode_step(params, cfg, tok, caches, cache_len, moe_fn)

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    cache_bytes = step_args_bytes(torch, caches)
    row = {"serve_decode_step_p50_ms": 1e3 * summary["decode_step_p50_s"],
           "step_wall_ms_p50": statistics.median(walls),
           "step_device_ms": sum(e.self_device_time_total
                                 for e in kernels) / 1e3,
           "step_launches": sum(e.count for e in kernels),
           "serve_args_bytes": summary["decode_args_bytes"],
           "kv_bytes_per_req": cache_bytes / b}
    del caches
    return row


def one_rank_records() -> None:
    """(In a process of its own.) A 1 x 1 dry-run record of every
    DRYRUN_SERVES config's decode step at the serve's shape and dtypes (the
    model's, float32 caches), one JSON line ``{name: record}``."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun

    mesh = dryrun.fake_mesh({"data": 1, "model": 1})
    shape = InputShape("serve_decode", DRYRUN_CAPACITY, DRYRUN_BATCH,
                       "decode")
    out = {}
    for name, config in DRYRUN_SERVES:
        t0 = time.perf_counter()
        out[name] = dryrun.record(globals()[config](), shape, mesh,
                                  cache_dtype=torch.float32)
        out[name]["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))


def load_entry(rel: str):
    """An example or script of the repo (``rel`` from the repo's root) as
    a module, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(rel).stem, HERE / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, device: str) -> dict:
    """Each of EXAMPLES through its ``main`` on the card (its own lines
    captured; the training example's checkpoint in a temporary
    directory), counts set to 0 just before it and read just after: one
    line each with its key numbers. Fails if an example fails, if the
    quickstart's INT8 linear, the R1 serve or the dev smoke's SSM prefills
    launch no kernel of theirs, if MTP's tokens part from greedy decoding
    or if training does not lower the loss. Returns each kernel's
    launches over the phase."""
    import io
    import tempfile

    total = {k: 0 for k in KERNEL_MODULES}
    with tempfile.TemporaryDirectory() as tmp:
        for name, rel, argv in EXAMPLES:
            argv = argv + ["--device", "cuda"]
            if name == "torch_train_moe_100m":
                argv += ["--ckpt", str(Path(tmp) / "ckpt")]
            main = load_entry(rel).main
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                got = main(argv)
            torch.cuda.synchronize()
            counts = read_counts()
            total = {k: total[k] + counts[k] for k in total}
            row = {"s": time.perf_counter() - t0, "kernel_launches": counts,
                   "lines": len(out.getvalue().splitlines())}
            if name == "torch_quickstart":
                row.update(int8_rel_err=got["int8_rel_err"],
                           greedy=got["greedy"],
                           moe_aux_loss=got["moe_aux_loss"])
                need = ("dispatch_quant", "int8_gemm")
            elif name.startswith("torch_serve_pdc"):
                row.update({k: got[k] for k in (
                    "arch", "mtp", "reused_tokens", "hit_rate", "handoffs",
                    "handoff_mib", "prefill_saved")})
                need = ("mla_attention",) if "r1" in name else ()
            elif name == "torch_mtp_speculative":
                row.update({k: got[k] for k in (
                    "iterations", "accepted", "tokens_per_iteration",
                    "equal_to_greedy")})
                if not got["equal_to_greedy"]:
                    raise AssertionError(f"examples {name}: {got}")
                need = ()
            elif name == "torch_train_moe_100m":
                row.update({k: got[k] for k in (
                    "steps", "first_loss", "final_loss", "params_m")})
                row["step_s"] = row["s"] / got["steps"]
                if not got["final_loss"] < got["first_loss"]:
                    raise AssertionError(f"examples {name}: {got}")
                need = ()
            else:
                # NaN where the batch leaves no labelled token (the VLM's
                # smoke prefix fills its 16 positions), as in JAX.
                row["configs"] = {r["name"]: {
                    k: r[k] if r[k] == r[k] else None
                    for k in ("loss", "prefill_err") if k in r} for r in got}
                need = ("ssd_scan",)
            if not all(counts[k] for k in need):
                raise AssertionError(f"examples {name}: no launch of "
                                     f"{need}: {counts}")
            log(f"examples: {name}: {json.dumps(row)} on {device}")
    return total


def dryrun_phase(torch, serve_rows) -> None:
    """The dry run on the production meshes and the 1 x 1 records, all in
    processes started together. Every production record must be ``ok``;
    every 1 x 1 record's argument bytes must equal its serve's, byte for
    byte, with no collective byte; beside each, the roofline step computed
    from the H100's data-sheet rates, the step measured on the card and
    the decode cost model calibrated from the record."""
    from repro_torch.serving.scheduler import decode_cost_from_roofline

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out_dir = HERE / "experiments" / "dryrun_torch"
    procs = []
    for arch, shape, multi_pod in DRYRUN_PRODUCTION:
        mesh = "2x16x16" if multi_pod else "16x16"
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        path.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if multi_pod
                                          else [])
        procs.append((f"{arch} × {shape} × {mesh}", path,
                      time.perf_counter(),
                      subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE)))
    records = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.one_rank_records()"],
        cwd=HERE, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    try:
        for what, path, t0, proc in procs:
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            wall = time.perf_counter() - t0
            rec = json.loads(path.read_text()) if path.exists() else {}
            if proc.returncode or rec.get("status") != "ok":
                raise AssertionError(f"dryrun {what}: {rec.get('error')} "
                                     f"{err[-2000:]}")
            jax_args, jax_coll = JAX_DRYRUN[what]
            if rec["argument_bytes"] != jax_args:
                raise AssertionError(f"dryrun {what}: argument bytes "
                                     f"{rec['argument_bytes']} != JAX's "
                                     f"{jax_args}")
            if what == DRYRUN_R1 and not (
                    rec["collectives"]["all-gather"] < DRYRUN_R1_AG_BYTES
                    and rec["collective_s"] < DRYRUN_R1_COLL_S):
                raise AssertionError(
                    f"dryrun {what}: all-gather "
                    f"{rec['collectives']['all-gather']} B and collective "
                    f"term {rec['collective_s']} s, over "
                    f"{DRYRUN_R1_AG_BYTES} B and {DRYRUN_R1_COLL_S} s")
            total = sum(rec["collectives"][k] for k in jax_coll)
            jax_total = sum(jax_coll.values())
            factor = DRYRUN_OLMOE_FACTOR if what == DRYRUN_OLMOE else \
                DRYRUN_R1_TRAIN_FACTOR if what == DRYRUN_R1_TRAIN else \
                DRYRUN_COLL_FACTOR
            if total > factor * jax_total:
                raise AssertionError(
                    f"dryrun {what}: collective bytes {total} over "
                    f"{factor} x JAX's {jax_total}")
            if what == DRYRUN_OLMOE and \
                    rec["collective_s"] >= DRYRUN_OLMOE_COLL_S:
                raise AssertionError(
                    f"dryrun {what}: collective term {rec['collective_s']} "
                    f"s, over {DRYRUN_OLMOE_COLL_S} s")
            if what == DRYRUN_QWEN3 and rec["collectives"]["all-gather"] \
                    >= DRYRUN_QWEN3_AG_BYTES:
                raise AssertionError(
                    f"dryrun {what}: all-gather "
                    f"{rec['collectives']['all-gather']} B, over "
                    f"{DRYRUN_QWEN3_AG_BYTES} B")
            sweep, sweep_permute = DRYRUN_CPU_SWEEP[what]
            permute = rec["collectives"]["collective-permute"]
            if permute != sweep_permute or \
                    abs(total - sweep) > DRYRUN_SWEEP_TOL * sweep:
                raise AssertionError(
                    f"dryrun {what}: collective bytes {total}, permuted "
                    f"{permute}, against the CPU sweep's {sweep} and "
                    f"{sweep_permute}")
            log(f"dryrun: {what}: " + json.dumps({
                "collective_bytes": total, "jax_collective_bytes": jax_total,
                "to_jax": total / jax_total,
                "cpu_sweep_collective_bytes": sweep,
                "cpu_sweep_permute_bytes": sweep_permute,
                "compute_ms": 1e3 * rec["compute_s"],
                "memory_ms": 1e3 * rec["memory_s"],
                "collective_ms": 1e3 * rec["collective_s"],
                "dominant": rec["dominant"],
                "argument_gib_per_rank": rec["argument_bytes"] / 2 ** 30,
                "temp_gib_per_rank": rec["temp_bytes"] / 2 ** 30,
                "argument_bytes": rec["argument_bytes"],
                "collectives": rec["collectives"],
                "jax_collectives": jax_coll,
                "trace_s": rec["compile_s"], "wall_s": wall,
                "terms": "computed from H100 SXM5 data-sheet rates"}))
        stdout, err = records.communicate(
            timeout=max(1.0, deadline - time.perf_counter()))
        if records.returncode:
            raise AssertionError(f"dryrun 1 x 1 records: {err[-3000:]}")
        ones = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in [p for *_, p in procs] + [records]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, _ in DRYRUN_SERVES:
        rec, row = ones[name], serve_rows[name]
        coll = rec["collective_bytes_per_device"]
        if rec["status"] != "ok" or coll:
            raise AssertionError(f"dryrun-serve {name}: status "
                                 f"{rec['status']}, {coll} collective bytes")
        # The record's cache ``length`` leaves that the step reads (a
        # hybrid's SSM length) are scalars of their own; the engine keeps
        # them as views of its ``cache_len``.
        args = rec["argument_bytes"] - rec["cache_length_bytes"]
        if args != row["serve_args_bytes"]:
            raise AssertionError(
                f"dryrun-serve {name}: the record's argument bytes {args} "
                f"!= the serve's {row['serve_args_bytes']}")
        roof_s = max(rec["compute_s"], rec["memory_s"]) + rec["collective_s"]
        model = decode_cost_from_roofline(rec, row["kv_bytes_per_req"],
                                          DRYRUN_BATCH)
        log(f"dryrun-serve: {name}: " + json.dumps({
            "argument_bytes": rec["argument_bytes"],
            "cache_length_bytes": rec["cache_length_bytes"],
            "unused_argument_bytes": rec["unused_argument_bytes"],
            "collective_bytes": coll,
            "roofline_step_ms": 1e3 * roof_s,
            "compute_ms": 1e3 * rec["compute_s"],
            "memory_ms": 1e3 * rec["memory_s"], "dominant": rec["dominant"],
            **row,
            "cost_model_step_ms": 1e3 * model.step_time(DRYRUN_BATCH),
            "record_wall_s": rec["wall_s"],
            "terms": "computed from H100 SXM5 data-sheet rates"}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the MLA kernel at each piece count of "
                         "SWEEP_PIECES in every kernel-phase case")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    device = device_line()
    log(device)
    kind = torch.cuda.get_device_name(0)

    from repro_torch.kernels import build
    tb = time.perf_counter()
    build_logs = build.build_all(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - tb:.1f} s for {sorted(build.SOURCES)}")
    for name, text in build_logs.items():
        func = None
        for line in text.splitlines():
            m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
            if m:
                func = entry_name(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"build[{name}:{func}]: {line.strip()}")
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)
                if name in SPILL_GATED and spills \
                        and spills.groups() != ("0", "0"):
                    raise AssertionError(f"{name} spills in {func}: "
                                         f"{line.strip()}")

    from repro_torch.models import init_params
    cfg = serve_config()
    ti = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"init: {n_params / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - ti:.1f} s")

    serve, counts, final_lens, tokens = serve_phase(torch, cfg, params)
    log(f"serve: {json.dumps(serve)} on {device}")
    lep_serve, lep_counts = serve_lep_phase(torch, cfg, params, tokens)
    log(f"serve-lep: {json.dumps(lep_serve)} on {device}")
    from repro_torch.core import make_lep_moe_fn
    serve_rows = {"serve-lep": serve_step_row(torch, cfg, params, lep_serve,
                                              make_lep_moe_fn())}
    log("serve-lep beside serve: " + json.dumps({
        key: [serve[key], lep_serve[key]]
        for key in ("ttft_p50_s", "tpot_p50_s", "decode_tokens_per_s")}))

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = kernel_phase(torch, flush, final_lens, args.sweep)
    lse_rows = kernel_lse_phase(torch, final_lens)
    dq_rows, dq_ragged = dispatch_quant_phase(torch, flush, cfg,
                                              max(serve["prompt_lens"]))
    int8_rows, int8_ragged, int8_counts = int8_phase(
        torch, flush, cfg, params, serve_requests(cfg))
    del flush

    agree = agreement_phase(torch, cfg, params)
    log(f"agreement: {json.dumps(agree)}")

    tp = time.perf_counter()
    mtp, mtp_counts = serve_mtp_phase(torch, cfg, params)
    log(f"serve-mtp: {json.dumps(mtp)} on {device}")
    log(f"serve-mtp: phase {time.perf_counter() - tp:.1f} s")
    tp = time.perf_counter()
    ems, ems_counts = serve_ems_phase(torch, cfg, params, tokens)
    log(f"serve-ems: {json.dumps(ems)} on {device}")
    log(f"serve-ems: phase {time.perf_counter() - tp:.1f} s")
    cli = cli_phase(torch)
    log(f"cli: {json.dumps(cli)} on {device}")
    cli_dense = cli_phase(torch, "qwen3-8b")
    log(f"cli-dense: {json.dumps(cli_dense)} on {device}")
    if any(cli_dense["kernel_launches"].values()):
        raise AssertionError(f"the GQA CLI launched a kernel: {cli_dense}")

    # The parallel layer over a 1 x 1 mesh of one NCCL rank: R1's prefill
    # through the §4.3.1 hybrid, then Kimi K2 through its model-axis plan.
    mesh = one_rank_mesh(torch)
    tp = time.perf_counter()
    hybrid = hybrid_prefill_phase(torch, cfg, params, mesh)
    log(f"hybrid-prefill: {json.dumps(hybrid)} on {device}")
    serve_hybrid, hybrid_counts = serve_hybrid_phase(torch, cfg, params, mesh,
                                                     tokens)
    log(f"serve-hybrid: {json.dumps(serve_hybrid)} on {device}")
    log("serve-hybrid beside serve: " + json.dumps({
        key: [serve[key], serve_hybrid[key]]
        for key in ("ttft_p50_s", "tpot_p50_s", "decode_step_p50_s",
                    "decode_tokens_per_s")}))
    log(f"serve-hybrid: phase {time.perf_counter() - tp:.1f} s")
    tp = time.perf_counter()
    sharded = sharded_step_phase(torch, params, mesh, [
        name for name in SHARDED_LAUNCHES if name in SHARDED_SERVE_WEIGHTS])
    del params
    free_model(torch)
    sharded += sharded_step_phase(torch, None, mesh, [
        name for name in SHARDED_LAUNCHES
        if name not in SHARDED_SERVE_WEIGHTS])
    for row in sharded:
        log(f"sharded-step: {json.dumps(row)} on {device}")
    sharded_counts = {k: sum(r["kernel_launches"][k] for r in sharded)
                      for k in KERNEL_MODULES}
    log(f"sharded-step: phase {time.perf_counter() - tp:.1f} s, kernel "
        f"launches {json.dumps(sharded_counts)}")

    # Kimi K2 at its widths, 2 layers, after R1's weights are freed.
    kcfg = kimi_config()
    kparams = init_model(torch, kcfg, "kimi")
    tp = time.perf_counter()
    kimi_agree = kimi_lep_agree_phase(torch, kcfg, kparams, mesh)
    log(f"kimi-lep-agree: {json.dumps(kimi_agree)} on {device}")
    prod_plan, tokens_plan = kimi_plans()
    kimi, kimi_counts = serve_kimi_phase(torch, kcfg, kparams, prod_plan,
                                         mesh, 1)
    kimi_tokens = kimi.pop("tokens")
    log(f"serve-kimi: {json.dumps(kimi)} on {device}")
    serve_rows["serve-kimi"] = serve_step_row(
        torch, kcfg, kparams, kimi, make_lep_moe_fn(mesh=mesh, **prod_plan))
    kimi_tok, kimi_tok_counts = serve_kimi_phase(
        torch, kcfg, kparams, tokens_plan, mesh, 2, kimi_tokens)
    log(f"serve-kimi-tokens: {json.dumps(kimi_tok)} on {device}")
    log("serve-kimi-tokens beside serve-kimi: " + json.dumps({
        key: [kimi[key], kimi_tok[key]]
        for key in ("ttft_p50_s", "tpot_p50_s", "decode_step_p50_s",
                    "decode_tokens_per_s", "peak_mem_gib")}))
    log(f"kimi: phase {time.perf_counter() - tp:.1f} s")
    del kparams
    free_model(torch)
    torch.distributed.destroy_process_group()

    # Qwen3-8B, whole: serve-dense, dense-agreement, int8-dense.
    qcfg = dense_config()
    qparams = init_model(torch, qcfg, "dense")
    qreqs = serve_requests(qcfg)
    dense, dense_counts, _, dense_tokens = serve_phase(torch, qcfg, qparams,
                                                       reqs=qreqs)
    log(f"serve-dense: {json.dumps(dense)} on {device}")
    serve_rows["serve-dense"] = serve_step_row(torch, qcfg, qparams, dense)
    tp = time.perf_counter()
    dense_agree = dense_agreement_phase(torch, qcfg, qparams, qreqs,
                                        dense_tokens)
    log(f"dense-agreement: {json.dumps(dense_agree)}")
    ring = ring_phase(torch, qcfg, qparams)
    log(f"dense-agreement ring: {json.dumps(ring)}")
    log(f"dense-agreement: phase {time.perf_counter() - tp:.1f} s")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    dense_int8_rows, dense_int8_counts = int8_path_rows(
        torch, flush, qcfg, qparams, qreqs, DENSE_INT8_PROJECTIONS,
        "int8-dense")
    del flush
    log("int8-dense: " + json.dumps({
        "cases": len(dense_int8_rows), "kernel_launches": dense_int8_counts,
        **{f"{key}_sum": sum(r[key] for r in dense_int8_rows)
           for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                       "library_ms")}}))
    free_model(torch)
    tp = time.perf_counter()
    faults = serve_faults_phase(torch, qcfg, qparams, qreqs, dense_tokens)
    log(f"serve-faults: {json.dumps(faults)} on {device}")
    log("serve-faults beside serve-dense: " + json.dumps({
        key: [dense[key], faults[key]]
        for key in ("ttft_p50_s", "tpot_p50_s", "decode_step_p50_s",
                    "decode_tokens_per_s")}))
    log(f"serve-faults: phase {time.perf_counter() - tp:.1f} s")
    check_serve_faults(faults)
    del qparams
    free_model(torch)

    # OLMoE-1B-7B, whole: moe_capacity, then LEP at world size 1.
    ocfg = olmoe_config()
    oparams = init_model(torch, ocfg, "olmoe")
    olmoe, _, _, olmoe_tokens = serve_phase(torch, ocfg, oparams)
    log(f"serve-olmoe: {json.dumps(olmoe)} on {device}")
    olmoe_lep, olmoe_lep_counts = serve_lep_phase(torch, ocfg, oparams,
                                                  olmoe_tokens)
    log(f"serve-olmoe-lep: {json.dumps(olmoe_lep)} on {device}")
    serve_rows["serve-olmoe-lep"] = serve_step_row(
        torch, ocfg, oparams, olmoe_lep, make_lep_moe_fn())
    log("serve-olmoe-lep beside serve-olmoe: " + json.dumps({
        key: [olmoe[key], olmoe_lep[key]]
        for key in ("ttft_p50_s", "tpot_p50_s", "decode_tokens_per_s")}))
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    olmoe_dq = dq_served_rows(torch, flush, ocfg, max(olmoe["prompt_lens"]),
                              torch.Generator(device="cuda").manual_seed(SEED),
                              tag="dispatch_quant-olmoe")
    del flush, oparams
    free_model(torch)

    # Mamba2-780m, whole, after the other models' weights are freed.
    scfg = ssm_config()
    sparams = init_model(torch, scfg, "ssm")
    ssm_serve, ssm_counts, _, ssm_tokens = serve_phase(torch, scfg, sparams)
    log(f"serve-ssm: {json.dumps(ssm_serve)} on {device}")
    serve_rows["serve-ssm"] = serve_step_row(torch, scfg, sparams, ssm_serve)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ts = time.perf_counter()
    ssd_rows = ssd_scan_phase(torch, flush, scfg.ssm_chunk)
    log(f"ssd_scan: phase {time.perf_counter() - ts:.1f} s")
    del flush
    ssm_agree = ssm_agreement_phase(torch, scfg, sparams, serve_requests(scfg),
                                    ssm_tokens)
    log(f"ssm-agreement: {json.dumps(ssm_agree)}")
    # Training: Mamba2 trained whole through the SSD Function, its
    # gradients at both models' widths, then a checkpoint round trip.
    tp = time.perf_counter()
    sparams, train_ssm, train_counts = train_ssm_phase(torch, scfg, sparams)
    log(f"train-ssm: {json.dumps(train_ssm)} on {device}")
    log(f"train-ssm: phase {time.perf_counter() - tp:.1f} s")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    tp = time.perf_counter()
    grad_rows = ssd_grad_rows(torch, flush)
    del flush
    log("train-ssd-grad: " + json.dumps({
        "scans_per_step": scfg.num_layers,
        "backward_ms_per_step": scfg.num_layers * grad_rows[0]["backward_ms"],
        "backward_share_of_step": scfg.num_layers * grad_rows[0]["backward_ms"]
        / (1e3 * train_ssm["step_p50_s"])}))
    log(f"train-ssd-grad: phase {time.perf_counter() - tp:.1f} s")
    tp = time.perf_counter()
    ckpt, ckpt_counts = ckpt_phase(torch, scfg, sparams)
    log(f"ckpt: {json.dumps(ckpt)} on {device}")
    log(f"ckpt: phase {time.perf_counter() - tp:.1f} s")
    del sparams
    free_model(torch)

    # Zamba2-1.2B, whole, after Mamba2's weights are freed.
    zcfg = zamba_config()
    zparams = init_model(torch, zcfg, "zamba")
    log(f"zamba-sizes: {json.dumps(zamba_sizes(zcfg, zparams))}")
    zreqs = serve_requests(zcfg)
    tp = time.perf_counter()
    zamba, zamba_counts, _, zamba_tokens = serve_phase(torch, zcfg, zparams,
                                                       reqs=zreqs)
    log(f"serve-zamba: {json.dumps(zamba)} on {device}")
    serve_rows["serve-zamba"] = serve_step_row(torch, zcfg, zparams, zamba)
    log(f"serve-zamba: phase {time.perf_counter() - tp:.1f} s")
    tp = time.perf_counter()
    zamba_agree = zamba_agreement_phase(torch, zcfg, zparams, zreqs,
                                        zamba_tokens)
    log(f"zamba-agreement: {json.dumps(zamba_agree)}")
    log(f"zamba-agreement: phase {time.perf_counter() - tp:.1f} s")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    tp = time.perf_counter()
    zamba_ssd_rows = ssd_scan_zamba_phase(torch, flush, zcfg.ssm_chunk)
    log(f"ssd_scan-zamba: phase {time.perf_counter() - tp:.1f} s")
    del flush
    tp = time.perf_counter()
    cli_zamba = cli_zamba_phase(torch)
    log(f"cli-zamba: {json.dumps(cli_zamba)} on {device}")
    log(f"cli-zamba: phase {time.perf_counter() - tp:.1f} s")

    # forward: Zamba2, then InternVL2-2B and HuBERT-XLarge, one at a time.
    tp = time.perf_counter()
    reset_counts()
    fwd = [forward_zamba(torch, zcfg, zparams, zreqs[FORWARD_RID].prompt)]
    fwd_counts = read_counts()
    if fwd_counts != {**{k: 0 for k in KERNEL_MODULES},
                      "ssd_scan": 2 * zcfg.num_layers}:
        raise AssertionError(f"Zamba2 forward + prefill launched "
                             f"{fwd_counts}, not 2 x {zcfg.num_layers} "
                             "SSD scans alone")
    del zparams
    free_model(torch)
    reset_counts()
    fwd += [forward_vlm(torch), forward_audio(torch)]
    if any(read_counts().values()):
        raise AssertionError(f"a GQA forward launched a kernel: "
                             f"{read_counts()}")
    for row in fwd:
        log(f"forward: {json.dumps(row)} on {device}")
    log(f"forward: phase {time.perf_counter() - tp:.1f} s")

    tp = time.perf_counter()
    example_counts = examples_phase(torch, device)
    if not all(example_counts.values()):
        raise AssertionError(f"examples: a kernel never launched: "
                             f"{example_counts}")
    log(f"examples: phase {time.perf_counter() - tp:.1f} s, kernel "
        f"launches {json.dumps(example_counts)}")
    free_model(torch)

    tp = time.perf_counter()
    dryrun_phase(torch, serve_rows)
    log(f"dryrun: phase {time.perf_counter() - tp:.1f} s")

    main_row = rows[-1]
    dq_row = dq_rows[0]                   # the decode dispatch buffer
    int8_total = {key: sum(r[key] for r in int8_rows)
                  for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                              "library_ms")}
    int8_ops_ms, int8_bytes_ms = (sum(t) for t in zip(*(
        int8_times(r["M"], r["N"], r["K"]) for r in int8_rows)))
    kernels = [{
        "name": "mla_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode_attention.cu",
        "replaces": "src/repro/kernels/mla_attention/mla_attention.py:69",
        "launches": counts["mla_attention"],
        # Each path's own run, counts set to 0 just before it.
        "launches_by_path": {
            "serve": counts["mla_attention"],
            "serve-lep": lep_counts["mla_attention"],
            "serve-mtp unfused": mtp_counts["unfused"]["mla_attention"],
            "serve-mtp fused": mtp_counts["fused"]["mla_attention"],
            "serve-ems turn 1": ems_counts["turn1"]["mla_attention"],
            "serve-ems turn 2": ems_counts["turn2"]["mla_attention"],
            "cli": cli["kernel_launches"]["mla_attention"],
            "serve-hybrid": hybrid_counts["mla_attention"],
            "serve-dense": dense_counts["mla_attention"],
            "examples": example_counts["mla_attention"],
            "sharded-step": sharded_counts["mla_attention"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # The return_lse variant (the sharded decode's) and the serve's
        # cache merged from MLA_SPLIT_BLOCKS blocks, against the plain
        # version and the whole-cache call.
        "lse_max_rel_err": max(r["lse_max_rel_err"] for r in lse_rows),
        "split_max_abs_err": lse_rows[-1]["split_max_abs_err"],
        "ms": main_row["ms"],
        "graph_ms": main_row["graph_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "bound_fp32_ms": main_row["bound_fp32_ms"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "dispatch_quantize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dispatch_quant.cu",
        "replaces": "src/repro/kernels/dispatch_quant/dispatch_quant.py:29",
        "launches": lep_counts["dispatch_quant"],
        "launches_by_path": {
            "serve-lep": lep_counts["dispatch_quant"],
            "serve-olmoe-lep": olmoe_lep_counts["dispatch_quant"],
            "serve-kimi": kimi_counts["dispatch_quant"],
            "serve-kimi-tokens": kimi_tok_counts["dispatch_quant"],
            "int8": int8_counts["dispatch_quant"],
            "int8-dense": dense_int8_counts["dispatch_quant"],
            "examples": example_counts["dispatch_quant"],
            "sharded-step": sharded_counts["dispatch_quant"]},
        "max_abs_err": max(r["max_abs_err"]
                           for r in dq_rows + dq_ragged + olmoe_dq),
        "ms": dq_row["ms"],
        "graph_ms": dq_row["graph_ms"],
        "plain_ms": dq_row["plain_ms"],
        "bound_ms": dq_row["bound_ms"],
        "bound_by": dq_row["bound_by"],
        "library_ms": None,
    }, {
        # Sums over every projection and both M of the int8 phase.
        "name": "int8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
        "replaces": "src/repro/kernels/int8_gemm/int8_gemm.py:39",
        "launches": int8_counts["int8_gemm"],
        "launches_by_path": {"int8": int8_counts["int8_gemm"],
                             "int8-dense": dense_int8_counts["int8_gemm"],
                             "examples": example_counts["int8_gemm"],
                             "sharded-step": sharded_counts["int8_gemm"]},
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows + int8_ragged
                           + dense_int8_rows),
        "ms": int8_total["ms"],
        "graph_ms": int8_total["graph_ms"],
        "plain_ms": int8_total["plain_ms"],
        "bound_ms": int8_total["bound_ms"],
        "bound_by": "operations" if int8_ops_ms >= int8_bytes_ms else "bytes",
        "library_ms": int8_total["library_ms"],
    }, {
        # The longest served prompt (S=1019) at the served widths.
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:74",
        "launches": ssm_counts["ssd_scan"],
        "launches_by_path": {
            "serve-ssm": ssm_counts["ssd_scan"],
            "serve-zamba": zamba_counts["ssd_scan"],
            "cli-zamba": cli_zamba["kernel_launches"]["ssd_scan"],
            "forward": fwd_counts["ssd_scan"],
            "train-ssm": train_counts["ssd_scan"],
            "ckpt": ckpt_counts["ssd_scan"],
            "examples": example_counts["ssd_scan"],
            "sharded-step": sharded_counts["ssd_scan"]},
        "max_abs_err": max(r["max_abs_err"]
                           for r in ssd_rows + zamba_ssd_rows),
        "ms": ssd_rows[0]["ms"],
        "graph_ms": ssd_rows[0]["graph_ms"],
        "plain_ms": ssd_rows[0]["plain_ms"],
        "bound_ms": ssd_rows[0]["bound_ms"],
        "bound_by": ssd_rows[0]["bound_by"],
        "bound_fp32_ms": ssd_rows[0]["bound_fp32_ms"],
        "library_ms": None,
        # The SSD Function's backward (plain PyTorch, no kernel) at
        # Mamba2's training widths and at Zamba2's.
        "backward": {r["case"]: {key: r[key] for key in (
            "B", "S", "H", "N", "max_rel_err", "forward_ms", "backward_ms",
            "plain_backward_ms")} for r in grad_rows},
        # Zamba2's served widths (H=64, P=64, N=64) at S=1019.
        "zamba": {key: zamba_ssd_rows[0][key] for key in (
            "S", "H", "P", "N", "max_abs_err", "ms", "graph_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_fp32_ms")},
    }]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(device)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                     # any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
