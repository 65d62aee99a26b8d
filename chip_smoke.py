#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

1. Prints the card and its power limit, builds the three Hopper kernels
   from ``src/repro_torch/csrc/`` with nvcc for sm_90a, one nvcc per
   source, all started together, and prints each source's ptxas report
   (registers, shared memory, spills; every kernel's in the JSON file).
   While nvcc runs, the paths that launch no kernel run: [train] (16)
   and [dryrun]'s traces (17).
2. Kernel phase: every kernel, at STAGES=1 ('off') and STAGES=2
   ('double_buffer'), against its plain torch version on the card.
   qmatmul and qconv: every ResNet-8 and MobileNet conv geometry, the
   head GEMM, MobileNet's three depthwise layers as block-diagonal GEMMs
   (4096x144x16, 4096x288x32, 1024x576x64) and as per-channel convs
   (cin = cout = 1, stride 1 and 2), all at a wave of 64, plus one larger
   GEMM, then a wall of ragged GEMMs (real K 1, 31, 33, 64, 200, 1000; N
   1, 10, 17, 100, 128, 200, 384; M 1, 64, 100, 4096; K split across
   blocks where the launch plan splits it, and unsplit; two A8 grids
   wider than the card at the 128-wide tile, at two blocks per SM as
   planned and at one) and the conv shapes the
   real-channel K order makes risky (Cin 1, 3, 160, 200: two chunks, one
   ragged; Cout 1, 10, 48, 200; a 1x1 stride-2 conv, 5x5 convs, Wo that
   does not divide the 128-pixel tile), for A{8,4,2} x W{8,4,2} and all
   three epilogues. The GEMM runs at each launch `Case.launches` lists.
   qmatmul_segmented: segment mixes 8|4, 8|2, 4|2, 8|4|2 at a ragged shape
   (N = 320 with a 64-wide tail panel, K = 200, K split across blocks),
   one more K = 200 call with a ragged last run, the reference's fig8
   shape 256x2048x256 (half W8, half W2) and qat-cnn's c3 as a GEMM over a
   wave of 64 (12544x288x256, half W8, half W4), for A{8,4,2} and all
   three epilogues. Tolerance: none — outputs must be identical (bf16 bit
   for bit).
3. Main path, ResNet-8: full width from seeded random weights, quantized
   on the card at W8, W4 and W2 and served by `VisionEngine` (waves of
   64, 256 images); then one wave with the kernels' double-buffered
   pipeline. qmatmul and qconv must have launched at both STAGES. The
   same fp weights and absmax are quantized again on the CPU: every array
   of that artifact must be byte-identical to the card's, and the logits
   must equal that CPU net's run through the plain versions.
4. Main path, qat-cnn (fine-grain mixed precision): full width, quantized
   on the card under (a) a fixed channel-group plan (c3 half W8, half W4)
   and (b) the plan `calibrate_vision` + `plan_mixed_precision(
   granularity='channel_group')` give on the card; both served (waves of
   64, 256 images), plan (a) once more with the double-buffered pipeline,
   and `kernels.api.qdot` called on a `SegmentedLinearParams` of plan
   (a)'s c3 runs at both pipelines. Every kernel of the path must have
   launched. The CPU re-quantizes both plans (byte-identical artifacts,
   identical logits); the qdot call's raw accumulators must equal c3's
   per-run qconv accumulators.
5. Main path, mobilenet-tiny (depthwise-separable): full width,
   quantized on the card at W8, W4, W2 and under the plan
   `calibrate_vision` + `plan_mixed_precision` (widths 8, 4, 2) give on
   the card, each served (waves of 64, 256 images); one more wave with
   the double-buffered pipeline, and one wave of each net forced through
   each depthwise lowering ('qdot': block-diagonal GEMM, 'per_group': one
   conv per channel), whose integer edges must be identical at every
   layer and whose logits must equal the served ones. qmatmul and qconv
   must have launched at both STAGES; the CPU re-quantizes every net
   (byte-identical artifacts, identical logits).
6. [tune]: `kernels.tune.autotune_qdot` on the card over the ResNet-8
   head and MobileNet's three block-diagonal GEMMs at a wave of 64,
   4096x1152x64, fig8 256x2048x256 and 4096x2048x1024 at A8 x W{8,4,2}
   (every launch `gemm_launches` lists, both pipelines), and
   `autotune_qconv` over ResNet-8's nine conv geometries at W8A8 (both
   pipelines), ranked by profiler device time; every candidate's output
   must equal the planned launch's. One line per shape: the planned
   launch and its device us, the winner and its device us, both re-timed
   in turns. The cache is
   saved to ``chiprun_out/tune_cache.json``, loaded and merged into a
   cleared cache, and one resnet8 W8 wave served with it: logits equal to
   the untuned wave's, every dispatch a cache hit with a tuned pipeline.
7. [obs]: observability off, a served resnet8 wave records nothing; on,
   one W8A8 wave each of resnet8 and mobilenet-tiny under torch.profiler,
   exported to ``chiprun_out/trace.json`` and rendered by
   `repro_torch.obs.report`; the op counters must equal those of the same
   nets on the CPU plain path (backend name aside). Prints the report's
   MAC/us per (op, W, A, pipeline) (span wall time, synced) beside MACs
   over the kernels' device time. Both phases start and end with an
   empty tune cache and observability off; ``REPRO_QTUNE_CACHE`` is
   ignored.
8. [lm]: the quantized dense LM, qwen2.5-3b. Kernels 1-3 at its four
   dense shapes (K x N 2048x2048, 2048x256, 2048x11008, 11008x2048; M 1,
   4 and 64; kernel 3 under a two-run plan on 2048x11008, half W8, half
   W4) with signed activations, a per-channel dequant scale and both
   output dtypes (bfloat16, float32), A{8,4,2} x W{8,4,2}, both STAGES,
   identical to the plain version. Then full width, its depth cut to 12
   of 36 layers, from
   seeded weights made and quantized on the card at W8A8, W4A8 and W2A8,
   each served by `Engine` (8 requests of 2-8 prompt tokens, 16 new
   tokens, batch 4, max_len 128, bf16 compute as configured), W4A8 once
   more double-buffered (the same tokens); qmatmul must have launched at
   both STAGES. Every dense call of one W4A8 decode step (`dense_tap`,
   12 x 7) is identical to the same call on the CPU; one decode step is
   profiled. A plan with a segments rule on every layers/mlp/wi (half
   W8, half W4) is served and then the CLI `python -m
   repro_torch.launch.serve --arch qwen2.5-3b --quant w4a8 --layers
   12`; kernel 3 must
   have launched. At 2 layers of the full width, float32 compute, the
   W4A8 artifact packed on the card equals the CPU's byte for byte, and
   prefill plus 8 decode steps stay within 1e-3 of the largest logit of
   the CPU run, with greedy tokens equal wherever the CPU's top-1 margin
   exceeds that.
9. [rec]: the recurrent LM families, mamba2-370m (Mamba-2 SSD) and
   recurrentgemma-9b (Griffin: RG-LRU + local attention on a ring KV
   cache). Kernels 1-2 at their six new K x N shapes (1024x4384,
   2048x1024, 4096x4096, 4096x256, 4096x12288, 12288x4096; M = 4, A8 x
   W{8,4,2}) and kernel 3 on 4096x12288 under a two-run plan (A{8,4,2}),
   signed activations, a per-channel scale, both output dtypes, both
   STAGES, identical to the plain version. Then each model at full width
   (its depth cut to 6 of 48 layers for mamba, 8 of 38 for rgemma:
   two (rec, rec, attn) groups and the two trailing rec layers; the
   CLI with ``--layers``)
   from seeded weights made and quantized on the card one width at a
   time (the fp tree stays; each artifact is freed before the next),
   served by `Engine` like qwen2.5-3b at W8A8, W4A8, W4A8
   double-buffered (the same tokens) and W2A8, with the peak device
   memory on each serve line; qmatmul must have launched at both STAGES.
   At W4A8: every dense call of one decode step at per-slot positions
   (`dense_tap`: 12 x 2 and 8 x 8 + 3 x 7) identical to the CPU's, one
   profiled decode step, and the last requests of the two waves (4 for
   mamba, the second wave's; 3 for rgemma), which ran on reused slots,
   each equal to
   the same request served alone by a one-slot `Engine` (the carried
   SSM / RG-LRU state is cleared on admission). rgemma serves one more
   plan, every rec_layers/mlp/wi split W8 | W4 (kernel 3 must launch),
   and each model runs the CLI at W4A8. At reduced depth (mamba 2
   layers, rgemma 3: one rec, rec, attn group, its window cut from 2048
   to 16 so the ring of 16 slots wraps), float32 compute: the W4A8
   artifact packed on the card equals the CPU's byte for byte, and 8
   prompt tokens plus 16 greedy decode steps stay within 1e-3 of the
   largest CPU logit, with greedy tokens equal where the margin exceeds
   that.
10. [xattn]: cross attention, seamless-m4t-large-v2 (enc-dec, its depth
   cut from 24 encoder + 24 decoder layers to 6 + 6) and
   llama-3.2-vision-90b (full width, its depth
   cut from 100 layers to 5: one group of four self layers and a cross
   layer; the W8 artifact of 100 layers outgrows the card). Kernels 1-2
   at the eleven (M, K, N) shapes these give (seamless's 1024x1024,
   1024x8192, 8192x1024 at M = 4 and over the encoder's 4 x 4096 frames,
   M = 16,384; vision's 8192x8192, 8192x1024, 8192x28672, 28672x8192 at
   M = 4 and 8192x1024 at M = 4096), A8 x W{8,4,2}, and kernel 3 on
   1024x8192 split W8 | W4 (A{8,4,2} at M = 4, A8 at M = 16,384), both
   output dtypes and STAGES, identical to the plain version. Each model
   served like qwen2.5-3b at W8A8, W4A8, W4A8 double-buffered and W2A8
   (the cross cache at zero, as the reference's `Engine` leaves it), with
   peak memory; at W4A8 every int dense call of one decode step (6 x 8,
   and 4 x 7 + 1 x 5) and, for seamless, of one encoder layer at M =
   16,384 and one cross_kv_project (6 + 2) identical to the CPU's; a
   profiled decode step; `Model.prefill` of seamless at 4 x 4096 source
   frames and 256 tokens, profiled, beside the bound of its int GEMMs;
   decode against the teacher-forced forward over the cross cache
   `fill_cross_kv` fills (float32, quantization off, within 1e-3 of the
   largest |logit|; W4A8 reported beside it); seamless's plan with every
   dec_layers/mlp/wi split W8 | W4 (kernel 3 must launch) and each CLI at
   W4A8 (vision with ``--layers 5``). At 2 + 2 layers and 64 source
   frames (cut from 4096), float32: seamless's W4A8 artifact packed on
   the card equals the CPU's byte for byte; the forward and 16 decode
   steps over each device's filled cross cache stay within 1e-3 of the
   largest CPU logit, greedy tokens equal where the margin exceeds it.
11. [moe]: Mixture-of-Experts, kimi-k2-1t-a32b (384 experts, top-8) and
   llama4-maverick-400b-a17b (128 experts, top-1), each at full width
   with its depth cut to 1 layer (of 61 and 48: one layer's routed
   experts are 33.8 and 32.2 GB of bfloat16). Kernels 1-2 at the eight
   (K, N) shapes of their attention and shared-expert denses (7168x7168,
   7168x896, 7168x2048, 2048x7168, 5120x5120, 5120x1024, 5120x8192,
   8192x5120) at M = 4, A8 x W{8,4,2}, and kernel 3 on each shared wi
   split W8 | W4 (A{8,4,2}), both output dtypes and STAGES, identical to
   the plain version. Each model served like qwen2.5-3b at W8A8, W4A8,
   W4A8 double-buffered and W2A8 with the packed, expert and embedding
   bytes and peak memory (the packed tree shares the fp tree's router and
   experts, storage checked); at W4A8 every int dense call of one decode
   step (4 attention + 3 shared expert) identical to the CPU's; a
   profiled decode step with the routed experts alone beside the bound
   of streaming them; a plan with layers/moe/shared/wi split W8 | W4
   (kernel 3 must launch); the CLI at W4A8 with ``--layers 1``. At full
   width, 1 layer and the routed experts cut to 16 (kimi) and 8
   (llama4), float32: the W4A8 artifact packed on the card equals the
   CPU's byte for byte; the forward's routing (experts where the k-th and
   (k+1)-th probability differ by over 1e-6, positions and keep up to the
   first token where they do not) equal, its aux within 1e-5, and the
   forward and 16 decode steps within 1e-3 of the largest CPU logit,
   greedy tokens equal where the margin exceeds it. Beside the stand-in,
   kimi-k2-instruct at its published widths (latent attention with
   YaRN, the dense layer and one MoE layer holding 48 of 384 experts,
   W4A8): a 2 x 64-token prefill, its latent cache and 4 decode steps,
   the logits and latents within root-mean-square limits of the plain
   reference's (`tests/plain_ref/mla_moe_lm.py`): the main path (the
   prefill's attention on the fused kernel) within its own limits, the
   same with the attention on `_sdpa` within tighter ones, the
   reference at A4 (the control) outside the main path's.
12. [deploy]: the LM deployment flow, qwen2.5-3b at full width and depth
   from seeded weights drawn on the card. The fp tree (12.4 GB of
   float32) is saved with `repro_torch.ckpt.checkpoint.save` under
   ``build/`` (the free disk printed first) and restored onto the card,
   equal leaf for leaf; the CLI `python -m repro_torch.launch.deploy
   --ckpt ... --budget auto --out ... --artifact ...` calibrates (36
   layers, 2 batches of 2 x 32 tokens), plans, packs and saves the
   artifact; the CLI `python -m repro_torch.launch.serve --ckpt ...
   --plan ...` serves it (8 requests, batch 4, 16 new), its params bytes
   equal to deploy's mixed bytes, qmatmul launched; the artifact,
   restored onto the card, equals `apply_plan` of the same plan over the
   same fp tree leaf for leaf. The files are deleted. At 2 layers of the
   full width, float32 compute, `calibrate` on the card and on the CPU
   agree (a_absmax within 1e-5, sens(b) within 1e-3, relative), and the
   plan from the card's stats, packed on both devices, gives
   byte-identical artifacts.
13. [mesh]: the cluster path on the one card, every mesh position on
   `cuda:0`, positions sharing it each on their own CUDA stream. Kernel
   wall: `api.qconv` and `api.qdot` on meshes (data, model) = (1,1),
   (1,4), (4,1), (2,2), (8,1) at every layer of ResNet-8 W8/W4/W2 (A8)
   on the layer's own input for a wave of 64 (each conv, the conv as its
   im2col GEMM, the head where its N = 10 divides the model axis), both
   pipelines, plus 61 rows / images on the data meshes; every call,
   twice, equal to the meshless call's integers, and one call's dispatch
   shape (shard-local) beside its counted MACs (global). Then ResNet-8
   W8/W4/W2 and W8 double-buffered, mobilenet-tiny W8 (the `qdot`
   lowering, as a mesh forces) and qat-cnn plan (b), 200 images in waves
   of 64 (the last ragged), served meshless and through
   `VisionEngine(mesh=)` on (2,2), (4,1) and (1,1), each mesh twice:
   logits equal meshless, per-device utilization equal to its
   definition, wave p50 / p95 of each printed side by side. qwen2.5-3b
   W4A8 at full width and 12 of 36 layers, 4 requests at batch 4:
   `Engine` meshless and on
   a (2,1) mesh, then the CLI with ``--mesh 2,1`` (its own `mesh:` and
   `cluster utilization:` lines), greedy tokens equal in all three, the
   (2,1) engine's logit rows within 1e-2 x max |row| of the meshless
   ones, and one (2,1) decode step's dense calls (kernel 1 at 2 rows)
   identical to the CPU's plain versions. Kernels 1-2 and 4-5 must have
   launched in the mesh runs alone: the counts are set to 0 just before
   each mesh run and read just after, the meshless baselines and the
   comparisons outside every window. Each net
   again on a (2,2) mesh of CPU positions: one wave's logits equal the
   card's. `ring_decode_attention`, `collective_matmul` (1 x 4) and
   `pipeline_apply` (2 stages) on the card within 1e-4 (relative to the
   largest |y|) of the same calls on CPU meshes, twice; a checkpoint of
   ResNet-8's fp tree saved meshless and restored onto a (2,2) mesh of
   the card (replicated, and split on the last dim) equal leaf for leaf.
14. [tp]: explicit LM tensor parallelism over 'model'
   (`repro_torch.parallel.tp`), every position on `cuda:0`. qwen2.5-3b
   W4A8 at full width and 12 of 36 layers (cut to keep the script
   within its time limit), 4 requests at batch 4: `Engine`
   meshless, then on (1,2) ('tp': kv-head blocks), (1,4) ('gp' weights,
   'cp' over the cache at decode) and (2,2), W4A8 double-buffered on
   (1,2), a plan with every layers/mlp/wi split W8 | W4 on (1,2) (the
   segmented container runs whole, kernel 3), and the CLI with ``--mesh
   2,2``: greedy tokens equal meshless in every run, logit rows within
   1e-2 x max |row|; every packed call of one decode step on (1,2) and
   on (1,4), column slices and row-parallel K-slices (raw int32) on
   every position, identical to the CPU's plain version; one profiled
   (1,2) decode step (wall, busy, idle, kernel 1 launches, the
   reductions' device ms). Then each other family at full width and cut
   depth on (1,2) against its own meshless run, the same checks: kimi
   and llama4 at 1 layer (experts over the positions), seamless at 2 + 2
   layers and 64 source frames, recurrentgemma at 3 layers with its
   window cut to 16 (the ring wraps under 'cp'), mamba2 at 2 layers,
   llama-3.2-vision at 5 (one cross layer). olmo-1b trains 3 steps at
   batch 8 x 256, full width and depth, on (1,2) and (2,2) (step wall,
   tokens/s, peak memory); at 2 layers in float32 its loss and gradients
   on (1,2) and (2,2) are within 1e-5 / 1e-4 x max |g| of meshless on
   the card, and a state stepped on (2,2), saved and restored, steps on
   (2,4) as the meshless run does. Kernels 1 and 3 must launch in the
   tensor-parallel serving runs alone.
15. [qat]: QAT on the card, qat-cnn at full width. Every fake-quant
   function at W{8,4,2} (per-tensor, per-channel, segmented weights;
   EMA and PACT activations with exact ties at 0 and beta) gives the
   CPU's values and gradients bit for bit (a scalar beta's gradient, a
   sum in another order, within 1e-6). The reference's W2 recipe on
   `SyntheticDigits(noise=0.45, jitter=3)`: 400 float steps, PTQ at W2,
   600 W2 QAT steps from the float params; the integer-path QAT accuracy
   must beat PTQ's by more than 0.05 (500 test images). Then the CLI
   `python -m repro_torch.launch.qat --steps 300` (W4 training,
   task-loss calibration, a channel-group plan, saved; the uniform and
   planned deployments evaluated on the card), `fold_check` on its
   result, and its uniform deployment evaluated again with the
   double-buffered kernels (equal accuracy). Kernels 1, 2, 4 and 5 must
   launch in the phase (kernel 3 is not on this path: a segmented conv
   runs one conv per run). The card-trained result, deployed again on
   the CPU, gives byte-identical artifacts and identical integer logits
   for both deployments. Steps/s, training and evaluation images/s and
   both accuracies are printed beside the card's name and power limit.
16. [train]: olmo-1b at full width and depth (16 layers, d 2048, vocab
   50304, bf16 compute, remat) trained by `python -m
   repro_torch.launch.train --steps 20 --batch 8 --seq 256 --ckpt-every
   10` under ``build/`` (the free disk printed first): the loss finite
   and falling. With the step-20 checkpoint removed (a run cut after step
   10), the same command resumes at step 10, replays step 10's batch,
   and its first loss equals the first run's (within 1e-6; later steps
   within 1e-2: the embedding's backward adds with atomics). The
   checkpoint's GB/s from the CLI's own save and restore, one step
   profiled (wall, device busy and idle, top device ops,
   tokens/s, peak memory), 3 steps each with ``--opt-state-bits 8`` and
   ``--qat w4a8``. At 2 of 16 layers, float32, from one CPU-drawn state:
   one step's loss on the card within 1e-4 of the CPU's, its gradients
   within 1e-4 x each leaf's largest |g|, three steps' losses within
   1e-4. The files are deleted.
17. [dryrun]: the dry run (`repro_torch.launch.dryrun`: the step on
   torch's ``meta`` device on the host, no kernel, no card) held against
   what the card held in this run; traced during the build, checked
   after [qat]. olmo-1b meshless at [train]'s full
   width and depth and batch 8 x 256: its ``argument`` bytes of train
   state must equal [train]'s ``state_bytes`` exactly; its predicted
   peak (argument + the step's live allocations) is printed beside the
   profiled step's measured peak, with the ratio (reported, not gated).
   qwen2.5-3b W4A8 decode on (1, 2) at [tp]'s slots and cache length:
   each position's param and cache bytes must equal those of the parts
   `Model.place` / `place_cache` put on the card for [tp]'s served
   (1, 2) engine. Then one production cell, qwen2.5-3b ``decode_32k`` on
   the 16 x 16 pod: its ``PASS`` line and seconds.
18. Times each kernel (CUDA events and profiler device time) beside its
   plain version, its bound, and a PyTorch library call where one
   computes the same function, and prints them as one JSON line. The
   uniform GEMM is timed at the ResNet-8 and qat-cnn heads, 4096x1152x64,
   the reference's fig8 256x2048x256 and 4096x2048x1024, A8 with W8/W4/W2
   ('raw'); its yardstick is `torch._int_mm` on pre-unpacked int8 where
   it takes the shape, else (N = 10) `torch.matmul` in float32 on the
   unpacked integers, exact while |acc| < 2^24. The conv's is
   `torch.nn.functional.conv2d` in bf16, channels-last, on the unpacked
   integers, summed over the wave's convs. Each is the raw product only;
   the port never calls them. Each MobileNet depthwise layer is timed at
   W8A8 under both lowerings beside cuDNN's bf16 channels-last
   ``conv2d(groups=C)`` on its integer input, with the MACs each
   lowering contracts against the real ones. Each of qwen2.5-3b's four
   dense shapes and the recurrent families' six at M = 4, A8 x
   W{8,4,2}, the [xattn] shapes (M = 16,384 among them) and the [moe]
   shapes at M = 4, beside its bound and `torch.matmul` in bf16 on
   dequantized weights.
19. [attn]: the fused attention kernel (``csrc/attn.cu``) against
   `nn/attention.py::_sdpa` in bf16 over causal, windowed and cross
   (S != T) masks, every (Dh, Dv) the registered configs run through
   `attn_core` (16 to 256, Kimi's 192 / 128), G 1, 4 and 8, S 1, 17,
   255 and 1024, within 2^-8 max|v| + 2^-7 |want| (the two round the
   probabilities on either side of the division by their sum); then
   timed at Phi-3-mini's layer (8 x 2048, 32 heads of 96, window 2047)
   and Kimi-K2's (8 x 2048, 64 heads of 192 / 128, causal): device ms
   (profiler) and ms (CUDA events) beside the bound (the causal pairs'
   products at the bf16 peak), the plain `_sdpa` path and, as the
   yardstick the port never calls,
   `torch.nn.functional.scaled_dot_product_attention` (causal).

A ``[phases]`` line gives each phase's seconds (``build``: the wait for
nvcc after [train] and the traces). Standard output is also written to
``chiprun_out/chip_smoke.log``. The last line is
``{"ok": true, "device": {...}}``. Any failure raises,
so the exit code is non-zero and no such line is printed. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
WAVE = 64
REQUESTS = 256
WIDTHS = (8, 4, 2)
BITS = [(a, w) for a in WIDTHS for w in WIDTHS]
EPILOGUES = ("int", "raw", "dequant")
BIG_GEMM = (4096, 1152, 64)
# rows of one block of either GEMM kernel
TILE_M = 128
# (M, K, N) of the uniform GEMM's ragged wall: every K of {1, 31, 33, 64,
# 200, 1000}, N of {1, 10, 17, 100, 128, 200, 384} and M of {1, 64, 100,
# 4096}; the last two are A8 grids of more 128 x 128 tiles than the card
# has SMs, which the plan runs at two blocks per SM (16-byte weight rows,
# then a ragged M and N with 4-byte rows)
# (tests/test_torch_cuda.py holds the same wall)
GEMM_WALL = ((1, 1, 1), (64, 31, 10), (100, 33, 17), (4096, 64, 100),
             (64, 200, 128), (100, 1000, 200), (1, 64, 384),
             (4096, 1000, 10), (64, 33, 384), (100, 200, 1),
             (4096, 200, 17), (1, 1000, 128), (4096, 200, 1024),
             (4100, 1000, 1000))
# published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
REPLACES = {
    ("qmatmul", 1): "src/repro/kernels/qmatmul/kernel.py:61",
    ("qmatmul", 2): "src/repro/kernels/qmatmul/kernel.py:81",
    ("qconv", 1): "src/repro/kernels/qconv/kernel.py:64",
    ("qconv", 2): "src/repro/kernels/qconv/kernel.py:108",
    # one Pallas body for both pipeline modes
    ("qmatmul_segmented", 1): "src/repro/kernels/qmatmul/kernel.py:234",
    ("qmatmul_segmented", 2): "src/repro/kernels/qmatmul/kernel.py:234",
}
PIPELINE = {1: "off", 2: "double_buffer"}
# qat-cnn's c3 under plan (a): channels [0, 128) at W8, [128, 256) at W4
PLAN_A = ((0, 128, 8), (128, 256, 4))
# kernel 3's shapes (M, K, N) and segment runs: the ragged case per mix,
# the reference's fig8 row, one larger GEMM for timing; `c3_gemm` gives
# c3 as a GEMM at a wave (the main path's qdot call)
SEG_MIXES = ((8, 4), (8, 2), (4, 2), (8, 4, 2))
SEG_RAGGED = (100, 200, 320)
SEG_FIG8 = ((256, 2048, 256), ((0, 128, 8), (128, 256, 2)))
SEG_BIG = ((4096, 2048, 1024), ((0, 384, 8), (384, 768, 4), (768, 1024, 2)))
SEG_RAGGED_RUN = ((40, 200, 200), ((0, 128, 2), (128, 200, 8)))
# (images, H, W, Cin, Cout, f, stride, padding): conv shapes the
# real-channel K order makes risky, checked but not timed; the last two
# are the depthwise per-group lowering's cin = cout = 1 convs
WALL_CONVS = ((2, 9, 7, 1, 10, 5, 1, 2), (2, 11, 9, 3, 48, 3, 1, 1),
              (2, 8, 8, 160, 200, 3, 2, 1), (2, 9, 9, 200, 48, 1, 2, 0),
              (1, 7, 13, 3, 200, 5, 1, 2), (2, 8, 8, 1, 1, 3, 1, 1),
              (2, 8, 8, 1, 1, 3, 2, 1))
LOWERINGS = ("qdot", "per_group")


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, warmup: int, iters: int) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls."""
    import torch
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


def max_abs_err(got, want) -> float:
    import torch
    if got.dtype == torch.bfloat16:
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            return float((got.float() - want.float()).abs().max())
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max())


class Case:
    """One kernel call at one shape: random packed operands on the card,
    the kernel at both stage counts and the plain version."""

    def __init__(self, kind, shape, a_bits, w_bits, epilogue, gen, dev):
        import torch
        from repro_torch.core import packing
        from repro_torch.kernels.qconv import kernel as ck

        self.kind, self.shape = kind, shape
        self.a_bits, self.w_bits, self.epilogue = a_bits, w_bits, epilogue

        def ints(bits, signed, size):
            lo, hi = packing.int_range(bits, signed)
            return torch.randint(lo, hi + 1, size, generator=gen,
                                 dtype=torch.int32).to(torch.int8).to(dev)

        if kind == "qmatmul":
            # K zero-padded to a CHUNK multiple, as `qdot` pads it, and
            # contracted over the real K, as `qdot` calls it
            m, k, n = shape
            self.x = packing.pack(packing.pad_to_chunk(
                ints(a_bits, False, (m, k)), axis=-1), a_bits)
            cout = n
            self.w = packing.pack(packing.pad_to_chunk(
                ints(w_bits, True, (k, n)), axis=0), w_bits, axis=0)
            self.kw = {"k_logical": k}
        else:
            b, h, w_, cin, cout, f, s, p = shape
            cin_pad = packing.padded_size(cin)
            wt = torch.nn.functional.pad(ints(w_bits, True, (f * f, cin,
                                                             cout)),
                                         (0, 0, 0, cin_pad - cin))
            self.w = packing.pack(wt.reshape(-1, cout), w_bits, axis=0)
            # the kernel takes the image unpadded, through the wrapper
            # (which copies only what its copy granule demands); the plain
            # version the reference's padded, packed copy
            self.x_hat = ints(a_bits, False, (b, h, w_, cin))
            self.x = ck.pad_and_pack(self.x_hat, padding=p, cin_pad=cin_pad,
                                     a_bits=a_bits)
            ho, wo = ck.conv_out_hw(h, w_, f, f, s, p)
            self.kw = dict(fh=f, fw=f, stride=s, ho=ho, wo=wo,
                           cin_pad=cin_pad, cout=cout)
            self.padding = p
        self.vecs = (
            torch.randint(-127, 128, (cout,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.randint(-2**20, 2**20, (cout,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.randint(0, 2**15, (cout,), generator=gen,
                          dtype=torch.int32).to(dev))
        self.kw.update(a_bits=a_bits, a_signed=False, w_bits=w_bits, d=23,
                       out_bits=a_bits, epilogue=epilogue, scale=0.0123)
        # the GEMM's launch (a `GemmLaunch`); None: the planned one
        self.plan = None

    def launches(self):
        """The GEMM's planned launch, then those the plan did not choose:
        K unsplit, and at A8 with the 128-wide tile the other register
        budget."""
        from repro_torch.kernels.qmatmul import kernel as gk
        m, k, n = self.shape
        sms = gk.sm_count(self.x.device)
        plan = gk.gemm_launch_plan(m, n, k, self.a_bits, sms)
        out = [plan]
        if plan.splits > 1:
            out.append(gk.gemm_launch_plan(m, n, k, self.a_bits, sms,
                                           splits=1))
        if self.a_bits == 8 and plan.nt == 128:
            out.append(gk.gemm_launch_plan(
                m, n, k, self.a_bits, sms, splits=plan.splits,
                min_blocks=3 - plan.min_blocks))
        return out

    def kernel(self, stages: int):
        from repro_torch.kernels.qconv import kernel as ck
        from repro_torch.kernels.qmatmul import kernel as gk
        if self.kind == "qmatmul":
            return gk._launch_packed(self.x, self.w, *self.vecs, self.plan,
                                     pipeline=PIPELINE[stages], **self.kw)
        kw = {k: v for k, v in self.kw.items() if k not in ("ho", "wo")}
        return ck.qconv2d_fused(self.x_hat, self.w, *self.vecs,
                                padding=self.padding,
                                pipeline=PIPELINE[stages], **kw)

    def plain(self):
        from repro_torch.kernels.qconv import kernel as ck
        from repro_torch.kernels.qmatmul import kernel as gk
        fn = (gk.qmatmul_packed_torch if self.kind == "qmatmul"
              else ck.qconv_packed_torch)
        return fn(self.x, self.w, *self.vecs, **self.kw)

    def bound(self):
        """(bytes ms, operations ms) at the published peaks, for the work
        the function needs (as `repro.obs.counters` counts packed bytes):
        the unpadded operands at real Cin or K, packed to their widths and
        read once; the epilogue's per-channel vectors only where it reads
        them ('int': kappa, lambda, m; a scalar dequant scale is none);
        the output written once; ops = 2 x real MACs."""
        out_item = {"int": 1, "raw": 4, "dequant": 2}[self.epilogue]
        a, w = self.a_bits / 8, self.w_bits / 8
        if self.kind == "qmatmul":
            m, k, n = self.shape
            cout, macs, nout = n, m * k * n, m * n
            nbytes = m * k * a + k * n * w
        else:
            b, h, w_, cin, cout, f, s, p = self.shape
            ho, wo = self.kw["ho"], self.kw["wo"]
            macs, nout = b * ho * wo * f * f * cin * cout, b * ho * wo * cout
            nbytes = b * h * w_ * cin * a + f * f * cin * cout * w
        if self.epilogue == "int":
            nbytes += 3 * 4 * cout
        nbytes += nout * out_item
        return nbytes / PEAK_BYTES * 1e3, 2 * macs / PEAK_INT8_OPS * 1e3

    def real_macs(self):
        b, h, w_, cin, cout, f, s, p = self.shape
        return b * self.kw["ho"] * self.kw["wo"] * f * f * cin * cout

    def contracted_macs(self):
        """MACs the conv kernel issues: output pixels x the plan's K
        (real channels, each stage rounded up to 32) x Cout rounded up to
        the kernel's column tile."""
        from repro_torch.kernels.qconv import kernel as ck
        b, h, w_, cin, cout, f, s, p = self.shape
        k = ck.conv_k_plan(f, f, cin, self.a_bits, self.w_bits,
                           ck.conv_stage_k(cout)).k_contracted
        nt = ck.conv_tile_n(cout)
        return b * self.kw["ho"] * self.kw["wo"] * k * (-(-cout // nt) * nt)

    def library(self):
        """A closure: the raw conv product of this shape by
        `torch.nn.functional.conv2d` in bf16, channels-last, on unpacked
        integers (a timing yardstick only; the port never calls it)."""
        import torch
        b, h, w_, cin, cout, f, s, p = self.shape
        dev = self.x.device
        x = torch.randint(0, 128, (b, cin, h, w_), device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = torch.randint(-8, 8, (cout, cin, f, f), device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        return lambda: torch.nn.functional.conv2d(x, w, stride=s, padding=p)


def mix_runs(widths, n):
    """One run per width: interior boundaries every CHUNK, the last run
    takes the rest (ragged when N is not a CHUNK multiple)."""
    runs, pos = [], 0
    for i, b in enumerate(widths):
        end = n if i == len(widths) - 1 else pos + 128
        runs.append((pos, end, b))
        pos = end
    return tuple(runs)


class SegCase:
    """One mixed-operand GEMM at one shape: random segmented weights
    packed panel-major and padded to whole panels (as `qdot` pads them),
    the kernel at both stage counts and the plain version."""

    kind = "qmatmul_segmented"

    def __init__(self, shape, runs, a_bits, epilogue, gen, dev,
                 vec_scale=False):
        import torch
        from repro_torch.core import packing

        self.shape, self.runs = shape, tuple(runs)
        self.a_bits, self.epilogue = a_bits, epilogue
        m, k, n = shape

        def ints(bits, signed, size):
            lo, hi = packing.int_range(bits, signed)
            return torch.randint(lo, hi + 1, size, generator=gen,
                                 dtype=torch.int32).to(torch.int8).to(dev)

        segmap = packing.SegmentMap(self.runs)
        w = torch.cat([ints(b, True, (k, e - s)) for s, e, b in self.runs],
                      dim=1)
        self.w, self.segmap = packing.pad_segmented(
            packing.pack_segmented(w, segmap), segmap, k)
        self.x = packing.pack(packing.pad_to_chunk(
            ints(a_bits, False, (m, k)), axis=-1), a_bits)
        n_pad = self.segmap.n
        self.vecs = (
            torch.randint(-127, 128, (n_pad,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.randint(-2**20, 2**20, (n_pad,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.randint(0, 2**15, (n_pad,), generator=gen,
                          dtype=torch.int32).to(dev))
        scale = (torch.rand(n_pad, generator=gen).to(dev) * 0.1 + 1e-3
                 if vec_scale else 0.0123)
        self.kw = dict(k_logical=k, a_bits=a_bits, a_signed=False, d=23,
                       out_bits=a_bits, epilogue=epilogue, scale=scale)

    def kernel(self, stages: int):
        from repro_torch.kernels.qmatmul import kernel as gk
        return gk.qmatmul_segmented_cuda(self.x, self.w, self.segmap,
                                         *self.vecs,
                                         pipeline=PIPELINE[stages],
                                         **self.kw)

    def plain(self):
        from repro_torch.kernels.qmatmul import kernel as gk
        return gk.qmatmul_segmented_torch(self.x, self.w, self.segmap,
                                          *self.vecs, **self.kw)

    def bound(self):
        """(bytes ms, operations ms) for the work the function needs:
        activations at real K packed to a_bits, each run's weights at
        real K and N packed to its width, the epilogue vectors where
        'int' reads them, the output once; ops = 2 x real MACs."""
        m, k, n = self.shape
        nbytes = m * k * self.a_bits / 8 + sum(
            k * (e - s) * b / 8 for s, e, b in self.runs)
        if self.epilogue == "int":
            nbytes += 3 * 4 * n
        nbytes += m * n * {"int": 1, "raw": 4, "dequant": 2}[self.epilogue]
        return nbytes / PEAK_BYTES * 1e3, 2 * m * k * n / PEAK_INT8_OPS * 1e3


def c3_gemm(wave: int):
    """((M, K, N), runs) of qat-cnn's c3 under plan (a) as an im2col GEMM
    over a wave of images: M = wave x Ho x Wo, K = 3 x 3 x Cin."""
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import trace_shapes
    t = [t for t in trace_shapes(get_vision_config("qat-cnn"))
         if t["layer"].path == "c3"][0]
    (h, w, c), (ho, wo, cout) = t["in"], t["out"]
    L = t["layer"]
    return (wave * ho * wo, L.fh * L.fw * c, cout), PLAN_A


def segmented_kernel_phase(dev, report):
    """Kernel 3 against its plain version at both STAGES, exactly."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    shapes = ([(SEG_RAGGED, mix_runs(w, SEG_RAGGED[2])) for w in SEG_MIXES]
              + [SEG_RAGGED_RUN, SEG_FIG8, c3_gemm(WAVE)])
    worst = {1: 0.0, 2: 0.0}
    n_cmp = 0
    for shape, runs in shapes:
        for a_bits in WIDTHS:
            for epi in EPILOGUES:
                case = SegCase(shape, runs, a_bits, epi, gen, dev,
                               vec_scale=(epi == "dequant"
                                          and shape == SEG_RAGGED))
                want = case.plain()
                for stages in (1, 2):
                    err = max_abs_err(case.kernel(stages), want)
                    torch.cuda.synchronize()
                    worst[stages] = max(worst[stages], err)
                    n_cmp += 1
                    if err != 0.0:
                        raise AssertionError(
                            f"qmatmul_segmented STAGES={stages} A{a_bits} "
                            f"{runs} {epi} at {shape}: max abs err {err}")
    say("kernels", kernel="qmatmul_segmented", compared=n_cmp,
        shapes=len(shapes), all_exact=True)
    report["segmented_kernel_phase"] = {
        "comparisons": n_cmp,
        "cases": [[list(s), [list(r) for r in runs]] for s, runs in shapes]}
    return worst


def net_shapes(cfg, wave):
    """The kernel calls of one wave of the net: "convs", (layer path, conv
    shape) per conv; "dw_gemms", (path, (M, real K, N)) per depthwise
    layer's block-diagonal GEMM (the 'qdot' lowering); "dw_convs", (path,
    shape) of its per-channel convs (the 'per_group' lowering, cin = cout
    = 1, one call per channel); "head", the head GEMM (M, real K, N)."""
    from repro_torch.vision.models import trace_shapes
    out = {"convs": [], "dw_gemms": [], "dw_convs": [], "head": None}
    for t in trace_shapes(cfg):
        L, (h, w, c), (ho, wo, _) = t["layer"], t["in"], t["out"]
        if L.kind == "conv":
            out["convs"].append((L.path, (wave, h, w, c, L.cout, L.fh,
                                          L.stride, L.padding)))
        elif L.kind == "dwconv":
            out["dw_gemms"].append((L.path, (wave * ho * wo,
                                             L.fh * L.fw * c, c)))
            out["dw_convs"].append((L.path, (wave, h, w, 1, 1, L.fh,
                                             L.stride, L.padding)))
        elif L.kind == "linear":
            out["head"] = (wave, c, L.cout)
    return out


def kernel_phase(dev, nets, report):
    """qmatmul and qconv at every call shape of the served nets' waves
    (``nets``: `net_shapes` per net), the larger GEMM, the ragged GEMM
    wall and the conv wall."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    worst = {(k, s): 0.0 for k in ("qmatmul", "qconv") for s in (1, 2)}
    gemms = [n["head"] for n in nets] + [BIG_GEMM] + [
        s for n in nets for _, s in n["dw_gemms"]] + list(GEMM_WALL)
    convs = [s for n in nets for key in ("convs", "dw_convs")
             for _, s in n[key]] + list(WALL_CONVS)
    shapes = ([("qmatmul", s) for s in dict.fromkeys(gemms)]
              + [("qconv", s) for s in dict.fromkeys(convs)])
    n_cmp, n_split, n_two = 0, 0, 0
    for kind, shape in shapes:
        for a_bits, w_bits in BITS:
            for epi in EPILOGUES:
                case = Case(kind, shape, a_bits, w_bits, epi, gen, dev)
                want = case.plain()
                # the GEMM at its planned launch and the others
                plans = case.launches() if kind == "qmatmul" else [None]
                for stages in (1, 2):
                    for plan in plans:
                        case.plan = plan
                        err = max_abs_err(case.kernel(stages), want)
                        torch.cuda.synchronize()
                        worst[(kind, stages)] = max(worst[(kind, stages)],
                                                    err)
                        n_cmp += 1
                        n_split += plan is not None and plan.splits > 1
                        n_two += plan is not None and plan.min_blocks == 2
                        if err != 0.0:
                            raise AssertionError(
                                f"{kind} STAGES={stages} A{a_bits}W{w_bits}"
                                f" {epi} at {shape} {plan}: max abs err "
                                f"{err}")
    say("kernels", compared=n_cmp, split_k=n_split, two_blocks_per_sm=n_two,
        shapes=len(shapes), all_exact=True)
    report["kernel_phase"] = {"comparisons": n_cmp, "split_k": n_split,
                              "two_blocks_per_sm": n_two,
                              "shapes": [list(s) for _, s in shapes]}
    return worst


def first_difference(a, b, path="net"):
    """Path of the first field where two artifacts differ, tensors byte
    for byte (dtype, shape and bits), or None when they are identical."""
    import dataclasses
    import torch
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.dtype != b.dtype \
                or a.shape != b.shape:
            return path
        same = torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
        return None if same else path
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if type(a) is not type(b):
            return path
        pairs = [(getattr(a, f.name), getattr(b, f.name), f".{f.name}")
                 for f in dataclasses.fields(a)]
    elif isinstance(a, (tuple, list)):
        if not isinstance(b, (tuple, list)) or len(a) != len(b):
            return path
        pairs = [(x, y, f"[{i}]") for i, (x, y) in enumerate(zip(a, b))]
    elif isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return path
        pairs = [(a[k], b[k], f"[{k!r}]") for k in a]
    else:
        return None if a == b else path
    for x, y, sub in pairs:
        diff = first_difference(x, y, path + sub)
        if diff is not None:
            return diff
    return None


def ptxas_report(kernels):
    """Each kernel instantiation's registers, shared memory and spills
    from its build's ptxas report; prints one summary line per source."""
    import re
    out = {}
    for name, k in kernels.items():
        rows, fn = {}, None
        for line in k.build_log().read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                rows.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + \
                    int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                smem = re.search(r"(\d+) bytes smem", line)
                rows.setdefault(fn, {}).update(
                    registers=int(m.group(1)),
                    static_smem=int(smem.group(1)) if smem else 0)
        out[name] = rows
        regs = [r["registers"] for r in rows.values() if "registers" in r]
        say("ptxas", source=f"{name}.cu", kernels=len(rows),
            registers=f"{min(regs)}-{max(regs)}" if regs else None,
            spill_bytes_max=max((r.get("spill_bytes", 0)
                                 for r in rows.values()), default=0))
    return out


def kernels_by_name():
    from repro_torch.kernels.attn.kernel import KERNEL as ATTN
    from repro_torch.kernels.qconv.kernel import KERNEL as QCONV
    from repro_torch.kernels.qmatmul.kernel import KERNEL as QMATMUL
    from repro_torch.kernels.qmatmul.kernel import SEGMENTED_KERNEL
    return {"qmatmul": QMATMUL, "qconv": QCONV,
            "qmatmul_segmented": SEGMENTED_KERNEL, "attn": ATTN}


def reset_launches():
    for k in kernels_by_name().values():
        k.reset_launches()


def read_launches():
    return {name: dict(k.launches) for name, k in kernels_by_name().items()}


def require_launches(path, launches, names, stages_needed=(1, 2)):
    """Fail unless every stage count of ``stages_needed`` of each named
    kernel launched in the window of ``path``; print the window's
    counts."""
    for name in names:
        for stages, n in launches[name].items():
            if n == 0 and stages in stages_needed:
                raise AssertionError(f"{name} STAGES={stages} never "
                                     f"launched on the {path} main path")
    say("launches", path=path, **{f"{k}_s{s}": n
                                  for k, c in launches.items()
                                  for s, n in c.items()})


def main_path(dev, cfg, report):
    """Serve full-width ResNet-8 at W8/W4/W2 through the port; returns the
    kernels' launch counts over exactly this run."""
    import numpy as np
    from repro_torch.convert import to_device
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision.models import (collect_absmax, init_fp,
                                           quantize_net)

    rng = np.random.default_rng(SEED)
    fp = init_fp(cfg, seed=SEED, device=dev)
    calib = [rng.uniform(0, 1, size=(WAVE, *cfg.in_hw, cfg.in_ch)).astype(
        np.float32) for _ in range(2)]
    absmax = collect_absmax(cfg, fp, calib)
    images = rng.uniform(0, 1, size=(REQUESTS, *cfg.in_hw, cfg.in_ch)
                         ).astype(np.float32)
    plans = {w_bits: uniform_plan(cfg, w_bits, cfg.a_bits)
             for w_bits in WIDTHS}
    nets = {w_bits: quantize_net(cfg, fp, absmax, plan=plan, device=dev)
            for w_bits, plan in plans.items()}
    # the kernels' double-buffered pipeline, through the plan's hint
    qdb = quantize_net(cfg, fp, absmax,
                       plan=uniform_plan(cfg, 8, cfg.a_bits,
                                         pipeline="double_buffer"),
                       device=dev)
    # one untimed wave first: torch loads its own CUDA kernels lazily
    VisionEngine(nets[8], batch_size=WAVE, device=dev).run(images[:WAVE])
    reset_launches()
    served = {w_bits: serve_net(f"resnet8 W{w_bits}", qnet, images, report)
              for w_bits, qnet in nets.items()}
    db = VisionEngine(qdb, batch_size=WAVE, device=dev).run(images[:WAVE])
    launches = read_launches()
    if not np.array_equal(db, served[8][:WAVE]):
        raise AssertionError("double_buffer wave differs from 'off'")
    say("serve", pipeline="double_buffer", images=WAVE, logits_equal=True)
    # the same fp weights and absmax quantized on the CPU must give the
    # card's artifact byte for byte; its plain torch run, the same logits
    fp_cpu = to_device(fp, "cpu")
    for w_bits, qnet in nets.items():
        check_against_cpu(f"resnet8 W{w_bits}", qnet, cfg, fp_cpu, absmax,
                          plans[w_bits], images, served[w_bits])
    require_launches("resnet8", launches, ("qmatmul", "qconv"))
    report.setdefault("launches", {})["resnet8"] = launches
    profile_wave(dev, nets[8], images[:WAVE], report, "resnet8 W8")
    return launches


def serve_net(name, qnet, images, report):
    """Serve ``images`` in waves of WAVE; print and record the [serve]
    line; return the host logits."""
    import numpy as np
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision.models import streamed_weight_bytes
    engine = VisionEngine(qnet, batch_size=WAVE, device=qnet.device)
    t0 = time.perf_counter()
    logits = engine.run(images)              # returns host arrays: synced
    wall = time.perf_counter() - t0
    if logits.shape != (len(images), qnet.cfg.num_classes) or \
            logits.dtype != np.int32:
        raise AssertionError(f"{name}: logits {logits.shape} {logits.dtype}")
    waves = engine.utilization_report()["latency_us"]
    req = engine.serving_report()["latency"]
    say("serve", net=name, images=len(images), wave=WAVE,
        images_per_s=round(len(images) / wall, 1),
        wave_p50_ms=round(waves["p50"] / 1e3, 3),
        wave_p95_ms=round(waves["p95"] / 1e3, 3),
        request_p50_ms=round(req["p50"] * 1e3, 3),
        request_p95_ms=round(req["p95"] * 1e3, 3),
        streamed_weight_bytes=streamed_weight_bytes(qnet))
    report.setdefault("serve", {})[name] = {
        "images_per_s": len(images) / wall, "wall_s": wall,
        "wave_latency_us": waves, "request_latency_s": req,
        "streamed_weight_bytes": streamed_weight_bytes(qnet)}
    return logits


def check_against_cpu(name, qnet, cfg, fp_cpu, absmax, plan, images,
                      served):
    """Quantize the same fp weights, absmax and plan on the CPU: the
    artifact must be byte-identical to the card's, and its plain run must
    give the served logits."""
    import numpy as np
    from repro_torch.convert import to_device
    from repro_torch.vision.models import (forward_int, quantize_input,
                                           quantize_net)
    cpu = quantize_net(cfg, fp_cpu, absmax, plan=plan, device="cpu")
    diff = first_difference(to_device(qnet, "cpu"), cpu)
    if diff is not None:
        raise AssertionError(f"{name}: the artifact quantized on the card "
                             f"differs from the CPU's at {diff}")
    want = np.concatenate([
        forward_int(cpu, quantize_input(cpu, images[i:i + WAVE])).numpy()
        for i in range(0, len(images), WAVE)])
    if not np.array_equal(served, want):
        bad = int((served != want).any(-1).sum())
        raise AssertionError(f"{name}: {bad} images' logits differ from "
                             "the CPU plain path")
    say("check", net=name, artifact_equal_cpu=True,
        logits_equal_cpu_plain=True,
        argmax_classes=len(set(want.argmax(-1).tolist())))


def c3_segmented_params(qnet, layer="c3"):
    """`SegmentedLinearParams` of a `QSegmentedConv2D`'s runs, built by
    `quantize_linear_segmented` from each run's integer weights and
    epilogue vectors (one shift d: the first run's)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.core.quantize import quantize_linear_segmented
    seg = dict((L.path, q) for L, q in qnet.qlayers)[layer]
    gemms = [p.conv.gemm for p in seg.parts]
    k = gemms[0].k_logical
    w_hat = torch.cat([packing.unpack(g.w_packed, g.w_bits, True,
                                      axis=0)[:k] for g in gemms], dim=1)
    return seg, quantize_linear_segmented(
        w_hat, packing.SegmentMap(seg.runs),
        torch.cat([g.kappa for g in gemms]), torch.cat([g.lam for g in gemms]),
        torch.cat([g.m for g in gemms]), a_bits=gemms[0].a_bits,
        a_signed=gemms[0].a_signed, d=gemms[0].d,
        out_bits=gemms[0].out_bits, assert_range=True)


def qat_cnn_path(dev, report):
    """Serve full-width qat-cnn under plans (a) and (b) and call `qdot`
    on segmented params; returns the kernels' launch counts over exactly
    this run."""
    import numpy as np
    import torch
    from repro_torch.convert import to_device
    from repro_torch.deploy.calibrate import calibrate_vision
    from repro_torch.deploy.planner import auto_budget, plan_mixed_precision
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.kernels import api
    from repro_torch.kernels.qconv.ops import im2col_hwc
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (forward_int, init_fp,
                                           quantize_input, quantize_net)

    cfg = get_vision_config("qat-cnn")
    rng = np.random.default_rng(SEED)
    fp = init_fp(cfg, seed=SEED, device=dev)
    calib = [rng.uniform(0, 1, size=(WAVE, *cfg.in_hw, cfg.in_ch)).astype(
        np.float32) for _ in range(2)]
    images = rng.uniform(0, 1, size=(REQUESTS, *cfg.in_hw, cfg.in_ch)
                         ).astype(np.float32)
    stats, absmax = calibrate_vision(cfg, fp, calib)
    budget = auto_budget(stats)
    plans = {
        "a": PrecisionPlan(rules=(PlanRule(pattern="c3", w_bits=8,
                                           segments=PLAN_A),)),
        "b": plan_mixed_precision(stats, budget,
                                  granularity="channel_group",
                                  meta={"arch": cfg.name}),
    }
    for r in plans["b"].rules:
        say("plan_b", layer=r.pattern, w_bits=r.w_bits,
            segments=json.dumps(r.segments),
            sens=json.dumps({b: round(stats[r.pattern].sens(b), 6)
                             for b in WIDTHS}))
    say("plan_b", budget=round(budget, 6),
        granularity=plans["b"].meta.get("granularity", "layer"),
        packed_weight_bytes=plans["b"].meta["packed_weight_bytes"],
        uniform_w8_bytes=plans["b"].meta["uniform_w8_bytes"])
    report["qat_cnn_plan_b"] = json.loads(plans["b"].to_json())
    plan_db = PrecisionPlan(rules=(
        PlanRule(pattern="c3", w_bits=8, segments=PLAN_A,
                 pipeline="double_buffer"),
        PlanRule(pattern="*", w_bits=8, pipeline="double_buffer")))
    nets = {k: quantize_net(cfg, fp, absmax, plan=p, device=dev)
            for k, p in plans.items()}
    qdb = quantize_net(cfg, fp, absmax, plan=plan_db, device=dev)
    # c3's input images for the qdot call, and one untimed wave
    edges = {}
    forward_int(nets["a"], quantize_input(nets["a"], images[:WAVE]),
                collect=lambda k, v: edges.setdefault(k, v))
    seg, params = c3_segmented_params(nets["a"])
    x_c3 = edges["p2"]
    x_cols = im2col_hwc(x_c3, 3, 3, 1, 1)[0].reshape(-1, params.k_logical)

    reset_launches()
    served = {k: serve_net(f"qat-cnn plan ({k})", q, images, report)
              for k, q in nets.items()}
    db = serve_net("qat-cnn plan (a) double_buffer", qdb, images[:WAVE],
                   report)
    raw = {pl: api.qdot(params, x_cols, epilogue="raw", pipeline=pl)
           for pl in ("off", "double_buffer")}
    out_int = api.qdot(params, x_cols, epilogue="int")
    torch.cuda.synchronize()
    launches = read_launches()

    if not np.array_equal(db, served["a"][:WAVE]):
        raise AssertionError("qat-cnn: double_buffer wave differs from off")
    fp_cpu = to_device(fp, "cpu")
    for k, q in nets.items():
        check_against_cpu(f"qat-cnn plan ({k})", q, cfg, fp_cpu, absmax,
                          plans[k], images, served[k])
    # the mixed GEMM's raw accumulators are c3's per-run conv accumulators
    want_raw = torch.cat([api.qconv(p.conv, x_c3, epilogue="raw")
                          for p in seg.parts], dim=-1)
    want_raw = want_raw.reshape(raw["off"].shape)
    for pl, got in raw.items():
        if not torch.equal(got, want_raw):
            raise AssertionError(f"qdot on SegmentedLinearParams ({pl}) "
                                 "differs from c3's per-run qconv")
    want_int = api.qdot(to_device(params, "cpu"), x_cols.cpu(),
                        epilogue="int")
    if not torch.equal(out_int.cpu(), want_int):
        raise AssertionError("qdot on SegmentedLinearParams ('int') "
                             "differs from the CPU plain path")
    say("check", qdot_segmented=list(x_cols.shape) + [params.n],
        runs=json.dumps(seg.runs), raw_equal_qconv_runs=True,
        int_equal_cpu_plain=True)
    require_launches("qat-cnn", launches,
                     ("qmatmul", "qconv", "qmatmul_segmented"))
    report.setdefault("launches", {})["qat-cnn"] = launches
    for k, q in nets.items():
        profile_wave(dev, q, images[:WAVE], report, f"qat-cnn plan ({k})")
    return launches


def mobilenet_path(dev, report):
    """Serve full-width mobilenet-tiny at W8/W4/W2 and under the plan that
    `calibrate_vision` + `plan_mixed_precision` give on the card, one
    more wave with the double-buffered pipeline, and one wave of each net
    forced through each depthwise lowering. Returns the kernels' launch
    counts over exactly this run, the W8 net and its wave's input."""
    import numpy as np
    import torch
    from repro_torch.convert import to_device
    from repro_torch.deploy.calibrate import calibrate_vision
    from repro_torch.deploy.planner import auto_budget, plan_mixed_precision
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (forward_int, init_fp,
                                           quantize_input, quantize_net)

    cfg = get_vision_config("mobilenet-tiny")
    rng = np.random.default_rng(SEED)
    fp = init_fp(cfg, seed=SEED, device=dev)
    calib = [rng.uniform(0, 1, size=(WAVE, *cfg.in_hw, cfg.in_ch)).astype(
        np.float32) for _ in range(2)]
    images = rng.uniform(0, 1, size=(REQUESTS, *cfg.in_hw, cfg.in_ch)
                         ).astype(np.float32)
    stats, absmax = calibrate_vision(cfg, fp, calib, bits=WIDTHS,
                                     a_bits=cfg.a_bits)
    budget = auto_budget(stats, WIDTHS)
    plans = {f"W{b}": uniform_plan(cfg, b, cfg.a_bits) for b in WIDTHS}
    plans["planner"] = plan_mixed_precision(
        stats, budget, candidates=WIDTHS, a_bits=cfg.a_bits,
        meta={"arch": cfg.name})
    for r in plans["planner"].rules:
        st = stats[r.pattern]
        say("plan_mobilenet", layer=r.pattern, w_bits=r.w_bits,
            d_in=st.d_in, d_out=st.d_out,
            sens=json.dumps({b: round(st.sens(b), 6) for b in WIDTHS}))
    say("plan_mobilenet", budget=round(budget, 6),
        packed_weight_bytes=plans["planner"].meta["packed_weight_bytes"],
        uniform_w8_bytes=plans["planner"].meta["uniform_w8_bytes"])
    report["mobilenet_plan"] = json.loads(plans["planner"].to_json())
    nets = {k: quantize_net(cfg, fp, absmax, plan=p, device=dev)
            for k, p in plans.items()}
    qdb = quantize_net(cfg, fp, absmax,
                       plan=uniform_plan(cfg, 8, cfg.a_bits,
                                         pipeline="double_buffer"),
                       device=dev)
    x_wave = quantize_input(nets["W8"], images[:WAVE])
    # one untimed wave first: torch loads its own CUDA kernels lazily
    VisionEngine(nets["W8"], batch_size=WAVE, device=dev).run(images[:WAVE])

    reset_launches()
    served = {k: serve_net(f"mobilenet-tiny {k}", q, images, report)
              for k, q in nets.items()}
    db = VisionEngine(qdb, batch_size=WAVE, device=dev).run(images[:WAVE])
    forced = {}
    for k, q in nets.items():
        for low in LOWERINGS:
            edges = {}
            logits = forward_int(q, x_wave, lowering=low,
                                 collect=lambda p, v, e=edges:
                                 e.setdefault(p, v))
            forced[(k, low)] = (edges, logits)
    torch.cuda.synchronize()
    launches = read_launches()

    if not np.array_equal(db, served["W8"][:WAVE]):
        raise AssertionError("mobilenet-tiny: double_buffer wave differs "
                             "from 'off'")
    say("serve", net="mobilenet-tiny W8", pipeline="double_buffer",
        images=WAVE, logits_equal=True)
    for k in nets:
        (e_q, l_q), (e_g, l_g) = (forced[(k, low)] for low in LOWERINGS)
        dw = [p for p in e_q if p.endswith("/dw")]
        for path in e_q:
            if not torch.equal(e_q[path], e_g[path]):
                raise AssertionError(f"mobilenet-tiny {k}: the lowerings' "
                                     f"integer edges differ at {path}")
        for low, got in ((LOWERINGS[0], l_q), (LOWERINGS[1], l_g)):
            if not np.array_equal(got.cpu().numpy(), served[k][:WAVE]):
                raise AssertionError(f"mobilenet-tiny {k}: the wave forced "
                                     f"through {low} differs from the "
                                     "served logits")
        say("check", net=f"mobilenet-tiny {k}", lowerings_identical=True,
            dw_layers=len(dw), edges=len(e_q), logits_equal_served=True)
    fp_cpu = to_device(fp, "cpu")
    for k, q in nets.items():
        check_against_cpu(f"mobilenet-tiny {k}", q, cfg, fp_cpu, absmax,
                          plans[k], images, served[k])
    require_launches("mobilenet-tiny", launches, ("qmatmul", "qconv"))
    report.setdefault("launches", {})["mobilenet-tiny"] = launches
    profile_wave(dev, nets["W8"], images[:WAVE], report,
                 "mobilenet-tiny W8")
    return launches, nets["W8"], x_wave


def depthwise_timing_phase(dev, qnet, x_wave, report):
    """Each depthwise layer of the W8A8 net at a wave: both lowerings'
    ms (CUDA events, host included), device ms of every kernel the call
    runs and of the port's kernels alone, beside cuDNN's bf16
    channels-last ``conv2d(groups=C)`` on the layer's integer input (a
    yardstick the port never calls), and the MACs each lowering
    contracts against the real ones."""
    import torch
    from repro_torch.kernels.qconv import kernel as ck
    from repro_torch.kernels.qmatmul import kernel as gk
    from repro_torch.vision.models import forward_int
    edges = {"__input__": x_wave}
    forward_int(qnet, x_wave, collect=lambda k, v: edges.setdefault(k, v))
    torch.cuda.synchronize()
    rows, prev = {}, "__input__"
    names = ("qmatmul_kernel", "qconv_kernel")
    for L, q in qnet.qlayers:
        if L.kind == "dwconv":
            x = edges[L.input_from or prev]
            n, h, w, c = x.shape
            ho, wo = ck.conv_out_hw(h, w, L.fh, L.fw, L.stride, L.padding)
            pix, g = n * ho * wo, q.gemm
            k_conv = ck.conv_k_plan(L.fh, L.fw, 1, g.a_bits, g.w_bits,
                                    ck.conv_stage_k(1)).k_contracted
            row = {"input": [n, h, w, c], "stride": L.stride,
                   "macs_real": pix * L.fh * L.fw * c,
                   "macs_contracted_qdot": pix * (-(-g.k_logical // 32)
                                                  * 32) * gk.gemm_tile_n(c),
                   "macs_contracted_per_group": c * pix * k_conv
                   * ck.conv_tile_n(1),
                   "kernel_launches_per_call": {"qdot": 1,
                                                "per_group": c}}
            for low in LOWERINGS:
                def fn(low=low):
                    return q.apply(x, lowering=low)
                row[f"{low}_ms"] = time_ms(fn, 3, 20)
                row[f"{low}_device_ms"] = library_device_ms(fn)
                row[f"{low}_kernel_device_ms"] = library_device_ms(
                    fn, names=names)
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wb = torch.randint(-128, 128, (c, 1, L.fh, L.fw), device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)

            def lib():
                return torch.nn.functional.conv2d(
                    xb, wb, stride=L.stride, padding=L.padding, groups=c)
            row["library_ms"] = time_ms(lib, 3, 20)
            row["library_device_ms"] = library_device_ms(lib)
            row["fastest_ms"] = min(LOWERINGS,
                                    key=lambda lw: row[f"{lw}_ms"])
            rows[L.path] = row
            say("time", kernel="depthwise", layer=L.path, a_bits=8, w_bits=8,
                **{k: (round(v, 5) if isinstance(v, float) else
                       json.dumps(v) if isinstance(v, (dict, list)) else v)
                   for k, v in row.items()})
        if not L.branch:
            prev = L.path
    from repro_torch.vision.layers import AUTO_LOWERING
    total = {low: sum(r[f"{low}_ms"] for r in rows.values())
             for low in LOWERINGS}
    say("time", kernel="depthwise", auto=AUTO_LOWERING,
        **{f"{low}_ms_all_layers": round(v, 5) for low, v in total.items()})
    report["timing_depthwise"] = {"auto": AUTO_LOWERING, "layers": rows,
                                  "ms_all_layers": total}
    return rows


def _device_us(prof, names=()) -> float:
    """Summed device time (us) of the profiled CUDA kernels whose name
    holds one of ``names`` (every kernel when ``names`` is empty); the
    device extents of `record_function` ranges (the port's spans) are
    not kernels."""
    import torch
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation
               and (not names or any(n in e.key for n in names)))


def profile_wave(dev, qnet, images, report, label):
    """One served wave under torch.profiler: device time of the port's
    kernels, of every other CUDA kernel, and the device's idle share of
    the wave's wall time (None where the trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import VisionEngine
    engine = VisionEngine(qnet, batch_size=WAVE, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ours = _device_us(prof, ("qconv_kernel", "qmatmul_kernel",
                             "qmatmul_segmented_kernel"))
    busy = _device_us(prof) or None
    row = {"wall_us": wall_us, "port_kernels_us": ours or None,
           "all_device_us": busy,
           "device_idle_share": None if busy is None
           else max(0.0, 1.0 - busy / wall_us)}
    say("profile", net=label, images=len(images), **row)
    report.setdefault("profile_wave", {})[label] = row


def _device_ms_per_pass(prof, reps: int, names=()) -> float:
    """Device ms of one of ``reps`` passes from a trace: per kernel name
    (of those holding one of ``names``; every kernel when empty), its mean
    duration times its launches per pass (at least one: every kernel in
    the trace runs in every pass). The trace may miss records (seen on an
    H100: the first launch of a profiler session); the mean does not
    depend on how many it holds."""
    import torch
    return sum(e.self_device_time_total / e.count
               * max(1, round(e.count / reps))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation
               and (not names or any(n in e.key for n in names))) / 1e3


def kernel_device_ms(cases, stages: int, reps: int = 10, tries: int = 3):
    """Device time per pass over ``cases`` from torch.profiler's kernel
    records: the kernel alone, without the host time of its wrapper. A
    trace that holds no record of the kernel is taken again, up to
    ``tries`` times; None when none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    name = f"{cases[0].kind}_kernel"
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for c in cases:
                    c.kernel(stages)
            torch.cuda.synchronize()
        ms = _device_ms_per_pass(prof, reps, (name,))
        if ms > 0:
            return ms
    return None


def _sum_or_none(values):
    values = list(values)
    return None if None in values else sum(values)


def library_device_ms(fn, reps: int = 10, names=(), tries: int = 3):
    """Device time of every CUDA kernel one call of ``fn`` runs (of those
    whose name holds one of ``names``, when given). A trace that holds no
    kernel record is taken again, up to ``tries`` times; None when none
    does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = _device_ms_per_pass(prof, reps, names)
        if ms > 0:
            return ms
    return None


def timing_phase(dev, convs, report):
    """Per-wave times of the conv kernel at the W8A8 main-path shapes (and
    W4/W2 into the report), beside the plain version, the bound and the
    bf16 cuDNN yardstick; plus the MACs it contracts per wave against the
    real ones."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    rows = {}
    conv_library = None
    for a_bits, w_bits in ((8, 8), (8, 4), (8, 2)):
        cases = [Case("qconv", shape, a_bits, w_bits, "int", gen, dev)
                 for _, shape in convs]
        plain = sum(time_ms(c.plain, 1, 5) for c in cases)
        bounds = [c.bound() for c in cases]
        bytes_ms = sum(b for b, _ in bounds)
        ops_ms = sum(o for _, o in bounds)
        if conv_library is None:
            fns = [c.library() for c in cases]
            conv_library = {
                "library_ms": sum(time_ms(f, 3, 20) for f in fns),
                "library_device_ms": _sum_or_none(
                    library_device_ms(f) for f in fns)}
        extra = {**conv_library,
                 "macs_contracted": sum(c.contracted_macs() for c in cases),
                 "macs_real": sum(c.real_macs() for c in cases)}
        for stages in (1, 2):
            ms = sum(time_ms(lambda c=c: c.kernel(stages), 3, 20)
                     for c in cases)
            if w_bits == 8:
                # where the conv's time goes, layer by layer
                extra[f"device_ms_by_layer_s{stages}"] = {
                    path: kernel_device_ms([c], stages)
                    for (path, _), c in zip(convs, cases)}
            rows[(stages, w_bits)] = {
                "ms": ms, "device_ms": kernel_device_ms(cases, stages),
                "plain_ms": plain, "bound_ms": sum(max(b) for b in bounds),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "calls_per_wave": len(cases), **extra}
    report["timing"] = {f"qconv_s{s}_W{w}": v for (s, w), v in rows.items()}
    for (stages, w_bits), r in rows.items():
        say("time", kernel="qconv", stages=stages, a_bits=8, w_bits=w_bits,
            ms_per_wave=round(r["ms"], 4), device_ms=r["device_ms"],
            plain_ms=round(r["plain_ms"], 4),
            bound_ms=round(r["bound_ms"], 5), calls=r["calls_per_wave"],
            **{k: r[k] for k in ("library_ms", "library_device_ms",
                                 "macs_contracted", "macs_real")})
        say("time", kernel="qconv", stages=stages, a_bits=8, w_bits=w_bits,
            device_ms_by_layer=json.dumps(
                r.get(f"device_ms_by_layer_s{stages}")))
    return rows


def gemm_shapes(head):
    """(label, (M, K, N)) of the uniform GEMM's timed shapes: the two
    heads at a wave (the main paths' calls), 4096x1152x64, the
    reference's fig8 256x2048x256 and 4096x2048x1024."""
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import trace_shapes
    qat = [t for t in trace_shapes(get_vision_config("qat-cnn"))
           if t["layer"].kind == "linear"][0]
    return (("resnet8 head", head),
            ("qat-cnn head", (WAVE, qat["in"][-1], qat["layer"].cout)),
            ("big", BIG_GEMM), ("fig8", (256, 2048, 256)),
            ("big2", (4096, 2048, 1024)))


def gemm_library(shape, gen, dev):
    """(name, closure) of one PyTorch call computing the GEMM's raw
    product on pre-unpacked operands: `torch._int_mm` where it takes the
    shape (M > 16, K and N multiples of 8), else `torch.matmul` in
    float32, exact while |acc| < 2^24 (127 x 127 x K at these K)."""
    import torch
    m, k, n = shape
    xu = torch.randint(0, 128, (m, k), generator=gen,
                       dtype=torch.int32).to(torch.int8).to(dev)
    wu = torch.randint(-128, 128, (k, n), generator=gen,
                       dtype=torch.int32).to(torch.int8).to(dev)
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return "torch._int_mm", lambda: torch._int_mm(xu, wu)
    if 127 * 128 * k >= 2 ** 24:
        raise ValueError(f"float32 GEMM of K={k} is not exact")
    xf, wf = xu.float(), wu.float()
    return "torch.matmul f32", lambda: torch.matmul(xf, wf)


def gemm_timing_phase(dev, head, report):
    """The uniform GEMM at A8 x W8/W4/W2, 'raw', both STAGES: ms with its
    wrapper (CUDA events) and device ms of the kernel alone, its launch
    plan, beside the plain version, the bound and the library's device
    time; then the device ms of each launch the plan did not choose
    (`Case.launches`: K unsplit, the other register budget)."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    rows = {}
    for label, shape in gemm_shapes(head):
        m, k, n = shape
        lib_name, lib = gemm_library(shape, gen, dev)
        library = {"library": lib_name, "library_ms": time_ms(lib, 3, 20),
                   "library_device_ms": library_device_ms(lib)}
        for w_bits in WIDTHS:
            case = Case("qmatmul", shape, 8, w_bits, "raw", gen, dev)
            bytes_ms, ops_ms = case.bound()
            row = {"shape": list(shape), "a_bits": 8, "w_bits": w_bits,
                   "plain_ms": time_ms(case.plain, 1, 5),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", **library}
            plan, *others = case.launches()
            row["plan"] = vars(plan)
            for stages in (1, 2):
                row[f"ms_s{stages}"] = time_ms(lambda: case.kernel(stages),
                                               3, 20)
                row[f"device_ms_s{stages}"] = kernel_device_ms([case],
                                                               stages)
            for other in others:
                case.plan = other
                row["other_launch " + json.dumps(
                    {"splits": other.splits,
                     "min_blocks": other.min_blocks})] = {
                    f"device_ms_s{stages}": kernel_device_ms([case], stages)
                    for stages in (1, 2)}
                case.plan = None
            rows[(label, w_bits)] = row
            what = label + " " + "x".join(map(str, shape))
            say("time", kernel="qmatmul", shape=what, **{
                k_: (round(v, 6) if isinstance(v, float) else v)
                for k_, v in row.items() if k_ not in ("shape", "plan")
                and not k_.startswith("other_launch")},
                plan=json.dumps(row.get("plan")))
            for k_, v in row.items():
                if k_.startswith("other_launch"):
                    say("time", kernel="qmatmul", shape=what, w_bits=w_bits,
                        launch=k_.split(" ", 1)[1], **v)
    report["timing_gemm"] = {f"{lb} W{w}": r for (lb, w), r in rows.items()}
    return rows


def segmented_timing_phase(dev, report):
    """Kernel 3 at A8, 'int' epilogue: c3's GEMM (the main path's qdot
    call), the reference's fig8 shape and a larger GEMM, beside the plain
    version, `torch._int_mm` on pre-unpacked int8 operands (the raw
    product only) and the bound."""
    import torch
    from repro_torch.kernels.qmatmul import kernel as gk
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    rows = {}
    for label, (shape, runs) in (("c3", c3_gemm(WAVE)), ("fig8", SEG_FIG8),
                                 ("big", SEG_BIG)):
        case = SegCase(shape, runs, 8, "int", gen, dev)
        m, k, n = shape
        xu = torch.randint(-127, 128, (m, k), generator=gen,
                           dtype=torch.int32).to(torch.int8).to(dev)
        wu = torch.randint(-8, 8, (k, n), generator=gen,
                           dtype=torch.int32).to(torch.int8).to(dev)
        bytes_ms, ops_ms = case.bound()
        row = {"shape": list(shape), "runs": [list(r) for r in runs],
               "plain_ms": time_ms(case.plain, 1, 5),
               "library_ms": time_ms(lambda: torch._int_mm(xu, wu), 3, 20),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "k_splits": gk.k_splits(
                   -(-m // TILE_M) * (case.segmap.n // 128),
                   -(-k // 128), gk.sm_count(dev))}
        for stages in (1, 2):
            row[f"ms_s{stages}"] = time_ms(lambda: case.kernel(stages), 3, 20)
            row[f"device_ms_s{stages}"] = kernel_device_ms([case], stages)
        rows[label] = row
        say("time", kernel="qmatmul_segmented", shape="x".join(map(str,
                                                                  shape)),
            runs=json.dumps(runs), **{k: (round(v, 5)
                                          if isinstance(v, float) else v)
                                      for k, v in row.items()
                                      if k not in ("shape", "runs")})
    report["timing_segmented"] = rows
    return rows


def w8_net(name, dev):
    """A full-width net at uniform W8A8 from seeded random weights,
    quantized on the card, and one wave of images for it."""
    import numpy as np
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (collect_absmax, init_fp,
                                           quantize_net)
    cfg = get_vision_config(name)
    rng = np.random.default_rng(SEED)
    fp = init_fp(cfg, seed=SEED, device=dev)
    calib = [rng.uniform(0, 1, size=(WAVE, *cfg.in_hw, cfg.in_ch)).astype(
        np.float32) for _ in range(2)]
    qnet = quantize_net(cfg, fp, collect_absmax(cfg, fp, calib),
                        plan=uniform_plan(cfg, 8, cfg.a_bits), device=dev)
    images = rng.uniform(0, 1, size=(WAVE, *cfg.in_hw, cfg.in_ch)).astype(
        np.float32)
    return qnet, images


def clear_tune_and_obs():
    """Empty the tune cache and every obs buffer, observability off: the
    phases that count launches per STAGES see no module state."""
    from repro_torch import obs as obs_pkg
    from repro_torch.kernels import tune
    tune.clear()
    obs_pkg.reset()
    obs_pkg.disable()


def tune_phase(dev, nets, report):
    """`autotune_qdot` on the card at A8 x W8/W4/W2 over the ResNet-8 head
    and MobileNet's three block-diagonal GEMMs at a wave, 4096x1152x64,
    fig8 256x2048x256 and 4096x2048x1024 ('raw'), `autotune_qconv` over
    ResNet-8's nine conv geometries at W8A8; one [tune] line per shape.
    Then the cache goes through save / load / merge into a cleared cache
    and one resnet8 W8 wave is served with it: its logits must equal the
    untuned wave's, and every dispatch must be a cache hit with a tuned
    pipeline. Each shape's planned launch and winner are timed once more,
    in turns (planned, winner, winner, planned, planned, winner; the
    median of each), to check the winner against the selection's own
    noise. Returns the kernels' launch counts over the phase."""
    import numpy as np
    import torch
    from repro_torch.kernels import api, tune
    from repro_torch.obs import trace as obs
    from repro_torch.serve.engine import VisionEngine

    clear_tune_and_obs()
    try:
        qnet, images = w8_net("resnet8", dev)
        untuned = VisionEngine(qnet, batch_size=WAVE, device=dev).run(images)
        gen = torch.Generator().manual_seed(SEED + 5)
        gemms = ([("resnet8 head", nets[0]["head"])]
                 + [(f"mobilenet {p}", sh) for p, sh in nets[1]["dw_gemms"]]
                 + list(TUNE_GEMMS))
        rows, runs = [], []
        reset_launches()
        t0 = time.perf_counter()
        with obs.enabled_scope():
            for label, (m, k, n) in gemms:
                for w_bits in WIDTHS:
                    params, xp = tune._mk_qdot_artifact(gen, m, k, n, 8,
                                                        w_bits, dev)
                    tune.autotune_qdot(params, xp, epilogue="raw")
                    rows.append(dict(obs.spans("tune.sweep")[-1]["args"],
                                     label=label + " " + "x".join(
                                         map(str, (m, k, n)))))
                    runs.append(("qmatmul_kernel",
                                 lambda lc, pl, a=params, b=xp: api.qdot_run(
                                     a, b, epilogue="raw", scale=1.0,
                                     pipeline=pl, launch=lc)))
            for path, (b, h, w_, cin, cout, f, s, p) in nets[0]["convs"]:
                params, x = tune._mk_qconv_artifact(
                    gen, h, w_, cin, cout, f, f, s, p, 8, 8, batch=b,
                    device=dev)
                tune.autotune_qconv(params, x)
                rows.append(dict(obs.spans("tune.sweep")[-1]["args"],
                                 label=f"resnet8 {path}"))
                runs.append(("qconv_kernel",
                             lambda lc, pl, a=params, b=x: api.qconv_run(
                                 a, b, epilogue="int", scale=1.0,
                                 pipeline=pl)))
        sweep_s = time.perf_counter() - t0
        with obs.enabled_scope():
            for r, (kernel, run) in zip(rows, runs):
                picks = {"planned": (r["planned_launch"],
                                     r["planned_pipeline"]),
                         "winner": (r["winner_launch"],
                                    r["winner_pipeline"])}
                turns = {"planned": [], "winner": []}
                for which in ("planned", "winner", "winner", "planned",
                              "planned", "winner"):
                    lc, pl = picks[which]
                    turns[which].append(tune._device_us(
                        lambda lc=lc, pl=pl: run(lc, pl), kernel, 20))
                r["confirm_planned_us"] = sorted(turns["planned"])[1]
                r["confirm_winner_us"] = sorted(turns["winner"])[1]
            # timings the profiler held no record of (`tune._device_us`)
            event_timed = obs.counter_values().get("tune.event_timed", 0)
        for r in rows:
            say("tune", op=r["op"], shape=r["label"], a_bits=r["a_bits"],
                w_bits=r["w_bits"], candidates=r["candidates"],
                planned=json.dumps(r["planned_launch"]),
                planned_pipeline=r["planned_pipeline"],
                planned_us=r["planned_us"],
                winner=json.dumps(r["winner_launch"]),
                winner_pipeline=r["winner_pipeline"],
                winner_us=r["winner_us"],
                planned_over_winner=round(r["planned_us"] / r["winner_us"],
                                          4),
                confirm_planned_us=round(r["confirm_planned_us"], 3),
                confirm_winner_us=round(r["confirm_winner_us"], 3),
                confirm_ratio=round(r["confirm_planned_us"]
                                    / r["confirm_winner_us"], 4),
                timer=r["timer"], exact=r["exact"])
            if not r["exact"] or r["timer"] != "device":
                raise AssertionError(f"tune {r['op']} {r['label']} "
                                     f"W{r['w_bits']}: {r['mismatched']} "
                                     "differ from the planned launch")
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        tune.save(out / "tune_cache.json")
        n_entries = len(tune.entries())
        tune.clear()
        tune.merge(tune.load(out / "tune_cache.json"))
        if len(tune.entries()) != n_entries:
            raise AssertionError("the tune cache did not survive save/load")
        with obs.enabled_scope():
            tuned = VisionEngine(qnet, batch_size=WAVE,
                                 device=dev).run(images)
            log = obs.dispatch_log()
        torch.cuda.synchronize()
        launches = read_launches()
        if not np.array_equal(tuned, untuned):
            raise AssertionError("the tuned resnet8 wave's logits differ "
                                 "from the untuned wave's")
        bad = [d for d in log if not d["tune_cache_hit"]
               or d["pipeline_source"] != "tuned"]
        if len(log) != 10 or bad:
            raise AssertionError(f"tuned wave: {len(log)} dispatches, "
                                 f"misses or untuned pipelines: {bad}")
        say("tune", net="resnet8 W8", images=WAVE, entries=n_entries,
            sweep_s=round(sweep_s, 1), event_timed=event_timed,
            dispatches=len(log),
            all_cache_hits=True, logits_equal_untuned=True,
            tuned_pipelines=json.dumps(sorted(
                {d["pipeline"] for d in log})),
            tuned_launches=json.dumps(sorted(
                {json.dumps(d["launch"]) for d in log})))
        require_launches("tune", launches, ("qmatmul", "qconv"))
        report["tune"] = {"rows": rows, "sweep_s": sweep_s,
                          "event_timed": event_timed, "entries": n_entries,
                          "launches": launches}
        return launches
    finally:
        clear_tune_and_obs()


# the GEMMs the [tune] phase sweeps besides the main paths' own
TUNE_GEMMS = (("big", BIG_GEMM), ("fig8", (256, 2048, 256)),
              ("big2", (4096, 2048, 1024)))
# the port's kernels by the op their launches count under
KERNEL_OPS = {"qmatmul_kernel": "qdot", "qconv_kernel": "qconv",
              "qmatmul_segmented_kernel": "qdot_mixed"}


def obs_phase(dev, report):
    """Observability off: a served resnet8 wave records nothing. On: one
    W8A8 wave each of resnet8 and mobilenet-tiny, then the same waves
    again under one torch.profiler session, exported to
    chiprun_out/trace.json and rendered by the port's report; their op
    counters must equal the same nets' on the CPU plain path (backend
    name aside). Prints the report's MAC/us rows (span wall time, synced;
    with and without the profiler) beside MACs over the kernels' device
    time. Returns the kernels' launch counts over the card waves."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs as obs_pkg
    from repro_torch.convert import to_device
    from repro_torch.kernels.api import device_backend
    from repro_torch.obs import counters, report as obs_report
    from repro_torch.obs import trace as obs
    from repro_torch.serve.engine import VisionEngine

    clear_tune_and_obs()
    try:
        waves = [w8_net(name, dev) for name in ("resnet8", "mobilenet-tiny")]
        reset_launches()
        VisionEngine(waves[0][0], batch_size=WAVE, device=dev).run(
            waves[0][1])
        if obs.events() or obs.dispatch_log() or counters.snapshot() \
                or obs.counter_values():
            raise AssertionError("observability off recorded something")
        # the spans once without the profiler, whose tracing costs host
        # time per launch
        with obs.enabled_scope():
            for qnet, images in waves:
                VisionEngine(qnet, batch_size=WAVE, device=dev).run(images)
        unprofiled = {r["op"]: r["us"] for r in obs_report.mac_table(
            obs.chrome_trace())}
        # the profiled pass, again where the trace holds no record of an
        # op (the profiler has dropped whole sessions on an H100)
        for _ in range(3):
            obs_pkg.reset()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                with obs.enabled_scope():
                    for qnet, images in waves:
                        VisionEngine(qnet, batch_size=WAVE,
                                     device=dev).run(images)
                torch.cuda.synchronize()
            # device time per op: mean per launch x the op's calls (a
            # trace may miss a record)
            dev_us = {}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                m = re.search(r"(\w+_kernel)\b", e.key)
                op = KERNEL_OPS.get(m.group(1)) if m else None
                if op is not None:
                    t, n = dev_us.get(op, (0.0, 0))
                    dev_us[op] = (t + e.self_device_time_total,
                                  n + e.count)
            if {"qdot", "qconv"} <= set(dev_us):
                break
        launches = read_launches()
        card = counters.snapshot()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        path = obs.export_chrome_trace(str(out / "trace.json"))
        doc = obs_report.load_trace(path)
        text = obs_report.render(doc)
        obs_pkg.reset()
        with obs.enabled_scope():
            for qnet, images in waves:
                VisionEngine(to_device(qnet, "cpu"), batch_size=WAVE,
                             device="cpu").run(images)
        cpu = counters.snapshot()
        tag = f"|{device_backend(dev)}|"
        renamed = {k.replace(tag, "|torch|"): v for k, v in card.items()}
        if renamed != cpu or not all(tag in k for k in card):
            raise AssertionError(f"card op counters {card} differ from the "
                                 f"CPU's {cpu}")
        say("obs", off_records_nothing=True, trace=str(path),
            events=len(doc["traceEvents"]),
            dispatches=len(doc["repro"]["dispatch"]), report_lines=len(
                text.splitlines()), counters_equal_cpu=True,
            buckets=len(card))
        rows = obs_report.mac_table(doc)
        if len({r["op"] for r in rows}) != len(rows):
            raise AssertionError("one mac_table row per op expected")
        for r in rows:
            if r["op"] not in dev_us:
                raise AssertionError(f"the profiler holds no kernel of "
                                     f"{r['op']}")
            t, n = dev_us[r["op"]]
            r["device_us"] = t / n * r["calls"]
            r["macs_per_device_us"] = r["macs"] / r["device_us"]
            say("obs", op=r["op"], w_bits=r["w_bits"], a_bits=r["a_bits"],
                backend=r["backend"], pipeline=r["pipeline"],
                calls=r["calls"], macs=r["macs"],
                span_us=round(r["us"], 3),
                macs_per_us=round(r["macs_per_us"], 3),
                span_us_unprofiled=round(unprofiled[r["op"]], 3),
                device_us=round(r["device_us"], 3),
                macs_per_device_us=round(r["macs_per_device_us"], 3),
                span_over_device=round(r["us"] / r["device_us"], 3))
        report["obs"] = {"mac_table": rows, "counters": card,
                         "span_us_unprofiled": unprofiled,
                         "launches": launches}
        require_launches("obs", launches, ("qmatmul", "qconv"),
                         stages_needed=(1,))
        return launches
    finally:
        clear_tune_and_obs()


# ------------------------------------------------------------- [lm] ---

LM_ARCH = "qwen2.5-3b"
# (K, N) of qwen2.5-3b's seven denses: wq and attn wo, wk and wv, wi and
# wg, mlp wo; M of a decode step (1), of the served batch (4) and of a
# prefill (64)
LM_SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048))
LM_M = (1, 4, 64)
# kernel 3's two-run plan on 2048 x 11008: half W8, half W4
LM_RUNS = ((0, 5504, 8), (5504, 11008, 4))
LM_REQUESTS, LM_BATCH, LM_MAX_NEW, LM_MAX_LEN = 8, 4, 16, 128
# [lm]'s, [mesh]'s and [tp]'s served depth of qwen2.5-3b, widths kept
# (of 36)
LM_LAYERS = 12
# the CPU cross-check: logits within this share of the largest |logit|
# (float32 math on two devices; a flipped activation code at a .5
# boundary moves a logit by far less)
LM_CPU_RTOL = 1e-3
LM_CPU_LAYERS, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 8, 8


class DenseCase:
    """One call of the LM dense path's GEMM: signed activation codes at
    a_bits packed with a_signed=True, packed weights at w_bits (or a
    segmented buffer), a per-channel dequant scale; the kernel at both
    STAGES and both output dtypes, and the plain version."""

    def __init__(self, m, k, n, a_bits, w_bits, gen, dev, runs=None,
                 w=None):
        import torch
        from repro_torch.core import packing

        def ints(bits, size):
            lo, hi = packing.int_range(bits, True)
            return torch.randint(-hi if bits == 8 else lo, hi + 1, size,
                                 generator=gen, device=gen.device,
                                 dtype=torch.int32).to(torch.int8).to(dev)

        self.shape, self.a_bits, self.w_bits, self.runs = (m, k, n), \
            a_bits, w_bits, runs
        self.kind = "qmatmul" if runs is None else "qmatmul_segmented"
        self.x = packing.pack(packing.pad_to_chunk(ints(a_bits, (m, k))),
                              a_bits)
        if w is not None:
            self.w, self.segmap = w
        elif runs is None:
            self.w = packing.pack(packing.pad_to_chunk(
                ints(w_bits, (k, n)), axis=0), w_bits, axis=0)
            self.segmap = None
        else:
            segmap = packing.SegmentMap(runs)
            wv = torch.cat([ints(b, (k, e - s)) for s, e, b in runs], dim=1)
            self.w, self.segmap = packing.pad_segmented(
                packing.pack_segmented(wv, segmap), segmap, k)
        self.scale = (torch.rand(n, generator=gen, device=gen.device)
                      * 1e-3 + 1e-5).to(dev)

    def weights(self):
        return self.w, self.segmap

    def _kw(self, out_dtype):
        return dict(a_bits=self.a_bits, a_signed=True, d=0, out_bits=8,
                    epilogue="dequant", scale=self.scale,
                    k_logical=self.shape[1], out_dtype=out_dtype)

    def kernel(self, stages, out_dtype=None):
        from repro_torch.kernels.qmatmul import kernel as gk
        if self.segmap is None:
            return gk.qmatmul_packed_cuda(
                self.x, self.w, None, None, None, w_bits=self.w_bits,
                pipeline=PIPELINE[stages], **self._kw(out_dtype))
        return gk.qmatmul_segmented_cuda(
            self.x, self.w, self.segmap, None, None, None,
            pipeline=PIPELINE[stages], **self._kw(out_dtype))

    def plain(self, out_dtype):
        from repro_torch.kernels.qmatmul import kernel as gk
        if self.segmap is None:
            return gk.qmatmul_packed_torch(self.x, self.w, None, None, None,
                                           w_bits=self.w_bits,
                                           **self._kw(out_dtype))
        return gk.qmatmul_segmented_torch(self.x, self.w, self.segmap, None,
                                          None, None, **self._kw(out_dtype))

    def bound(self, out_dtype):
        """(bytes ms, operations ms): activations packed at a_bits, the
        packed weights (each run at its width), the per-channel scale and
        the output, each moved once; ops = 2 x MACs."""
        import torch
        m, k, n = self.shape
        runs = self.runs or ((0, n, self.w_bits),)
        nbytes = (m * k * self.a_bits / 8
                  + sum(k * (e - s) * b / 8 for s, e, b in runs)
                  + 4 * n + m * n * (4 if out_dtype == torch.float32 else 2))
        return nbytes / PEAK_BYTES * 1e3, 2 * m * k * n / PEAK_INT8_OPS * 1e3


def compare_dense_cases(phase, cases, worst, n_cmp):
    """Each `DenseCase` at both output dtypes and both STAGES, identical
    to its plain version on the card; tallies into ``worst`` and
    ``n_cmp``."""
    import torch
    for c in cases:
        kind = c.kind
        for out_dtype in (torch.bfloat16, torch.float32):
            want = c.plain(out_dtype)
            for stages in (1, 2):
                got = c.kernel(stages, out_dtype)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                if got.dtype != out_dtype or err != 0.0:
                    raise AssertionError(
                        f"[{phase}] {kind} STAGES={stages} A{c.a_bits}W"
                        f"{c.w_bits} {c.runs} {out_dtype} at {c.shape}: "
                        f"dtype {got.dtype}, max abs err {err}")
                worst[(kind, stages)] = max(worst[(kind, stages)], err)
                n_cmp[kind] += 1
    say(phase, kernels="qmatmul,qmatmul_segmented", a_signed=True,
        scale="per-channel", out_dtypes="bfloat16,float32",
        compared=json.dumps(n_cmp), all_exact=True)


def _no_errors():
    return ({(k, s): 0.0 for k in ("qmatmul", "qmatmul_segmented")
             for s in (1, 2)}, {"qmatmul": 0, "qmatmul_segmented": 0})


def lm_kernel_phase(dev, report):
    """Kernels 1-3 at qwen2.5-3b's four dense shapes, M 1/4/64, signed
    activations, a per-channel scale, both output dtypes, both STAGES:
    identical to the plain version on the card."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    worst, n_cmp = _no_errors()
    cases = []
    for k, n in LM_SHAPES:
        for w_bits in WIDTHS:
            w = None
            for m in LM_M:
                for a_bits in WIDTHS:
                    c = DenseCase(m, k, n, a_bits, w_bits, gen, dev, w=w)
                    w = c.weights()
                    cases.append(c)
    seg_w = None
    k, n = LM_SHAPES[2]                 # wi / wg
    for m in LM_M:
        for a_bits in WIDTHS:
            c = DenseCase(m, k, n, a_bits, 8, gen, dev, runs=LM_RUNS,
                          w=seg_w)
            seg_w = c.weights()
            cases.append(c)
    compare_dense_cases("lm", cases, worst, n_cmp)
    report["lm_kernel_phase"] = {"comparisons": n_cmp,
                                 "shapes": [list(s) for s in LM_SHAPES],
                                 "m": list(LM_M), "runs": LM_RUNS}
    return worst


def _lm_requests(cfg, seed=SEED):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(2, cfg.vocab, size=(
        int(rng.integers(2, 9)),)).astype(np.int32),
        max_new_tokens=LM_MAX_NEW) for _ in range(LM_REQUESTS)]


def _lm_model(cfg, w_bits, pipeline=None, plan=None):
    import dataclasses
    from repro_torch.models.api import build
    from repro_torch.nn.layers import QuantConfig
    return build(dataclasses.replace(
        cfg, quant=QuantConfig(mode="int", w_bits=w_bits, a_bits=8,
                               pipeline=pipeline), quant_plan=plan))


def _dense_bytes(params):
    """Bytes of the packed dense weights (every `w_packed` leaf)."""
    if isinstance(params, dict):
        return sum(v.numel() if k == "w_packed" else _dense_bytes(v)
                   for k, v in params.items())
    return 0


def _expert_bytes(params):
    """Bytes of a MoE tree's routed experts (float wi, wg, wo)."""
    from repro_torch.nn.module import param_bytes
    moe = params["layers"]["moe"]
    return sum(param_bytes(moe[k]) for k in ("wi", "wg", "wo"))


def serve_lm(name, model, params, report, phase="lm"):
    """Serve the LM requests through `Engine`; print and record the
    [phase] serve line (peak device memory since the path's last
    `torch.cuda.reset_peak_memory_stats`); return the outputs."""
    import torch
    from repro_torch.nn.module import param_bytes
    from repro_torch.serve.engine import Engine
    eng = Engine(model, params, batch_size=LM_BATCH, max_len=LM_MAX_LEN,
                 device=params["embed"]["table"].device)
    t0 = time.perf_counter()
    out = eng.generate(_lm_requests(model.cfg))   # host tokens: synced
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in out)
    # each request runs to max_new tokens or stops at EOS (id 1)
    if any(not (len(r.out) == LM_MAX_NEW or (0 < len(r.out) < LM_MAX_NEW
                                              and r.out[-1] == eng.eos))
           or (r.out < 0).any() or (r.out >= model.cfg.vocab).any()
           for r in out):
        raise AssertionError(f"[{phase}] {name}: bad outputs "
                             f"{[r.out.tolist() for r in out]}")
    lat = eng.utilization_report()["latency_us"]
    row = {"tok_per_s": toks / wall, "tokens": toks, "wall_s": wall,
           "wave_p50_ms": lat["p50"] / 1e3, "wave_p95_ms": lat["p95"] / 1e3,
           "waves": lat["waves"], "dense_bytes": _dense_bytes(params),
           "param_bytes": param_bytes(params),
           "embed_bytes": param_bytes(params["embed"]),
           **({"expert_bytes": _expert_bytes(params)}
              if "moe" in params.get("layers", {}) else {}),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": torch.cuda.get_device_name(0)}
    say(phase, serve=name, **{k: (round(v, 3) if isinstance(v, float)
                                  else v) for k, v in row.items()})
    report.setdefault(f"{phase}_serve", {})[name] = row
    return [r.out.tolist() for r in out]


def dense_calls_per_step(model) -> int:
    """Dense calls of one decode step: each quantized dense path of the
    model (`quantized_dense_paths`) once per stacked layer, but for the
    encoder's and the cross K/V projections (run once per source, not per
    step)."""
    from repro_torch.deploy.apply import quantized_dense_paths
    defs = model.defs()
    total = 0
    for path in quantized_dense_paths(defs):
        if path.startswith("enc_layers/") or path.endswith(
                ("xattn/wk", "xattn/wv")):
            continue
        node = defs
        for part in path.split("/"):
            node = node[part]
        total += node["w_packed"].shape[0]      # every dense is stacked
    return total


def _check_dense_calls(dev, model, params, phase="lm"):
    """One decode step of the served W4A8 model with `dense_tap` on: every
    one of its int dense calls, run again on the card, is identical to the
    same call on the CPU (the kernels' plain versions). A cross cache is
    filled with seeded normals first, so the cross layers' wo sees real
    inputs."""
    import torch
    from repro_torch.nn.layers import dense_tap
    cfg = model.cfg
    cache = model.init_cache(LM_BATCH, LM_MAX_LEN, device=dev)
    if "cross_kv" in cache:
        cache["cross_kv"].normal_(generator=torch.Generator(
            device=dev).manual_seed(SEED + 6))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    toks = torch.randint(2, cfg.vocab, (LM_BATCH, 5), generator=gen).to(dev)
    for t in range(4):
        model.decode(params, cache, toks[:, t:t + 1], t)
    calls = []
    # a float dense (an untied head) is outside the int path
    with dense_tap(lambda p, x: calls.append((p, x)) if "w_packed" in p
                   else None):
        # each slot at its own position, as the serving adapter feeds them
        model.decode(params, cache, toks[:, 4:5],
                     torch.tensor([4, 3, 4, 2], device=dev))
    torch.cuda.synchronize()
    expected = dense_calls_per_step(model)
    if len(calls) != expected:
        raise AssertionError(f"[{phase}] tapped {len(calls)} dense calls, "
                             f"expected {expected}")
    _calls_equal_cpu(calls, cfg.quant, phase)
    say(phase, check="dense_tap", arch=cfg.name, w_bits=cfg.quant.w_bits,
        dense_calls=len(calls), all_equal_cpu_plain=True)
    return len(calls)


def _calls_equal_cpu(calls, qcfg, phase):
    """Each tapped (params, input) dense call, run again on the card, is
    identical to the same call on the CPU (the kernels' plain
    versions)."""
    from repro_torch.convert import to_device
    from repro_torch.nn.layers import dense_apply
    for i, (p, x) in enumerate(calls):
        got = dense_apply(p, x, qcfg=qcfg)
        want = dense_apply(to_device(p, "cpu"), x.cpu(), qcfg=qcfg)
        err = max_abs_err(got.cpu(), want)
        if err != 0.0:
            raise AssertionError(f"[{phase}] dense call {i} "
                                 f"({tuple(x.shape)} x "
                                 f"{tuple(p['w_packed'].shape)}): max abs "
                                 f"err {err} against the CPU plain path")


def profile_decode_step(dev, model, params, report, phase="lm",
                        extra=None):
    """One decode step (batch 4) under torch.profiler: wall, device busy
    and idle share, the qmatmul kernels' device ms and launches; and the
    logits head (the tied embedding matmul or the untied head, and the
    mask) profiled alone at the step's shapes. ``extra`` fields join the
    printed row. Resets the launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import _logits
    cfg = model.cfg
    cache = model.init_cache(LM_BATCH, LM_MAX_LEN, device=dev)
    tok = torch.full((LM_BATCH, 1), 7, device=dev)
    model.decode(params, cache, tok, 0)           # warm
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode(params, cache, tok, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = read_launches()
    busy = _device_us(prof) or None
    ours = _device_us(prof, ("qmatmul_kernel", "qmatmul_segmented_kernel"))
    x = torch.randn(LM_BATCH, 1, cfg.d_model, device=dev).to(torch.bfloat16)
    head_ms = library_device_ms(lambda: _logits(params, x, cfg))
    row = {"wall_ms": wall_us / 1e3,
           "device_busy_ms": None if busy is None else busy / 1e3,
           "device_idle_share": None if busy is None
           else max(0.0, 1.0 - busy / wall_us),
           "qmatmul_device_ms": ours / 1e3 if ours else None,
           "qmatmul_launches": sum(launches["qmatmul"].values()),
           "qmatmul_segmented_launches": sum(
               launches["qmatmul_segmented"].values()),
           "logits_head_device_ms": head_ms, **(extra or {})}
    say(phase, profile="decode step", arch=cfg.name, batch=LM_BATCH,
        w_bits=cfg.quant.w_bits, **row)
    report.setdefault(f"{phase}_profile_decode_step", {})[cfg.name] = row


def lm_timing_phase(dev, report, shapes, label, seed):
    """Each dense shape (M, K, N) (M = 4: a decode step of the served
    batch), A8 x W8/W4/W2, bf16 output: the kernel's device ms at both
    STAGES beside its bound, its plain version and `torch.matmul` in bf16
    on the dequantized weights (`torch._int_mm` does not take M = 4)."""
    import torch
    from repro_torch.core import packing
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = {}
    for m, k, n in shapes:
        library = None
        for w_bits in WIDTHS:
            c = DenseCase(m, k, n, 8, w_bits, gen, dev)
            if library is None:
                # the W8 case's codes and weights, dequantized to bf16
                xb = packing.unpack(c.x, 8, True)[:, :k].to(torch.bfloat16)
                wb = (packing.unpack(c.w, 8, True, axis=0)[:k].float()
                      * c.scale).to(torch.bfloat16)
                lib = lambda: torch.matmul(xb, wb)  # noqa: E731
                library = {"library": "torch.matmul bf16",
                           "library_ms": time_ms(lib, 3, 20),
                           "library_device_ms": library_device_ms(lib)}
            bytes_ms, ops_ms = c.bound(torch.bfloat16)
            row = {"shape": [m, k, n], "a_bits": 8, "w_bits": w_bits,
                   "plain_ms": time_ms(lambda: c.plain(torch.bfloat16), 1,
                                       5),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", **library}
            for stages in (1, 2):
                row[f"ms_s{stages}"] = time_ms(
                    lambda: c.kernel(stages, torch.bfloat16), 3, 20)
                row[f"device_ms_s{stages}"] = kernel_device_ms([c], stages)
            rows[f"{m}x{k}x{n} W{w_bits}"] = row
            say("time", kernel="qmatmul", **{label: f"{m}x{k}x{n}"}, **{
                k_: (round(v, 6) if isinstance(v, float) else v)
                for k_, v in row.items() if k_ != "shape"})
    report[f"timing_{label}"] = rows
    return rows


def lm_cpu_check(dev, report):
    """qwen2.5-3b's widths at LM_CPU_LAYERS layers, float32 compute, fp
    weights from a CPU generator: the W4A8 artifact packed on the card is
    byte-identical to the CPU's; prefill plus LM_CPU_STEPS decode steps
    on the card stay within LM_CPU_RTOL of the CPU plain run, and greedy
    tokens agree wherever the CPU's top-1 margin exceeds that
    tolerance."""
    import dataclasses
    import torch
    from repro_torch.convert import to_device
    from repro_torch.launch.convert import convert_params
    from repro_torch.models.api import build, get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_CPU_LAYERS,
                              compute_dtype="float32")
    fp_cpu = build(cfg).init(SEED, device="cpu")
    model = _lm_model(cfg, 4)
    q = {d: convert_params(model.init(0, device=d), to_device(fp_cpu, d), 4)
         for d in ("cpu", dev)}
    diff = first_difference(to_device(q[dev], "cpu"), q["cpu"])
    if diff is not None:
        raise AssertionError(f"[lm] the W4A8 artifact packed on the card "
                             f"differs from the CPU's at {diff}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    prompt = torch.randint(2, cfg.vocab, (2, LM_CPU_PROMPT), generator=gen)
    total = LM_CPU_PROMPT + LM_CPU_STEPS
    logits, caches = {}, {}
    for d in ("cpu", dev):
        lg, (k, v) = model.prefill(q[d], {"tokens": prompt.to(d)})
        cache = model.init_cache(2, total, torch.float32, device=d)
        cache["kv"]["k"][:, :, :LM_CPU_PROMPT] = k
        cache["kv"]["v"][:, :, :LM_CPU_PROMPT] = v
        logits[d], caches[d] = [lg[:, -1].cpu()], cache
    tol = LM_CPU_RTOL * float(logits["cpu"][0][:, :cfg.vocab].abs().max())
    worst, agreed, compared = 0.0, 0, 0
    for t in range(LM_CPU_STEPS + 1):
        ref = logits["cpu"][t][:, :cfg.vocab]
        got = logits[dev][t][:, :cfg.vocab]
        worst = max(worst, float((got - ref).abs().max()))
        top2 = ref.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        same = got.argmax(-1) == ref.argmax(-1)
        compared += int(sure.sum())
        agreed += int((same & sure).sum())
        if t == LM_CPU_STEPS:
            break
        tok = ref.argmax(-1, keepdim=True)      # the CPU's greedy token
        for d in ("cpu", dev):
            lg, caches[d] = model.decode(q[d], caches[d], tok.to(d),
                                         LM_CPU_PROMPT + t)
            logits[d].append(lg[:, -1].cpu())
    if worst > tol or agreed != compared:
        raise AssertionError(f"[lm] card vs CPU at {LM_CPU_LAYERS} layers: "
                             f"max |dlogit| {worst} (tol {tol}), greedy "
                             f"tokens {agreed}/{compared} where the margin "
                             "exceeds tol")
    row = {"layers": LM_CPU_LAYERS, "artifact_equal_cpu": True,
           "max_abs_logit_err": worst, "tol": tol,
           "greedy_agree": f"{agreed}/{compared}"}
    say("lm", check="card_vs_cpu", arch=LM_ARCH, w_bits=4,
        compute="float32", **row)
    report["lm_cpu_check"] = row


def lm_path(dev, report):
    """Serve full-width qwen2.5-3b from seeded weights made and quantized
    on the card: W8A8, W4A8, W2A8 and W4A8 double-buffered through
    `Engine`, every dense call of one W4A8 decode step held against the
    CPU plain path, a plan with a segments rule on every layers/mlp/wi
    (half W8, half W4), then the CLI `repro_torch.launch.serve` at W4A8.
    Returns the kernels' launch counts over the two serving windows."""
    import dataclasses
    import torch
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.convert import convert_params
    from repro_torch.models.api import build, get_config

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    label = f"{LM_ARCH} ({LM_LAYERS} of 36 layers)"
    torch.cuda.reset_peak_memory_stats()
    fp = build(cfg).init(SEED, device=dev)
    models = {w: _lm_model(cfg, w) for w in WIDTHS}
    params = {w: convert_params(int_skeleton(m.defs()), fp, w)
              for w, m in models.items()}
    db = _lm_model(cfg, 4, pipeline="double_buffer")
    # one untimed request first: torch loads its own CUDA kernels lazily
    serve_lm("warm-up", models[8], params[8], {})
    reset_launches()
    outs = {w: serve_lm(f"{label} W{w}A8", models[w], params[w], report)
            for w in WIDTHS}
    out_db = serve_lm(f"{label} W4A8 double_buffer", db, params[4],
                      report)
    torch.cuda.synchronize()
    first = read_launches()
    if out_db != outs[4]:
        raise AssertionError("[lm] double_buffer tokens differ from 'off'")
    require_launches(LM_ARCH, first, ("qmatmul",))
    _check_dense_calls(dev, models[4], params[4])
    profile_decode_step(dev, models[4], params[4], report)

    plan = PrecisionPlan(rules=(PlanRule("layers/mlp/wi", 8,
                                         segments=LM_RUNS),),
                         default_w_bits=4)
    pm = _lm_model(cfg, 4, plan=plan)
    pp = apply_plan(int_skeleton(pm.defs()), fp, plan, 4)
    del fp, params
    reset_launches()
    serve_lm(f"{label} plan wi W8|W4", pm, pp, report)
    del pp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = serve_cli.main(["--arch", LM_ARCH, "--quant", "w4a8",
                          "--requests", str(LM_REQUESTS), "--batch",
                          str(LM_BATCH), "--max-new", str(LM_MAX_NEW),
                          "--layers", str(LM_LAYERS)])
    torch.cuda.synchronize()
    second = read_launches()
    if len(cli) != LM_REQUESTS or not all(len(r.out) for r in cli):
        raise AssertionError("[lm] the serve CLI returned no tokens")
    say("lm", cli="python -m repro_torch.launch.serve --arch qwen2.5-3b "
        f"--quant w4a8 --layers {LM_LAYERS}",
        seconds=round(time.perf_counter() - t0, 1))
    require_launches(f"{LM_ARCH} plan + CLI", second,
                     ("qmatmul_segmented", "qmatmul"), stages_needed=(1,))
    launches = {k: {s: first[k][s] + second[k][s] for s in (1, 2)}
                for k in first}
    report.setdefault("launches", {})[LM_ARCH] = launches
    return launches


# ------------------------------------------------------------ [rec] ---

REC_ARCHS = ("mamba2-370m", "recurrentgemma-9b")
# (K, N) the recurrent families give kernels 1-2 and no earlier path
# does: mamba2-370m's in_proj (34 x 128 + 32 = 4384 columns) and
# out_proj; recurrentgemma-9b's in_x, in_gate, w_a, w_i, out, wq, attn wo
# (4096 x 4096), wk and wv, wi and wg, mlp wo
REC_SHAPES = ((1024, 4384), (2048, 1024), (4096, 4096), (4096, 256),
              (4096, 12288), (12288, 4096))
# kernel 3's two-run plan on 4096 x 12288 (rgemma's rec_layers/mlp/wi
# under the [rec] plan): half W8, half W4
REC_RUNS = ((0, 6144, 8), (6144, 12288, 4))
# requests of the served W4A8 run each checked against the same request
# served alone: the last ones, which the second wave puts on reused slots
REC_ALONE = {"mamba2-370m": 4, "recurrentgemma-9b": 3}
# the served depth, widths kept (of 48 and 38 layers), room for [tp]:
# rgemma keeps two (rec, rec, attn) groups and its two trailing rec
# layers
REC_LAYERS = {"mamba2-370m": 6, "recurrentgemma-9b": 8}
# the CPU cross-check: the full widths at a reduced depth (rgemma: one
# rec, rec, attn group), float32 compute; rgemma's window cut from 2048 to
# 16 so that its ring of min(24, 16) slots wraps within the 8 prompt
# tokens and 16 decode steps
REC_CPU_LAYERS = {"mamba2-370m": 2, "recurrentgemma-9b": 3}
REC_CPU_WINDOW = 16
REC_CPU_PROMPT, REC_CPU_STEPS = 8, 16


def rec_kernel_phase(dev, report):
    """Kernels 1-2 at the six (K, N) shapes of the recurrent families,
    M = 4, A8 x W{8,4,2}; kernel 3 on 4096 x 12288 under a two-run plan,
    A{8,4,2}: signed activations, a per-channel scale, both output
    dtypes, both STAGES, identical to the plain version on the card."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    worst, n_cmp = _no_errors()
    cases = [DenseCase(4, k, n, 8, w_bits, gen, dev)
             for k, n in REC_SHAPES for w_bits in WIDTHS]
    seg_w = None
    for a_bits in WIDTHS:
        c = DenseCase(4, 4096, 12288, a_bits, 8, gen, dev, runs=REC_RUNS,
                      w=seg_w)
        seg_w = c.weights()
        cases.append(c)
    compare_dense_cases("rec", cases, worst, n_cmp)
    report["rec_kernel_phase"] = {"comparisons": n_cmp,
                                  "shapes": [list(s) for s in REC_SHAPES],
                                  "m": 4, "runs": REC_RUNS}
    return worst


def _decode_once(dev, model, params):
    """One decode step at the served batch (torch loads its own CUDA
    kernels lazily: the first served step would pay for it)."""
    import torch
    cache = model.init_cache(LM_BATCH, LM_MAX_LEN, device=dev)
    model.decode(params, cache, torch.full((LM_BATCH, 1), 7, device=dev), 0)
    torch.cuda.synchronize()


def rec_reset_check(dev, model, params, served, n, report):
    """The last ``n`` requests of the served 8 (4 slots, two waves: these
    ran on slots the first wave left), each served alone by a fresh
    one-slot `Engine`: the same tokens, so the re-admitted slots started
    from cleared SSM / RG-LRU state."""
    from repro_torch.serve.engine import Engine
    cfg = model.cfg
    reqs = _lm_requests(cfg)
    for i in range(LM_REQUESTS - n, LM_REQUESTS):
        alone = Engine(model, params, batch_size=1, max_len=LM_MAX_LEN,
                       device=dev).generate([reqs[i]])[0].out.tolist()
        if alone != served[i]:
            raise AssertionError(f"[rec] {cfg.name} request {i}: served on a "
                                 f"reused slot {served[i]}, alone {alone}")
    say("rec", check="state_reset", arch=cfg.name, w_bits=4,
        requests_alone=n, two_wave_equal_alone=True)
    report.setdefault("rec_state_reset", {})[cfg.name] = n


def rec_path(dev, arch, report):
    """Serve one recurrent family at full width from seeded weights made
    and quantized on the card, one width at a time: W8A8, W4A8, W4A8
    double-buffered (the same tokens) and W2A8 through `Engine`; then at
    W4A8 every dense call of one decode step against the CPU plain path,
    one profiled decode step and the state-reset check; for rgemma a plan
    with every rec_layers/mlp/wi split W8 | W4; then the CLI at W4A8.
    Returns the kernels' launch counts over the two serving windows."""
    import dataclasses
    import torch
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.api import build, get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=REC_LAYERS[arch])
    label = f"{arch} ({REC_LAYERS[arch]} of {full.n_layers} layers)"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp = build(cfg).init(SEED, device=dev)

    def pack(model, w_bits, plan=None):
        return apply_plan(int_skeleton(model.defs()), fp, plan, w_bits)

    models = {w: _lm_model(cfg, w) for w in WIDTHS}
    db = _lm_model(cfg, 4, pipeline="double_buffer")
    params = pack(models[8], 8)
    _decode_once(dev, models[8], params)
    reset_launches()
    outs = {8: serve_lm(f"{label} W8A8", models[8], params, report, "rec")}
    del params
    p4 = pack(models[4], 4)
    outs[4] = serve_lm(f"{label} W4A8", models[4], p4, report, "rec")
    out_db = serve_lm(f"{label} W4A8 double_buffer", db, p4, report, "rec")
    params = pack(models[2], 2)
    outs[2] = serve_lm(f"{label} W2A8", models[2], params, report, "rec")
    del params
    torch.cuda.synchronize()
    first = read_launches()
    if out_db != outs[4]:
        raise AssertionError(f"[rec] {arch}: double_buffer tokens differ "
                             "from 'off'")
    require_launches(arch, first, ("qmatmul",))
    _check_dense_calls(dev, models[4], p4, "rec")
    profile_decode_step(dev, models[4], p4, report, "rec")
    rec_reset_check(dev, models[4], p4, outs[4], REC_ALONE[arch], report)
    del p4

    reset_launches()
    needed = ("qmatmul",)
    if cfg.family == "griffin":
        plan = PrecisionPlan(rules=(PlanRule("rec_layers/mlp/wi", 8,
                                             segments=REC_RUNS),),
                             default_w_bits=4)
        pm = _lm_model(cfg, 4, plan=plan)
        pp = pack(pm, 4, plan)
        serve_lm(f"{label} plan rec wi W8|W4", pm, pp, report, "rec")
        del pp
        needed = ("qmatmul_segmented", "qmatmul")
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = serve_cli.main(["--arch", arch, "--quant", "w4a8", "--requests",
                          str(LM_REQUESTS), "--batch", str(LM_BATCH),
                          "--max-new", str(LM_MAX_NEW), "--layers",
                          str(REC_LAYERS[arch])])
    torch.cuda.synchronize()
    second = read_launches()
    if len(cli) != LM_REQUESTS or not all(len(r.out) for r in cli):
        raise AssertionError(f"[rec] the serve CLI returned no tokens for "
                             f"{arch}")
    say("rec", cli=f"python -m repro_torch.launch.serve --arch {arch} "
        f"--quant w4a8 --layers {REC_LAYERS[arch]}",
        seconds=round(time.perf_counter() - t0, 1))
    require_launches(f"{arch} plan + CLI" if len(needed) > 1
                     else f"{arch} CLI", second, needed, stages_needed=(1,))
    del cli
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: {s: first[k][s] + second[k][s] for s in (1, 2)}
                for k in first}
    report.setdefault("launches", {})[arch] = launches
    return launches


def rec_cpu_check(dev, arch, report):
    """One recurrent family at its full widths and REC_CPU_LAYERS layers,
    float32 compute, fp weights from a CPU generator: the W4A8 artifact
    packed on the card is byte-identical to the CPU's; REC_CPU_PROMPT
    prompt tokens and REC_CPU_STEPS greedy steps, each one decode step on
    both devices, stay within LM_CPU_RTOL of the largest CPU logit, and
    greedy tokens agree wherever the CPU's top-1 margin exceeds that."""
    import dataclasses
    import torch
    from repro_torch.convert import to_device
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.models.api import build, get_config
    cut = {"n_layers": REC_CPU_LAYERS[arch], "compute_dtype": "float32"}
    if arch == "recurrentgemma-9b":
        cut["window"] = REC_CPU_WINDOW
    cfg = dataclasses.replace(get_config(arch), **cut)
    fp_cpu = build(cfg).init(SEED, device="cpu")
    model = _lm_model(cfg, 4)
    q = {d: apply_plan(int_skeleton(model.defs()), to_device(fp_cpu, d),
                       None, 4) for d in ("cpu", dev)}
    diff = first_difference(to_device(q[dev], "cpu"), q["cpu"])
    if diff is not None:
        raise AssertionError(f"[rec] {arch}: the W4A8 artifact packed on "
                             f"the card differs from the CPU's at {diff}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    prompt = torch.randint(2, cfg.vocab, (2, REC_CPU_PROMPT), generator=gen)
    total = REC_CPU_PROMPT + REC_CPU_STEPS
    caches = {d: model.init_cache(2, total, torch.float32, device=d)
              for d in ("cpu", dev)}
    tol, worst, agreed, compared = None, 0.0, 0, 0
    tok = prompt[:, :1]
    for t in range(total):
        lg = {d: model.decode(q[d], caches[d], tok.to(d), t)[0][:, -1]
              .cpu()[:, :cfg.vocab] for d in ("cpu", dev)}
        ref, got = lg["cpu"], lg[dev]
        if tol is None:
            tol = LM_CPU_RTOL * float(ref.abs().max())
        worst = max(worst, float((got - ref).abs().max()))
        if t >= REC_CPU_PROMPT - 1:
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > tol
            same = got.argmax(-1) == ref.argmax(-1)
            compared += int(sure.sum())
            agreed += int((same & sure).sum())
        # the next prompt token, then the CPU's greedy token
        tok = (prompt[:, t + 1:t + 2] if t + 1 < REC_CPU_PROMPT
               else ref.argmax(-1, keepdim=True))
    if worst > tol or agreed != compared:
        raise AssertionError(f"[rec] {arch} card vs CPU at {cfg.n_layers} "
                             f"layers: max |dlogit| {worst} (tol {tol}), "
                             f"greedy tokens {agreed}/{compared} where the "
                             "margin exceeds tol")
    row = {"layers": cfg.n_layers, "artifact_equal_cpu": True,
           "max_abs_logit_err": worst, "tol": tol,
           "greedy_agree": f"{agreed}/{compared}"}
    if "window" in cut:
        row.update(window=f"{REC_CPU_WINDOW} (cut from 2048)",
                   ring_slots=caches["cpu"]["kv"]["k"].shape[2],
                   positions=total)
    say("rec", check="card_vs_cpu", arch=arch, w_bits=4, compute="float32",
        **row)
    report.setdefault("rec_cpu_check", {})[arch] = row


# ---------------------------------------------------------- [xattn] ---

XATTN_ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
# llama-3.2-vision-90b keeps its widths with its depth cut from 100 layers
# to 5 (one group of four self layers and a cross layer): at 100 layers
# its W8 artifact alone (85.6 GB) is larger than the card, and 5 rather
# than 10 leaves the script's time limit room for [qat] and [train];
# seamless-m4t-large-v2 keeps 6 of its 24 encoder and 24 decoder layers,
# room for [tp] (the CLI's ``--layers`` counts each stack)
XATTN_LAYERS = {"llama-3.2-vision-90b": 5, "seamless-m4t-large-v2": 6}
# (M, K, N) the cross-attention archs give kernels 1-2: seamless's wq / wk
# / wv / wo (1024x1024), mlp wi (1024x8192) and wo (8192x1024) at a decode
# step of the served batch (M = 4) and over the encoder's batch of 4 x
# 4096 frames (M = 16,384); vision's wq / wo (8192x8192), wk / wv
# (8192x1024), wi / wg (8192x28672) and mlp wo (28672x8192) at M = 4, and
# its cross_kv_project over 4096 source positions (8192x1024, M = 4096)
XATTN_SHAPES = tuple(
    (m, k, n) for m in (4, 16384)
    for k, n in ((1024, 1024), (1024, 8192), (8192, 1024))) + tuple(
    (4, k, n) for k, n in ((8192, 8192), (8192, 1024), (8192, 28672),
                           (28672, 8192))) + ((4096, 8192, 1024),)
# kernel 3's two-run plan on seamless's dec_layers/mlp/wi (1024 x 8192):
# half W8, half W4; (M, A bits) of its cases
XATTN_RUNS = ((0, 4096, 8), (4096, 8192, 4))
XATTN_SEG_CASES = ((4, 8), (4, 4), (4, 2), (16384, 8))
# the reference's enc-dec prefill: the config's 4096 source frames at
# batch 4 and 256 decoder tokens
XATTN_SRC_BATCH, XATTN_PREFILL_TOKENS = 4, 256
# decode against the teacher-forced forward (tests/test_decode_agreement.py
# on the card): batch 2, 12 positions, float32, quantization off, within
# this share of the largest |logit|
XATTN_DVF_STEPS, XATTN_DVF_RTOL = 12, 1e-3
# the CPU cross-check: seamless's widths at 2 encoder + 2 decoder layers,
# its 4096 source frames cut to 64
XATTN_CPU_LAYERS, XATTN_CPU_SRC = 2, 64


def xattn_kernel_phase(dev, report):
    """Kernels 1-2 at XATTN_SHAPES, A8 x W{8,4,2} (each weight shared by
    the shape's M values); kernel 3 on 1024 x 8192 under XATTN_RUNS at
    XATTN_SEG_CASES: signed activations, a per-channel scale, both output
    dtypes, both STAGES, identical to the plain version on the card. The
    operands are drawn on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    worst, n_cmp = _no_errors()
    by_kn = {}
    for m, k, n in XATTN_SHAPES:
        by_kn.setdefault((k, n), []).append(m)
    cases = []
    for (k, n), ms in by_kn.items():
        for w_bits in WIDTHS:
            w = None
            for m in ms:
                c = DenseCase(m, k, n, 8, w_bits, gen, dev, w=w)
                w = c.weights()
                cases.append(c)
    seg_w = None
    for m, a_bits in XATTN_SEG_CASES:
        c = DenseCase(m, 1024, 8192, a_bits, 8, gen, dev, runs=XATTN_RUNS,
                      w=seg_w)
        seg_w = c.weights()
        cases.append(c)
    compare_dense_cases("xattn", cases, worst, n_cmp)
    report["xattn_kernel_phase"] = {
        "comparisons": n_cmp, "shapes": [list(s) for s in XATTN_SHAPES],
        "runs": XATTN_RUNS, "seg_cases": XATTN_SEG_CASES}
    return worst


def _xattn_config(arch, **over):
    import dataclasses
    from repro_torch.models.api import get_config
    full = get_config(arch)
    if arch in XATTN_LAYERS:
        n = XATTN_LAYERS[arch]
        cut = ({"enc_layers": n, "dec_layers": n, "n_layers": 2 * n}
               if full.family == "encdec" else {"n_layers": n})
        over = {**cut, **over}
    return dataclasses.replace(full, **over)


def _label(cfg):
    """The arch's name, with the depth where it was cut."""
    from repro_torch.models.api import get_config
    cut = XATTN_LAYERS.get(cfg.name)
    if cut is None:
        return cfg.name
    full = get_config(cfg.name)
    if full.family == "encdec":
        return (f"{cfg.name} ({cut} + {cut} of {full.enc_layers} + "
                f"{full.dec_layers} layers)")
    return f"{cfg.name} ({cut} of {full.n_layers} layers)"


def _check_encoder_calls(dev, model, params):
    """One encoder layer over XATTN_SRC_BATCH x src_len seeded frames (M =
    16,384 at seamless's 4096) and the first decoder layer's
    `cross_kv_project` of its output, at the served width with `dense_tap`
    on: each of the 6 + 2 int dense calls, run again on the card, is
    identical to the same call on the CPU."""
    import dataclasses
    import torch
    from repro_torch.models import encdec
    from repro_torch.models.lm import _attn_cfg, layer_params
    from repro_torch.nn.attention import cross_kv_project
    from repro_torch.nn.layers import dense_tap
    cfg = dataclasses.replace(model.cfg, enc_layers=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    src = torch.randn(XATTN_SRC_BATCH, cfg.src_len, cfg.d_model,
                      generator=gen, device=dev)
    calls = []
    with dense_tap(lambda p, x: calls.append((p, x))):
        enc = encdec.encode(params, src, cfg)
        cross_kv_project(layer_params(params["dec_layers"], 0)["xattn"], enc,
                         _attn_cfg(cfg, "dec_layers/xattn"))
    torch.cuda.synchronize()
    if len(calls) != 8:
        raise AssertionError(f"[xattn] tapped {len(calls)} encoder and "
                             "cross K/V calls, expected 6 + 2")
    _calls_equal_cpu(calls, cfg.quant, "xattn")
    say("xattn", check="dense_tap", arch=cfg.name, w_bits=cfg.quant.w_bits,
        part="encoder layer + cross_kv_project",
        rows=XATTN_SRC_BATCH * cfg.src_len, dense_calls=len(calls),
        all_equal_cpu_plain=True)


def profile_prefill(dev, model, params, report):
    """`Model.prefill` at the reference's enc-dec prefill shape
    (XATTN_SRC_BATCH x src_len seeded source frames, XATTN_PREFILL_TOKENS
    decoder tokens) under torch.profiler: wall, device busy and idle
    share, kernel 1's device ms and launches against the bound of the
    prefill's int GEMMs (2 x MACs at the int8 peak; MACs from the shapes
    of its tapped dense calls), and the peak device memory of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.nn.layers import dense_tap
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    batch = {"src_embed": torch.randn(
        XATTN_SRC_BATCH, cfg.src_len, cfg.d_model, generator=gen,
        device=dev).to(torch.bfloat16),
        "tokens": torch.randint(2, cfg.vocab, (XATTN_SRC_BATCH,
                                               XATTN_PREFILL_TOKENS),
                                generator=gen, device=dev)}
    macs = []
    with dense_tap(lambda p, x: macs.append(
            x.numel() * p["w_scale"].numel()) if "w_packed" in p else None):
        model.prefill(params, batch)              # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = read_launches()["qmatmul"]
    if (logits.shape != (XATTN_SRC_BATCH, 1, logits.shape[-1])
            or not bool(torch.isfinite(logits[..., :cfg.vocab]).all())):
        raise AssertionError(f"[xattn] prefill logits {tuple(logits.shape)}"
                             " not finite or of the wrong shape")
    busy = _device_us(prof) or None
    ours = _device_us(prof, ("qmatmul_kernel",))
    row = {"src_frames": cfg.src_len, "batch": XATTN_SRC_BATCH,
           "tokens": XATTN_PREFILL_TOKENS, "wall_ms": wall_us / 1e3,
           "device_busy_ms": None if busy is None else busy / 1e3,
           "device_idle_share": None if busy is None
           else max(0.0, 1.0 - busy / wall_us),
           "qmatmul_device_ms": ours / 1e3 if ours else None,
           "qmatmul_launches": launches[1] + launches[2],
           "gemm_macs": sum(macs),
           "gemm_bound_ms": 2 * sum(macs) / PEAK_INT8_OPS * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    say("xattn", profile="prefill", arch=cfg.name, w_bits=cfg.quant.w_bits,
        **row)
    report.setdefault("xattn_profile_prefill", {})[cfg.name] = row


def decode_vs_forward(dev, cfg, fp, p4, report):
    """tests/test_decode_agreement.py on the card: the cross cache filled
    by `Model.fill_cross_kv` (seamless: `encode` over the source; vision:
    the source embeddings), XATTN_DVF_STEPS positions decoded one by one
    against the teacher-forced forward, float32 compute, batch 2, the
    config's src_len: within XATTN_DVF_RTOL of the largest |logit| with
    quantization off. The W4A8 artifact's error and greedy agreement are
    reported beside it."""
    import dataclasses
    import torch
    from repro_torch.models.api import build
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, s, v = 2, XATTN_DVF_STEPS, cfg.vocab
    toks = torch.randint(2, v, (b, s), generator=gen, device=dev)
    src = torch.randn(b, cfg.src_len, cfg.d_model, generator=gen,
                      device=dev) * 0.05
    row = {}
    for name, model, params in (("fp", build(f32), fp),
                                ("w4a8", _lm_model(f32, 4), p4)):
        lf = model.forward(params, {"tokens": toks, "src_embed": src})[0][
            ..., :v]
        cache = model.fill_cross_kv(params, model.init_cache(
            b, s, torch.float32, device=dev), src)
        err, agree = 0.0, 0
        for t in range(s):
            lg, cache = model.decode(params, cache, toks[:, t:t + 1], t)
            lg = lg[:, 0, :v]
            err = max(err, float((lg - lf[:, t]).abs().max()))
            agree += int((lg.argmax(-1) == lf[:, t].argmax(-1)).sum())
        row[name] = {"max_abs_err": err,
                     "tol": XATTN_DVF_RTOL * float(lf.abs().max()),
                     "greedy_agree": f"{agree}/{b * s}"}
        del lf, cache
    if row["fp"]["max_abs_err"] > row["fp"]["tol"]:
        raise AssertionError(f"[xattn] {cfg.name}: decode against forward "
                             f"{row['fp']}")
    say("xattn", check="decode_vs_forward", arch=_label(cfg),
        src_len=cfg.src_len, positions=s, compute="float32",
        **{f"{k}_{f}": x for k, r in row.items() for f, x in r.items()})
    report.setdefault("xattn_decode_vs_forward", {})[cfg.name] = row


def xattn_path(dev, arch, report):
    """Serve one cross-attention arch from seeded weights made and
    quantized on the card, one width at a time: W8A8, W4A8, W4A8
    double-buffered (the same tokens) and W2A8 through `Engine`, the cross
    cache at zero as the reference's `Engine` leaves it; then at W4A8
    every int dense call of one decode step against the CPU plain path
    and one profiled decode step; for seamless one full-length encoder
    layer and one cross_kv_project against the CPU, the profiled prefill,
    and a plan with every dec_layers/mlp/wi split W8 | W4; decode against
    forward on the card; then the CLI at W4A8. Returns the kernels' launch
    counts over the two serving windows."""
    import torch
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.api import build

    cfg = _xattn_config(arch)
    label = _label(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp = build(cfg).init(SEED, device=dev)

    def pack(model, w_bits, plan=None):
        return apply_plan(int_skeleton(model.defs()), fp, plan, w_bits)

    models = {w: _lm_model(cfg, w) for w in WIDTHS}
    db = _lm_model(cfg, 4, pipeline="double_buffer")
    params = pack(models[8], 8)
    _decode_once(dev, models[8], params)
    reset_launches()
    outs = {8: serve_lm(f"{label} W8A8", models[8], params, report, "xattn")}
    del params
    p4 = pack(models[4], 4)
    outs[4] = serve_lm(f"{label} W4A8", models[4], p4, report, "xattn")
    out_db = serve_lm(f"{label} W4A8 double_buffer", db, p4, report,
                      "xattn")
    params = pack(models[2], 2)
    outs[2] = serve_lm(f"{label} W2A8", models[2], params, report, "xattn")
    del params
    torch.cuda.synchronize()
    first = read_launches()
    if out_db != outs[4]:
        raise AssertionError(f"[xattn] {arch}: double_buffer tokens differ "
                             "from 'off'")
    require_launches(label, first, ("qmatmul",))
    _check_dense_calls(dev, models[4], p4, "xattn")
    profile_decode_step(dev, models[4], p4, report, "xattn")
    if cfg.family == "encdec":
        _check_encoder_calls(dev, models[4], p4)
        profile_prefill(dev, models[4], p4, report)
    decode_vs_forward(dev, cfg, fp, p4, report)
    del p4
    gc.collect()
    torch.cuda.empty_cache()

    reset_launches()
    needed = ("qmatmul",)
    if cfg.family == "encdec":
        plan = PrecisionPlan(rules=(PlanRule("dec_layers/mlp/wi", 8,
                                             segments=XATTN_RUNS),),
                             default_w_bits=4)
        pm = _lm_model(cfg, 4, plan=plan)
        pp = pack(pm, 4, plan)
        serve_lm(f"{label} plan dec wi W8|W4", pm, pp, report, "xattn")
        del pp
        needed = ("qmatmul_segmented", "qmatmul")
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    cut = (["--layers", str(XATTN_LAYERS[arch])] if arch in XATTN_LAYERS
           else [])
    t0 = time.perf_counter()
    cli = serve_cli.main(["--arch", arch, "--quant", "w4a8", "--requests",
                          str(LM_REQUESTS), "--batch", str(LM_BATCH),
                          "--max-new", str(LM_MAX_NEW)] + cut)
    torch.cuda.synchronize()
    second = read_launches()
    if len(cli) != LM_REQUESTS or not all(len(r.out) for r in cli):
        raise AssertionError(f"[xattn] the serve CLI returned no tokens for "
                             f"{arch}")
    say("xattn", cli=" ".join(["python -m repro_torch.launch.serve --arch",
                               arch, "--quant w4a8"] + cut),
        seconds=round(time.perf_counter() - t0, 1))
    require_launches(f"{label} plan + CLI" if len(needed) > 1
                     else f"{label} CLI", second, needed, stages_needed=(1,))
    del cli
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: {s: first[k][s] + second[k][s] for s in (1, 2)}
                for k in first}
    report.setdefault("launches", {})[arch] = launches
    return launches


def xattn_cpu_check(dev, report):
    """seamless-m4t-large-v2's widths at XATTN_CPU_LAYERS encoder and
    decoder layers, its source cut from 4096 to XATTN_CPU_SRC frames,
    float32 compute, fp weights from a CPU generator: the W4A8 artifact
    packed on the card is byte-identical to the CPU's; the teacher-forced
    forward over the prompt, then LM_CPU_PROMPT prompt tokens and
    LM_CPU_STEPS greedy steps decoded over the cross cache each device
    fills from `encode`, stay within LM_CPU_RTOL of the largest CPU logit,
    and greedy tokens agree wherever the CPU's top-1 margin exceeds
    that."""
    import dataclasses
    import torch
    from repro_torch.convert import to_device
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.models.api import build
    arch = XATTN_ARCHS[0]
    cfg = _xattn_config(arch, enc_layers=XATTN_CPU_LAYERS,
                        dec_layers=XATTN_CPU_LAYERS,
                        n_layers=2 * XATTN_CPU_LAYERS, src_len=XATTN_CPU_SRC,
                        compute_dtype="float32")
    fp_cpu = build(cfg).init(SEED, device="cpu")
    model = _lm_model(cfg, 4)
    q = {d: apply_plan(int_skeleton(model.defs()), to_device(fp_cpu, d),
                       None, 4) for d in ("cpu", dev)}
    diff = first_difference(to_device(q[dev], "cpu"), q["cpu"])
    if diff is not None:
        raise AssertionError(f"[xattn] {arch}: the W4A8 artifact packed on "
                             f"the card differs from the CPU's at {diff}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    prompt = torch.randint(2, cfg.vocab, (2, LM_CPU_PROMPT), generator=gen)
    src = torch.randn(2, cfg.src_len, cfg.d_model, generator=gen)
    v = cfg.vocab
    fwd = {d: model.forward(q[d], {"tokens": prompt.to(d),
                                   "src_embed": src.to(d)})[0][..., :v].cpu()
           for d in ("cpu", dev)}
    tol = LM_CPU_RTOL * float(fwd["cpu"].abs().max())
    worst = float((fwd[dev] - fwd["cpu"]).abs().max())
    total = LM_CPU_PROMPT + LM_CPU_STEPS
    caches = {d: model.fill_cross_kv(q[d], model.init_cache(
        2, total, torch.float32, device=d), src.to(d)) for d in ("cpu", dev)}
    agreed, compared = 0, 0
    tok = prompt[:, :1]
    for t in range(total):
        lg = {d: model.decode(q[d], caches[d], tok.to(d), t)[0][:, -1]
              .cpu()[:, :v] for d in ("cpu", dev)}
        ref, got = lg["cpu"], lg[dev]
        worst = max(worst, float((got - ref).abs().max()))
        if t >= LM_CPU_PROMPT - 1:
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > tol
            same = got.argmax(-1) == ref.argmax(-1)
            compared += int(sure.sum())
            agreed += int((same & sure).sum())
        tok = (prompt[:, t + 1:t + 2] if t + 1 < LM_CPU_PROMPT
               else ref.argmax(-1, keepdim=True))
    if worst > tol or agreed != compared:
        raise AssertionError(f"[xattn] {arch} card vs CPU: max |dlogit| "
                             f"{worst} (tol {tol}), greedy tokens "
                             f"{agreed}/{compared} where the margin exceeds "
                             "tol")
    row = {"layers": f"{XATTN_CPU_LAYERS}+{XATTN_CPU_LAYERS}",
           "src_len": f"{XATTN_CPU_SRC} (cut from 4096)",
           "artifact_equal_cpu": True, "max_abs_logit_err": worst,
           "tol": tol, "greedy_agree": f"{agreed}/{compared}"}
    say("xattn", check="card_vs_cpu", arch=arch, w_bits=4,
        compute="float32", **row)
    report["xattn_cpu_check"] = row


# ------------------------------------------------------------ [moe] ---

MOE_ARCHS = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b")
# each served at its full width with its depth cut to one layer (of 61
# and 48): one layer's routed experts are 33.8 and 32.2 GB of bfloat16,
# so two layers would leave the card under 10 GB
MOE_LAYERS = 1
# (K, N) of the MoE archs' int denses, which no earlier path gives
# kernels 1-2: kimi's wq / wo (7168x7168), wk / wv (7168x896 = 8 heads of
# 112), shared wi / wg (7168x2048) and shared wo (2048x7168); llama4's
# 5120x5120, 5120x1024, 5120x8192 and 8192x5120; all at M = 4
MOE_SHAPES = ((7168, 7168), (7168, 896), (7168, 2048), (2048, 7168),
              (5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120))
# kernel 3 on each arch's layers/moe/shared/wi (K, N), half W8, half W4
MOE_SHARED_WI = {"kimi-k2-1t-a32b": (7168, 2048),
                 "llama4-maverick-400b-a17b": (5120, 8192)}
# the CPU cross-check at full width, float32, with the routed experts
# cut (top-k kept): 384 float32 experts of kimi alone would take 67.6 GB
# of host memory
MOE_CPU_EXPERTS = {"kimi-k2-1t-a32b": 16, "llama4-maverick-400b-a17b": 8}
MOE_AUX_ATOL, MOE_ROUTE_MARGIN = 1e-5, 1e-6


def _moe_runs(arch):
    n = MOE_SHARED_WI[arch][1]
    return ((0, n // 2, 8), (n // 2, n, 4))


def moe_kernel_phase(dev, report):
    """Kernels 1-2 at MOE_SHAPES, M = 4, A8 x W{8,4,2}; kernel 3 on each
    arch's shared wi split W8 | W4 at A{8,4,2}: signed activations, a
    per-channel scale, both output dtypes, both STAGES, identical to the
    plain version on the card. The operands are drawn on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    worst, n_cmp = _no_errors()
    cases = []
    for k, n in MOE_SHAPES:
        for w_bits in WIDTHS:
            cases.append(DenseCase(4, k, n, 8, w_bits, gen, dev))
    for arch in MOE_ARCHS:
        k, n = MOE_SHARED_WI[arch]
        seg_w = None
        for a_bits in WIDTHS:
            c = DenseCase(4, k, n, a_bits, 8, gen, dev, runs=_moe_runs(arch),
                          w=seg_w)
            seg_w = c.weights()
            cases.append(c)
    compare_dense_cases("moe", cases, worst, n_cmp)
    report["moe_kernel_phase"] = {
        "comparisons": n_cmp, "shapes": [list(s) for s in MOE_SHAPES],
        "m": 4, "shared_wi": MOE_SHARED_WI}
    return worst


def _expert_step_extra(dev, cfg, params):
    """The routed experts of one decode step alone (every expert at the
    step's capacity, as `moe_apply` runs them): ms per call by CUDA
    events over back-to-back calls, beside the bound of streaming their
    weights once. Not the profiler: its per-pass count rounds a kernel
    that runs twice a call (wi, wg) down to once when the trace misses
    records, and on an H100 that read 7.06 ms against the 10.10 ms
    bound of kimi's experts."""
    import torch
    from repro_torch.models.lm import _moe_cfg, layer_params
    from repro_torch.nn.mlp import _experts
    mcfg = _moe_cfg(cfg)
    moe = layer_params(params["layers"], 0)["moe"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    xin = torch.randn(1, mcfg.n_experts, mcfg.capacity(LM_BATCH),
                      cfg.d_model, generator=gen, device=dev).to(
        moe["wi"].dtype)
    nbytes = _expert_bytes(params) / cfg.n_layers
    return {"experts_ms_per_layer": time_ms(
        lambda: _experts(xin, moe, mcfg.act), 2, 10),
        "experts_stream_bound_ms_per_layer": nbytes / PEAK_BYTES * 1e3,
        "expert_bytes_per_layer": nbytes}


def moe_path(dev, arch, report):
    """Serve one MoE arch at full width, MOE_LAYERS layer(s), from seeded
    weights made and quantized on the card one width at a time: W8A8,
    W4A8, W4A8 double-buffered (the same tokens) and W2A8 through
    `Engine` (the packed tree shares the fp tree's router and experts);
    then at W4A8 every int dense call of one decode step against the CPU
    plain path and one profiled decode step; a plan with every
    layers/moe/shared/wi split W8 | W4; then the CLI at W4A8 with
    ``--layers``. Returns the kernels' launch counts over the two serving
    windows."""
    import dataclasses
    import torch
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.api import build, get_config
    from repro_torch.nn.module import param_bytes

    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS)
    label = f"{arch} ({MOE_LAYERS} of {get_config(arch).n_layers} layers)"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp = build(cfg).init(SEED, device=dev)
    say("moe", arch=label, fp_param_bytes=param_bytes(fp),
        fp_init_peak_mem_bytes=torch.cuda.max_memory_allocated())

    def pack(model, w_bits, plan=None):
        q = apply_plan(int_skeleton(model.defs()), fp, plan, w_bits)
        if q["layers"]["moe"]["wi"].data_ptr() != \
                fp["layers"]["moe"]["wi"].data_ptr():
            raise AssertionError("[moe] the int tree copied the experts")
        return q

    models = {w: _lm_model(cfg, w) for w in WIDTHS}
    db = _lm_model(cfg, 4, pipeline="double_buffer")
    params = pack(models[8], 8)
    _decode_once(dev, models[8], params)
    reset_launches()
    outs = {8: serve_lm(f"{label} W8A8", models[8], params, report, "moe")}
    del params
    p4 = pack(models[4], 4)
    outs[4] = serve_lm(f"{label} W4A8", models[4], p4, report, "moe")
    out_db = serve_lm(f"{label} W4A8 double_buffer", db, p4, report, "moe")
    params = pack(models[2], 2)
    outs[2] = serve_lm(f"{label} W2A8", models[2], params, report, "moe")
    del params
    torch.cuda.synchronize()
    first = read_launches()
    if out_db != outs[4]:
        raise AssertionError(f"[moe] {arch}: double_buffer tokens differ "
                             "from 'off'")
    require_launches(label, first, ("qmatmul",))
    _check_dense_calls(dev, models[4], p4, "moe")
    profile_decode_step(dev, models[4], p4, report, "moe",
                        extra=_expert_step_extra(dev, cfg, p4))
    del p4

    reset_launches()
    plan = PrecisionPlan(rules=(PlanRule("layers/moe/shared/wi", 8,
                                         segments=_moe_runs(arch)),),
                         default_w_bits=4)
    pm = _lm_model(cfg, 4, plan=plan)
    pp = pack(pm, 4, plan)
    serve_lm(f"{label} plan shared wi W8|W4", pm, pp, report, "moe")
    del pp, fp
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cut = ["--layers", str(MOE_LAYERS)]
    cli = serve_cli.main(["--arch", arch, "--quant", "w4a8", "--requests",
                          str(LM_REQUESTS), "--batch", str(LM_BATCH),
                          "--max-new", str(LM_MAX_NEW)] + cut)
    torch.cuda.synchronize()
    second = read_launches()
    if len(cli) != LM_REQUESTS or not all(len(r.out) for r in cli):
        raise AssertionError(f"[moe] the serve CLI returned no tokens for "
                             f"{arch}")
    say("moe", cli=" ".join(["python -m repro_torch.launch.serve --arch",
                             arch, "--quant w4a8"] + cut),
        seconds=round(time.perf_counter() - t0, 1),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    require_launches(f"{label} plan + CLI", second,
                     ("qmatmul_segmented", "qmatmul"), stages_needed=(1,))
    del cli
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: {s: first[k][s] + second[k][s] for s in (1, 2)}
                for k in first}
    report.setdefault("launches", {})[arch] = launches
    return launches


def _moe_forward(model, params, tokens):
    """The forward's logits (real vocab, on the host) and aux, and the
    routing of its one MoE layer: `moe_route` on the block's input, which
    the shared expert's wi reads (captured with `dense_tap`)."""
    import torch
    from repro_torch.models.lm import _moe_cfg
    from repro_torch.nn.layers import dense_tap
    from repro_torch.nn.mlp import moe_route
    cfg = model.cfg
    wi = params["layers"]["moe"]["shared"]["wi"]["w_packed"]
    seen = []
    with dense_tap(lambda p, x: seen.append(x)
                   if p.get("w_packed") is not None
                   and p["w_packed"].data_ptr() == wi.data_ptr() else None):
        logits, aux, _ = model.forward(params, {"tokens": tokens})
    (x,) = seen
    b, s, d = x.shape
    route = moe_route(x.reshape(1, b * s, d),
                      params["layers"]["moe"]["router"][0], _moe_cfg(cfg))
    return (logits[..., :cfg.vocab].cpu(), float(aux),
            [t.cpu() for t in route])


KIMI_INSTRUCT_LAYERS = 2      # the dense layer and one MoE layer
KIMI_INSTRUCT_PROMPT, KIMI_INSTRUCT_STEPS = 64, 4
# the block's root-mean-square gaps to the plain reference on the main
# path, the prefill's attention on the fused kernel, which rounds its
# probabilities before the division by their sum where the reference
# rounds them after. On an H100 over 6 seeds: logits 0.019-0.026 but
# one decode row at 0.147, the latent 0.0171-0.0174; the A4 control
# 0.432-0.478 / 0.351-0.355. Each limit lies near the geometric mean of
# the two sides: 1.7 (logits) and 4.6 (latent) times the largest
# reading, 1.7 and 4.4 times below the control's least
KIMI_INSTRUCT_LOGITS_RTOL, KIMI_INSTRUCT_LATENT_RTOL = 0.25, 0.08
# the same with the attention on `_sdpa`, whose rounding the reference
# repeats: logits 0.0073-0.0145 and the latent 0.0011 on an H100 (two
# runs), with no routing choice upstream of the one MoE layer to flip;
# the limits are 3.4 and 4.5 times those
KIMI_SDPA_LOGITS_RTOL, KIMI_SDPA_LATENT_RTOL = 0.05, 0.005
# tokens routed for the grouped-GEMM check: one call of the benchmark
# cell (8 x 2048), about 341 rows a held expert
KIMI_GROUPED_TOKENS = 16384


def _plain_reference(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"plain_{name}", ROOT / "tests" / "plain_ref" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kimi_grouped_check(dev, report):
    """kimi-k2-instruct's held-expert GEMMs on the card: the row counts
    of a real routing (KIMI_GROUPED_TOKENS random tokens through a random
    sigmoid / noaux router over the 384 experts, top-8, the 48 of EP rank
    0 held, then one group emptied), `qmatmul_grouped` W4A8 at wi's (K
    7168 -> N 2048) and wo's (K 2048 -> N 7168) shapes, both pipelines,
    bfloat16 and float32 out: every group's rows identical to
    `qmatmul_packed_torch` on them, with that group's weights and scale
    (the empty group's none, its neighbours' rows in place)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels.qmatmul.kernel import (qmatmul_grouped,
                                                    qmatmul_packed_torch)
    from repro_torch.nn.mlp import MoeConfig, moe_select
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    d, f, held = 7168, 2048, 48
    mcfg = MoeConfig(d, f, 384, 8, scoring="sigmoid_noaux", norm_topk=True,
                     routed_scale=2.827, experts_held=held)
    router = {"router": torch.randn(d, 384, generator=gen, device=dev)
              * d ** -0.5,
              "router_bias": 1e-3 * torch.randn(384, generator=gen,
                                                device=dev)}
    tokens = torch.randn(KIMI_GROUPED_TOKENS, d, generator=gen, device=dev)
    _, idx = moe_select(tokens, router, mcfg)
    del tokens
    counts = torch.bincount(idx[idx < held], minlength=held).tolist()
    counts[1] = 0
    compared = 0
    for k, n in ((d, f), (f, d)):
        x = packing.pack(torch.randint(-127, 128, (sum(counts), k),
                                       generator=gen, device=dev,
                                       dtype=torch.int8), 8)
        w = torch.stack([packing.pack(
            torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                          dtype=torch.int8), 4, axis=0)
            for _ in range(held)])
        scale = torch.rand(held, n, generator=gen, device=dev) * 1e-3 + 1e-5
        for out_dtype in (torch.bfloat16, torch.float32):
            want, start = [], 0
            for e, c in enumerate(counts):
                want.append(qmatmul_packed_torch(
                    x[start:start + c], w[e], None, None, None, a_bits=8,
                    a_signed=True, w_bits=4, d=0, out_bits=8,
                    epilogue="dequant", scale=scale[e], out_dtype=out_dtype))
                start += c
            for pipeline in ("off", "double_buffer"):
                got = qmatmul_grouped(x, w, scale, counts, a_bits=8,
                                      w_bits=4, pipeline=pipeline,
                                      out_dtype=out_dtype)
                torch.cuda.synchronize()
                start = 0
                for e, c in enumerate(counts):
                    err = max_abs_err(got[start:start + c],
                                      want[e]) if c else 0.0
                    if got.dtype != out_dtype or err != 0.0:
                        raise AssertionError(
                            f"[moe] qmatmul_grouped {k}x{n} expert {e} "
                            f"({c} rows) {pipeline} {out_dtype}: dtype "
                            f"{got.dtype}, max abs err {err}")
                    compared += bool(c)
                    start += c
        del x, w, scale, want, got
    say("moe", check="grouped", arch="kimi-k2-instruct", experts=held,
        tokens=KIMI_GROUPED_TOKENS, rows=sum(counts),
        rows_min_max=[min(counts), max(counts)], empty_groups=counts.count(0),
        shapes="7168x2048,2048x7168", w_bits=4, a_bits=8,
        pipelines="off,double_buffer", out_dtypes="bfloat16,float32",
        groups_compared=compared, all_exact=True)
    report["kimi_grouped_check"] = {"counts": counts, "compared": compared}


@contextlib.contextmanager
def _sdpa_attention():
    """`attn_core` on `_sdpa` in place of the fused kernel."""
    from repro_torch.kernels import api
    takes = api.attention_takes
    api.attention_takes = lambda *args: False
    try:
        yield
    finally:
        api.attention_takes = takes


def kimi_instruct_readings(dev, seed=SEED):
    """Kimi-K2-Instruct at its published widths, the dense layer and one
    MoE layer holding 48 of the 384 experts (EP rank 0 of 8), served
    W4A8 from weights drawn on the card from ``seed``: `Model.prefill`
    of 2 x KIMI_INSTRUCT_PROMPT tokens, its latent into a cache, then
    KIMI_INSTRUCT_STEPS `Model.decode` steps. Root-mean-square gaps over
    the plain reference's (`tests/plain_ref/mla_moe_lm.py`, A8) root-
    mean-square of the prefill's and each step's logit row and of each
    layer's latent (the largest), for three runs: ``main``, the main
    path (the prefill's attention on the fused kernel); ``sdpa``, the
    same with the attention on `_sdpa` (`_sdpa_attention`); ``control``,
    the reference at A4 in the program's place. Also the kernels' launch
    counts over the main run alone and the peak memory."""
    import dataclasses
    import torch
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.launch.convert import convert_params
    from repro_torch.models import lm
    from repro_torch.models.api import build, get_config
    from repro_torch.nn.layers import QOFF, QuantConfig
    ref = _plain_reference("mla_moe_lm")
    base = get_config("kimi-k2-instruct")
    cfg = dataclasses.replace(
        base, n_layers=KIMI_INSTRUCT_LAYERS, remat=False,
        moe=dataclasses.replace(base.moe, experts_held=48),
        quant=QuantConfig(mode="int", w_bits=4, a_bits=8, a_absmax=4.0))
    rcfg = json.loads((ROOT / "portbench" / "configs" /
                       "kimi-k2-instruct-w4a8-ep8.json").read_text())
    rcfg["num_hidden_layers"] = KIMI_INSTRUCT_LAYERS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp = build(dataclasses.replace(cfg, quant=QOFF)).init(seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    rb = fp["layers"]["moe"]["router_bias"]
    rb.copy_(1e-3 * torch.randn(rb.shape, generator=gen, device=dev))
    model = build(cfg)
    params = convert_params(int_skeleton(model.defs()), fp, 4)
    total = KIMI_INSTRUCT_PROMPT + KIMI_INSTRUCT_STEPS
    toks = torch.randint(0, cfg.vocab, (2, total), generator=gen,
                         device=dev)
    p = KIMI_INSTRUCT_PROMPT

    def serve():
        with torch.inference_mode():
            last, kvs = model.prefill(params, {"tokens": toks[:, :p]})
            cache = lm.cache_from_prefill(cfg, kvs, total)
            rows = [last[:, 0, :cfg.vocab].float()]
            for t in range(p, total):
                out, cache = model.decode(params, cache, toks[:, t:t + 1], t)
                rows.append(out[:, 0, :cfg.vocab].float())
        return torch.stack(rows, 1), kvs

    torch.cuda.synchronize()
    reset_launches()
    runs = {"main": serve()}
    torch.cuda.synchronize()
    launches = read_launches()
    with _sdpa_attention():
        runs["sdpa"] = serve()
    peak = torch.cuda.max_memory_allocated()
    del params

    def layer_weights(i):
        if i < cfg.first_dense_layers:
            return lm.layer_params(fp["dense_layers"], i)
        return lm.layer_params(fp["layers"], i - cfg.first_dense_layers)

    def reference(a_bits):
        seen = {}
        (rows,) = ref.logits(rcfg, {k: fp[k] for k in ("embed", "final_norm",
                                                       "head")},
                             layer_weights, [toks], a_bits, last_only=False,
                             on_latent=lambda i, slot, c, pe:
                             seen.__setitem__(i, (c[:, :p], pe[:, :p])))
        kvs = ([seen[i][0] for i in range(cfg.n_layers)],
               [seen[i][1] for i in range(cfg.n_layers)])
        return rows[:, p - 1:], kvs

    want, seen = reference(8)
    runs["control"] = reference(4)
    del fp

    def rms(got, w):
        return float((got.float() - w.float()).norm() / w.float().norm())

    gaps = {name: {"prefill": rms(rows[:, 0], want[:, 0]),
                   "decode": [rms(rows[:, j], want[:, j])
                              for j in range(1, rows.shape[1])],
                   "latent": max(max(rms(kvs[0][i], seen[0][i]),
                                     rms(kvs[1][i], seen[1][i]))
                                 for i in range(cfg.n_layers))}
            for name, (rows, kvs) in runs.items()}
    del runs, want, seen
    gc.collect()
    torch.cuda.empty_cache()
    return dict(gaps, launches=launches, peak_mem_bytes=peak)


def kimi_instruct_block(dev, report):
    """`kimi_instruct_readings` gated: the main path within
    KIMI_INSTRUCT_LOGITS_RTOL (the prefill's and every step's logits)
    and KIMI_INSTRUCT_LATENT_RTOL, the `_sdpa` run within the tighter
    KIMI_SDPA_* limits, the A4 control outside the main path's; kernel
    1 and the fused attention kernel launched on the main path. Returns
    the main run's launch counts."""
    r = kimi_instruct_readings(dev)

    def within(g, logits, latent):
        return (max([g["prefill"]] + g["decode"]) <= logits
                and g["latent"] <= latent)

    limits = {"main": (KIMI_INSTRUCT_LOGITS_RTOL, KIMI_INSTRUCT_LATENT_RTOL),
              "sdpa": (KIMI_SDPA_LOGITS_RTOL, KIMI_SDPA_LATENT_RTOL)}
    ok = {name: within(r[name], *lim) for name, lim in limits.items()}
    ok["control_outside"] = not within(r["control"], *limits["main"])
    for name in ("main", "sdpa", "control"):
        g = r[name]
        say("moe", kimi_instruct=f"{KIMI_INSTRUCT_LAYERS} of 61 layers, 48 "
            "of 384 experts, W4A8", run=name,
            prompt=f"2x{KIMI_INSTRUCT_PROMPT}", steps=KIMI_INSTRUCT_STEPS,
            prefill_rms_rel_err=g["prefill"],
            decode_rms_rel_err=g["decode"], latent_rms_rel_err=g["latent"],
            limits=list(limits.get(name, limits["main"])))
    say("moe", kimi_instruct="gates", peak_mem_bytes=r["peak_mem_bytes"],
        **ok)
    report["kimi_instruct_block"] = {k: r[k] for k in
                                     ("main", "sdpa", "control",
                                      "peak_mem_bytes")}
    if not all(ok.values()):
        raise AssertionError(f"[moe] kimi-k2-instruct against the plain "
                             f"reference: {ok}, {r}")
    launches = r["launches"]
    if launches["attn"][2] == 0:
        raise AssertionError("attn never launched on the kimi-k2-instruct "
                             "main path")
    require_launches("kimi-k2-instruct", launches, ("qmatmul",),
                     stages_needed=(1,))
    report.setdefault("launches", {})["kimi-k2-instruct"] = launches
    return launches


def moe_cpu_check(dev, arch, report):
    """One MoE arch at its full width, MOE_LAYERS layer(s) and
    MOE_CPU_EXPERTS routed experts (top-k kept), float32 params and
    compute, fp weights from a CPU generator: the W4A8 artifact packed on
    the card is byte-identical to the CPU's; the forward over
    LM_CPU_PROMPT tokens stays within LM_CPU_RTOL of the largest CPU
    logit, its aux within MOE_AUX_ATOL, and its routing (experts,
    position, keep) equal wherever the k-th and (k+1)-th probability of a
    token differ by more than MOE_ROUTE_MARGIN; then the prompt and
    LM_CPU_STEPS greedy steps, one decode step each on both devices, stay
    within the same tolerance, greedy tokens equal where the CPU's top-1
    margin exceeds it."""
    import dataclasses
    import torch
    from repro_torch.convert import to_device
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.models.api import build, get_config
    base = get_config(arch)
    cfg = dataclasses.replace(
        base, n_layers=MOE_LAYERS, compute_dtype="float32",
        param_dtype="float32", moe=dataclasses.replace(
            base.moe, n_experts=MOE_CPU_EXPERTS[arch]))
    fp_cpu = build(cfg).init(SEED, device="cpu")
    model = _lm_model(cfg, 4)
    q = {d: apply_plan(int_skeleton(model.defs()), to_device(fp_cpu, d),
                       None, 4) for d in ("cpu", dev)}
    del fp_cpu
    diff = first_difference(to_device(q[dev], "cpu"), q["cpu"])
    if diff is not None:
        raise AssertionError(f"[moe] {arch}: the W4A8 artifact packed on "
                             f"the card differs from the CPU's at {diff}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    prompt = torch.randint(2, cfg.vocab, (2, LM_CPU_PROMPT), generator=gen)
    fwd = {d: _moe_forward(model, q[d], prompt.to(d)) for d in ("cpu", dev)}
    (ref, ref_aux, ref_route), (got, got_aux, got_route) = \
        fwd["cpu"], fwd[dev]
    tol = LM_CPU_RTOL * float(ref.abs().max())
    worst = float((got - ref).abs().max())
    k = cfg.moe.top_k
    top = ref_route[0].sort(dim=-1, descending=True).values
    sure = (top[..., k - 1] - top[..., k]) > MOE_ROUTE_MARGIN
    # a choice's position counts the choices of every token before it:
    # held up to the first token whose top-k is not sure
    upto = torch.cumprod(sure.to(torch.int32), dim=-1).bool()
    routed = int(sure.sum())
    for name, a, b, mask in zip(("experts", "pos", "keep"), got_route[2:],
                                ref_route[2:], (sure, upto, upto)):
        if not torch.equal(a[mask], b[mask]):
            raise AssertionError(f"[moe] {arch}: routing ({name}) on the "
                                 "card differs from the CPU's")
    aux_err = abs(got_aux - ref_aux)
    total = LM_CPU_PROMPT + LM_CPU_STEPS
    caches = {d: model.init_cache(2, total, torch.float32, device=d)
              for d in ("cpu", dev)}
    agreed, compared = 0, 0
    tok = prompt[:, :1]
    for t in range(total):
        lg = {d: model.decode(q[d], caches[d], tok.to(d), t)[0][:, -1]
              .cpu()[:, :cfg.vocab] for d in ("cpu", dev)}
        r, g = lg["cpu"], lg[dev]
        worst = max(worst, float((g - r).abs().max()))
        if t >= LM_CPU_PROMPT - 1:
            top2 = r.topk(2, dim=-1).values
            ok = (top2[:, 0] - top2[:, 1]) > tol
            compared += int(ok.sum())
            agreed += int(((g.argmax(-1) == r.argmax(-1)) & ok).sum())
        tok = (prompt[:, t + 1:t + 2] if t + 1 < LM_CPU_PROMPT
               else r.argmax(-1, keepdim=True))
    if worst > tol or agreed != compared or aux_err > MOE_AUX_ATOL:
        raise AssertionError(f"[moe] {arch} card vs CPU: max |dlogit| "
                             f"{worst} (tol {tol}), aux err {aux_err}, "
                             f"greedy tokens {agreed}/{compared} where the "
                             "margin exceeds tol")
    row = {"layers": cfg.n_layers,
           "experts": f"{cfg.moe.n_experts} (cut from {base.moe.n_experts})",
           "top_k": k, "artifact_equal_cpu": True,
           "routed_tokens_compared": f"{routed}/{sure.numel()}",
           "positions_compared": f"{int(upto.sum())}/{sure.numel()}",
           "routing_equal": True, "aux_abs_err": aux_err,
           "max_abs_logit_err": worst, "tol": tol,
           "greedy_agree": f"{agreed}/{compared}"}
    say("moe", check="card_vs_cpu", arch=arch, w_bits=4, compute="float32",
        **row)
    report.setdefault("moe_cpu_check", {})[arch] = row


# ----------------------------------------------------------- [deploy] ---

# the deploy flow's card-vs-CPU check: qwen2.5-3b's full width at this
# depth, float32 compute, the CLI's calibration batches. a_absmax: the max
# of a float32 activation (cuBLAS and the CPU's BLAS sum in other orders);
# sens(b): float32 sums of squared errors, the W8 error ~1/250 of the
# output, so the outputs' rounding shows ~250x larger in it
DEPLOY_CPU_LAYERS = 2
DEPLOY_ABSMAX_RTOL, DEPLOY_SENS_RTOL = 1e-5, 1e-3
# free disk the phase needs: the fp checkpoint (12.4 GB of float32) and
# the packed artifact (~3 GB)
DEPLOY_DISK_BYTES = 16e9


def _captured(fn, *args):
    """fn(*args) with its standard output captured; the output is
    printed after it, and returned beside fn's result."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def deploy_path(dev, work, report):
    """The LM deployment flow at qwen2.5-3b's full width and depth from
    seeded weights drawn on the card: the fp tree saved with `ckpt.save`
    and restored (equal leaf for leaf); the CLI `repro_torch.launch.deploy
    --ckpt` calibrates, plans, packs and saves the artifact; the CLI
    `repro_torch.launch.serve --ckpt --plan` serves the plan, its params
    bytes equal to deploy's mixed bytes, kernel 1 launched; the saved
    artifact, restored onto the card, equal leaf for leaf to `apply_plan`
    of the same plan over the same fp tree. Returns the kernels' launch
    counts over the two CLIs."""
    import re
    import shutil
    import torch
    from repro_torch.ckpt import checkpoint
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import load_plan
    from repro_torch.launch import deploy as deploy_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.api import build, get_config
    from repro_torch.nn.module import param_bytes

    cfg = get_config(LM_ARCH)
    free = shutil.disk_usage(work).free
    say("deploy", disk_free_bytes=free, work_dir=work.relative_to(ROOT))
    if free < DEPLOY_DISK_BYTES:
        raise AssertionError(f"[deploy] {free} bytes free under {work}; "
                             f"the phase writes ~{DEPLOY_DISK_BYTES:.0f}")
    ckpt, art, plan_path = work / "ckpt", work / "art", work / "plan.json"
    torch.cuda.reset_peak_memory_stats()
    fp = build(cfg).init(SEED, device=dev)
    fp_bytes = param_bytes(fp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(ckpt, 0, {"params": fp})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = checkpoint.restore(ckpt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = first_difference(back["params"], fp)
    if diff is not None:
        raise AssertionError(f"[deploy] the restored fp checkpoint differs "
                             f"at {diff}")
    del back
    row = {"fp_bytes": fp_bytes, "leaves": len(list(ckpt.rglob("*.npy"))),
           "save_s": save_s, "save_gb_per_s": fp_bytes / save_s / 1e9,
           "restore_s": restore_s,
           "restore_gb_per_s": fp_bytes / restore_s / 1e9,
           "restored_equal": True}
    say("deploy", ckpt=f"{LM_ARCH} fp float32", **{
        k: (round(v, 3) if isinstance(v, float) else v)
        for k, v in row.items()})
    report["deploy_ckpt"] = row

    reset_launches()
    t0 = time.perf_counter()
    summary = deploy_cli.main(["--arch", LM_ARCH, "--ckpt", str(ckpt),
                               "--budget", "auto", "--out", str(plan_path),
                               "--artifact", str(art)])
    deploy_s = time.perf_counter() - t0
    plan = summary["plan"]
    row = {"seconds": deploy_s, "calibrate_s": summary["calibrate_s"],
           "rules": len(plan.rules), "w_bits": list(plan.distinct_w_bits()),
           "rule_w_bits": {r.pattern: r.w_bits for r in plan.rules},
           "budget": summary["budget"],
           "total_sensitivity": plan.meta["total_sensitivity"],
           "fp_bytes": summary["fp_bytes"], "w8_bytes": summary["w8_bytes"],
           "mixed_bytes": summary["mixed_bytes"],
           "mixed_over_w8": summary["mixed_bytes"] / summary["w8_bytes"]}
    say("deploy", cli=f"python -m repro_torch.launch.deploy --arch "
        f"{LM_ARCH} --ckpt --budget auto", **{
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in row.items() if k != "rule_w_bits"})
    report["deploy_cli"] = row

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, text = _captured(serve_cli.main, [
        "--arch", LM_ARCH, "--ckpt", str(ckpt), "--plan", str(plan_path),
        "--requests", str(LM_REQUESTS), "--batch", str(LM_BATCH),
        "--max-new", str(LM_MAX_NEW)])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    served = int(re.search(r"\((\d[\d,]*) bytes\)", text).group(1)
                 .replace(",", ""))
    if served != summary["mixed_bytes"]:
        raise AssertionError(f"[deploy] serve's params {served} bytes != "
                             f"deploy's mixed {summary['mixed_bytes']}")
    if len(out) != LM_REQUESTS or not all(len(r.out) for r in out):
        raise AssertionError("[deploy] the serve CLI returned no tokens")
    require_launches(f"{LM_ARCH} deploy + serve --ckpt --plan", launches,
                     ("qmatmul",), stages_needed=(1,))
    tok = re.search(r"= ([\d.]+) tok/s", text)
    lat = re.search(r"p50=([\d.]+)ms p95=([\d.]+)ms", text)
    row = {"param_bytes": served, "equals_mixed_bytes": True,
           "tok_per_s": float(tok.group(1)),
           "wave_p50_ms": float(lat.group(1)),
           "wave_p95_ms": float(lat.group(2)), "seconds": serve_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": torch.cuda.get_device_name(0)}
    say("deploy", serve=f"python -m repro_torch.launch.serve --arch "
        f"{LM_ARCH} --ckpt --plan", **{
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in row.items()})
    report["deploy_serve"] = row

    t0 = time.perf_counter()
    got, _ = checkpoint.restore(art)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if load_plan(art / "plan.json").to_json() != plan.to_json():
        raise AssertionError("[deploy] the artifact's plan.json differs")
    q_model = _lm_model(cfg, plan.default_w_bits, plan=plan)
    want = apply_plan(int_skeleton(q_model.defs()), fp, plan,
                      plan.default_w_bits)
    diff = first_difference(got["params"], want)
    if diff is not None:
        raise AssertionError(f"[deploy] the restored artifact differs from "
                             f"apply_plan's at {diff}")
    art_bytes = param_bytes(got)
    row = {"bytes": art_bytes, "restore_s": restore_s,
           "restore_gb_per_s": art_bytes / restore_s / 1e9,
           "equal_apply_plan": True}
    say("deploy", check="artifact round trip", **{
        k: (round(v, 3) if isinstance(v, float) else v)
        for k, v in row.items()})
    report["deploy_artifact"] = row
    report.setdefault("launches", {})["deploy"] = launches
    return launches


def deploy_cpu_check(dev, report):
    """qwen2.5-3b's full width at DEPLOY_CPU_LAYERS layers, float32
    compute, fp weights from a CPU generator, the CLI's calibration
    batches: `calibrate` on the card and on the CPU agree (a_absmax within
    DEPLOY_ABSMAX_RTOL, sens(b) within DEPLOY_SENS_RTOL); the plan the
    card's stats give, packed on both devices, gives byte-identical
    artifacts."""
    import dataclasses
    from repro_torch.convert import to_device
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.calibrate import calibrate
    from repro_torch.deploy.planner import auto_budget, plan_mixed_precision
    from repro_torch.launch.deploy import calib_batches
    from repro_torch.models.api import build, get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=DEPLOY_CPU_LAYERS,
                              compute_dtype="float32")
    model = build(cfg)
    fp = {"cpu": model.init(SEED, device="cpu")}
    fp[dev] = to_device(fp["cpu"], dev)
    batches = calib_batches(cfg.vocab, seed=SEED)
    stats = {d: calibrate(model, fp[d], batches) for d in ("cpu", dev)}
    if list(stats[dev]) != list(stats["cpu"]):
        raise AssertionError("[deploy] card and CPU calibrate other paths")
    absmax_err, sens_err = 0.0, 0.0
    for path, want in stats["cpu"].items():
        got = stats[dev][path]
        if (got.layers, got.d_in, got.d_out, got.taps) != \
                (want.layers, want.d_in, want.d_out, want.taps):
            raise AssertionError(f"[deploy] {path}: shapes or taps differ")
        absmax_err = max(absmax_err, abs(got.a_absmax - want.a_absmax)
                         / want.a_absmax)
        for b in WIDTHS:
            sens_err = max(sens_err, abs(got.sens(b) - want.sens(b))
                           / want.sens(b))
    if absmax_err > DEPLOY_ABSMAX_RTOL or sens_err > DEPLOY_SENS_RTOL:
        raise AssertionError(f"[deploy] card vs CPU calibration: a_absmax "
                             f"rel err {absmax_err} (tol "
                             f"{DEPLOY_ABSMAX_RTOL}), sens rel err "
                             f"{sens_err} (tol {DEPLOY_SENS_RTOL})")
    plans = {d: plan_mixed_precision(
        stats[d], auto_budget(stats[d]), meta={"arch": cfg.name})
        for d in ("cpu", dev)}
    plan = plans[dev]
    q_model = _lm_model(cfg, plan.default_w_bits, plan=plan)
    q = {d: apply_plan(int_skeleton(q_model.defs()), fp[d], plan,
                       plan.default_w_bits) for d in ("cpu", dev)}
    diff = first_difference(to_device(q[dev], "cpu"), q["cpu"])
    if diff is not None:
        raise AssertionError(f"[deploy] the card's plan packed on the card "
                             f"differs from the CPU's packing at {diff}")
    row = {"layers": DEPLOY_CPU_LAYERS, "paths": len(stats["cpu"]),
           "absmax_rel_err": absmax_err, "absmax_tol": DEPLOY_ABSMAX_RTOL,
           "sens_rel_err": sens_err, "sens_tol": DEPLOY_SENS_RTOL,
           "plan_rules_equal_cpu_plan": plans[dev].rules == plans["cpu"].rules,
           "w_bits": list(plan.distinct_w_bits()),
           "artifact_equal_cpu": True}
    say("deploy", check="card_vs_cpu", arch=LM_ARCH, compute="float32",
        **row)
    report["deploy_cpu_check"] = row


# ------------------------------------------------------------ [mesh] ---

# (data, model) layouts of the kernel wall; every position on the one card
MESHES = ((1, 1), (1, 4), (4, 1), (2, 2), (8, 1))
# the served layouts, (1, 1) as the mesh path's own baseline
MESH_SERVE = ((2, 2), (4, 1), (1, 1))
# 200 images in waves of 64: the last wave holds 8 (ragged)
MESH_REQUESTS = 200
# rows / images that no data axis above divides: padded, sliced back
MESH_RAGGED = 61
MESH_LM_REQUESTS, MESH_LM_BATCH = 4, 4
# qwen2.5-3b's depth on the (2,1) mesh, widths kept (of 36)
MESH_LM_LAYERS = LM_LAYERS
# logit rows of the (2,1) mesh against meshless serving: the float parts
# of a decode step (bf16 compute) may round differently at 2 rows than
# at 4; a wrong block's cache, position or row is off by O(max |row|)
MESH_LM_ROW_TOL = 1e-2
MESH_RUNS = 2      # every mesh check runs twice (a stream race shows as
                   # a mismatch at random)


def _layer_inputs(qnet, x):
    """(LayerDef, layer, its integer input) per compute layer of one
    forward (`forward_int`'s graph walk)."""
    from repro_torch.vision.models import COMPUTE_KINDS
    stream, edges, out = x, {}, []
    for L, q in qnet.qlayers:
        xin = edges[L.input_from] if L.input_from else stream
        if L.kind in COMPUTE_KINDS:
            out.append((L, q, xin))
            y = q.apply(xin)
        elif L.kind == "add":
            y = q.apply(xin, edges[L.skip_from])
        else:
            y = q.apply(xin)
        if L.save_as:
            edges[L.save_as] = y
        if not L.branch:
            stream = y
    return out


def _count_launches(acc, fn):
    """``fn()`` with every launch count set to 0 just before and read
    just after; the counts are added into ``acc``."""
    import torch
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for name, counts in read_launches().items():
        for stages, n in counts.items():
            acc[name][stages] = acc[name].get(stages, 0) + n
    return out


def _mesh_equal(name, fn, want):
    """``fn()`` MESH_RUNS times, each identical to ``want``."""
    import torch
    for run in range(MESH_RUNS):
        got = fn()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"[mesh] {name} (run {run}) differs from "
                                 "the meshless call")


def mesh_kernel_phase(dev, nets, images, report):
    """`api.qconv` and `api.qdot` on every mesh of MESHES at each ResNet-8
    layer of ``nets`` (W{8,4,2}, A8), on the layer's own input for a wave
    of 64: each conv, each conv as its im2col GEMM (kernel 1/2 at N =
    Cout), the head (N = 10: meshes whose model axis divides it), at both
    pipelines; ragged rows and batches of MESH_RAGGED on the data meshes.
    Every call equals the meshless one's integers, MESH_RUNS times."""
    import torch
    from repro_torch.kernels import api
    from repro_torch.kernels.qconv.ops import im2col_hwc
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.obs import counters as obs_counters
    from repro_torch.obs import trace as obs
    from repro_torch.vision.models import quantize_input

    meshes = {s: make_cluster_mesh(*s, device=dev) for s in MESHES}
    compared = {"qdot": 0, "qconv": 0}
    t0 = time.perf_counter()
    for w_bits, qnet in nets.items():
        x = quantize_input(qnet, images[:WAVE])
        for L, q, xin in _layer_inputs(qnet, x):
            for pl in PIPELINE.values():
                if L.kind == "conv":
                    c = q.conv
                    want = api.qconv(c, xin, pipeline=pl)
                    cols = im2col_hwc(xin, c.fh, c.fw, c.stride,
                                      c.padding)[0]
                    cols = cols.reshape(-1, c.gemm.k_logical)
                    want_g = api.qdot(c.gemm, cols, pipeline=pl)
                    if not torch.equal(want_g.reshape(want.shape), want):
                        raise AssertionError(f"[mesh] {L.path}: im2col "
                                             "GEMM differs from the conv")
                    for s, m in meshes.items():
                        _mesh_equal(f"qconv {L.path} W{w_bits} {pl} {s}",
                                    lambda: api.qconv(c, xin, pipeline=pl,
                                                      mesh=m), want)
                        _mesh_equal(f"qdot {L.path} W{w_bits} {pl} {s}",
                                    lambda: api.qdot(c.gemm, cols,
                                                     pipeline=pl, mesh=m),
                                    want_g)
                        compared["qconv"] += MESH_RUNS
                        compared["qdot"] += MESH_RUNS
                    r = xin[:MESH_RAGGED]
                    want_r = api.qconv(c, r, pipeline=pl)
                    for s in ((4, 1), (8, 1), (2, 2)):
                        _mesh_equal(f"qconv {L.path} ragged batch {s}",
                                    lambda: api.qconv(c, r, pipeline=pl,
                                                      mesh=meshes[s]),
                                    want_r)
                        compared["qconv"] += MESH_RUNS
                else:
                    g, epi = q.gemm, q.epilogue
                    for rows in (WAVE, MESH_RAGGED):
                        xr = xin[:rows]
                        want = api.qdot(g, xr, epilogue=epi, pipeline=pl)
                        for s, m in meshes.items():
                            if g.w_packed.shape[1] % s[1]:
                                continue     # N = 10 over 4: refused
                            _mesh_equal(
                                f"qdot {L.path} M={rows} {pl} {s}",
                                lambda: api.qdot(g, xr, epilogue=epi,
                                                 pipeline=pl, mesh=m),
                                want)
                            compared["qdot"] += MESH_RUNS
    wall = time.perf_counter() - t0
    # one sharded call observed: pipeline and launch resolve on the
    # shard-local shape, the counters count the global one
    L, q, xin = _layer_inputs(nets[8], quantize_input(
        nets[8], images[:WAVE]))[1]
    obs.reset()
    obs_counters.reset()
    with obs.enabled_scope():
        api.qconv(q.conv, xin, mesh=meshes[(2, 2)])
        ev = obs.dispatch_log()[-1]
        (counted,) = obs_counters.snapshot().values()
    obs.reset()
    obs_counters.reset()
    say("mesh", kernels="qmatmul,qconv", meshes=json.dumps(
        [list(s) for s in MESHES]), compared=json.dumps(compared),
        runs_each=MESH_RUNS, seconds=round(wall, 1), all_exact=True)
    say("mesh", call=f"qconv {L.path} W8 on (2,2)",
        dispatch_shape=list(ev["shape"]), counted_macs=counted["macs"],
        counted_calls=counted["calls"])
    report["mesh_kernels"] = {"compared": compared, "seconds": wall,
                              "local_dispatch_shape": list(ev["shape"]),
                              "counted": counted}


def _expected_per_device(wave_sizes, batch, dp):
    """Per-device slot utilization of a wave stream, from the definition
    (device d owns the contiguous slots [d*b, (d+1)*b) of the padded
    array, real slots fill from 0)."""
    b = -(-batch // dp)
    per = [[min(max(n - d * b, 0), b) / b for d in range(dp)]
           for n in wave_sizes]
    return [sum(col) / len(per) for col in zip(*per)]


def mesh_vision_path(dev, nets, images, report, acc):
    """Serve each net of ``nets`` meshless and through `VisionEngine(mesh=)`
    on every layout of MESH_SERVE (each MESH_RUNS times), waves of 64 with
    a ragged last one; logits equal meshless, per-device utilization as
    its definition gives. Only the mesh runs' launches go into ``acc``.
    Returns the meshless logits."""
    import numpy as np
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.serve.engine import VisionEngine

    served = {}
    for name, qnet in nets.items():
        eng = VisionEngine(qnet, batch_size=WAVE, device=dev)
        want = eng.run(images)
        lat = eng.utilization_report()["latency_us"]
        row = {"meshless": {"wave_p50_ms": lat["p50"] / 1e3,
                            "wave_p95_ms": lat["p95"] / 1e3}}
        for s in MESH_SERVE:
            mesh = make_cluster_mesh(*s, device=dev)
            eng = VisionEngine(qnet, batch_size=WAVE, device=dev, mesh=mesh)
            for run in range(MESH_RUNS):
                got = _count_launches(acc, lambda: eng.run(images))
                if not np.array_equal(got, want):
                    bad = int((got != want).any(-1).sum())
                    raise AssertionError(f"[mesh] {name} on {s} (run "
                                         f"{run}): {bad} images' logits "
                                         "differ from meshless serving")
            rep = eng.utilization_report()
            sizes = [w["n_real"] for w in eng.wave_stats]
            exp = _expected_per_device(sizes, WAVE, s[0])
            if not np.allclose(rep["per_device"], exp):
                raise AssertionError(f"[mesh] {name} on {s}: per-device "
                                     f"{rep['per_device']} != {exp}")
            lat = rep["latency_us"]
            row[f"{s[0]},{s[1]}"] = {
                "wave_p50_ms": lat["p50"] / 1e3,
                "wave_p95_ms": lat["p95"] / 1e3,
                "per_device": rep["per_device"]}
        say("mesh", serve=name, images=len(images), wave=WAVE,
            logits_equal_meshless=True, **{
                f"p50_p95_ms[{k}]": f"{v['wave_p50_ms']:.3f}/"
                                    f"{v['wave_p95_ms']:.3f}"
                for k, v in row.items()},
            per_device_2x2=row["2,2"]["per_device"],
            per_device_4x1=row["4,1"]["per_device"])
        report.setdefault("mesh_serve", {})[name] = row
        served[name] = want
    return served


def mesh_vision_cpu_check(nets, images, served):
    """Each net moved to the CPU and served on a (2, 2) mesh of CPU
    positions: logits of its first wave (``images[name]``) equal the
    card's."""
    import numpy as np
    from repro_torch.convert import to_device
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.serve.engine import VisionEngine
    mesh = make_cluster_mesh(2, 2, device="cpu")
    for name, qnet in nets.items():
        got = VisionEngine(to_device(qnet, "cpu"), batch_size=WAVE,
                           device="cpu", mesh=mesh).run(
            images[name][:WAVE])
        if not np.array_equal(got, served[name][:WAVE]):
            raise AssertionError(f"[mesh] {name}: CPU mesh logits differ "
                                 "from the card's")
    say("mesh", check="card_vs_cpu_mesh", mesh="2,2", nets=len(nets),
        images=WAVE, logits_equal=True)


def _cli_requests(cfg, n, max_new, seed=SEED):
    """The requests `repro_torch.launch.serve` draws for ``--seed``."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(2, cfg.vocab, size=(
        int(rng.integers(2, 8)),)).astype(np.int32),
        max_new_tokens=max_new) for _ in range(n)]


def _record_rows(eng):
    """Per request id, the float32 logit rows its engine's adapter hands
    to `consume` (one per fed position)."""
    import numpy as np
    rows = {}
    ad = eng._adapter
    consume = ad.consume

    def record(cur, row):
        rows.setdefault(cur.rid, []).append(np.array(row, np.float32))
        return consume(cur, row)

    ad.consume = record
    return rows


def _check_mesh_dense_calls(model, adapter):
    """One decode step of the mesh adapter with `dense_tap` on: each data
    block's int dense calls run at the block's rows (kernel 1 at the
    shard-local M), and each, run again on the card, is identical to the
    same call on the CPU (the kernels' plain versions)."""
    import numpy as np
    import torch
    from repro_torch.nn.layers import dense_tap
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 24)
    toks = rng.integers(2, cfg.vocab, size=(MESH_LM_BATCH, 5)).astype(
        np.int32)
    state = adapter.init_state(MESH_LM_BATCH)
    for t in range(4):
        _, state = adapter.step(state, toks[:, t:t + 1],
                                np.full(MESH_LM_BATCH, t))
    calls = []
    with dense_tap(lambda p, x: calls.append((p, x)) if "w_packed" in p
                   else None):
        adapter.step(state, toks[:, 4:5], np.array([4, 3, 4, 2]))
    torch.cuda.synchronize()
    expected = adapter.dp * dense_calls_per_step(model)
    rows = sorted({x.reshape(-1, x.shape[-1]).shape[0] for _, x in calls})
    if len(calls) != expected or rows != [MESH_LM_BATCH // adapter.dp]:
        raise AssertionError(f"[mesh] tapped {len(calls)} dense calls of "
                             f"{rows} rows, expected {expected} of "
                             f"{MESH_LM_BATCH // adapter.dp}")
    _calls_equal_cpu(calls, cfg.quant, "mesh")
    say("mesh", check="dense_tap", arch=cfg.name, w_bits=cfg.quant.w_bits,
        mesh=f"{adapter.dp},1", dense_calls=len(calls), rows_per_call=rows[0],
        all_equal_cpu_plain=True)
    return len(calls)


def mesh_lm_path(dev, report, acc):
    """qwen2.5-3b W4A8 at full width: `Engine` meshless and on a (2, 1)
    mesh of the card, then the CLI with ``--mesh 2,1`` (the same seeded
    weights and requests): greedy tokens equal in all three, the logit
    rows of the (2,1) engine within MESH_LM_ROW_TOL x max |row| of the
    meshless ones, and one mesh decode step's dense calls equal to the
    CPU's. Only the mesh runs' launches go into ``acc``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.convert import convert_params
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models.api import build, get_config
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_LM_LAYERS)
    model = _lm_model(cfg, 4)
    fp = build(cfg).init(SEED, device=dev)
    params = convert_params(int_skeleton(model.defs()), fp, 4)
    del fp
    torch.cuda.empty_cache()
    outs, rows = {}, {}
    for label, mesh in (("meshless", None),
                        ("2,1", make_cluster_mesh(2, 1, device=dev))):
        eng = Engine(model, params, batch_size=MESH_LM_BATCH,
                     max_len=LM_MAX_LEN, device=dev, mesh=mesh)
        rows[label] = _record_rows(eng)
        reqs = _cli_requests(cfg, MESH_LM_REQUESTS, LM_MAX_NEW)
        t0 = time.perf_counter()
        if mesh is None:
            out = eng.generate(reqs)
        else:
            out = _count_launches(acc, lambda: eng.generate(reqs))
        wall = time.perf_counter() - t0
        outs[label] = [r.out.tolist() for r in out]
        rep = eng.utilization_report()
        toks = sum(len(r.out) for r in out)
        say("mesh", serve=f"{LM_ARCH} W4A8", mesh=label,
            tok_per_s=round(toks / wall, 3), tokens=toks,
            wave_p50_ms=round(rep["latency_us"]["p50"] / 1e3, 3),
            wave_p95_ms=round(rep["latency_us"]["p95"] / 1e3, 3),
            per_device=rep["per_device"])
        report.setdefault("mesh_lm", {})[label] = {
            "tok_per_s": toks / wall, "tokens": toks, "wall_s": wall,
            "latency_us": rep["latency_us"],
            "per_device": rep["per_device"]}
    err, n_rows, scale = 0.0, 0, 0.0
    for rid, want in rows["meshless"].items():
        got = rows["2,1"].get(rid, [])
        if len(got) != len(want):
            raise AssertionError(f"[mesh] request {rid}: {len(got)} logit "
                                 f"rows on (2,1), {len(want)} meshless")
        for g, w in zip(got, want):
            # the real vocab: the padded entries sit at -1e9
            g, w = g[:cfg.vocab], w[:cfg.vocab]
            err = max(err, float(np.abs(g - w).max()))
            scale = max(scale, float(np.abs(w).max()))
            n_rows += 1
    if not err <= MESH_LM_ROW_TOL * scale:
        raise AssertionError(f"[mesh] {LM_ARCH} logit rows on (2,1): max "
                             f"abs err {err} against meshless (max |row| "
                             f"{scale})")
    say("mesh", check="logit_rows 2,1 vs meshless", arch=LM_ARCH,
        rows=n_rows, max_abs_err=err, max_abs_row=scale,
        tol=f"{MESH_LM_ROW_TOL} x max|row|", exact=err == 0.0)
    report["mesh_lm"]["logit_rows"] = {"rows": n_rows, "max_abs_err": err,
                                       "max_abs_row": scale}
    report["mesh_lm"]["dense_calls"] = _check_mesh_dense_calls(
        model, eng._adapter)
    del params, eng, rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli, text = _count_launches(acc, lambda: _captured(serve_cli.main, [
        "--arch", LM_ARCH, "--quant", "w4a8", "--requests",
        str(MESH_LM_REQUESTS), "--batch", str(MESH_LM_BATCH), "--max-new",
        str(LM_MAX_NEW), "--mesh", "2,1", "--layers", str(MESH_LM_LAYERS)]))
    outs["cli 2,1"] = [r.out.tolist() for r in cli]
    if "mesh: data=2 model=1" not in text or \
            "cluster utilization:" not in text:
        raise AssertionError("[mesh] the serve CLI printed no mesh lines")
    if not outs["meshless"] == outs["2,1"] == outs["cli 2,1"]:
        raise AssertionError(f"[mesh] {LM_ARCH} tokens differ: {outs}")
    say("mesh", cli=f"python -m repro_torch.launch.serve --arch {LM_ARCH} "
        f"--quant w4a8 --mesh 2,1 --layers {MESH_LM_LAYERS}",
        seconds=round(time.perf_counter() - t0, 1),
        tokens_equal_meshless=True)


def mesh_collectives_check(dev, report):
    """`ring_decode_attention`, `collective_matmul` and `pipeline_apply`
    on meshes of the card against the same calls on CPU meshes (float32,
    MESH_RUNS times), and a checkpoint saved meshless and restored onto a
    (2, 2) mesh of the card."""
    import numpy as np
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.pipeline import pipeline_apply, stage_stack
    from repro_torch.parallel.ring import (collective_matmul,
                                           ring_decode_attention)
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import init_fp

    rng = np.random.default_rng(SEED + 23)
    card, cpu = (make_cluster_mesh(1, 4, device=dev),
                 make_cluster_mesh(1, 4, device="cpu"))
    b, t, h, dh = 2, 64, 4, 32
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((b, h, dh), (b, t, h, dh), (b, t, h, dh)))
    mask = torch.arange(t)[None, :] < torch.tensor([[40], [7]])
    x = torch.from_numpy(rng.normal(size=(16, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 96)).astype(np.float32))
    wl = torch.from_numpy((rng.normal(size=(8, 16, 16)) * 0.3).astype(
        np.float32))
    xm = torch.from_numpy(rng.normal(size=(4, 3, 16)).astype(np.float32))

    def stage(sp, hh):
        for wi in sp["w"]:
            hh = torch.tanh(hh @ wi)
        return hh

    pods = {d: pm.make_mesh((2,), ("pod",), [d, d]) for d in (dev, "cpu")}
    cases = {
        "ring_decode_attention": lambda m, d: ring_decode_attention(
            q.to(d), k.to(d), v.to(d), mask.to(d), m),
        "collective_matmul": lambda m, d: collective_matmul(
            x.to(d), w.to(d), m),
        "pipeline_apply": lambda m, d: pipeline_apply(
            stage, stage_stack({"w": wl.to(d)}, 2), xm.to(d), pods[d]),
    }
    errs = {}
    for name, fn in cases.items():
        want = fn(cpu, "cpu")
        for run in range(MESH_RUNS):
            got = fn(card, dev).cpu()
            errs[name] = max(errs.get(name, 0.0),
                             float((got - want).abs().max()))
        if errs[name] > 1e-4 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"[mesh] {name}: card vs CPU max abs err "
                                 f"{errs[name]}")
    say("mesh", check="collectives card_vs_cpu", tol="1e-4 x max|y|",
        **{k: f"{e:.3g}" for k, e in errs.items()})

    fp = init_fp(get_vision_config("resnet8"), seed=SEED, device=dev)
    mesh = make_cluster_mesh(2, 2, device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="mesh_ckpt_",
                                         dir=ROOT / "build"))
    try:
        ckpt.save(work, 1, {"params": fp})
        leaves = 0
        for run in range(MESH_RUNS):
            state, _ = ckpt.restore(work, mesh=mesh)
            split, _ = ckpt.restore(work, shardings=_split_last(
                state, mesh))
            for tree in (state, split):
                leaves = _check_restored(tree["params"], fp)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("mesh", check="restore onto (2,2)", leaves=leaves,
        replicated_and_split_equal=True)
    report["mesh_collectives"] = {"max_abs_err": errs,
                                  "restored_leaves": leaves}


def _split_last(tree, mesh):
    """Per leaf: the last dim over ``model`` where it divides, else
    replicated."""
    from repro_torch.parallel import mesh as pm
    if isinstance(tree, dict):
        return {k: _split_last(v, mesh) for k, v in tree.items()}
    spec = [None] * len(tree.shape)
    if tree.shape and tree.shape[-1] % mesh.shape["model"] == 0:
        spec[-1] = "model"
    return pm.NamedSharding(mesh, pm.P(*spec))


def _check_restored(tree, want) -> int:
    import torch
    from repro_torch.parallel import mesh as pm
    if isinstance(want, dict):
        return sum(_check_restored(tree[k], want[k]) for k in want)
    if not isinstance(tree, pm.Sharded) or not torch.equal(
            pm.gather(tree).to(want.device), want):
        raise AssertionError("[mesh] a restored leaf differs")
    return 1


def mesh_path(dev, report):
    """[mesh]: the cluster path on one card. Returns the kernels' launch
    counts summed over the mesh serving runs alone (vision and LM; the
    meshless baselines and the comparisons are outside every window)."""
    import numpy as np
    import torch
    from repro_torch.deploy.calibrate import calibrate_vision
    from repro_torch.deploy.planner import auto_budget, plan_mixed_precision
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (collect_absmax, init_fp,
                                           quantize_net)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    nets, inputs = {}, {}
    for net in ("resnet8", "mobilenet-tiny", "qat-cnn"):
        cfg = get_vision_config(net)
        fp = init_fp(cfg, seed=SEED, device=dev)
        calib = [rng.uniform(0, 1, size=(WAVE, *cfg.in_hw, cfg.in_ch))
                 .astype(np.float32) for _ in range(2)]
        inputs[net] = rng.uniform(0, 1, size=(
            MESH_REQUESTS, *cfg.in_hw, cfg.in_ch)).astype(np.float32)
        if net == "qat-cnn":
            stats, absmax = calibrate_vision(cfg, fp, calib)
            plan = plan_mixed_precision(stats, auto_budget(stats),
                                        granularity="channel_group")
            nets["qat-cnn plan (b)"] = quantize_net(cfg, fp, absmax,
                                                    plan=plan, device=dev)
            continue
        absmax = collect_absmax(cfg, fp, calib)
        widths = WIDTHS if net == "resnet8" else (8,)
        for w in widths:
            nets[f"{net} W{w}"] = quantize_net(
                cfg, fp, absmax, plan=uniform_plan(cfg, w, cfg.a_bits),
                device=dev)
        if net == "resnet8":
            nets["resnet8 W8 double_buffer"] = quantize_net(
                cfg, fp, absmax, plan=uniform_plan(
                    cfg, 8, cfg.a_bits, pipeline="double_buffer"),
                device=dev)
    images = {k: inputs[k.split(" ")[0]] for k in nets}
    mesh_kernel_phase(dev, {w: nets[f"resnet8 W{w}"] for w in WIDTHS},
                      inputs["resnet8"], report)
    # one untimed wave per layout: torch loads its CUDA kernels lazily,
    # and each position's stream is made at first use
    for s in MESH_SERVE:
        VisionEngine(nets["resnet8 W8"], batch_size=WAVE, device=dev,
                     mesh=make_cluster_mesh(*s, device=dev)).run(
            images["resnet8 W8"][:WAVE])
    launches = {name: {stages: 0 for stages in counts}
                for name, counts in read_launches().items()}
    served = {}
    for name in nets:
        served.update(mesh_vision_path(dev, {name: nets[name]},
                                       images[name], report, launches))
    mesh_lm_path(dev, report, launches)
    require_launches("mesh", launches, ("qmatmul", "qconv"))
    report.setdefault("launches", {})["mesh"] = launches
    mesh_vision_cpu_check(nets, images, served)
    mesh_collectives_check(dev, report)
    say("mesh", phase_seconds=round(time.perf_counter() - t0, 1))
    return launches


# ------------------------------------------------------------------ [qat] ---
QAT_FLOAT_STEPS, QAT_W2_STEPS = 400, 600    # tests/test_qat.py's recipe
QAT_MARGIN = 0.05           # QAT must beat PTQ at W2 by more than this
QAT_CLI_STEPS = 300
QAT_CLI_EVAL_BATCHES = 4    # the CLI's --eval-batches default
QAT_TEST_BATCHES, QAT_TEST_BATCH = 5, 100


def _fakequant_card_vs_cpu(dev) -> int:
    """Every fake-quant function at W{8,4,2} on the same inputs on the card
    and the CPU: values and gradients equal bit for bit (weights with one
    on the clip edge, activations with exact ties at 0 and beta, beta per
    element; a scalar beta's gradient, a sum in another order, within
    1e-6). Returns the number of tensors compared."""
    import numpy as np
    import torch
    from repro_torch.qat import fakequant as fq

    rng = np.random.default_rng(SEED + 30)
    compared = 0

    def both(fn, *arrays):
        outs = []
        for d in ("cpu", dev):
            xs = [torch.from_numpy(a).to(d).requires_grad_(True)
                  for a in arrays]
            y = fn(*xs)
            cot = torch.from_numpy(rng_cot[y.shape]).to(d)
            y.backward(cot)
            outs.append([y.detach().cpu()] + [
                None if x.grad is None else x.grad.cpu() for x in xs])
        return outs

    rng_cot = {}
    w4 = rng.normal(size=(3, 3, 64, 256)).astype(np.float32)
    w4[0, 0, 0, 0] = np.abs(w4).max()
    w2 = w4.reshape(-1, 256)
    x = rng.uniform(-0.5, 2.5, size=(64, 8, 8, 32)).astype(np.float32)
    beta = np.float32(1.7)
    x.reshape(-1)[:4] = beta, 0.0, beta, 0.0
    for shape in (w4.shape, w2.shape, x.shape):
        rng_cot[shape] = rng.normal(size=shape).astype(np.float32)
    rng_cot[()] = np.float32(1.0)
    cases = []
    for b in WIDTHS:
        cases += [
            (lambda w, b=b: fq.fake_quant_weight(w, b), (w4,), True),
            (lambda w, b=b: fq.fake_quant_weight(w, b, per_channel=True),
             (w2,), True),
            (lambda w, b=b: fq.fake_quant_weight_segmented(
                w, ((0, 128, 8), (128, 256, b))), (w4,), True),
            (lambda v, bb, b=b: fq.fake_quant_act(v, bb, b), (
                x, np.full(x.shape, beta, np.float32)), True),
            (lambda v, bb, b=b: fq.fake_quant_act(v, bb, b, learned=True),
             (x, np.full(x.shape, beta, np.float32)), True),
            (lambda v, bb, b=b: fq.fake_quant_act(v, bb, b, learned=True),
             (x, np.array(beta)), False)]
    for fn, arrays, exact in cases:
        cpu, card = both(fn, *arrays)
        for i, (a, g) in enumerate(zip(cpu, card)):
            if a is None and g is None:
                continue
            last = i == len(cpu) - 1 and not exact
            if last:
                if not torch.allclose(g, a, rtol=1e-6, atol=0):
                    raise AssertionError("[qat] a scalar beta's gradient "
                                         f"differs: {g} vs {a}")
            elif not torch.equal(g.view(torch.int32), a.view(torch.int32)):
                raise AssertionError(
                    f"[qat] fake-quant output {i} differs on the card: max "
                    f"{float((g - a).abs().max())}")
            compared += 1
    return compared


def qat_path(dev, work, report):
    """[qat]: qat-cnn at full width trained on the card. Returns the
    kernels' launch counts over the phase's training, evaluations and
    CLI (the comparisons and the CPU deployment outside)."""
    import numpy as np
    import torch
    from repro_torch.convert import to_device
    from repro_torch.launch import qat as qat_cli
    from repro_torch.qat.data import SyntheticDigits, make_dataset
    from repro_torch.qat.evaluate import deploy, evaluate_int, fold_check
    from repro_torch.qat.train import QATConfig, train_qat
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (forward_int, quantize_input,
                                           streamed_weight_bytes)

    t_phase = time.perf_counter()
    card = report["nvidia_smi"]
    n = _fakequant_card_vs_cpu(dev)
    say("qat", check="fakequant card_vs_cpu", widths=list(WIDTHS),
        tensors_compared=n, all_equal=True)

    cfg = get_vision_config("qat-cnn")
    data = SyntheticDigits(split="train", seed=SEED, noise=0.45, jitter=3)
    test = SyntheticDigits(split="test", seed=SEED, noise=0.45, jitter=3)

    def trained(qc, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_qat(cfg, data, qc, device=dev, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return res, {"steps": qc.steps, "seconds": s,
                     "steps_per_s": qc.steps / s,
                     "train_images_per_s": qc.steps * qc.batch / s}

    def evaluated(qnet, on=test, batches=QAT_TEST_BATCHES, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = evaluate_int(qnet, on.batches(QAT_TEST_BATCH, batches), **kw)
        torch.cuda.synchronize()
        return ev, ev["n"] / (time.perf_counter() - t0)

    reset_launches()
    res_f, row_f = trained(QATConfig(steps=QAT_FLOAT_STEPS, batch=64,
                                     w_bits=None, log_every=200, seed=SEED))
    ptq, ptq_ips = evaluated(deploy(res_f, default_w_bits=2, device=dev))
    res2, row_q = trained(QATConfig(steps=QAT_W2_STEPS, batch=64, lr=1e-2,
                                    w_bits=2, warmup=30, log_every=300,
                                    seed=SEED), init_params=res_f.params)
    fold_check(res2)
    qnet2 = deploy(res2, device=dev)
    qat, qat_ips = evaluated(qnet2)
    row = {"float": row_f, "w2_qat": row_q,
           "ptq_w2_accuracy": ptq["accuracy"],
           "qat_w2_accuracy": qat["accuracy"], "test_images": qat["n"],
           "eval_images_per_s": qat_ips, "card": card}
    say("qat", recipe="W2 float->PTQ vs QAT (noise=0.45 jitter=3)",
        float_steps=QAT_FLOAT_STEPS, qat_steps=QAT_W2_STEPS,
        ptq_w2_accuracy=ptq["accuracy"], qat_w2_accuracy=qat["accuracy"],
        margin=round(qat["accuracy"] - ptq["accuracy"], 4),
        float_steps_per_s=round(row_f["steps_per_s"], 2),
        float_train_images_per_s=round(row_f["train_images_per_s"], 1),
        qat_steps_per_s=round(row_q["steps_per_s"], 2),
        qat_train_images_per_s=round(row_q["train_images_per_s"], 1),
        eval_images_per_s=round(qat_ips, 1), card=card)
    report["qat_w2"] = row
    if not qat["accuracy"] > ptq["accuracy"] + QAT_MARGIN:
        raise AssertionError(
            f"[qat] QAT {qat['accuracy']} does not beat PTQ "
            f"{ptq['accuracy']} by more than {QAT_MARGIN} at W2")

    plan_path = work / "qat_plan.json"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = _captured(qat_cli.main, [
        "--steps", str(QAT_CLI_STEPS), "--out", str(plan_path),
        "--report", str(work / "qat_report.json")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    result, plan = out["result"], out["plan"]
    fold_check(result)
    if not plan_path.exists():
        raise AssertionError("[qat] the CLI saved no plan")
    rows = {r["deployment"]: r for r in out["rows"]}
    # the CLI's uniform deployment on its own test set (the default
    # noise), once more with each pipeline
    cli_test = make_dataset("synthetic", split="test", seed=SEED)
    qnet = deploy(result, device=dev)
    ev_off, ips_off = evaluated(qnet, cli_test, QAT_CLI_EVAL_BATCHES)
    ev_db, ips_db = evaluated(qnet, cli_test, QAT_CLI_EVAL_BATCHES,
                              pipeline="double_buffer")
    torch.cuda.synchronize()
    launches = read_launches()
    if ev_db != ev_off or ev_off["accuracy"] != rows["uniform_w4"][
            "accuracy"]:
        raise AssertionError(f"[qat] evaluations disagree: {ev_off} "
                             f"{ev_db} {rows['uniform_w4']}")
    segments = any(r.segments for r in plan.rules)
    say("qat", cli=f"python -m repro_torch.launch.qat --steps "
        f"{QAT_CLI_STEPS}", seconds=round(cli_s, 1),
        final_loss=round(result.log[-1]["loss"], 4), fold_check=True,
        plan_rules=json.dumps({r.pattern: [r.w_bits, r.segments]
                               for r in plan.rules}),
        plan_segments=segments,
        uniform_w4_accuracy=rows["uniform_w4"]["accuracy"],
        plan_accuracy=rows["task_loss_plan"]["accuracy"],
        uniform_w4_bytes=rows["uniform_w4"]["packed_weight_bytes"],
        plan_bytes=rows["task_loss_plan"]["packed_weight_bytes"],
        eval_images_per_s=round(ips_off, 1),
        eval_images_per_s_double_buffer=round(ips_db, 1),
        double_buffer_equal=True, card=card)
    report["qat_cli"] = {"seconds": cli_s, "rows": out["rows"],
                         "plan": json.loads(plan.to_json()),
                         "eval_images_per_s": ips_off,
                         "eval_images_per_s_double_buffer": ips_db}
    # kernel 3 is the GEMM over a SegmentedLinearParams; a segmented conv
    # runs each run's own conv (kernel 4), as the reference's does
    require_launches("qat", launches, ("qmatmul", "qconv"))
    report.setdefault("launches", {})["qat"] = launches

    # the card-trained result deployed again on the CPU
    x, _ = next(test.batches(QAT_TEST_BATCH, 1))
    for tag, p in (("uniform_w4", None), ("task_loss_plan", plan)):
        q_card = deploy(result, plan=p, device=dev)
        q_cpu = deploy(result, plan=p, device="cpu")
        diff = first_difference(to_device(q_card, "cpu"), q_cpu)
        if diff is not None:
            raise AssertionError(f"[qat] {tag}: the card-trained artifact "
                                 f"packed on the CPU differs at {diff}")
        want = forward_int(q_cpu, quantize_input(q_cpu, x))
        got = forward_int(q_card, quantize_input(q_card, x)).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"[qat] {tag}: integer logits differ "
                                 "between the card and the CPU")
        say("qat", check=f"card_vs_cpu {tag}", artifact_equal_cpu=True,
            logits_equal_cpu=True, images=len(x),
            packed_weight_bytes=streamed_weight_bytes(q_cpu))
    say("qat", phase_seconds=round(time.perf_counter() - t_phase, 1))
    return launches


# ---------------------------------------------------------------- [train] ---
TRAIN_ARCH = "olmo-1b"
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_VARIANT_STEPS = 3
TRAIN_LOSS_RTOL = 1e-2      # a resumed run against the first: the
                            # embedding's backward adds with atomics
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 1, 32
TRAIN_CPU_RTOL, TRAIN_CPU_GRAD_TOL = 1e-4, 1e-4
# free disk the phase needs: two float32 train states of olmo-1b (params,
# m and v, 14.2 GB each) at a time
TRAIN_DISK_BYTES = 32e9


def _train_cli(ckpt, steps=TRAIN_STEPS, every=TRAIN_CKPT_EVERY, extra=()):
    """The train CLI in this process: (its return, its seconds)."""
    import torch
    from repro_torch.launch import train as train_cli
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = _captured(train_cli.main, [
        "--arch", TRAIN_ARCH, "--steps", str(steps), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt", str(ckpt),
        "--ckpt-every", str(every), "--lr", "1e-3", "--warmup", "5",
        *extra])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_path(dev, work, report):
    """[train]: olmo-1b at full width and depth trained on the card
    through the CLI, resumed, in its 8-bit-state and QAT variants, one
    step profiled, the checkpoint timed; then the card against the CPU at
    2 layers. Returns the kernels' launch counts over the CLI runs."""
    import numpy as np
    import shutil
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build, get_config
    from repro_torch.nn.module import param_bytes
    from repro_torch.train.step import TrainStepConfig, make_train_fns
    from repro_torch.train.optimizer import OptConfig

    t_phase = time.perf_counter()
    card = report["nvidia_smi"]
    free = shutil.disk_usage(work).free
    say("train", disk_free_bytes=free, work_dir=work.relative_to(ROOT))
    if free < TRAIN_DISK_BYTES:
        raise AssertionError(f"[train] {free} bytes free under {work}; "
                             f"the phase writes ~{TRAIN_DISK_BYTES:.0f}")
    ckpt = work / "ckpt"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    first, s1 = _train_cli(ckpt)
    losses = [r["loss"] for r in first["log"]]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"[train] the loss does not fall: {losses}")
    state_bytes = param_bytes(first["state"])
    report["train_state_bytes"] = state_bytes
    say("train", cli=f"python -m repro_torch.launch.train --arch "
        f"{TRAIN_ARCH} --steps {TRAIN_STEPS} --batch {TRAIN_BATCH} --seq "
        f"{TRAIN_SEQ} --ckpt-every {TRAIN_CKPT_EVERY}",
        seconds=round(s1, 1), first_loss=round(losses[0], 4),
        last_loss=round(losses[-1], 4), loss_falls=True,
        state_bytes=state_bytes,
        steps=list(checkpoint.list_steps(ckpt)),
        peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)

    # a run cut after step 10's checkpoint: the same command resumes there
    shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:08d}")
    second, s2 = _train_cli(ckpt)
    start = second["trainer"].restored_step
    if start != TRAIN_CKPT_EVERY or [r["step"] for r in second["log"]] != \
            list(range(start + 1, TRAIN_STEPS + 1)):
        raise AssertionError(f"[train] the rerun did not resume at step "
                             f"{TRAIN_CKPT_EVERY}: {start}")
    replayed = second["data"]._batch_at(start)
    if not all(np.array_equal(replayed[k], v) for k, v in
               first["data"]._batch_at(start).items()):
        raise AssertionError("[train] the replayed batch differs")
    rel = [abs(b["loss"] - a["loss"]) / abs(a["loss"]) for a, b in
           zip(first["log"][start:], second["log"])]
    if rel[0] > 1e-6 or max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"[train] resumed losses differ: {rel}")
    say("train", resume=f"same command again, step {TRAIN_STEPS} "
        "checkpoint removed", resumed_at=start, replayed_batch_equal=True,
        first_step_loss_rel_err=rel[0], max_loss_rel_err=max(rel),
        tol=TRAIN_LOSS_RTOL, seconds=round(s2, 1))

    # the checkpoint timed on the CLI's own I/O: the first run's last save
    # (host copy, then the worker's writes) and the resume's restore (its
    # state proven by the replayed losses above)
    saved = first["trainer"].ckpt.last_save
    state = second["state"]
    shutil.rmtree(ckpt)
    save_s = saved["copy_s"] + saved["write_s"]
    restore_s = second["trainer"].restore_s
    say("train", ckpt=f"{TRAIN_ARCH} train state", bytes=saved["bytes"],
        save_s=round(save_s, 2), save_copy_s=round(saved["copy_s"], 2),
        save_gb_per_s=round(saved["bytes"] / save_s / 1e9, 3),
        restore_s=round(restore_s, 2),
        restore_gb_per_s=round(saved["bytes"] / restore_s / 1e9, 3))

    # one step profiled, from the trained state
    model = build(get_config(TRAIN_ARCH))
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    _, step, _ = make_train_fns(model, None, shape, TrainStepConfig(
        opt=OptConfig(lr=1e-3, warmup=5, total_steps=TRAIN_STEPS)),
        device=dev)
    batch = second["data"].place(second["data"]._batch_at(TRAIN_STEPS))
    del first, second
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _device_us(prof) / 1e6 or None
    by_op = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            k = e.key[:72]
            by_op[k] = by_op.get(k, 0.0) + e.self_device_time_total / 1e3
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    row = {"wall_ms": wall * 1e3,
           "device_busy_ms": None if busy is None else busy * 1e3,
           "device_idle_share": None if busy is None
           else max(0.0, 1 - busy / wall),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "top_device_ops_ms": {k: round(v, 3) for k, v in ops},
           "loss": float(m["loss"]), "card": card}
    say("train", profile="train step", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, **{k: (round(v, 4) if isinstance(v, float) else
                             (json.dumps(v) if isinstance(v, dict) else v))
                          for k, v in row.items()})
    report["train_profile"] = row
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    for tag, extra in (("opt_state_bits_8", ["--opt-state-bits", "8"]),
                       ("qat_w4a8", ["--qat", "w4a8"])):
        out, s = _train_cli(work / tag, steps=TRAIN_VARIANT_STEPS,
                            every=1000, extra=extra)
        ls = [r["loss"] for r in out["log"]]
        if not np.isfinite(ls).all():
            raise AssertionError(f"[train] {tag}: losses {ls}")
        say("train", variant=" ".join(extra), steps=TRAIN_VARIANT_STEPS,
            losses=json.dumps([round(v, 4) for v in ls]),
            state_bytes=param_bytes(out["state"]), seconds=round(s, 1))
        del out
        shutil.rmtree(work / tag)
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_launches()
    report.setdefault("launches", {})["train"] = launches
    train_cpu_check(dev, report)
    say("train", phase_seconds=round(time.perf_counter() - t_phase, 1))
    return launches


def train_cpu_check(dev, report):
    """olmo-1b's full width at TRAIN_CPU_LAYERS layers, float32 compute,
    from one CPU-drawn state on both devices: one step's loss within
    TRAIN_CPU_RTOL, its gradients within TRAIN_CPU_GRAD_TOL x each leaf's
    largest |g|, and the losses of three steps within TRAIN_CPU_RTOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import to_device
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.api import build, get_config
    from repro_torch.nn.module import leaf_paths
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                        make_train_fns)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CPU_LAYERS,
                              compute_dtype="float32")
    model = build(cfg)
    shape = ShapeConfig("t", TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, "train")
    tcfg = TrainStepConfig(opt=OptConfig(lr=1e-3, warmup=1, total_steps=10))
    init_cpu, step_cpu, _ = make_train_fns(model, None, shape, tcfg,
                                           device="cpu")
    _, step_gpu, _ = make_train_fns(model, None, shape, tcfg, device=dev)
    s_cpu = init_cpu(SEED)
    s_gpu = to_device(s_cpu, dev)
    data = SyntheticLM(cfg.vocab, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ,
                       seed=SEED, device=None)
    batches = [data._batch_at(i) for i in range(3)]

    def place(b, d):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
                for k, v in b.items()}

    l_cpu, g_cpu = loss_and_grads(model, s_cpu["params"],
                                     place(batches[0], "cpu"), None)
    l_gpu, g_gpu = loss_and_grads(model, s_gpu["params"],
                                     place(batches[0], dev), None)
    loss_rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    worst = 0.0
    for (path, _), gc_, gg in zip(leaf_paths(s_cpu["params"]), g_cpu, g_gpu):
        scale = float(gc_.abs().max()) or 1.0
        err = float((gg.cpu() - gc_).abs().max()) / scale
        worst = max(worst, err)
        if err > TRAIN_CPU_GRAD_TOL:
            raise AssertionError(f"[train] grad {'/'.join(path)}: "
                                 f"{err} x its max |g|")
    del g_cpu, g_gpu
    steps = []
    for b in batches:
        s_cpu, m_cpu = step_cpu(s_cpu, place(b, "cpu"))
        s_gpu, m_gpu = step_gpu(s_gpu, place(b, dev))
        steps.append(abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
                     / abs(float(m_cpu["loss"])))
    if loss_rel > TRAIN_CPU_RTOL or max(steps) > TRAIN_CPU_RTOL:
        raise AssertionError(f"[train] card vs CPU losses: {loss_rel} "
                             f"{steps}")
    row = {"tokens": TRAIN_CPU_BATCH
           * TRAIN_CPU_SEQ, "loss_rel_err": loss_rel,
           "grad_max_err_over_max_g": worst, "step_loss_rel_errs": steps,
           "rtol": TRAIN_CPU_RTOL, "grad_tol": TRAIN_CPU_GRAD_TOL,
           "seconds": round(time.perf_counter() - t0, 1)}
    say("train", check="card_vs_cpu", arch=TRAIN_ARCH,
        layers=f"{TRAIN_CPU_LAYERS} (cut from 16)", compute="float32",
        **{k: (json.dumps(v) if isinstance(v, list) else v)
           for k, v in row.items()})
    report["train_card_vs_cpu"] = row
    del s_cpu, s_gpu
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- [tp] ---
# explicit LM tensor parallelism over 'model', every position on cuda:0
TP_MESHES = ((1, 2), (1, 4), (2, 2))
# the other families at full width and cut depth, each on (1, 2) against
# its own meshless run (vision keeps one group of four self layers and
# its cross layer; rgemma's window is cut so its ring of 16 slots wraps
# under 'cp'; seamless serves 64 source frames)
TP_FAMILIES = (
    ("kimi-k2-1t-a32b", {"n_layers": 1}),
    ("llama4-maverick-400b-a17b", {"n_layers": 1}),
    ("seamless-m4t-large-v2", {"enc_layers": 2, "dec_layers": 2,
                               "n_layers": 4, "src_len": 64}),
    ("recurrentgemma-9b", {"n_layers": 3, "window": 16}),
    ("mamba2-370m", {"n_layers": 2}),
    ("llama-3.2-vision-90b", {"n_layers": 5}),
)
# the float32 logit-row check: prompt tokens, then greedy decode steps
TP_ROW_PROMPT, TP_ROW_STEPS = 8, 8
# new tokens of the served tensor-parallel runs (the engines and the CLI)
TP_MAX_NEW = 8
TP_TRAIN_STEPS = 3
TP_TRAIN_LAYERS = 2         # the float32 card check and the checkpoint
TP_LOSS_RTOL, TP_GRAD_TOL = 1e-5, 1e-4


def _tp_tap_equal_cpu(calls, qcfg):
    """Each tapped local dense call of a tensor-parallel step (a column
    slice with the dequant epilogue, or a `RowSlice` K-slice whose raw
    int32 accumulators the step sums), run again on the card, identical
    to the same call on the CPU. Returns (calls, row-parallel calls)."""
    from repro_torch.convert import to_device
    from repro_torch.nn.layers import RowSlice, dense_apply
    rows = 0
    for i, (p, x) in enumerate(calls):
        cpu = to_device(dict(p), "cpu")
        if isinstance(p, RowSlice):
            cpu = RowSlice(cpu, p.k_full)
            rows += 1
        got = dense_apply(p, x, qcfg=qcfg)
        want = dense_apply(cpu, x.cpu(), qcfg=qcfg)
        err = max_abs_err(got.cpu(), want)
        if err != 0.0 or got.dtype != want.dtype:
            raise AssertionError(f"[tp] dense call {i} ({type(p).__name__}"
                                 f" {tuple(x.shape)} x "
                                 f"{tuple(p['w_packed'].shape)}): max abs "
                                 f"err {err} against the CPU plain path")
    return len(calls), rows


def _tp_dense_tap(model, adapter, label):
    """One decode step of a tensor-parallel adapter under `dense_tap`:
    every packed call, column and row-parallel, on every position,
    identical to the CPU's plain version."""
    import numpy as np
    import torch
    from repro_torch.nn.layers import dense_tap
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 25)
    toks = rng.integers(2, cfg.vocab, size=(MESH_LM_BATCH, 5)).astype(
        np.int32)
    state = adapter.init_state(MESH_LM_BATCH)
    for t in range(4):
        _, state = adapter.step(state, toks[:, t:t + 1],
                                np.full(MESH_LM_BATCH, t))
    calls = []
    with dense_tap(lambda p, x: calls.append((p, x)) if "w_packed" in p
                   else None):
        adapter.step(state, toks[:, 4:5], np.array([4, 3, 4, 2]))
    torch.cuda.synchronize()
    n, rows = _tp_tap_equal_cpu(calls, cfg.quant)
    if n == 0:
        raise AssertionError(f"[tp] {label}: tapped no dense call")
    say("tp", check="dense_tap", arch=label,
        mesh=",".join(str(v) for v in adapter.mesh.shape.values()),
        dense_calls=n, row_parallel_calls=rows, all_equal_cpu_plain=True)
    return n


def _tp_strategies(model, mesh):
    """The strategy each attention block runs at decode over the served
    cache on ``mesh`` (`attn_strategy`, as the blocks call it), and its
    weight layout."""
    from repro_torch.models.lm import _attn_cfg
    from repro_torch.nn.attention import attn_layout, attn_strategy
    from repro_torch.parallel import tp
    cfg = model.cfg
    if cfg.family == "mamba":
        return "no attention"
    acfg = _attn_cfg(cfg)
    t = min(LM_MAX_LEN, cfg.window) if cfg.family == "griffin" \
        else LM_MAX_LEN
    with tp.tp_scope(tp.TPGroup(mesh, 0)):
        strat = attn_strategy(acfg.kv_heads, acfg.groups, 1, t)
    lay = attn_layout(acfg, mesh.shape["model"])
    return f"{strat} (weights {lay.kind}, wo {lay.wo})"


def _tp_serve(model, params, mesh, label, acc, report):
    """`Engine` over the CLI's requests; the mesh run's launches into
    ``acc``. Returns (tokens, logit rows by request, row)."""
    import torch
    from repro_torch.serve.engine import Engine
    dev = params["embed"]["table"].device
    eng = Engine(model, params, batch_size=MESH_LM_BATCH,
                 max_len=LM_MAX_LEN, device=dev, mesh=mesh)
    rows = _record_rows(eng)
    reqs = _cli_requests(model.cfg, MESH_LM_REQUESTS, TP_MAX_NEW)
    t0 = time.perf_counter()
    if mesh is None:
        out = eng.generate(reqs)
    else:
        out = _count_launches(acc, lambda: eng.generate(reqs))
    wall = time.perf_counter() - t0
    rep = eng.utilization_report()
    toks = sum(len(r.out) for r in out)
    row = {"tok_per_s": toks / wall, "tokens": toks, "wall_s": wall,
           "wave_p50_ms": rep["latency_us"]["p50"] / 1e3,
           "wave_p95_ms": rep["latency_us"]["p95"] / 1e3,
           "per_device": rep["per_device"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    mesh_s = "meshless" if mesh is None else ",".join(
        str(v) for v in mesh.shape.values())
    strat = "" if mesh is None else _tp_strategies(model, mesh)
    say("tp", serve=label, mesh=mesh_s, strategy=strat,
        **{k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in row.items()})
    report.setdefault("tp_serve", {})[f"{label} {mesh_s}"] = row
    return [r.out.tolist() for r in out], rows, eng


def _tp_compare(label, base, got, mesh_s, vocab):
    """Greedy tokens of a served mesh run equal the meshless run's (a
    gate); the largest difference of their bf16 logit rows over the real
    vocab is reported (`_tp_rows_f32` gates the rows: a bf16 GEMM of
    another shape, a head's column block or a few heads' attention,
    rounds its last bits otherwise)."""
    import numpy as np
    (t0, r0), (t1, r1) = base, got
    if t0 != t1:
        raise AssertionError(f"[tp] {label} on {mesh_s}: tokens {t1}, "
                             f"meshless {t0}")
    err, scale, n = 0.0, 0.0, 0
    for rid, want in r0.items():
        have = r1.get(rid, [])
        if len(have) != len(want):
            raise AssertionError(f"[tp] {label} on {mesh_s}: request {rid}"
                                 f" {len(have)} rows, {len(want)} meshless")
        for g, w in zip(have, want):
            err = max(err, float(np.abs(g[:vocab] - w[:vocab]).max()))
            scale = max(scale, float(np.abs(w[:vocab]).max()))
            n += 1
    say("tp", check="served vs meshless", arch=label, mesh=mesh_s,
        tokens_equal=True, bf16_rows=n, bf16_max_abs_err=err,
        max_abs_row=scale)
    return {"rows": n, "bf16_max_abs_err": err, "max_abs_row": scale}


def _tp_rows_f32(dev, cfg, fp, label, shapes, report):
    """The logit rows of the fp model (quantization off, float32
    compute) over TP_ROW_PROMPT prompt tokens and TP_ROW_STEPS greedy
    steps, decoded on data block 0 of each mesh of ``shapes`` (params
    and cache placed) against meshless: within MESH_LM_ROW_TOL x max
    |row| over the real vocab, greedy tokens equal wherever meshless's
    top-1 margin exceeds that. The packed path is held bit for bit per
    call (`_tp_dense_tap`); its activation codes would turn a last-bit
    float difference (a GEMM of another shape) into a flipped code, so
    the rows of the composition are held on the continuous fp path."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models.api import build
    from repro_torch.nn.layers import QOFF
    from repro_torch.parallel import tp
    m32 = build(dataclasses.replace(cfg, compute_dtype="float32",
                                    quant=QOFF, quant_plan=None))
    vocab = m32.cfg.vocab
    gen = torch.Generator(device="cpu").manual_seed(SEED + 26)
    prompt = torch.randint(2, vocab, (LM_BATCH, TP_ROW_PROMPT),
                           generator=gen).to(dev)

    def run(group, feed=None):
        p = fp if group is None else m32.place(fp, group)
        cache = m32.init_cache(LM_BATCH, LM_MAX_LEN, dtype=torch.float32,
                               device=dev)
        if group is not None:
            cache = m32.place_cache(cache, group)
        rows, fed, tok = [], [], prompt[:, :1]
        with tp.tp_scope(group):
            for t in range(TP_ROW_PROMPT + TP_ROW_STEPS):
                if feed is not None:
                    tok = feed[t]
                elif t < TP_ROW_PROMPT:
                    tok = prompt[:, t:t + 1]
                fed.append(tok)
                lg, cache = m32.decode(p, cache, tok, t)
                rows.append(lg[:, -1, :vocab].float())
                tok = lg[:, -1, :vocab].argmax(-1, keepdim=True)
        return torch.stack(rows), fed

    want, fed = run(None)
    top2 = want.topk(2, dim=-1).values
    out = {}
    for shape in shapes:
        got, _ = run(tp.TPGroup(make_cluster_mesh(*shape, device=dev), 0),
                     fed)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = MESH_LM_ROW_TOL * scale
        sure = (top2[..., 0] - top2[..., 1]) > tol
        agree = bool((got.argmax(-1) == want.argmax(-1))[sure].all())
        mesh_s = f"{shape[0]},{shape[1]}"
        if not (err <= tol and agree):
            raise AssertionError(f"[tp] {label} fp float32 rows on {mesh_s}"
                                 f": max abs err {err} (max |row| {scale}),"
                                 f" greedy agree {agree}")
        say("tp", check="fp float32 rows vs meshless", arch=label,
            mesh=mesh_s, rows=int(want.shape[0] * want.shape[1]),
            max_abs_err=err, max_abs_row=scale,
            tol=f"{MESH_LM_ROW_TOL} x max|row|",
            greedy_agree=f"{int(sure.sum())}/{sure.numel()}")
        out[mesh_s] = {"max_abs_err": err, "max_abs_row": scale}
    report.setdefault("tp_rows_f32", {})[label] = out
    del want, fed
    return out


def _tp_profile_step(dev, model, params, mesh, report):
    """One tensor-parallel decode step of data block 0 under
    torch.profiler: wall, device busy and idle, kernel 1 and 2 launches,
    and the device ms of the reductions across positions (the partial
    sums and their one dequant, the log-sum-exp merges, marked with
    ``record_function``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.nn import attention, layers
    from repro_torch.parallel import tp
    grp = tp.TPGroup(mesh, 0)
    placed = model.place(params, grp)
    cache = model.place_cache(model.init_cache(LM_BATCH, LM_MAX_LEN,
                                               device=dev), grp)
    tok = torch.full((LM_BATCH, 1), 7, device=dev)
    marked = {}

    def mark(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            with record_function("tp_reduce"):
                return fn(*a, **k)
        marked[(mod, name)] = fn
        setattr(mod, name, wrapped)

    with tp.tp_scope(grp):
        model.decode(placed, cache, tok, 0)              # warm
        torch.cuda.synchronize()
        for mod, name in ((layers, "dense_finish"), (tp, "total"),
                          (attention, "_merge")):
            mark(mod, name)
        try:
            reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.decode(placed, cache, tok, 1)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            for (mod, name), fn in marked.items():
                setattr(mod, name, fn)
    launches = read_launches()
    busy = _device_us(prof) or None
    red = [e for e in prof.key_averages() if e.key == "tp_reduce"]
    red_ms = max((e.device_time_total for e in red), default=0) / 1e3
    row = {"mesh": ",".join(str(v) for v in mesh.shape.values()),
           "wall_ms": wall_us / 1e3,
           "device_busy_ms": None if busy is None else busy / 1e3,
           "device_idle_share": None if busy is None
           else max(0.0, 1.0 - busy / wall_us),
           "qmatmul_device_ms": _device_us(prof, ("qmatmul_kernel",)) / 1e3
           or None,
           "qmatmul_launches_s1": launches["qmatmul"][1],
           "qmatmul_launches_s2": launches["qmatmul"][2],
           "reduce_ranges": sum(e.count for e in red) // max(1, len(red)),
           "reduce_device_ms": red_ms or None}
    say("tp", profile="decode step", arch=model.cfg.name, batch=LM_BATCH,
        **row)
    report.setdefault("tp_profile_decode_step", []).append(row)
    del placed, cache


def _tp_qwen_config():
    """qwen2.5-3b at full width and LM_LAYERS, as [tp] serves it."""
    import dataclasses
    from repro_torch.models.api import get_config
    return dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)


def tp_qwen_path(dev, report, acc):
    """qwen2.5-3b W4A8 at full width and LM_LAYERS: `Engine` meshless and on
    each mesh of TP_MESHES, W4A8 double-buffered on (1, 2), the wi plan
    (kernel 3, the container whole) on (1, 2), the CLI with ``--mesh
    2,2``: tokens equal meshless, logit rows within MESH_LM_ROW_TOL; one
    decode step's packed calls on (1, 2) and (1, 4) equal the CPU's; a
    profiled (1, 2) decode step."""
    import torch
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.convert import convert_params
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models.api import build

    cfg = _tp_qwen_config()
    model = _lm_model(cfg, 4)
    fp = build(cfg).init(SEED, device=dev)
    params = convert_params(int_skeleton(model.defs()), fp, 4)
    label = f"{LM_ARCH} W4A8"
    toks, rows, _ = _tp_serve(model, params, None, label, acc, report)
    base = (toks, rows)
    checks = {}
    for shape in TP_MESHES:
        mesh = make_cluster_mesh(*shape, device=dev)
        toks, rows, eng = _tp_serve(model, params, mesh, label, acc, report)
        mesh_s = f"{shape[0]},{shape[1]}"
        checks[mesh_s] = _tp_compare(label, base, (toks, rows), mesh_s,
                                     cfg.vocab)
        if shape == (1, 2):
            checks[mesh_s]["dense_calls"] = _tp_dense_tap(
                model, eng._adapter, f"{label} {mesh_s}")
            report["tp_placement"] = _tp_placement(eng)
        del eng
    mesh = make_cluster_mesh(1, 2, device=dev)
    db = _lm_model(cfg, 4, pipeline="double_buffer")
    toks, _, eng = _tp_serve(db, params, mesh, f"{label} double_buffer",
                             acc, report)
    if toks != base[0]:
        raise AssertionError(f"[tp] double_buffer tokens differ: {toks}")
    del eng
    _tp_profile_step(dev, model, params, mesh, report)
    plan = PrecisionPlan(rules=(PlanRule(pattern="layers/mlp/wi", w_bits=8,
                                         segments=LM_RUNS),),
                         default_w_bits=4)
    pm = _lm_model(cfg, 4, plan=plan)
    pp = apply_plan(int_skeleton(pm.defs()), fp, plan, 4)
    before = acc["qmatmul_segmented"].get(1, 0)
    _, _, eng = _tp_serve(pm, pp, mesh, f"{LM_ARCH} plan wi W8|W4", acc,
                          report)
    if acc["qmatmul_segmented"].get(1, 0) == before:
        raise AssertionError("[tp] the wi plan on (1,2) launched no "
                             "qmatmul_segmented")
    del eng, pp, params
    gc.collect()
    torch.cuda.empty_cache()
    _tp_rows_f32(dev, cfg, fp, LM_ARCH, ((1, 2), (1, 4)), report)
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli, text = _count_launches(acc, lambda: _captured(serve_cli.main, [
        "--arch", LM_ARCH, "--quant", "w4a8", "--requests",
        str(MESH_LM_REQUESTS), "--batch", str(MESH_LM_BATCH), "--max-new",
        str(TP_MAX_NEW), "--mesh", "2,2", "--layers", str(LM_LAYERS)]))
    if "mesh: data=2 model=2" not in text or \
            "tensor-parallel over 'model'" not in text:
        raise AssertionError("[tp] the serve CLI printed no tp mesh line")
    if [r.out.tolist() for r in cli] != base[0]:
        raise AssertionError("[tp] the CLI on --mesh 2,2 gave other tokens")
    say("tp", cli=f"python -m repro_torch.launch.serve --arch {LM_ARCH} "
        f"--quant w4a8 --mesh 2,2 --layers {LM_LAYERS}",
        seconds=round(time.perf_counter() - t0, 1),
        tokens_equal_meshless=True)
    report["tp_qwen_checks"] = checks


def tp_family_path(dev, arch, cut, report, acc):
    """One family at full width and cut depth, W4A8, on (1, 2) against
    its own meshless run: tokens, logit rows, and one step's packed
    calls against the CPU's."""
    import dataclasses
    import torch
    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models.api import build, get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, **cut)
    label = f"{arch} W4A8 ({', '.join(f'{k}={v}' for k, v in cut.items())})"
    gc.collect()
    torch.cuda.empty_cache()
    fp = build(cfg).init(SEED, device=dev)
    model = _lm_model(cfg, 4)
    params = apply_plan(int_skeleton(model.defs()), fp, None, 4)
    base = _tp_serve(model, params, None, label, acc, report)
    mesh = make_cluster_mesh(1, 2, device=dev)
    toks, rows, eng = _tp_serve(model, params, mesh, label, acc, report)
    out = _tp_compare(label, base[:2], (toks, rows), "1,2", cfg.vocab)
    out["dense_calls"] = _tp_dense_tap(model, eng._adapter, label)
    del eng, base, params
    if cfg.moe is not None:
        # float32 compute would copy every expert to float32: the fp row
        # check runs at MOE_CPU_EXPERTS experts
        del fp
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=MOE_CPU_EXPERTS[arch]))
        fp = build(cfg).init(SEED, device=dev)
        label = f"{label} experts={MOE_CPU_EXPERTS[arch]}"
    out["rows_f32"] = _tp_rows_f32(dev, cfg, fp, label, ((1, 2),), report)
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    report.setdefault("tp_families", {})[arch] = out


def tp_train_path(dev, work, report):
    """olmo-1b on (1, 2) and (2, 2): at full width and depth, 3 steps at
    batch 8 x 256 each (step wall, tokens/s, peak memory); at
    TP_TRAIN_LAYERS layers in float32 against meshless on the card (loss
    within TP_LOSS_RTOL relative, gradients within TP_GRAD_TOL of each
    leaf's max); a checkpoint of that state saved after a (2, 2) step
    and resumed with a (2, 4) step, equal to the meshless second step."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models.api import build, get_config
    from repro_torch.nn.module import leaf_paths
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                        make_train_fns)

    tcfg = TrainStepConfig(opt=OptConfig(lr=1e-3, warmup=1, total_steps=10))
    model = build(get_config(TRAIN_ARCH))
    shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    for mshape in ((1, 2), (2, 2)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step, _ = make_train_fns(
            model, make_cluster_mesh(*mshape, device=dev), shape, tcfg,
            device=dev)
        state = init_fn(SEED)
        data = SyntheticLM(model.cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                           seed=SEED, device=dev)
        walls, losses = [], []
        for _ in range(TP_TRAIN_STEPS):
            batch = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
        if not np.isfinite(losses).all():
            raise AssertionError(f"[tp] train on {mshape}: losses {losses}")
        row = {"mesh": f"{mshape[0]},{mshape[1]}",
               "step_wall_ms": [round(w * 1e3, 1) for w in walls],
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / min(walls[1:]),
               "losses": [round(v, 4) for v in losses],
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        say("tp", train=f"{TRAIN_ARCH} full width and depth", batch=
            f"{TRAIN_BATCH}x{TRAIN_SEQ}", **{k: (json.dumps(v)
                                                  if isinstance(v, list)
                                                  else v)
                                              for k, v in row.items()})
        report.setdefault("tp_train", []).append(row)
        del state, step, init_fn, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TP_TRAIN_LAYERS,
                              compute_dtype="float32")
    small = build(cfg)
    sshape = ShapeConfig("t", TRAIN_CPU_SEQ * 2, 4, "train")
    init_fn, step0, _ = make_train_fns(small, None, sshape, tcfg, device=dev)
    state = init_fn(SEED)
    data = SyntheticLM(cfg.vocab, 4, TRAIN_CPU_SEQ * 2, seed=SEED,
                       device=dev)
    b1, b2 = next(data), next(data)
    l0, g0 = loss_and_grads(small, state["params"], b1)
    worst = {}
    for mshape in ((1, 2), (2, 2)):
        l1, g1 = loss_and_grads(small, state["params"], b1,
                                make_cluster_mesh(*mshape, device=dev))
        rel = abs(float(l1) - float(l0)) / abs(float(l0))
        gerr = 0.0
        for (path, _), a, b in zip(leaf_paths(state["params"]), g0, g1):
            e = float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)
            if e > TP_GRAD_TOL:
                raise AssertionError(f"[tp] grad {'/'.join(path)} on "
                                     f"{mshape}: {e} x its max |g|")
            gerr = max(gerr, e)
        if rel > TP_LOSS_RTOL:
            raise AssertionError(f"[tp] loss on {mshape}: rel err {rel}")
        worst[f"{mshape[0]},{mshape[1]}"] = {"loss_rel_err": rel,
                                             "grad_err_over_max_g": gerr}
    _, step22, _ = make_train_fns(small, make_cluster_mesh(2, 2, device=dev),
                                  sshape, tcfg, device=dev)
    _, step24, _ = make_train_fns(small, make_cluster_mesh(2, 4, device=dev),
                                  sshape, tcfg, device=dev)
    s22, _ = step22(state, b1)
    ckpt.save(str(work / "tp_ckpt"), 1, s22)
    restored, at = ckpt.restore(str(work / "tp_ckpt"), device=dev)
    _, m24 = step24(restored, b2)
    ref, _ = step0(state, b1)
    _, m0 = step0(ref, b2)
    rel = abs(float(m24["loss"]) - float(m0["loss"])) / abs(float(m0["loss"]))
    if at != 1 or rel > TP_LOSS_RTOL:
        raise AssertionError(f"[tp] resumed on (2,4) at {at}: loss rel err "
                             f"{rel}")
    shutil.rmtree(work / "tp_ckpt", ignore_errors=True)
    say("tp", check="train card float32", arch=TRAIN_ARCH,
        layers=f"{TP_TRAIN_LAYERS} (cut from 16)",
        vs_meshless=json.dumps(worst), resumed_2x2_on_2x4_loss_rel_err=rel)
    report["tp_train_check"] = {"vs_meshless": worst,
                                "resume_loss_rel_err": rel}
    del state, restored, s22, ref
    gc.collect()
    torch.cuda.empty_cache()


def tp_path(dev, work, report):
    """[tp]: explicit LM tensor parallelism over 'model' on one card.
    Returns the kernels' launch counts over the tensor-parallel serving
    runs alone (the meshless baselines and the comparisons outside)."""
    t0 = time.perf_counter()
    launches = {name: {stages: 0 for stages in counts}
                for name, counts in read_launches().items()}
    tp_qwen_path(dev, report, launches)
    say("tp", part="qwen2.5-3b", seconds=round(time.perf_counter() - t0, 1))
    for arch, cut in TP_FAMILIES:
        tp_family_path(dev, arch, cut, report, launches)
    say("tp", part="families", seconds=round(time.perf_counter() - t0, 1))
    require_launches("tp", launches, ("qmatmul",))
    if launches["qmatmul_segmented"].get(1, 0) == 0:
        raise AssertionError("[tp] qmatmul_segmented never launched")
    report.setdefault("launches", {})["tp"] = launches
    tp_train_path(dev, work, report)
    say("tp", phase_seconds=round(time.perf_counter() - t0, 1))
    return launches


def _tp_placement(eng):
    """Per mesh position, the bytes of data block 0's params and cache as
    a served TP engine holds them on the card (`Split` parts at their
    positions, whole leaves at the block's first), and its slots."""
    from repro_torch.nn.module import leaf_paths
    from repro_torch.parallel import tp
    ad = eng._adapter
    grp = ad._groups[0]
    out = {"slots": eng._sched.slots.phys}
    for key, tree in (("params", ad.block_params(0)),
                      ("cache", eng._sched.state.blocks[0])):
        per = [0] * ad.mesh.size
        for _, leaf in leaf_paths(tree):
            if isinstance(leaf, tp.Split):
                for i, t in enumerate(leaf.parts):
                    if t is not None:
                        per[grp.positions[i]] += t.nbytes
            else:
                per[grp.positions[0]] += leaf.nbytes
        out[key] = per
    return out


# ---------------------------------------------------------------- [dryrun] ---
DRYRUN_CELL = ("qwen2.5-3b", "decode_32k", "pod")


def dryrun_traces(report):
    """[dryrun]'s traces (module docstring), on the host while the kernels
    build: meta tensors, no launch. The gates wait for [train] and [tp]
    (`dryrun_check`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build, get_config
    from repro_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    model = build(get_config(TRAIN_ARCH))
    train = dryrun.trace_cell(model, model.cfg, ShapeConfig(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"), None)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = _lm_model(_tp_qwen_config(), 4)
    placed = dryrun.trace_cell(
        model, model.cfg, ShapeConfig("tp", LM_MAX_LEN, MESH_LM_BATCH,
                                      "decode"),
        make_mesh((1, 2), ("data", "model"), "meta"))
    placed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cell = dryrun.run_cell(*DRYRUN_CELL, save=False)
    cell_s = time.perf_counter() - t0
    print("[dryrun]", dryrun.pass_line(cell), f"seconds={cell_s:.1f}",
          flush=True)
    report["dryrun_cell"] = {k: cell[k] for k in (
        "arch", "shape", "mesh", "devices", "traced_blocks",
        "bytes_per_device", "roofline", "io_bytes_per_device")}
    report["dryrun_cell"]["seconds"] = cell_s
    return {"train": train, "train_s": train_s, "placed": placed,
            "placed_s": placed_s, "seconds": train_s + placed_s + cell_s}


def dryrun_check(report, traces):
    """[dryrun]'s gates: the traced olmo-1b train state against [train]'s
    ``state_bytes`` (its peak reported against the profiled step's), the
    traced (1, 2) placement against [tp]'s served engine's."""
    card = report["nvidia_smi"]
    tr = traces["train"]
    state = tr["argument"]["state"][0]
    argument = sum(v[0] for v in tr["argument"].values())
    predicted = argument + tr["recorder"].positions[0].peak
    measured = report["train_profile"]["peak_mem_bytes"]
    if state != report["train_state_bytes"]:
        raise AssertionError(f"[dryrun] {TRAIN_ARCH} train state: the dry "
                             f"run holds {state} bytes, [train] "
                             f"{report['train_state_bytes']}")
    row = {"state_bytes": state,
           "card_state_bytes": report["train_state_bytes"],
           "argument_bytes": argument, "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured,
           "predicted_over_measured": predicted / measured,
           "trace_s": traces["train_s"]}
    say("dryrun", check=f"{TRAIN_ARCH} train meshless batch {TRAIN_BATCH} "
        f"x {TRAIN_SEQ}", state_equal=True,
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in row.items()}, card=card)
    report["dryrun_train"] = row

    pl, tr = report["tp_placement"], traces["placed"]
    if pl["slots"] != MESH_LM_BATCH:
        raise AssertionError(f"[dryrun] [tp] served {pl['slots']} slots, "
                             f"the dry run traced {MESH_LM_BATCH}")
    for key in ("params", "cache"):
        if tr["argument"][key] != pl[key]:
            raise AssertionError(
                f"[dryrun] {LM_ARCH} W4A8 on (1,2): {key} bytes per "
                f"position {tr['argument'][key]} in the dry run, "
                f"{pl[key]} on the card")
    say("dryrun", check=f"{LM_ARCH} ({LM_LAYERS} of 36 layers) W4A8 decode "
        f"placement mesh=1,2 slots={pl['slots']} max_len={LM_MAX_LEN}",
        param_bytes=json.dumps(pl["params"]),
        cache_bytes=json.dumps(pl["cache"]), equal_card=True,
        trace_s=round(traces["placed_s"], 1))
    report["dryrun_placement"] = {"card": pl, "dry_run": tr["argument"]}
    say("dryrun", traces_seconds=round(traces["seconds"], 1),
        note="traced on the host while the kernels built")


ATTN_WIDTHS = ((16, 16), (64, 64), (96, 96), (112, 112), (128, 128),
               (192, 128), (256, 256))
# (label, B, S, heads, Dh, Dv, mode, window) of the timed prefill layers
ATTN_LAYERS = (("phi3-mini layer", 8, 2048, 32, 96, 96, "local", 2047),
               ("kimi-k2 layer", 8, 2048, 64, 192, 128, "causal", None))
BF16_PEAK = 989e12


def _attn_inputs(dev, b, s, t, hk, g, dh, dv, seed):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, hk, g, dh), generator=gen, device=dev) * 2
    k = torch.randn((b, t, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, t, hk, dv), generator=gen, device=dev)
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


def _attn_plain(q, k, v, mode, window):
    """`attn_core`'s plain path: the mask, `_sdpa`, the reshape."""
    from repro_torch.nn.attention import _mask_full, _sdpa
    b, s = q.shape[:2]
    mask = _mask_full(s, k.shape[1], mode, window, q.device)
    return _sdpa(q, k, v, mask[None, None, None]).reshape(b, s, -1)


def attn_kernel_phase(dev, report):
    """The fused attention kernel against the plain path over masks,
    widths, groups and lengths; raises beyond the tolerance."""
    import itertools
    import torch
    from repro_torch.kernels.attn import kernel as ak
    worst, n = 0.0, 0
    for mode, (dh, dv), g, s in itertools.product(
            ("causal", "local", "bidir"), ATTN_WIDTHS, (1, 4, 8),
            (1, 17, 255, 1024)):
        t = s + 77 if mode == "bidir" else s
        window = max(1, s // 3) if mode == "local" else None
        q, k, v = _attn_inputs(dev, 1, s, t, 2, g, dh, dv, SEED + s + g)
        got = ak.attention_fused_cuda(q, k, v, mode=mode, window=window)
        want = _attn_plain(q, k, v, mode, window)
        ratio = float(((got.float() - want.float()).abs()
                       / (2 ** -8 * v.float().abs().max()
                          + 2 ** -7 * want.float().abs())).max())
        if not ratio <= 1.0:
            raise AssertionError(f"attn kernel {mode} Dh={dh} Dv={dv} G={g} "
                                 f"S={s}: gap {ratio:.3f} of the tolerance")
        worst, n = max(worst, ratio), n + 1
    say("attn", check="vs_sdpa", cases=n, worst_of_tolerance=round(worst, 4))
    report["attn_check"] = {"cases": n, "worst_of_tolerance": worst}
    return worst


def attn_timing_phase(dev, report):
    """Device ms of the kernel alone and ms with its host path at the
    two prefill layers, beside the bound, the plain path and the library
    call; one ``[time] kernel=attn`` line each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn import kernel as ak
    rows = {}
    for label, b, s, h, dh, dv, mode, window in ATTN_LAYERS:
        q, k, v = _attn_inputs(dev, b, s, s, h, 1, dh, dv, SEED + h)
        w = window if window and window < s else s
        pairs = w * (w + 1) // 2 + (s - w) * w
        bound_ms = 2 * pairs * (dh + dv) * h * b / BF16_PEAK * 1e3

        def kernel():
            return ak.attention_fused_cuda(q, k, v, mode=mode, window=window)
        device_ms = library_device_ms(kernel, names=("attn_fwd_kernel",))
        ms = time_ms(kernel, 3, 20)
        plain_ms = time_ms(lambda: _attn_plain(q, k, v, mode, window), 1, 3)
        qh, kh, vh = (x.reshape(b, s, h, -1).transpose(1, 2)
                      for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), 3, 20)
        row = {"shape": f"B={b} S={s} H={h} Dh={dh} Dv={dv} {mode}",
               "ms": ms, "device_ms": device_ms, "bound_ms": bound_ms,
               "of_peak": None if device_ms is None else bound_ms / device_ms,
               "plain_ms": plain_ms, "library_ms": library_ms}
        say("time", kernel="attn", layer=label.replace(" ", "_"),
            **{k: (round(x, 4) if isinstance(x, float) else x)
               for k, x in row.items() if k != "shape"})
        rows[label] = row
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    report["attn_timing"] = rows
    return rows


def write_report(report, name: str):
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(report, indent=1,
                                                 default=str))


class _Tee:
    """Standard output also written to a file (the whole run's lines,
    where the caller may keep only the end)."""

    def __init__(self, stream, path: pathlib.Path):
        self.stream, self.file = stream, path.open("w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    sys.stdout = _Tee(sys.stdout, ROOT / "chiprun_out" / "chip_smoke.log")
    sys.path.insert(0, str(ROOT / "src"))
    # the tune cache is this run's own
    os.environ.pop("REPRO_QTUNE_CACHE", None)
    from repro_torch.kernels.build import build_all
    from repro_torch.vision.configs import get_vision_config

    # fp reference convs and matmuls in full float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    kernels_all = kernels_by_name()
    (ROOT / "build").mkdir(exist_ok=True)
    # nvcc runs in the background while the paths that launch no kernel
    # run: [train] (float) and [dryrun]'s traces (meta tensors)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build_all, list(kernels_all.values()))
        work = pathlib.Path(tempfile.mkdtemp(prefix="train_",
                                             dir=ROOT / "build"))
        try:
            train_path(dev, work, report)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        mark("train")
        gc.collect()
        torch.cuda.empty_cache()
        dry = dryrun_traces(report)
        mark("dryrun traces")
        build_s = building.result()
    mark("build")
    say("build", seconds=round(build_s, 1), arch="sm_90a",
        sources=",".join(f"{k}.cu" for k in kernels_all),
        note="[train] and [dryrun]'s traces ran meanwhile")
    report["build_s"] = build_s
    report["ptxas"] = ptxas_report(kernels_all)

    cfg = get_vision_config("resnet8")
    shapes = net_shapes(cfg, WAVE)
    m_shapes = net_shapes(get_vision_config("mobilenet-tiny"), WAVE)
    convs, head = shapes["convs"], shapes["head"]
    worst = kernel_phase(dev, [shapes, m_shapes], report)
    worst.update({("qmatmul_segmented", s): e for s, e in
                  segmented_kernel_phase(dev, report).items()})
    by_path = {"resnet8": main_path(dev, cfg, report),
               "qat-cnn": qat_cnn_path(dev, report)}
    by_path["mobilenet-tiny"], mnet, m_wave = mobilenet_path(dev, report)
    by_path["tune"] = tune_phase(dev, [shapes, m_shapes], report)
    by_path["obs"] = obs_phase(dev, report)
    mark("vision+tune+obs")
    for key, err in lm_kernel_phase(dev, report).items():
        worst[key] = max(worst[key], err)
    by_path[LM_ARCH] = lm_path(dev, report)
    gc.collect()
    torch.cuda.empty_cache()
    lm_cpu_check(dev, report)
    mark("lm")
    for key, err in rec_kernel_phase(dev, report).items():
        worst[key] = max(worst[key], err)
    for arch in REC_ARCHS:
        by_path[arch] = rec_path(dev, arch, report)
    for arch in REC_ARCHS:
        rec_cpu_check(dev, arch, report)
    mark("rec")
    for key, err in xattn_kernel_phase(dev, report).items():
        worst[key] = max(worst[key], err)
    for arch in XATTN_ARCHS:
        by_path[arch] = xattn_path(dev, arch, report)
    xattn_cpu_check(dev, report)
    mark("xattn")
    for key, err in moe_kernel_phase(dev, report).items():
        worst[key] = max(worst[key], err)
    for arch in MOE_ARCHS:
        by_path[arch] = moe_path(dev, arch, report)
    for arch in MOE_ARCHS:
        moe_cpu_check(dev, arch, report)
    kimi_grouped_check(dev, report)
    by_path["kimi-k2-instruct"] = kimi_instruct_block(dev, report)
    mark("moe")
    attn_worst = attn_kernel_phase(dev, report)
    mark("attn")
    gc.collect()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="deploy_",
                                         dir=ROOT / "build"))
    try:
        by_path["deploy"] = deploy_path(dev, work, report)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    deploy_cpu_check(dev, report)
    mark("deploy")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mesh"] = mesh_path(dev, report)
    mark("mesh")
    gc.collect()
    torch.cuda.empty_cache()
    work = pathlib.Path(tempfile.mkdtemp(prefix="tp_", dir=ROOT / "build"))
    try:
        by_path["tp"] = tp_path(dev, work, report)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("tp")
    gc.collect()
    torch.cuda.empty_cache()
    work = pathlib.Path(tempfile.mkdtemp(prefix="qat_", dir=ROOT / "build"))
    try:
        by_path["qat"] = qat_path(dev, work, report)
        mark("qat")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_check(report, dry)
    mark("dryrun")
    lm_timing_phase(dev, report, [(4, k, n) for k, n in LM_SHAPES],
                    "lm_shape", SEED + 7)
    lm_timing_phase(dev, report, [(4, k, n) for k, n in REC_SHAPES],
                    "rec_shape", SEED + 10)
    lm_timing_phase(dev, report, XATTN_SHAPES, "xattn_shape", SEED + 15)
    lm_timing_phase(dev, report, [(4, k, n) for k, n in MOE_SHAPES],
                    "moe_shape", SEED + 18)
    gemm_rows = gemm_timing_phase(dev, head, report)
    conv_rows = timing_phase(dev, convs, report)
    seg_rows = segmented_timing_phase(dev, report)
    depthwise_timing_phase(dev, mnet, m_wave, report)
    attn_rows = attn_timing_phase(dev, report)
    mark("timing")
    phase_s = {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}
    say("phases", seconds=json.dumps(phase_s),
        total=round(marks[-1][1] - marks[0][1], 1))
    report["phase_seconds"] = phase_s

    kernels = []
    for kind in kernels_all:
        if kind == "attn":
            continue
        for stages in (1, 2):
            if kind == "qmatmul_segmented":
                r = seg_rows["c3"]
                timed = {"shape": r["shape"], "ms": r[f"ms_s{stages}"],
                         "device_ms": r[f"device_ms_s{stages}"]}
            elif kind == "qmatmul":
                r = gemm_rows[("resnet8 head", 8)]
                timed = {"shape": "resnet8 head at a wave of 64, "
                                  f"{'x'.join(map(str, head))}, W8A8",
                         "ms": r[f"ms_s{stages}"],
                         "device_ms": r[f"device_ms_s{stages}"],
                         "library_device_ms": r["library_device_ms"]}
            else:
                r = conv_rows[(stages, 8)]
                timed = {"shape": "resnet8 wave of 64, W8A8",
                         "ms": r["ms"], "device_ms": r["device_ms"],
                         "library_device_ms": r["library_device_ms"]}
            kernels.append({
                "name": f"{kind}[STAGES={stages}]", "route": "cuda",
                "source": f"src/repro_torch/csrc/{kind}.cu",
                "replaces": REPLACES[(kind, stages)],
                "launches": sum(c[kind][stages] for c in by_path.values()),
                "launches_by_path": {p: c[kind][stages]
                                     for p, c in by_path.items()},
                "max_abs_err": worst[(kind, stages)],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], **timed})
    for label, r in attn_rows.items():
        kernels.append({
            "name": f"attn[{label}]", "route": "cuda",
            "source": "src/repro_torch/csrc/attn.cu",
            "replaces": "none: the reference leaves attention to XLA",
            "launches": sum(c.get("attn", {}).get(2, 0)
                            for c in by_path.values()),
            "launches_by_path": {p: c.get("attn", {}).get(2, 0)
                                 for p, c in by_path.items()},
            "worst_of_tolerance": attn_worst, **r})
    report["kernels"] = kernels
    write_report(report, "chip_smoke")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
