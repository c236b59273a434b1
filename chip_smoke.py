#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # the full run, one card
    python3 chip_smoke.py --vertices 65536     # a quick run on a smaller graph

Phases, in order (no captured graph is made after the graph that a
profiled chunk replays and destroyed before that chunk: in a process
whose earlier profiler sessions traced kernels, that order made the
profiled replay crash, PERF.md section 7); any failure ends the script
with a non-zero exit code:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compile ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``,
   and print ptxas's registers, shared memory and spills of the flash
   forward's and backward's kernels and of the SpMM's and its dX's,
   the flash kernels' dynamic shared memory and the forward's CTAs an SM
   (a spill fails, but for the bf16 forward's known 20 B at hd 64,
   ``KNOWN_SPILLS``, held to its size);
3. kernels — build the ogbn-products stand-in graph and the training
   plan, then hold each CUDA kernel against its plain PyTorch version on
   the card. The extraction is bit-identical on real sampled serving rows
   and on a real sampled training batch (8192 x 8192, scalar rescale); the
   fused tail is within 1e-5 relative at the serving shape, a ragged one
   and the training shape (8192, 256). Both are timed at the serving shape
   (256 rows, back to back) and at the training shape on a cold L2 (256 MB
   written before each call): per call with CUDA events, and the kernel
   alone on the device with the profiler, beside the bound of the bytes
   these inputs need and the device time of an empty kernel at the
   serving grid (the launch floor). Those shapes take the tail's vector
   route; its scalar route is timed at the ragged shape (300, 33). As a
   diagnostic only, held against no target, each is also timed at the
   training shape behind a flush that reads the 256 MB back, so that the
   L2 holds no dirty lines to write back, and the extraction beside a
   ``fill_`` of a block of its size;
   The tail's counter route (the keep bits drawn in the kernel from the
   0-d key ``keep_mask`` takes, the training path's route) is bit for bit
   the bytes route fed ``keep_mask``'s mask at the three shapes, and timed
   at the training shape on a cold L2 beside the bytes route plus
   ``keep_mask``; the tail's backward kernel (``fused_layer_bwd``: dx and a
   deterministic d_scale) is within 1e-5 of the largest |plain| for dx and
   d_scale at the three shapes in every case of RMSNorm, ReLU and keep
   source (none, bytes, counter; the counter bit for bit the bytes mask's),
   10 calls bit-identical on each route, and timed (counter, RMSNorm,
   ReLU) at the training shape on a cold L2, at the serving shape and, on
   its scalar route, at (300, 33), beside its bound, its plain version and
   the plain version fed a mask (the backward before this kernel);
   The block-ELL SpMM is held against its plain version on a real sampled
   training batch (8192 vertices, 128 x 128 tiles) within 1e-4 of the
   largest output, at the reference's sweep shapes with a ragged d, on a
   top-k layout with padding between live slots, a live column-block-0
   tile in slot 2 and a row-block of padding only (exact zeros), and in
   bf16 at 5e-2; beside its times stand its bound (bytes: the batch's
   nonzeros need few operations; the bounds over the live tiles and over
   every slot beside it) and two yardsticks the port
   never calls: ``torch.sparse.mm`` on the same tiles as a BSR tensor
   (``library_ms``) and a dense ``torch.matmul``;
   The SpMM's dX kernel is held against its plain version on the same
   batch's tiles with a random cotangent within 1e-5 of the largest |dX|,
   bit-identical over 10 repeated calls, at the sweep shapes, on the
   padding layout and in bf16 (5e-2), and timed beside its bound, its
   plain version and the path it replaced (a batched GEMM over every slot
   and an ``index_add_``); no single library call computes it;
   The routes of ``block_dtype="bf16"`` at the training shape: the
   extraction's bf16 block bit for bit its plain version and the float32
   block's cast (timed on a cold L2), the SpMM with the batch's bf16 tiles
   and a float32 h (1e-4) and its dX with a float32 cotangent (1e-5,
   bit-identical over 10 calls), each also on the top-k padding layout,
   each timed beside its bound, its plain version and the float32 route's
   device time in the same call, the dX's kernels one by one, and the
   batch's work at the kernels' units (``spmm_ell_work``: live chunks,
   steps, nonzeros, the busiest CTA's share);
   The flash-attention kernel is held against its plain version (out and
   lse) at the reference's five sweep shapes on both routes, f32 (CUDA
   cores, 1e-4 absolute) and bf16 (tensor cores: out per element within
   1e-2 * (1 + |plain|) and at most 5e-2, lse within 1e-4), and in bf16 at
   the LLM serving shape (q (1, 512, 32, 64), 4 kv heads, causal) and a
   qwen2-style one at hd 128 (14 q heads over 2, T 512), and in f32 at
   the backward's f32 shapes below (the training shape (2, 2048), hd 128,
   windows, non-causal ragged T, MHA); every compared call's second call
   gives the same bits; the bf16 route is timed at the serving shape and
   at (8, 2048, 32, 64), the f32 route at the serving shape, each beside
   its bound and ``scaled_dot_product_attention`` on the same tensors in
   turns (``library_ms``, a yardstick the port never calls); both routes
   are also timed at the LLM training shapes (bf16 (4, 2048, 32/4, 64),
   f32 (2, 2048, ...));
   The flash-attention backward (``flash_attention_bwd``: a dq kernel, a
   dk/dv kernel whose units pair key blocks and may split the q heads,
   and then a fixed-order sum of the split's partials; bf16 on wgmma fed
   by TMA, f32 in register tiles; no float atomics) is held against its
   plain version: dq, dk and dv within 5e-2 (bf16) and 1e-4 (f32) of each
   one's largest |plain| at the training shapes, at hd 128 with
   internlm2-1.8b's 16/8 heads, under a window, non-causal with a T that
   is no multiple of 64, on a plan that pairs and splits (1 x 2048), MHA,
   and a window over a T of 333, a second call the same bits; each route
   timed at its training shape, each kernel's device time beside the sum,
   the kernels and the backward of ``scaled_dot_product_attention``
   (autograd, without its forward) in turns, beside the bound and the
   plain version;
4. serve   — the serving path: the port's ``InferenceEngine`` at the
   paper's width (d_hidden 256, 3 layers, seeded random weights) serves a
   Zipf(1.3) stream of single-vertex requests with both of its kernels on;
   every kernel route's launch count is zeroed just before the stream and
   read just after, and every served logit row is recomputed by a second engine
   on the same card with the plain ``"torch"`` implementations and must
   match (atol 1e-4);
4b. serve-mesh — serving over the mesh (``serve/distributed.py``): the
   same engine with ``force_distributed=True`` in a NCCL group of world
   size 1 (rank 0 broadcasts each device call's plan and gathers the
   logits) and the single-device engine serve the same replayed stream,
   every logit within 1e-5 of the largest; the assembly and extraction of
   a micro-batch report and dispatch no collective, and one request's
   ledger holds the plan's broadcast, the logits' gather and the forward's
   PMM collectives, none under ``extract``; counts zeroed before the
   stream and read after;
4c. serve-driver — ``ServingDriver`` in front of the GNN engine: 8
   submitter threads split the 400 Zipf requests (a future each); every
   micro-batch the driver's pump ran, executed again directly on the
   engine, gives each result within 1e-6 of the largest |logit| (its bits
   printed); req/s, p50/p99 and the starvation flushes;
5. train   — the training path: ``Trainer`` trains ``paper_model
   ("ogbn-products")`` on the same graph with the block-ELL SpMM and its
   dX kernel, the fused tail and the fused extraction (batch 8192, AdamW
   with warm-up and cosine decay, dropout 0.3) through ``ForwardEngine``
   on the 1x1x1x1 mesh for 48 steps: ``Trainer.run`` runs one eager
   warm-up step, captures the step in a CUDA graph and replays it 47
   times. Launch counts are zeroed just before and read just after: the
   wrappers count the warm-up step's launches and the capture's (per
   layer one tail on the counter route and one tail backward; no
   ``keep_mask``: the tail draws the dropout), and one more chunk of 8
   replays under the profiler must run each of the step's device kernels
   8 times its per-step count (``keep_mask_kernel`` 0 times); then twice
   more for the spread of ms/step, after that chunk. The first step's
   loss and gradients and an
   eight-step loss trajectory are held against the plain versions on the
   card, and eight captured steps and eight eager ``Trainer.step`` calls
   from one state must give bit-identical losses and params; the loss
   must fall; then one full-graph evaluation;
5b. train-nccl — the distributed step at the training shape: a NCCL
   process group of world size 1 (a ``FileStore`` under ``build/``),
   ``make_mesh_4d(1, 1)`` over it, and 8 ``Trainer`` steps from the state
   of phase 5's eight-step runs, captured with the group's collectives in
   the graph, whose losses and params must be phase 5's bits (an
   all-reduce over one rank is the identity), counts zeroed before and
   read after; then the same 8 steps eagerly; the group is destroyed at
   the end;
5c. train-comm — the paper's §V options at the training shape, each run
   captured. §V-B: 8
   steps with ``bf16_collectives=True``, then 8 with ``compress="bf16"``,
   each on the single device (no group) and through a NCCL group of one
   rank: the two runs of an option bit-identical, the first loss within
   5e-2 relative of phase 5's f32 step; ``overlap_impl="ring"`` through
   the group bit-identical to phase 5b; 8 steps with ``compress="int8"``
   bit-identical to phase 5 with every error-feedback accumulator exactly
   zero (a quantized wire at g = 1 is the identity); the quantizers
   (int8, int4 and its nibble packing) at (8192, 256) on the card give
   the CPU's bits. §V-A: 48 steps with ``prefetch=True`` (the next batch
   built on a side CUDA stream, a parallel branch of the graph), counts
   zeroed before and read after (3 extractions: the warm-up batch, the
   warm-up step's and the capture's), whose losses
   and final params must be phase 5's 48 steps' bits; then
   ms/step with prefetch on and off, three runs each in turns, and one
   profiled chunk of replays with prefetch on, from whose trace the
   device time during which side-stream and main-stream kernels run
   together;
5d. train-capture — the captured step against the eager one: the
   counter-based draws' kernels (``hash_keys`` over the graph's vertices,
   ``keep_mask`` at (8192, 256)) bit-identical to their plain versions
   on the card and the CPU and timed beside their bound, their plain
   version and ``torch.rand(...) < 1 - p``; the card's sampled ids for
   (seed, step) equal to the CPU's; 48 eager ``Trainer.step`` calls
   bit-identical to phase 5's 48 captured steps; ms/step captured (the
   warm-up step and the capture included, as the reference's compile is,
   and beside it without the capture) and eager in turns, three runs
   each, with each one's peak device memory
   and the memory the graph holds; one profiled eager chunk beside phase
   5's profiled replays;
5e. train-samplers — the reference's other samplers, the paper model on
   the same graph, dropout 0.3, AdamW, the fused tail (drawing its
   dropout from the counter: the SAINT and SAGE steps hand the model one
   key a layer): partition (the
   locality reordering into clusters of 1,024, q = 8 at batch 8192) and
   walk (2,048 roots of 4 vertices, ``walk_k`` 8) through the 4D step
   with the block-ELL SpMM and the plain extraction (their rescale is per
   pair of vertices), 48 steps of ``Trainer.run`` each (captured), 8 and
   48 eager steps bit-identical to the captured ones, the card's samples
   the CPU's; then the baselines, eagerly: GraphSAINT's node sampler
   (batch 8192, the extraction kernel, 48 steps), GraphSAGE's (1,024
   targets, fan-outs (15, 10, 5), 48 steps; its frontier sizes printed)
   and the full-batch GCN (8 steps over every vertex; the largest halving
   of the graph that fits if the whole one does not). Each path: the
   first step's loss within 1e-5 and its gradients within 1e-4 of the
   same step through the plain versions, counts zeroed just before its
   run and read just after (each kernel of the path at its exact count),
   the loss falls; ms/step, a step's device time from one profiled
   chunk, labelled vertices per second, peak memory and the full-graph
   accuracy after its steps;
5f. train-bf16 — phase 5's cell with ``block_dtype="bf16"``: the first
   step within 1e-5 (loss) and 1e-4 (gradients) of the plain versions on
   the same bf16 blocks, its loss beside phase 5's; 48 steps of
   ``Trainer.run`` with every wrapper at its count on the bf16 routes
   (bf16 block, bf16 tiles with float32 operands), the loss falling; one
   profiled chunk of 8 replays (each kernel 8 times its count, the route
   kernels' bf16 instances) for a step's device time beside phase 5's; 8
   captured and 8 eager steps bit for bit; one eager step walked: its
   bytes, bound and roofline share beside phase 5's (fewer bytes);
6. llm     — LLM serving: tinyllama-1.1b at its published width (22
   layers, d_model 2048, 32/4 heads, vocab 32000, bf16, seeded random
   weights) behind the port's ``LLMEngine`` (8 slots, prompts padded to
   512, 32 new tokens, continuous batching) serves 32 prompts of 32-512
   random tokens; the counts are zeroed just before the stream and the
   flash kernel's bf16 route must run once per layer of every prefill,
   and its f32 route never; then on 4 of
   the prompts a prefill and 8 decode steps through the kernel and
   through the plain attention, fed the same tokens, must give logits
   within 5e-2 of the largest |logit|; then one profiled wave;
6b. llm-driver — the same engine behind ``ServingDriver``: a wave of 8
   prompts from 4 threads, each prompt's tokens those of the engine's
   direct run of the wave;
7. llm-train — LLM training at tinyllama-1.1b's published width (seeded
   weights, ``TokenStream`` batches): (a) one bf16 gradient of
   ``lm_loss(forward_train(...))`` on 4 x 2048 tokens through the flash
   kernels and through the plain attention (loss within 1e-2 relative,
   every gradient leaf within 5e-2 of its largest |plain|; the forward's
   and the backward's bf16 routes once a layer each, counts zeroed just
   before); (b) in float32, the reference's training dtype: the first
   step of 2 x 2048 within 1e-5 (loss) and 1e-4 (each leaf) of the plain
   route, then ``launch.train_transformer.train`` for 16 eager AdamW
   steps (the loss falls; both f32 routes once a layer a step); ms/step,
   tokens/s, peak memory and MFU ((6 N tokens + attention) over 67
   TFLOP/s).

The last two lines of standard output are one JSON object per kernel
route (``{"kernels": [...]}``, each with its launches on every path and,
for the extraction, the tail's routes and its backward, its times at the
training shape, where the training path launches them, with the other
shapes' under ``shapes``) and ``{"ok": true, "device": {...}}``. Without a card,
the script exits non-zero before printing either.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, the float32 rate outside the
# tensor cores and the dense bf16 tensor-core rate, at the full 700 W power
# limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

TAIL_RTOL = 1e-5         # f32 sum of squares in another order
TAIL_BWD_RTOL = 1e-5     # the tail's backward: dx and d_scale (a sum over
                         # rows in another order), of the largest |plain|
SERVE_ATOL = 1e-4        # two GCN forwards: fused vs plain tail and extraction
SPMM_RTOL = 1e-4         # f32 sums of up to S * bn products in another order
DX_RTOL = 1e-5           # dX: the same products, summed in another order,
                         # of the largest |dX|
BF16_TOL = 5e-2          # the reference's bf16 tolerance (test_kernels.py)
LOSS_RTOL = 1e-5         # first step: one loss, kernels vs plain versions
GRAD_RTOL = 1e-4         # first step: every gradient leaf, of its max |.|
TRAJ_RTOL = 1e-3         # eight AdamW steps, kernels vs plain versions
FLASH_ATOL = 1e-4        # f32 attention, sums in another order
# bf16 attention: out per element within 1e-2 * (1 + |plain|), and never
# above BF16_TOL (p and out are rounded to bf16: an ulp of |out| in [1, 2)
# is 7.8e-3); lse absolute (f32 scores of exact bf16 products)
FLASH_BF16_OUT_RTOL = 1e-2
FLASH_BF16_LSE_ATOL = 1e-4
LLM_RTOL = 5e-2          # bf16 logits, kernel vs plain path, of max |logit|
FLASH_BWD_RTOL = 1e-4    # f32 dq, dk, dv, of each one's largest |plain|
LLM_LOSS_BF16_RTOL = 1e-2  # a bf16 full-width loss, kernels vs plain

# the kernels of the port: the module that counts their launches, the
# count's name in it, and where the count is split (by route, or by the
# tail's keep source) the dict of the split and the entry's key in it
KERNEL_COUNTERS = {
    "extract_dense_fused": ("extract_gather", "LAUNCHES",
                            ("ROUTE_LAUNCHES", "f32")),
    "extract_dense_fused_bf16": ("extract_gather", "LAUNCHES",
                                 ("ROUTE_LAUNCHES", "bf16")),
    "fused_layer": ("fused_layer", "LAUNCHES", ("ROUTE_LAUNCHES", "vector")),
    "fused_layer_scalar": ("fused_layer", "LAUNCHES",
                           ("ROUTE_LAUNCHES", "scalar")),
    "fused_layer_counter": ("fused_layer", "LAUNCHES",
                            ("SOURCE_LAUNCHES", "counter")),
    "fused_layer_bwd": ("fused_layer", "BWD_LAUNCHES",
                        ("BWD_ROUTE_LAUNCHES", "vector")),
    "fused_layer_bwd_scalar": ("fused_layer", "BWD_LAUNCHES",
                               ("BWD_ROUTE_LAUNCHES", "scalar")),
    "spmm_ell": ("spmm_ell", "LAUNCHES", ("ROUTE_LAUNCHES", "f32")),
    "spmm_ell_bf16_f32": ("spmm_ell", "LAUNCHES",
                          ("ROUTE_LAUNCHES", "bf16_f32")),
    "spmm_ell_dx": ("spmm_ell", "DX_LAUNCHES", ("DX_ROUTE_LAUNCHES", "f32")),
    "spmm_ell_dx_bf16_f32": ("spmm_ell", "DX_LAUNCHES",
                             ("DX_ROUTE_LAUNCHES", "bf16_f32")),
    "flash_attention": ("flash_attention", "LAUNCHES",
                        ("ROUTE_LAUNCHES", "mma")),
    "flash_attention_f32": ("flash_attention", "LAUNCHES",
                            ("ROUTE_LAUNCHES", "f32")),
    "flash_attention_bwd": ("flash_attention", "BWD_LAUNCHES",
                            ("BWD_ROUTE_LAUNCHES", "mma")),
    "flash_attention_bwd_f32": ("flash_attention", "BWD_LAUNCHES",
                                ("BWD_ROUTE_LAUNCHES", "f32")),
    "hash_keys": ("counter_rng", "HASH_LAUNCHES", None),
    "keep_mask": ("counter_rng", "MASK_LAUNCHES", None)}
DX_KERNELS = ("dx_scan_kernel", "dx_product_kernel")

TRAIN_BATCH = 8192
TRAIN_STEPS = 48
CHUNK = 8
BF16_LOSS_RTOL = 5e-2    # a bf16 wire's first loss against the f32 step
L2_FLUSH_BYTES = 256 << 20  # written between cold-L2 timings


def log(msg: str) -> None:
    print(msg, flush=True)


# a layer's launches on a path whose fused tail draws its dropout from the
# counter (no keep-mask): the tail's forward (vector route, counter source)
# and its backward
TAIL_PER_LAYER = ("fused_layer", "fused_layer_counter", "fused_layer_bwd")


def step_launches(num_layers: int, bf16: bool = False) -> dict:
    """The wrappers' launches of one training step: one fused extraction
    (the one block of g = 1) and one permutation hash; per layer one SpMM,
    its dX, and the tail's forward (vector route, the counter's keep bits)
    and backward; no keep-mask. With ``bf16`` blocks the extraction, the
    SpMM and its dX take their bf16 routes (bf16 tiles, f32 operands)."""
    ext, spmm, dx = (("extract_dense_fused_bf16", "spmm_ell_bf16_f32",
                      "spmm_ell_dx_bf16_f32") if bf16 else
                     ("extract_dense_fused", "spmm_ell", "spmm_ell_dx"))
    per_layer = (spmm, dx) + TAIL_PER_LAYER
    return {name: (num_layers if name in per_layer else
                   1 if name in (ext, "hash_keys") else 0)
            for name in KERNEL_COUNTERS}


def captured_launches(num_layers: int, bf16: bool = False) -> dict:
    """The wrappers' launches of a run of ``Trainer.run`` on the card: the
    warm-up step's and the capture's. The replays relaunch the captured
    kernels from the graph, without the wrappers."""
    return {k: 2 * n for k, n in step_launches(num_layers, bf16).items()}


# the device kernels of one training step of the 3-layer plan, by name,
# and how many run a step (the dX wrapper launches two, the tail's
# backward two; the tail draws its dropout, so no keep-mask kernel runs)
STEP_KERNELS = {"extract_dense_kernel": 1, "hash_keys_kernel": 1,
                "spmm_ell_kernel": 3, "fused_layer_kernel_vec": 3,
                "fused_layer_bwd_kernel_vec": 3,
                "fused_layer_dscale_kernel": 3, "keep_mask_kernel": 0,
                "dx_scan_kernel": 3, "dx_product_kernel": 3}
# the device kernels whose names carry their route's types: under
# block_dtype="bf16" each is the bf16 instance (a __nv_bfloat16 template
# argument), under f32 none is
BF16_ROUTE_KERNELS = ("extract_dense_kernel", "spmm_ell_kernel",
                      "dx_scan_kernel", "dx_product_kernel")


def in_nccl_group(torch, tag: str, body):
    """``body()`` inside a NCCL process group of world size 1 (a
    ``FileStore`` under ``build/``). The group is destroyed once
    ``body``'s locals, the CUDA graphs that captured the group's work among
    them, are released: a live graph that holds NCCL work keeps the group
    from shutting down. If ``body`` raises, the group is left to the
    process's exit."""
    import gc

    import torch.distributed as dist
    store = ROOT / "build" / "chip_smoke" / f"store{tag}.{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    out = body()
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    store.unlink(missing_ok=True)
    return out


def eager_run(torch, trainer, state, graph, steps: int) -> tuple:
    """``steps`` eager ``Trainer.step`` calls: (losses, ms/step), the host's
    wall over the steps with the losses read once at the end, as
    ``RunLog`` times a run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = torch.stack([trainer.step(state, graph)
                          for _ in range(steps)]).cpu().tolist()
    return losses, (time.perf_counter() - t0) * 1e3 / steps


def ms_without_capture(run_log) -> float:
    """A run's ms/step (``RunLog``: the reference's yardstick, the warm-up
    step and the capture included) less the capture's share."""
    return run_log.ms_per_step - run_log.capture_s * 1e3 / len(
        run_log.losses)


def time_ms(torch, fn, reps: int = 25, inner: int = 10,
            warmup: int = 5, flush=None) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each, per
    call, after a warm-up. With ``flush`` each window holds one call on a
    cold L2: ``flush()`` writes a buffer larger than the L2, and the host
    waits for it before the window opens, so the window holds the call's
    host and device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        calls = 1 if flush is not None else inner
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(torch, fn, kernel, n: int = 50, flush=None,
              parts=None) -> float:
    """Mean device time of the CUDA kernel named ``kernel`` over ``n`` calls,
    from the profiler's CUPTI trace: the kernel alone, without the host
    time between launches that the event windows include. A tuple of names
    gives the sum of their means: the kernels of one call. With ``flush``,
    ``flush()`` runs before each call, so each starts on a cold L2; the
    flush's kernels have names of their own, outside the mean. The trace
    can miss launches at its edges (4 of 50, and 4 of 10, flash-attention
    launches were missing in full-size runs), so the mean is over the
    launches it holds, which must be at least half of them; a trace that
    holds fewer (once, none of 50 tail launches) is taken again, up to
    three times. ``parts``, a dict, receives each name's mean."""
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        hits = [[e for e in prof.key_averages() if name in e.key]
                for name in names]
        if all(len(h) == 1 and n / 2 <= h[0].count <= n for h in hits):
            means = [h[0].device_time_total / h[0].count / 1e3 for h in hits]
            if parts is not None:
                parts.update(zip(names, means))
            return sum(means)
        log(f"[kernels] the profiler found "
            f"{[[(e.key, e.count) for e in h] for h in hits]} for {names} x "
            f"{n}; tracing again")
    raise AssertionError(f"no trace held {names} x {n}")


def l2_flushers(torch, dev) -> dict:
    """Two ways to put the L2 out of a call's reach, each writing 256 MB,
    five times the H100's 50 MB L2, before the call. ``"written"`` is the
    cold L2 of every timing held against a bound: it leaves the L2 full of
    the buffer's dirty lines, so the call also pays their write-back as it
    evicts them. ``"clean"`` then reads the buffer, so the L2 holds clean
    lines only: a diagnostic of what that write-back costs, held against
    no target."""
    buf = torch.zeros((L2_FLUSH_BYTES // 4,), dtype=torch.float32,
                      device=dev)

    def clean():
        buf.add_(1.0)
        buf.sum()

    return {"written": lambda: buf.add_(1.0), "clean": clean}


def launch_floor_ms(torch, grid: int, threads: int) -> float:
    """Device time of an empty kernel at this grid: the floor under a
    kernel's time where the launch, not the work, dominates."""
    from repro_torch.kernels import _build
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    return device_ms(torch, lambda: _build.check(
        lib.repro_empty_kernel(grid, threads, stream), "empty_kernel"),
        "empty_kernel")


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> float:
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s) * 1e3


def _kernel_modules() -> dict:
    import importlib
    return {mod: importlib.import_module(f"repro_torch.kernels.{mod}")
            for mod, _, _ in KERNEL_COUNTERS.values()}


def zero_launches() -> None:
    """Set every kernel's launch counts to 0 (just before a path runs)."""
    mods = _kernel_modules()
    for mod, counter, split in KERNEL_COUNTERS.values():
        setattr(mods[mod], counter, 0)
        if split is not None:
            parts = getattr(mods[mod], split[0])
            for k in parts:
                parts[k] = 0


def read_launches() -> dict:
    """Every kernel's launch count (just after a path ran): a route's (or
    a keep source's) own count where the count is split, and every split
    must add up to its total."""
    mods = _kernel_modules()
    for mod, counter, split in KERNEL_COUNTERS.values():
        if split is not None:
            parts, total = getattr(mods[mod], split[0]), getattr(mods[mod],
                                                                 counter)
            if sum(parts.values()) != total:
                raise AssertionError(f"{mod}.{split[0]} {parts} does not "
                                     f"add up to {counter} {total}")
    return {name: (getattr(mods[mod], counter) if split is None
                   else getattr(mods[mod], split[0])[split[1]])
            for name, (mod, counter, split) in KERNEL_COUNTERS.items()}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    log(card_line())
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch.cuda.get_device_name(0) = {name}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


# the sources whose kernels' registers, shared memory and spills the build
# prints, from ptxas (-Xptxas -v on one more nvcc beside the build's); a
# spill fails the build phase
PTXAS_REPORT = ("flash_attention.cu", "flash_attention_bwd.cu",
                "spmm_ell.cu", "spmm_ell_dx.cu")
# spills that were there when their source joined the report, held to their
# bytes: the bf16 forward at hd 64 caps its registers at 128 a thread (four
# CTAs an SM) and spills 20 B (PERF.md row 4a); any other spill, or more
# bytes, fails the build phase
KNOWN_SPILLS = {"flash_attention_mma_kernel<64>": 20}


def phase_build() -> None:
    import ctypes
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports = [(src, subprocess.Popen(
        [_build.nvcc_path(), *_build.CFLAGS, "-Xptxas", "-v", "-c",
         str(_build._CSRC / src), "-o",
         str(_build.BUILD_DIR / f"ptxas.{os.getpid()}.{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in PTXAS_REPORT]
    so = _build.build()
    lib = _build.load()
    log(f"[build] {so.relative_to(ROOT)} in {time.monotonic() - t0:.2f} s "
        f"({_build.nvcc_path()})")
    spills = []
    for src, proc in reports:
        out, _ = proc.communicate()
        (_build.BUILD_DIR / f"ptxas.{os.getpid()}.{src}.o").unlink(
            missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{out}")
        for name, regs, stack, st, ld, smem in _ptxas_kernels(out):
            log(f"[build] ptxas {src}: {name}: {regs} registers, {smem} B "
                f"static shared memory, {stack} B stack, {st} B spill "
                f"stores, {ld} B spill loads")
            if max(st, ld) > KNOWN_SPILLS.get(name, 0):
                spills.append(name)
            elif st or ld:
                log(f"[build] ptxas {src}: {name}'s spill is the known "
                    f"{KNOWN_SPILLS[name]} B (KNOWN_SPILLS)")
        for line in out.splitlines():
            if "Performance Loss" in line:
                log(f"[build] ptxas {src}: {line.strip()}")
    import torch
    from repro_torch.kernels import flash_attention as fa
    dq, dkdv = ctypes.c_int(), ctypes.c_int()
    fwd, ctas = ctypes.c_int(), ctypes.c_int()
    for hd in (16, 32, 64, 128):
        for bf16, route in ((1, "bf16"), (0, "f32")):
            _build.check(lib.repro_flash_attention_smem(
                hd, bf16, ctypes.byref(fwd), ctypes.byref(ctas)),
                "repro_flash_attention_smem")
            plan = fa.fwd_plan(1, 64, 64, 1, 1, hd,
                               torch.bfloat16 if bf16 else torch.float32)
            if plan.smem_bytes != fwd.value:
                raise AssertionError(f"flash forward {route} hd {hd}: the "
                                     f"kernel stages {fwd.value} B, "
                                     f"fwd_plan says {plan.smem_bytes}")
            _build.check(lib.repro_flash_attention_bwd_smem(
                hd, bf16, ctypes.byref(dq), ctypes.byref(dkdv)),
                "repro_flash_attention_bwd_smem")
            log(f"[build] flash forward {route} hd {hd}: dynamic shared "
                f"memory {fwd.value} B a CTA, {ctas.value} CTAs an SM; "
                f"backward {dq.value} B (dq), {dkdv.value} B (dk/dv) a CTA")
    if spills:
        raise AssertionError(f"ptxas spills registers in {spills}")


def _ptxas_kernels(out: str) -> list:
    """(name<template argument>, registers, stack, spill stores, spill
    loads, static shared bytes) of every entry function in a ptxas -v
    report."""
    rows, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = mangled = m.group(1)
            # _ZN <len> namespace <len> name I <template argument> E ...
            ns = re.match(r"_ZN(\d+)", mangled)
            if ns:
                rest = mangled[ns.end() + int(ns.group(1)):]
                own = re.match(r"(\d+)", rest)
                if own:
                    n = int(own.group(1))
                    name = rest[own.end():own.end() + n]
                    args = _template_args(rest[own.end() + n:])
                    if args:
                        name += f"<{args}>"
            stack = st = ld = 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack, st, ld = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), stack, st, ld,
                         int(smem.group(1)) if smem else 0))
            name = None
    return rows


def _template_args(rest: str):
    """The template arguments of a mangled name's ``I ... E`` (ints,
    bools, float and named types) as C++ writes them, or None."""
    if not rest.startswith("I"):
        return None
    rest, args, named = rest[1:], [], None
    while rest and rest[0] != "E":
        m = re.match(r"Li(\d+)E|Lb([01])E|(f)|(\d+)|S\d*_", rest)
        if not m:
            return None
        if m.group(1):
            args.append(m.group(1))
        elif m.group(2):
            args.append("true" if m.group(2) == "1" else "false")
        elif m.group(3):
            args.append("float")
        elif m.group(4):          # a named type: <length><name>
            n = int(m.group(4))
            named = rest[m.end():m.end() + n]
            args.append(named)
            rest = rest[m.end() + n:]
            continue
        else:                     # a substitution: the type named before
            if named is None:
                return None
            args.append(named)
        rest = rest[m.end():]
    return ", ".join(args) if rest else None


def _bound_by(n_bytes: float, n_ops: float) -> str:
    return ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_OPS_PER_S
            else "operations")


def check_extraction(torch, A, plan, plan_b, train_plan, train_graph, dev,
                     flushers) -> dict:
    """The extraction kernel against its plain version, bit for bit: on
    real sampled serving rows, then on a real sampled training batch
    (8192 rows and columns of the partitioned graph, scalar rescale,
    ``max_deg`` its ``max_row_nnz``). Both timed at the serving shape
    back to back and at the training shape on a cold L2; beside them the
    launch floor at the serving grid."""
    from repro_torch.kernels import extract_gather as eg
    csr = [torch.from_numpy(a).to(dev) for a in (A.indptr, A.indices,
                                                 A.data)]
    ids = torch.from_numpy(plan.batch_ids).to(dev)
    ids_b = torch.from_numpy(plan_b.batch_ids).to(dev)
    col_scale = torch.from_numpy(plan.col_scale).to(dev)
    col_scale_b = torch.from_numpy(plan_b.col_scale).to(dev)
    inv_p = float(plan.col_scale.max())
    max_deg = A.max_row_nnz()
    builder = train_plan.builder
    train_csr = list(train_graph["adj"][0])
    train_ids = builder.sample_ids(0, None, 0, device=dev)[0]
    train_kw = dict(col_scale=builder.rescale_constants()[0], diag=True,
                    max_deg=builder.max_row_nnz)
    cases = [("per-column, diag", csr, ids, ids, col_scale, True, max_deg),
             ("scalar, diag", csr, ids, ids, inv_p, True, max_deg),
             ("per-column, off-diag", csr, ids, ids_b, col_scale_b, False,
              max_deg),
             ("scalar, off-diag", csr, ids, ids_b, inv_p, False, max_deg),
             ("per-column, diag, max_deg 8", csr, ids, ids, col_scale, True,
              8),
             ("training batch", train_csr, train_ids, train_ids,
              train_kw["col_scale"], True, train_kw["max_deg"])]
    err, nnz = 0.0, {}
    for name, graph_csr, rows, cols, scale, diag, md in cases:
        got = eg.extract_dense_fused(*graph_csr, rows, cols, col_scale=scale,
                                     diag=diag, max_deg=md)
        torch.cuda.synchronize()
        ref = eg.extract_dense_plain(*graph_csr, rows, cols, col_scale=scale,
                                     diag=diag, max_deg=md)
        case_err = (got - ref).abs().max().item()
        nnz[name] = int(torch.count_nonzero(ref))
        log(f"[kernels] extract_dense_fused {name}: ({rows.shape[0]}, "
            f"{cols.shape[0]}) nnz {nnz[name]}, max |kernel - plain| "
            f"{case_err}, bit-identical {torch.equal(got, ref)}")
        if not torch.equal(got, ref) or nnz[name] == 0:
            raise AssertionError(f"extract_dense_fused {name}: kernel and "
                                 "plain version differ (or the block is "
                                 "empty)")
        err = max(err, case_err)
        del got, ref

    shapes = {}
    for label, graph_csr, rows, kw, cold, case in (
            ("serving", csr, ids, dict(col_scale=col_scale, diag=True,
                                       max_deg=max_deg), None,
             "per-column, diag"),
            ("training", train_csr, train_ids, train_kw, flushers,
             "training batch")):
        call = lambda: eg.extract_dense_fused(*graph_csr, rows, rows, **kw)
        written = cold["written"] if cold else None
        ms = time_ms(torch, call, flush=written)
        plain_ms = time_ms(torch, lambda: eg.extract_dense_plain(
            *graph_csr, rows, rows, **kw), flush=written)
        dev_ms = device_ms(torch, call, "extract_dense_kernel", flush=written)
        b = rows.shape[0]
        # the wrapper's own count (eg.extract_dense_cost): the edges
        # walked, the nonzeros placed
        n_ops, n_bytes = eg.extract_dense_cost(*graph_csr, rows, rows,
                                               out=call(), **kw)
        walked = eg.edges_walked(graph_csr[0], rows, kw["max_deg"])
        bound = bound_ms(n_bytes, n_ops)
        shapes[label] = {"b_r": b, "b_c": b, "edges": walked,
                         "bytes": n_bytes, "ms": ms, "device_ms": dev_ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": _bound_by(n_bytes, n_ops),
                         "l2": "written" if cold else "warm"}
        log(f"[kernels] extract_dense_fused {label} shape ({b}, {b}), "
            f"{walked} edges, {n_bytes} B, L2 {shapes[label]['l2']}: kernel "
            f"{ms:.5f} ms per call ({dev_ms:.5f} ms on the device, "
            f"{n_bytes / dev_ms / 1e9:.3f} TB/s, {bound / dev_ms:.3f} of "
            f"the bound), plain {plain_ms:.5f} ms, bound {bound:.6f} ms")
        if cold:
            # diagnostics: behind the clean flush, and beside it a fill of
            # a block of the same size (one PyTorch call that writes its
            # bytes)
            blk = torch.empty((b, b), device=dev)
            fill = lambda: blk.fill_(0.5)
            more = {"device_ms_clean_l2": device_ms(
                        torch, call, "extract_dense_kernel",
                        flush=cold["clean"]),
                    "fill_device_ms": device_ms(torch, fill, "FillFunctor",
                                                flush=written),
                    "fill_device_ms_clean_l2": device_ms(
                        torch, fill, "FillFunctor", flush=cold["clean"])}
            del blk
            shapes[label].update(more)
            log(f"[kernels] extract_dense_fused {label} shape, diagnostic, "
                f"L2 clean: {more['device_ms_clean_l2']:.5f} ms on the device"
                f" ({bound / more['device_ms_clean_l2']:.3f} of the bound); "
                f"fill_ of a ({b}, {b}) float32 block "
                f"{more['fill_device_ms']:.5f} ms (L2 written), "
                f"{more['fill_device_ms_clean_l2']:.5f} ms (L2 clean)")
    grid = eg.launch_config(
        ids.shape[0], ids.shape[0], True,
        torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    shapes["serving"]["floor_ms"] = launch_floor_ms(torch, grid, eg.THREADS)
    log(f"[kernels] empty kernel at the extraction's serving grid "
        f"({grid} x {eg.THREADS}): {shapes['serving']['floor_ms']:.5f} ms on "
        f"the device")
    train = shapes["training"]
    return {"name": "extract_dense_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/extract_gather.cu",
            "replaces": "src/repro/kernels/extract_gather.py:101",
            "max_abs_err": err,
            **{k: train[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
            "library_ms": None, "shapes": shapes}


def check_fused_tail(torch, d_hidden: int, rows: int, dev,
                     flushers) -> list:
    """The fused tail's kernels against their plain versions at the serving
    shape, at a ragged one and at the training shape (8192 rows, dropout
    0.3, residual). The forward with a bytes keep-mask, with and without
    mask and residual; with the counter's keep bits (``dropout_key``),
    bit for bit the bytes route fed ``keep_mask``'s mask and within
    TAIL_RTOL of the plain version; the backward (``fused_layer_bwd``) in
    every case of RMSNorm, ReLU and keep source (none, bytes, counter)
    within TAIL_BWD_RTOL of the largest |plain| for dx and d_scale, the
    counter bit for bit the bytes mask's, and 10 calls at the training
    shape bit-identical. Then the forward's vector route timed at the
    serving shape (residual on, no dropout) back to back and at the
    training shape (residual, bytes mask; and the counter) on a cold L2,
    beside the launch floor at the serving grid, and its scalar route at
    the ragged shape (300, 33), mask and residual; the backward (counter,
    RMSNorm, ReLU) at the training shape on a cold L2 and at the serving
    shape, and its scalar route at the ragged shape. Each timed call must
    take its route. Returns one entry per route."""
    from repro_torch.core import sampling as smp
    from repro_torch.kernels import counter_rng as crng
    from repro_torch.kernels import fused_layer as fl
    gen = torch.Generator(device=dev).manual_seed(0)
    key = smp.key_tensor(smp.step_key(0, 7), dev)
    rate = 0.3

    def case(b, d, mask, res):
        x = torch.randn((b, d), generator=gen, device=dev) * 2.0
        s = torch.rand((d,), generator=gen, device=dev) + 0.5
        m = (torch.rand((b, d), generator=gen, device=dev) < 0.7
             if mask else None)
        r = torch.randn((b, d), generator=gen, device=dev) if res else None
        return x, s, m, r

    def took(counts, before, route):
        return counts[route] == before[route] + 1

    shapes = ((rows, d_hidden), (300, 33), (TRAIN_BATCH, d_hidden))
    err = {"vector": 0.0, "scalar": 0.0}
    for b, d in shapes:
        for mask, res, rms in ((False, False, True), (True, True, True),
                               (False, True, True), (True, True, False)):
            x, s, m, r = case(b, d, mask, res)
            kw = dict(dropout_rate=rate if mask else 0.0, eps=1e-6,
                      use_rmsnorm=rms, use_relu=True)
            before = dict(fl.ROUTE_LAUNCHES)
            got = fl.fused_layer(x, s, m, r, **kw)
            torch.cuda.synchronize()
            route = "vector" if took(fl.ROUTE_LAUNCHES, before, "vector") \
                else "scalar"
            ref = fl.fused_layer_plain(x, s, m, r, **kw)
            case_err = (got - ref).abs().max().item()
            limit = TAIL_RTOL * max(1.0, ref.abs().max().item())
            log(f"[kernels] fused_layer ({b}, {d}) mask={mask} "
                f"residual={res} rmsnorm={rms}, {route} route: max |kernel "
                f"- plain| {case_err:.3e} (limit {limit:.3e})")
            if not case_err <= limit:
                raise AssertionError(f"fused_layer ({b}, {d}): error "
                                     f"{case_err} above {limit}")
            err[route] = max(err[route], case_err)

    # the counter's keep bits: the bytes route's output fed keep_mask's
    # mask, bit for bit
    err["counter"] = 0.0
    for b, d in shapes:
        for res, rms in ((True, True), (False, True), (True, False)):
            x, s, _, r = case(b, d, False, res)
            kw = dict(dropout_rate=rate, eps=1e-6, use_rmsnorm=rms,
                      use_relu=True)
            before = dict(fl.SOURCE_LAUNCHES)
            got = fl.fused_layer(x, s, None, r, dropout_key=key, **kw)
            if not took(fl.SOURCE_LAUNCHES, before, "counter"):
                raise AssertionError("fused_layer: a key took no counter "
                                     "launch")
            same = torch.equal(got, fl.fused_layer(
                x, s, crng.keep_mask(key, b, d, rate), r, **kw))
            ref = fl.fused_layer_plain(x, s, None, r, dropout_key=key, **kw)
            case_err = (got - ref).abs().max().item()
            limit = TAIL_RTOL * max(1.0, ref.abs().max().item())
            log(f"[kernels] fused_layer ({b}, {d}) counter keep bits, "
                f"residual={res} rmsnorm={rms}: the bytes route's bits fed "
                f"keep_mask {same}; max |kernel - plain| {case_err:.3e} "
                f"(limit {limit:.3e})")
            if not (same and case_err <= limit):
                raise AssertionError(f"fused_layer ({b}, {d}) counter: "
                                     f"same bits {same}, error {case_err}")
            err["counter"] = max(err["counter"], case_err)

    # the backward, every flag case and keep source
    bwd_err = {"vector": 0.0, "scalar": 0.0}
    for b, d in shapes:
        for rms in (True, False):
            for relu in (True, False):
                for src in ("none", "bytes", "counter"):
                    x, s, m, _ = case(b, d, src == "bytes", False)
                    g = torch.randn((b, d), generator=gen, device=dev)
                    k = key if src == "counter" else None
                    kw = dict(dropout_rate=0.0 if src == "none" else rate,
                              eps=1e-6, use_rmsnorm=rms, use_relu=relu)
                    before = dict(fl.BWD_ROUTE_LAUNCHES)
                    dx, ds = fl.fused_layer_bwd(g, x, s, m, dropout_key=k,
                                                **kw)
                    torch.cuda.synchronize()
                    route = ("vector" if took(fl.BWD_ROUTE_LAUNCHES, before,
                                              "vector") else "scalar")
                    pdx, pds = fl.fused_layer_bwd_plain(g, x, s, m,
                                                        dropout_key=k, **kw)
                    e_dx = (dx - pdx).abs().max().item()
                    e_ds = (ds - pds).abs().max().item()
                    l_dx = TAIL_BWD_RTOL * pdx.abs().max().item()
                    l_ds = TAIL_BWD_RTOL * pds.abs().max().item()
                    same = True
                    if src == "counter":
                        km = crng.keep_mask(key, b, d, rate)
                        same = all(torch.equal(u, v) for u, v in zip(
                            (dx, ds), fl.fused_layer_bwd(g, x, s, km, **kw)))
                    log(f"[kernels] fused_layer_bwd ({b}, {d}) keep {src} "
                        f"rmsnorm={rms} relu={relu}, {route} route: max "
                        f"|kernel - plain| dx {e_dx:.3e} (limit {l_dx:.3e}),"
                        f" d_scale {e_ds:.3e} (limit {l_ds:.3e})"
                        + (f"; the bytes mask's bits {same}"
                           if src == "counter" else ""))
                    if not (e_dx <= l_dx and e_ds <= l_ds and same):
                        raise AssertionError(f"fused_layer_bwd ({b}, {d}) "
                                             f"{src}: dx {e_dx}, d_scale "
                                             f"{e_ds}, same bits {same}")
                    bwd_err[route] = max(bwd_err[route], e_dx, e_ds)
    for b, d in shapes[1:]:
        x, s, _, _ = case(b, d, False, False)
        g = torch.randn((b, d), generator=gen, device=dev)
        outs = [fl.fused_layer_bwd(g, x, s, None, dropout_key=key,
                                   dropout_rate=rate) for _ in range(10)]
        same = all(torch.equal(u, v) for o in outs[1:]
                   for u, v in zip(o, outs[0]))
        log(f"[kernels] fused_layer_bwd ({b}, {d}), 10 calls: bit-identical "
            f"{same}")
        if not same:
            raise AssertionError("fused_layer_bwd is not deterministic")

    # (label, rows, d, keep source, flushers, route, the route's kernel)
    timed = (("serving", rows, d_hidden, "none", None, "vector",
              "fused_layer_kernel_vec"),
             ("training", TRAIN_BATCH, d_hidden, "bytes", flushers, "vector",
              "fused_layer_kernel_vec"),
             ("training_counter", TRAIN_BATCH, d_hidden, "counter", flushers,
              "vector", "fused_layer_kernel_vec"),
             ("ragged", 300, 33, "bytes", None, "scalar",
              "fused_layer_kernel("))
    times = {"vector": {}, "scalar": {}}
    for label, b, d, src, cold, route, kernel in timed:
        x, s, m, r = case(b, d, src == "bytes", True)
        kw = dict(dropout_rate=0.0 if src == "none" else rate,
                  dropout_key=key if src == "counter" else None)
        call = lambda: fl.fused_layer(x, s, m, r, **kw)
        before = dict(fl.ROUTE_LAUNCHES)
        call()
        if not took(fl.ROUTE_LAUNCHES, before, route):
            raise AssertionError(f"fused_layer {label} shape: the call did "
                                 f"not take the {route} route")
        written = cold["written"] if cold else None
        ms = time_ms(torch, call, flush=written)
        plain_ms = time_ms(torch, lambda: fl.fused_layer_plain(x, s, m, r,
                                                               **kw),
                           flush=written)
        dev_ms = device_ms(torch, call, kernel, flush=written)
        # x, the residual and a bytes mask (or the key) read once, the
        # scale once, out written once (the wrapper's fused_layer_cost)
        n_ops, n_bytes = fl.fused_layer_cost(x, s, m, r, **kw)
        bound = bound_ms(n_bytes, n_ops)
        times[route][label] = {"rows": b, "d": d, "keep": src,
                               "bytes": n_bytes, "ms": ms,
                               "device_ms": dev_ms, "plain_ms": plain_ms,
                               "bound_ms": bound,
                               "bound_by": _bound_by(n_bytes, n_ops),
                               "l2": "written" if cold else "warm"}
        log(f"[kernels] fused_layer {label} shape ({b}, {d}) residual, keep "
            f"{src}, {route} route, {n_bytes} B, L2 "
            f"{times[route][label]['l2']}: kernel {ms:.5f} ms per call "
            f"({dev_ms:.5f} ms on the device, {n_bytes / dev_ms / 1e9:.3f} "
            f"TB/s, {bound / dev_ms:.3f} of the bound), plain "
            f"{plain_ms:.5f} ms, bound {bound:.6f} ms")
        if cold:
            clean_ms = device_ms(torch, call, kernel, flush=cold["clean"])
            times[route][label]["device_ms_clean_l2"] = clean_ms
            log(f"[kernels] fused_layer {label} shape, diagnostic, L2 clean: "
                f"{clean_ms:.5f} ms on the device ({bound / clean_ms:.3f} of "
                f"the bound)")
    grid, threads = -(-rows // fl.ROWS_PER_CTA), 32 * fl.ROWS_PER_CTA
    serving = times["vector"]["serving"]
    serving["floor_ms"] = launch_floor_ms(torch, grid, threads)
    log(f"[kernels] empty kernel at the tail's serving grid ({grid} x "
        f"{threads}): {serving['floor_ms']:.5f} ms on the device")
    training, counter = (times["vector"]["training"],
                         times["vector"]["training_counter"])
    mask_ms = device_ms(torch, lambda: crng.keep_mask(key, TRAIN_BATCH,
                                                      d_hidden, rate),
                        "keep_mask_kernel")
    counter["keep_mask_device_ms"] = mask_ms
    log(f"[kernels] fused_layer training shape, the counter's draw against "
        f"a mask pass: counter route {counter['device_ms']:.5f} ms on the "
        f"device, bytes route {training['device_ms']:.5f} ms + keep_mask "
        f"{mask_ms:.5f} ms = {training['device_ms'] + mask_ms:.5f} ms")

    # the backward: (label, rows, d, flushers, route, its kernels)
    bwd_kernels = ("fused_layer_bwd_kernel_vec", "fused_layer_dscale_kernel")
    bwd_timed = (("training", TRAIN_BATCH, d_hidden, flushers, "vector",
                  bwd_kernels),
                 ("serving", rows, d_hidden, None, "vector", bwd_kernels),
                 ("ragged", 300, 33, None, "scalar",
                  ("fused_layer_bwd_kernel(", "fused_layer_dscale_kernel")))
    bwd_times = {"vector": {}, "scalar": {}}
    for label, b, d, cold, route, kernels in bwd_timed:
        x, s, m, _ = case(b, d, True, False)
        g = torch.randn((b, d), generator=gen, device=dev)
        kw = dict(dropout_rate=rate)
        call = lambda: fl.fused_layer_bwd(g, x, s, None, dropout_key=key,
                                          **kw)
        before = dict(fl.BWD_ROUTE_LAUNCHES)
        call()
        if not took(fl.BWD_ROUTE_LAUNCHES, before, route):
            raise AssertionError(f"fused_layer_bwd {label} shape: the call "
                                 f"did not take the {route} route")
        written = cold["written"] if cold else None
        ms = time_ms(torch, call, flush=written)
        plain_ms = time_ms(torch, lambda: fl.fused_layer_bwd_plain(
            g, x, s, None, dropout_key=key, **kw), flush=written)
        # the plain backward fed a mask: the training step's backward
        # before this kernel (the mask drawn in its own pass)
        plain_mask_ms = time_ms(torch, lambda: fl.fused_layer_bwd_plain(
            g, x, s, m, **kw), flush=written)
        dev_ms = device_ms(torch, call, kernels, flush=written)
        # g and x read once, dx written once, the scale read and d_scale
        # written once, the key read (the wrapper's fused_layer_bwd_cost)
        n_ops, n_bytes = fl.fused_layer_bwd_cost(g, x, s, None,
                                                 dropout_key=key, **kw)
        bound = bound_ms(n_bytes, n_ops)
        bwd_times[route][label] = {
            "rows": b, "d": d, "keep": "counter", "bytes": n_bytes,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_bytes_mask_ms": plain_mask_ms, "bound_ms": bound,
            "bound_by": _bound_by(n_bytes, n_ops),
            "l2": "written" if cold else "warm"}
        log(f"[kernels] fused_layer_bwd {label} shape ({b}, {d}) rmsnorm, "
            f"relu, keep counter, {route} route, {n_bytes} B, L2 "
            f"{bwd_times[route][label]['l2']}: kernel {ms:.5f} ms per call "
            f"({dev_ms:.5f} ms on the device, {n_bytes / dev_ms / 1e9:.3f} "
            f"TB/s, {bound / dev_ms:.3f} of the bound), plain {plain_ms:.5f}"
            f" ms (fed a mask {plain_mask_ms:.5f} ms), bound {bound:.6f} ms")

    def entry(name, route, label, replaces, max_err, at):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fused_layer.cu",
                "replaces": replaces, "max_abs_err": max_err,
                **{k: at[route][label][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None, "shapes": at[route]}

    fwd = "src/repro/kernels/fused_layer.py:78"
    bwd = ("none: the reference's _fused_bwd (src/repro/kernels/ops.py:99) "
           "is plain jnp")
    return [entry("fused_layer", "vector", "training", fwd, err["vector"],
                  times),
            entry("fused_layer_scalar", "scalar", "ragged", fwd,
                  err["scalar"], times),
            entry("fused_layer_counter", "vector", "training_counter", fwd,
                  err["counter"], times),
            entry("fused_layer_bwd", "vector", "training", bwd,
                  bwd_err["vector"], bwd_times),
            entry("fused_layer_bwd_scalar", "scalar", "ragged", bwd,
                  bwd_err["scalar"], bwd_times)]


def train_setup(torch, ds, dev):
    """The training plan on the full graph: ``paper_model("ogbn-products")``
    with the block-ELL SpMM, the fused tail and the fused extraction at
    batch 8192, and ``ell_slots`` set from the first 8 sampled batches: the
    next power of two at or above the most non-empty column tiles any
    row-block holds, so those batches drop no tile. Returns the plan, the
    graph on the card and the partitioned graph (phase 5b plans on it
    again)."""
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.core import fourd
    from repro_torch.graphs import build_partitioned_graph

    t0 = time.monotonic()
    pg = build_partitioned_graph(ds, g=1)
    cfg = paper_model("ogbn-products")
    opts = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                              extract_impl="cuda", dropout=0.3, ell_tile=128)
    mesh = fourd.make_mesh_4d(1, 1, dev)
    plan = fourd.build_plan(pg, cfg, mesh, batch=TRAIN_BATCH, opts=opts)
    graph = plan.shard_graph(pg)
    log(f"[train] graph partitioned (g = 1) and on the card in "
        f"{time.monotonic() - t0:.2f} s: n_pad {pg.n_pad}, e_pad "
        f"{pg.e_pad}, max_block_row_nnz {pg.max_block_row_nnz}, e_cap "
        f"{plan.scfg.e_cap}")

    slots = ell_slots_for(torch, plan, graph, "train")
    plan = fourd.build_plan(pg, cfg, mesh, batch=TRAIN_BATCH,
                            opts=dataclasses.replace(opts, ell_slots=slots))
    return plan, graph, pg


def ell_slots_for(torch, plan, graph, tag: str) -> int:
    """``ell_slots`` for a plan: the next power of two at or above the
    most non-empty column tiles any row-block of its first 8 sampled
    batches holds (each extracted dense with the plan's own rescale), so
    that those batches drop no tile."""
    from repro_torch.core.minibatch import BlockFormat
    from repro_torch.kernels.spmm_ell import dense_to_block_ell_ranked
    b, tile = plan.builder, plan.opts.ell_tile
    aux = graph.get("walk")
    n_rb = plan.scfg.batch // tile
    blocks, most = [], 0
    for step in range(8):
        ids = b.sample_ids(step, None, 0, device=plan.device, aux=aux)
        dense = b.extract_block(*graph["adj"][0], ids[0], ids[0],
                                col_scale=b.col_scale_fn(ids, aux)(0, 0),
                                diag=True, fmt=BlockFormat.DENSE)
        per_rb = (dense.reshape(n_rb, tile, n_rb, tile).abs().sum((1, 3))
                  > 0).sum(1)
        most = max(most, int(per_rb.max()))
        blocks.append(dense)
    slots = 1 << (most - 1).bit_length()
    for dense in blocks:
        tiles, _ = dense_to_block_ell_ranked(dense, tile, tile, slots)
        kept, want = int(torch.count_nonzero(tiles)), \
            int(torch.count_nonzero(dense))
        if kept != want:
            raise AssertionError(f"ell_slots={slots} drops entries: ELL "
                                 f"nnz {kept} != dense nnz {want}")
    log(f"[{tag}] non-empty column tiles per row-block over 8 batches: at "
        f"most {most}; ell_slots = {slots} (no tile dropped)")
    return slots


def check_spmm_ell(torch, plan, graph, dev) -> dict:
    """The block-ELL SpMM kernel against its plain version: on a real
    sampled training batch's tiles with a random h, at the reference's
    sweep shapes with a ragged d, and in bf16; then timed at the training
    shape beside its bound and two yardsticks."""
    from repro_torch.kernels import spmm_ell as sp
    gen = torch.Generator(device=dev).manual_seed(1)
    mb = plan.builder.build(*graph["adj"][0], graph["features"],
                            graph["labels"], 0)
    tiles, colidx = mb.adj[0]
    d = plan.cfg.d_hidden
    h = torch.randn((TRAIN_BATCH, d), generator=gen, device=dev)

    def compare(name, t, c, x, rtol):
        got = sp.spmm_ell(t, c, x)
        torch.cuda.synchronize()
        ref = sp.spmm_ell_plain(t, c, x)
        err = (got.float() - ref.float()).abs().max().item()
        limit = rtol * max(1.0, ref.float().abs().max().item())
        log(f"[kernels] spmm_ell {name}: tiles {tuple(t.shape)} {t.dtype}, "
            f"d {x.shape[1]}: max |kernel - plain| {err:.3e} (limit "
            f"{limit:.3e})")
        if not err <= limit or got.dtype != x.dtype:
            raise AssertionError(f"spmm_ell {name}: error {err} above "
                                 f"{limit} (or dtype {got.dtype})")
        return err

    err = compare("training batch", tiles, colidx, h, SPMM_RTOL)
    for bm, bn in ((8, 8), (16, 32), (32, 16), (8, 128)):
        n_rb, n_cb, dd = 6, 5, 37
        keep = torch.rand((n_rb, 1, n_cb, 1), generator=gen,
                          device=dev) < 0.5
        dense = (torch.randn((n_rb, bm, n_cb, bn), generator=gen,
                             device=dev) * keep).reshape(n_rb * bm, n_cb * bn)
        t, c = sp.dense_to_block_ell(dense, bm, bn, n_cb - 1)
        x = torch.randn((n_cb * bn, dd), generator=gen, device=dev)
        err = max(err, compare(f"sweep ({bm}, {bn})", t, c, x, SPMM_RTOL))
    # padding found from the tiles, not from colidx: padding between live
    # slots, a live column-block-0 tile in slot 2, a row-block of padding
    layout = [[3, None, 1, None, 2], [2, None, 0, 1, None], [None] * 5]
    t = torch.randn((3, 5, 128, 128), generator=gen, device=dev)
    c = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    for i, row in enumerate(layout):
        for slot, cb in enumerate(row):
            if cb is None:
                t[i, slot] = 0.0
            else:
                c[i, slot] = cb
    x = torch.randn((4 * 128, d), generator=gen, device=dev)
    err = max(err, compare("top-k padding layout", t, c, x, SPMM_RTOL))
    if torch.count_nonzero(sp.spmm_ell(t, c, x)[256:]) != 0:
        raise AssertionError("spmm_ell: the all-padding row-block is not "
                             "exactly zero")
    compare("bf16 training batch", tiles.bfloat16(), colidx, h.bfloat16(),
            BF16_TOL)

    n_rb, n_slots, bm, bn = tiles.shape
    ms = time_ms(torch, lambda: sp.spmm_ell(tiles, colidx, h))
    plain_ms = time_ms(torch, lambda: sp.spmm_ell_plain(tiles, colidx, h))
    dev_ms = device_ms(torch, lambda: sp.spmm_ell(tiles, colidx, h),
                       "spmm_ell_kernel")
    # yardsticks: the same product as one library call on a BSR tensor of
    # the non-empty tiles, and densified
    keep = tiles.abs().sum((2, 3)) > 0
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(keep.sum(1), 0)])
    with warnings.catch_warnings():      # "sparse BSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        bsr = torch.sparse_bsr_tensor(crow, colidx[keep].long(),
                                      tiles[keep],
                                      size=(n_rb * bm, TRAIN_BATCH),
                                      check_invariants=True)
    lib_err = (torch.sparse.mm(bsr, h)
               - sp.spmm_ell_plain(tiles, colidx, h)).abs().max().item()
    library_ms = time_ms(torch, lambda: torch.sparse.mm(bsr, h))
    dense_adj = sp.ell_to_dense(tiles, colidx, TRAIN_BATCH)
    dense_ms = time_ms(torch, lambda: torch.matmul(dense_adj, h))
    # every tile is read once (padding included, to find it), x and out
    # once; the products this batch needs are those of its nonzeros, so
    # the bound is the bytes' (the wrapper's spmm_ell_cost); beside it the
    # bound over the live tiles and over every slot (the first port's
    # count)
    n_ops, n_bytes = sp.spmm_ell_cost(tiles, colidx, h)
    nz_tiles = int(keep.sum())
    nnz = int(torch.count_nonzero(tiles))
    live_ops = 2 * nz_tiles * bm * bn * d
    padded_ops = 2 * n_rb * n_slots * bm * bn * d
    bound = bound_ms(n_bytes, n_ops)
    live_bound = bound_ms(n_bytes, live_ops)
    padded_bound = bound_ms(n_bytes, padded_ops)
    log(f"[kernels] spmm_ell training shape: {n_rb} row-blocks x {n_slots} "
        f"slots of ({bm}, {bn}) ({nz_tiles} live tiles, {nnz} nonzeros), d "
        f"{d}, {n_bytes} B, {n_ops} ops on the nonzeros: kernel {ms:.5f} ms "
        f"per call ({dev_ms:.5f} ms on the device, "
        f"{n_bytes / dev_ms / 1e9:.3f} TB/s), plain {plain_ms:.5f} ms, "
        f"bound {bound:.6f} ms (over the live tiles, {live_ops} ops: "
        f"{live_bound:.6f} ms; over every slot, {padded_ops} ops: "
        f"{padded_bound:.6f} ms); torch.sparse.mm on BSR {library_ms:.5f} ms "
        f"(max |diff| {lib_err:.3e}), dense torch.matmul {dense_ms:.5f} ms")
    return {"name": "spmm_ell", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spmm_ell.cu",
            "replaces": "src/repro/kernels/spmm_ell.py:69",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops /
                         F32_OPS_PER_S else "operations"),
            "bound_live_tiles_ms": live_bound,
            "bound_every_slot_ms": padded_bound, "live_tiles": nz_tiles,
            "library_ms": library_ms, "dense_matmul_ms": dense_ms}


def atomic_dx(torch, tiles, colidx, g, n_rows):
    """The SpMM backward's dX before the kernel: a batched GEMM over every
    slot, padding included, then an ``index_add_`` (float atomics on the
    card). A yardstick only: the port no longer calls it."""
    n_rb, n_slots, bm, bn = tiles.shape
    d = g.shape[1]
    n_cb = n_rows // bn
    c = colidx.long().clamp(0, max(n_cb - 1, 0))
    contrib = torch.matmul(tiles.transpose(-1, -2),
                           g.reshape(n_rb, bm, d)[:, None]).float()
    dx = torch.zeros((n_cb, bn, d), dtype=torch.float32, device=g.device)
    dx.index_add_(0, c.reshape(-1), contrib.reshape(-1, bn, d))
    return dx.reshape(n_rows, d).to(g.dtype)


def check_spmm_ell_dx(torch, plan, graph, dev) -> dict:
    """The SpMM's dX kernel against its plain version: on a real sampled
    training batch's tiles with a random cotangent, within 1e-5 of the
    largest |dX|, and bit-identical over 10 repeated calls; at the
    reference's tile sweep with a ragged d, on the top-k padding layout and
    in bf16 (5e-2); then timed at the training shape beside its bound, the
    plain version and the path it replaced (``atomic_dx``). No single
    library call computes this function."""
    from repro_torch.kernels import spmm_ell as sp
    gen = torch.Generator(device=dev).manual_seed(2)
    mb = plan.builder.build(*graph["adj"][0], graph["features"],
                            graph["labels"], 0)
    tiles, colidx = mb.adj[0]
    d = plan.cfg.d_hidden
    n_rb, n_slots, bm, bn = tiles.shape
    n_rows = TRAIN_BATCH
    g = torch.randn((n_rb * bm, d), generator=gen, device=dev)

    def compare(name, t, c, gg, rows, rtol):
        got = sp.spmm_ell_dx(t, c, gg, rows)
        torch.cuda.synchronize()
        ref = sp.spmm_ell_dx_plain(t, c, gg, rows)
        err = (got.float() - ref.float()).abs().max().item()
        limit = rtol * max(ref.float().abs().max().item(), 1e-30)
        log(f"[kernels] spmm_ell_dx {name}: tiles {tuple(t.shape)} "
            f"{t.dtype}, d {gg.shape[1]}: max |kernel - plain| {err:.3e} "
            f"(limit {limit:.3e})")
        if not err <= limit or got.dtype != gg.dtype:
            raise AssertionError(f"spmm_ell_dx {name}: error {err} above "
                                 f"{limit} (or dtype {got.dtype})")
        return err

    err = compare("training batch", tiles, colidx, g, n_rows, DX_RTOL)
    first = sp.spmm_ell_dx(tiles, colidx, g, n_rows)
    same = all(torch.equal(sp.spmm_ell_dx(tiles, colidx, g, n_rows), first)
               for _ in range(9))
    log(f"[kernels] spmm_ell_dx training batch, 10 calls: bit-identical "
        f"{same}")
    if not same:
        raise AssertionError("spmm_ell_dx: repeated calls differ")
    for bm_, bn_ in ((8, 8), (16, 32), (32, 16), (8, 128)):
        n_rb_, n_cb_, dd = 6, 5, 37
        keep = torch.rand((n_rb_, 1, n_cb_, 1), generator=gen,
                          device=dev) < 0.5
        dense = (torch.randn((n_rb_, bm_, n_cb_, bn_), generator=gen,
                             device=dev) * keep).reshape(n_rb_ * bm_,
                                                         n_cb_ * bn_)
        t, c = sp.dense_to_block_ell(dense, bm_, bn_, n_cb_ - 1)
        gg = torch.randn((n_rb_ * bm_, dd), generator=gen, device=dev)
        err = max(err, compare(f"sweep ({bm_}, {bn_})", t, c, gg,
                               n_cb_ * bn_, DX_RTOL))
    layout = [[3, None, 1, None, 2], [2, None, 0, 1, None], [None] * 5]
    t = torch.randn((3, 5, 128, 128), generator=gen, device=dev)
    c = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    for i, row in enumerate(layout):
        for slot, cb in enumerate(row):
            if cb is None:
                t[i, slot] = 0.0
            else:
                c[i, slot] = cb
    gg = torch.randn((3 * 128, d), generator=gen, device=dev)
    err = max(err, compare("top-k padding layout", t, c, gg, 4 * 128,
                           DX_RTOL))
    compare("bf16 training batch", tiles.bfloat16(), colidx, g.bfloat16(),
            n_rows, BF16_TOL)

    call = lambda: sp.spmm_ell_dx(tiles, colidx, g, n_rows)
    ms = time_ms(torch, call)
    plain_ms = time_ms(torch, lambda: sp.spmm_ell_dx_plain(tiles, colidx, g,
                                                           n_rows))
    atomic_ms = time_ms(torch, lambda: atomic_dx(torch, tiles, colidx, g,
                                             n_rows))
    parts = {}
    dev_ms = device_ms(torch, call, DX_KERNELS, parts=parts)
    atomic_err = (atomic_dx(torch, tiles, colidx, g, n_rows)
                - first).abs().max().item()
    # every tile read once (padding included, to find it), g read once,
    # dX written once; the products this batch needs are those of its
    # nonzeros (the wrapper's spmm_ell_dx_cost); beside it the bound over
    # the live tiles
    n_ops, n_bytes = sp.spmm_ell_dx_cost(tiles, colidx, g, n_rows)
    keep = tiles.abs().sum((2, 3)) > 0
    nz_tiles = int(keep.sum())
    live_ops = 2 * nz_tiles * bm * bn * d
    bound = bound_ms(n_bytes, n_ops)
    live_bound = bound_ms(n_bytes, live_ops)
    log(f"[kernels] spmm_ell_dx training shape: {n_rb} row-blocks x "
        f"{n_slots} slots of ({bm}, {bn}) ({nz_tiles} live tiles), d {d}, "
        f"{n_bytes} B, {n_ops} ops on the nonzeros: kernel {ms:.5f} ms per "
        f"call ({dev_ms:.5f} ms on the device: "
        f"{', '.join(f'{k} {v:.5f}' for k, v in parts.items())}; "
        f"{n_bytes / dev_ms / 1e9:.3f} TB/s), plain {plain_ms:.5f} ms, "
        f"bound {bound:.6f} ms (over the live tiles, {live_ops} ops: "
        f"{live_bound:.6f} ms); the path it replaced (batched GEMM + "
        f"index_add_) {atomic_ms:.5f} ms (max |diff| {atomic_err:.3e})")
    return {"name": "spmm_ell_dx", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spmm_ell_dx.cu",
            "replaces": "src/repro/kernels/ops.py:36",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": _bound_by(n_bytes, n_ops),
            "bound_live_tiles_ms": live_bound, "live_tiles": nz_tiles,
            "atomic_path_ms": atomic_ms, "library_ms": None,
            "device_parts": parts}


def check_bf16_routes(torch, plan, graph, dev, flushers) -> list:
    """The routes of ``block_dtype="bf16"`` at the training shape, each
    against its plain version on the card: the extraction's bf16 block
    (bit for bit, and the float32 block's cast; timed on a cold L2), the
    SpMM with the batch's bf16 tiles and a float32 h (1e-4 of the largest
    output) and its dX with a float32 cotangent (1e-5 of the largest
    |dX|, bit-identical over 10 calls), each on the top-k padding layout
    too; each timed beside its bound (the wrapper's cost function: 2-byte
    output or tiles), its plain version and the float32 route's device
    time in the same call. No single PyTorch call computes bf16 tiles
    times a float32 operand (``library_ms`` null)."""
    from repro_torch.kernels import extract_gather as eg
    from repro_torch.kernels import spmm_ell as sp
    bf16 = torch.bfloat16
    builder = plan.builder
    csr = list(graph["adj"][0])
    ids = builder.sample_ids(0, None, 0, device=dev)[0]
    kw = dict(col_scale=builder.rescale_constants()[0], diag=True,
              max_deg=builder.max_row_nnz)
    got = eg.extract_dense_fused(*csr, ids, ids, dtype=bf16, **kw)
    torch.cuda.synchronize()
    ref = eg.extract_dense_plain(*csr, ids, ids, dtype=bf16, **kw)
    f32 = eg.extract_dense_fused(*csr, ids, ids, **kw)
    nnz = int(torch.count_nonzero(ref))
    bitwise = torch.equal(got, ref) and torch.equal(got, f32.to(bf16))
    log(f"[kernels] extract_dense_fused bf16 training batch: "
        f"({ids.shape[0]}, {ids.shape[0]}) nnz {nnz}, bit-identical to the "
        f"plain bf16 block and to the float32 block's cast {bitwise}")
    if not bitwise or nnz == 0 or got.dtype != bf16:
        raise AssertionError("extract_dense_fused bf16: kernel and plain "
                             "version differ (or the block is empty)")
    written = flushers["written"]
    call = lambda: eg.extract_dense_fused(*csr, ids, ids, dtype=bf16, **kw)
    call32 = lambda: eg.extract_dense_fused(*csr, ids, ids, **kw)
    ms = time_ms(torch, call, flush=written)
    plain_ms = time_ms(torch, lambda: eg.extract_dense_plain(
        *csr, ids, ids, dtype=bf16, **kw), flush=written)
    dev_ms = device_ms(torch, call, "extract_dense_kernel", flush=written)
    dev32 = device_ms(torch, call32, "extract_dense_kernel", flush=written)
    n_ops, n_bytes = eg.extract_dense_cost(*csr, ids, ids, dtype=bf16,
                                           out=got, **kw)
    bound = bound_ms(n_bytes, n_ops)
    log(f"[kernels] extract_dense_fused bf16 training shape, {n_bytes} B, "
        f"L2 written: kernel {ms:.5f} ms per call ({dev_ms:.5f} ms on the "
        f"device, {bound / dev_ms:.3f} of the bound), plain {plain_ms:.5f} "
        f"ms, bound {bound:.6f} ms; the float32 route {dev32:.5f} ms on the "
        f"device in the same call")
    rows = [{"name": "extract_dense_fused_bf16", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/extract_gather.cu",
             "replaces": "src/repro/kernels/extract_gather.py:101",
             "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": _bound_by(n_bytes, n_ops), "library_ms": None,
             "f32_route_device_ms": dev32}]
    del got, ref, f32

    gen = torch.Generator(device=dev).manual_seed(3)
    mb = builder.build(*graph["adj"][0], graph["features"],
                       graph["labels"], 0)
    tiles = mb.adj[0][0].to(bf16)            # the bf16 batch's tiles
    colidx = mb.adj[0][1]
    d = plan.cfg.d_hidden
    n_rb, n_slots, bm, bn = tiles.shape
    h = torch.randn((TRAIN_BATCH, d), generator=gen, device=dev)
    g = torch.randn((n_rb * bm, d), generator=gen, device=dev)
    layout = [[3, None, 1, None, 2], [2, None, 0, 1, None], [None] * 5]
    pt = torch.randn((3, 5, 128, 128), generator=gen, device=dev)
    pc = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    for i, row in enumerate(layout):
        for slot, cb in enumerate(row):
            if cb is None:
                pt[i, slot] = 0.0
            else:
                pc[i, slot] = cb
    pt = pt.to(bf16)
    px = torch.randn((4 * 128, d), generator=gen, device=dev)

    def compare(name, fn, plain, args, rtol):
        out = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = (out - want).abs().max().item()
        limit = rtol * max(want.abs().max().item(), 1e-30)
        log(f"[kernels] {name}: bf16 tiles {tuple(args[0].shape)}, f32 "
            f"operand: max |kernel - plain| {err:.3e} (limit {limit:.3e})")
        if not err <= limit or out.dtype != torch.float32:
            raise AssertionError(f"{name}: error {err} above {limit} (or "
                                 f"dtype {out.dtype})")
        return err, out

    err_f, _ = compare("spmm_ell bf16_f32 training batch", sp.spmm_ell,
                       sp.spmm_ell_plain, (tiles, colidx, h), SPMM_RTOL)
    err_f = max(err_f, compare("spmm_ell bf16_f32 top-k padding layout",
                               sp.spmm_ell, sp.spmm_ell_plain,
                               (pt, pc, px), SPMM_RTOL)[0])
    err_b, first = compare("spmm_ell_dx bf16_f32 training batch",
                           sp.spmm_ell_dx, sp.spmm_ell_dx_plain,
                           (tiles, colidx, g, TRAIN_BATCH), DX_RTOL)
    err_b = max(err_b, compare(
        "spmm_ell_dx bf16_f32 top-k padding layout", sp.spmm_ell_dx,
        sp.spmm_ell_dx_plain, (pt, pc, torch.randn(
            (3 * 128, d), generator=gen, device=dev), 4 * 128), DX_RTOL)[0])
    same = all(torch.equal(sp.spmm_ell_dx(tiles, colidx, g, TRAIN_BATCH),
                           first) for _ in range(9))
    log(f"[kernels] spmm_ell_dx bf16_f32 training batch, 10 calls: "
        f"bit-identical {same}")
    if not same:
        raise AssertionError("spmm_ell_dx bf16_f32: repeated calls differ")

    # the batch's work at the kernels' units (spmm_ell_work): live
    # chunks, steps (8 rows x 1 column / 1 row x 8 columns), nonzeros and
    # the busiest CTA's share
    work = sp.spmm_ell_work(tiles, colidx, TRAIN_BATCH // bn)
    log(f"[kernels] the bf16 batch's work: {work['live_tiles']} live "
        f"tiles, {work['live_chunks']} live chunks, {work['nonzeros']} "
        f"nonzeros, {work['fwd_steps']} forward steps and "
        f"{work['dx_steps']} dX steps; the busiest forward CTA of "
        f"{work['fwd_ctas']} {work['fwd_cta_max']}, dX CTA of "
        f"{work['dx_ctas']} {work['dx_cta_max']}")
    t32 = tiles.float()
    for name, fn, plain, args, args32, kernels, cost, err, src, repl in (
            ("spmm_ell_bf16_f32", sp.spmm_ell, sp.spmm_ell_plain,
             (tiles, colidx, h), (t32, colidx, h), "spmm_ell_kernel",
             sp.spmm_ell_cost, err_f, "spmm_ell.cu",
             "src/repro/kernels/spmm_ell.py:69"),
            ("spmm_ell_dx_bf16_f32", sp.spmm_ell_dx, sp.spmm_ell_dx_plain,
             (tiles, colidx, g, TRAIN_BATCH), (t32, colidx, g, TRAIN_BATCH),
             DX_KERNELS, sp.spmm_ell_dx_cost, err_b, "spmm_ell_dx.cu",
             "src/repro/kernels/ops.py:36")):
        ms = time_ms(torch, lambda: fn(*args))
        plain_ms = time_ms(torch, lambda: plain(*args))
        parts, parts32 = {}, {}
        dev_ms = device_ms(torch, lambda: fn(*args), kernels, parts=parts)
        dev32 = device_ms(torch, lambda: fn(*args32), kernels,
                          parts=parts32)
        n_ops, n_bytes = cost(*args)
        bound = bound_ms(n_bytes, n_ops)
        split = lambda p: ", ".join(f"{k} {v:.5f}" for k, v in p.items())
        log(f"[kernels] {name} training shape: {n_rb} row-blocks x "
            f"{n_slots} slots of ({bm}, {bn}) bf16 tiles, d {d}, {n_bytes} "
            f"B, {n_ops} ops: kernel {ms:.5f} ms per call ({dev_ms:.5f} ms "
            f"on the device: {split(parts)}; {bound / dev_ms:.3f} of the "
            f"bound), plain {plain_ms:.5f} ms, bound {bound:.6f} ms; the "
            f"float32 route on the same values {dev32:.5f} ms on the device "
            f"({split(parts32)}) in the same call")
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": repl, "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": _bound_by(n_bytes, n_ops),
                     "library_ms": None, "f32_route_device_ms": dev32,
                     "device_parts": parts})
    return rows


# the reference's sweep (tests/test_kernels_flash.py), B = 2:
# (sq, t, h, kv, hd, causal, window)
FLASH_SWEEP = [(64, 64, 4, 2, 32, True, None),
               (32, 96, 4, 4, 16, False, None),
               (128, 128, 8, 2, 16, True, 32),
               (64, 100, 2, 1, 32, False, None),
               (256, 256, 2, 2, 64, True, None)]


def check_flash_attention(torch, np, dev) -> list:
    """The flash-attention kernel against its plain version on the card:
    out and lse at the reference's sweep shapes on both routes (f32 within
    1e-4; bf16 out per element within 1e-2 of 1 + |plain| and at most 5e-2,
    lse within 1e-4), in bf16 at the LLM serving shape and at hd 128, and
    in f32 at FLASH_BWD_SHAPES' f32 rows, each call's bits repeated by a
    second call; then the bf16 route timed at the serving shape, a long
    one and the LLM training shape (4, 2048), the f32 route at the serving
    shape and the training shape (2, 2048), beside the bound and, in turns,
    SDPA on the same tensors. Returns one entry per route."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(3)

    def make(b, sq, t, h, kv, hd, dtype):
        mk = lambda *s: torch.from_numpy(
            rng.normal(size=s).astype(np.float32)).to(dev, dtype)
        return mk(b, sq, h, hd), mk(b, t, kv, hd), mk(b, t, kv, hd)

    def compare(name, q, k, v, causal, window):
        out, lse = fa.flash_attention(q, k, v, causal, window)
        again = fa.flash_attention(q, k, v, causal, window)
        torch.cuda.synchronize()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal, window)
        diff = (out.float() - ref.float()).abs()
        if q.dtype == torch.float32:
            out_limit, lse_limit = FLASH_ATOL, FLASH_ATOL
            what = f"limits {FLASH_ATOL}"
        else:
            out_limit = (FLASH_BF16_OUT_RTOL * (1 + ref.float().abs())
                         ).clamp(max=BF16_TOL)
            lse_limit = FLASH_BF16_LSE_ATOL
            what = (f"limits {FLASH_BF16_OUT_RTOL} * (1 + |plain|) <= "
                    f"{BF16_TOL} and {lse_limit}")
        err, worst = diff.max().item(), (diff / out_limit).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"[kernels] flash_attention {name}: q {tuple(q.shape)}, kv "
            f"{tuple(k.shape)} {q.dtype}, causal={causal}, window={window}: "
            f"max |kernel - plain| out {err:.3e} ({worst:.3f} of its "
            f"limit), lse {lse_err:.3e} ({what}); a second call the same "
            f"bits: {same}")
        if not (worst <= 1 and lse_err <= lse_limit and same
                and out.dtype == q.dtype):
            raise AssertionError(f"flash_attention {name}: out {err} "
                                 f"({worst} of its limit), lse {lse_err} "
                                 f"above {lse_limit}, same bits {same}")
        return max(err, lse_err)

    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for sq, t, h, kv, hd, causal, window in FLASH_SWEEP:
            q, k, v = make(2, sq, t, h, kv, hd, dtype)
            err[dtype] = max(err[dtype], compare("sweep", q, k, v, causal,
                                                 window))
    for name, (h, kv, hd) in (("LLM serving shape", (32, 4, 64)),
                              ("qwen2-style, hd 128", (14, 2, 128))):
        q, k, v = make(1, 512, 512, h, kv, hd, torch.bfloat16)
        err[torch.bfloat16] = max(err[torch.bfloat16],
                                  compare(name, q, k, v, True, None))
    # the f32 route where it runs: the backward's f32 shapes (the training
    # shape, hd 128, windows, non-causal ragged T, MHA)
    for label, b, sq, t, h, kv, hd, causal, window, dname in \
            FLASH_BWD_SHAPES:
        if dname == "float32":
            q, k, v = make(b, sq, t, h, kv, hd, torch.float32)
            err[torch.float32] = max(err[torch.float32],
                                     compare(label, q, k, v, causal, window))
            del q, k, v

    # (label, batch, sequence, type, the route's peak rate)
    timed = (("serving", 1, 512, torch.bfloat16, BF16_TC_OPS_PER_S),
             ("long", 8, 2048, torch.bfloat16, BF16_TC_OPS_PER_S),
             ("train", 4, 2048, torch.bfloat16, BF16_TC_OPS_PER_S),
             ("serving", 1, 512, torch.float32, F32_OPS_PER_S),
             ("train", 2, 2048, torch.float32, F32_OPS_PER_S))
    shapes = {torch.float32: {}, torch.bfloat16: {}}
    for label, b, s, dtype, peak in timed:
        plan = fa.fwd_plan(b, s, s, 32, 4, 64, dtype, True)
        kernel = plan.kernel()
        q, k, v = make(b, s, s, 32, 4, 64, dtype)
        reps, inner = (25, 10) if label == "serving" else (5, 4)
        call = lambda: fa.flash_attention(q, k, v, True)
        # the kernel alone first: after the plain version's gigabyte of
        # scores, a profiled window read the f32 kernel 7 % slower than
        # the event windows of the same run did
        dev_ms = device_ms(torch, call, kernel,
                           n=50 if label == "serving" else 20)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                                   True),
                           reps=3, inner=2, warmup=1)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, S, hd)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True,
                                                      enable_gqa=True)
        lib_err = (sdpa().transpose(1, 2).float()
                   - call()[0].float()).abs().max().item()
        # in turns: kernel, SDPA, SDPA, kernel
        turns = [time_ms(torch, fn, reps=reps, inner=inner)
                 for fn in (call, sdpa, sdpa, call)]
        ms = (turns[0] + turns[3]) / 2
        library_ms = (turns[1] + turns[2]) / 2
        n_ops, n_bytes = fa.flash_attention_cost(q, k, v, True, None)
        bound = bound_ms(n_bytes, n_ops, peak)
        by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / peak \
            else "operations"
        log(f"[kernels] flash_attention {label} shape, {kernel} "
            f"({plan.n_ctas} CTAs, {plan.k_block}-key blocks, the last "
            f"tile first: {plan.reverse}): q {tuple(q.shape)}, kv "
            f"{tuple(k.shape)} {dtype} causal, "
            f"{n_bytes} B, {n_ops} ops: kernel {ms:.5f} ms per call "
            f"({dev_ms:.5f} ms on the device, "
            f"{n_ops / dev_ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.5f} ms, "
            f"bound {bound:.6f} ms ({by}, {bound / dev_ms:.3f} of it); "
            f"scaled_dot_product_attention {library_ms:.5f} ms (max |diff| "
            f"{lib_err:.3e}); in turns, kernel / SDPA / SDPA / kernel: "
            + " / ".join(f"{x:.5f}" for x in turns) + " ms")
        shapes[dtype][label] = {"q": list(q.shape), "kv": list(k.shape),
                                "ms": ms, "device_ms": dev_ms,
                                "turns_ms": turns,
                                "plain_ms": plain_ms, "bound_ms": bound,
                                "bound_by": by, "library_ms": library_ms}
        del q, k, v, qh, kh, vh

    # each route's figures at the shape of the path that launches it most:
    # bf16 LLM serving, f32 LLM training
    def entry(name, dtype, at):
        main = shapes[dtype][at]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:110",
                "max_abs_err": err[dtype],
                **{key: main[key] for key in
                   ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "shapes": shapes[dtype]}

    return [entry("flash_attention", torch.bfloat16, "serving"),
            entry("flash_attention_f32", torch.float32, "train")]


# the backward's shapes (b, sq, t, h, kv, hd, causal, window, dtype): the
# LLM training shapes (bf16 4 x 2048 and f32 2 x 2048 of tinyllama-1.1b's
# 32/4 heads), hd 128 at internlm2-1.8b's 16/8 heads in both types, a
# window, a non-causal call and a T that is no multiple of the 64-key block;
# then, in both types, a shape whose plan pairs key blocks and splits the q
# heads, MHA, and a window over a T that is no multiple of 64 or 128
FLASH_BWD_SHAPES = [
    ("train", 4, 2048, 2048, 32, 4, 64, True, None, "bfloat16"),
    ("train", 2, 2048, 2048, 32, 4, 64, True, None, "float32"),
    ("internlm2 hd 128", 2, 1024, 1024, 16, 8, 128, True, None, "bfloat16"),
    ("internlm2 hd 128", 1, 512, 512, 16, 8, 128, True, None, "float32"),
    ("window", 2, 1000, 1000, 8, 2, 64, True, 256, "bfloat16"),
    ("window", 1, 500, 500, 8, 2, 64, True, 128, "float32"),
    ("non-causal, ragged T", 2, 300, 333, 8, 2, 32, False, None,
     "bfloat16"),
    ("non-causal, ragged T", 1, 200, 333, 8, 2, 16, False, None,
     "float32"),
    ("paired and split", 1, 2048, 2048, 32, 4, 64, True, None, "bfloat16"),
    ("paired and split", 1, 2048, 2048, 32, 4, 64, True, None, "float32"),
    ("MHA, ragged T", 2, 300, 300, 4, 4, 64, True, None, "bfloat16"),
    ("MHA, ragged T", 2, 300, 300, 4, 4, 64, True, None, "float32"),
    ("window, ragged T", 2, 333, 333, 8, 2, 64, True, 100, "bfloat16"),
    ("window, ragged T", 2, 333, 333, 8, 2, 64, True, 100, "float32"),
]


def check_flash_attention_bwd(torch, np, dev) -> list:
    """The flash-attention backward kernels against their plain version on
    the card: dq, dk and dv at FLASH_BWD_SHAPES, bf16 within 5e-2 and f32
    within 1e-4 of each one's largest |plain|, and a second call's bits
    equal to the first's; then each route timed at its training shape
    beside its bound, its plain version and the backward of
    ``scaled_dot_product_attention`` (``is_causal``, ``enable_gqa``: a
    yardstick the port never calls), timed by autograd without its
    forward. Returns one entry per route."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(5)

    def make(b, sq, t, h, kv, hd, dtype, causal, window):
        mk = lambda *s: torch.from_numpy(
            rng.normal(size=s).astype(np.float32)).to(dev, dtype)
        q, k, v = mk(b, sq, h, hd), mk(b, t, kv, hd), mk(b, t, kv, hd)
        out, lse = fa.flash_attention(q, k, v, causal, window)
        return q, k, v, out, lse, mk(b, sq, h, hd)

    err = {"bfloat16": 0.0, "float32": 0.0}
    shapes = {"bfloat16": {}, "float32": {}}
    for label, b, sq, t, h, kv, hd, causal, window, dname in \
            FLASH_BWD_SHAPES:
        dtype = getattr(torch, dname)
        args = make(b, sq, t, h, kv, hd, dtype, causal, window)
        got = fa.flash_attention_bwd(*args, causal, window)
        again = fa.flash_attention_bwd(*args, causal, window)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        ref = fa.flash_attention_bwd_plain(*args, causal, window)
        limit = BF16_TOL if dtype == torch.bfloat16 else FLASH_BWD_RTOL
        rel = [(a.float() - r.float()).abs().max().item()
               / max(r.float().abs().max().item(), 1e-30)
               for a, r in zip(got, ref)]
        log(f"[kernels] flash_attention_bwd {label}: q ({b}, {sq}, {h}, "
            f"{hd}), kv ({b}, {t}, {kv}, {hd}) {dname}, causal={causal}, "
            f"window={window}: dq, dk, dv within {rel[0]:.3e}, "
            f"{rel[1]:.3e}, {rel[2]:.3e} of their largest |plain| (limit "
            f"{limit}); a second call the same bits: {same}")
        if not (max(rel) <= limit and same
                and all(a.dtype == dtype for a in got)):
            raise AssertionError(f"flash_attention_bwd {label} {dname}: "
                                 f"{rel}, same bits {same}")
        err[dname] = max(err[dname], max(
            (a.float() - r.float()).abs().max().item()
            for a, r in zip(got, ref)))
        if label != "train":
            continue
        del got, again, ref
        torch.cuda.empty_cache()
        plan = fa.bwd_plan(b, sq, t, h, kv, hd, dtype, causal, window)
        kernels = plan.kernels()
        peak = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 \
            else F32_OPS_PER_S
        call = lambda: fa.flash_attention_bwd(*args, causal, window)
        parts: dict = {}
        dev_ms = device_ms(torch, call, kernels, n=10, parts=parts)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            *args, causal, window), reps=3, inner=1, warmup=1)
        q, k, v, _, _, dout = args
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]                      # (B, H, S, hd)
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  enable_gqa=True)
        sdpa_dout = dout.transpose(1, 2)
        sdpa = lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                           retain_graph=True)
        # in turns: kernels, SDPA, SDPA, kernels
        turns = [time_ms(torch, fn, reps=5, inner=3, warmup=2)
                 for fn in (call, sdpa, sdpa, call)]
        ms = (turns[0] + turns[3]) / 2
        library_ms = (turns[1] + turns[2]) / 2
        lib_err = max((a.transpose(1, 2).float() - c.float()).abs().max()
                      .item() for a, c in zip(torch.autograd.grad(
                          sdpa_out, leaves, sdpa_dout, retain_graph=True),
                          call()))
        n_ops, n_bytes = fa.flash_attention_bwd_cost(*args, causal, window)
        bound = bound_ms(n_bytes, n_ops, peak)
        by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / peak \
            else "operations"
        log(f"[kernels] flash_attention_bwd {label} shape, plan "
            f"pair={plan.pair} split={plan.split} ({plan.n_units} dk/dv "
            f"units): {dname}, {n_bytes} B, {n_ops} ops: kernels {ms:.5f} "
            f"ms per call ({dev_ms:.5f} ms on the device: "
            + ", ".join(f"{name} {parts[name]:.5f}" for name in kernels)
            + f"; {n_ops / dev_ms / 1e9:.2f} TFLOP/s, {bound / dev_ms:.3f} "
            f"of the bound), plain {plain_ms:.5f} ms, bound {bound:.6f} ms "
            f"({by}); the backward of scaled_dot_product_attention "
            f"{library_ms:.5f} ms (max |diff| {lib_err:.3e}); in turns, "
            f"kernels / SDPA / SDPA / kernels: "
            + " / ".join(f"{x:.5f}" for x in turns) + " ms")
        shapes[dname][label] = {"q": [b, sq, h, hd], "kv": [b, t, kv, hd],
                                "ms": ms, "device_ms": dev_ms,
                                "kernels": parts, "turns_ms": turns,
                                "plain_ms": plain_ms, "bound_ms": bound,
                                "bound_by": by, "library_ms": library_ms}
        del args, leaves, sdpa_out, sdpa_dout, q, k, v, dout
        torch.cuda.empty_cache()

    def entry(name, dname):
        train = shapes[dname]["train"]
        return {"name": name, "route": "cuda",
                "source":
                    "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                # no pallas_call: the reference's _fa_bwd, plain jnp
                # (through layers._flash_bwd)
                "replaces": "src/repro/kernels/ops.py:190",
                "max_abs_err": err[dname],
                **{key: train[key] for key in
                   ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "shapes": shapes[dname]}

    return [entry("flash_attention_bwd", "bfloat16"),
            entry("flash_attention_bwd_f32", "float32")]


def phase_serve(torch, np, ds, cfg, n_requests: int) -> dict:
    """The main path: live serving through both kernels, then every served
    row recomputed on the plain path. Returns the launch counts."""
    from repro_torch.core import gcn_model as M
    from repro_torch.serve import InferenceEngine, ServeOptions

    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    eng = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                          ServeOptions(extract_impl="cuda"))
    ref_eng = InferenceEngine(
        params, dataclasses.replace(cfg, elementwise_impl="torch"),
        ds.adj_norm, ds.features, ServeOptions(extract_impl="torch"))
    eng.predict([0])                              # first-call warm-up
    eng.reset_stats()
    torch.cuda.synchronize()
    log(f"[serve] two engines built in {time.monotonic() - t0:.2f} s: "
        f"d_hidden {cfg.d_hidden}, {cfg.num_layers} layers, "
        f"{cfg.num_classes} classes, slots {eng.opts.slots} + support "
        f"{eng.opts.support}, e_cap {eng.spec.e_cap}")

    groups = []                                   # every micro-batch run
    execute = eng.backend.execute

    def recording_execute(group, now):
        groups.append(group)
        return execute(group, now)

    eng.backend.execute = recording_execute

    zipf = _zipf_stream(np, n_requests, ds.num_vertices)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    rids = []
    for v in zipf:
        rids.append(eng.submit([int(v)]))
        eng.pump()
    eng.drain()
    outs = {rid: eng.poll(rid) for rid in rids}
    dt = time.monotonic() - t0
    launches = read_launches()
    st = eng.stats()
    log(f"[serve] {len(rids)} requests in {dt:.4f} s: "
        f"{len(rids) / dt:.1f} req/s, p50 {st['p50_ms']:.4f} ms, "
        f"p99 {st['p99_ms']:.4f} ms, {st['device_calls']} device calls, "
        f"occupancy {st['occupancy']:.4f}, launches {launches}")
    # one extraction and one tail per layer for every device call
    expect = _per_step(extract_dense_fused=st["device_calls"],
                       fused_layer=cfg.num_layers * st["device_calls"])
    if launches != expect or st["device_calls"] == 0:
        raise AssertionError(f"kernel launches {launches} on the main path, "
                             f"expected {expect}")
    if st["completed"] != len(rids):
        raise AssertionError(f"{st['completed']} of {len(rids)} completed")
    for rid, out in outs.items():
        if out is None or out.shape != (1, cfg.num_classes) \
                or not np.all(np.isfinite(out)):
            raise AssertionError(f"request {rid}: bad output {out}")

    # every served row, recomputed from the same micro-batches on the
    # plain path on the same card
    worst = 0.0
    rows = 0
    for group in groups:
        for c in ref_eng.backend.execute(group, 0.0):
            worst = max(worst, float(np.abs(outs[c.rid][c.pos]
                                            - c.value).max()))
            rows += 1
    log(f"[serve] {rows} served rows vs the plain path: max |diff| "
        f"{worst:.3e} (atol {SERVE_ATOL})")
    if not worst <= SERVE_ATOL:
        raise AssertionError(f"served logits differ from the plain path by "
                             f"{worst}")
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_stream(torch, eng, zipf)
    return launches


def profile_stream(torch, eng, zipf) -> None:
    """Where the time goes: the same stream again under the profiler (which
    slows the host), as the device's busy share and its top operations."""
    from torch.profiler import ProfilerActivity, profile
    eng.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for v in zipf:
            eng.submit([int(v)])
            eng.pump()
        eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    device_profile(prof, wall_us,
                   f"stream of {len(zipf)} requests, "
                   f"{eng.stats()['device_calls']} device calls")


def _zipf_stream(np, n_requests: int, n_vertices: int):
    """Phase 4's request stream: Zipf(1.3) single vertices, seed 7."""
    return np.minimum(np.random.default_rng(7).zipf(1.3, size=n_requests),
                      n_vertices) - 1


def _replay_stream(eng, zipf) -> list:
    """The stream through a replay engine on a virtual clock (50 us between
    arrivals): the same batches on any engine; the logits of each
    request."""
    eng.reset_stats()
    rids, t = [], 0.0
    for v in zipf:
        rids.append(eng.submit([int(v)], now=t))
        eng.pump(now=t)
        t += 5e-5
    eng.drain(now=t)
    return [eng.poll(r, now=t) for r in rids]


def phase_serve_mesh(torch, np, ds, cfg, n_requests: int) -> dict:
    """Phase 4b: serving over the mesh (``serve/distributed.py``) at world
    size 1 over NCCL, ``force_distributed=True``, at phase 4's
    configuration (the fused extraction and tail): the same replayed
    stream through the single-device engine and through the mesh engine
    (the plan broadcast and the logits gathered by rank 0 of a NCCL group
    of one), every logit within 1e-5 of the largest |logit| of the single
    engine's; the mesh engine's assembly and extraction report and
    dispatch no collective, and one request's ledger holds the broadcast,
    the gather and the forward's all-reduces only. Returns the launch
    counts of the mesh engine's stream."""
    from repro_torch.core import gcn_model as M
    from repro_torch.obs import comm
    from repro_torch.serve import (InferenceEngine, ServeOptions,
                                   plan_batch_ranges)

    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    zipf = _zipf_stream(np, n_requests, ds.num_vertices)
    opts = dict(extract_impl="cuda", replay=True)
    single = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                             ServeOptions(**opts))
    single.predict([0], now=0.0)
    want = _replay_stream(single, zipf)
    single_calls = single.device_calls
    del single
    torch.cuda.empty_cache()

    def body():
        t0 = time.monotonic()
        eng = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                              ServeOptions(force_distributed=True, **opts))
        build_s = time.monotonic() - t0
        eng.predict([0], now=0.0)
        back = eng.backend
        plan = plan_batch_ranges(zipf[:1], back.spec, back._pools,
                                 back._n_pad_plan)
        dev = back.device
        assembly = comm.comm_report(
            back._dist.assemble, back._graph_sh,
            torch.from_numpy(plan.batch_ids).to(dev),
            torch.from_numpy(plan.col_scale).to(dev))
        ledger = comm.comm_report(eng.predict, [int(zipf[1])], now=0.0)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.monotonic()
        got = _replay_stream(eng, zipf)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = read_launches()
        st = eng.stats()
        eng.close()
        return got, launches, st, assembly, ledger, dt, build_s

    got, launches, st, assembly, ledger, dt, build_s = in_nccl_group(
        torch, "serve", body)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    scale = max(float(np.abs(b).max()) for b in want)
    bitwise = all(np.array_equal(a, b) for a, b in zip(got, want))
    log(f"[serve-mesh] mesh engine (force_distributed, NCCL world size 1) "
        f"built in {build_s:.2f} s; {len(got)} requests in {dt:.4f} s over "
        f"{st['device_calls']} device calls (single engine "
        f"{single_calls}): max |mesh - single| {worst:.3e} of the largest "
        f"|logit| {scale:.3e}, bit-identical {bitwise}; launches "
        f"{launches}")
    log(f"[serve-mesh] assembly and extraction of one micro-batch: "
        f"{assembly}, c10d ops dispatched {assembly.dispatched}; one "
        f"request: {ledger}, scopes "
        f"{sorted({op.op_name for op in ledger.sites})}, c10d ops "
        f"dispatched {ledger.dispatched}")
    if not worst <= 1e-5 * scale or st["device_calls"] != single_calls:
        raise AssertionError(f"the mesh engine's logits differ from the "
                             f"single engine's by {worst}")
    assembly.assert_no_collectives("serving's assembly and extraction")
    if (ledger.counts.get("broadcast"), ledger.counts.get("gather")) != \
            (1, 1) or ledger.counts["all-reduce"] == 0 \
            or ledger.for_scope("extract") \
            or ledger.dispatched_kinds() != ledger.kinds():
        raise AssertionError(f"unexpected collectives of one request: "
                             f"{ledger}")
    expect = _per_step(extract_dense_fused=st["device_calls"],
                       fused_layer=cfg.num_layers * st["device_calls"])
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} on the mesh "
                             f"serving path, expected {expect}")
    return launches


DRIVER_THREADS = 8


def phase_serve_driver(torch, np, ds, cfg, n_requests: int) -> dict:
    """Phase 4c: the threaded driver (``ServingDriver``) in front of the
    GNN engine: 8 submitter threads split phase 4's 400 Zipf requests, a
    future each; then every micro-batch the driver's pump ran is executed
    again directly on the engine, and every result must be its bits.
    Reports req/s, p50 and p99 and the starvation flushes; returns the
    launch counts of the threaded stream."""
    import threading

    from repro_torch.core import gcn_model as M
    from repro_torch.serve import InferenceEngine, ServeOptions, ServingDriver

    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    eng = InferenceEngine(params, cfg, ds.adj_norm, ds.features,
                          ServeOptions(extract_impl="cuda"))
    eng.predict([0])
    eng.reset_stats()
    groups = []
    execute = eng.backend.execute

    def recording_execute(group, now):
        groups.append(group)
        return execute(group, now)

    eng.backend.execute = recording_execute
    # each submitter learns its request's id from the engine's submit,
    # which the driver calls in the submitting thread
    local = threading.local()
    submit = eng.submit

    def recording_submit(payload, now=None, **kw):
        local.rid = submit(payload, now, **kw)
        return local.rid

    eng.submit = recording_submit
    zipf = _zipf_stream(np, n_requests, ds.num_vertices)
    parts = np.array_split(zipf, DRIVER_THREADS)
    futs, errs = {}, []
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.monotonic()
    with ServingDriver(eng) as drv:
        def worker(i):
            try:
                for v in parts[i]:
                    fut = drv.submit([int(v)])
                    futs[local.rid] = fut
            except Exception as exc:
                errs.append(exc)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(DRIVER_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = {rid: f.result(timeout=120) for rid, f in futs.items()}
        dt = time.monotonic() - t0
        st = drv.stats()
        flushes = drv.starvation_flushes
    torch.cuda.synchronize()
    launches = read_launches()
    if errs or len(results) != len(zipf):
        raise AssertionError(f"driver stream: {len(results)} of {len(zipf)} "
                             f"results, errors {errs}")
    eng.backend.execute = execute
    checked, worst, bitwise = 0, 0.0, True
    for group in groups:
        for c in execute(group, 0.0):
            row = results[c.rid][c.pos]
            worst = max(worst, float(np.abs(row - c.value).max()))
            bitwise &= bool(np.array_equal(row, c.value))
            checked += 1
    log(f"[serve-driver] {len(results)} requests from {DRIVER_THREADS} "
        f"threads in {dt:.4f} s: {len(results) / dt:.1f} req/s, p50 "
        f"{st['p50_ms']:.4f} ms, p99 {st['p99_ms']:.4f} ms, "
        f"{st['device_calls']} device calls, starvation flushes {flushes}, "
        f"in flight at most {st['inflight_high_water']}; launches "
        f"{launches}")
    scale = max(float(np.abs(r).max()) for r in results.values())
    log(f"[serve-driver] {checked} rows against the engine's direct "
        f"execution of the same micro-batches: max |diff| {worst:.3e} of "
        f"the largest |logit| {scale:.3e}, bit-identical {bitwise}")
    if not worst <= 1e-6 * scale or checked != len(results):
        raise AssertionError("results through the driver differ from the "
                             "engine's direct execution")
    expect = _per_step(extract_dense_fused=st["device_calls"],
                       fused_layer=cfg.num_layers * st["device_calls"])
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} through the "
                             f"driver, expected {expect}")
    return launches


def device_profile(prof, wall_us: float, what: str,
                   watch: tuple = (), spans: tuple = ()) -> dict:
    """The device's busy share of ``wall_us`` and its top six operations,
    from a profiler trace, and what the host issued: the PyTorch operators
    called from Python (``aten::`` ops not inside another one) and the
    kernel launches; then the device time and count in this trace of each
    kernel whose name holds a string of ``watch``, and the device time of
    the kernels launched inside each host range whose name ends with a
    string of ``spans`` (a ``phase`` annotation or an autograd node; a
    range inside another of the same name counts once). The phase
    annotations' mirrors on the device's timeline span kernels already
    counted and are left out. Returns the busy and wall time, the
    launches and each watched kernel's count."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    count: dict = {}
    span_us = dict.fromkeys(spans, 0.0)
    span_n = dict.fromkeys(spans, 0)
    host_ops = launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us()
                count[e.name] = count.get(e.name, 0) + 1
            continue
        for sp in spans:
            if e.name.endswith(sp):
                up = e.cpu_parent
                while up is not None and not up.name.endswith(sp):
                    up = up.cpu_parent
                if up is None:
                    span_us[sp] += e.device_time_total
                    span_n[sp] += 1
        if e.name.startswith("aten::") and not (
                e.cpu_parent is not None
                and e.cpu_parent.name.startswith("aten::")):
            host_ops += 1
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += 1
    busy_us = sum(by_name.values())
    log(f"[profile] {what}: wall {wall_us:.1f} us, device busy "
        f"{busy_us:.1f} us ({100 * busy_us / wall_us:.2f} %); the host "
        f"called {host_ops} operators and launched {launches} kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[profile]   {us:10.1f} us  {name[:90]}")
    for kernel in watch:
        names = [n for n in by_name if kernel in n]
        log(f"[profile]   {kernel}: {sum(by_name[n] for n in names):.1f} us "
            f"in {sum(count[n] for n in names)} launches")
    for sp in spans:
        log(f"[profile]   inside {sp}: {span_us[sp]:.1f} us of device time "
            f"over {span_n[sp]} ranges")
    return {"busy_us": busy_us, "wall_us": wall_us, "launches": launches,
            "host_ops": host_ops, "span_us": span_us,
            "kernels": {k: sum(count[n] for n in count if k in n)
                        for k in watch},
            "us": {k: sum(by_name[n] for n in by_name if k in n)
                   for k in watch},
            "names": {k: sorted(n for n in count if k in n) for k in watch}}


def plain_loss(params, mb, cfg, masks):
    """The training loss through the kernels' plain versions (autograd
    through plain PyTorch ops): the yardstick of phase 5."""
    from repro_torch.core.gcn_model import cross_entropy_loss
    from repro_torch.kernels.fused_layer import fused_layer_plain
    from repro_torch.kernels.spmm_ell import spmm_ell_plain
    tiles, colidx = mb.adj[0]
    h = mb.feats @ params["w_in"]
    for layer, mask in zip(params["layers"], masks):
        conv = spmm_ell_plain(tiles, colidx, h) @ layer["w"]
        h = fused_layer_plain(conv, layer["rms_scale"], mask, h,
                              dropout_rate=cfg.dropout, eps=cfg.rms_eps,
                              use_rmsnorm=cfg.use_rmsnorm,
                              use_relu=cfg.use_relu)
    return cross_entropy_loss(h @ params["w_out"], mb.labels)


def phase_train(torch, np, plan, graph, pg) -> dict:
    """The main path of training: ``Trainer.run`` for 48 steps through the
    four kernels (the SpMM's dX among them), held against the plain
    versions first, and twice more for the spread of ms/step; eight steps
    run twice from one state must give the same bits; then phase 5b, the
    distributed step through NCCL at world size 1, must give those bits
    again. Returns the launch counts of the 48 steps (``"train"``) and of
    phase 5b's eight (``"train_nccl"``)."""
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.core.forward import dropout_masks
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves, tree_map, unflatten

    dev, cfg, opts = plan.device, plan.cfg, plan.opts
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params0)
    make_opt = lambda: AdamW(lr=linear_warmup_cosine(5e-3, 20, TRAIN_STEPS),
                             weight_decay=1e-4, grad_clip=1.0)
    plain_builder = dataclasses.replace(plan.builder, impl="torch")
    mcfg = fourd.model_config(cfg, opts)

    def plain_step(params, step):
        mb = plain_builder.build(*graph["adj"][0], graph["features"],
                                 graph["labels"], step)
        masks = dropout_masks(opts, step, cfg.num_layers,
                              (TRAIN_BATCH, cfg.d_hidden), dev)
        for t in leaves(params):
            t.requires_grad_(True)
        loss = plain_loss(params, mb, mcfg, masks)
        grads = torch.autograd.grad(loss, leaves(params))
        return loss.detach(), unflatten(params, list(grads))

    # 1. the first step, kernels against plain versions, same params,
    #    batch and masks
    kb = plan.builder.build(*graph["adj"][0], graph["features"],
                            graph["labels"], 0)
    pb = plain_builder.build(*graph["adj"][0], graph["features"],
                             graph["labels"], 0)
    same_batch = all(torch.equal(a, b) for a, b in zip(kb.adj[0], pb.adj[0]))
    lk, gk = fourd.value_and_grad(fourd.make_loss_fn(plan), fresh(), graph, 0)
    lp, gp = plain_step(fresh(), 0)
    rel = abs(lk.item() - lp.item()) / abs(lp.item())
    worst = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
                for a, b in zip(leaves(gk), leaves(gp)))
    log(f"[train] first step, kernels vs plain versions: ELL batch "
        f"bit-identical {same_batch}, loss {lk.item():.7f} vs "
        f"{lp.item():.7f} (rel {rel:.3e}, limit {LOSS_RTOL}), worst "
        f"gradient leaf {worst:.3e} of its max |.| (limit {GRAD_RTOL})")
    if not (same_batch and rel <= LOSS_RTOL and worst <= GRAD_RTOL):
        raise AssertionError("first step: kernel path and plain path "
                             "disagree")

    # 2. eight steps on each path from the same init; the kernel path
    #    twice, captured (Trainer.run) and eager (Trainer.step)
    def eight(plan_, graph_):
        tr8 = Trainer(plan_, make_opt(),
                      TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                      eval_fn=lambda p, g: 0.0)
        st8, log8 = tr8.run(tr8.init_state(plan_.shard_params(fresh())),
                            graph_)
        return log8, st8.params

    log8, params8 = eight(plan, graph)
    tr8 = Trainer(plan, make_opt(),
                  TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                  eval_fn=lambda p, g: 0.0)
    st8 = tr8.init_state(fresh())
    eager8 = eager_run(torch, tr8, st8, graph, CHUNK)[0]
    same = eager8 == log8.losses and all(
        torch.equal(a, b) for a, b in zip(leaves(params8),
                                          leaves(st8.params)))
    log(f"[train] 8 steps from one state, captured ({log8.replays} replays)"
        f" and eager: losses and params bit-identical {same}")
    if not same or log8.replays != CHUNK - 1:
        raise AssertionError("8 captured steps and 8 eager steps from one "
                             "state differ")
    opt, params = make_opt(), fresh()
    opt_state, plain_losses = opt.init(params), []
    for step in range(CHUNK):
        loss, grads = plain_step(params, step)
        opt.update(params, grads, opt_state)
        plain_losses.append(loss.item())
    traj = max(abs(a - b) / abs(b) for a, b in zip(log8.losses,
                                                   plain_losses))
    log(f"[train] 8 steps, kernels: {[round(x, 5) for x in log8.losses]}")
    log(f"[train] 8 steps, plain:   {[round(x, 5) for x in plain_losses]} "
        f"(worst rel diff {traj:.3e}, limit {TRAJ_RTOL})")
    if not traj <= TRAJ_RTOL:
        raise AssertionError(f"8-step losses differ by {traj}")

    # 3. the main path: 48 steps through the Trainer, a warm-up step and a
    #    capture, then 47 replays; counts zeroed first
    trainer = Trainer(plan, make_opt(),
                      TrainLoopConfig(total_steps=TRAIN_STEPS,
                                      chunk_size=CHUNK))
    state = trainer.init_state(fresh())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state, run_log = trainer.run(state, graph)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    params48 = tree_map(lambda t: t.detach().clone(), state.params)
    # the wrappers count the warm-up step's launches and the capture's;
    # the 47 replays launch the same kernels from the graph (the profiled
    # chunk below counts them on the device)
    expect = captured_launches(cfg.num_layers)
    losses = run_log.losses
    first, last = np.mean(losses[:CHUNK]), np.mean(losses[-CHUNK:])
    log(f"[train] {len(losses)} steps in chunks of {CHUNK}, "
        f"{run_log.replays} of them replays of the captured step (capture "
        f"{run_log.capture_s:.3f} s): {run_log.ms_per_step:.4f} ms/step "
        f"(without the capture {ms_without_capture(run_log):.4f}), loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} (mean of first 8 {first:.5f},"
        f" last 8 {last:.5f}), launches {launches}, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if launches != expect or run_log.replays != TRAIN_STEPS - 1:
        raise AssertionError(f"kernel launches {launches} and "
                             f"{run_log.replays} replays on the training "
                             f"path, expected {expect} and "
                             f"{TRAIN_STEPS - 1}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"the loss did not fall: {losses}")

    t0 = time.monotonic()
    acc = float(trainer.eval_fn(state.params, graph))
    torch.cuda.synchronize()
    log(f"[train] full-graph accuracy after {TRAIN_STEPS} steps: {acc:.6f} "
        f"({graph['labels'].shape[0]} vertices, "
        f"{time.monotonic() - t0:.3f} s)")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc}")

    # where the time goes: one more chunk under the profiler, replays of
    # the graph the main run captured
    from torch.profiler import ProfilerActivity, profile
    trainer.total_steps = TRAIN_STEPS + CHUNK
    trainer.eval_fn = lambda p, g: 0.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, chunk_log = trainer.run(state, graph)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    seen = device_profile(
        prof, wall_us, f"one chunk of {CHUNK} training steps, "
        f"{chunk_log.replays} replays of the captured step",
        watch=tuple(STEP_KERNELS), spans=("sample", "extract",
                                          "_SpmmEllBackward",
                                          "_FusedTailBackward"))
    want = {k: n * CHUNK for k, n in STEP_KERNELS.items()}
    log(f"[train] kernels in the profiled replays: {seen['kernels']} "
        f"(expected {want})")
    if chunk_log.replays != CHUNK or seen["kernels"] != want:
        raise AssertionError("the replays did not run the step's kernels")
    del trainer
    # the spread of ms/step: two more runs of 48 steps from the same init,
    # after the profiled chunk: a graph captured after the profiled one and
    # destroyed before its profiled replays made that replay crash
    # (PERF.md section 7)
    spread = [run_log]
    for _ in range(2):
        tr = Trainer(plan, make_opt(),
                     TrainLoopConfig(total_steps=TRAIN_STEPS,
                                     chunk_size=CHUNK),
                     eval_fn=lambda p, g: 0.0)
        spread.append(tr.run(tr.init_state(fresh()), graph)[1])
        del tr
    log(f"[train] ms/step over {TRAIN_STEPS} steps, three runs: "
        f"{', '.join(f'{v.ms_per_step:.4f}' for v in spread)} (without the "
        f"capture {', '.join(f'{ms_without_capture(v):.4f}' for v in spread)}"
        ")")
    if any("bfloat16" in n for k in BF16_ROUTE_KERNELS
           for n in seen["names"][k]):
        raise AssertionError(f"a bf16 route ran in the f32 step: "
                             f"{seen['names']}")
    figures = phase_instruments(torch, plan, graph, pg, fresh, make_opt,
                                seen["busy_us"] / CHUNK / 1e3)
    figures["first_loss"] = lk.item()
    nccl = phase_train_nccl(torch, plan, pg, fresh, make_opt, log8, params8)
    prefetch = phase_train_comm(torch, np, plan, graph, pg, fresh, make_opt,
                                (log8, params8), (run_log, params48), expect)
    counter_kernels = phase_train_capture(torch, np, plan, graph, fresh,
                                          make_opt, (run_log, params48))
    return {"train": launches, "train_nccl": nccl,
            "train_prefetch": prefetch}, counter_kernels, figures


DRYRUN_TIMEOUT_S = 600


def phase_instruments(torch, plan, graph, pg, fresh, make_opt,
                      step_device_ms: float) -> None:
    """The instruments on the training path; captures no graph. One eager
    ``Trainer.step`` of phase 5's plan (its seeds, step 0) walked on the
    card (``launch.roofline.analyze_step``), and the same step walked on
    the CPU (the plan on a CPU mesh with ``draw_in_tail``, so that the
    engine hands the tail its dropout key as on the card): equal FLOPs and
    bytes. Its roofline
    bound beside phase 5's device time a step (the profiled chunk's busy
    time over its steps), their ratio, and the FLOPs over that time at the
    float32 peak. Then the collectives of one eager step in a NCCL group of
    world size 1, sampling under ``assert_no_collectives``; then the
    production dry run (``python -m repro_torch.launch.dryrun --gnn``, both
    meshes) in a child process that sees no card: both records ``ok``."""
    from repro_torch.core import fourd
    from repro_torch.launch.roofline import (PEAK_FLOPS_F32, analyze_step,
                                             roofline_terms)
    from repro_torch.obs import comm
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import tree_map

    def walk(plan_, graph_, params):
        tr = Trainer(plan_, make_opt(),
                     TrainLoopConfig(total_steps=1, chunk_size=1),
                     eval_fn=lambda p, g: 0.0)
        return analyze_step(tr.step, tr.init_state(params), graph_)

    t0 = time.monotonic()
    card = walk(plan, graph, fresh())
    torch.cuda.synchronize()
    t_card = time.monotonic() - t0
    cpu_plan = dataclasses.replace(
        fourd.build_plan(pg, plan.cfg, fourd.make_mesh_4d(1, 1, "cpu"),
                         batch=TRAIN_BATCH, opts=plan.opts),
        draw_in_tail=True)
    t0 = time.monotonic()
    cpu = walk(cpu_plan, cpu_plan.shard_graph(pg),
               tree_map(lambda t: t.cpu(), fresh()))
    t_cpu = time.monotonic() - t0
    same = (card["flops"], card["bytes"]) == (cpu["flops"], cpu["bytes"])
    log(f"[instruments] one eager training step walked on the card "
        f"({t_card:.2f} s): {card['flops']:.0f} FLOPs, {card['bytes']:.0f} "
        f"bytes ({card['bytes_copy']:.0f} more in copies), upper bound "
        f"{card['upper_bound']}; on the CPU ({t_cpu:.2f} s): "
        f"{cpu['flops']:.0f} FLOPs, {cpu['bytes']:.0f} bytes; equal {same}")
    for name, k in sorted(card["kernels"].items()):
        log(f"[instruments]   {name}: {k['launches']} launches, "
            f"{k['flops']:.0f} operations, {k['bytes']:.0f} bytes (CPU "
            f"walk {cpu['kernels'].get(name)})")
    if not same:
        raise AssertionError("the step walked on the card and on the CPU "
                             "counts different work")
    terms = roofline_terms(card)
    bound_ms = terms["t_bound_s"] * 1e3
    share = bound_ms / step_device_ms
    mfu = card["flops"] / (step_device_ms * 1e-3 * PEAK_FLOPS_F32)
    log(f"[instruments] {card_line()}: the step's compute term "
        f"{terms['t_compute_s'] * 1e3:.6f} ms (f32, 67e12 FLOP/s), memory "
        f"term {terms['t_memory_s'] * 1e3:.6f} ms (3.35e12 B/s), bound "
        f"{bound_ms:.6f} ms ({terms['dominant']}) against phase 5's "
        f"{step_device_ms:.6f} ms of device time a step: roofline share "
        f"{share:.4f}, f32 MFU {mfu:.4f}")
    if not 0.0 < share <= 1.0:
        raise AssertionError(f"roofline share {share}: the walk counts too "
                             "little work (or none)")
    figures = {"step_device_ms": step_device_ms, "walk_flops": card["flops"],
               "walk_bytes": card["bytes"], "bound_ms": bound_ms,
               "share": share, "mfu": mfu}

    def body():
        mesh = fourd.make_mesh_4d(1, 1)
        mplan = fourd.build_plan(pg, plan.cfg, mesh, batch=TRAIN_BATCH,
                                 opts=plan.opts)
        mgraph = mplan.shard_graph(pg)
        sampling = comm.assert_no_collectives(
            fourd.make_loss_fn(mplan).sample, mgraph, 0, what="sampling")
        tr = Trainer(mplan, make_opt(),
                     TrainLoopConfig(total_steps=1, chunk_size=1),
                     eval_fn=lambda p, g: 0.0)
        rep = comm.comm_report(tr.step, tr.init_state(
            mplan.shard_params(fresh())), mgraph)
        torch.cuda.synchronize()
        return sampling, rep

    sampling, rep = in_nccl_group(torch, "instr", body)
    scopes = {sc: rep.bytes_for_scope(sc)
              for sc in ("reshard", "spmm", "gemm", "tail", "transpose")}
    log(f"[instruments] one eager step's collectives in a NCCL group of one "
        f"rank: sampling {sampling} (c10d ops dispatched "
        f"{sampling.dispatched}); step {rep}; bytes by scope {scopes}, "
        f"by dtype {rep.bytes_by_dtype()}; c10d ops dispatched "
        f"{rep.dispatched}")
    if rep.counts["all-reduce"] == 0 or rep.counts["all-to-all"] \
            or rep.counts["reduce-scatter"]:
        raise AssertionError(f"unexpected collective set {rep.counts}")
    if rep.dispatched_kinds() != rep.kinds():
        raise AssertionError(f"c10d ops {rep.dispatched} of kinds no call "
                             f"site reported ({rep.kinds()})")

    out_dir = ROOT / "experiments" / "dryrun"
    for old in out_dir.glob("scalegnn_gcn_*.json"):
        old.unlink()
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--gnn"],
        cwd=ROOT, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(ROOT / "src")))
    recs = {m: json.loads((out_dir / f"scalegnn_gcn_{m}.json").read_text())
            for m in ("single", "multi")
            if (out_dir / f"scalegnn_gcn_{m}.json").exists()}
    for m, rec in recs.items():
        if rec["status"] != "ok":
            log(f"[instruments] dry run {m}: {rec.get('error')}")
            continue
        mem = rec["memory"]
        log(f"[instruments] dry run {m}, rank {rec['rank']} of "
            f"{rec['n_devices']} (counts on the meta device, not times): "
            f"{rec['flops_per_device']:.0f} FLOPs and "
            f"{rec['bytes_per_device']:.0f} bytes a rank, collective bytes "
            f"{ {k: v for k, v in rec['collective_bytes_per_device'].items() if v} }"
            f", arguments {mem['argument_bytes'] / 2**30:.3f} GiB, temp "
            f"{mem['temp_bytes'] / 2**30:.3f} GiB, sampling collectives "
            f"{rec['sampling_collectives']}, upper bound "
            f"{rec['loop_aware']['upper_bound']}")
    log(f"[instruments] dry run of both meshes in {time.monotonic() - t0:.1f}"
        f" s, exit code {r.returncode}")
    if r.returncode != 0 or len(recs) != 2 or any(
            rec["status"] != "ok" for rec in recs.values()):
        raise AssertionError(f"the dry run failed:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return figures


def phase_train_nccl(torch, plan, pg, fresh, make_opt, want_log,
                     want_params) -> dict:
    """Phase 5b: the distributed step through a real NCCL process group of
    world size 1 (a ``FileStore`` under ``build/``), ``make_mesh_4d(1, 1)``
    over it, the plan and graph built again on that mesh, and 8
    ``Trainer`` steps from the state of phase 5's 8-step runs, captured with
    the group's collectives in the graph (then 8 eager steps). An
    all-reduce over one rank is the identity, so the losses and params must
    be phase 5's bits. Returns the launch counts of the 8 steps."""
    import torch.distributed as dist

    from repro_torch.core import fourd
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves

    def body():
        mesh = fourd.make_mesh_4d(1, 1)
        mplan = fourd.build_plan(pg, plan.cfg, mesh, batch=TRAIN_BATCH,
                                 opts=plan.opts)
        mgraph = mplan.shard_graph(pg)
        tr = Trainer(mplan, make_opt(),
                     TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                     eval_fn=lambda p, g: 0.0)
        state = tr.init_state(mplan.shard_params(fresh()))
        torch.cuda.synchronize()
        zero_launches()
        state, run_log = tr.run(state, mgraph)
        launches = read_launches()
        same = run_log.losses == want_log.losses and all(
            torch.equal(a, b) for a, b in zip(leaves(state.params),
                                              leaves(want_params)))
        # the first run also sets up NCCL's communicators: time a second,
        # and the same 8 steps eagerly
        warm = Trainer(mplan, make_opt(),
                       TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                       eval_fn=lambda p, g: 0.0)
        warm_ms = warm.run(warm.init_state(mplan.shard_params(fresh())),
                           mgraph)[1].ms_per_step
        eager = Trainer(mplan, make_opt(),
                        TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                        eval_fn=lambda p, g: 0.0)
        eager_losses, eager_ms = eager_run(
            torch, eager, eager.init_state(mplan.shard_params(fresh())),
            mgraph, CHUNK)
        log(f"[train-nccl] {dist.get_backend()} process group of "
            f"{dist.get_world_size()} rank, mesh {mesh.shape} on "
            f"{mesh.device}: 8 steps, {run_log.replays} of them replays of "
            f"the captured step, {run_log.ms_per_step:.4f} ms/step "
            f"(communicators set up), again {warm_ms:.4f} ms/step, eager "
            f"{eager_ms:.4f} ms/step; losses and params bit-identical to "
            f"phase 5's {same}, eager losses too "
            f"{eager_losses == want_log.losses}, launches {launches}")
        if not (same and eager_losses == want_log.losses):
            raise AssertionError("the NCCL step differs from phase 5's")
        expect = captured_launches(plan.cfg.num_layers)
        if launches != expect or run_log.replays != CHUNK - 1:
            raise AssertionError(f"kernel launches {launches} and "
                                 f"{run_log.replays} replays on the NCCL "
                                 f"path, expected {expect} and {CHUNK - 1}")
        return launches

    return in_nccl_group(torch, "5b", body)


def _stream_overlap_us(trace_path, side_kernel: str) -> dict:
    """From a profiler's Chrome trace: the device time (us) of the kernels
    on the stream that ran ``side_kernel``, of those on the other streams,
    and the time during which kernels of both run together (the measure of
    the intersection of the two unions of intervals)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and e.get("ph") == "X"]
    side = {e["args"]["stream"] for e in events if side_kernel in e["name"]}
    if len(side) != 1:
        raise AssertionError(f"{side_kernel} ran on streams {side}")

    def union(evs):
        out = []
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in evs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out
    s_iv = union([e for e in events if e["args"]["stream"] in side])
    m_iv = union([e for e in events if e["args"]["stream"] not in side])
    both, i, j = 0.0, 0, 0
    while i < len(s_iv) and j < len(m_iv):
        lo = max(s_iv[i][0], m_iv[j][0])
        hi = min(s_iv[i][1], m_iv[j][1])
        both += max(0.0, hi - lo)
        if s_iv[i][1] < m_iv[j][1]:
            i += 1
        else:
            j += 1
    return {"side_us": sum(b - a for a, b in s_iv),
            "main_us": sum(b - a for a, b in m_iv), "overlap_us": both}


def phase_train_comm(torch, np, plan, graph, pg, fresh, make_opt, want8,
                     want48, expect) -> dict:
    """Phase 5c: the §V options at the training shape (see the module
    docstring). ``want8`` is phase 5's 8-step (log, params), ``want48`` its
    48-step run's, ``expect`` that run's launch counts. Returns the launch
    counts of the 48 prefetched steps."""
    from repro_torch.core import fourd
    from repro_torch.core.precision import (dequantize, pack_int4, quantize,
                                            unpack_int4)
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves

    cfg, dev = plan.cfg, plan.device
    log8, params8 = want8
    log48, params48 = want48

    def same_run(a, b):
        return a[0].losses == b[0].losses and all(
            torch.equal(x, y) for x, y in zip(leaves(a[1]), leaves(b[1])))

    def run(plan_, graph_, steps, prefetch=False):
        """``steps`` steps of ``Trainer.run``: a warm-up step, a capture and
        replays, every option's collectives in the graph."""
        tr = Trainer(plan_, make_opt(),
                     TrainLoopConfig(total_steps=steps, chunk_size=CHUNK,
                                     prefetch=prefetch),
                     eval_fn=lambda p, g: 0.0)
        st, lg = tr.run(tr.init_state(plan_.shard_params(fresh()), graph_),
                        graph_)
        if lg.replays != steps - 1:
            raise AssertionError(f"{lg.replays} replays in {steps} steps")
        return lg, st.params, st, tr

    def with_opts(mesh, **kw):
        return fourd.build_plan(pg, cfg, mesh, batch=TRAIN_BATCH,
                                opts=dataclasses.replace(plan.opts, **kw))

    # the quantizers on the card against the CPU, at the training shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=(TRAIN_BATCH, cfg.d_hidden)).astype(np.float32)
    x[3] = 0.0
    x[7] *= 1e4
    xc = torch.from_numpy(x)
    for bits in (8, 4):
        qc, sc = quantize(xc, bits)
        qg, sg = quantize(xc.to(dev), bits)
        ok = (torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
              and torch.equal(dequantize(qg, sg, bits).cpu(),
                              dequantize(qc, sc, bits)))
        log(f"[train-comm] quantize/dequantize int{bits} at {tuple(x.shape)}"
            f" on the card: the CPU's bits {ok}")
        if not ok:
            raise AssertionError(f"int{bits} quantizers differ on the card")
    q4 = torch.from_numpy(rng.integers(-7, 8, size=x.shape).astype(np.int8))
    ok = (torch.equal(pack_int4(q4.to(dev)).cpu(), pack_int4(q4))
          and torch.equal(unpack_int4(pack_int4(q4.to(dev))).cpu(), q4))
    log(f"[train-comm] pack_int4/unpack_int4 on the card: the CPU's bits "
        f"and a round trip {ok}")
    if not ok:
        raise AssertionError("int4 packing differs on the card")

    # §V-B and the quantized wire on the single device
    single = {}
    for name, kw in (("bf16_collectives", dict(bf16_collectives=True)),
                     ("compress=bf16", dict(compress="bf16")),
                     ("compress=int8", dict(compress="int8"))):
        single[name] = run(with_opts(plan.mesh, **kw), graph, CHUNK)
    lg, _, st, _ = single["compress=int8"]
    zero = all(bool((v == 0).all()) for v in st.comm_ef.values())
    same = same_run(single["compress=int8"], (log8, params8))
    log(f"[train-comm] compress=int8, 8 steps: bit-identical to phase 5 "
        f"{same}, {len(st.comm_ef)} EF accumulators all exactly zero {zero}")
    if not (same and zero):
        raise AssertionError("the int8 wire at g = 1 is not the identity")

    # the same options, and the ring, through a NCCL group of one rank
    def body():
        mesh = fourd.make_mesh_4d(1, 1)
        mgraph = fourd.build_plan(pg, cfg, mesh, batch=TRAIN_BATCH,
                                  opts=plan.opts).shard_graph(pg)
        for name, kw in (("bf16_collectives", dict(bf16_collectives=True)),
                         ("compress=bf16", dict(compress="bf16"))):
            got = run(with_opts(mesh, **kw), mgraph, CHUNK)
            same = same_run(got, single[name])
            rel = abs(got[0].losses[0] - log8.losses[0]) / abs(
                log8.losses[0])
            log(f"[train-comm] {name}, 8 steps: single device and NCCL "
                f"bit-identical {same}; first loss {got[0].losses[0]:.7f} "
                f"vs f32 {log8.losses[0]:.7f} (rel {rel:.3e}, limit "
                f"{BF16_LOSS_RTOL}); losses "
                f"{[round(v, 5) for v in got[0].losses]}")
            if not (same and rel <= BF16_LOSS_RTOL):
                raise AssertionError(f"{name}: the bf16 wire is off")
        got = run(with_opts(mesh, overlap_impl="ring"), mgraph, CHUNK)
        same = same_run(got, (log8, params8))
        log(f"[train-comm] overlap_impl=ring through NCCL, 8 steps: "
            f"bit-identical to phase 5b {same}")
        if not same:
            raise AssertionError("the ring differs from the none path")

    in_nccl_group(torch, "5c", body)

    # §V-A: 48 steps with the next batch built on a side stream
    pplan = with_opts(plan.mesh)
    torch.cuda.synchronize()
    zero_launches()
    lg, params, _, tr = run(pplan, graph, TRAIN_STEPS, prefetch=True)
    launches = read_launches()
    same = same_run((lg, params), (log48, params48))
    log(f"[train-comm] prefetch, {TRAIN_STEPS} steps, {lg.replays} of them "
        f"replays: losses and params bit-identical to phase 5's {same}, "
        f"launches {launches}")
    if not same:
        raise AssertionError("prefetch changed the run")
    # the warm-up batch, then one prefetched in the warm-up step and one in
    # the capture (the replays prefetch from the graph)
    expect = dict(expect, extract_dense_fused=3, hash_keys=3)
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} with prefetch, "
                             f"expected {expect}")
    ms = {True: [lg.ms_per_step], False: []}
    for prefetch in (False, True, False, True, False):
        ms[prefetch].append(run(pplan, graph, TRAIN_STEPS,
                                prefetch)[0].ms_per_step)
    log(f"[train-comm] ms/step over {TRAIN_STEPS} steps, in turns: prefetch "
        f"on {', '.join(f'{v:.4f}' for v in ms[True])}; off "
        f"{', '.join(f'{v:.4f}' for v in ms[False])}")

    # one profiled chunk with prefetch on, replays of a captured step: do
    # side and main kernels overlap
    from torch.profiler import ProfilerActivity, profile
    tr = Trainer(pplan, make_opt(),
                 TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK,
                                 prefetch=True), eval_fn=lambda p, g: 0.0)
    state, _ = tr.run(tr.init_state(fresh(), graph), graph)
    tr.total_steps += CHUNK
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, chunk_log = tr.run(state, graph)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    trace = ROOT / "build" / "chip_smoke" / "prefetch_trace.json"
    prof.export_chrome_trace(str(trace))
    ov = _stream_overlap_us(trace, "extract_dense_kernel")
    trace.unlink()
    device_profile(prof, wall_us, f"one chunk of {CHUNK} training steps with "
                   f"prefetch, {chunk_log.replays} replays",
                   watch=("extract_dense_kernel",))
    log(f"[train-comm] prefetch chunk: side-stream kernels "
        f"{ov['side_us']:.1f} us, main-stream kernels {ov['main_us']:.1f} us,"
        f" both at once {ov['overlap_us']:.1f} us of {wall_us:.1f} us wall")
    return launches


def check_counter_rng(torch, plan, dev) -> list:
    """The counter kernels against their plain versions at the training
    path's shapes: ``hash_keys`` over the graph's padded vertex count,
    ``keep_mask`` at (8192, d_hidden) with the plan's dropout, bit for bit
    on the card and against the CPU, for keys at and above 2^63; then each
    timed beside its bound (the bytes it writes: the guide's table has no
    64-bit integer rate), its plain version and, for the mask,
    ``torch.rand(...) < 1 - p`` (another mask of the same rate, the
    library's yardstick; the port never calls it)."""
    from repro_torch.core import sampling as smp
    from repro_torch.kernels import counter_rng as crng
    n, rate = plan.scfg.n_pad, plan.opts.dropout
    rows, cols = TRAIN_BATCH, plan.cfg.d_hidden
    step_key = smp.step_key(plan.opts.seed, 7)
    for key in (0, 12345, 2 ** 63, 2 ** 64 - 1, step_key):
        k, kc = smp.key_tensor(key, dev), smp.key_tensor(key, "cpu")
        h = crng.hash_keys(k, n)
        m = crng.keep_mask(k, rows, cols, rate)
        same = (torch.equal(h, crng.hash_keys_plain(k, n))
                and torch.equal(h.cpu(), crng.hash_keys_plain(kc, n))
                and torch.equal(m, crng.keep_mask_plain(k, rows, cols, rate))
                and torch.equal(m.cpu(), crng.keep_mask_plain(kc, rows, cols,
                                                              rate)))
        log(f"[train-capture] key {key:#x}: hash_keys over {n} and "
            f"keep_mask at ({rows}, {cols}), rate {rate}: the plain "
            f"versions' bits on the card and the CPU {same}; keep rate "
            f"{m.float().mean().item():.6f}")
        if not same:
            raise AssertionError(f"counter kernels differ for key {key}")
    k = smp.key_tensor(step_key, dev)
    out = []
    for name, call, plain, lib, n_bytes in (
            ("hash_keys", lambda: crng.hash_keys(k, n),
             lambda: crng.hash_keys_plain(k, n), None,
             crng.hash_keys_cost(k, n)[1]),
            ("keep_mask", lambda: crng.keep_mask(k, rows, cols, rate),
             lambda: crng.keep_mask_plain(k, rows, cols, rate),
             lambda: torch.rand((rows, cols), device=dev) < 1.0 - rate,
             crng.keep_mask_cost(k, rows, cols, rate)[1])):
        ms = time_ms(torch, call)
        dev_ms = device_ms(torch, call, f"{name}_kernel")
        plain_ms = time_ms(torch, plain)
        lib_ms = None if lib is None else time_ms(torch, lib)
        bound = bound_ms(n_bytes, 0)
        log(f"[train-capture] {name}: {n_bytes} B written: kernel {ms:.5f} "
            f"ms per call ({dev_ms:.5f} ms on the device, "
            f"{n_bytes / dev_ms / 1e9:.3f} TB/s), bound {bound:.6f} ms, "
            f"plain {plain_ms:.5f} ms"
            + ("" if lib_ms is None else
               f", torch.rand(...) < 1 - p {lib_ms:.5f} ms"))
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/counter_rng.cu",
                    "replaces": ("none: the reference's jax.random."
                                 "permutation (src/repro/core/sampling.py:"
                                 "207) is XLA's threefry"
                                 if name == "hash_keys" else
                                 "none: the reference's jax.random."
                                 "bernoulli (src/repro/core/forward.py:300) "
                                 "is XLA's threefry"),
                    "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": lib_ms})
    return out


def phase_train_capture(torch, np, plan, graph, fresh, make_opt,
                        want48) -> list:
    """Phase 5d: the captured step against the eager one at the training
    shape. The counter kernels against their plain versions; the card's
    sampled ids for (seed, step) against the CPU's; 48 eager
    ``Trainer.step`` calls against phase 5's 48 captured steps (losses and
    params bit for bit); ms/step captured and eager in turns, three runs
    each, with the peak device memory of each; one profiled eager chunk
    beside phase 5's profiled replays. Returns the counter kernels'
    entries of the kernels line."""
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves

    kernels = check_counter_rng(torch, plan, plan.device)
    b = plan.builder
    for step in (0, 47):
        t = torch.tensor(step, dtype=torch.int32, device=plan.device)
        same = torch.equal(b.sample_ids(t, None, 0).cpu(),
                           b.sample_ids(step, None, 0, device="cpu"))
        log(f"[train-capture] sampled ids of (seed {b.seed}, step {step}), "
            f"{plan.scfg.batch} of {plan.scfg.n_pad}: the card's counter "
            f"draws the CPU's {same}")
        if not same:
            raise AssertionError("the card's sample differs from the CPU's")

    def trainer():
        return Trainer(plan, make_opt(),
                       TrainLoopConfig(total_steps=TRAIN_STEPS,
                                       chunk_size=CHUNK),
                       eval_fn=lambda p, g: 0.0)

    def eager():
        tr = trainer()
        st = tr.init_state(fresh())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = eager_run(torch, tr, st, graph, TRAIN_STEPS)
        return losses, st.params, ms, torch.cuda.max_memory_allocated()

    def captured():
        tr = trainer()
        st = tr.init_state(fresh())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, lg = tr.run(st, graph)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        del tr                                 # the graph and its pool
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return (lg.losses, st.params, lg, peak,
                held - torch.cuda.memory_reserved())

    log48, params48 = want48
    losses, params, ms_e, peak_e = eager()
    same = losses == log48.losses and all(
        torch.equal(a, b) for a, b in zip(leaves(params), leaves(params48)))
    log(f"[train-capture] {TRAIN_STEPS} eager Trainer.step calls: losses "
        f"and params bit-identical to phase 5's {TRAIN_STEPS} captured "
        f"steps {same}")
    if not same:
        raise AssertionError("captured and eager steps differ")
    ms = {"captured": [], "eager": [ms_e]}
    peaks = {"captured": [], "eager": [peak_e]}
    held, cap_s, steady = [], [], []
    for kind in ("captured", "eager", "captured", "eager", "captured"):
        if kind == "eager":
            _, _, m, p = eager()
        else:
            _, _, lg, p, h = captured()
            m = lg.ms_per_step
            held.append(h)
            cap_s.append(lg.capture_s)
            steady.append(ms_without_capture(lg))
        ms[kind].append(m)
        peaks[kind].append(p)
    log(f"[train-capture] ms/step over {TRAIN_STEPS} steps, in turns: "
        f"captured {', '.join(f'{v:.4f}' for v in ms['captured'])} (the "
        f"warm-up step and the capture included; without the capture "
        f"{', '.join(f'{v:.4f}' for v in steady)}); eager "
        f"{', '.join(f'{v:.4f}' for v in ms['eager'])}; capture "
        f"{', '.join(f'{v:.3f}' for v in cap_s)} s")
    log(f"[train-capture] peak device memory: captured "
        f"{max(peaks['captured']) / 2**30:.3f} GiB, eager "
        f"{max(peaks['eager']) / 2**30:.3f} GiB; the graph's private pool "
        f"reserves {max(held) / 2**30:.3f} GiB after a run")

    from torch.profiler import ProfilerActivity, profile
    tr = trainer()
    st = tr.init_state(fresh())
    eager_run(torch, tr, st, graph, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eager_run(torch, tr, st, graph, CHUNK)
        wall_us = (time.monotonic() - t0) * 1e6
    device_profile(prof, wall_us, f"one chunk of {CHUNK} eager training "
                   "steps (Trainer.step)")
    return kernels


# phase 5e: the reference's other samplers at the training shape
def phase_train_bf16(torch, np, plan, graph, pg, f32: dict) -> dict:
    """Phase 5f: phase 5's train cell with ``block_dtype="bf16"`` (the
    same model, graph, batch, options and init): the first step against
    the plain versions on the same bf16 blocks (loss 1e-5, gradients 1e-4)
    and its loss beside the float32 step's; 48 steps of ``Trainer.run``
    (a warm-up step, a capture, 47 replays) with every wrapper at its
    count on the bf16 routes, the loss falling; one profiled chunk of 8
    replays (each step's device kernels, the bf16 instances of the route
    kernels) for a step's device time beside phase 5's; 8 captured and 8
    eager steps from one state, bit for bit; and one eager step walked
    (``launch.roofline.analyze_step``): its bytes, bound and roofline
    share beside phase 5's. Returns the launch counts of the 48 steps."""
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.core.forward import dropout_masks
    from repro_torch.launch.roofline import analyze_step, roofline_terms
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves, tree_map, unflatten

    dev, cfg = plan.device, plan.cfg
    opts = dataclasses.replace(plan.opts, block_dtype="bf16")
    bplan = fourd.build_plan(pg, cfg, plan.mesh, batch=TRAIN_BATCH,
                             opts=opts)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params0)
    make_opt = lambda: AdamW(lr=linear_warmup_cosine(5e-3, 20, TRAIN_STEPS),
                             weight_decay=1e-4, grad_clip=1.0)
    plain_builder = dataclasses.replace(bplan.builder, impl="torch")
    mcfg = fourd.model_config(cfg, opts)

    # 1. the first step, kernels against plain versions on the same blocks
    kb = bplan.builder.build(*graph["adj"][0], graph["features"],
                             graph["labels"], 0)
    pb = plain_builder.build(*graph["adj"][0], graph["features"],
                             graph["labels"], 0)
    same_batch = kb.adj[0][0].dtype == torch.bfloat16 and all(
        torch.equal(a, b) for a, b in zip(kb.adj[0], pb.adj[0]))
    lk, gk = fourd.value_and_grad(fourd.make_loss_fn(bplan), fresh(), graph,
                                  0)
    for t in leaves(params := fresh()):
        t.requires_grad_(True)
    masks = dropout_masks(opts, 0, cfg.num_layers,
                          (TRAIN_BATCH, cfg.d_hidden), dev)
    loss_p = plain_loss(params, pb, mcfg, masks)
    gp = unflatten(params, list(torch.autograd.grad(loss_p,
                                                    leaves(params))))
    log(f"[train-bf16] the bf16 batch: tiles {tuple(kb.adj[0][0].shape)} "
        f"{kb.adj[0][0].dtype}, the fused and the plain extraction "
        f"bit-identical {same_batch}")
    if not same_batch:
        raise AssertionError("the bf16 blocks of the kernel and plain "
                             "paths differ")
    _first_step_check(torch, "train-bf16", lk.item(), gk, loss_p.item(), gp)
    rel = abs(lk.item() - f32["first_loss"]) / abs(f32["first_loss"])
    log(f"[train-bf16] first step's loss {lk.item():.7f} beside the float32 "
        f"step's {f32['first_loss']:.7f} (rel {rel:.3e})")

    # 2. the main path: 48 steps, a warm-up, a capture and 47 replays
    trainer = Trainer(bplan, make_opt(),
                      TrainLoopConfig(total_steps=TRAIN_STEPS,
                                      chunk_size=CHUNK),
                      eval_fn=lambda p, g: 0.0)
    state = trainer.init_state(fresh())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state, run_log = trainer.run(state, graph)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    expect = captured_launches(cfg.num_layers, bf16=True)
    log(f"[train-bf16] {len(run_log.losses)} steps, {run_log.replays} "
        f"replays (capture {run_log.capture_s:.3f} s): "
        f"{run_log.ms_per_step:.4f} ms/step (without the capture "
        f"{ms_without_capture(run_log):.4f}), launches {launches}, peak "
        f"device memory {peak / 2**30:.3f} GiB")
    if launches != expect or run_log.replays != TRAIN_STEPS - 1:
        raise AssertionError(f"kernel launches {launches} and "
                             f"{run_log.replays} replays on the bf16 path, "
                             f"expected {expect} and {TRAIN_STEPS - 1}")
    _loss_falls("train-bf16", run_log.losses, np)

    # 3. a chunk of replays of the graph just captured, under the profiler
    from torch.profiler import ProfilerActivity, profile
    trainer.total_steps = TRAIN_STEPS + CHUNK
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, chunk_log = trainer.run(state, graph)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    seen = device_profile(
        prof, wall_us, f"one chunk of {CHUNK} bf16 training steps, "
        f"{chunk_log.replays} replays", watch=tuple(STEP_KERNELS),
        spans=("sample", "extract", "_SpmmEllBackward"))
    want = {k: n * CHUNK for k, n in STEP_KERNELS.items()}
    routes_bf16 = all(seen["names"][k] and all("bfloat16" in n for n in
                                               seen["names"][k])
                      for k in BF16_ROUTE_KERNELS)
    log(f"[train-bf16] kernels in the profiled replays: {seen['kernels']} "
        f"(expected {want}); the route kernels' instances "
        f"{ {k: seen['names'][k] for k in BF16_ROUTE_KERNELS} }")
    if chunk_log.replays != CHUNK or seen["kernels"] != want \
            or not routes_bf16:
        raise AssertionError("the bf16 replays did not run the step's "
                             "kernels on their bf16 routes")
    dev_ms = seen["busy_us"] / CHUNK / 1e3
    del trainer

    # 4. captured against eager, 8 steps from one state
    tr8 = Trainer(bplan, make_opt(),
                  TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                  eval_fn=lambda p, g: 0.0)
    st8, log8 = tr8.run(tr8.init_state(fresh()), graph)
    del tr8
    tre = Trainer(bplan, make_opt(),
                  TrainLoopConfig(total_steps=CHUNK, chunk_size=CHUNK),
                  eval_fn=lambda p, g: 0.0)
    ste = tre.init_state(fresh())
    eager8 = eager_run(torch, tre, ste, graph, CHUNK)[0]
    same = eager8 == log8.losses and all(
        torch.equal(a, b) for a, b in zip(leaves(st8.params),
                                          leaves(ste.params)))
    log(f"[train-bf16] 8 steps from one state, captured ({log8.replays} "
        f"replays) and eager: losses and params bit-identical {same}")
    if not same or log8.replays != CHUNK - 1:
        raise AssertionError("8 captured and 8 eager bf16 steps differ")

    # 5. one eager step walked from the init, as phase 5's was
    trw = Trainer(bplan, make_opt(),
                  TrainLoopConfig(total_steps=1, chunk_size=1),
                  eval_fn=lambda p, g: 0.0)
    walk = analyze_step(trw.step, trw.init_state(fresh()), graph)
    torch.cuda.synchronize()
    terms = roofline_terms(walk)
    bound = terms["t_bound_s"] * 1e3
    share = bound / dev_ms
    log(f"[train-bf16] {card_line()}: one eager bf16 step walked: "
        f"{walk['flops']:.0f} FLOPs, {walk['bytes']:.0f} bytes, bound "
        f"{bound:.6f} ms ({terms['dominant']}) against {dev_ms:.6f} ms of "
        f"device time a step: roofline share {share:.4f}; the float32 step "
        f"(phase 5, this run): {f32['walk_bytes']:.0f} bytes, bound "
        f"{f32['bound_ms']:.6f} ms, {f32['step_device_ms']:.6f} ms a step, "
        f"share {f32['share']:.4f}")
    for name, k in sorted(walk["kernels"].items()):
        log(f"[train-bf16]   {name}: {k['launches']} launches, "
            f"{k['flops']:.0f} operations, {k['bytes']:.0f} bytes")
    if not 0.0 < share <= 1.0 or walk["bytes"] >= f32["walk_bytes"]:
        raise AssertionError(f"the bf16 step's walk: share {share}, bytes "
                             f"{walk['bytes']} (float32 "
                             f"{f32['walk_bytes']})")
    return launches


CLUSTER_SIZE = 1024      # partition: vertices per cluster (q = 8 at 8192)
WALK_LEN, WALK_K = 3, 8  # walk: 2048 roots of 4 vertices at 8192
SAGE_BATCH = 1024
SAGE_FANOUTS = (15, 10, 5)   # innermost first
FULLBATCH_STEPS = 8


def _per_step(**counts) -> dict:
    """A path's launches of one step, every other kernel at 0."""
    return {name: counts.get(name, 0) for name in KERNEL_COUNTERS}


def _times(counts: dict, k: int) -> dict:
    return {name: n * k for name, n in counts.items()}


def _first_step_check(torch, tag, loss_k, grads_k, loss_p, grads_p,
                      loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL):
    """The first step's loss within ``loss_rtol`` and every gradient leaf
    within ``grad_rtol`` of its max |.| of the plain versions' step."""
    from repro_torch.tree import leaves
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max((a.float() - b.float()).abs().max().item()
                / max(b.float().abs().max().item(), 1e-30)
                for a, b in zip(leaves(grads_k), leaves(grads_p)))
    log(f"[{tag}] first step, kernels vs plain versions: loss "
        f"{loss_k:.7f} vs {loss_p:.7f} (rel {rel:.3e}, limit {loss_rtol}), "
        f"worst gradient leaf {worst:.3e} of its max |.| (limit "
        f"{grad_rtol})")
    if not (rel <= loss_rtol and worst <= grad_rtol):
        raise AssertionError(f"{tag}: kernel and plain first steps differ")


def _loss_falls(tag, losses, np) -> None:
    k = min(CHUNK, len(losses) // 2)
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    log(f"[{tag}] loss {losses[0]:.5f} -> {losses[-1]:.5f} (mean of first "
        f"{k} {first:.5f}, last {k} {last:.5f})")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"{tag}: the loss did not fall: {losses}")


def _grad_of(torch, loss_fn, params):
    from repro_torch.tree import leaves, unflatten
    for t in leaves(params):
        t.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.item(), unflatten(params, list(grads))


def _summary(tag, labelled, ms, dev_ms, peak, acc, extra="") -> dict:
    out = {"ms_per_step": ms, "device_ms_per_step": dev_ms,
           "labelled_per_s": labelled / ms * 1e3, "peak_gib": peak / 2**30,
           "accuracy": acc}
    log(f"[{tag}] summary: {ms:.4f} ms/step{extra}, a step's device time "
        f"{dev_ms:.4f} ms (profiled chunk), {labelled} labelled vertices a "
        f"step = {out['labelled_per_s']:.1f} labelled vertices/s, peak "
        f"device memory {out['peak_gib']:.3f} GiB, full-graph accuracy "
        f"after its steps {acc:.6f}")
    return out


def _profiled_ms(torch, run, steps: int, tag: str, watch=()) -> float:
    """A step's device time: the device busy time of ``run()`` (``steps``
    steps) under the profiler, over ``steps``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    seen = device_profile(prof, wall_us, f"{tag}: {steps} steps",
                          watch=watch)
    return seen["busy_us"] / steps / 1e3


def locality_path(torch, np, tag, pg, kind, eval_plan, **opts) -> tuple:
    """Partition or walk through the 4D step at the training shape:
    ``Trainer.run`` replays a captured step (48 steps), held against the
    plain versions (first step), against 8 and 48 eager steps (bit for
    bit), its card samples against the CPU's; returns (launches, summary).
    """
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.core.forward import dropout_masks
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainLoopConfig
    from repro_torch.tree import leaves, tree_map

    dev = eval_plan.device
    t0 = time.monotonic()
    base = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                              extract_impl="torch", dropout=0.3,
                              ell_tile=128, sample_kind=kind, **opts)
    cfg = paper_model("ogbn-products")
    plan = fourd.build_plan(pg, cfg, eval_plan.mesh, batch=TRAIN_BATCH,
                            opts=base)
    graph = plan.shard_graph(pg)
    slots = ell_slots_for(torch, plan, graph, tag)
    plan = fourd.build_plan(pg, cfg, eval_plan.mesh, batch=TRAIN_BATCH,
                            opts=dataclasses.replace(base, ell_slots=slots))
    s = plan.scfg
    log(f"[{tag}] plan in {time.monotonic() - t0:.2f} s: n_pad {s.n_pad}, "
        f"e_cap {s.e_cap}, clusters {s.clusters} (q "
        f"{s.clusters_per_step if s.clusters else 0}), walk_len "
        f"{s.walk_len}, walk_k {s.walk_k}, ell_slots {slots}")
    aux = graph.get("walk")
    aux_cpu = None if aux is None else {k: v.cpu() for k, v in aux.items()}
    b = plan.builder
    for step in (0, 47):
        t = torch.tensor(step, dtype=torch.int32, device=dev)
        same = torch.equal(b.sample_ids(t, None, 0, aux=aux).cpu(),
                           b.sample_ids(step, None, 0, device="cpu",
                                        aux=aux_cpu))
        log(f"[{tag}] sampled ids of (seed {b.seed}, step {step}): the "
            f"card's draws the CPU's {same}")
        if not same:
            raise AssertionError(f"{tag}: the card's sample differs")

    params0 = M.init_params(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    fresh = lambda: tree_map(lambda t: t.detach().clone(), params0)
    make_opt = lambda: AdamW(lr=linear_warmup_cosine(5e-3, 20, TRAIN_STEPS),
                             weight_decay=1e-4, grad_clip=1.0)
    # 1. the first step: kernels against plain versions on its batch
    lk, gk = fourd.value_and_grad(fourd.make_loss_fn(plan), fresh(), graph,
                                  0)
    mb = b.build(*graph["adj"][0], graph["features"], graph["labels"], 0,
                 aux=aux)
    masks = dropout_masks(plan.opts, 0, cfg.num_layers,
                          (TRAIN_BATCH, cfg.d_hidden), dev)
    mcfg = fourd.model_config(cfg, plan.opts)
    lp, gp = _grad_of(torch, lambda p: plain_loss(p, mb, mcfg, masks),
                      fresh())
    _first_step_check(torch, tag, lk.item(), gk, lp, gp)
    labelled = int((mb.labels >= 0).sum())

    def trainer(steps):
        return Trainer(plan, make_opt(), TrainLoopConfig(
            total_steps=steps, chunk_size=CHUNK), eval_fn=lambda p, g: 0.0)

    # 2. 8 captured steps and 8 eager ones from one state
    tr = trainer(CHUNK)
    st, log8 = tr.run(tr.init_state(fresh()), graph)
    tr_e = trainer(CHUNK)
    st_e = tr_e.init_state(fresh())
    eager8 = eager_run(torch, tr_e, st_e, graph, CHUNK)[0]
    same = eager8 == log8.losses and all(
        torch.equal(x, y) for x, y in zip(leaves(st.params),
                                          leaves(st_e.params)))
    log(f"[{tag}] 8 steps from one state, captured ({log8.replays} "
        f"replays) and eager: losses and params bit-identical {same}")
    if not same or log8.replays != CHUNK - 1:
        raise AssertionError(f"{tag}: captured and eager steps differ")
    del tr, tr_e, st, st_e

    # 3. the path: 48 captured steps, counts zeroed just before
    tr = trainer(TRAIN_STEPS)
    state = tr.init_state(fresh())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state, run_log = tr.run(state, graph)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = _per_step(hash_keys=1 + s.walk_len,
                         **dict.fromkeys(("spmm_ell", "spmm_ell_dx")
                                         + TAIL_PER_LAYER, cfg.num_layers))
    expect = _times(per_step, 2)
    log(f"[{tag}] {TRAIN_STEPS} steps, {run_log.replays} replays of the "
        f"captured step (capture {run_log.capture_s:.3f} s): "
        f"{run_log.ms_per_step:.4f} ms/step (without the capture "
        f"{ms_without_capture(run_log):.4f}), launches {launches}")
    if launches != expect or run_log.replays != TRAIN_STEPS - 1:
        raise AssertionError(f"{tag}: launches {launches}, expected "
                             f"{expect}")
    _loss_falls(tag, run_log.losses, np)
    acc = float(eval_plan_eval(torch, plan, state.params, graph))

    # 4. the same 48 steps eagerly: the captured run's bits, timed
    tr_e = trainer(TRAIN_STEPS)
    st_e = tr_e.init_state(fresh())
    losses_e, ms_e = eager_run(torch, tr_e, st_e, graph, TRAIN_STEPS)
    same = losses_e == run_log.losses and all(
        torch.equal(x, y) for x, y in zip(leaves(state.params),
                                          leaves(st_e.params)))
    log(f"[{tag}] {TRAIN_STEPS} eager Trainer.step calls: {ms_e:.4f} "
        f"ms/step; losses and params bit-identical to the captured run "
        f"{same}")
    if not same:
        raise AssertionError(f"{tag}: 48 eager steps differ from captured")
    del tr_e, st_e

    # 5. a step's device time: one profiled chunk of replays
    tr.total_steps = TRAIN_STEPS + CHUNK

    def chunk():
        if tr.run(state, graph)[1].replays != CHUNK:
            raise AssertionError(f"{tag}: the chunk was not replayed")
    dev_ms = _profiled_ms(torch, chunk, CHUNK, f"{tag}, captured replays",
                          watch=tuple(STEP_KERNELS))
    out = _summary(tag, labelled, ms_without_capture(run_log), dev_ms, peak,
                   acc, extra=f" captured (RunLog {run_log.ms_per_step:.4f}"
                   f" with the capture), {ms_e:.4f} eager")
    out["ms_per_step_eager"] = ms_e
    del tr, state, graph
    return launches, out


def eval_plan_eval(torch, plan, params, graph) -> float:
    """The full-graph accuracy of ``params`` on ``plan``'s graph."""
    from repro_torch.core import fourd
    acc = float(fourd.make_eval_step(plan)(params, graph))
    torch.cuda.synchronize()
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc}")
    return acc


def eager_path(torch, np, tag, step_fn, params, opt, steps, labelled,
               per_step, eval_fn) -> tuple:
    """``steps`` eager steps of ``step_fn(params, opt_state, step) ->
    loss``, counts zeroed just before and read just after (each must be
    ``per_step`` times ``steps``), timed; the loss must fall; then one
    profiled chunk for a step's device time and the full-graph
    accuracy. Returns (launches, summary)."""
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    losses = torch.stack([step_fn(params, opt_state, i)
                          for i in range(steps)]).cpu().tolist()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {steps} eager steps: {ms:.4f} ms/step, launches "
        f"{launches}")
    if launches != _times(per_step, steps):
        raise AssertionError(f"{tag}: launches {launches}, expected "
                             f"{_times(per_step, steps)}")
    _loss_falls(tag, losses, np)
    acc = eval_fn(params)
    n = min(CHUNK, steps)
    dev_ms = _profiled_ms(torch, lambda: [step_fn(params, opt_state, steps + i)
                                          for i in range(n)], n, tag)
    return launches, _summary(tag, labelled, ms, dev_ms, peak, acc)


def phase_train_samplers(torch, np, ds, train_plan, train_graph,
                         train_pg) -> tuple:
    """Phase 5e: the reference's other samplers on the card at the
    training shape (see the module docstring). Returns the launch counts
    of each path and each path's summary."""
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.core import baselines as TB
    from repro_torch.core import gcn_model as M
    from repro_torch.core import sampling as smp
    from repro_torch.core.forward import dropout_keys
    from repro_torch.core.minibatch import MinibatchBuilder
    from repro_torch.graphs import build_partitioned_graph
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.tree import leaves

    launches, summaries = {}, {}
    n = ds.num_vertices
    clusters = -(-(-(-n // CLUSTER_SIZE)) // CHUNK) * CHUNK
    t0 = time.monotonic()
    pg_p = build_partitioned_graph(ds, g=1, clusters=clusters)
    log(f"[train-partition] locality reordering and partition of {n} "
        f"vertices into {clusters} clusters of {pg_p.cluster_size}: "
        f"{time.monotonic() - t0:.2f} s (max_cluster_block_nnz "
        f"{pg_p.max_cluster_block_nnz})")
    if pg_p.cluster_size != CLUSTER_SIZE:
        raise AssertionError(f"clusters of {pg_p.cluster_size} vertices")
    launches["partition"], summaries["partition"] = locality_path(
        torch, np, "train-partition", pg_p, "partition", train_plan,
        clusters=clusters)
    del pg_p
    t0 = time.monotonic()
    launches["walk"], summaries["walk"] = locality_path(
        torch, np, "train-walk", train_pg, "walk", train_plan,
        walk_len=WALK_LEN, walk_k=WALK_K)
    log(f"[train-walk] the path in {time.monotonic() - t0:.2f} s (its walk "
        "tables built on the host included)")
    torch.cuda.empty_cache()

    # the baselines: one device, eager steps of the paper's model
    dev, opts = train_plan.device, train_plan.opts
    rp, ci, val = train_graph["adj"][0]
    feats, labels = train_graph["features"], train_graph["labels"]
    n_pad, L = train_pg.n_pad, train_plan.cfg.num_layers
    kcfg = dataclasses.replace(paper_model("ogbn-products"), dropout=0.3,
                               elementwise_impl="cuda")
    pcfg = dataclasses.replace(kcfg, elementwise_impl="torch")
    make_opt = lambda steps: AdamW(lr=linear_warmup_cosine(5e-3, 20, steps),
                                   weight_decay=1e-4, grad_clip=1.0)
    init = lambda: M.init_params(kcfg, torch.Generator().manual_seed(0),
                                 device=dev)
    evaluate = lambda p: eval_plan_eval(torch, train_plan, p, train_graph)

    def descend(opt, params, opt_state, loss_fn):
        for t in leaves(params):
            t.requires_grad_(True)
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves(params))
        from repro_torch.tree import unflatten
        opt.update(params, unflatten(params, list(grads)), opt_state)
        return loss.detach()

    # GraphSAINT node sampler: batch 8192, the extraction kernel
    deg = (rp[1:] - rp[:-1]).float()
    e_cap = TRAIN_BATCH * train_pg.max_block_row_nnz
    scfg = smp.SampleConfig(n_pad=n_pad, g=1, batch=TRAIN_BATCH, e_cap=e_cap)
    kb = MinibatchBuilder(scfg, mode="exact", impl="cuda",
                          max_row_nnz=train_pg.max_block_row_nnz)
    pb = MinibatchBuilder(scfg, mode="exact")

    def saint_loss(step, builder, cfg):
        key = smp.key_tensor(smp.step_key(opts.seed, step), dev)
        sb = TB.saint_node_sample(key, rp, ci, val, feats, labels, deg,
                                  n_pad, TRAIN_BATCH, e_cap, builder)
        keys = dropout_keys(opts, step, L, dev)
        return lambda p: M.cross_entropy_loss(
            M.forward(p, sb.adj, sb.feats, cfg, train=True,
                      dropout_keys=keys), sb.labels, sb.loss_weights), sb

    (fk, sb0), (fp, _) = saint_loss(0, kb, kcfg), saint_loss(0, pb, pcfg)
    _first_step_check(torch, "train-saint", *_grad_of(torch, fk, init()),
                      *_grad_of(torch, fp, init()))
    opt = make_opt(TRAIN_STEPS)
    launches["saint"], summaries["saint"] = eager_path(
        torch, np, "train-saint",
        lambda p, o, i: descend(opt, p, o, saint_loss(i, kb, kcfg)[0]),
        init(), opt, TRAIN_STEPS, int((sb0.labels >= 0).sum()),
        _per_step(extract_dense_fused=1, hash_keys=1,
                  **dict.fromkeys(TAIL_PER_LAYER, L)), evaluate)
    del sb0

    # GraphSAGE neighbor sampler: batch 1024, fan-outs (15, 10, 5)
    def sage_loss(step, cfg):
        key = smp.key_tensor(smp.step_key(opts.seed, step), dev)
        sgb = TB.sage_sample(key, rp, ci, feats, labels, n_pad, SAGE_BATCH,
                             SAGE_FANOUTS)
        keys = [smp.key_tensor(smp.fold_in(key, 100 + li))
                for li in range(L)]
        return lambda p: M.cross_entropy_loss(M.sage_forward(
            p, sgb, cfg, train=True, dropout_keys=keys), sgb.labels), sgb

    (fk, sgb0), (fp, _) = sage_loss(0, kcfg), sage_loss(0, pcfg)
    log(f"[train-sage] frontier sizes {[f.shape[0] for f in sgb0.frontiers]}"
        f" (fan-outs {SAGE_FANOUTS}, innermost first)")
    _first_step_check(torch, "train-sage", *_grad_of(torch, fk, init()),
                      *_grad_of(torch, fp, init()))
    opt = make_opt(TRAIN_STEPS)
    launches["sage"], summaries["sage"] = eager_path(
        torch, np, "train-sage",
        lambda p, o, i: descend(opt, p, o, sage_loss(i, kcfg)[0]),
        init(), opt, TRAIN_STEPS, int((sgb0.labels >= 0).sum()),
        _per_step(hash_keys=1 + len(SAGE_FANOUTS),
                  **dict.fromkeys(TAIL_PER_LAYER, L)), evaluate)
    del sgb0
    torch.cuda.empty_cache()

    # the full-batch GCN: every vertex in every step
    launches["fullbatch"], summaries["fullbatch"] = fullbatch_path(
        torch, np, ds, train_plan, train_graph, train_pg, make_opt, init)
    return launches, summaries


def fullbatch_path(torch, np, ds, train_plan, train_graph, train_pg,
                   make_opt, init) -> tuple:
    """The full-batch GCN for FULLBATCH_STEPS steps over the whole graph
    (the "csr" engine, the fused tail); on running out of the card's
    memory, the largest halving of the vertex count that fits."""
    from repro_torch.core import baselines as TB
    from repro_torch.core import fourd
    from repro_torch.graphs import build_partitioned_graph, get_dataset
    plan, graph, pg = train_plan, train_graph, train_pg
    L = plan.cfg.num_layers
    while True:
        kplan = fourd.build_plan(pg, plan.cfg, plan.mesh, batch=TRAIN_BATCH,
                                 opts=fourd.TrainOptions(
                                     fused_elementwise=True, dropout=0.3))
        pplan = dataclasses.replace(kplan, opts=dataclasses.replace(
            kplan.opts, fused_elementwise=False))
        oom = False
        try:
            torch.cuda.reset_peak_memory_stats()
            lk, gk = fourd.value_and_grad(TB.make_fullbatch_gcn_loss(kplan),
                                          init(), graph, 0)
            lp, gp = fourd.value_and_grad(TB.make_fullbatch_gcn_loss(pplan),
                                          init(), graph, 0)
            _first_step_check(torch, "train-fullbatch", lk.item(), gk,
                              lp.item(), gp)
            del gk, gp
            opt = make_opt(FULLBATCH_STEPS)
            step = TB.make_fullbatch_gcn_step(kplan, opt)
            res = eager_path(
                torch, np, "train-fullbatch",
                lambda p, o, i: step(p, o, graph, i)[2], init(), opt,
                FULLBATCH_STEPS, int((graph["labels"] >= 0).sum()),
                _per_step(**dict.fromkeys(TAIL_PER_LAYER, L)),
                lambda p: eval_plan_eval(torch, kplan, p, graph))
            log(f"[train-fullbatch] {pg.n} vertices"
                + ("" if pg.n == train_pg.n else
                   f" (cut from {train_pg.n}: the whole graph ran out of "
                   "the card's memory)"))
            return res
        except torch.cuda.OutOfMemoryError:
            oom = True                 # the traceback's tensors go first
        if oom:
            log(f"[train-fullbatch] {pg.n} vertices: out of memory, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            torch.cuda.empty_cache()
            if pg.n < 2 * TRAIN_BATCH:
                raise AssertionError("the full-batch GCN fits no graph")
            pg = build_partitioned_graph(get_dataset(
                "ogbn-products", scale_vertices=pg.n // 2), g=1)
            graph = kplan.shard_graph(pg)


LLM_PROMPTS = 32
LLM_CHECK_PROMPTS = 4
LLM_CHECK_STEPS = 8


def phase_llm(torch, np, cfg, dev) -> dict:
    """The main path of LLM serving: ``cfg`` (tinyllama-1.1b at full
    width) behind ``LLMEngine``, a stream of 32 prompts through the flash
    kernel; then the kernel path against the plain attention on 4 prompts,
    teacher forced. Returns the launch counts of the stream."""
    from repro_torch.models import transformer as TT
    from repro_torch.serve import LLMEngine, LLMServeOptions

    t0 = time.monotonic()
    model = TT.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.param_dtype}; {n_params} parameters "
        f"drawn in {time.monotonic() - t0:.2f} s")
    # the config's count leaves out the final norm's scale
    if n_params != cfg.num_params() + cfg.d_model:
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{cfg.num_params() + cfg.d_model}")
    opts = LLMServeOptions(slots=8, max_prompt_len=512, max_new_tokens=32,
                           device=str(dev))
    eng = LLMEngine(model, cfg, opts)
    rng = np.random.default_rng(11)
    lengths = rng.integers(32, 513, size=LLM_PROMPTS)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in lengths]
    eng.generate([prompts[0][:32]])                 # first-call warm-up
    eng.reset_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    rids = []
    for p in prompts:             # staggered: two decode steps per arrival
        rids.append(eng.submit(p))
        eng.pump()
        eng.pump()
    eng.drain()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = read_launches()
    done = eng.take_completed()
    st = eng.stats()
    n_tok = sum(len(done.get(r, ())) for r in rids)
    peak = torch.cuda.max_memory_allocated()
    log(f"[llm] {len(rids)} prompts ({int(lengths.min())}-"
        f"{int(lengths.max())} tokens, mean {float(lengths.mean()):.1f}) in "
        f"{dt:.4f} s: {n_tok} tokens, {n_tok / dt:.1f} tok/s; prefill p50 "
        f"{st['prefill_p50_ms']:.4f} ms, p95 {st['prefill_p95_ms']:.4f} ms; "
        f"decode p50 {st['decode_p50_ms']:.4f} ms, p95 "
        f"{st['decode_p95_ms']:.4f} ms; {st['prefills']} prefills, "
        f"{st['decode_steps']} decode steps, slot_occupancy "
        f"{st['slot_occupancy']:.4f}, mid_stream_refills "
        f"{st['mid_stream_refills']}; launches {launches}; peak device "
        f"memory {peak / 2**30:.3f} GiB")
    # every prefill layer through the tensor-core route, none through f32
    expect = _per_step(flash_attention=cfg.n_layers * st["prefills"])
    if launches != expect or st["prefills"] != LLM_PROMPTS:
        raise AssertionError(f"kernel launches {launches} on the LLM path "
                             f"({st['prefills']} prefills), expected "
                             f"{expect}")
    for rid in rids:
        out = done.get(rid)
        if out is None or out.shape != (opts.max_new_tokens,) \
                or not np.all((out >= 0) & (out < cfg.vocab)):
            raise AssertionError(f"prompt {rid}: bad completion {out}")
    if st["mid_stream_refills"] == 0:
        raise AssertionError("no slot was refilled mid-stream")

    # the kernel path against the plain attention: a prefill and 8 decode
    # steps on 4 prompts, both fed the kernel path's tokens
    n = LLM_CHECK_PROMPTS
    forced = []

    def run(impl):
        cache = TT.init_slot_cache(cfg, n, opts.max_prompt_len
                                   + LLM_CHECK_STEPS + 1, dev)
        steps, firsts = [], []
        for i, p in enumerate(prompts[:n]):
            padded = torch.zeros((1, opts.max_prompt_len), dtype=torch.int32,
                                 device=dev)
            padded[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
            tok, lg, cache = TT.prefill_into_slot(model, padded, len(p),
                                                  cache, i, cfg,
                                                  attn_impl=impl)
            firsts.append(tok)
            steps.append(lg[:, -1].float())
        steps = [torch.cat(steps)]
        cur = torch.cat(firsts)
        if impl == "cuda":
            forced.append(cur)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        for step in range(LLM_CHECK_STEPS):
            tok, lg, cache = TT.decode_step_slots(
                model, forced[step][:, None], cache, cfg, active,
                attn_impl=impl)
            steps.append(lg[:, -1].float())
            if impl == "cuda":
                forced.append(tok)
        torch.cuda.synchronize()
        return steps

    kernel_steps = run("cuda")
    plain_steps = run("torch")
    worst = 0.0
    for a, b in zip(kernel_steps, plain_steps):
        a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
        worst = max(worst, (a - b).abs().max().item()
                    / a.abs().max().item())
    agree = sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                for a, b in zip(kernel_steps, plain_steps))
    log(f"[llm] {n} prompts, prefill + {LLM_CHECK_STEPS} decode steps, "
        f"teacher forced: max |kernel - plain| logit "
        f"{worst:.3e} of the largest |logit| (limit {LLM_RTOL}); the greedy "
        f"tokens agree at {agree} of {len(kernel_steps)} steps")
    if not worst <= LLM_RTOL:
        raise AssertionError(f"kernel and plain LLM paths differ by {worst}")

    # where the time goes: one wave of 8 prompts under the profiler
    from torch.profiler import ProfilerActivity, profile
    eng.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.generate(prompts[:opts.slots])
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    st = eng.stats()
    device_profile(prof, wall_us, f"one wave of {opts.slots} prompts "
                   f"({st['prefills']} prefills, {st['decode_steps']} "
                   f"decode steps)", watch=("flash_attention_mma_kernel",))
    return launches, phase_llm_driver(torch, np, eng, prompts[:opts.slots])


def phase_llm_driver(torch, np, eng, prompts) -> dict:
    """Phase 6b: the threaded driver in front of the LLM engine: a wave of
    prompts submitted from 4 threads, each prompt's tokens equal to the
    engine's direct run of the same wave. Returns the launch counts of the
    driven wave."""
    import threading

    from repro_torch.serve import ServingDriver
    direct = eng.generate(prompts)
    eng.reset_stats()
    torch.cuda.synchronize()
    zero_launches()
    futs, errs, n_threads = {}, [], 4
    t0 = time.monotonic()
    with ServingDriver(eng) as drv:
        def worker(i):
            try:
                for k in range(i, len(prompts), n_threads):
                    futs[k] = drv.submit(prompts[k])
            except Exception as exc:
                errs.append(exc)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        outs = {k: f.result(timeout=600) for k, f in futs.items()}
        dt = time.monotonic() - t0
        st = drv.stats()
        flushes = drv.starvation_flushes
    torch.cuda.synchronize()
    launches = read_launches()
    same = not errs and len(outs) == len(prompts) and all(
        np.array_equal(outs[k], direct[k]) for k in range(len(prompts)))
    n_tok = sum(len(o) for o in outs.values())
    log(f"[llm-driver] {len(outs)} prompts from {n_threads} threads in "
        f"{dt:.4f} s: {n_tok} tokens, {n_tok / dt:.1f} tok/s, "
        f"{st['prefills']} prefills, {st['decode_steps']} decode steps, "
        f"starvation flushes {flushes}; every prompt's tokens those of the "
        f"direct run {same}; launches {launches}")
    if not same:
        raise AssertionError(f"tokens through the driver differ from the "
                             f"direct run (errors {errs})")
    expect = _per_step(flash_attention=eng.cfg.n_layers * st["prefills"])
    if launches != expect or st["prefills"] != len(prompts):
        raise AssertionError(f"kernel launches {launches} through the "
                             f"driver, expected {expect}")
    return launches


LLM_TRAIN_BF16_BATCH = 4
LLM_TRAIN_F32_BATCH = 2
LLM_TRAIN_SEQ = 2048
LLM_TRAIN_STEPS = 16


def phase_llm_train(torch, np, cfg, dev) -> dict:
    """Phase 7: LLM training at ``cfg``'s published width (tinyllama-1.1b).
    (a) one bf16 ``loss_and_grads`` on a 4 x 2048 ``TokenStream`` batch
    through the kernels and through the plain attention: the loss within
    1e-2 relative, every gradient leaf within 5e-2 of its largest |plain|,
    the flash forward's and backward's bf16 routes once a layer each;
    (b) the same widths in float32 (the dtypes the reference trains in):
    the first step of 2 x 2048 within 1e-5 (loss) and 1e-4 (each leaf) of
    the plain route on the same weights and batch, then
    ``train_transformer.train`` for 16 eager steps (the loss falls), the
    f32 routes of both kernels once a layer a step; ms/step, tokens/s,
    peak memory and MFU. Returns the launch counts of (a) and (b)."""
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train_transformer as TTR
    from repro_torch.models import transformer as TT

    def batch(b):
        stream = TokenStream(vocab_size=cfg.vocab, batch=b,
                             seq_len=LLM_TRAIN_SEQ, seed=0, coherence=0.8)
        return tuple(torch.from_numpy(a).to(dev) for a in stream.batch_at(0))

    def timed_grads(model, c, toks, tgts, impl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = TTR.loss_and_grads(model, toks, tgts, c,
                                         attn_impl=impl)
        loss = loss.item()
        return loss, grads, (time.perf_counter() - t0) * 1e3

    # (a) bf16, one gradient
    model = TT.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev, trainable=True)
    toks, tgts = batch(LLM_TRAIN_BF16_BATCH)
    TTR.loss_and_grads(model, toks[:, :128], tgts[:, :128], cfg)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    loss_k, grads_k, ms_k = timed_grads(model, cfg, toks, tgts, "cuda")
    bf16_launches = read_launches()
    loss_p, grads_p, ms_p = timed_grads(model, cfg, toks, tgts, "torch")
    log(f"[llm-train] (a) {cfg.name} bf16, one gradient of {toks.shape[0]} "
        f"x {toks.shape[1]} tokens: {ms_k:.1f} ms through the kernels, "
        f"{ms_p:.1f} ms through the plain attention; launches "
        f"{bf16_launches}")
    expect = _per_step(flash_attention=cfg.n_layers,
                       flash_attention_bwd=cfg.n_layers)
    if bf16_launches != expect:
        raise AssertionError(f"launches {bf16_launches} in a bf16 gradient, "
                             f"expected {expect}")
    _first_step_check(torch, "llm-train", loss_k, grads_k, loss_p, grads_p,
                      LLM_LOSS_BF16_RTOL, BF16_TOL)
    del model, grads_k, grads_p
    torch.cuda.empty_cache()

    # (b) f32: the first step against plain, then 16 steps of train()
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = TT.init_params(c32, torch.Generator(device=dev).manual_seed(0),
                           dev, trainable=True)
    toks, tgts = batch(LLM_TRAIN_F32_BATCH)
    loss_k, grads_k, _ = timed_grads(model, c32, toks, tgts, "cuda")
    loss_p, grads_p, _ = timed_grads(model, c32, toks, tgts, "torch")
    _first_step_check(torch, "llm-train", loss_k, grads_k, loss_p, grads_p)
    del grads_k, grads_p
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    zero_launches()
    run = TTR.train(c32, steps=LLM_TRAIN_STEPS, batch=LLM_TRAIN_F32_BATCH,
                    seq=LLM_TRAIN_SEQ, seed=0, device=dev, params=model,
                    log=lambda m: log(f"[llm-train] {m}"), log_every=4)
    launches = read_launches()
    expect = _per_step(
        flash_attention_f32=c32.n_layers * LLM_TRAIN_STEPS,
        flash_attention_bwd_f32=c32.n_layers * LLM_TRAIN_STEPS)
    if launches != expect:
        raise AssertionError(f"launches {launches} in {LLM_TRAIN_STEPS} "
                             f"f32 steps, expected {expect}")
    if abs(run.losses[0] - loss_k) > LOSS_RTOL * abs(loss_k):
        raise AssertionError(f"train()'s first loss {run.losses[0]} is not "
                             f"the checked step's {loss_k}")
    tokens = LLM_TRAIN_F32_BATCH * LLM_TRAIN_SEQ
    q = torch.empty((LLM_TRAIN_F32_BATCH, LLM_TRAIN_SEQ, c32.n_heads,
                     c32.hd), device="meta")
    kv = torch.empty((LLM_TRAIN_F32_BATCH, LLM_TRAIN_SEQ, c32.n_kv_heads,
                      c32.hd), device="meta")
    attn_ops = c32.n_layers * (fa.flash_attention_cost(q, kv, kv)[0]
                               + fa.flash_attention_bwd_cost(
                                   q, kv, kv, q, None, q)[0])
    step_ops = 6 * run.n_params * tokens + attn_ops
    mfu = step_ops / (run.ms_per_step / 1e3) / F32_OPS_PER_S
    log(f"[llm-train] (b) {c32.name} float32, {LLM_TRAIN_STEPS} steps of "
        f"{LLM_TRAIN_F32_BATCH} x {LLM_TRAIN_SEQ} tokens: "
        f"{run.ms_per_step:.3f} ms/step, {run.tokens_per_s:.1f} tokens/s, "
        f"peak device memory {run.peak_bytes / 2**30:.3f} GiB, "
        f"{run.n_params} parameters; 6 N tokens + attention = "
        f"{step_ops / 1e12:.4f} TFLOP a step (attention "
        f"{attn_ops / 1e12:.4f}), MFU {mfu:.4f} of 67 TFLOP/s f32; losses "
        f"{[round(x, 5) for x in run.losses]}; launches {launches}")
    _loss_falls("llm-train", run.losses, np)
    profile_llm_step(torch, model, c32, *batch(LLM_TRAIN_F32_BATCH))
    del model, run
    torch.cuda.empty_cache()
    return bf16_launches, launches


def profile_llm_step(torch, model, cfg, toks, tgts) -> None:
    """Where an f32 training step's time goes: one more step (gradient and
    AdamW update, with fresh moments) under the profiler, after the
    counted run: the device's busy share, its top kernels, the GEMMs and
    the flash kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train_transformer as TTR
    from repro_torch.models import transformer as TT
    from repro_torch.optim import AdamW, linear_warmup_cosine
    tree = TT.param_tree(model)
    opt = AdamW(lr=linear_warmup_cosine(3e-3, 10, LLM_TRAIN_STEPS),
                grad_clip=1.0)
    state = opt.init(tree)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = TTR.loss_and_grads(model, toks, tgts, cfg)
        opt.update(tree, grads, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    bwd = ("flash_bwd_dq_f32_kernel", "flash_bwd_dkdv_f32_kernel",
           "flash_bwd_reduce_kernel")
    seen = device_profile(prof, wall_us, f"one {cfg.name} float32 training "
                          f"step of {toks.shape[0]} x {toks.shape[1]} "
                          f"tokens", watch=("gemm", "flash_attention_kernel<")
                          + bwd)
    bwd_us = sum(seen["us"][k] for k in bwd)
    fwd_us = seen["us"]["flash_attention_kernel<"]
    log(f"[profile]   the flash forward: {fwd_us:.1f} us, "
        f"{100 * fwd_us / max(seen['busy_us'], 1e-9):.2f} % of the step's "
        f"device time; the flash backward: {bwd_us:.1f} us, "
        f"{100 * bwd_us / max(seen['busy_us'], 1e-9):.2f} %")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=2_449_029,
                    help="vertices of the ogbn-products stand-in "
                         "(default: the dataset's full count)")
    ap.add_argument("--requests", type=int, default=400)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.device import use_full_f32_matmul
    from repro_torch.graphs import get_dataset
    from repro_torch.serve import make_spec, make_support_pool, plan_batch

    use_full_f32_matmul()        # f32 GEMMs stay f32, as in the reference
    t_start = time.monotonic()
    device = phase_device(torch)
    phase_build()

    t0 = time.monotonic()
    ds = get_dataset("ogbn-products", scale_vertices=args.vertices)
    A = ds.adj_norm
    log(f"[kernels] graph {ds.name}: {A.n_rows} vertices, {A.nnz} nnz, "
        f"max_row_nnz {A.max_row_nnz()}, d_in {ds.feature_dim}, "
        f"{ds.num_classes} label classes, built in "
        f"{time.monotonic() - t0:.2f} s")
    cfg = dataclasses.replace(paper_model("ogbn-products"),
                              elementwise_impl="cuda")
    if cfg.d_in != ds.feature_dim:
        raise AssertionError(f"d_in {cfg.d_in} != {ds.feature_dim}")

    # real sampled rows: two micro-batch plans of the serving engine
    spec = make_spec(A, 64, 192)
    pool = make_support_pool(A.n_rows, 0)
    rng = np.random.default_rng(7)
    req = lambda: np.minimum(rng.zipf(1.3, size=spec.slots), A.n_rows) - 1
    plan, plan_b = plan_batch(req(), spec, pool), plan_batch(req(), spec,
                                                            pool)
    dev = torch.device("cuda")
    train_plan, train_graph, train_pg = train_setup(torch, ds, dev)
    flushers = l2_flushers(torch, dev)
    kernels = [check_extraction(torch, A, plan, plan_b, train_plan,
                                train_graph, dev, flushers),
               *check_fused_tail(torch, cfg.d_hidden, spec.total, dev,
                                 flushers)]
    kernels.extend(check_bf16_routes(torch, train_plan, train_graph, dev,
                                     flushers))
    del flushers
    kernels.append(check_spmm_ell(torch, train_plan, train_graph, dev))
    kernels.append(check_spmm_ell_dx(torch, train_plan, train_graph, dev))
    torch.cuda.empty_cache()
    kernels.extend(check_flash_attention(torch, np, dev))
    kernels.extend(check_flash_attention_bwd(torch, np, dev))
    by_path = {"serve": phase_serve(torch, np, ds, cfg, args.requests)}
    torch.cuda.empty_cache()
    by_path["serve_mesh"] = phase_serve_mesh(torch, np, ds, cfg,
                                             args.requests)
    by_path["serve_driver"] = phase_serve_driver(torch, np, ds, cfg,
                                                 args.requests)
    torch.cuda.empty_cache()
    train_paths, counter_kernels, f32_step = phase_train(
        torch, np, train_plan, train_graph, train_pg)
    by_path.update(train_paths)
    kernels.extend(counter_kernels)
    samplers, _ = phase_train_samplers(torch, np, ds, train_plan,
                                       train_graph, train_pg)
    by_path.update(samplers)
    torch.cuda.empty_cache()
    by_path["train_bf16"] = phase_train_bf16(torch, np, train_plan,
                                             train_graph, train_pg, f32_step)
    del train_plan, train_graph, train_pg
    torch.cuda.empty_cache()
    by_path["llm"], by_path["llm_driver"] = phase_llm(
        torch, np, get_config("tinyllama-1.1b"), dev)
    torch.cuda.empty_cache()
    by_path["llm_train_bf16"], by_path["llm_train"] = phase_llm_train(
        torch, np, get_config("tinyllama-1.1b"), dev)
    # each kernel's launches on the path that runs it, each route of the
    # tail and of flash from its own count (the training path's tails take
    # the vector route and draw from the counter; LLM serving runs flash in
    # bf16, LLM training both its routes, forward and backward, the f32
    # routes over its 16 steps: the tail's scalar routes and keep_mask read
    # 0)
    main_path = {"extract_dense_fused": "train",
                 "extract_dense_fused_bf16": "train_bf16",
                 "spmm_ell_bf16_f32": "train_bf16",
                 "spmm_ell_dx_bf16_f32": "train_bf16",
                 "fused_layer": "train",
                 "fused_layer_scalar": "train",
                 "fused_layer_counter": "train", "fused_layer_bwd": "train",
                 "fused_layer_bwd_scalar": "train", "spmm_ell": "train",
                 "spmm_ell_dx": "train", "hash_keys": "train",
                 "keep_mask": "train",
                 "flash_attention": "llm",
                 "flash_attention_f32": "llm_train",
                 "flash_attention_bwd": "llm_train_bf16",
                 "flash_attention_bwd_f32": "llm_train"}
    for k in kernels:
        k["launches_by_path"] = {p: counts[k["name"]]
                                 for p, counts in by_path.items()}
        k["launches"] = by_path[main_path[k["name"]]][k["name"]]
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
