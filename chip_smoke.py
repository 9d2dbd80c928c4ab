#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one NVIDIA H100.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a), prints the card's name and power limit, and runs the repo's
   card tests (``tests/test_torch_gpu.py``, special operands included)
   in four processes at once;
2. holds each kernel against its plain PyTorch version on the card at
   the shapes of the main paths, timing both with CUDA events, and raises
   on a breach of the stated tolerance (K5/K6: bit-equal, special
   operands included);
3. serves full-width h2o_danube_1_8b (24 layers, d_model 2560, random
   weights from a seed) with RAPID arithmetic through the lockstep
   ``ServeEngine``: 4 requests of 96-128 prompt tokens, 16 greedy tokens
   each, bf16 activations and KV cache, ``cache_n=512``, its decode step
   captured as a CUDA graph (the graph route, the main path); the launch
   counts are set to 0 just before and read just after, and K1-K4 must
   have launched.  The same requests then run on the eager route and
   both routes again, warm (graph, eager, eager, graph): the greedy
   tokens must be equal, the eager route's launch counts equal to the
   graph route's (each replay counts what its capture recorded), and
   ``trace_counts`` {"decode": 1, "prefill": 1}; the decode step's time
   and tokens/s are printed for both routes;
4. serves a 2-layer full-width copy once through the kernels (graph
   route) and once through the plain versions (eager) on the card: the
   greedy tokens must agree, and the launch counts show that the first
   run launched the path's kernels and the second none;
5. serves the same model through ``ContinuousServeEngine`` (paged KV,
   chunked prefill, slot recycling): 6 requests of 96-128 prompt tokens,
   16 greedy tokens each, 4 slots, so the queue backs up; on the graph
   route (both ticks captured) cold, then warm on the drained engine,
   then on the eager route cold and warm; K1, K2, K4 and K5 must
   launch, K3 must not, every run must give the same tokens and launch
   counts, ``trace_counts`` must read {"decode": 1, "prefill": 1} and
   the page free list must be whole after each drain.  The process's
   first continuous prefill tick (warm-up and capture) is timed layer by
   layer, and one tick of each kind on each route runs under
   torch.profiler (the device's busy share), where the port's kernels
   the profiler saw must number the launches the counters gained (on
   the graph route: what the capture recorded, added per replay);
6. runs the continuous engine on a 2-layer copy kernels vs plain (the
   greedy tokens must agree), and prefills one 8320-token prompt on a
   2-layer copy, which takes the blockwise attention path (K5) and wraps
   the 4096-slot sliding-window ring cache, then decodes 4 steps; at
   that shape ``_attn_blockwise`` with K5 must equal it with the plain
   K5; then, after the depth A/B of step 9, serves full-width
   starcoder2_7b (32 layers, d_model 4608, LN, the ungated gelu MLP; f32
   params from a seed) on the graph route through both engines (4
   requests of 96-128 prompt tokens, 8 greedy tokens; 4 slots, page 16,
   chunk 64), launches counted from 0 and peak memory read, and a
   1-layer copy kernels vs plain through both engines at that load
   (equal greedy tokens); then serves the MoE family at full width, its
   depth cut to 4 layers (qwen3_moe_235b_a22b: 4 of 94 layers, 128
   experts top-8; llama4_scout_17b_a16e: 4 of 48, 16 experts top-1 and
   the shared expert; f32 params from a seed, one model freed before
   the next loads) through both engines at the same load, on the graph
   route and then eagerly: equal greedy tokens and launch counts,
   ``trace_counts`` {"decode": 1, "prefill": 1}, K1 launched once a
   layer a step for each projection and expert contraction, the
   router's softmax divide once a layer a step; one step of each kind
   profiled on graphs (the kernels seen = the counters' gain; busy
   share, batched K1's share and the casts'); a 1-layer copy kernels vs
   plain (qwen3 through both engines, llama4 through the lockstep
   engine: equal greedy tokens) and one MoE layer kernels vs plain at 4
   x 128 and 4 x 1 tokens (the same bits); then full-width
   jamba_1_5_large_398b cut to one superblock (``jamba_phase``) and
   full-width, full-depth xlstm_350m (``xlstm_phase``: 24 layers, sLSTM
   at 5, 13, 21) through the lockstep engine on graphs and eagerly,
   each kernel launched exactly as often as the steps call it (xlstm:
   K1, the rms divides, K5 as K8 and K6; no K3, no K4), profiled
   steps, a 2-layer copy kernels vs plain (equal greedy tokens) and
   one layer of each mixer kernels vs plain (the same bits, state
   included); then full-width, full-depth whisper_medium
   (``whisper_phase``: 24 encoder + 24 decoder layers, 4 requests of
   1500 frame embeddings and 16 prompt tokens, 48 greedy tokens)
   through ``Model.prefill`` and ``Model.decode_step`` (no engine
   carries the frames), the decode step captured through
   ``CompiledStep`` and eagerly: equal tokens and launch counts, each
   kernel launched exactly as the steps call it (K1, the LN divides, K3
   in prefill, K4 twice a decoder layer a step), a profiled decode step
   and prefill, a 2 + 2 layer copy kernels vs plain (equal tokens); then
   full-width llava_next_34b cut to 4 of 60 layers (``llava_phase``:
   7168 wide, 56 / 8 heads of 128, d_ff 20480; 4 requests of 576 patch
   embeddings ahead of 32 prompt tokens, 32 greedy tokens, ``cache_n``
   1024) through the same function (``frontend_generate``: no engine
   carries the patches), graph, eager and warm graph: equal tokens and
   launch counts, each kernel launched as the steps call it (K1 7 a
   layer, the rms divides, K3 in prefill, K4 at G 7), the projector's
   exact f32 products held against f64 (TF32 off), a profiled decode
   step and prefill, a 1-layer copy kernels vs plain (equal tokens);
7. drives the paper's integer units (K9 ``rapid_mul``, K10
   ``rapid_div``) through their wrappers as Table III does, at 8 bits
   exhaustively and 2^24 random pairs at 16 (16/8) bits, all four
   schemes, and prints their error beside the paper's (information);
   K9 and K10 must launch, and return the reference's uint32; where
   the parent A/B of step 9 (run before this step) unpacked the parent
   commit, every row of the table must equal the parent's digit for
   digit;
8. runs the three applications (JPEG, Pan-Tompkins, Harris) under all
   five variants at the reference's QoR sizes, each device stage through
   the kernels and through the plain versions (equal bits required), and
   holds the QoR gates of ``tests/test_apps_qor.py``; then at the timing
   sizes (a 2048^2 frame, a 5-minute ECG record, a 1024^2 scene),
   kernels only, host and device times apart: K1 (batched) and K6 must
   launch.

9. times the serve paths at the default stage counts against depth 1
   and depth 2 everywhere, in turns on this card (the lockstep decode
   step and prefill, the continuous prefill tick), and
   ``launch/k1_times.py`` at depths 1, 2 and 3 (the depth A/B); then K1,
   K4, the dividers (K2/K3/K5 at depth 1, K8, K6) and K9/K10 before and
   after: ``k1_times.py``, ``k4_times.py``, ``k8_times.py`` and
   ``int_times.py`` on the parent commit's kernels and on this tree's in
   turns (parent, this, this, parent), where the parent's sources can be
   unpacked, and the parent's Table III (``int_times.py --table3``);
   the record names the parent's revision (information);
10. trains full-width h2o_danube_1_8b (RAPID, f32 params from a seed,
    bf16 compute, block remat) for 3 AdamW steps of 4 x 128 tokens
    through ``make_train_step`` / ``train_loop`` into a checkpoint
    under ``build/`` (checked, then deleted): the launch counts are set
    to 0 just before the loop and read just after, and K1 (as K7) and
    K2/K3 (as K8) must have launched at depth >= 2; losses and gradient
    norms must be finite.  One more step runs under torch.profiler;
11. runs one train step of a 2-layer full-width copy through the kernels
    and through the plain versions: loss within rel 1e-5 and every
    gradient within 1e-5 of its largest magnitude, the kernels launched
    in the first run and none in the second;
12. trains the recurrent families the same way (``train_recurrent_phase``:
    RAPID, f32 params from a seed, bf16 compute, block remat, 3 steps of
    4 x 128 tokens, the config's optimizer): full-width, full-depth
    xlstm_350m with AdamW into a checkpoint (checked, then deleted), and
    full-width jamba_1_5_large_398b cut to one 4-slot period (Mamba slots
    0, 1, 3, the attention slot 2, every FFN dense) with Adafactor and no
    checkpoint.  K1 (K7) and the rms divide (K8) must launch, K1, K5 / K6
    (xlstm) and K3 (jamba) exactly as often as the steps call them (the
    remat's recomputes included); losses and gradient norms finite; one
    step profiled on the device (busy share, K1's, the f32 products', the
    fma's f64 kernels), one mixer of each kind apart; and one train step
    kernels vs plain at 1 x 32 tokens (xlstm: a 2-layer copy of layers 4
    and 5, jamba: the phase's model) within 1e-5, as in step 11.

Step 2 holds K1 at every 2-D site of the served configs' blocks
(h2o_danube_1_8b's, starcoder2_7b's, the MoE configs' attention
projections and llama4's shared expert; M = 4, 64 and 512) bit-equal at
every stage count, starcoder2's w1 with the tanh gelu epilogue within 2
ulp, timed beside f32 ``torch.matmul``, starcoder2's
LN divides (K2/K8 over 4 / 64 / 512 rows of 4608) and a 64-token
chunk's combine (K5, 36 heads of 128) bit-equal; K1 batched at the MoE
experts' shapes (w1 with silu, w3, w2 of both configs at 1, 5 and 40
slots an expert: a decode step's, a 64-token chunk's and the lockstep
prefill's capacity) bit-equal at the default stage count beside
batched f32 ``torch.matmul``, the router's gate rows (4 / 64 / 512 rows
of 8, 4 / 512 of 1), the MoE configs' rms rows (4096 and 5120 wide)
and qwen3's 64-token combine (K5, 64 heads of 128), whisper_medium's
wq, w1 (gelu) and w2 (+ residual) at M 4, 512 and 6000, its encoder's
LN rows (6000 of 1024) and its softmax rows of 1500 frames,
llava_next_34b's wq, wk / wv, w1 (silu) and w2 (+ residual) at M 4, 512
and 2432, its rms rows of 7168 and its prefill's softmax rows of 608.  It holds K4 bit-equal to its plain version, both arms, at h2o's
lockstep step (512 slots, 136 live), the full 4096-slot window and the
continuous tick's paged views, and at the MoE configs' lockstep step
(256 slots, 136 live) and paged views (qwen3: 4 KV heads of 16
queries, llama4: 8 of 5, heads of 128), at whisper_medium's (16 KV
heads of one query, heads of 64: its 1500-frame cross cache at pos
2**30 and its 64-slot self cache), at llava_next_34b's (8 KV heads of 7
queries, heads of 128, 640 of 1024 slots live), and times beside each
the library's
``scaled_dot_product_attention`` on the exact arm as a yardstick (the
port never calls it).  It also holds K9/K10 bit-equal to their plain
versions (special operands included; 2^24 pairs also from offsets of
one and two elements) and K1 batched at JPEG's 2048^2
shape, with the broadcast DCT basis on each side; and it holds K1 (K7
at depth >= 2) and K2/K3/K5 (K8) at depths 1, 2, 3, 4 and 8 bit-equal
to their plain versions, including K not a multiple of the K block, K
shorter than depth K blocks, a single row (fewer slabs than depth) and
ragged slabs, and K1 at full width with K blocks that take its lean product
path and blocks that take the full one (a zero, a subnormal, an inf,
-0, products at the lean proof's edges) in one call, and with K blocks
on the proof's own bounds and one step outside them.  Beside the row
dividers it times library yardsticks the port never calls (torch's f32
``rms_norm`` at the rms rows, ``F.normalize(e, p=1)`` at the softmax
rows, ``a / b[:, None]`` at the row-broadcast rows, ``a / b`` beside K6,
f32 ``torch.matmul`` beside K1's rows without an epilogue and its
batched JPEG products, int32 ``a * b`` and ``a // b`` beside K9 / K10;
exact arithmetic, no RAPID) and the card's launch floor, one
graph-replayed one-element torch op (information).  K2 / K3 also run at
4 x 40 000, where the deferred depth falls back to 1 and the kernel
streams the rounds past those a thread holds.

It exits non-zero, printing no result, when no CUDA card is present or
when it is run outside a checkout of the repository.  Its last line is
``{"ok": true, "device": {...}}``; the line before holds the per-kernel
record (launches, error, times, bound; K7 and K8 as rows of their own,
counting the launches at depth >= 2).  The whole record also goes to
``chiprun_out/chip_smoke.json``, and the whole log, each line with its
seconds since the start, to ``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper), at 700 W
HBM_BYTES_PER_S = 3.35e12
# int32 lanes: 132 SMs x 64 INT32 lanes x 1.98 GHz (the float32 row of
# 67 TFLOP/s is 132 x 128 FP32 lanes x 2 flops x 1.98 GHz)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# fewest int32 ops a RAPID product can take: K1's lean loop issues two
# IADD3s, one forming the LUT address, one adding the sign-folded
# operands and the coefficient (a' + m' + c); the LUT gather (one
# shared-memory word a product, 32 words a clock an SM) gives the same
# rate; clamps, sign and the f32 accumulate are extra
INT32_OPS_PER_PRODUCT = 2
FP32_FLOPS_PER_S = 67e12

D, KV_HEADS, G, HD, D_FF = 2560, 8, 4, 80, 6912
# K1's rows: lockstep prefill (4 x 128 tokens), a continuous prefill
# tick (one 64-token chunk) and a decode step (4 tokens)
PREFILL_M, CHUNK_M, DECODE_M = 4 * 128, 64, 4
# starcoder2_7b's widths (its w1 takes the gelu epilogue) and the bound
# of K1's tanh gelu against the plain version on the card, in ulp
SC_D, SC_HEADS, SC_HD = 4608, 36, 128
GELU_ULP = 2
# jamba_1_5_large_398b's d_model (its rms rows)
JAMBA_D = 8192

# the MoE configs' widths (qwen3_moe_235b_a22b, llama4_scout_17b_a16e),
# qwen3's query heads, and the router's gate rows: (top-k, rows) over a
# decode step's 4 tokens, a prefill chunk's 64 and the lockstep
# prefill's 512
MOE_D, QWEN3_HEADS = (4096, 5120), 64
ROUTER_ROWS = ((8, DECODE_M), (8, CHUNK_M), (8, PREFILL_M), (1, DECODE_M),
               (1, PREFILL_M))

# fewest int32 ops of one integer RAPID unit (K9/K10): two leading-one
# detections, two fraction alignments, the cell index, the ternary add
# with the LUT coefficient, the carry/borrow select and the anti-log
# shift; the saturate and zero tests are extra
INT32_OPS_PER_UNIT = 12
# JPEG's DCT products at a 2048 x 2048 frame: 65 536 blocks of 8 x 8
JPEG_FRAME, JPEG_BLOCKS = 2048, (2048 // 8) ** 2
# the integer units at the paper's widths: 2^24 random pairs
INT_PAIRS = 1 << 24
# paper Table III (ARE %, PRE %), as benchmarks/table3_accuracy.py lists it
PAPER_MUL = {("mitchell", 8): (3.77, 11.11), ("mitchell", 16): (3.85, 11.11),
             ("rapid3", 8): (1.02, 6.1), ("rapid3", 16): (1.03, 6.1),
             ("rapid5", 8): (0.91, 4.45), ("rapid5", 16): (0.93, 4.45),
             ("rapid10", 8): (0.64, 3.69), ("rapid10", 16): (0.56, 3.69)}
PAPER_DIV = {("mitchell", 4): (3.90, 13.0), ("mitchell", 8): (4.11, 13.0),
             ("rapid3", 4): (0.99, 5.74), ("rapid3", 8): (1.02, 5.74),
             ("rapid5", 4): (0.79, 4.34), ("rapid5", 8): (0.79, 4.34),
             ("rapid9", 4): (0.58, 3.48), ("rapid9", 8): (0.58, 3.48)}

# the card tests run in this many processes at once (they share the
# card; most of their time is the host's)
CARD_TEST_SHARDS = 4
# stage counts held against the plain versions (K1 compiles 1-4 and 8;
# at depth >= 2 K1 is K7 and K2/K3/K5 are K8)
DEPTHS = (1, 2, 3, 4, 8)
# the train phase: full-width h2o_danube_1_8b, batch 4 x 128, 3 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 3
# the recurrent families' train phases (same batch and steps): xlstm_350m
# at full width and full depth; jamba_1_5_large_398b at full width cut to
# one 4-slot period (Mamba slots 0, 1, 3 and the attention slot 2, every
# FFN dense): 4.89e9 params, ~46 GiB with gradients, the bf16 copy and
# Adafactor (one 8-slot superblock alone, 33.5 GiB of f32, would need
# ~84 GiB)
TRAIN_CUTS = {"xlstm_350m": {},
              "jamba_1_5_large_398b": dict(n_layers=4, attn_every=4,
                                           n_experts=0)}
# their kernels-vs-plain train steps: 1 x 32 tokens, remat off
TRAIN_CHECK_B, TRAIN_CHECK_S = 1, 32
# the kernels whose names carry f64 arithmetic: the mixers' fma (its
# products, sums and nextafter; the casts to f64 are copy kernels)
FMA_NAMES = re.compile(r"double|nextafter", re.I)
# the cuBLAS / CUTLASS products (the straight-through backward's exact
# f32 matmuls, the mixers' exact gate and state contractions)
GEMM_NAMES = re.compile(r"gemm|xmma|cutlass", re.I)
# the port's row and elementwise dividers (K2/K3/K5, K8, K6)
ROW_DIV_NAMES = re.compile(r"(?<!\w)(row_slab_kernel|row_hold_kernel|"
                           r"elementwise_div_kernel)\b")

REPLACES = {
    "log_matmul": "src/repro/kernels/log_matmul/log_matmul.py:302",
    "log_matmul_pipelined": "src/repro/kernels/log_matmul/log_matmul.py:223",
    "rowwise_pipelined": "src/repro/kernels/fused_div/fused_div.py:129",
    "rms_div": "src/repro/kernels/fused_div/fused_div.py:202",
    "softmax_div": "src/repro/kernels/fused_div/fused_div.py:188",
    "flash_decode": "src/repro/kernels/flash_attn/flash_attn.py:113",
    "div_rowbcast": "src/repro/kernels/fused_div/fused_div.py:214",
    "div": "src/repro/kernels/fused_div/fused_div.py:239",
    "rapid_mul": "src/repro/kernels/rapid_mul/rapid_mul.py:49",
    "rapid_div": "src/repro/kernels/rapid_div/rapid_div.py:51",
}
SOURCES = {
    "log_matmul": "src/repro_torch/csrc/log_matmul.cu",
    "log_matmul_pipelined": "src/repro_torch/csrc/log_matmul.cu",
    "rowwise_pipelined": "src/repro_torch/csrc/fused_div.cu",
    "rms_div": "src/repro_torch/csrc/fused_div.cu",
    "softmax_div": "src/repro_torch/csrc/fused_div.cu",
    "flash_decode": "src/repro_torch/csrc/flash_attn.cu",
    "div_rowbcast": "src/repro_torch/csrc/fused_div.cu",
    "div": "src/repro_torch/csrc/fused_div.cu",
    "rapid_mul": "src/repro_torch/csrc/rapid_int.cu",
    "rapid_div": "src/repro_torch/csrc/rapid_int.cu",
}
# the kernels each serve path must launch (and, for the continuous
# path, the one it must not: K3 serves only lockstep prefill)
LOCKSTEP_KERNELS = ("log_matmul", "rms_div", "softmax_div", "flash_decode")
CONTINUOUS_KERNELS = ("log_matmul", "rms_div", "flash_decode", "div_rowbcast")
XLSTM_KERNELS = ("log_matmul", "rms_div", "div_rowbcast", "div")
# the CUDA kernels each wrapper family launches (one a counted launch),
# by the names the profiler gives them: a profiled tick's kernel events
# must number what its launch counters gained
PROFILED_KERNELS = {
    ("log_matmul",): ("log_matmul_kernel", "lean_kernel", "decode_kernel"),
    ("rms_div", "softmax_div", "div_rowbcast"): ("row_slab_kernel",
                                                 "row_hold_kernel"),
    ("div",): ("elementwise_div_kernel",),
    ("flash_decode",): ("flash_decode_kernel",),
    ("rapid_mul", "rapid_div"): ("int_unit_kernel",),
}
# K1's kernels, and their batched instances (template argument BATCHED)
K1_NAMES = re.compile(r"(?<!\w)(log_matmul_kernel|lean_kernel|decode_kernel)"
                      r"\b")
BATCHED_K1 = re.compile(r"(?<!\w)(log_matmul_kernel|lean_kernel|"
                        r"decode_kernel)<[^()]*\btrue>")
# K6 and K5 (K5 at depth 1 is an elementwise_div_kernel instance, as K8
# the row kernel's OP 2, the row broadcast, where the profiler names
# template arguments)
DIV_NAMES = re.compile(r"(?<!\w)(elementwise_div_kernel\b|"
                       r"row_slab_kernel<\s*2\s*,)")
# the MoE configs served at full width, their depth cut to MOE_LAYERS
MOE_ARCHS = ("qwen3_moe_235b_a22b", "llama4_scout_17b_a16e")
MOE_LAYERS = 4
# the depth of the full-width copies that the starcoder2 and MoE phases
# serve kernels vs plain at the main path's load (the plain K1 on a
# lockstep prefill's ~450 rows takes 16-25 s a layer at these widths)
COPY_LAYERS = 1
# the hybrid config served at full width: one superblock (attn_every = 8
# of its 72 layers), every FFN dense (n_experts = 0)
JAMBA = "jamba_1_5_large_398b"
# the ssm config, served at full width and full depth (24 layers, sLSTM
# at 5, 13 and 21); its rms rows and its normalisers' rows: a decode
# step's B x H = 16 mLSTM rows of 512 and a prefill chunk's 16 x 64, the
# sLSTM's [B, H, 256]
XLSTM = "xlstm_350m"
XLSTM_D, XLSTM_ROWS, XLSTM_HD = 1024, (16, 16 * 64), 512
XLSTM_SLSTM = (4, 4, 256)
# the encdec config, served at full width and full depth (24 encoder + 24
# decoder layers, 1024 wide, 16 heads of 64, 1500 frames): 4 requests of
# precomputed frame embeddings (x 0.1) and 16-token prompts, 48 greedy
# tokens into a 64-slot cache; the kernels its prefill and decode steps
# launch, and its rows: the encoder's M (4 x 1500), K3's score rows of
# 1500 (a 1024-query chunk of 4 x 16 heads; the cross-attention prefill's
# 4 x 16 x 16), K4's cross cache of 1500 frames and 64-slot self cache
WHISPER = "whisper_medium"
WHISPER_B, WHISPER_PROMPT, WHISPER_NEW, WHISPER_CACHE = 4, 16, 48, 64
WHISPER_KERNELS = ("log_matmul", "rms_div", "softmax_div", "flash_decode")
WHISPER_FRAMES, WHISPER_HEADS, WHISPER_HD = 1500, 16, 64
WHISPER_M = WHISPER_B * WHISPER_FRAMES
# the vlm config, served at full width with its depth cut to LLAVA_LAYERS
# of 60 (7168 wide, 56 / 8 heads of 128: K4 at G 7; d_ff 20480): 4
# requests of one image's 576 patch embeddings (x 0.1) ahead of a 32-token
# prompt, 32 greedy tokens into a 1024-slot cache (patches + prompt + new
# tokens); K1's prefill rows M = 4 x 608, K3's score rows of 608; the
# kernels-vs-plain copy: 1 layer, 1 request of 64 patches and 8 tokens,
# 3 greedy tokens (the plain K1 takes ~3 s a full-width layer a step)
LLAVA = "llava_next_34b"
LLAVA_LAYERS = 4
LLAVA_B, LLAVA_PROMPT, LLAVA_NEW, LLAVA_CACHE = 4, 32, 32, 1024
LLAVA_KERNELS = ("log_matmul", "rms_div", "softmax_div", "flash_decode")
LLAVA_PATCHES, LLAVA_D, LLAVA_HEADS, LLAVA_KV, LLAVA_HD = (576, 7168, 56, 8,
                                                           128)
LLAVA_S = LLAVA_PATCHES + LLAVA_PROMPT
LLAVA_M = LLAVA_B * LLAVA_S
LLAVA_COPY = dict(patches=64, prompt=8, new=3, cache_n=128)
# the f32 projector against its f64 product: TF32 (10 mantissa bits)
# would miss by ~5e-4 of the largest magnitude, f32 by ~1e-6
PROJ_F64_RTOL = 1e-4
# the wait between opening the profiler's window and the profiled tick,
# and between the tick's end and closing it
PROFILE_SETTLE_S = 0.05
# torch kernels launched as the window opens, before the profiled step
PROFILE_PAD_KERNELS = 64
# the blockwise prefill: over _PLAIN_ATTN_MAX_T (8192) tokens and over
# the 4096-token sliding window
LONG_PROMPT = 8320


# the run's whole log with each line's seconds since the start
# (chiprun_out/chip_smoke.log), opened by main: the end of the standard
# output is all a caller may get back
_LOG = None
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)
    if _LOG is not None:
        _LOG.write(f"[{time.perf_counter() - _T0:7.1f}s] {msg}\n")
        _LOG.flush()


# --------------------------------------------------------------------------
# timing and comparison
# --------------------------------------------------------------------------

class Timer:
    """Mean device time of a call by CUDA events, L2 flushed before each
    run (the main path meets every weight cold: no layer repeats); the
    card sleeps ~0.5 ms before the first event, so the call's host work
    is queued behind the sleep and not counted."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()  # warm
        total = 0.0
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def graph(self, fn, n: int) -> float:
        """Device time per call: ``n`` calls captured in one CUDA graph
        and replayed, so no host time between launches is counted (the
        wrappers' Python path costs ~20 us a call, more than the small
        kernels themselves).  Inputs stay L2-warm across the launches
        where they fit, as on the path, where the producer just wrote
        them."""
        from repro_torch.launch.kernel_timing import graph_ms

        return graph_ms(self.torch, fn, n)


def ulp_max(a, b) -> int:
    """Largest distance in float32 ulp between two tensors, on ``a``'s
    device (each float's bits mapped to a signed line of int64)."""
    import torch

    def line(t):
        i = t.detach().float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    if not a.numel():
        return 0
    return int((line(a) - line(b.to(a.device))).abs().max())


def abs_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def same_bits(a, b) -> bool:
    """float32 tensors (or arrays) bit-equal, NaN payloads aside: NaN in
    the same places, every other element the same bit pattern.  Two
    tensors are compared on ``a``'s device."""
    if hasattr(a, "detach") and hasattr(b, "detach"):
        import torch
        if a.shape != b.shape:
            return False
        ta = a.detach().contiguous()
        tb = b.detach().to(ta.device).contiguous()
        nan_a = torch.isnan(ta)
        return bool(torch.equal(nan_a, torch.isnan(tb)) and (
            (ta.view(torch.int32) == tb.view(torch.int32)) | nan_a).all())
    ga, gb = _host(a), _host(b)
    if ga.shape != gb.shape:
        return False
    nan_a = np.isnan(ga)
    return bool((nan_a == np.isnan(gb)).all()
                and ((ga.view(np.int32) == gb.view(np.int32)) | nan_a).all())


def u32_long(t):
    """A uint32 tensor's values as int64 (torch has few uint32 ops)."""
    import torch
    return t.view(torch.int32).long() & 0xFFFFFFFF


def same_uint32(a, b) -> bool:
    """uint32 tensors equal bit for bit (compared as int32 views)."""
    import torch
    return a.shape == b.shape and bool(torch.equal(
        a.view(torch.int32), b.view(torch.int32)))


def card_tests() -> None:
    """The repo's card tests (``tests/test_torch_gpu.py``: each kernel
    against its plain version at small ragged shapes and on special
    operands -- 0, -0, inf, NaN, subnormals, the overflow edge), in
    CARD_TEST_SHARDS child processes started together, each taking every
    CARD_TEST_SHARDS-th test (:func:`pytest_collection_modifyitems`) and
    its share of the cores for torch's and numpy's CPU threads (more
    threads than cores thrash); every test must pass and none may
    skip."""
    t0 = time.perf_counter()
    threads = str(max(1, len(os.sched_getaffinity(0)) // CARD_TEST_SHARDS))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "chip_smoke", "--durations=8", "-m", "gpu",
         "tests/test_torch_gpu.py"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
             "CHIP_SMOKE_SHARD": f"{i}/{CARD_TEST_SHARDS}",
             "OMP_NUM_THREADS": threads, "MKL_NUM_THREADS": threads},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(CARD_TEST_SHARDS)]
    try:
        outs = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    finally:  # on a timeout, no shard outlives the script
        for p in procs:
            p.kill()
    passed, failed = 0, []
    for i, (stdout, stderr, rc) in enumerate(outs):
        lines = stdout.strip().splitlines()
        tail = lines[-1] if lines else ""
        slow = [ln for ln in lines if re.match(r"\d+\.\d+s (call|setup)", ln)]
        log(f"card tests shard {i}/{CARD_TEST_SHARDS}: {tail}; slowest "
            f"{slow[:4]}")
        m = re.search(r"(\d+) passed", tail)
        passed += int(m.group(1)) if m else 0
        if rc != 0 or "skipped" in tail or not m:
            print(stdout[-6000:], stderr[-3000:], file=sys.stderr)
            failed.append(f"shard {i}: {tail}")
    log(f"card tests: {passed} passed in {CARD_TEST_SHARDS} shards of "
        f"{threads} CPU threads ({time.perf_counter() - t0:.1f}s)")
    if failed:
        raise AssertionError(f"card tests failed: {failed}")


def pytest_collection_modifyitems(config, items):
    """pytest hook, where ``-p chip_smoke`` loads this file as a plugin:
    with CHIP_SMOKE_SHARD="i/n" set, keep the tests at indices i, i + n,
    ... of the collected list and deselect the rest."""
    shard = os.environ.get("CHIP_SMOKE_SHARD")
    if not shard:
        return
    i, n = map(int, shard.split("/"))
    config.hook.pytest_deselected(
        items=[t for j, t in enumerate(items) if j % n != i])
    items[:] = items[i::n]


def _sass(build, lib: str, wanted: dict) -> dict:
    """{label: [(address, instruction)]} of each function of the built
    ``lib`` whose name matches a pattern of ``wanted`` {regex: label
    or callable(match) -> label}, read with ``cuobjdump -sass``."""
    import re

    so = next(build.BUILD_DIR.glob(f"{lib}-*.so"))
    dump = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = None
            for pattern, label in wanted.items():
                m = re.search(pattern, line)
                if m:
                    name = label(m) if callable(label) else label
                    out[name] = []
        elif name:
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);", line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def _backward_loops(body):
    """The instructions of each loop in ``body`` [(address, instruction)]
    closed by a backward branch, predicates stripped."""
    import re

    at = {a: i for i, (a, _) in enumerate(body)}
    for i, (addr, ins) in enumerate(body):
        m = re.search(r"BRA (0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            yield [re.sub(r"^@!?U?P\w+\s+", "", op)
                   for _, op in body[at.get(int(m.group(1), 16), i):i + 1]]


def lean_loop_sass(build) -> dict:
    """SASS instructions per product in K1's inner loops, read from the
    built library: for each 2-D depth-2 instance of ``lean_kernel``
    (chunk, prefill) and ``decode_kernel``, every loop (a backward
    branch) that reads shared memory and adds >= 4 products -- FADDs, or
    in the decode kernel's product phase STSs -- with its instructions
    per product.  The lean loop is the one with the fewest; the full
    product() loop and the decode kernel's sum loop are the others."""
    funcs = _sass(build, "log_matmul", {
        "lean_kernelILi4ELi4ELi1ELi64ELi2ELb0E": "chunk",
        "lean_kernelILi4ELi8ELi4ELi16ELi2ELb0E": "prefill",
        "decode_kernelILi4ELi128ELi2ELb0E": "decode (4 rows)"})
    out = {}
    for regime, body in funcs.items():
        out[regime] = []
        for seg in _backward_loops(body):
            ops = [op.split()[0] for op in seg]
            products = ops.count("FADD") or ops.count("STS")
            if products >= 4 and "LDS" in ops:  # not the LUT's upload
                out[regime].append((len(seg), products))
        log(f"sass {regime}: " + "; ".join(
            f"loop of {n} instructions, {p} products, {n / p:.2f} a product"
            for n, p in out[regime]))
    return out


def int_unit_sass(build) -> list:
    """SASS instructions per pair in the vector loop of each instance of
    ``int_unit_kernel`` (``csrc/rapid_int.cu``): the loop closed by a
    backward branch that stores 16 B result vectors (STG.E.128), its
    instructions over 4 pairs a store."""
    funcs = _sass(build, "rapid_int", {
        r"int_unit_kernelILb([01])E([jy])E": lambda m: (
            "rapid_mul" if m.group(1) == "1" else "rapid_div",
            "32-bit" if m.group(2) == "j" else "64-bit")})
    rows = []
    for (unit, index), body in funcs.items():
        for seg in _backward_loops(body):
            stores = sum(op.startswith("STG.E.128") for op in seg)
            if stores:
                rows.append({"unit": unit, "index": index,
                             "instructions": len(seg), "pairs": 4 * stores,
                             "per_pair": len(seg) / (4 * stores)})
                log(f"sass {unit} {index}: loop of {len(seg)} "
                    f"instructions, {4 * stores} pairs, "
                    f"{len(seg) / (4 * stores):.2f} a pair")
    return rows


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def k1_sites(cfg) -> list:
    """K1's 2-D call sites in one of ``cfg``'s blocks, as
    ``models/layers.py`` makes them: (site, K, N, activation, residual,
    the ln2 rms tail).  wq, wk / wv (one row for both), wo with the
    residual, and in an rms block wo with ln2's divide in its epilogue
    (prefill); then the dense MLP (w1 with the activation, w3 where it is
    gated, w2 with the residual) or, in an MoE block, the shared
    expert's, whose w2 takes no residual (the block adds it after the
    experts)."""
    D, F, q, kv = (cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd,
                   cfg.n_kv_heads * cfg.hd)
    if cfg.family == "ssm":
        # an mLSTM layer's (the 2x up-projected space of 2D) and an sLSTM
        # layer's; no epilogue at any site (the residual is added after
        # the mixer); sLSTM's w has up_proj's shape
        up = 2 * D
        return [("up_proj / sLSTM w", D, 2 * up, None, False, False),
                ("wq/wk/wv", up, up, None, False, False),
                ("mLSTM down_proj", up, D, None, False, False),
                ("sLSTM down_proj", q, D, None, False, False)]
    if cfg.family == "hybrid":
        # a superblock's: the attention slot's projections (wo with the
        # residual in decode), a Mamba slot's in_proj / out_proj, the
        # dense FFN (w2 with no residual: the slots add it after)
        d_inner = cfg.ssm_expand * D
        return [("wq", D, q, None, False, False),
                ("wk/wv", D, kv, None, False, False),
                ("wo", q, D, None, True, False),
                ("in_proj", D, 2 * d_inner, None, False, False),
                ("out_proj", d_inner, D, None, False, False),
                ("w1", D, F, cfg.act, False, False),
                ("w3", D, F, None, False, False),
                ("w2", F, D, None, False, False)]
    sites = [("wq", D, q, None, False, False),
             ("wk/wv", D, kv, None, False, False),
             ("wo", q, D, None, True, False)]
    if cfg.norm == "rms":
        sites.append(("wo+ln2", q, D, None, True, True))
    if cfg.n_experts == 0 or cfg.shared_expert:
        pre = "shared " if cfg.n_experts else ""
        sites.append((pre + "w1", D, F, cfg.act, False, False))
        if cfg.act == "silu":
            sites.append((pre + "w3", D, F, None, False, False))
        sites.append((pre + "w2", F, D, None, cfg.n_experts == 0, False))
    return sites


def library_k1(torch, timer, x, w, r, epilogue, exact_ms) -> dict:
    """K1's library yardstick at a site: one PyTorch call of the same
    function in f32 with TF32 off (exact, no RAPID; never called by the
    port): ``torch.matmul`` (timed as ``exact_ms``), or with the residual
    in the epilogue ``torch.addmm(r, x, w)``.  None where the epilogue
    holds an activation or a norm, which no one call computes."""
    if epilogue:
        return {}
    if r is None:
        return {"library_ms": exact_ms,
                "library": "torch.matmul, f32 with TF32 off (exact, no "
                           "epilogue, no RAPID; never called by the port)"}
    return {"library_ms": timer(lambda: torch.addmm(r, x, w), 5),
            "library": "torch.addmm(residual, x, w), f32 with TF32 off "
                       "(exact, no RAPID; never called by the port)"}


def kernel_phase(torch, dev, timer):
    from repro_torch.configs.base import get_config
    from repro_torch.core import backend as be
    from repro_torch.kernels.flash_attn.ops import (flash_decode_attn,
                                                    flash_decode_plain)
    from repro_torch.kernels.fused_div.ops import (div_elementwise, div_plain,
                                                   div_rowbcast,
                                                   div_rowbcast_plain,
                                                   fused_rms_div,
                                                   fused_softmax_div,
                                                   rms_div_plain,
                                                   softmax_div_plain)
    from repro_torch.kernels.log_matmul.ops import (log_matmul,
                                                    log_matmul_plain)
    from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,
                                          resolve_spec)

    def at(depth):
        return KernelSpec(pipeline=PipelineSpec(depth=depth))

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    cases = []

    def record(kernel, shape, err, ulps, limit_ok, ms, plain_ms, bytes_, ops,
               ops_rate, extra=None):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ops_rate * 1e3
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
               "max_ulp": ulps, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": bytes_, "ops": ops}
        row.update(extra or {})
        cases.append(row)
        call = (f" call_ms={row['call_ms']:.4f}" if "call_ms" in row else "")
        if "library_ms" in row:
            call += f" library_ms={row['library_ms']:.4f}"
        log(f"kernel {kernel:12s} {shape:44s} max_abs={err:.3e} "
            f"max_ulp={ulps} ms={ms:.4f}{call} plain_ms={plain_ms:.3f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
        if not limit_ok:
            raise AssertionError(f"{kernel} {shape}: kernel disagrees with its "
                                 f"plain version (max_abs {err}, {ulps} ulp)")

    # K1 / K7 at every 2-D site of the served configs' blocks
    # (:func:`k1_sites`: h2o_danube_1_8b, starcoder2_7b and the MoE
    # configs' attention projections and llama4's shared expert) at M =
    # 4 (decode), 64 (continuous prefill tick) and 512 (lockstep
    # prefill, a train step's 4 x 128 tokens), at every stage count:
    # bit-equal, the tanh gelu epilogue within GELU_ULP (the kernel takes
    # torch's CUDA gelu step for step, its fma written out).  The plain
    # version (thousands of launches) is timed once by the host clock
    # between syncs
    rms_tail = be.Epilogue(norm="rms", div_scheme="rapid9", eps=1e-6,
                           keep_prenorm=True)
    for arch, prefix in (("h2o_danube_1_8b", ""),
                         ("starcoder2_7b", "starcoder2 "),
                         *((a, a.split("_")[0] + " ") for a in MOE_ARCHS)):
        sites = k1_sites(get_config(arch))
        for m in (DECODE_M, CHUNK_M, PREFILL_M):
            for site, k, n, act, res, tail in sites:
                x = randn(m, k)
                w = randn(k, n, std=k ** -0.5)
                r = randn(m, n) if res else None
                kw = dict(residual=r, epilogue=rms_tail if tail
                          else be.Epilogue(activation=act))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = log_matmul_plain(x, w, "rapid10", **kw)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                exact_ms = timer(lambda: torch.matmul(x, w), 5)
                lib = library_k1(torch, timer, x, w, r, act or tail, exact_ms)
                limit = GELU_ULP if act == "gelu" else 0
                nbytes = 4 * (m * k + k * n + m * n * (1 + res + tail))
                for depth in DEPTHS:
                    got = log_matmul(x, w, "rapid10", spec=at(depth), **kw)
                    torch.cuda.synchronize()
                    pairs = list(zip(got, ref)) if tail else [(got, ref)]
                    ulps = max(ulp_max(a, b) for a, b in pairs)
                    record("log_matmul" if depth == 1
                           else "log_matmul_pipelined",
                           f"{prefix}{site} M={m} K={k} N={n}"
                           + (f" {act}" if act else "")
                           + (" +res" if res else "")
                           + (" +rms(keep_prenorm)" if tail else "")
                           + f" depth={depth}",
                           max(abs_max(a, b) for a, b in pairs), ulps,
                           ulps <= limit,
                           timer(lambda: log_matmul(x, w, "rapid10",
                                                    spec=at(depth), **kw), 5),
                           plain_ms, nbytes,
                           m * n * k * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                           {"exact_matmul_ms": exact_ms, "products": m * n * k,
                            "depth": depth, **lib,
                            **({"gelu_ulp_bound": GELU_ULP}
                               if act == "gelu" else {})})
                    del got
                del x, w, r, ref

    expert_cases(torch, dev, timer, g, record)
    for arch in (JAMBA, XLSTM):
        family_k1_cases(torch, dev, timer, g, record, arch)
    family_k1_cases(torch, dev, timer, g, record, WHISPER,
                    (DECODE_M, PREFILL_M, WHISPER_M), ("wq", "w1", "w2"))
    family_k1_cases(torch, dev, timer, g, record, LLAVA,
                    (DECODE_M, PREFILL_M, LLAVA_M),
                    ("wq", "wk/wv", "w1", "w2"))

    # K1 / K7 where the ring meets its edges: K not a multiple of BK with
    # N not a multiple of 4 (4 B copies), K % 4 != 0, and K shorter than
    # depth K blocks (nk < depth); bit-equal at every depth
    for m, k, n in ((CHUNK_M, 300, 130), (PREFILL_M, 129, 65),
                    (DECODE_M, 20, 640)):
        x, w = randn(m, k), randn(k, n, std=k ** -0.5)
        ref = log_matmul_plain(x, w, "rapid10", activation="silu")
        plain_ms = timer(lambda: log_matmul_plain(x, w, "rapid10",
                                                  activation="silu"), 1)
        for depth in DEPTHS:
            got = log_matmul(x, w, "rapid10", activation="silu",
                             spec=at(depth))
            torch.cuda.synchronize()
            ulps = ulp_max(got, ref)
            record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                   f"ragged M={m} K={k} N={n} silu depth={depth}",
                   abs_max(got, ref), ulps, ulps <= 2,
                   timer(lambda: log_matmul(x, w, "rapid10", activation="silu",
                                            spec=at(depth)), 5),
                   plain_ms, 4 * (m * k + k * n + m * n),
                   m * n * k * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                   {"depth": depth})

    # K1 / K7 with lean and full K blocks in one call, at the serve
    # paths' full width (wq's K = N = 2560): a zero, a subnormal, an inf
    # (x) and -0 (w) each in a K block of its own, and products just
    # inside and just outside the lean proof's MIN_NORMAL / INF_BITS
    # edges in another; the plain model of the proof must find both
    # verdicts among the K blocks of the tile at row 0, column 0;
    # bit-equal at every depth
    from repro_torch.kernels.log_matmul.ops import (edge_blocks,
                                                    lean_block_ok,
                                                    mixed_blocks)
    from repro_torch.kernels.spec import matmul_geometry
    for m in (DECODE_M, CHUNK_M, PREFILL_M):
        bm, bn, bk = matmul_geometry(m, D)
        xh, wh = mixed_blocks(np.random.default_rng(m), m, D, D, bk)
        x, w = torch.from_numpy(xh).to(dev), torch.from_numpy(wh).to(dev)
        verdicts = [lean_block_ok(x[:bm, k0:k0 + bk], w[k0:k0 + bk, :bn],
                                  "rapid10") for k0 in range(0, D, bk)]
        if all(verdicts) or not any(verdicts):
            raise AssertionError(f"mixed blocks M={m}: verdicts {verdicts}")
        ref = log_matmul_plain(x, w, "rapid10")
        plain_ms = timer(lambda: log_matmul_plain(x, w, "rapid10"), 1)
        for depth in DEPTHS:
            got = log_matmul(x, w, "rapid10", spec=at(depth))
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            ok = same_bits(got, ref)
            record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                   f"mixed lean/full M={m} K={D} N={D} "
                   f"({sum(verdicts)}/{len(verdicts)} lean blocks at tile 0) "
                   f"depth={depth}",
                   abs_max(got[fin], ref[fin]), ulp_max(got[fin], ref[fin]),
                   ok, timer(lambda: log_matmul(x, w, "rapid10",
                                                spec=at(depth)), 5),
                   plain_ms, 4 * (m * D + D * D + m * D),
                   m * D * D * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                   {"depth": depth, "lean_blocks_tile0": sum(verdicts),
                    "blocks_tile0": len(verdicts)})
            del got
        del x, w, ref

    # K1 / K7 with the lean proof at its own bounds, at wq's full width:
    # in every tile, K block 0's operands give min a + min m + lut_min ==
    # MIN_NORMAL and max a + max m + lut_max == INF_BITS - 1 (proved),
    # block 1 sits one step below the lower bound and block 2 one above
    # the upper (refused), with real products on each bound; the plain
    # model must give these verdicts at tile 0; bit-equal at every depth
    for m in (DECODE_M, CHUNK_M, PREFILL_M):
        bm, bn, bk = matmul_geometry(m, D)
        xh, wh = edge_blocks(np.random.default_rng(m + 1), m, D, D, bk)
        x, w = torch.from_numpy(xh).to(dev), torch.from_numpy(wh).to(dev)
        verdicts = [lean_block_ok(x[:bm, k0:k0 + bk], w[k0:k0 + bk, :bn],
                                  "rapid10") for k0 in range(0, 4 * bk, bk)]
        if verdicts != [True, False, False, True]:
            raise AssertionError(f"proof edges M={m}: verdicts {verdicts}")
        ref = log_matmul_plain(x, w, "rapid10")
        plain_ms = timer(lambda: log_matmul_plain(x, w, "rapid10"), 1)
        for depth in DEPTHS:
            got = log_matmul(x, w, "rapid10", spec=at(depth))
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                   f"proof edges M={m} K={D} N={D} depth={depth}",
                   abs_max(got[fin], ref[fin]), ulp_max(got[fin], ref[fin]),
                   same_bits(got, ref),
                   timer(lambda: log_matmul(x, w, "rapid10", spec=at(depth)),
                         5),
                   plain_ms, 4 * (m * D + D * D + m * D),
                   m * D * D * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                   {"depth": depth})
            del got
        del x, w, ref

    # the card's launch floor: one graph-replayed one-element torch op
    # (information: bound_ms stays max(bytes, ops) as defined)
    one = torch.zeros(1, device=dev)
    floor_ms = timer.graph(lambda: one.add_(1.0), 200)
    cases.append({"kernel": "launch_floor", "shape": "add_ on 1 f32 element",
                  "ms": floor_ms})
    log(f"launch floor: one graph-replayed one-element add_ "
        f"ms={floor_ms:.4f}")

    # K2: ln1/ln2/final norm of a decode step (4 rows), of a continuous
    # prefill tick (64 rows) and of the lockstep prefill / a train step
    # (512 rows), a single row (fewer slabs than depth) and 37 rows (a
    # ragged last slab), starcoder2_7b's LN divides (4 / 64 / 512 rows of
    # 4608) and the MoE configs' norms (of 4096 and 5120), at every stage
    # count (depth >= 2: K8);
    # tolerance: denominators and quotients bit-equal.  Library: torch's
    # f32 rms_norm, a yardstick with an exact divide and no RAPID one
    # and jamba's 8192-wide rows at depths 1, 2, 3 (8192 f32 rows fill a
    # block's shared memory past depth 4), xlstm_350m's 1024-wide ones,
    # whisper_medium's encoder LN divides (4 x 1500 rows of 1024) and
    # llava_next_34b's rms rows of 7168 (a decode step's 4, 512, its
    # prefill's 4 x 608)
    rms_norm = torch.nn.functional.rms_norm
    for rows, n in [(r, D) for r in (1, DECODE_M, CHUNK_M, 37, PREFILL_M)] + [
            (r, d) for d in (SC_D,) + MOE_D + (JAMBA_D, XLSTM_D)
            for r in (DECODE_M, CHUNK_M, PREFILL_M)] + [(WHISPER_M, XLSTM_D)] + [
            (r, LLAVA_D) for r in (DECODE_M, PREFILL_M, LLAVA_M)]:
        x = randn(rows, n, std=3.0)
        ref, rden = rms_div_plain(x, 1e-6, "rapid9", return_denom=True)
        plain_ms = timer(lambda: rms_div_plain(x, 1e-6, "rapid9"), 3)
        lib = {"library_ms": timer.graph(lambda: rms_norm(x, (n,), eps=1e-6),
                                         100),
               "library": "torch.nn.functional.rms_norm, f32 (exact "
                          "divide, no RAPID; never called by the port)"}
        for depth in (DEPTHS if n != JAMBA_D else (1, 2, 3)):
            got, den = fused_rms_div(x, 1e-6, "rapid9", return_denom=True,
                                     spec=at(depth))
            torch.cuda.synchronize()
            ulps = max(ulp_max(got, ref), ulp_max(den, rden))
            k2 = lambda: fused_rms_div(x, 1e-6, "rapid9",  # noqa: E731
                                       spec=at(depth))
            record("rms_div" if depth == 1 else "rowwise_pipelined",
                   f"rms rows={rows} n={n} depth={depth}", abs_max(got, ref),
                   ulps, ulps == 0, timer.graph(k2, 100), plain_ms,
                   4 * (2 * rows * n), rows * n * 2, FP32_FLOPS_PER_S / 2,
                   {"call_ms": timer(k2, 20), "depth": depth, **lib})

    # K3: prefill attention probabilities, B*H*S rows of T = 128, a
    # ragged 33 x 130 (n % 4 != 0: 4 B copies), the MoE router's gates
    # (top-8 rows of qwen3_moe_235b_a22b, top-1 of llama4_scout_17b_a16e,
    # over a decode step's 4 tokens, a prefill chunk's 64 and the lockstep
    # prefill's 512), whisper_medium's rows of 1500 frames (an encoder
    # layer's 1024-query chunk, 4 x 16 heads x 1024 rows, and the
    # cross-attention prefill's 4 x 16 x 16) and llava_next_34b's prefill
    # scores (4 x 56 heads x 608 rows of 608); every stage count.
    # Library: F.normalize(e, p=1, eps=floor), e / max(sum e, floor) for
    # e >= 0 with an exact divide
    from repro_torch.kernels.fused_div.ref import SOFTMAX_FLOOR
    normalize = torch.nn.functional.normalize
    s = randn(4 * 32 * 128, 128, std=2.0)

    def gates(rows, k):  # a router's top-k logits, exp(v - max)
        v = torch.sort(randn(rows, k), dim=-1, descending=True).values
        return torch.exp(v - v[:, :1])

    def scores(rows, n):  # exp(s - max) over rows of n scores
        t = randn(rows, n, std=2.0)
        return torch.exp(t - t.amax(dim=-1, keepdim=True))

    score_rows = ((WHISPER_B * WHISPER_HEADS * 1024, WHISPER_FRAMES),
                    (WHISPER_B * WHISPER_HEADS * WHISPER_PROMPT,
                     WHISPER_FRAMES), (LLAVA_B * LLAVA_HEADS * LLAVA_S,
                                       LLAVA_S))
    for e in (torch.exp(s - s.amax(dim=-1, keepdim=True)),
              torch.exp(randn(33, 130))) + tuple(
                  gates(rows, k) for k, rows in ROUTER_ROWS) + tuple(
                  scores(rows, n) for rows, n in score_rows):
        ref, rden = softmax_div_plain(e, "rapid9", return_denom=True)
        plain_ms = timer(lambda: softmax_div_plain(e, "rapid9"), 3)
        lib = {"library_ms": timer.graph(
                   lambda: normalize(e, p=1.0, dim=-1, eps=SOFTMAX_FLOOR),
                   100),
               "library": "torch.nn.functional.normalize(e, p=1, dim=-1, "
                          "eps=floor), f32 (exact divide, no RAPID; never "
                          "called by the port)"}
        for depth in DEPTHS:
            got, den = fused_softmax_div(e, "rapid9", return_denom=True,
                                         spec=at(depth))
            torch.cuda.synchronize()
            ulps = max(ulp_max(got, ref), ulp_max(den, rden))
            k3 = lambda: fused_softmax_div(e, "rapid9",  # noqa: E731
                                           spec=at(depth))
            record("softmax_div" if depth == 1 else "rowwise_pipelined",
                   f"softmax rows={e.shape[0]} n={e.shape[1]} depth={depth}",
                   abs_max(got, ref), ulps, ulps == 0, timer.graph(k3, 100),
                   plain_ms, 4 * 2 * e.numel(), e.numel(),
                   FP32_FLOPS_PER_S / 2,
                   {"call_ms": timer(k3, 20), "depth": depth, **lib})

    # K2 / K3 where two slabs do not fit one block, so the deferred depth
    # falls back to 1: 4 rows of 40 000, whose rounds past the 32 a thread
    # holds are streamed; depth 1 only, bit-equal, denominators included
    x = randn(4, 40_000, std=3.0)
    wide = (("rms", x,
             lambda t, **kw: fused_rms_div(t, 1e-6, "rapid9", **kw),
             lambda t, **kw: rms_div_plain(t, 1e-6, "rapid9", **kw)),
            ("softmax", x.abs(),
             lambda t, **kw: fused_softmax_div(t, "rapid9", **kw),
             lambda t, **kw: softmax_div_plain(t, "rapid9", **kw)))
    for op, t, fn, plain in wide:
        ref, rden = plain(t, return_denom=True)
        got, den = fn(t, return_denom=True, spec=at(1))
        torch.cuda.synchronize()
        ulps = max(ulp_max(got, ref), ulp_max(den, rden))
        k = lambda: fn(t, spec=at(1))  # noqa: E731
        lib = {}
        if op == "rms":
            lib = {"library_ms": timer.graph(
                       lambda: rms_norm(t, (t.shape[1],), eps=1e-6), 100),
                   "library": "torch.nn.functional.rms_norm, f32 (exact "
                              "divide, no RAPID; never called by the port)"}
        record(f"{op}_div", f"{op} rows=4 n=40000 depth=1 (streamed)",
               abs_max(got, ref), ulps, ulps == 0, timer.graph(k, 100),
               timer(lambda: plain(t), 3), 4 * 2 * t.numel(),
               t.numel() * (2 if op == "rms" else 1), FP32_FLOPS_PER_S / 2,
               {"call_ms": timer(k, 20), "depth": 1, **lib})
    del x, t, got, ref

    # K4 at the paths' shapes (and the full window), with the geometry of
    # kernels/spec.py; tolerance: bit-equal (the plain version takes the
    # kernel's steps in its order).  Positions are an int32 device vector,
    # so a timed call launches K4 alone.  Library: SDPA on the exact arm
    # (bf16, boolean mask, GQA): a yardstick with no RAPID divide, NaN on
    # a fully masked row, never called by the port
    def k4_row(label, qf, kc, vc, sp, posv, window):
        before = flash_decode_attn.launches
        got = flash_decode_attn(qf, kc, vc, sp, posv, window, "rapid9")
        per_call = flash_decode_attn.launches - before
        ref = flash_decode_plain(qf, kc, vc, sp, posv, window, "rapid9")
        exact = flash_decode_attn(qf, kc, vc, sp, posv, window, None)
        exact_ref = flash_decode_plain(qf, kc, vc, sp, posv, window, None)
        torch.cuda.synchronize()
        ok = same_bits(got, ref) and same_bits(exact, exact_ref)
        valid = sp <= posv[:, None]
        if window:  # 0: full attention
            valid &= sp > posv[:, None] - window
        live = int(valid.sum())  # slots this step's data needs
        b, kv, g, hd = qf.shape
        nbytes = (4 * qf.numel() * 2 + 2 * kc.element_size() * live * kv * hd
                  + 4 * sp.numel() + 4 * b)
        qs = qf.reshape(b, kv * g, 1, hd).to(kc.dtype)
        kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        mask = valid[:, None, None, :]
        sdpa_fn = torch.nn.functional.scaled_dot_product_attention
        sdpa = lambda: sdpa_fn(qs, kt, vt, attn_mask=mask,  # noqa: E731
                               scale=1.0, enable_gqa=True)
        k4 = lambda: flash_decode_attn(qf, kc, vc, sp, posv,  # noqa: E731
                                       window, "rapid9")
        ks = resolve_spec("flash_attn", (b * kv, kc.shape[1]))
        record("flash_decode", label, abs_max(got, ref), ulp_max(got, ref),
               ok, timer.graph(k4, 100),
               timer(lambda: flash_decode_plain(qf, kc, vc, sp, posv, window,
                                                "rapid9"), 3),
               nbytes, 2 * 2 * kv * g * live * hd, FP32_FLOPS_PER_S,
               {"call_ms": timer(k4, 20), "library_ms": timer.graph(sdpa, 100),
                "library": "scaled_dot_product_attention, exact arm (no "
                           "RAPID divide; NaN on a fully masked row)",
                "bk": ks.bk, "bn": ks.bn, "launches_a_call": per_call,
                "blocks": b * kv * -(-kc.shape[1] // ks.bn)})
        return got

    # one lockstep decode step: 128 prompt + 8 generated tokens in a
    # 512-slot bf16 cache, and the model's full 4096-slot window, all live
    B, window = 4, 4096
    qf = randn(B, KV_HEADS, G, HD, std=HD ** -0.5)
    for C, live in ((512, 136), (4096, 4096)):
        kc = randn(B, C, KV_HEADS, HD).to(torch.bfloat16)
        vc = randn(B, C, KV_HEADS, HD).to(torch.bfloat16)
        base = torch.arange(C, dtype=torch.int32, device=dev)
        sp = torch.where(base < live, base, 2**31 - 1).expand(B, C)
        sp = sp.contiguous()
        posv = torch.full((B,), live - 1, dtype=torch.int32, device=dev)
        k4_row(f"q=[4,8,4,80] cache=[4,{C},8,80] bf16 live={live}", qf, kc,
               vc, sp, posv, window)
    del kc, vc

    # K4 at the continuous decode tick: 4 slots, each gathering its
    # 256-slot view out of a 65-page bf16 pool of 16-slot pages through
    # the page table as block_decode_paged does, slot positions from
    # kv_len, a [4] position vector of distinct depths and one inactive
    # slot (kv_len 0: every slot INT32_MAX, output 0); for h2o (8 KV
    # heads of 4 queries of 80, its 4096-slot window) and for the MoE
    # configs (full attention, heads of 128: qwen3's 4 KV heads of 16
    # queries, K4's widest group, and llama4's 8 of 5), whose lockstep
    # step (cache_n 256, 136 live) is held first
    n_pages, ps, pps = 65, 16, 16
    table = torch.zeros((B, pps), dtype=torch.long, device=dev)
    table[:3] = (torch.randperm(n_pages - 1, generator=g, device=dev)
                 [:3 * pps] + 1).reshape(3, pps)
    kv_len = torch.tensor([131, 98, 201, 0], dtype=torch.int32, device=dev)
    C = pps * ps
    j = torch.arange(C, dtype=torch.int32, device=dev)
    sp = torch.where(j[None] < kv_len[:, None], j[None], 2**31 - 1)
    for prefix, kv, grp, hd, win in (
            ("", KV_HEADS, G, HD, window),
            *((a.split("_")[0] + " ", c.n_kv_heads,
               c.n_heads // c.n_kv_heads, c.hd, c.sliding_window)
              for a in MOE_ARCHS + (JAMBA,) for c in (get_config(a),))):
        qf = randn(B, kv, grp, hd, std=hd ** -0.5)
        geo = f"{kv},{hd}] bf16"
        if prefix:
            kc = randn(B, C, kv, hd).to(torch.bfloat16)
            vc = randn(B, C, kv, hd).to(torch.bfloat16)
            lsp = torch.where(j < 136, j, 2**31 - 1).expand(B, C)
            k4_row(f"{prefix}q=[4,{kv},{grp},{hd}] cache=[4,{C},{geo} "
                   "live=136", qf, kc, vc, lsp.contiguous(),
                   torch.full((B,), 135, dtype=torch.int32, device=dev), win)
            del kc, vc
        if prefix.startswith("jamba"):  # lockstep only: no paged cache
            continue
        pool_k = randn(n_pages, ps, kv, hd).to(torch.bfloat16)
        pool_v = randn(n_pages, ps, kv, hd).to(torch.bfloat16)
        kg = pool_k[table].reshape(B, C, kv, hd)
        vg = pool_v[table].reshape(B, C, kv, hd)
        got = k4_row(f"{prefix}q=[4,{kv},{grp},{hd}] paged view=[4,{C},"
                     f"{geo} kv_len={kv_len.tolist()}", qf, kg, vg, sp,
                     torch.clamp(kv_len - 1, min=0), win)
        if got[3].any():
            raise AssertionError(f"flash_decode {prefix}: the inactive slot "
                                 "attends")
        del pool_k, pool_v, kg, vg

    # K4 at whisper_medium's decode step: 16 kv heads of one query, heads
    # of 64, bf16; the cross cache of every frame (1500, no whole number
    # of chunks; slot positions arange(1500), pos 2**30, all live) and
    # the 64-slot self cache with 40 live
    qf = randn(B, WHISPER_HEADS, 1, WHISPER_HD, std=WHISPER_HD ** -0.5)
    for C, live, pos in ((WHISPER_FRAMES, WHISPER_FRAMES, 2**30),
                         (WHISPER_CACHE, 40, 39)):
        kc = randn(B, C, WHISPER_HEADS, WHISPER_HD).to(torch.bfloat16)
        vc = randn(B, C, WHISPER_HEADS, WHISPER_HD).to(torch.bfloat16)
        base = torch.arange(C, dtype=torch.int32, device=dev)
        wsp = torch.where(base < live, base, 2**31 - 1).expand(B, C)
        k4_row(f"whisper q=[4,{WHISPER_HEADS},1,{WHISPER_HD}] "
               f"{'cross' if C == WHISPER_FRAMES else 'self'} cache=[4,{C},"
               f"{WHISPER_HEADS},{WHISPER_HD}] bf16 live={live} pos={pos}",
               qf, kc, vc, wsp.contiguous(),
               torch.full((B,), pos, dtype=torch.int32, device=dev), 0)
        del kc, vc

    # K4 at llava_next_34b's decode step: 8 kv heads of 7 queries (G 7,
    # 224 threads a block), heads of 128, bf16; a 1024-slot cache with 640
    # live (576 patches + 32 prompt + 32 new tokens)
    lq = randn(B, LLAVA_KV, LLAVA_HEADS // LLAVA_KV, LLAVA_HD,
               std=LLAVA_HD ** -0.5)
    kc = randn(B, LLAVA_CACHE, LLAVA_KV, LLAVA_HD).to(torch.bfloat16)
    vc = randn(B, LLAVA_CACHE, LLAVA_KV, LLAVA_HD).to(torch.bfloat16)
    live = LLAVA_S + LLAVA_NEW
    base = torch.arange(LLAVA_CACHE, dtype=torch.int32, device=dev)
    lsp = torch.where(base < live, base, 2**31 - 1).expand(B, LLAVA_CACHE)
    k4_row(f"llava q=[4,{LLAVA_KV},{LLAVA_HEADS // LLAVA_KV},{LLAVA_HD}] "
           f"cache=[4,{LLAVA_CACHE},{LLAVA_KV},{LLAVA_HD}] bf16 live={live}",
           lq, kc, vc, lsp.contiguous(),
           torch.full((B,), live - 1, dtype=torch.int32, device=dev), 0)
    del kc, vc, lq

    # K5: the online-softmax combine acc / l of a 64-token prefill chunk
    # (64 x 32 heads rows of head_dim 80; starcoder2_7b's: 64 x 36 heads
    # of 128; qwen3_moe_235b_a22b's: 64 x 64 heads of 128) and of an
    # 8320-token blockwise prefill, at every stage
    # count (depth >= 2: K8), and at depth 1 also
    # with a starting 4 B past a 16 B boundary (the combine hands K5 a
    # view of the caller's tensor: a head of single elements, then the
    # 16 B stream); K6 where the apps launch it -- 2048 x 2048 (JPEG's
    # quantization of a 2048^2 frame, 65 536 blocks of 64), 1024 x 1024
    # (Harris), 59 498 samples (Pan-Tompkins) -- and at 2048 x 2048 with
    # both operands 4 B past a 16 B boundary.  Special operands (0, -0,
    # +-inf, NaN, subnormals, the overflow edge) head every operand;
    # tolerance: bit-equal, NaN payloads aside.  Bound: bytes (each
    # operand read once, the output written once), ops = 3 int32 ops per
    # divide.  Library: torch's f32 a / b[:, None] (K5, K8) and a / b
    # (K6), yardsticks with an exact divide
    specials = torch.tensor(
        [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40,
         -1e-42, 3.4e38, -3.4e38, 1e-38, 2.0**64, 2.0**-64], device=dev)
    edge = torch.tensor([0x7F7FFFFF, 0x7F7FFFFE, 0x00800000, 0x00800001],
                        dtype=torch.int32, device=dev).view(torch.float32)
    special = torch.cat([specials, edge])

    def with_specials(t):
        t.view(-1)[:special.numel()] = special
        return t

    def past16(t, off=1):  # t's values, starting 4 * off B past 16 B
        flat = torch.empty(t.numel() + off, device=dev)
        out = flat[off:].view(t.shape)
        out.copy_(t)
        return out

    for rows, hd in ((64 * 32, HD), (LONG_PROMPT * 32, HD),
                     (64 * SC_HEADS, SC_HD), (64 * QWEN3_HEADS, SC_HD),
                     *((r, XLSTM_HD) for r in XLSTM_ROWS)):
        a = with_specials(randn(rows, hd))
        b = with_specials(randn(rows).abs() * 40 + 1)
        ref = div_rowbcast_plain(a, b, "rapid9")
        fin = torch.isfinite(ref)
        plain_ms = timer(lambda: div_rowbcast_plain(a, b, "rapid9"), 3)
        reps = 200 if rows < 10**5 else 20
        lib = {"library_ms": timer.graph(lambda: a / b[:, None], reps),
               "library": "a / b[:, None], f32 (exact divide, no RAPID; "
                          "never called by the port)"}
        for depth, x in [(d, a) for d in DEPTHS] + [(1, past16(a))]:
            got = div_rowbcast(x, b, "rapid9", spec=at(depth))
            torch.cuda.synchronize()
            ok = same_bits(got, ref)
            k5 = lambda: div_rowbcast(x, b, "rapid9",  # noqa: E731
                                      spec=at(depth))
            record("div_rowbcast" if depth == 1 else "rowwise_pipelined",
                   f"a=[{rows},{hd}] b=[{rows}] depth={depth}"
                   + ("" if x is a else " a +4B"),
                   abs_max(got[fin], ref[fin]), 0 if ok else -1, ok,
                   timer.graph(k5, reps), plain_ms,
                   4 * (2 * rows * hd + rows), 3 * rows * hd, INT32_OPS_PER_S,
                   {"call_ms": timer(k5, 20), "depth": depth, **lib})
            del got
        del a, b, ref
    for shape, off in (((2048, 2048), 0), ((1024, 1024), 0), ((59498,), 0),
                       ((2048, 2048), 1)):
        a = past16(with_specials(randn(*shape)), off)
        b = past16(with_specials(randn(*shape)), off)
        got = div_elementwise(a, b, "rapid9")
        ref = div_plain(a, b, "rapid9")
        torch.cuda.synchronize()
        ok = same_bits(got, ref)
        fin = torch.isfinite(ref)
        k6 = lambda: div_elementwise(a, b, "rapid9")  # noqa: E731
        reps = 50 if a.numel() > 10**6 else 200
        record("div", "a=b=[" + ",".join(map(str, shape)) + "]"
               + (" +4B" if off else ""), abs_max(got[fin], ref[fin]),
               0 if ok else -1, ok, timer.graph(k6, reps),
               timer(lambda: div_plain(a, b, "rapid9"), 3),
               4 * 3 * a.numel(), 3 * a.numel(), INT32_OPS_PER_S,
               {"call_ms": timer(k6, 20),
                "library_ms": timer.graph(lambda: a / b, reps),
                "library": "a / b, f32 (exact divide, no RAPID; never "
                           "called by the port)"})
        del a, b, got, ref
    slstm_div_case(torch, dev, timer, record, with_specials)
    integer_and_batched_cases(torch, dev, timer, g, record, at)
    return cases


def slstm_div_case(torch, dev, timer, record, with_specials):
    """K6 at the sLSTM normaliser, ``c / max(n, 1e-6)`` over [4, 4, 256]
    (once a layer and step), eagerly and replayed from a captured CUDA
    graph, as the decode step runs it: the same bits as the plain
    version, special operands included."""
    from repro_torch.kernels.fused_div.ops import div_elementwise, div_plain

    g = torch.Generator(device=dev).manual_seed(25)
    a = with_specials(torch.randn(XLSTM_SLSTM, generator=g, device=dev))
    b = torch.clamp_min(torch.rand(XLSTM_SLSTM, generator=g, device=dev)
                        * 3, 1e-6)
    ref = div_plain(a, b, "rapid9")
    eager = div_elementwise(a, b, "rapid9")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = div_elementwise(a, b, "rapid9")
    static.zero_()
    graph.replay()
    torch.cuda.synchronize()
    ok = same_bits(eager, ref) and same_bits(static, ref)
    fin = torch.isfinite(ref)
    k6 = lambda: div_elementwise(a, b, "rapid9")  # noqa: E731
    n = a.numel()
    record("div", "a=b=[" + ",".join(map(str, XLSTM_SLSTM))
           + "] (sLSTM; eager and graph replay)",
           abs_max(eager[fin], ref[fin]), 0 if ok else -1, ok,
           timer.graph(k6, 200), timer(lambda: div_plain(a, b, "rapid9"), 3),
           4 * 3 * n, 3 * n, INT32_OPS_PER_S,
           {"call_ms": timer(k6, 20), "graph_equal": ok,
            "library_ms": timer.graph(lambda: a / b, 200),
            "library": "a / b, f32 (exact divide, no RAPID; never called by "
                       "the port)"})


def expert_cases(torch, dev, timer, g, record):
    """K1 batched at the MoE experts' shapes, as ``_expert_compute``
    calls it (operands rounded to bf16, the compute dtype, then f32):
    w1 with silu in the epilogue, w3 and w2, over each config's experts
    at the capacity of a decode step (4 tokens), a 64-token prefill
    chunk and the lockstep prefill (4 x 128 tokens), at the default
    stage count, with the slots the path leaves empty under even
    routing (``launch/kernel_timing.py`` ``empty_slots``) as rows of
    zeros; bit-equal to the plain version (timed once by the host clock:
    thousands of launches), timed beside batched f32 ``torch.matmul``
    (the port never calls it).  The bytes bound counts the operands at
    the path's dtypes (the bf16 buffer and expert stack read once, the
    f32 output written once: the kernel's f32 operands are the port's
    own widening), the ops bound the filled rows' products (an empty
    slot's are 0)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.kernel_timing import empty_slots
    from repro_torch.kernels.log_matmul.ops import (log_matmul,
                                                    log_matmul_plain)
    from repro_torch.kernels.spec import resolve_spec
    from repro_torch.models.moe import capacity

    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        for tokens in (DECODE_M, CHUNK_M, PREFILL_M):
            m = capacity(tokens, cfg)
            for site, k, n, act in (("w1", d, f, "silu"), ("w3", d, f, None),
                                    ("w2", f, d, None)):
                x = torch.randn((E, m, k), generator=g, device=dev).to(
                    torch.bfloat16).float()
                mask = empty_slots(torch, E, m,
                                   tokens * cfg.experts_per_token, dev)
                x[mask] = 0.0
                empty = int(mask.sum())
                w = (torch.randn((E, k, n), generator=g, device=dev)
                     * k ** -0.5).to(torch.bfloat16).float()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = log_matmul_plain(x, w, "rapid10", activation=act)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                depth = resolve_spec("log_matmul", (m, n, k)).depth
                got = log_matmul(x, w, "rapid10", activation=act)
                torch.cuda.synchronize()
                ulps = ulp_max(got, ref)
                exact_ms = timer(lambda: torch.matmul(x, w), 3)
                lib = {} if act else {
                    "library_ms": exact_ms,
                    "library": "torch.matmul, batched f32 with TF32 off "
                               "(exact, no RAPID; never called by the port)"}
                filled = (E * m - empty) * n * k
                record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                       f"{arch} {site} E={E} M={m} ({tokens} tokens, "
                       f"{empty} empty) K={k} N={n}"
                       + (f" {act}" if act else "") + f" depth={depth}",
                       abs_max(got, ref), ulps,
                       ulps == 0 and same_bits(got, ref),
                       timer(lambda: log_matmul(x, w, "rapid10",
                                                activation=act), 3),
                       plain_ms, E * (2 * (m * k + k * n) + 4 * m * n),
                       filled * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                       {"exact_matmul_ms": exact_ms, "products": filled,
                        "empty_slots": empty, "depth": depth,
                        "experts": E, "tokens": tokens, **lib})
                del x, w, ref, got


def family_k1_cases(torch, dev, timer, g, record, arch,
                    ms=(DECODE_M, CHUNK_M, PREFILL_M), names=None):
    """K1 at the 2-D sites of ``arch`` (:func:`k1_sites`, those in
    ``names`` where given; jamba_1_5_large_398b: in_proj 8192 -> 32768,
    out_proj 16384 -> 8192, the dense FFN's w1 / w3 8192 -> 24576 and w2
    24576 -> 8192 with no residual, the attention slot's projections;
    xlstm_350m: up_proj / sLSTM's w 1024 -> 4096, wq / wk / wv 2048 ->
    2048, the down_projs 2048 -> 1024 and 1024 -> 1024; whisper_medium:
    wq 1024 -> 1024, w1 1024 -> 4096 with the tanh gelu, w2 4096 -> 1024
    with the residual; llava_next_34b: wq 7168 -> 7168, wk / wv 7168 ->
    1024, w1 7168 -> 20480 with silu, w2 20480 -> 7168 with the residual)
    at the rows ``ms`` (M = 4, 64 and 512; whisper: 4, 512 and the
    encoder's 4 x 1500; llava: 4, 512 and the prefill's 4 x 608), at the
    default stage count, bit-equal to the plain version
    (the gelu epilogue within GELU_ULP), timed beside its bound and f32
    ``torch.matmul``.  Past M = 4 the plain version (one k at a time: its
    cost follows K x N) checks the first 2048 / 1024 columns (256 past M
    512): K1 sums in K order per element, so an element's bits do not
    depend on N; its time is scaled to the whole output."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.log_matmul.ops import (log_matmul,
                                                    log_matmul_plain)
    from repro_torch.kernels.spec import resolve_spec

    for m in ms:
        for site, k, n, act, res, _ in k1_sites(get_config(arch)):
            if names is not None and site not in names:
                continue
            x = torch.randn((m, k), generator=g, device=dev)
            w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
            r = (torch.randn((m, n), generator=g, device=dev) if res
                 else None)
            cols = n if m == DECODE_M else min(n, {CHUNK_M: 2048,
                                                   PREFILL_M: 1024}.get(m,
                                                                        256))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = log_matmul_plain(
                x, w[:, :cols].contiguous(), "rapid10", activation=act,
                residual=None if r is None else r[:, :cols].contiguous())
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3 * n / cols
            depth = resolve_spec("log_matmul", (m, n, k)).depth
            got = log_matmul(x, w, "rapid10", activation=act, residual=r)
            torch.cuda.synchronize()
            got = got[:, :cols]
            ulps = ulp_max(got, ref)
            limit = GELU_ULP if act == "gelu" else 0
            exact_ms = timer(lambda: torch.matmul(x, w), 5)
            lib = library_k1(torch, timer, x, w, r, act, exact_ms)
            record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                   f"{arch.split('_')[0]} {site} M={m} K={k} N={n}"
                   + (f" {act}" if act else "") + (" +res" if res else "")
                   + f" depth={depth}"
                   + ("" if cols == n else f" (plain: {cols} columns)"),
                   abs_max(got, ref), ulps,
                   ulps <= limit and (limit or same_bits(got, ref)),
                   timer(lambda: log_matmul(x, w, "rapid10", activation=act,
                                            residual=r), 5),
                   plain_ms, 4 * (m * k + k * n + m * n * (1 + res)),
                   m * n * k * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                   {"exact_matmul_ms": exact_ms, "products": m * n * k,
                    "depth": depth, "plain_columns": cols, **lib,
                    **({"gelu_ulp_bound": GELU_ULP} if act == "gelu"
                       else {})})
            del x, w, r, ref, got


def integer_and_batched_cases(torch, dev, timer, g, record, at):
    """K9 / K10 against their plain versions, bit for bit: every pair of
    8-bit operands, then 2^24 random pairs (K9 at 16 bits; K10 with a 16-
    and b 8-bit), each headed by the special operands (0 on either side
    and both, 1, the largest values, a < b, the divider's b = 0), and
    the same 2^24 pairs from an offset of one element (``a[1:]``, a head
    of three single elements before the 16 B body) and of different
    offsets (every element single).  Then K1 batched at JPEG's 2048^2
    frame, [65536, 8, 8] @ [65536, 8, 8], with the DCT basis broadcast
    (stride 0) on each side in turn.  Bound: bytes (two int32 operands
    in, one uint32 result out per pair, 12 B, as the reference)."""
    from repro_torch.kernels.log_matmul.ops import (log_matmul,
                                                    log_matmul_plain)
    from repro_torch.kernels.rapid_div.ops import rapid_div, rapid_div_plain
    from repro_torch.kernels.rapid_mul.ops import rapid_mul, rapid_mul_plain

    def pairs(a_bits, b_bits, n):
        if n is None:  # every pair of 8-bit operands
            v = torch.arange(256, dtype=torch.int32, device=dev)
            return v.repeat_interleave(256), v.repeat(256)
        a = torch.randint(0, 1 << a_bits, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        b = torch.randint(0, 1 << b_bits, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        amax, bmax = (1 << a_bits) - 1, (1 << b_bits) - 1
        sa = [0, 5, 0, 1, 1, amax, amax, 1, 3, bmax, amax, 2]
        sb = [7, 0, 0, 1, bmax, 1, bmax, 0, bmax, 1, 0, 3]
        a[:len(sa)] = torch.tensor(sa, dtype=torch.int32, device=dev)
        b[:len(sb)] = torch.tensor(sb, dtype=torch.int32, device=dev)
        return a, b

    for name, fn, plain, scheme, n_bits, a_bits in (
            ("rapid_mul", rapid_mul, rapid_mul_plain, "rapid10", 8, 8),
            ("rapid_mul", rapid_mul, rapid_mul_plain, "rapid10", 16, 16),
            ("rapid_div", rapid_div, rapid_div_plain, "rapid9", 8, None),
            ("rapid_div", rapid_div, rapid_div_plain, "rapid9", 8, 16)):
        n = None if a_bits in (8, None) else INT_PAIRS
        a0, b0 = pairs(a_bits or 8, n_bits, n)
        starts = [("", 0, 0)] + ([] if n is None else [
            (" from a[1:], b[1:]", 1, 1), (" from a[1:], b[2:]", 1, 2)])
        for where, i, j in starts:
            cut = a0.numel() - (2 if i else 0)
            a, b = a0[i:i + cut], b0[j:j + cut]
            got = fn(a, b, scheme, n_bits)
            ref = plain(a, b, scheme, n_bits)
            torch.cuda.synchronize()
            ok = got.dtype == torch.uint32 and same_uint32(got, ref)
            err = float((u32_long(got) - u32_long(ref)).abs().max())
            k = lambda: fn(a, b, scheme, n_bits)  # noqa: E731
            m = a.numel()
            lib = {}
            if n is not None and not i:  # int32 a * b / a // b, b = 0 -> 1
                bnz = b.clamp(min=1)
                exact = ((lambda: a * b) if name == "rapid_mul"
                         else (lambda: a // bnz))
                lib = {"library_ms": timer.graph(exact, 10),
                       "library": ("int32 a * b" if name == "rapid_mul" else
                                   "int32 a // b (b = 0 lifted to 1)")
                       + ", exact (no RAPID; never called by the port)"}
            record(name, f"pairs={m} {scheme} n_bits={n_bits}"
                   + (" a<2^16" if name == "rapid_div" and n else "")
                   + (" exhaustive 8-bit" if n is None else "") + where,
                   err, 0 if ok else -1, ok,
                   timer.graph(k, 50 if n is None else 10),
                   timer(lambda: plain(a, b, scheme, n_bits), 2),
                   m * (4 + 4 + 4), m * INT32_OPS_PER_UNIT, INT32_OPS_PER_S,
                   {"call_ms": timer(k, 10), **lib})
            del a, b, got, ref
        del a0, b0

    c = torch.randn((8, 8), generator=g, device=dev)
    blocks = torch.randn((JPEG_BLOCKS, 8, 8), generator=g, device=dev) * 40
    for side in ("x", "w"):
        x = c.expand(JPEG_BLOCKS, 8, 8) if side == "x" else blocks
        w = blocks if side == "x" else c.T.contiguous().expand(
            JPEG_BLOCKS, 8, 8)
        ref = log_matmul_plain(x, w, "rapid10")
        plain_ms = timer(lambda: log_matmul_plain(x, w, "rapid10"), 2)
        lib = {"library_ms": timer.graph(lambda: torch.matmul(x, w), 20),
               "library": "torch.matmul, batched f32 with TF32 off (exact, "
                          "no RAPID; never called by the port)"}
        for depth in DEPTHS:  # one K block: nk < depth from depth 2 on
            got = log_matmul(x, w, "rapid10", spec=at(depth))
            torch.cuda.synchronize()
            ok = same_bits(got, ref)
            k1b = lambda: log_matmul(x, w, "rapid10",  # noqa: E731
                                     spec=at(depth))
            record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                   f"batched [{JPEG_BLOCKS},8,8]@[{JPEG_BLOCKS},8,8]"
                   f" {side} broadcast (JPEG 2048^2 DCT) depth={depth}",
                   abs_max(got, ref), ulp_max(got, ref), ok,
                   timer.graph(k1b, 20), plain_ms,
                   4 * (64 + 2 * JPEG_BLOCKS * 64),
                   JPEG_BLOCKS * 512 * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                   {"call_ms": timer(k1b, 10), "products": JPEG_BLOCKS * 512,
                    "depth": depth, **lib})
            del got


# --------------------------------------------------------------------------
# phases 3 and 4: serving
# --------------------------------------------------------------------------

class TimedEngine:
    """Host-clock timing around an engine's steps, each between two device
    syncs, and a finiteness check on every logits row that a request
    reads.  The lockstep engine's prefill and decode steps land in
    ``prefill_s`` / ``decode_s``; the continuous engine's ticks in
    ``prefill_tick_s`` / ``decode_tick_s``.  On the graph route a
    phase's first step is its warm-up and capture, every later one a
    replay.  With ``probe`` set, the first continuous tick runs under
    :func:`tick_probe`."""

    def __init__(self, torch, engine, probe: bool = False):
        self.torch, self.engine = torch, engine
        self.prefill_s, self.decode_s = [], []
        self.prefill_tick_s, self.decode_tick_s = [], []
        self.probe = {} if probe else None
        if hasattr(engine, "_steps"):  # ContinuousServeEngine
            run = engine._run

            def timed_run(phase, tokens, page_table, offsets, n_valid):
                sink = (self.prefill_tick_s if phase == "prefill"
                        else self.decode_tick_s)
                return self._timed(sink, run, phase, tokens, page_table,
                                   offsets, n_valid, rows=n_valid > 0)
            engine._run = timed_run
        else:
            prefill, decode = engine._prefill, engine._decode
            engine._prefill = lambda *a, **k: self._timed(
                self.prefill_s, prefill, *a, **k)
            engine._decode = lambda *a, **k: self._timed(
                self.decode_s, decode, *a, **k)

    def _timed(self, sink, fn, *a, rows=None, **k):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.probe == {} and rows is not None:
            with tick_probe(torch, self.probe):
                res = fn(*a, **k)
        else:
            res = fn(*a, **k)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        logits = res[0] if isinstance(res, tuple) else res
        read = logits if rows is None else logits[
            torch.from_numpy(rows).to(logits.device)]
        if not bool(torch.isfinite(read).all()):
            raise AssertionError("non-finite logits")
        return res


def step_stats(times) -> dict:
    """The first step (on the graph route: warm-up and capture) apart
    from the rest (replays), in ms."""
    rest = times[1:] or times
    return {"first_ms": times[0] * 1e3,
            "rest_mean_ms": float(np.mean(rest)) * 1e3,
            "rest_median_ms": float(np.median(rest)) * 1e3, "n": len(times)}


@contextmanager
def tick_probe(torch, out: dict):
    """Where a paged tick spends its time, at next to no cost to it: the
    host clock and a CUDA event after each layer (recording an event does
    not block the host; the wrapper adds ~10 us a layer) and the caching
    allocator's cudaMalloc calls and OOM retries around the tick.  A
    layer whose host time is long while the device waited on it stalled
    on the host (module loading, allocation); one whose device time is
    long ran long on the card.  On the graph route the tick's layers run
    in its warm-up (marked) and again in its capture (not marked: a
    capture records no event), so the last segment is the head and the
    capture.  Fills ``out``."""
    from repro_torch.models import model as model_mod

    orig = model_mod.block_decode_paged
    marks = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return time.perf_counter(), ev

    def block(*a, **k):
        res = orig(*a, **k)
        if not torch.cuda.is_current_stream_capturing():
            marks.append(event())
        return res

    mem0 = torch.cuda.memory_stats()
    marks.append(event())
    model_mod.block_decode_paged = block
    try:
        yield
    finally:
        model_mod.block_decode_paged = orig
    marks.append(event())  # the head: final norm, logits
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_stats()
    out["host_ms"] = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    out["device_ms"] = [a[1].elapsed_time(b[1])
                        for a, b in zip(marks, marks[1:])]
    for key in ("num_device_alloc", "num_alloc_retries", "num_device_free"):
        out[key] = mem1.get(key, 0) - mem0.get(key, 0)


def prompts_for(vocab: int, seed: int = 0, n_extra: int = 0):
    """4 prompts of 96-128 tokens, then ``n_extra`` more from the same
    generator (the first 4 do not change with ``n_extra``)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(96, 129, 4)]
    return prompts + [rng.integers(0, vocab, int(n)).tolist()
                      for n in rng.integers(96, 129, n_extra)]


def require_launches(path: str, counts, must, must_not=()) -> None:
    missing = [k for k in must if counts[k] <= 0]
    extra = [k for k in must_not if counts[k] > 0]
    if missing or extra:
        raise AssertionError(f"{path}: launched no {missing}; launched "
                             f"{extra}, which it must not ({counts})")


def counts_now() -> dict:
    """``launch_counts()`` plus, for each kernel with a stage count, its
    launches at depth >= 2 under ``<name>@d2+`` (K1's are K7's, K2's,
    K3's and K5's are K8's)."""
    from repro_torch.kernels import launch_counts, launch_counts_by_depth

    counts = launch_counts()
    for name, by_depth in launch_counts_by_depth().items():
        counts[f"{name}@d2+"] = sum(n for d, n in by_depth.items() if d >= 2)
    return counts


def serve_phase(torch, dev):
    """Full-width lockstep serving on the graph route (the main path,
    counted), the same requests on the eager route (the same greedy
    tokens and launch counts), both again warm in turns (eager, graph)
    for the decode step's time; then the 2-layer copy kernels vs
    plain."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("h2o_danube_1_8b").with_(approx=RAPID)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    log(f"serve: h2o_danube_1_8b {cfg.n_layers} layers d_model={cfg.d_model} "
        f"RAPID {cfg.approx.mul_scheme}/{cfg.approx.div_scheme}, params "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}e9 f32 "
        f"(init {time.perf_counter() - t0:.1f}s)")
    prompts = prompts_for(cfg.vocab_size)
    max_new = 16
    routes = {"graph": ServeEngine(model, params, cache_n=512),
              "eager": ServeEngine(model, params, cache_n=512,
                                   cuda_graphs=False)}
    timers = {route: TimedEngine(torch, eng) for route, eng in routes.items()}
    runs = {}
    for route, turn in (("graph", "cold"), ("eager", "cold"),
                        ("eager", "warm"), ("graph", "warm")):
        timed = timers[route]
        n_dec = len(timed.decode_s)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = routes[route].generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dec = timed.decode_s[n_dec:]
        n_tok = sum(len(o) for o in out) - len(out)  # after the first
        runs[route, turn] = {
            "wall_s": wall, "tokens": out, "launches": counts_now(),
            "prefill_ms": timed.prefill_s[-1] * 1e3,
            "decode_steps": len(dec), **step_stats(dec),
            "decode_ms_per_step": float(np.mean(dec)) * 1e3,
            "decode_tokens_per_s": n_tok / sum(dec),
            "decode_tokens_per_s_replays": (n_tok - len(out))
            / sum(dec[1:])}
        r = runs[route, turn]
        log(f"serve {route} {turn}: prompts {[len(p) for p in prompts]}, "
            f"prefill {r['prefill_ms']:.1f} ms, decode {len(dec)} steps "
            f"{sum(dec) * 1e3:.1f} ms ({r['decode_tokens_per_s']:.1f} "
            f"tokens/s; step 1 {r['first_ms']:.2f} ms, the rest mean "
            f"{r['rest_mean_ms']:.2f} ms = "
            f"{r['decode_tokens_per_s_replays']:.1f} tokens/s), wall "
            f"{wall:.2f}s")
    main = runs["graph", "cold"]
    counts, out = main["launches"], main["tokens"]
    log("kernels " + json.dumps(counts))
    for i, o in enumerate(out):
        log(f"req{i}: {o}")
    if any(len(o) != max_new for o in out):
        raise AssertionError(f"expected {max_new} tokens per request")
    if any(not 0 <= t < cfg.padded_vocab for o in out for t in o):
        raise AssertionError("token outside the vocabulary")
    require_launches("lockstep serve", counts, LOCKSTEP_KERNELS)
    for key, r in runs.items():
        if r["tokens"] != out:
            raise AssertionError(f"lockstep {key} tokens differ from the "
                                 f"graph route's:\n{out}\n{r['tokens']}")
    if runs["eager", "cold"]["launches"] != counts:
        raise AssertionError(f"lockstep launches, graph route {counts} vs "
                             f"eager {runs['eager', 'cold']['launches']}")
    traces = routes["graph"].trace_counts
    if traces != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"lockstep trace_counts {traces} after two "
                             "runs of one shape")
    g, e = runs["graph", "warm"], runs["eager", "warm"]
    log(f"serve graph vs eager (warm, same requests): decode step "
        f"{g['decode_ms_per_step']:.2f} vs {e['decode_ms_per_step']:.2f} ms "
        f"({e['decode_ms_per_step'] / g['decode_ms_per_step']:.2f}x), "
        f"{g['decode_tokens_per_s']:.1f} vs {e['decode_tokens_per_s']:.1f} "
        f"tokens/s; tokens equal, launches equal, trace_counts {traces}")

    # the path end to end: 2-layer full-width copy, kernels (graph route)
    # vs plain (eager: a capture of the plain matmul's K-step loop would
    # hold hundreds of thousands of nodes)
    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    reset_launch_counts()
    t0 = time.perf_counter()
    k_tok = ServeEngine(Model(cfg2), params2, cache_n=512).generate(
        prompts, max_new=max_new)
    t_k = time.perf_counter() - t0
    k_counts = counts_now()
    reset_launch_counts()
    t0 = time.perf_counter()
    with plain_versions():
        p_tok = ServeEngine(Model(cfg2), params2, cache_n=512,
                            cuda_graphs=False).generate(prompts,
                                                        max_new=max_new)
    t_p = time.perf_counter() - t0
    p_counts = counts_now()
    # the comparison means something only if the two runs took different
    # routes: the path's kernels in the first, none in the second
    require_launches("lockstep 2-layer kernel run", k_counts, LOCKSTEP_KERNELS)
    require_launches("lockstep 2-layer plain run", p_counts, (), p_counts)
    agree = sum(a == b for ka, pa in zip(k_tok, p_tok) for a, b in zip(ka, pa))
    log(f"e2e 2-layer: kernels {t_k:.2f}s {json.dumps(k_counts)}, plain "
        f"{t_p:.2f}s {json.dumps(p_counts)}, greedy tokens equal "
        f"{agree}/{sum(len(o) for o in p_tok)}")
    if k_tok != p_tok:
        raise AssertionError(f"2-layer greedy tokens differ:\n{k_tok}\n{p_tok}")
    return cfg, params, {
        "prefill_ms": main["prefill_ms"],
        "decode_ms_per_step": main["decode_ms_per_step"],
        "decode_tokens_per_s": main["decode_tokens_per_s"],
        "decode_steps": main["decode_steps"], "launches": counts,
        "tokens": out, "trace_counts": traces,
        "graph_vs_eager": {f"{route}_{turn}": {
            k: v for k, v in r.items() if k != "tokens"}
            for (route, turn), r in runs.items()},
        "e2e_2layer_equal": True}


def drain(engine, prompts, max_new):
    """Stream ``prompts`` through the engine until it drains; returns the
    tokens per request in submission order, the longest queue seen after
    a tick and the seconds to the first token."""
    outs, max_queued, first = {}, 0, None
    t0 = time.perf_counter()
    for ev in engine.stream(prompts, max_new):
        if ev.token is not None:
            if first is None:
                first = time.perf_counter() - t0
            outs.setdefault(ev.rid, []).append(ev.token)
        max_queued = max(max_queued, engine.n_queued)
    if len(outs) != len(prompts):
        raise AssertionError(f"{len(outs)} of {len(prompts)} requests "
                             "produced tokens")
    return [outs[r] for r in sorted(outs)], max_queued, first


def profiled_step(torch, run):
    """One ``run()`` (an engine step) under torch.profiler: its wall time
    in ms, the profiler's averages of the kernels the card ran in it,
    and the launch counts before and after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    before = counts_now()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        # warm-up step: the tracer runs, its events are dropped
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        # the window opens here; a step started at once now and then
        # lost its first kernels to the profiler, and so did a graph
        # replay started after a wait (PERF.md §6): torch's own kernels
        # go first, then the wait (they add ~0.1 ms to kernel time)
        pad = torch.ones(1, device="cuda")
        for _ in range(PROFILE_PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_SETTLE_S)
        prof.step()
    after = counts_now()
    # the step's annotation spans the window; it is no kernel
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]
    return wall, kern, before, after


def profiled(torch, label: str, run, shares=None) -> dict:
    """``run()`` (one engine step) under torch.profiler: wall time, the
    device time of its kernels, the device's busy share (kernel time /
    wall; one stream, so kernels never overlap), the kernels that take
    most of it, and the device time of two groups: the batched K1
    launches (the MoE experts' contractions; the kernel's ``BATCHED``
    template argument) and the copy kernels (dtype casts: on an MoE
    step the expert stacks' two casts a contraction, f32 -> bf16 ->
    f32, beside the activations' small ones).  The port's kernels the
    profiler saw must number the launches its counters gained (on the
    graph route, the launches the capture recorded, which each replay
    adds): proof that a replay ran them.  ``shares`` (where given) maps
    the kernels' (name, device ms) pairs, the wall and K1's ms to a dict
    of shares, kept as ``shares``."""
    wall, kern, before, after = profiled_step(torch, run)
    seen = {}
    for wrappers, names in PROFILED_KERNELS.items():
        pat = re.compile(r"(?<!\w)(%s)\b" % "|".join(names))
        seen[wrappers] = (
            sum(after[w] - before[w] for w in wrappers),
            sum(e.count for e in kern if pat.search(e.key)))
    if any(c != r for c, r in seen.values()) or not seen[
            ("log_matmul",)][1]:
        raise AssertionError(
            f"profiled {label}: launches counted vs kernels the profiler "
            f"saw: {seen}")
    dev = sum(e.self_device_time_total for e in kern) / 1e3
    k1 = [e for e in kern if K1_NAMES.search(e.key)]
    # the batched instances, where the profiler names template arguments
    expert = (sum(e.self_device_time_total for e in k1
                  if BATCHED_K1.search(e.key)) / 1e3
              if any("<" in e.key for e in k1) else None)
    casts = sum(e.self_device_time_total for e in kern
                if "copy" in e.key) / 1e3
    divs = (sum(e.self_device_time_total for e in kern
                if DIV_NAMES.search(e.key)) / 1e3
            if all("<" in e.key for e in kern if "row_slab_kernel" in e.key)
            else None)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
    k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
    res = {"wall_ms": wall, "kernel_ms": dev,
           "busy": dev / wall if dev else None, "k1_ms": k1_ms,
           "expert_k1_ms": expert, "copy_kernels_ms": casts,
           "div_ms": divs,
           "launches_vs_profiled": {
               "+".join(w): list(v) for w, v in seen.items()},
           "top": [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                   for e in top]}
    if shares is not None:
        res["shares"] = shares([(e.key, e.self_device_time_total / 1e3)
                                for e in kern], wall, k1_ms)
    busy = (f"busy {dev / wall:.1%}" if dev else
            "device time not measured (the profiler saw no kernels)")
    share = ("batched K1 not measured (no template arguments in the "
             "profiler's names)" if expert is None else
             f"batched K1 {expert:.2f} ms ({expert / wall:.1%} of wall)")
    log(f"profile {label}: wall {wall:.1f} ms, kernels {dev:.1f} ms, "
        f"{busy}; K1 {k1_ms:.2f} ms ({k1_ms / wall:.1%} of wall); {share}; "
        f"copy kernels {casts:.2f} ms "
        f"({casts / wall:.1%}); launches counted = kernels profiled "
        f"{ {'+'.join(w): v[0] for w, v in seen.items()} }; top " + "; ".join(
            f"{k} x{n} {t:.1f} ms" for k, n, t in res["top"]))
    return res


def profile_ticks(torch, model, params, cuda_graphs: bool = True):
    """A prefill tick (the first 64-token chunk of a 128-token prompt, no
    slot decoding) and a decode-only tick (one slot) under torch.profiler,
    on a warm process and, on the graph route, on graphs already captured
    (a 2-token request drains first), each through :func:`profiled`."""
    from repro_torch.serve.scheduler import ContinuousServeEngine

    engine = ContinuousServeEngine(model, params, n_slots=4, max_len=256,
                                   page_size=16, prefill_chunk=64,
                                   cuda_graphs=cuda_graphs)
    prompt = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, 128).tolist()
    engine.generate([prompt[:64]], max_new=2)  # one tick of each phase
    rid = engine.submit(prompt, 16)
    out = {}
    # the first tick prefills chunk 1, the second chunk 2 and decodes the
    # first token, the third only decodes
    route = "graph" if cuda_graphs else "eager"
    for tick in ("prefill", "mixed", "decode"):
        torch.cuda.synchronize()
        if tick == "mixed":
            engine.step()
            continue
        out[tick] = profiled(torch, f"{route} {tick} tick", engine.step)
    engine.cancel(rid)
    if engine.trace_counts != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"profiled engine traced {engine.trace_counts}")
    return out


def continuous_phase(torch, cfg, params, lockstep_out):
    """Full-width continuous serving (paged KV, chunked prefill, slot
    recycling) on the graph route: the process's first run (the main
    path, counted), whose first prefill tick is probed layer by layer,
    and the same load again on the drained engine (warm); the same load
    on the eager route, cold and warm (the same greedy tokens and launch
    counts as the graph route's cold run); a profile of one tick of each
    kind on each route; then the 2-layer kernels-vs-plain comparison."""
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

    prompts = prompts_for(cfg.vocab_size, n_extra=2)
    max_new = 16
    serve_runs, engines = {}, {}
    for route, turn in (("graph", "cold"), ("graph", "warm"),
                        ("eager", "cold"), ("eager", "warm")):
        if turn == "cold":
            engine = ContinuousServeEngine(Model(cfg), params, n_slots=4,
                                           max_len=256, page_size=16,
                                           prefill_chunk=64,
                                           cuda_graphs=route == "graph")
            engines[route] = (engine, TimedEngine(
                torch, engine, probe=route == "graph"))
        engine, timed = engines[route]
        pool_mb = sum(t.numel() * t.element_size()
                      for t in _leaves(engine.cache)) / 2**20
        n_pf, n_dc = len(timed.prefill_tick_s), len(timed.decode_tick_s)
        reset_launch_counts()
        t0 = time.perf_counter()
        out, max_queued, ttft = drain(engine, prompts, max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
        pf, dc = timed.prefill_tick_s[n_pf:], timed.decode_tick_s[n_dc:]
        n_gen = sum(len(o) for o in out)
        serve_runs[route, turn] = {
            "run": f"{route} {turn}", "wall_s": wall,
            "tokens_per_s": n_gen / wall, "ttft_s": ttft,
            "prefill_ticks": len(pf), "prefill_tick_ms": np.mean(pf) * 1e3,
            "decode_ticks": len(dc), "decode_tick_ms": np.mean(dc) * 1e3,
            "prefill_tick_ms_each": [t * 1e3 for t in pf],
            "decode_tick_ms_each": [t * 1e3 for t in dc],
            "longest_queue": max_queued, "launches": counts,
            "trace_counts": dict(engine.trace_counts), "tokens": out}
        log(f"continuous {route} {turn}: {len(prompts)} requests "
            f"{[len(p) for p in prompts]}, n_slots 4, page 16, "
            f"{engine.geom.n_pages} pages ({pool_mb:.1f} MiB of pools), "
            f"prefill_chunk 64; longest queue {max_queued}; {len(pf)} "
            f"prefill ticks (mean {np.mean(pf) * 1e3:.1f} ms: the first "
            f"{pf[0] * 1e3:.1f}, the rest median {np.median(pf[1:]) * 1e3:.1f}"
            f"), {len(dc)} decode ticks (mean {np.mean(dc) * 1e3:.2f} ms: the "
            f"first {dc[0] * 1e3:.1f}, the rest median "
            f"{np.median(dc[1:]) * 1e3:.2f}); first token after "
            f"{ttft * 1e3:.1f} ms; {n_gen} tokens in {wall:.2f}s wall = "
            f"{n_gen / wall:.2f} tokens/s; traces {engine.trace_counts}")
        if any(len(o) != max_new for o in out):
            raise AssertionError(f"expected {max_new} tokens per request")
        if any(not 0 <= t < cfg.padded_vocab for o in out for t in o):
            raise AssertionError("token outside the vocabulary")
        if max_queued < 1:
            raise AssertionError("the queue never backed up: no admission "
                                 "wait")
        if engine.alloc.n_free != engine.geom.usable_pages:
            raise AssertionError(f"page leak: {engine.alloc.n_free} free of "
                                 f"{engine.geom.usable_pages}")
        if engine.trace_counts != {"decode": 1, "prefill": 1}:
            raise AssertionError(f"continuous {route} {turn}: trace_counts "
                                 f"{engine.trace_counts}")
    cold, warm = serve_runs["graph", "cold"], serve_runs["graph", "warm"]
    out, counts = cold["tokens"], cold["launches"]
    probe = engines["graph"][1].probe
    slow = [(i, round(h, 1), round(d, 1)) for i, (h, d) in
            enumerate(zip(probe["host_ms"], probe["device_ms"])) if d > 50]
    log(f"continuous cold first prefill tick (warm-up and capture): "
        f"{cold['prefill_tick_ms_each'][0]:.1f} ms; per layer host ms median {np.median(probe['host_ms'][:-1]):.2f}, "
        f"device ms median {np.median(probe['device_ms'][:-1]):.2f}; segments "
        f"over 50 ms (index, host ms, device ms; index {cfg.n_layers} is the "
        f"head and the capture) {slow}; cudaMalloc calls "
        f"{probe['num_device_alloc']}, cudaFree calls "
        f"{probe['num_device_free']}, allocator OOM retries "
        f"{probe['num_alloc_retries']}")
    log("kernels " + json.dumps(counts))
    for i, o in enumerate(out):
        log(f"creq{i}: {o}")
    require_launches("continuous serve", counts, CONTINUOUS_KERNELS,
                     ("softmax_div",))
    # the warm run reuses pages the cold run wrote: stale KV must not leak
    # into a new request; the eager route gives the graph route's tokens
    # and, run for run, its launches
    for key, r in serve_runs.items():
        if r["tokens"] != out:
            raise AssertionError(f"continuous {key} tokens differ from the "
                                 f"graph route's cold run:\n{out}\n"
                                 f"{r['tokens']}")
        if r["launches"] != counts:
            raise AssertionError(f"continuous {key} launches {r['launches']}"
                                 f" vs the graph route's cold run {counts}")
    ew = serve_runs["eager", "warm"]
    log(f"continuous graph vs eager (warm, same load): decode tick "
        f"{warm['decode_tick_ms']:.2f} vs {ew['decode_tick_ms']:.2f} ms "
        f"({ew['decode_tick_ms'] / warm['decode_tick_ms']:.2f}x), prefill "
        f"tick {warm['prefill_tick_ms']:.1f} vs {ew['prefill_tick_ms']:.1f} "
        f"ms, {warm['tokens_per_s']:.2f} vs {ew['tokens_per_s']:.2f} "
        f"tokens/s; tokens and launches equal")
    del engines
    prof = {route: profile_ticks(torch, Model(cfg), params, route == "graph")
            for route in ("graph", "eager")}

    # information, not a gate: each of the 4 lockstep prompts alone
    # through the lockstep engine (the batch run left-pads them); bf16
    # rounds differently on the two paths (fused ln2 tail vs a separate
    # norm, softmax-then-PV vs PV-then-divide)
    alone_engine = ServeEngine(Model(cfg), params, cache_n=256)
    alone = [alone_engine.generate([p], max_new=4)[0] for p in prompts[:4]]
    agree = sum(a == b for x, y in zip(alone, out) for a, b in zip(x, y))
    log(f"continuous vs lockstep (each prompt alone, first 4 tokens): "
        f"{agree}/16 equal; lockstep batch run's first tokens "
        f"{[o[0] for o in lockstep_out]}, continuous "
        f"{[o[0] for o in out[:4]]}")

    # 2-layer full-width copy, kernels (graph route) vs plain (eager): 4
    # requests of 40-70 tokens through 2 slots (admission waits) in
    # 32-token chunks (2-3 chunks per prompt)
    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    rng = np.random.default_rng(1)
    prompts2 = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                for n in rng.integers(40, 71, 4)]
    runs = {}
    for route in ("kernels", "plain"):
        eng2 = ContinuousServeEngine(Model(cfg2), params2, n_slots=2,
                                     max_len=128, page_size=16,
                                     prefill_chunk=32,
                                     cuda_graphs=route == "kernels")
        t2 = TimedEngine(torch, eng2)
        reset_launch_counts()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_versions():
                toks, q2, _ = drain(eng2, prompts2, 8)
        else:
            toks, q2, _ = drain(eng2, prompts2, 8)
        runs[route] = (toks, time.perf_counter() - t0, counts_now(),
                       len(t2.prefill_tick_s), q2)
    (k_tok, t_k, k_counts, k_pf, k_q), (p_tok, t_p, p_counts, _, _) = \
        runs["kernels"], runs["plain"]
    require_launches("continuous 2-layer kernel run", k_counts,
                     CONTINUOUS_KERNELS, ("softmax_div",))
    require_launches("continuous 2-layer plain run", p_counts, (), p_counts)
    if k_pf < 2 * len(prompts2) or k_q < 1:
        raise AssertionError(f"2-layer continuous run: {k_pf} prefill ticks "
                             f"for {len(prompts2)} prompts, longest queue "
                             f"{k_q}")
    agree2 = sum(a == b for x, y in zip(k_tok, p_tok) for a, b in zip(x, y))
    log(f"continuous e2e 2-layer: prompts {[len(p) for p in prompts2]}, "
        f"{k_pf} prefill ticks, longest queue {k_q}; kernels {t_k:.2f}s "
        f"{json.dumps(k_counts)}, plain {t_p:.2f}s {json.dumps(p_counts)}, "
        f"greedy tokens equal {agree2}/{sum(len(o) for o in p_tok)}")
    if k_tok != p_tok:
        raise AssertionError(f"continuous 2-layer greedy tokens differ:\n"
                             f"{k_tok}\n{p_tok}")
    return {"cold": cold, "warm": warm,
            "eager_cold": serve_runs["eager", "cold"],
            "eager_warm": ew, "first_tick_probe": probe,
            "launches": counts, "profile": prof,
            "lockstep_alone_agree": agree, "e2e_2layer_equal": True}


def long_prefill_phase(torch, dev, cfg, params):
    """An 8320-token prompt on a 2-layer full-width copy: blockwise
    attention (K5) and a wrapped 4096-slot ring cache, then 4 decode
    steps; and ``_attn_blockwise`` at that shape, K5 vs its plain
    version."""
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine

    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    engine = ServeEngine(Model(cfg2), params2, cache_n=LONG_PROMPT + 5)
    timed = TimedEngine(torch, engine)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, LONG_PROMPT).tolist()
    reset_launch_counts()
    out = engine.generate([prompt], max_new=5)[0]  # prefill + 4 decode steps
    torch.cuda.synchronize()
    counts = counts_now()
    dec = step_stats(timed.decode_s)
    log(f"long prefill: {LONG_PROMPT} tokens, 2 layers, window "
        f"{cfg.sliding_window} (ring cache wraps): prefill "
        f"{timed.prefill_s[0] * 1e3:.1f} ms, {len(timed.decode_s)} decode "
        f"steps (the first, warm-up and capture, {dec['first_ms']:.2f} ms, "
        f"the replays mean {dec['rest_mean_ms']:.2f} ms); tokens {out}; "
        f"kernels {json.dumps(counts)}")
    if len(out) != 5 or len(timed.decode_s) != 4:
        raise AssertionError(f"long prefill: {len(out)} tokens, "
                             f"{len(timed.decode_s)} decode steps")
    require_launches("long prefill", counts,
                     ("log_matmul", "rms_div", "flash_decode",
                      "div_rowbcast"), ("softmax_div",))

    # _attn_blockwise at that shape (GQA 8 x 4 heads, chunk 1024 as
    # attention() passes it), K5 vs plain: the einsums are the same torch
    # calls on the same card, so the outputs must be equal
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, LONG_PROMPT, KV_HEADS, G, HD), generator=g,
                    device=dev).to(torch.bfloat16)
    k = torch.randn((1, LONG_PROMPT, KV_HEADS, HD), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((1, LONG_PROMPT, KV_HEADS, HD), generator=g,
                    device=dev).to(torch.bfloat16)
    pos = torch.arange(LONG_PROMPT, dtype=torch.int32, device=dev)

    def blockwise():
        return layers._attn_blockwise(q, k, v, pos, pos, cfg.sliding_window,
                                      True, cfg.approx, 1024)

    reset_launch_counts()
    got = blockwise().float()
    with plain_versions():
        ref = blockwise().float()
    torch.cuda.synchronize()
    n_k5 = counts_now()["div_rowbcast"]
    diff = abs_max(got, ref)
    log(f"long prefill: _attn_blockwise [1,{LONG_PROMPT},8,4,80] bf16, K5 "
        f"vs plain K5: max abs diff {diff!r} (K5 launches {n_k5})")
    if n_k5 != 1 or diff != 0.0:
        raise AssertionError(f"_attn_blockwise K5 vs plain: diff {diff}, "
                             f"{n_k5} K5 launches")
    return {"prefill_ms": timed.prefill_s[0] * 1e3, "decode": dec,
            "launches": counts, "tokens": out, "blockwise_k5_vs_plain": diff}


def kernels_vs_plain(torch, label: str, engines: dict, prompts,
                     max_new: int, layers: int = 2) -> dict:
    """Each engine of ``engines`` (path -> (make(graphs), the kernels it
    must launch, those it must not)) of a ``layers``-layer copy on
    ``prompts``, through the kernels (graph route) and through the plain
    versions (eager): the greedy tokens must agree, the first run must
    launch the path's kernels and the second none."""
    from repro_torch.kernels import plain_versions, reset_launch_counts

    rec = {}
    for path, (make, must, must_not) in engines.items():
        runs = {}
        for route in ("kernels", "plain"):
            eng2 = make(route == "kernels")
            gen = ((lambda: eng2.generate(prompts, max_new=max_new))
                   if path == "lockstep"
                   else (lambda: drain(eng2, prompts, max_new)[0]))
            reset_launch_counts()
            t0 = time.perf_counter()
            if route == "plain":
                with plain_versions():
                    toks = gen()
            else:
                toks = gen()
            torch.cuda.synchronize()
            runs[route] = (toks, time.perf_counter() - t0, counts_now())
            del eng2
        (k_tok, t_k, k_counts), (p_tok, t_p, p_counts) = (runs["kernels"],
                                                          runs["plain"])
        copy = f"{layers}-layer"
        require_launches(f"{label} {copy} {path} kernel run", k_counts,
                         must, must_not)
        require_launches(f"{label} {copy} {path} plain run", p_counts,
                         (), p_counts)
        agree = sum(a == b for x, y in zip(k_tok, p_tok)
                    for a, b in zip(x, y))
        log(f"{label} e2e {copy} {path}: prompts "
            f"{[len(p) for p in prompts]}; kernels {t_k:.2f}s "
            f"{json.dumps(k_counts)}, plain {t_p:.2f}s; greedy tokens equal "
            f"{agree}/{sum(len(o) for o in p_tok)}")
        if k_tok != p_tok:
            raise AssertionError(f"{label} {copy} {path} greedy tokens "
                                 f"differ:\n{k_tok}\n{p_tok}")
        rec[f"e2e_{layers}layer_{path}"] = {"kernels_s": t_k, "plain_s": t_p,
                                     "launches": k_counts, "tokens": k_tok}
    return rec


def engine_makers(model, params) -> dict:
    """The two engines as the full-width phases serve them, by path:
    ``make(graphs)`` builds the lockstep engine (cache_n 256) or the
    continuous one (4 slots, page 16, chunk 64) on the graph route
    (``graphs`` true) or the eager one."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

    return {
        "lockstep": lambda graphs: ServeEngine(model, params, cache_n=256,
                                               cuda_graphs=graphs),
        "continuous": lambda graphs: ContinuousServeEngine(
            model, params, n_slots=4, max_len=256, page_size=16,
            prefill_chunk=64, cuda_graphs=graphs)}


def path_kernels(cfg, path: str):
    """The kernels a serve path of ``cfg`` must launch, and those it must
    not: K3 serves the lockstep prefill's attention, and in the
    continuous engine only an MoE router's gates; an xLSTM (lockstep
    only) has no attention, and its normalisers take K5 and K6."""
    if cfg.family == "ssm":
        return XLSTM_KERNELS, ("softmax_div", "flash_decode")
    if path == "lockstep":
        return LOCKSTEP_KERNELS, ()
    if cfg.n_experts:
        return CONTINUOUS_KERNELS + ("softmax_div",), ()
    return CONTINUOUS_KERNELS, ("softmax_div",)


def serve_paths(torch, name: str, cfg, make: dict, prompts, max_new: int,
                routes=("graph",), profile=None) -> dict:
    """Each engine of ``make`` (path -> make(graphs), as
    :func:`engine_makers`) serving ``prompts`` to ``max_new`` greedy
    tokens on each of ``routes`` ("graph", the main path, then "eager"),
    its launches counted from 0 and its peak memory read: every token
    inside the vocabulary, ``trace_counts`` {"decode": 1, "prefill": 1},
    the page free list whole after a continuous drain, the path's
    kernels launched (:func:`path_kernels`), and the routes equal in
    tokens and launch counts.  ``profile(path, engine)``, where given,
    runs after the graph route's run.  Returns {path: {route: run}}."""
    from repro_torch.kernels import reset_launch_counts

    rec = {}
    for path, mk in make.items():
        runs = rec[path] = {}
        for route in routes:
            gc.collect()
            torch.cuda.empty_cache()
            engine = mk(route == "graph")
            timed = TimedEngine(torch, engine)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            if path == "lockstep":
                out, ttft = engine.generate(prompts, max_new=max_new), None
                pf, dc = timed.prefill_s, timed.decode_s
            else:
                out, _, ttft = drain(engine, prompts, max_new)
                pf, dc = timed.prefill_tick_s, timed.decode_tick_s
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_gen = sum(len(o) for o in out)
            r = runs[route] = {
                "wall_s": wall, "tokens_per_s": n_gen / wall,
                "ttft_s": ttft, "prefill": step_stats(pf),
                "decode": step_stats(dc),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": counts_now(),
                "trace_counts": dict(engine.trace_counts), "tokens": out,
                "steps": len(pf) + len(dc)}
            log(f"{name} {path} {route}: prompts {[len(p) for p in prompts]}"
                f", {len(pf)} prefill steps (the first {pf[0] * 1e3:.1f} ms, "
                f"the rest mean {r['prefill']['rest_mean_ms']:.1f}), "
                f"{len(dc)} decode steps (the first {dc[0] * 1e3:.1f} ms, the "
                f"rest mean {r['decode']['rest_mean_ms']:.2f}); {n_gen} tokens"
                f" in {wall:.2f}s = {n_gen / wall:.2f} tokens/s; peak "
                f"{r['peak_gib']:.2f} GiB; traces {engine.trace_counts}; "
                f"kernels {json.dumps(r['launches'])}")
            if path == "continuous" and \
                    engine.alloc.n_free != engine.geom.usable_pages:
                raise AssertionError(f"{name} continuous: page leak")
            if route == "graph" and profile is not None:
                r["profile"] = profile(path, engine)
            del engine, timed
        first = runs[routes[0]]
        for i, o in enumerate(first["tokens"]):
            log(f"{name} {path} req{i}: {o}")
        if any(len(o) != max_new for o in first["tokens"]) or any(
                not 0 <= t < cfg.padded_vocab for o in first["tokens"]
                for t in o):
            raise AssertionError(f"{name} {path} tokens: {first['tokens']}")
        for route, r in runs.items():
            if r["trace_counts"] != {"decode": 1, "prefill": 1}:
                raise AssertionError(f"{name} {path} {route} traced "
                                     f"{r['trace_counts']}")
            if r["tokens"] != first["tokens"] or \
                    r["launches"] != first["launches"]:
                raise AssertionError(
                    f"{name} {path}: {routes[0]} vs {route} route, tokens "
                    f"{first['tokens']} vs {r['tokens']}, launches "
                    f"{first['launches']} vs {r['launches']}")
        require_launches(f"{name} {path}", first["launches"],
                         *path_kernels(cfg, path))
    return rec


def starcoder2_phase(torch, dev):
    """Full-width starcoder2_7b (32 layers, d_model 4608, 36 heads over 4
    KV heads of 128, d_ff 18432, LN, the ungated gelu MLP; RAPID rapid10
    / rapid9, f32 params from a seed, bf16 activations and KV) on the
    graph route through both engines (:func:`serve_paths`: 4 requests of
    96-128 prompt tokens, 8 greedy tokens); then a COPY_LAYERS-layer
    full-width copy through both engines at the same load, kernels (graph
    route) vs plain (eager): the greedy tokens must agree."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.models.model import Model

    cfg = get_config("starcoder2_7b").with_(approx=RAPID)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"starcoder2: {cfg.n_layers} layers d_model={cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd} d_ff={cfg.d_ff} "
        f"act={cfg.act} norm={cfg.norm}, params {n_params / 1e9:.3f}e9 f32 "
        f"({n_params * 4 / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f}s)")
    prompts = prompts_for(cfg.vocab_size)
    max_new = 8
    rec = {"params": n_params}
    rec.update(serve_paths(torch, "starcoder2", cfg,
                           engine_makers(model, params), prompts, max_new))

    # the full-width copy at the main path's load (the same 4 prompts, 8
    # greedy tokens), kernels (graph route) vs plain (eager), through
    # both engines as the main path runs them
    cfg2 = cfg.with_(n_layers=COPY_LAYERS)
    params2 = dict(params, blocks=params["blocks"][:COPY_LAYERS])
    make2 = engine_makers(Model(cfg2), params2)
    rec.update(kernels_vs_plain(torch, "starcoder2", {
        p: (mk, *path_kernels(cfg2, p)) for p, mk in make2.items()},
        prompts, max_new, COPY_LAYERS))
    rec["e2e_copy_equal"] = True
    del params, params2, make2
    torch.cuda.empty_cache()
    return rec


def moe_phase(torch, dev, arch: str, plain_paths=("lockstep",)):
    """Full-width MoE serving, the depth cut to MOE_LAYERS layers (RAPID
    rapid10 / rapid9, f32 params from a seed, bf16 activations and KV):
    both engines (:func:`serve_paths`: 4 requests of 96-128 prompt
    tokens, 8 greedy tokens) on the graph route (the main path) and then
    on the eager route.  K1 must launch as many times as the model's
    steps call it (the attention projections and the experts' three
    batched contractions, with the shared expert's three where the
    config has one), the router's softmax divide once a layer a step.
    On graphs, one lockstep decode step (a replay) and prefill, and one
    continuous prefill and decode tick, run under torch.profiler
    (:func:`profiled`: busy share, batched K1 and the casts).  Then a
    COPY_LAYERS-layer full-width copy, kernels (graph route) vs plain (eager)
    through the engines of ``plain_paths`` at the same load (equal
    greedy tokens), and one MoE layer on the card kernels vs plain at
    the lockstep prefill's 4 x 128 tokens and a decode step's 4: the
    same bits."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.models.moe import capacity, moe_ffn

    full = get_config(arch)
    cfg = full.with_(approx=RAPID, n_layers=MOE_LAYERS)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    name = arch.split("_")[0]
    caps = {m: capacity(m, cfg) for m in (DECODE_M, CHUNK_M, PREFILL_M)}
    log(f"{name}: {cfg.n_layers} of {full.n_layers} layers, d_model="
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token} of d_ff "
        f"{cfg.d_ff}, shared expert {cfg.shared_expert}, capacity "
        f"{caps} (tokens: slots), params {n_params / 1e9:.3f}e9 f32 "
        f"({n_params * 4 / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f}s)")
    prompts = prompts_for(cfg.vocab_size)
    max_new = 8
    # K1 launches a layer a step: wq, wk, wv, wo, the experts' w1, w3,
    # w2, and the shared expert's
    k1_a_layer = 7 + 3 * cfg.shared_expert

    def profile(path, engine):
        if path == "lockstep":
            return profile_lockstep(torch, name, engine, model, params,
                                    prompts)
        return profile_ticks(torch, model, params)

    rec = {"params": n_params, "layers": cfg.n_layers,
           "full_layers": full.n_layers, "capacity": caps}
    runs = serve_paths(torch, name, cfg, engine_makers(model, params),
                       prompts, max_new, ("graph", "eager"), profile)
    for path, r in runs.items():
        g, e = r["graph"], r["eager"]
        counts = g["launches"]
        # every step calls K1 k1_a_layer times a layer (the experts'
        # batched contractions among them) and the router's divide once
        steps = g["steps"] * cfg.n_layers
        gates = counts["softmax_div"] - (cfg.n_layers if path == "lockstep"
                                         else 0)  # + prefill attention
        if counts["log_matmul"] != steps * k1_a_layer or gates != steps:
            raise AssertionError(
                f"{name} {path}: {g['steps']} steps of {cfg.n_layers} layers "
                f"launched K1 {counts['log_matmul']} times (expected "
                f"{steps * k1_a_layer}) and the router's divide {gates} "
                f"(expected {steps})")
        log(f"{name} {path} graph vs eager: decode step "
            f"{g['decode']['rest_mean_ms']:.2f} vs "
            f"{e['decode']['rest_mean_ms']:.2f} ms, prefill "
            f"{g['prefill']['rest_mean_ms']:.1f} vs "
            f"{e['prefill']['rest_mean_ms']:.1f} ms; tokens and launches "
            f"equal (K1 {counts['log_matmul']} = {g['steps']} steps x "
            f"{cfg.n_layers} layers x {k1_a_layer}), trace_counts "
            f"{g['trace_counts']}")
    rec.update(runs)

    # the full-width copy at the main path's load, kernels vs plain
    cfg2 = cfg.with_(n_layers=COPY_LAYERS)
    params2 = dict(params, blocks=params["blocks"][:COPY_LAYERS])
    make2 = engine_makers(Model(cfg2), params2)
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(kernels_vs_plain(torch, name, {
        p: (make2[p], *path_kernels(cfg2, p)) for p in plain_paths},
        prompts, max_new, COPY_LAYERS))

    # one MoE layer, kernels vs plain on the card: bit-equal (every
    # kernel is, and the combine is a fixed-order sum)
    g = torch.Generator(device=dev).manual_seed(7)
    layer = params["blocks"][0]["ffn"]
    rec["layer_bits"] = {}
    for label, (b, s) in (("lockstep prefill", (4, 128)),
                          ("decode", (DECODE_M, 1))):
        x = torch.randn((b, s, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
        reset_launch_counts()
        got = moe_ffn(x, layer, cfg)
        k_counts = counts_now()
        with plain_versions():
            ref = moe_ffn(x, layer, cfg)
        torch.cuda.synchronize()
        ok = same_bits(got.float(), ref.float())
        log(f"{name} MoE layer kernels vs plain at {label} ({b} x {s} "
            f"tokens, capacity {capacity(b * s, cfg)}): bit-equal {ok}, max "
            f"abs {abs_max(got, ref)!r}; kernels {json.dumps(k_counts)}")
        require_launches(f"{name} MoE layer {label}", k_counts,
                         ("log_matmul", "softmax_div"))
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} MoE layer at {label}: kernels and "
                                 "plain differ, or not finite")
        rec["layer_bits"][label] = True
    rec["e2e_copy_equal"] = True
    del params, params2, make2, layer
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def jamba_phase(torch, dev):
    """Full-width jamba_1_5_large_398b (d_model 8192, 64 / 8 heads of 128,
    d_ff 24576, d_inner 16384, state 16, conv 4; RAPID rapid10 / rapid9,
    f32 params from a seed, bf16 activations and cache), cut to one
    superblock (8 of 72 layers: slots 0-3 and 5-7 Mamba, slot 4
    attention) and ``n_experts=0`` (every FFN dense: one MoE slot's
    experts alone would be 38.7 GB of f32), through the lockstep engine
    (:func:`serve_paths`: 4 requests of 96-128 prompt tokens, 8 greedy
    tokens, cache_n 256) on the graph route and then eagerly: equal
    tokens and launch counts, ``trace_counts`` {"decode": 1, "prefill":
    1}, K1 launched exactly as often as a step calls it (a Mamba slot's
    in_proj and out_proj, the attention slot's 4 projections, 3 a dense
    FFN), K3 in prefill; the continuous engine refuses the family.  On
    graphs one decode step (a replay) and the prefill run under
    torch.profiler, and one Mamba mixer's torch ops (everything but its
    two K1 launches) are profiled apart at both shapes.  Then a 2-slot
    full-width copy (a Mamba slot and the attention slot) kernels (graph
    route) vs plain (eager) at a light load (4 requests of 16-22 tokens,
    4 greedy tokens: equal), and one Mamba slot kernels vs plain at 4 x
    64 tokens (two scan chunks: the carry) and 4 x 1 (a decode step on
    that state): the same bits, output and state."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.mamba import (mamba, mamba_decode,
                                          mamba_init_cache)
    from repro_torch.models.model import Model
    from repro_torch.serve.scheduler import ContinuousServeEngine

    full = get_config(JAMBA)
    cfg = full.with_(approx=RAPID, n_layers=full.attn_every, n_experts=0)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"jamba: {cfg.n_layers} of {full.n_layers} layers (one superblock, "
        f"attention at slot {cfg.attn_every // 2}), d_model={cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff={cfg.d_ff}, "
        f"d_inner {cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, "
        f"experts {cfg.n_experts} (of {full.n_experts}), params "
        f"{n_params / 1e9:.3f}e9 f32 ({n_params * 4 / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f}s)")
    try:
        ContinuousServeEngine(model, params)
    except ValueError as e:
        log(f"jamba: ContinuousServeEngine refuses the family: {e}")
    else:
        raise AssertionError("ContinuousServeEngine took the hybrid family")
    prompts = prompts_for(cfg.vocab_size)
    max_new = 8
    slots = cfg.attn_every
    # K1 launches a step: in_proj and out_proj in each Mamba slot, wq /
    # wk / wv / wo in the attention slot, w1 / w3 / w2 in every slot
    k1_a_step = 2 * (slots - 1) + 4 + 3 * slots
    sb = params["blocks"][0]

    def mixer_ops(label, x, decode):
        """One Mamba mixer (slot 0) at ``x``'s shape, profiled apart
        (:func:`mixer_profile`): its kernels' device time a call, K1's
        apart."""
        p = sb["slot0"]["mamba"]
        if decode:
            cache = mamba_init_cache(cfg, x.shape[0], x.dtype, dev)
            run = lambda: mamba_decode(x, cache, p, cfg)  # noqa: E731
        else:
            run = lambda: mamba(x, p, cfg)  # noqa: E731
        return mixer_profile(torch, f"jamba mixer {label}", run)

    def profile(path, engine):
        rec = profile_lockstep(torch, "jamba", engine, model, params,
                               prompts)
        g = torch.Generator(device=dev).manual_seed(3)
        plen = max(map(len, prompts))
        for label, shape, decode in (("decode", (len(prompts), cfg.d_model),
                                      True),
                                     ("prefill", (len(prompts), plen,
                                                  cfg.d_model), False)):
            x = torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
            ops = mixer_ops(label, x, decode)
            step = rec[label]
            # the step's Mamba ops: 7 mixers' worth of one mixer's
            ops["share_of_step"] = (slots - 1) * ops["ops_ms"] / step[
                "wall_ms"]
            log(f"jamba {label}: the Mamba mixers' torch ops "
                f"{(slots - 1) * ops['ops_ms']:.2f} ms = "
                f"{ops['share_of_step']:.1%} of the profiled step "
                f"({step['wall_ms']:.1f} ms); K1 {step['k1_ms']:.1f} ms "
                f"({step['k1_ms'] / step['wall_ms']:.1%}); busy "
                f"{step['busy']}")
            step["mamba_ops"] = ops
        return rec

    rec = {"params": n_params, "layers": cfg.n_layers,
           "full_layers": full.n_layers, "k1_a_step": k1_a_step}
    runs = serve_paths(torch, "jamba", cfg,
                       {"lockstep": engine_makers(model, params)["lockstep"]},
                       prompts, max_new, ("graph", "eager"), profile)
    g_run, e_run = runs["lockstep"]["graph"], runs["lockstep"]["eager"]
    counts = g_run["launches"]
    n_pf = g_run["prefill"]["n"]
    if counts["log_matmul"] != g_run["steps"] * k1_a_step or \
            counts["softmax_div"] != n_pf or \
            counts["flash_decode"] != g_run["decode"]["n"]:
        raise AssertionError(
            f"jamba: {g_run['steps']} steps launched K1 "
            f"{counts['log_matmul']} times (expected "
            f"{g_run['steps'] * k1_a_step}), K3 {counts['softmax_div']} "
            f"(expected {n_pf}), K4 {counts['flash_decode']} (expected "
            f"{g_run['decode']['n']})")
    log(f"jamba lockstep graph vs eager: decode step "
        f"{g_run['decode']['rest_mean_ms']:.2f} vs "
        f"{e_run['decode']['rest_mean_ms']:.2f} ms, prefill "
        f"{g_run['prefill']['rest_mean_ms']:.1f} vs "
        f"{e_run['prefill']['rest_mean_ms']:.1f} ms; tokens and launches "
        f"equal (K1 {counts['log_matmul']} = {g_run['steps']} steps x "
        f"{k1_a_step}), peak {g_run['peak_gib']:.2f} GiB")
    rec.update(runs)

    # the 2-slot full-width copy: slot 0 Mamba, slot 1 the attention slot
    cfg2 = cfg.with_(attn_every=2, n_layers=2)
    params2 = dict(params, blocks=[{"slot0": sb["slot0"],
                                    "slot1": sb[f"slot{slots // 2}"]}])
    make2 = engine_makers(Model(cfg2), params2)
    light = [p[:16 + 2 * i] for i, p in enumerate(prompts)]
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(kernels_vs_plain(torch, "jamba", {
        "lockstep": (make2["lockstep"], *path_kernels(cfg2, "lockstep"))},
        light, 4))

    # one Mamba slot, kernels vs plain: the prefill form over two scan
    # chunks, then a decode step on its state; the same bits
    g = torch.Generator(device=dev).manual_seed(11)
    p = sb["slot0"]["mamba"]
    x = torch.randn((4, 64, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    xd = torch.randn((4, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)

    def run():
        with torch.inference_mode():
            out, (h, conv) = mamba(x, p, cfg)
            cache = {"h": h.clone(), "conv": conv.clone()}
            dec, _ = mamba_decode(xd, cache, p, cfg)
        return out, h, conv, dec, cache["h"], cache["conv"]

    reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    k_counts = counts_now()
    t0 = time.perf_counter()
    with plain_versions():
        ref = run()
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    names = ("out", "h", "conv", "decode out", "decode h", "decode conv")
    bad = [n for n, a, b in zip(names, got, ref)
           if not same_bits(a.float(), b.float())
           or not bool(torch.isfinite(a).all())]
    log(f"jamba Mamba slot kernels vs plain (4 x 64 tokens, then 4 x 1): "
        f"kernels {t_k:.2f}s {json.dumps(k_counts)}, plain {t_p:.2f}s; "
        f"differ or not finite: {bad}")
    if bad or k_counts["log_matmul"] != 4:
        raise AssertionError(f"jamba Mamba slot: {bad} differ, K1 "
                             f"{k_counts['log_matmul']} launches")
    rec["mamba_slot_bits"] = {"equal": True, "kernels_s": t_k,
                              "plain_s": t_p}
    rec["e2e_2layer_equal"] = True
    del params, params2, make2, sb, p, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mixer_profile(torch, label, run, reps=5) -> dict:
    """``run()`` (one mixer call) ``reps`` times under torch.profiler: its
    kernels' device time a call, K1's apart, and the top other kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / (reps * 1e3)
    k1 = sum(e.self_device_time_total for e in kern
             if K1_NAMES.search(e.key)) / (reps * 1e3)
    top = sorted((e for e in kern if not K1_NAMES.search(e.key)),
                 key=lambda e: -e.self_device_time_total)[:4]
    log(f"{label}: kernels {total:.3f} ms a call, K1 {k1:.3f}, the mixer's "
        f"torch ops {total - k1:.3f}; top "
        + "; ".join(f"{e.key[:60]} "
                    f"{e.self_device_time_total / (reps * 1e3):.3f}"
                    for e in top))
    return {"kernel_ms": total, "k1_ms": k1, "ops_ms": total - k1}


def xlstm_phase(torch, dev, timer):
    """Full-width, full-depth xlstm_350m (24 layers, sLSTM at 5, 13 and
    21, d_model 1024, 4 heads; mLSTM in the 2x up-projected space: heads
    of 512; RAPID rapid10 / rapid9, f32 params from a seed, bf16
    activations; no depth cut) through the lockstep engine
    (:func:`serve_paths`: 4 requests of 96-128 prompt tokens, 16 greedy
    tokens, cache_n 256) on the graph route and then eagerly: equal
    tokens and launch counts, ``trace_counts`` {"decode": 1, "prefill":
    1}, K1, the rms divides, K5 (as K8 at the default depth) and K6
    launched exactly as often as the steps call them, K3 and K4 never;
    the continuous engine refuses the family.  On graphs one decode step
    (a replay) and the prefill run under torch.profiler (the busy share,
    K1's, K5 + K6's), one mLSTM and one sLSTM layer's torch ops are
    profiled apart at both shapes, and the in-place mLSTM C update is
    timed.  Then a 2-layer full-width copy (an mLSTM layer, then an sLSTM
    layer) kernels (graph route) vs plain (eager) at a light load (4
    requests of 16-22 tokens, 4 greedy tokens: equal), and one mLSTM and
    one sLSTM layer kernels vs plain at 4 x 100 tokens (two chunks, the
    second padded: the carry) and then 4 x 1 on that state: the same
    bits, output and state."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models import xlstm as xl
    from repro_torch.models.model import Model
    from repro_torch.serve.scheduler import ContinuousServeEngine

    cfg = get_config(XLSTM).with_(approx=RAPID)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    kinds = model._xlstm_kinds()
    n_s = kinds.count("slstm")
    n_m = len(kinds) - n_s
    up, mhd = xl.mlstm_dims(cfg)
    log(f"xlstm: {cfg.n_layers} layers ({n_m} mLSTM, sLSTM at "
        f"{list(cfg.slstm_at)}), d_model={cfg.d_model}, heads {cfg.n_heads}"
        f" (mLSTM {mhd} wide in {up}, sLSTM {cfg.hd}), vocab "
        f"{cfg.padded_vocab}, params {n_params / 1e6:.3f}e6 f32 "
        f"({n_params * 4 / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f}s)")
    try:
        ContinuousServeEngine(model, params)
    except ValueError as e:
        log(f"xlstm: ContinuousServeEngine refuses the family: {e}")
    else:
        raise AssertionError("ContinuousServeEngine took the ssm family")
    prompts = prompts_for(cfg.vocab_size)
    max_new = 16
    plen = max(map(len, prompts))
    chunks = -(-plen // 64)
    # a step's launches: K1 5 an mLSTM layer (up_proj, wq, wk, wv,
    # down_proj) and 2 an sLSTM layer (w, down_proj); an rms divide a
    # layer and the final norm; K5 (K8) once an mLSTM layer and chunk;
    # K6 once an sLSTM layer and time step
    k1_a_step = 5 * n_m + 2 * n_s
    rms_a_step = cfg.n_layers + 1
    blocks = params["blocks"]
    mp = blocks[kinds.index("mlstm")]["mlstm"]
    sp = blocks[kinds.index("slstm")]["slstm"]

    def profile(path, engine):
        rec = profile_lockstep(torch, "xlstm", engine, model, params,
                               prompts)
        g = torch.Generator(device=dev).manual_seed(3)
        B = len(prompts)
        for label, decode in (("decode", True), ("prefill", False)):
            shape = (B, cfg.d_model) if decode else (B, plen, cfg.d_model)
            x = torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
            ops = {}
            for kind, p, n in (("mlstm", mp, n_m), ("slstm", sp, n_s)):
                if decode:
                    cache = xl.layer_init_cache(cfg, kind, B, dev)
                    fn = getattr(xl, f"{kind}_decode")
                    run = lambda fn=fn, p=p, c=cache: fn(x, c, p, cfg)  # noqa: E731,E501
                else:
                    fn = getattr(xl, kind)
                    run = lambda fn=fn, p=p: fn(x, p, cfg)  # noqa: E731
                ops[kind] = mixer_profile(
                    torch, f"xlstm {kind} layer {label}", run,
                    reps=5 if decode or kind == "mlstm" else 1)
                ops[kind]["layers"] = n
            step = rec[label]
            mixers = sum(o["ops_ms"] * o["layers"] for o in ops.values())
            step["mixer_ops"] = ops
            step["mixer_ops_share"] = mixers / step["wall_ms"]
            log(f"xlstm {label}: the mixers' torch ops {mixers:.2f} ms "
                f"({n_m} x mLSTM + {n_s} x sLSTM) = "
                f"{step['mixer_ops_share']:.1%} of the profiled step "
                f"({step['wall_ms']:.1f} ms); K1 {step['k1_ms']:.2f} ms "
                f"({step['k1_ms'] / step['wall_ms']:.1%}); K5 + K6 "
                + ("not measured (no template arguments in the profiler's "
                   "names)" if step["div_ms"] is None else
                   f"{step['div_ms']:.3f} ms "
                   f"({step['div_ms'] / step['wall_ms']:.1%})")
                + f"; busy {step['busy']}")
        # the decode step's in-place C update of one mLSTM layer: the
        # f64 fma over [B, H, 512, 512] and the copy into the cache
        C = torch.randn((B, cfg.n_heads, mhd, mhd), generator=g,
                        device=dev)
        n_ = torch.randn((B, cfg.n_heads, mhd), generator=g, device=dev)
        kv = [torch.randn((B, cfg.n_heads, mhd), generator=g, device=dev)
              for _ in range(2)]
        wf, wi = (torch.rand((B, cfg.n_heads), generator=g, device=dev)
                  for _ in range(2))

        def update():
            Cn, nn_ = xl.mlstm_decode_update(wf, C, n_, wi, *kv)
            C.copy_(Cn)
            n_.copy_(nn_)
        ms = timer(update, 10)
        state_bytes = 2 * 4 * C.numel()  # read once, written once
        rec["c_update"] = {"ms": ms, "state_mib": 4 * C.numel() / 2**20,
                           "bound_ms": state_bytes / HBM_BYTES_PER_S * 1e3,
                           "layers": n_m}
        log(f"xlstm mLSTM C update (one layer, [{B},{cfg.n_heads},{mhd},"
            f"{mhd}] f32 = {rec['c_update']['state_mib']:.0f} MiB, f64 fma "
            f"+ copy): {ms:.3f} ms, bound {rec['c_update']['bound_ms']:.4f}"
            f" ms (the state read and written once); x {n_m} layers = "
            f"{ms * n_m:.2f} ms a step")
        del C, n_, kv
        return rec

    rec = {"params": n_params, "layers": cfg.n_layers,
           "slstm_at": list(cfg.slstm_at), "k1_a_step": k1_a_step}
    runs = serve_paths(torch, "xlstm", cfg,
                       {"lockstep": engine_makers(model, params)["lockstep"]},
                       prompts, max_new, ("graph", "eager"), profile)
    g_run, e_run = runs["lockstep"]["graph"], runs["lockstep"]["eager"]
    counts = g_run["launches"]
    n_pf, n_dc = g_run["prefill"]["n"], g_run["decode"]["n"]
    want = {"log_matmul": g_run["steps"] * k1_a_step,
            "rms_div": g_run["steps"] * rms_a_step,
            "div_rowbcast": n_m * (n_dc + n_pf * chunks),
            "div": n_s * (n_dc + n_pf * plen),
            "softmax_div": 0, "flash_decode": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"xlstm: {n_pf} prefill and {n_dc} decode "
                             f"steps launched {got}, expected {want}")
    log(f"xlstm lockstep graph vs eager: decode step "
        f"{g_run['decode']['rest_mean_ms']:.2f} vs "
        f"{e_run['decode']['rest_mean_ms']:.2f} ms, prefill "
        f"{g_run['prefill']['rest_mean_ms']:.1f} vs "
        f"{e_run['prefill']['rest_mean_ms']:.1f} ms; tokens and launches "
        f"equal ({got}: K1 {k1_a_step}, rms {rms_a_step} a step; K5 "
        f"{n_m} a decode step and {n_m * chunks} a prefill; K6 {n_s} a "
        f"decode step and {n_s * plen} a prefill), peak "
        f"{g_run['peak_gib']:.2f} GiB")
    rec.update(runs)
    rec["launches_expected"] = want

    # the 2-layer full-width copy: an mLSTM layer, then an sLSTM layer
    cfg2 = cfg.with_(n_layers=2, slstm_at=(1,))
    params2 = dict(params, blocks=[{"ln": blocks[0]["ln"], "mlstm": mp},
                                   {"ln": blocks[cfg.slstm_at[0]]["ln"],
                                    "slstm": sp}])
    make2 = engine_makers(Model(cfg2), params2)
    light = [p[:16 + 2 * i] for i, p in enumerate(prompts)]
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(kernels_vs_plain(torch, "xlstm", {
        "lockstep": (make2["lockstep"], *path_kernels(cfg2, "lockstep"))},
        light, 4))

    # one mLSTM and one sLSTM layer, kernels vs plain: the prefill form
    # over 4 x 100 tokens (two chunks, the second padded), then a decode
    # step on its state; the same bits, output and state
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((4, 100, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    xd = torch.randn((4, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)

    def run():
        outs = []
        with torch.inference_mode():
            for kind, p in (("mlstm", mp), ("slstm", sp)):
                out, st = getattr(xl, kind)(x, p, cfg)
                cache = {k: t.clone() for k, t in st.items()}
                dec, _ = getattr(xl, f"{kind}_decode")(xd, cache, p, cfg)
                outs += [(f"{kind} out", out),
                         *((f"{kind} {k}", t) for k, t in st.items()),
                         (f"{kind} decode out", dec),
                         *((f"{kind} decode {k}", t)
                           for k, t in cache.items())]
        return outs

    reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    k_counts = counts_now()
    t0 = time.perf_counter()
    with plain_versions():
        ref = run()
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    bad = [n for (n, a), (_, b) in zip(got, ref)
           if not same_bits(a.float(), b.float())
           or not bool(torch.isfinite(a).all())]
    log(f"xlstm layers kernels vs plain (4 x 100 tokens, then 4 x 1): "
        f"kernels {t_k:.2f}s {json.dumps(k_counts)}, plain {t_p:.2f}s; "
        f"differ or not finite: {bad}")
    want = {"log_matmul": 2 * (5 + 2), "div_rowbcast": 2 + 1,
            "div": 100 + 1}
    if bad or any(k_counts[k] != n for k, n in want.items()):
        raise AssertionError(f"xlstm layers: {bad} differ; launches "
                             f"{k_counts}, expected {want}")
    rec["layer_bits"] = {"equal": True, "kernels_s": t_k, "plain_s": t_p,
                         "tensors": [n for n, _ in got]}
    rec["e2e_2layer_equal"] = True
    del params, params2, make2, blocks, mp, sp, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def frontend_batch(torch, dev, cfg, B: int, prompt: int, extra: str,
                   seed: int = 7) -> dict:
    """``B`` requests for a frontend family: ``extra`` (encdec:
    ``enc_embeds``, the frames; vlm: ``patches``, an image's patch
    embeddings) [B, frontend_seq, 1024] (x 0.1, as the reference's tests
    scale them) and prompts of ``prompt`` tokens, from a seed; the first
    requests do not change with ``B``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (8, prompt))[:B]
    emb = 0.1 * rng.standard_normal((B, cfg.frontend_seq, 1024))
    return {"tokens": torch.tensor(toks, dtype=torch.int32, device=dev),
            extra: torch.tensor(emb, dtype=torch.float32, device=dev)}


def frontend_generate(torch, model, params, batch, extra: str, cache_n: int,
                      max_new: int, graphs: bool) -> dict:
    """Greedy generation the way a caller drives a frontend family (no
    engine carries ``batch[extra]``: whisper's ``enc_embeds``, llava's
    ``patches``): ``Model.prefill`` through an eager ``CompiledStep``
    (counted as the engine's prefill is), then ``max_new - 1``
    ``Model.decode_step`` calls through a ``CompiledStep`` keyed by
    ``cache_n``: one CUDA graph on the graph route (warm-up and capture on
    the first step, replays after), eager with ``graphs`` False.  Each
    step is timed by the host clock between syncs; every logits row must
    be finite.  Returns the tokens, times, trace counts, the cache's
    final ``pos`` and a ``replay`` of one more decode step (for the
    profiler)."""
    from repro_torch.serve.compiled import CompiledStep

    dev = batch["tokens"].device
    traces = {"decode": 0, "prefill": 0}
    prefill = CompiledStep("prefill", traces, dev, graphs=False)
    decode = CompiledStep("decode", traces, dev, graphs)

    def finite(logits):
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{model.cfg.name}: non-finite logits")
        return logits.argmax(-1).to(torch.int32).cpu()

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(
            lambda t, e: model.prefill(params, {"tokens": t, extra: e},
                                       cache_n),
            batch["tokens"], batch[extra])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    tok = finite(logits)
    out, step_s = [tok], []

    def fn(t):
        return model.decode_step(params, t, cache)[0]

    with torch.inference_mode():
        for _ in range(max_new - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = decode(fn, tok, key=cache_n)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            tok = finite(logits)
            out.append(tok)

    def replay():
        with torch.inference_mode():
            decode(fn, tok, key=cache_n)

    return {"tokens": torch.stack(out, 1).tolist(),
            "prefill_ms": prefill_s * 1e3,
            "decode": step_stats(step_s) if step_s else None,
            "trace_counts": traces, "pos": int(cache["pos"]),
            "replay": replay}


def whisper_launches(cfg, steps: int) -> dict:
    """The launches of a prefill and ``steps`` decode steps: K1 6 an
    encoder layer (wq, wk, wv, wo, w1, w2) and 10 a decoder layer in
    prefill (the cross k/v kept from the cross-attention, not projected
    again), 8 a decoder layer a step (wq, wk, wv, wo, the cross wq and
    wo, w1, w2; the adapter and the logits stay exact); an LN divide 2
    an encoder layer, 3 a decoder layer, and the two final norms; K3 once
    a 1024-query chunk of an encoder layer's frames and twice a decoder
    layer in prefill (self and cross); K4 twice a decoder layer a step."""
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    chunks = -(-cfg.frontend_seq // 1024)
    return {"log_matmul": 6 * Le + 10 * Ld + steps * 8 * Ld,
            "rms_div": (2 * Le + 1) + (3 * Ld + 1) * (1 + steps),
            "softmax_div": Le * chunks + 2 * Ld,
            "flash_decode": steps * 2 * Ld,
            "div_rowbcast": 0, "div": 0, "rapid_mul": 0, "rapid_div": 0}


def whisper_phase(torch, dev):
    """Full-width, full-depth whisper_medium (24 encoder + 24 decoder
    layers, d_model 1024, 16 heads of 64, d_ff 4096, LN, gelu; RAPID
    rapid10 / rapid9, f32 params from a seed, bf16 activations and
    caches; no depth cut): 4 requests of 1500 frame embeddings and 16
    prompt tokens, 48 greedy tokens into a 64-slot cache, through
    ``Model.prefill`` and ``Model.decode_step`` (:func:`frontend_generate`)
    on the graph route (the main path, counted from 0), then eagerly, then
    on graphs again (warm): equal tokens and launch counts, each kernel
    launched exactly as :func:`whisper_launches` says, ``trace_counts``
    {"decode": 1, "prefill": 1}; the launcher and the continuous engine
    refuse the family.  One decode step (a replay) and the prefill run
    under torch.profiler (the busy share; K1's, K4's and the row
    dividers' shares: the LN divides, K8, apart from K3 where the
    profiler names template arguments).  Then a 2 + 2 layer full-width
    copy on 2 of the requests, 4 greedy tokens, kernels (graph route) vs
    plain (eager): equal tokens, the kernels launched in the first run and
    none in the second."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.launch.serve import check_servable
    from repro_torch.models.model import Model
    from repro_torch.serve.scheduler import ContinuousServeEngine

    cfg = get_config(WHISPER).with_(approx=RAPID)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"whisper: {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
        f"layers, d_model={cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, "
        f"d_ff={cfg.d_ff}, {cfg.frontend_seq} frames, vocab "
        f"{cfg.padded_vocab}, params {n_params} f32 "
        f"({n_params * 4 / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f}s)")
    for what, refuse in (("ContinuousServeEngine",
                          lambda: ContinuousServeEngine(model, params)),
                         ("launch/serve.py", lambda: check_servable(cfg))):
        try:
            refuse()
        except ValueError as e:
            log(f"whisper: {what} refuses the family: {e}")
        else:
            raise AssertionError(f"{what} took the encdec family")
    batch = frontend_batch(torch, dev, cfg, WHISPER_B, WHISPER_PROMPT,
                           "enc_embeds")
    steps = WHISPER_NEW - 1
    want = whisper_launches(cfg, steps)
    runs = {}
    # no empty_cache between the routes: a prefill that has to cudaMalloc
    # its ~25 large blocks afresh took ~0.6 s longer on the H100 (1265
    # against 675 ms), which would time the allocator, not the model
    gc.collect()
    torch.cuda.empty_cache()
    for route in ("graph", "eager", "graph_warm"):
        # the prefill's encoder part: one timed encoder call on the same
        # frames before the run (its launches are not the run's)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model._encode(params, batch["enc_embeds"])
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        run = frontend_generate(torch, model, params, batch, "enc_embeds",
                                WHISPER_CACHE, WHISPER_NEW, route != "eager")
        run["launches"] = counts_now()
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        run["encoder_ms"] = enc_ms
        run["decoder_prefill_ms"] = run["prefill_ms"] - enc_ms
        runs[route] = run
        log(f"whisper {route}: prefill {run['prefill_ms']:.1f} ms (encoder "
            f"{run['encoder_ms']:.1f}, decoder {run['decoder_prefill_ms']:.1f}"
            f"), decode step first {run['decode']['first_ms']:.2f} ms, then "
            f"mean {run['decode']['rest_mean_ms']:.3f} / median "
            f"{run['decode']['rest_median_ms']:.3f} ms; peak "
            f"{run['peak_gib']:.2f} GiB; traces {run['trace_counts']}")
    g_run = runs["graph"]
    for route, run in runs.items():
        got = {k: run["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"whisper {route}: launched {got}, "
                                 f"expected {want}")
        if run["tokens"] != g_run["tokens"]:
            raise AssertionError(f"whisper {route}: tokens differ from the "
                                 f"graph route's")
        if run["trace_counts"] != {"decode": 1, "prefill": 1}:
            raise AssertionError(f"whisper {route}: traced "
                                 f"{run['trace_counts']}")
    require_launches("whisper", g_run["launches"], WHISPER_KERNELS,
                     ("div_rowbcast", "div", "rapid_mul", "rapid_div"))
    log(f"whisper graph vs eager: tokens and launches equal ({want}); "
        f"decode step {runs['graph_warm']['decode']['rest_mean_ms']:.3f} vs "
        f"{runs['eager']['decode']['rest_mean_ms']:.3f} ms")

    # one decode step (a replay of the warm run's graph) and one prefill
    # under the profiler
    def prefill():
        with torch.inference_mode():
            model.prefill(params, batch, WHISPER_CACHE)

    prof = {"decode": profiled(torch, "whisper decode step (graph replay)",
                               runs["graph_warm"]["replay"], row_shares),
            "prefill": profiled(torch, "whisper prefill", prefill,
                                row_shares)}
    # the profiled wall carries the profiler's own host work (a replayed
    # decode step: 23.4 ms profiled, 14.4 unprofiled on the H100; a
    # process's first profiled window also sets up CUPTI, seconds), so
    # the busy share is also read against the warm run's unprofiled wall
    warm = runs["graph_warm"]
    for label, rec in prof.items():
        shares = rec["shares"]
        wall = (warm["prefill_ms"] if label == "prefill"
                else warm["decode"]["rest_mean_ms"])
        rec["busy_of_unprofiled_wall"] = rec["kernel_ms"] / wall
        log(f"whisper {label} profiled: busy {rec['busy']} of the "
            f"profiled wall, {rec['busy_of_unprofiled_wall']:.1%} of the "
            f"unprofiled {wall:.2f} ms; of the profiled wall "
            + ", ".join(f"{k} " + ("not measured" if v is None
                                   else f"{v:.1%}")
                        for k, v in shares.items()))
    for run in runs.values():
        del run["replay"]
    rec = {"params": n_params, "encoder_layers": cfg.n_encoder_layers,
           "decoder_layers": cfg.n_layers, "frames": cfg.frontend_seq,
           "requests": WHISPER_B, "prompt": WHISPER_PROMPT,
           "new_tokens": WHISPER_NEW, "cache_n": WHISPER_CACHE,
           "launches_expected": want, "profiled": prof, **runs}

    # the 2 + 2 layer full-width copy on 2 requests, kernels vs plain
    cfg2 = cfg.with_(n_layers=2, n_encoder_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2],
                   enc_blocks=params["enc_blocks"][:2])
    model2 = Model(cfg2)
    batch2 = frontend_batch(torch, dev, cfg2, 2, WHISPER_PROMPT,
                            "enc_embeds")
    two = {}
    for route in ("kernels", "plain"):
        reset_launch_counts()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_versions():
                out = frontend_generate(torch, model2, params2, batch2,
                                        "enc_embeds", WHISPER_CACHE, 4, False)
        else:
            out = frontend_generate(torch, model2, params2, batch2,
                                    "enc_embeds", WHISPER_CACHE, 4, True)
        two[route] = {"tokens": out["tokens"], "counts": counts_now(),
                      "s": time.perf_counter() - t0}
    require_launches("whisper 2+2 kernel run", two["kernels"]["counts"],
                     WHISPER_KERNELS)
    require_launches("whisper 2+2 plain run", two["plain"]["counts"], (),
                     two["plain"]["counts"])
    log(f"whisper e2e 2+2 layers (2 requests, 4 tokens): kernels "
        f"{two['kernels']['s']:.2f}s, plain {two['plain']['s']:.2f}s; "
        f"tokens {two['kernels']['tokens']} vs {two['plain']['tokens']}")
    if two["kernels"]["tokens"] != two["plain"]["tokens"]:
        raise AssertionError("whisper 2+2: kernel and plain tokens differ")
    rec["e2e_2layer"] = {k: {"tokens": v["tokens"], "s": v["s"],
                             "launches": v["counts"]} for k, v in two.items()}
    del params, params2, batch, batch2, model, model2
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def kernel_share(kernels, wall_ms: float, pattern: str) -> float:
    """The share of ``wall_ms`` that the kernels whose names match
    ``pattern`` took, from (name, device ms) pairs."""
    pat = re.compile(pattern)
    return sum(t for k, t in kernels if pat.search(k)) / wall_ms


def row_shares(kernels, wall_ms: float, k1_ms: float,
               norm: str = "LN") -> dict:
    """Shares of a profiled step's wall time, from its kernels' (name,
    device ms) pairs: K1, K4 and the row dividers (the ``norm`` divides
    and K3's softmax, apart where the profiler's names carry the kernels'
    template arguments: OP 0 the norm, 1 softmax).  Whisper's shares."""
    def share(pattern):
        return kernel_share(kernels, wall_ms, pattern)

    named = all("<" in k for k, _ in kernels
                if re.search(r"row_(slab|hold)_kernel", k))
    return {"K1": k1_ms / wall_ms,
            "K4": share(r"flash_decode_kernel"),
            f"{norm} divides (K2/K8)": (
                share(r"row_(slab|hold)_kernel<\s*0\s*,") if named else None),
            "K3 softmax": (share(r"row_(slab|hold)_kernel<\s*1\s*,")
                           if named else None),
            "row dividers": share(r"row_(slab|hold)_kernel")}


def llava_launches(cfg, steps: int) -> dict:
    """The launches of a prefill and ``steps`` decode steps of the vlm
    family: K1 7 a layer in prefill and in each step (wq, wk, wv, wo --
    in prefill with ln2's rms divide in its epilogue --, w1 with silu,
    w3, w2 with the residual; the projector's two products and the logits
    stay exact); an rms divide 2 a layer (ln1, ln2) and the final norm,
    in prefill and in each step; K3 once a layer in prefill (one q chunk:
    608 tokens); K4 once a layer a step."""
    L = cfg.n_layers
    return {"log_matmul": 7 * L * (1 + steps),
            "rms_div": (2 * L + 1) * (1 + steps),
            "softmax_div": L, "flash_decode": steps * L,
            "div_rowbcast": 0, "div": 0, "rapid_mul": 0, "rapid_div": 0}


def llava_shares(kernels, wall_ms: float, k1_ms: float) -> dict:
    """:func:`row_shares` of a profiled llava step (its norms rms), the
    casts (copy kernels) and the exact cuBLAS products (the projector's
    two, the attention's score and value einsums, the logits head)."""
    return {**row_shares(kernels, wall_ms, k1_ms, "rms"),
            "casts": kernel_share(kernels, wall_ms, r"copy"),
            "exact gemms": kernel_share(kernels, wall_ms,
                                        r"gemm|Kernel2|cutlass")}


def llava_phase(torch, dev, timer):
    """Full-width llava_next_34b, its depth cut to LLAVA_LAYERS of 60
    (d_model 7168, 56 / 8 heads of 128, d_ff 20480, rms, silu; RAPID
    rapid10 / rapid9, f32 params from a seed, bf16 activations and KV):
    4 requests of 576 patch embeddings and a 32-token prompt, 32 greedy
    tokens into a 1024-slot cache, through ``Model.prefill`` and
    ``Model.decode_step`` (:func:`frontend_generate`: no engine carries
    ``patches``) on the graph route (the main path, counted from 0), then
    eagerly, then on graphs again (warm): equal tokens and launch counts,
    each kernel launched exactly as :func:`llava_launches` says, none of
    K5, K6, K9, K10, ``trace_counts`` {"decode": 1, "prefill": 1}, the
    cache's ``pos`` at patches + prompt + steps; the launcher and the
    continuous engine refuse the family.  The projector's two exact f32
    products are held against their f64 product (TF32 off) and timed
    apart.  One decode step (a replay) and the prefill run under
    torch.profiler (busy share; K1, K4, rms divides, K3, casts, exact
    products).  Then a 1-layer full-width copy on 1 request of 64 patches
    and 8 tokens, 3 greedy tokens, kernels (graph route) vs plain
    (eager): equal tokens, the kernels launched in the first run and none
    in the second."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.launch.serve import check_servable
    from repro_torch.models.model import Model
    from repro_torch.serve.scheduler import ContinuousServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(LLAVA).with_(approx=RAPID, n_layers=LLAVA_LAYERS)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"llava: {cfg.n_layers} of 60 layers, d_model={cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, "
        f"d_ff={cfg.d_ff}, {cfg.frontend_seq} patches, vocab "
        f"{cfg.padded_vocab}, params {n_params} f32 "
        f"({n_params * 4 / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f}s)")
    for what, refuse in (("ContinuousServeEngine",
                          lambda: ContinuousServeEngine(model, params)),
                         ("launch/serve.py", lambda: check_servable(cfg))):
        try:
            refuse()
        except ValueError as e:
            log(f"llava: {what} refuses the family: {e}")
        else:
            raise AssertionError(f"{what} took the vlm family")
    batch = frontend_batch(torch, dev, cfg, LLAVA_B, LLAVA_PROMPT, "patches")

    # the projector: exact f32 products (TF32 off), held against the same
    # math in f64 on the card, and timed apart (CUDA events)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("llava: TF32 is on for f32 matmuls")
    pr = params["projector"]
    with torch.inference_mode():
        p32 = Model(cfg.with_(dtype="float32"))._project(params,
                                                         batch["patches"])
        h64 = torch.nn.functional.gelu(
            batch["patches"].double() @ pr["w1"].double(), approximate="tanh")
        p64 = h64 @ pr["w2"].double()
        proj_rel = float((p32.double() - p64).abs().max() / p64.abs().max())
        del h64, p64, p32
        proj_ms = timer(lambda: model._project(params, batch["patches"]), 3)
    log(f"llava projector [{LLAVA_B}, {LLAVA_PATCHES}, 1024] -> "
        f"[{LLAVA_B}, {LLAVA_PATCHES}, {cfg.d_model}]: {proj_ms:.3f} ms "
        f"(two exact f32 products), against f64 rel {proj_rel:.2e} (TF32 "
        f"off: bound {PROJ_F64_RTOL})")
    if not proj_rel <= PROJ_F64_RTOL:
        raise AssertionError(f"llava projector: f32 vs f64 rel {proj_rel}")

    steps = LLAVA_NEW - 1
    want = llava_launches(cfg, steps)
    runs = {}
    gc.collect()
    torch.cuda.empty_cache()
    for route in ("graph", "eager", "graph_warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        run = frontend_generate(torch, model, params, batch, "patches",
                                LLAVA_CACHE, LLAVA_NEW, route != "eager")
        run["launches"] = counts_now()
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[route] = run
        log(f"llava {route}: prefill {run['prefill_ms']:.1f} ms, decode "
            f"step first {run['decode']['first_ms']:.2f} ms, then mean "
            f"{run['decode']['rest_mean_ms']:.3f} / median "
            f"{run['decode']['rest_median_ms']:.3f} ms; peak "
            f"{run['peak_gib']:.2f} GiB; traces {run['trace_counts']}")
    g_run = runs["graph"]
    for route, run in runs.items():
        got = {k: run["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"llava {route}: launched {got}, "
                                 f"expected {want}")
        if run["tokens"] != g_run["tokens"]:
            raise AssertionError(f"llava {route}: tokens differ from the "
                                 f"graph route's")
        if run["trace_counts"] != {"decode": 1, "prefill": 1}:
            raise AssertionError(f"llava {route}: traced "
                                 f"{run['trace_counts']}")
        if run["pos"] != LLAVA_S + steps or np.shape(run["tokens"]) != (
                LLAVA_B, LLAVA_NEW):
            raise AssertionError(f"llava {route}: pos {run['pos']}, tokens "
                                 f"{np.shape(run['tokens'])}")
    require_launches("llava", g_run["launches"], LLAVA_KERNELS,
                     ("div_rowbcast", "div", "rapid_mul", "rapid_div"))
    log(f"llava graph vs eager: tokens and launches equal ({want}); "
        f"decode step {runs['graph_warm']['decode']['rest_mean_ms']:.3f} vs "
        f"{runs['eager']['decode']['rest_mean_ms']:.3f} ms")

    def prefill():
        with torch.inference_mode():
            model.prefill(params, batch, LLAVA_CACHE)

    prof = {"decode": profiled(torch, "llava decode step (graph replay)",
                               runs["graph_warm"]["replay"], llava_shares),
            "prefill": profiled(torch, "llava prefill", prefill,
                                llava_shares)}
    warm = runs["graph_warm"]
    prof["prefill"]["shares"]["projector (timed apart)"] = (
        proj_ms / warm["prefill_ms"])
    for label, rec in prof.items():
        wall = (warm["prefill_ms"] if label == "prefill"
                else warm["decode"]["rest_mean_ms"])
        rec["busy_of_unprofiled_wall"] = rec["kernel_ms"] / wall
        log(f"llava {label} profiled: busy {rec['busy']} of the profiled "
            f"wall, {rec['busy_of_unprofiled_wall']:.1%} of the unprofiled "
            f"{wall:.2f} ms; of the profiled wall "
            + ", ".join(f"{k} " + ("not measured" if v is None
                                   else f"{v:.1%}")
                        for k, v in rec["shares"].items()))
    for run in runs.values():
        del run["replay"]
    rec = {"params": n_params, "layers": cfg.n_layers, "of_layers": 60,
           "patches": cfg.frontend_seq, "requests": LLAVA_B,
           "prompt": LLAVA_PROMPT, "new_tokens": LLAVA_NEW,
           "cache_n": LLAVA_CACHE, "launches_expected": want,
           "projector_ms": proj_ms, "projector_f64_rel": proj_rel,
           "profiled": prof, **runs}

    # the 1-layer full-width copy on 1 request, kernels vs plain
    c = LLAVA_COPY
    cfg2 = cfg.with_(n_layers=1, frontend_seq=c["patches"])
    params2 = dict(params, blocks=params["blocks"][:1])
    model2 = Model(cfg2)
    batch2 = frontend_batch(torch, dev, cfg2, 1, c["prompt"], "patches")
    two = {}
    for route in ("kernels", "plain"):
        reset_launch_counts()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_versions():
                out = frontend_generate(torch, model2, params2, batch2,
                                        "patches", c["cache_n"], c["new"],
                                        False)
        else:
            out = frontend_generate(torch, model2, params2, batch2, "patches",
                                    c["cache_n"], c["new"], True)
        two[route] = {"tokens": out["tokens"], "counts": counts_now(),
                      "s": time.perf_counter() - t0}
    require_launches("llava 1-layer kernel run", two["kernels"]["counts"],
                     LLAVA_KERNELS)
    require_launches("llava 1-layer plain run", two["plain"]["counts"], (),
                     two["plain"]["counts"])
    log(f"llava e2e 1 layer (1 request, {c['patches']} patches + "
        f"{c['prompt']} tokens, {c['new']} tokens): kernels "
        f"{two['kernels']['s']:.2f}s, plain {two['plain']['s']:.2f}s; "
        f"tokens {two['kernels']['tokens']} vs {two['plain']['tokens']}")
    if two["kernels"]["tokens"] != two["plain"]["tokens"]:
        raise AssertionError("llava 1 layer: kernel and plain tokens differ")
    rec["e2e_1layer"] = {k: {"tokens": v["tokens"], "s": v["s"],
                             "launches": v["counts"]} for k, v in two.items()}
    rec["seconds"] = time.perf_counter() - t_phase
    del params, params2, batch, batch2, model, model2, pr
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def profile_lockstep(torch, name, engine, model, params, prompts):
    """After a run on the graph route: the lockstep engine's decode step
    (a replay of its captured graph) and its prefill of ``prompts``
    (eager, as the engine runs it), each through :func:`profiled`."""
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p
    toks = torch.from_numpy(toks).to(engine.device)
    nxt = torch.zeros(len(prompts), dtype=torch.int32)

    def decode():  # the key is captured: the step replays, fn is unused
        engine._decode(None, nxt, key=engine.cache_n)

    def prefill():
        with torch.inference_mode():
            model.prefill(params, {"tokens": toks}, engine.cache_n)

    return {"decode": profiled(torch, f"{name} lockstep decode step "
                                      "(graph replay)", decode),
            "prefill": profiled(torch, f"{name} lockstep prefill", prefill)}


# --------------------------------------------------------------------------
# phases 7 and 8: the paper's integer units and its three applications
# --------------------------------------------------------------------------

def integer_units_phase(torch, dev, parent_rows=None):
    """The integer units' own path, as the paper's Table III uses them:
    K9 at 8 bits (every pair of nonzero operands) and 16 bits (2^24
    random nonzero pairs), K10 at 8/4 (every a < 256, 0 < b < 16) and
    16/8 (2^24 random pairs), all four schemes each, through the
    wrappers (``launch/int_times.py`` ``table3``); the launch counts are
    set to 0 just before and read just after.  The mean (ARE) and peak
    (PRE) relative error of the integer outputs against the exact
    product, and against the exact quotient where it is at least 1,
    beside the paper's fixed-point figures (information).  Where the
    parent A/B computed the parent commit's table (``parent_rows``, the
    same operands), every row must equal it digit for digit: the units'
    values did not change with their dtype."""
    from repro_torch.core import schemes
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.rapid_div.ops import rapid_div
    from repro_torch.kernels.rapid_mul.ops import rapid_mul
    from repro_torch.launch.int_times import table3

    reset_launch_counts()
    t0 = time.perf_counter()
    rows = table3(torch, dev, rapid_mul, rapid_div, schemes)
    torch.cuda.synchronize()
    counts = counts_now()
    require_launches("integer units", counts, ("rapid_mul", "rapid_div"))
    for row in rows:
        paper = PAPER_MUL if row["op"] == "mul" else PAPER_DIV
        row["paper_are_pct"], row["paper_pre_pct"] = paper[(row["scheme"],
                                                            row["n_bits"])]
        log(f"int accuracy {row['op']} n_bits={row['n_bits']:2d} "
            f"{row['scheme']:8s} ARE {row['are_pct']:.3f}% PRE "
            f"{row['pre_pct']:.2f}% over {row['pairs']} pairs (paper Table "
            f"III {row['paper_are_pct']}% / {row['paper_pre_pct']}%: "
            "fixed-point outputs; these are the units' truncated integer "
            "outputs, so they differ)")
    keys = ("op", "n_bits", "scheme", "pairs", "are_pct", "pre_pct")
    parent_equal = None
    if parent_rows:
        mine = [tuple(r[k] for k in keys) for r in rows]
        theirs = [tuple(r[k] for k in keys) for r in parent_rows]
        if mine != theirs:
            raise AssertionError(f"Table III differs from the parent's: "
                                 f"{mine} against {theirs}")
        parent_equal = True
        log(f"int accuracy: all {len(rows)} rows equal the parent's "
            "digit for digit (ARE, PRE and pairs)")
    log(f"integer units: {time.perf_counter() - t0:.1f}s, kernels "
        f"{json.dumps(counts)}")
    return {"accuracy": rows, "parent_equal": parent_equal,
            "launches": counts}


def _device_timed(torch, fn):
    """``fn()`` with its host wall time and its device time (CUDA events
    around it, synchronised), in ms."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, a.elapsed_time(b)


def apps_phase(torch, dev):
    """JPEG, Pan-Tompkins and Harris under all five variants.  At the
    reference's QoR sizes each device stage runs through the kernels and
    through the plain versions, and the two must give equal bits; the
    QoR gates of tests/test_apps_qor.py must hold.  Then the timing sizes
    (a 2048^2 aerial frame, a 5-minute ECG record, a 1024^2 scene),
    kernels only, the launch counts set to 0 just before and read just
    after: K1 and K6 must launch.  Host (numpy) and device times apart."""
    from repro_torch.apps import harris, jpeg, pan_tompkins
    from repro_torch.apps.arith import VARIANTS, psnr
    from repro_torch.kernels import plain_versions, reset_launch_counts

    names = list(VARIANTS)
    qor_counts = {}

    def both(fn, what):
        """fn() through the kernels (counted) and the plain versions (no
        launch); the two must be bit-equal."""
        reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        for k, v in counts_now().items():
            qor_counts[k] = qor_counts.get(k, 0) + v
        reset_launch_counts()
        with plain_versions():
            ref = fn()
        torch.cuda.synchronize()
        if any(counts_now().values()):
            raise AssertionError(f"{what}: the plain route launched "
                                 f"{counts_now()}")
        if not same_bits(got, ref):
            raise AssertionError(f"{what}: kernel and plain routes differ")
        return got

    t0 = time.perf_counter()
    imgs = [jpeg.synthetic_aerial(256, seed=s) for s in range(3)]
    jq = {name: float(np.mean([
        psnr(img, both(lambda: jpeg.jpeg_roundtrip(img, VARIANTS[name], device=dev),
                       f"jpeg {name}"), 255.0) for img in imgs]))
        for name in names}
    sig, truth = pan_tompkins.synthetic_ecg(40, seed=0)
    der = torch.as_tensor(pan_tompkins._bandpass_derivative(sig), device=dev)
    integ = {name: both(lambda: pan_tompkins.integrate_energy(
        der, VARIANTS[name]), f"pan-tompkins {name}").cpu().numpy()
        for name in names}
    peak = float(np.max(np.abs(integ["accurate"])) + 1e-9)
    pq = {}
    for name in names:
        se, ppv = pan_tompkins.score(pan_tompkins.find_peaks(integ[name]),
                                     truth)
        pq[name] = {"sensitivity": se, "ppv": ppv,
                    "psnr_vs_accurate_db": psnr(integ["accurate"],
                                                integ[name], peak)}
    scenes = [harris.synthetic_scene(192, seed=s) for s in range(3)]
    grads = [harris.normalized_gradients(img, dev) for img in scenes]
    corners = {name: [harris.nms_top(both(
        lambda: harris.harris_response(gx, gy, VARIANTS[name]),
        f"harris {name}").cpu().numpy()) for gx, gy in grads]
        for name in names}
    hq = {name: float(np.mean([harris.match_fraction(r, c) for r, c in zip(
        corners["accurate"], corners[name])])) * 100.0 for name in names}
    log(f"apps QoR (kernel and plain routes bit-equal in every stage, "
        f"{time.perf_counter() - t0:.1f}s; kernels {json.dumps(qor_counts)})")
    log("  jpeg psnr (3 x 256^2): " + ", ".join(
        f"{k} {v:.2f} dB" for k, v in jq.items()))
    log("  pan-tompkins (40 beats): " + "; ".join(
        f"{k} se {v['sensitivity']:.4f} ppv {v['ppv']:.4f} psnr "
        f"{v['psnr_vs_accurate_db']:.2f} dB" for k, v in pq.items()))
    log("  harris correct vectors (3 x 192^2): " + ", ".join(
        f"{k} {v:.2f}%" for k, v in hq.items()))
    gates = {
        "jpeg rapid >= 28 dB": jq["rapid"] >= 28.0,
        "jpeg accurate - rapid < 2.5 dB": jq["accurate"] - jq["rapid"] < 2.5,
        "jpeg rapid > mitchell + 2 dB": jq["rapid"] > jq["mitchell"] + 2.0,
        "pan-tompkins rapid se, ppv >= 0.95":
            min(pq["rapid"]["sensitivity"], pq["rapid"]["ppv"]) >= 0.95,
        "pan-tompkins rapid psnr >= 28 dB":
            pq["rapid"]["psnr_vs_accurate_db"] >= 28.0,
        "pan-tompkins rapid psnr > mitchell":
            pq["rapid"]["psnr_vs_accurate_db"]
            > pq["mitchell"]["psnr_vs_accurate_db"],
        "harris rapid >= 90%": hq["rapid"] >= 90.0,
        "harris rapid > truncated": hq["rapid"] > hq["truncated"]}
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"QoR gates failed: {failed}")
    require_launches("apps QoR kernel route", qor_counts, ("log_matmul", "div"))

    # timing sizes, kernels only
    timing = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    img = jpeg.synthetic_aerial(JPEG_FRAME, seed=0)
    synth = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    blocks = torch.as_tensor(jpeg._blockify(img), device=dev) - 128.0
    q = torch.as_tensor(jpeg.QTABLE, device=dev)
    torch.cuda.synchronize()
    up = (time.perf_counter() - t0) * 1e3
    dev_ms, wall_ms = {}, {}
    for name in names:
        jpeg.roundtrip_blocks(blocks, VARIANTS[name], q)  # warm
        rec, wall_ms[name], dev_ms[name] = _device_timed(
            torch, lambda: jpeg.roundtrip_blocks(blocks, VARIANTS[name], q))
        if name == "rapid":
            t0 = time.perf_counter()
            out = jpeg._unblockify(rec.cpu().numpy(), *img.shape)
            down = (time.perf_counter() - t0) * 1e3
            p_rapid = psnr(img, out, 255.0)
    timing["jpeg"] = {"shape": f"{JPEG_FRAME}x{JPEG_FRAME} "
                      f"({JPEG_BLOCKS} blocks)", "host_synth_ms": synth,
                      "host_blockify_upload_ms": up,
                      "host_download_unblockify_ms": down,
                      "device_ms": dev_ms, "wall_ms": wall_ms,
                      "psnr_rapid_db": p_rapid}
    t0 = time.perf_counter()
    sig, truth = pan_tompkins.synthetic_ecg(350, seed=1)
    synth = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    der = torch.as_tensor(pan_tompkins._bandpass_derivative(sig), device=dev)
    torch.cuda.synchronize()
    band = (time.perf_counter() - t0) * 1e3
    dev_ms, wall_ms = {}, {}
    for name in names:
        pan_tompkins.integrate_energy(der, VARIANTS[name])  # warm
        integ, wall_ms[name], dev_ms[name] = _device_timed(
            torch, lambda: pan_tompkins.integrate_energy(der, VARIANTS[name]))
        if name == "rapid":
            t0 = time.perf_counter()
            det = pan_tompkins.find_peaks(integ.cpu().numpy())
            find = (time.perf_counter() - t0) * 1e3
            se, ppv = pan_tompkins.score(det, truth)
    timing["pan_tompkins"] = {
        "shape": f"{len(sig)} samples ({len(sig) / pan_tompkins.FS:.0f} s, "
                 f"{len(truth)} beats)", "host_synth_ms": synth,
        "host_bandpass_upload_ms": band, "host_find_peaks_ms": find,
        "device_ms": dev_ms, "wall_ms": wall_ms,
        "rapid_sensitivity": se, "rapid_ppv": ppv}
    t0 = time.perf_counter()
    img = harris.synthetic_scene(1024, seed=0)
    synth = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gx, gy = harris.normalized_gradients(img, dev)
    torch.cuda.synchronize()
    sob = (time.perf_counter() - t0) * 1e3
    dev_ms, wall_ms = {}, {}
    for name in names:
        harris.harris_response(gx, gy, VARIANTS[name])  # warm
        r, wall_ms[name], dev_ms[name] = _device_timed(
            torch, lambda: harris.harris_response(gx, gy, VARIANTS[name]))
        if name == "rapid":
            t0 = time.perf_counter()
            n_corners = len(harris.nms_top(r.cpu().numpy()))
            nms = (time.perf_counter() - t0) * 1e3
    timing["harris"] = {"shape": "1024x1024", "host_synth_ms": synth,
                        "host_sobel_upload_ms": sob, "host_nms_ms": nms,
                        "device_ms": dev_ms, "wall_ms": wall_ms,
                        "rapid_corners": n_corners}
    torch.cuda.synchronize()
    counts = counts_now()
    for app, t in timing.items():
        host = {k: round(v, 2) for k, v in t.items() if k.startswith("host")}
        log(f"apps timing {app} {t['shape']}: host ms {host}; device ms per "
            "variant " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   t["device_ms"].items())
            + " (host wall " + ", ".join(f"{v:.2f}" for v in
                                         t["wall_ms"].values()) + ")")
    log(f"apps timing: jpeg rapid psnr {timing['jpeg']['psnr_rapid_db']:.2f} "
        f"dB, pan-tompkins rapid se {timing['pan_tompkins']['rapid_sensitivity']:.4f}"
        f" ppv {timing['pan_tompkins']['rapid_ppv']:.4f}, harris rapid "
        f"{timing['harris']['rapid_corners']} corners; kernels "
        f"{json.dumps(counts)}")
    require_launches("apps timing", counts, ("log_matmul", "div"))
    launches = {k: qor_counts.get(k, 0) + counts[k] for k in counts}
    return {"qor": {"jpeg_psnr_db": jq, "pan_tompkins": pq,
                    "harris_correct_vectors_pct": hq},
            "timing": timing, "launches": launches,
            "launches_qor": qor_counts, "launches_timing": counts}


# --------------------------------------------------------------------------
# depth A/B of the serve paths (the default stage counts vs depth 1)
# --------------------------------------------------------------------------

def depth_ab_phase(torch, cfg, params):
    """The serve paths at the default stage counts against depth 1 and
    depth 2 everywhere, in turns on this card (default, 1, 2, 2, 1,
    default), on the graph route: the lockstep decode step (4 tokens; K1
    in its decode regime; the replays, not the capture), the lockstep
    prefill (4 x 128 tokens) and the continuous prefill tick (64-token
    chunks; K1's chunk regime; the two replays of three ticks); then
    ``launch/k1_times.py`` at depths 1, 2 and 3 in turns (1, 2, 3, 3, 2,
    1) shape by shape, one process at the dense paths' shapes and one at
    the MoE experts' (``--moe``).  Information: nothing here fails on a
    time."""
    from repro_torch.kernels.spec import deferred_depth
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

    t0 = time.perf_counter()
    settings = {"default": None, "depth1": 1, "depth2": 2}
    prompts = prompts_for(cfg.vocab_size)
    chunk_prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, 192).tolist()
    runs = {k: {"decode_s": [], "prefill_s": [], "tick_s": []}
            for k in settings}
    for name in ("default", "depth1", "depth2", "depth2", "depth1",
                 "default"):
        with deferred_depth(settings[name]):
            engine = ServeEngine(Model(cfg), params, cache_n=512)
            timed = TimedEngine(torch, engine)
            engine.generate(prompts, max_new=5)
            # the replays: the first decode step is the capture
            runs[name]["decode_s"] += timed.decode_s[1:]
            runs[name]["prefill_s"] += timed.prefill_s
            engine = ContinuousServeEngine(Model(cfg), params, n_slots=4,
                                           max_len=256, page_size=16,
                                           prefill_chunk=64)
            timed = TimedEngine(torch, engine)
            engine.submit(chunk_prompt, 2)
            for _ in range(3):  # the prompt's three 64-token chunks
                engine.step()
            runs[name]["tick_s"] += timed.prefill_tick_s[1:]
    out = {}
    for name, r in runs.items():
        out[name] = {key[:-2] + "_ms": float(np.mean(v)) * 1e3
                     for key, v in r.items()}
        out[name].update({key[:-2] + "_ms_each": [t * 1e3 for t in v]
                          for key, v in r.items()})
    for key in ("decode", "prefill", "tick"):
        base = out["depth1"][f"{key}_ms"]
        log(f"depth A/B {key}: default {out['default'][f'{key}_ms']:.2f} ms "
            f"({out['default'][f'{key}_ms'] / base - 1:+.1%} vs depth 1), "
            f"depth 1 {base:.2f} ms, depth 2 "
            f"{out['depth2'][f'{key}_ms']:.2f} ms "
            f"({out['depth2'][f'{key}_ms'] / base - 1:+.1%})")

    t_engines = time.perf_counter() - t0
    depths = ["--depth", *map(str, (1, 2, 3, 3, 2, 1))]
    k1 = k1_times(depths) + k1_times(["--moe", *depths])
    for site in sorted({(r["site"], r["M"]) for r in k1}):
        by = {d: [r["ms"] for r in k1 if (r["site"], r["M"]) == site
                  and r["depth"] == d] for d in (1, 2, 3)}
        log(f"depth A/B k1_times {site[0]} M={site[1]}: depth 1 "
            f"{by[1]} ms, depth 2 {by[2]} ms "
            f"({np.mean(by[2]) / np.mean(by[1]) - 1:+.1%}), depth 3 "
            f"{by[3]} ms ({np.mean(by[3]) / np.mean(by[1]) - 1:+.1%})")
    out["k1_times"] = k1
    t_k1 = time.perf_counter() - t0 - t_engines
    out["parent_ab"] = parent_ab()
    out["seconds"] = {"engines": t_engines, "k1_times": t_k1,
                      "parent_ab": time.perf_counter() - t0 - t_engines
                      - t_k1}
    log(f"depth A/B seconds: {out['seconds']}")
    return out


def k1_times(args, src=None, script="k1_times.py"):
    """``launch/k1_times.py`` (or ``k4_times.py``, ``k8_times.py``: this
    tree's timers) in
    a process of its own, on this tree's kernels or on those of the tree
    ``src``."""
    cmd = [sys.executable, str(ROOT / "src/repro_torch/launch" / script),
           "--reps", "5", *args] + (["--src", str(src)] if src else [])
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        raise AssertionError(f"{script} {args} {src}: {res.stderr[-2000:]}")
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]


def parent_src():
    """(src, revision) of the parent commit's ``src`` for K1's
    before/after, unpacked by ``git archive`` under ``build/k1_parent``
    with its full revision in ``build/k1_parent/REV``.  The parent is
    HEAD where ``src/repro_torch`` differs from it (the parent of an
    uncommitted change), else HEAD^.  With git, a tree stamped with
    another revision is unpacked anew; in a copy of the checkout
    without ``.git`` a tree unpacked there beforehand is used only with
    its stamp.  (None, why) where there is no such tree."""
    dest = ROOT / "build" / "k1_parent"
    stamp = dest / "REV"
    have = stamp.read_text().strip() if stamp.is_file() else None
    if not (dest / "src" / "repro_torch" / "csrc").is_dir():
        have = None
    if not (ROOT / ".git").exists() or shutil.which("git") is None:
        if have is None:
            return None, "no git history and no stamped build/k1_parent"
        return dest / "src", have

    def git(*args):
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True)

    dirty = git("status", "--porcelain", "--untracked-files=no", "--",
                "src/repro_torch").stdout.strip()
    rev = "HEAD" if dirty else "HEAD^"
    full = git("rev-parse", "--verify", "-q", rev + "^{commit}")
    if full.returncode:
        return None, f"no commit {rev}"
    full = full.stdout.strip()
    if have != full:
        arch = subprocess.run(["git", "archive", full, "src/repro_torch"],
                              cwd=ROOT, capture_output=True)
        if arch.returncode:  # a shallow or partial clone lacks it
            return None, f"git archive {full} failed"
        shutil.rmtree(dest, ignore_errors=True)
        dest.mkdir(parents=True)
        subprocess.run(["tar", "-x", "-C", str(dest)], input=arch.stdout,
                       check=True)
        stamp.write_text(full + "\n")
    return dest / "src", full


def share_builds(src) -> list:
    """Lend this tree's kernel libraries to the tree under ``src``: a
    library is named by the hash of its sources and flags
    (``kernels/_build.py``), so one the other tree would build under the
    same name is this one, and it need not run nvcc for it.  Returns the
    names lent."""
    from repro_torch.kernels import _build

    dest = Path(src).parent / "build" / "repro_torch"
    dest.mkdir(parents=True, exist_ok=True)
    lent = []
    for so in sorted(_build.BUILD_DIR.glob("*.so")):
        if ".tmp" in so.name or (dest / so.name).exists():
            continue
        try:
            os.link(so, dest / so.name)
        except OSError:
            shutil.copy2(so, dest / so.name)
        lent.append(so.name)
    return lent


def same_kernel_code(src) -> bool:
    """True where the ``repro_torch`` under ``src`` holds this tree's
    kernel code byte for byte: the code the timing scripts run (csrc,
    kernels, core, device.py)."""
    def files(root):
        base = Path(root) / "repro_torch"
        found = {"device.py": (base / "device.py").read_bytes()}
        for sub in ("csrc", "kernels", "core"):
            for f in (base / sub).rglob("*"):
                if f.is_file() and "__pycache__" not in f.parts:
                    found[str(f.relative_to(base))] = f.read_bytes()
        return found
    return files(src) == files(ROOT / "src")


def parent_ab():
    """K1, K4, the dividers and K9/K10 before and after on this card:
    ``k1_times.py`` at each tree's default stage counts, ``k4_times.py``
    at each tree's geometry, ``k8_times.py`` (the row dividers at depths
    1, 2 and 3, each tree's geometry, and K6) and ``int_times.py`` (the
    integer units at 2^24 pairs and 8 bits exhaustive, beside int32
    ``a * b`` / ``a // b``), on the parent commit's kernels and on this
    tree's, in turns (parent, this, this, parent), one process each;
    every shape with both means, and the parent's revision; then the
    parent's Table
    III accuracy (``int_times.py --table3``), which the integer units'
    phase holds this tree's to.  Information: nothing here fails on a
    time."""
    src, parent = parent_src()
    if src is None:
        log(f"parent A/B: not run -- {parent}")
        return {"parent": None, "why": parent, "runs": []}
    log(f"parent A/B: parent {parent}; kernel libraries shared with this "
        f"tree: {share_builds(src)}")
    if same_kernel_code(src):
        log("parent A/B: the parent's kernel code (repro_torch's csrc, "
            "kernels and core, device.py) is this tree's byte for byte: "
            "no times taken, they would time one build twice")
        table3 = k1_times(["--table3"], src, "int_times.py")
        return {"parent": parent, "same_kernel_code": True, "runs": [],
                "table3": table3}
    runs = []
    for kernel, script, key in (("K1", "k1_times.py", ("site", "M")),
                                ("K4", "k4_times.py", ("shape", "C")),
                                ("K2/K3/K5/K6/K8", "k8_times.py",
                                 ("shape", "depth")),
                                ("K9/K10", "int_times.py",
                                 ("shape", "pairs"))):
        mine = []
        for who in ("parent", "this", "this", "parent"):
            rows = k1_times([], src if who == "parent" else None, script)
            mine += [dict(r, tree=who, kernel=kernel) for r in rows]
        for site in sorted({tuple(r[k] for k in key) for r in mine}):
            by = {t: [r["ms"] for r in mine
                      if tuple(r[k] for k in key) == site and r["tree"] == t]
                  for t in ("parent", "this")}
            log(f"{kernel} parent A/B {site[0]} {key[1]}={site[1]}: parent "
                f"{by['parent']} ms, this tree {by['this']} ms "
                f"({np.mean(by['parent']) / np.mean(by['this']):.2f}x faster)")
        runs += mine
    table3 = k1_times(["--table3"], src, "int_times.py")
    log(f"parent A/B: the parent's Table III, {len(table3)} rows")
    return {"parent": parent, "runs": runs, "table3": table3}


# --------------------------------------------------------------------------
# training: full width, then a 2-layer copy kernels vs plain
# --------------------------------------------------------------------------

def train_phase(torch, dev):
    """Full-width h2o_danube_1_8b, RAPID, f32 params from a seed, bf16
    compute, batch 4 x 128 (SyntheticLM), AdamW on the cosine schedule,
    block remat: 3 steps through ``make_train_step`` / ``train_loop``,
    ending in a checkpoint under ``build/``.  The launch counts are set
    to 0 just before the loop and read just after; K1 must have launched
    at depth >= 2 (K7) and K2 / K3 at depth >= 2 (K8); losses and
    gradient norms must be finite, and the checkpoint complete."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts_by_depth, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import make_train_step

    cfg = get_config("h2o_danube_1_8b").with_(approx=RAPID)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(1, dev)
    oc = OptConfig(name=cfg.optimizer, lr=3e-4, schedule=cfg.lr_schedule,
                   total_steps=TRAIN_STEPS)
    init_opt, step = make_train_step(model, oc)
    opt = init_opt(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"train: h2o_danube_1_8b {cfg.n_layers} layers d_model={cfg.d_model} "
        f"RAPID, {n_params / 1e9:.3f}e9 f32 params + AdamW state, remat "
        f"{cfg.remat}, compute {cfg.dtype}, batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"(init {time.perf_counter() - t0:.1f}s)")
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    free_gb = shutil.disk_usage(ROOT).free / 1e9
    lc = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=0, log_every=1,
                    ckpt_dir=str(ckpt), resume=False)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = train_loop(step, params, opt, src, lc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_depth = counts_now(), launch_counts_by_depth()
    peak = torch.cuda.max_memory_allocated()
    ckpt_s = wall - sum(state.step_s)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (dt, loss, gn) in enumerate(zip(state.step_s, state.losses,
                                           state.grad_norms)):
        log(f"train step {i}: {dt * 1e3:.1f} ms, {tokens / dt:.1f} tokens/s, "
            f"loss {loss:.4f}, grad norm {gn:.4f}")
    mgr = CheckpointManager(str(ckpt))
    files = list((ckpt / f"step_{TRAIN_STEPS:08d}").glob("*.npy"))
    ckpt_gb = sum(f.stat().st_size for f in files) / 1e9
    log(f"train: peak allocated {peak / 2**30:.2f} GiB; checkpoint "
        f"{len(files)} arrays {ckpt_gb:.2f} GB in {ckpt_s:.1f}s (disk free "
        f"before {free_gb:.0f} GB); launches by depth "
        f"log_matmul {by_depth['log_matmul']} rms_div {by_depth['rms_div']} "
        f"softmax_div {by_depth['softmax_div']}; kernels {json.dumps(counts)}")
    if not (np.isfinite(state.losses).all()
            and np.isfinite(state.grad_norms).all()
            and len(state.losses) == TRAIN_STEPS):
        raise AssertionError(f"train: losses {state.losses}, grad norms "
                             f"{state.grad_norms}")
    require_launches("train", counts, ("log_matmul@d2+", "rms_div@d2+",
                                       "softmax_div@d2+"))
    n_leaves = 3 * len(list(_leaves(params)))  # params, m, v
    if mgr.latest_step() != TRAIN_STEPS or len(files) != n_leaves:
        raise AssertionError(f"train: checkpoint step {mgr.latest_step()} "
                             f"with {len(files)} of {n_leaves} arrays")
    shutil.rmtree(ckpt, ignore_errors=True)
    prof = profile_train_step(torch, step, params, opt,
                              src.batch_at(TRAIN_STEPS))
    del opt
    record = {"step_ms": [t * 1e3 for t in state.step_s],
              "tokens_per_s": [tokens / t for t in state.step_s],
              "losses": state.losses, "grad_norms": state.grad_norms,
              "peak_allocated_gib": peak / 2**30, "checkpoint_s": ckpt_s,
              "checkpoint_gb": ckpt_gb, "launches": counts,
              "launches_by_depth": {k: {str(d): n for d, n in v.items()}
                                    for k, v in by_depth.items()},
              "profile": prof}
    return cfg, params, record


def profile_train_step(torch, step, params, opt, batch,
                       label="train step"):
    """One more train step (after the counted run) under torch.profiler:
    wall time, the device time of its kernels, the device's busy share
    (kernel time / wall; one stream), the device time of K1, of the row
    and elementwise dividers, of the cuBLAS / CUTLASS products, of the
    kernels named for f64 arithmetic (the mixers' fma) and of the rest,
    and the kernels that take most of it.  The profiler traces the
    device alone (the host's ops add time to the wall, and the recurrent
    steps' ~10^5 of them would take minutes to trace and sort)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch, TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's events straight from the trace, by kernel name (what
    # key_averages sums, without building its per-event records: those
    # take ~0.3 ms an event, minutes for the recurrent steps)
    kern = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, us = kern.get(e.name(), (0, 0.0))
            kern[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    dev = sum(us for _, us in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]

    def ms(pattern):
        return sum(us for k, (_, us) in kern.items()
                   if pattern.search(k)) / 1e3

    parts = {"k1_ms": ms(K1_NAMES), "row_div_ms": ms(ROW_DIV_NAMES),
             "gemm_ms": ms(GEMM_NAMES), "fma_f64_ms": ms(FMA_NAMES)}
    parts["other_ms"] = dev - sum(parts.values())
    out = {"wall_ms": wall, "kernel_ms": dev,
           "busy": dev / wall if dev else None, **parts,
           "top": [(k[:80], n, us / 1e3) for k, (n, us) in top]}
    busy = (f"busy {dev / wall:.1%}" if dev else
            "device time not measured (the profiler saw no kernels)")
    log(f"profile {label}: wall {wall:.1f} ms, kernels {dev:.1f} ms, "
        f"{busy}; " + ", ".join(f"{k[:-3]} {v:.1f} ms ({v / wall:.1%})"
                                for k, v in parts.items())
        + "; top " + "; ".join(f"{k} x{n} {t:.1f} ms"
                               for k, n, t in out["top"]))
    return out


def train_check_phase(torch, cfg, params):
    """One train step's loss and gradients on a 2-layer full-width copy
    (the trained params' first two blocks, the same batch), through the
    kernels and through the plain versions on this card.  Bound: the
    kernels are bit-equal to their plain versions (silu within 2 ulp),
    and the backward is the same torch ops on the same card, so the loss
    must agree within rel 1e-5 and every gradient within 1e-5 x its
    largest magnitude.  The launch counts must show the kernels (K7, K8)
    in the first run and none in the second.  Remat off: it moves no
    bits (``tests/test_torch_train.py``) and would run the plain
    products twice."""
    from repro_torch.data.pipeline import SyntheticLM

    cfg2 = cfg.with_(n_layers=2, remat="none")
    params2 = dict(params, blocks=params["blocks"][:2])
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=1).batch_at(0)
    return train_kernels_vs_plain(
        torch, "train 2-layer", cfg2, params2, batch,
        ("log_matmul@d2+", "rms_div@d2+", "softmax_div@d2+"))


def train_kernels_vs_plain(torch, label, cfg, params, batch, must):
    """``loss_and_grads`` of one train step of ``cfg`` on ``params`` and
    ``batch`` through the kernels and through the plain versions on this
    card: loss within rel 1e-5, every gradient within 1e-5 x its largest
    magnitude, the ``must`` kernels launched in the first run and no
    kernel in the second."""
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import make_train_step

    step = make_train_step(Model(cfg), OptConfig())[1]
    runs = {}
    for route in ("kernels", "plain"):
        reset_launch_counts()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_versions():
                loss, grads = step.loss_and_grads(params, batch)
        else:
            loss, grads = step.loss_and_grads(params, batch)
        torch.cuda.synchronize()
        runs[route] = (float(loss), grads, time.perf_counter() - t0,
                       counts_now())
    (lk, gk, tk, ck), (lp, gp, tp, cp) = runs["kernels"], runs["plain"]
    require_launches(f"{label} kernel run", ck, must)
    require_launches(f"{label} plain run", cp, (), cp)
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk, gp))
    rel = abs(lk - lp) / abs(lp)
    del runs, gk, gp
    log(f"{label} kernels vs plain: loss {lk!r} vs {lp!r} (rel "
        f"{rel:.2e}), worst gradient leaf max|diff|/max|g| {worst:.2e}; "
        f"kernels {tk:.2f}s {json.dumps(ck)}, plain {tp:.2f}s")
    if rel > 1e-5 or worst > 1e-5 or not finite:
        raise AssertionError(f"{label}: loss rel {rel}, gradient {worst} "
                             f"beyond 1e-5, or gradients not finite")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": rel,
            "grad_worst_rel_diff": worst, "kernels_s": tk, "plain_s": tp,
            "launches_kernels": ck}


def recurrent_launches(cfg, model) -> dict:
    """The launches one block-remat train step of the recurrent families
    makes.  xlstm (each layer checkpointed, recomputed once): K1 5 an
    mLSTM layer and 2 an sLSTM layer, K5 once an mLSTM layer and 64-token
    chunk, K6 once an sLSTM layer and time step, each twice.  jamba (each
    slot checkpointed inside the superblock's checkpoint): K1 2 a Mamba
    slot or 4 the attention slot, plus 3 its dense FFN, K3 once the
    attention slot, each three times (the forward, the superblock's
    recompute, the slot's own), the superblock's last slot twice (the
    superblock's recompute stops at its input)."""
    if cfg.family == "ssm":
        kinds = model._xlstm_kinds()
        n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
        return {"log_matmul": 2 * (5 * n_m + 2 * n_s),
                "div_rowbcast": 2 * n_m * -(-TRAIN_SEQ // 64),
                "div": 2 * n_s * TRAIN_SEQ}
    from repro_torch.models.hybrid import attn_slot
    out = {"log_matmul": 0, "softmax_div": 0}
    n_blocks = cfg.n_layers // cfg.attn_every
    for s in range(cfg.attn_every):
        runs = 2 if s == cfg.attn_every - 1 else 3
        attn = s == attn_slot(cfg)
        out["log_matmul"] += runs * ((4 if attn else 2) + 3) * n_blocks
        out["softmax_div"] += runs * n_blocks if attn else 0
    return out


def train_recurrent_phase(torch, dev, arch):
    """Full-width ``arch`` (xlstm_350m at full depth, jamba_1_5_large_398b
    cut to one 4-slot period: ``TRAIN_CUTS``), RAPID, f32 params from a
    seed, bf16 compute, the config's block remat and optimizer (xlstm
    AdamW, jamba Adafactor), batch 4 x 128 (SyntheticLM): 3 steps through
    ``make_train_step``; xlstm's through ``train_loop``, ending in a
    checkpoint under ``build/`` (checked, then deleted), jamba's through
    ``run_steps``, which writes none (~20 GB for nothing h2o's and
    xlstm's do not show).  The launch counts are set to 0 just
    before the loop and read just after: K1 (as K7) and the rms divide (as
    K8) must launch, and K1, K5 / K6 (xlstm) and K3 (jamba) exactly as
    often as the steps call them (``recurrent_launches``); losses and
    gradient norms must be finite.  One more step runs under
    torch.profiler (``profile_train_step``: busy share, K1's, the
    dividers', the products', the fma's f64 kernels), one mixer of each
    kind is profiled apart at the train shape, and one train step runs
    kernels vs plain on the card: xlstm on a 2-layer copy of trained
    layers 4 (mLSTM) and 5 (its first sLSTM), jamba on the phase's own
    model, both at 1 x 32 tokens, remat off."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts_by_depth, reset_launch_counts
    from repro_torch.models import mamba as mb
    from repro_torch.models import xlstm as xl
    from repro_torch.models.model import Model
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import make_train_step

    name = "train_" + arch.split("_")[0]
    cfg = get_config(arch).with_(approx=RAPID, **TRAIN_CUTS[arch])
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(1, dev)
    oc = OptConfig(name=cfg.optimizer, lr=3e-4, schedule=cfg.lr_schedule,
                   total_steps=TRAIN_STEPS)
    init_opt, step = make_train_step(model, oc)
    opt = init_opt(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"{name}: {arch} {cfg.n_layers} layers d_model={cfg.d_model} cut "
        f"{TRAIN_CUTS[arch] or 'none'}, RAPID, {n_params / 1e9:.3f}e9 f32 "
        f"params ({n_params * 4 / 2**30:.2f} GiB) + {cfg.optimizer} state, "
        f"remat {cfg.remat}, compute {cfg.dtype}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} (init {time.perf_counter() - t0:.1f}s)")
    ckpt = ROOT / "build" / "chip_smoke_ckpt" if cfg.family == "ssm" else None
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    if ckpt is not None:
        shutil.rmtree(ckpt, ignore_errors=True)
        lc = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=0, log_every=1,
                        ckpt_dir=str(ckpt), resume=False)
        state = train_loop(step, params, opt, src, lc)
    else:
        state, params, opt = run_steps(torch, step, params, opt, src)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_depth = counts_now(), launch_counts_by_depth()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (dt, loss, gn) in enumerate(zip(state.step_s, state.losses,
                                           state.grad_norms)):
        log(f"{name} step {i}: {dt * 1e3:.1f} ms, {tokens / dt:.1f} "
            f"tokens/s, loss {loss:.4f}, grad norm {gn:.4f}")
    want = {k: n * TRAIN_STEPS
            for k, n in recurrent_launches(cfg, model).items()}
    log(f"{name}: peak allocated {peak / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f}; loop {wall:.1f}s (checkpoint "
        f"{wall - sum(state.step_s):.1f}s); launches by depth "
        + " ".join(f"{k} {by_depth[k]}" for k in by_depth if by_depth[k])
        + f"; expected {json.dumps(want)}; kernels {json.dumps(counts)}")
    if not (np.isfinite(state.losses).all()
            and np.isfinite(state.grad_norms).all()
            and len(state.losses) == TRAIN_STEPS):
        raise AssertionError(f"{name}: losses {state.losses}, grad norms "
                             f"{state.grad_norms}")
    must = ("log_matmul@d2+", "rms_div@d2+") + (
        ("div_rowbcast@d2+", "div") if cfg.family == "ssm"
        else ("softmax_div@d2+",))
    require_launches(name, counts, must)
    off = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if off:
        raise AssertionError(f"{name}: launches (got, expected) {off}")
    rec = {"arch": arch, "cut": TRAIN_CUTS[arch], "n_params": n_params,
           "step_ms": [t * 1e3 for t in state.step_s],
           "tokens_per_s": [tokens / t for t in state.step_s],
           "losses": state.losses, "grad_norms": state.grad_norms,
           "peak_allocated_gib": peak / 2**30,
           "card_memory_gib": total / 2**30, "launches": counts,
           "expected_launches": want,
           "launches_by_depth": {k: {str(d): n for d, n in v.items()}
                                 for k, v in by_depth.items()}}
    if ckpt is not None:
        mgr = CheckpointManager(str(ckpt))
        files = list((ckpt / f"step_{TRAIN_STEPS:08d}").glob("*.npy"))
        n_leaves = 3 * len(list(_leaves(params)))  # params, m, v
        rec["checkpoint_gb"] = sum(f.stat().st_size for f in files) / 1e9
        rec["checkpoint_s"] = wall - sum(state.step_s)
        if mgr.latest_step() != TRAIN_STEPS or len(files) != n_leaves:
            raise AssertionError(f"{name}: checkpoint step "
                                 f"{mgr.latest_step()} with {len(files)} of "
                                 f"{n_leaves} arrays")
        log(f"{name}: checkpoint {len(files)} arrays "
            f"{rec['checkpoint_gb']:.2f} GB")
        shutil.rmtree(ckpt, ignore_errors=True)
    rec["profile"] = profile_train_step(torch, step, params, opt,
                                        src.batch_at(TRAIN_STEPS),
                                        f"{name} step")
    del opt
    gc.collect()
    torch.cuda.empty_cache()

    # one mixer of each kind, forward at the train shape: its torch ops
    # apart from its K1 launches
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=g,
                    device=dev).to(model.dtype)
    blocks = params["blocks"]
    if cfg.family == "ssm":
        kinds = model._xlstm_kinds()
        mixers = {k: (lambda k=k, p=blocks[kinds.index(k)][k]:
                      getattr(xl, k)(x, p, cfg)) for k in ("mlstm", "slstm")}
    else:
        mixers = {"mamba": lambda: mb.mamba(x, blocks[0]["slot0"]["mamba"],
                                            cfg)}
    rec["mixer_ops"] = {k: mixer_profile(torch, f"{name} {k} mixer forward "
                                                f"{TRAIN_BATCH} x {TRAIN_SEQ}",
                                         run, reps=1)
                        for k, run in mixers.items()}
    del x

    # kernels vs plain: xlstm's 2-layer copy of its first sLSTM layer (5)
    # and the mLSTM layer before it, jamba's own 4-slot model
    if cfg.family == "ssm":
        first = cfg.slstm_at[0]
        cfg2 = cfg.with_(n_layers=2, slstm_at=(1,), remat="none")
        params2 = dict(params, blocks=blocks[first - 1:first + 1])
        what = f"2-layer copy of layers {first - 1}-{first}"
    else:
        cfg2, params2, what = cfg.with_(remat="none"), params, "model"
    batch = SyntheticLM(cfg.vocab_size, TRAIN_CHECK_S, TRAIN_CHECK_B,
                        seed=1).batch_at(0)
    rec["kernels_vs_plain"] = train_kernels_vs_plain(
        torch, f"{name} {what} {TRAIN_CHECK_B} x {TRAIN_CHECK_S}",
        cfg2, params2, batch, must)
    del params, params2, blocks, state
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_steps(torch, step, params, opt, src):
    """``TRAIN_STEPS`` steps of ``step`` on ``src``'s batches, as
    ``train_loop`` runs them but with no checkpoint: ``(LoopState,
    params, opt)``, each step timed by the host clock up to a device
    sync."""
    from repro_torch.train.loop import LoopState

    state = LoopState()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, src.batch_at(i), i)
        state.losses.append(float(met["loss"]))
        state.grad_norms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        state.step_s.append(time.perf_counter() - t0)
        state.step += 1
    return state, params, opt


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global _LOG
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    _LOG = open(out_dir / "chip_smoke.log", "w")
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.kernel_timing import card_line

    t_start = time.perf_counter()
    laps = {}

    def lap(name):  # each phase's seconds, logged and recorded
        laps[name] = time.perf_counter() - t_start - sum(laps.values())
        log(f"phase {name}: {laps[name]:.1f}s (at "
            f"{time.perf_counter() - t_start:.1f}s)")

    dev = resolve_device("cuda")
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(p.name for p in _build.BUILD_DIR.glob('*.so'))} in "
        f"{time.perf_counter() - t0:.1f}s")
    ptxas = []
    for f in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in f.read_text().splitlines():
            if "registers" in line or "spill" in line:
                ptxas.append(f"{f.stem}: {line.strip()}")
                log(f"  {ptxas[-1]}")
    sass = lean_loop_sass(_build)
    sass["int_units"] = int_unit_sass(_build)
    lap("build")

    card_tests()
    lap("card_tests")
    timer = Timer(torch, dev)
    cases = kernel_phase(torch, dev, timer)
    lap("kernels")
    cfg, params, serve = serve_phase(torch, dev)
    lap("lockstep")
    cont = continuous_phase(torch, cfg, params, serve["tokens"])
    lap("continuous")
    long_ = long_prefill_phase(torch, dev, cfg, params)
    lap("long_prefill")
    ab = depth_ab_phase(torch, cfg, params)
    lap("depth_and_parent_ab")
    del params
    # the timed engines sit in reference cycles: collect them, and the
    # graphs' memory pools they hold, before the next phases allocate
    gc.collect()
    torch.cuda.empty_cache()
    sc2 = starcoder2_phase(torch, dev)
    lap("starcoder2")
    gc.collect()
    torch.cuda.empty_cache()
    # qwen3 kernels vs plain through both engines, llama4 through the
    # lockstep engine
    moe = {arch: moe_phase(torch, dev, arch, paths) for arch, paths in zip(
        MOE_ARCHS, (("lockstep", "continuous"), ("lockstep",)))}
    lap("moe")
    jamba = jamba_phase(torch, dev)
    lap("jamba")
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = xlstm_phase(torch, dev, timer)
    lap("xlstm")
    gc.collect()
    torch.cuda.empty_cache()
    whisper = whisper_phase(torch, dev)
    lap("whisper")
    llava = llava_phase(torch, dev, timer)
    lap("llava")
    ints = integer_units_phase(torch, dev, ab["parent_ab"].get("table3"))
    lap("integer_units")
    apps = apps_phase(torch, dev)
    lap("apps")
    tcfg, tparams, train = train_phase(torch, dev)
    train_check = train_check_phase(torch, tcfg, tparams)
    lap("train")
    del tparams
    gc.collect()
    torch.cuda.empty_cache()
    train_xlstm = train_recurrent_phase(torch, dev, XLSTM)
    lap("train_xlstm")
    train_jamba = train_recurrent_phase(torch, dev, JAMBA)
    lap("train_jamba")

    # each kernel's row: its time at the main paths' heaviest shape (K5:
    # the chunked-prefill tick's), its launches summed over the paths'
    # runs (the two serve paths, the integer units' own path, the apps,
    # training), each read just after that run.  K1 / K2 / K3 / K5 count
    # their wrappers' launches at depth 1, K7 and K8 those at depth >= 2
    # (K1's, and K2's + K3's + K5's), so no launch is counted twice
    from repro_torch.kernels.spec import resolve_spec
    k7_depth = resolve_spec("log_matmul", (PREFILL_M, D_FF, D)).depth
    heaviest = {"log_matmul": "w1 M=512",
                "log_matmul_pipelined": f"w1 M=512 K={D} N={D_FF} silu "
                                        f"depth={k7_depth}",
                "rms_div": "rms rows=512", "softmax_div": "softmax rows=",
                "rowwise_pipelined": "rms rows=512",
                "flash_decode": "q=",
                "div_rowbcast": "a=[2048,", "div": "a=b=",
                "rapid_mul": f"pairs={INT_PAIRS} rapid10 n_bits=16",
                "rapid_div": f"pairs={INT_PAIRS} rapid9 n_bits=8"}

    def launches(counts, name):
        if name == "log_matmul_pipelined":
            return counts["log_matmul@d2+"]
        if name == "rowwise_pipelined":
            return sum(counts[f"{k}@d2+"]
                       for k in ("rms_div", "softmax_div", "div_rowbcast"))
        if f"{name}@d2+" in counts:  # the depth-1 form's own launches
            return counts[name] - counts[f"{name}@d2+"]
        return counts[name]

    kernels = []
    for name, tag in heaviest.items():
        mine = [c for c in cases if c["kernel"] == name]
        top = next(c for c in mine if c["shape"].startswith(tag))
        by_path = {path: launches(runs["launches"], name)
                   for path, runs in (("lockstep", serve),
                                      ("continuous", cont),
                                      ("starcoder2_lockstep",
                                       sc2["lockstep"]["graph"]),
                                      ("starcoder2_continuous",
                                       sc2["continuous"]["graph"]),
                                      *((f"{arch.split('_')[0]}_{path}",
                                         moe[arch][path]["graph"])
                                        for arch in MOE_ARCHS
                                        for path in ("lockstep",
                                                     "continuous")),
                                      ("jamba_lockstep",
                                       jamba["lockstep"]["graph"]),
                                      ("xlstm_lockstep",
                                       xlstm["lockstep"]["graph"]),
                                      ("whisper", whisper["graph"]),
                                      ("llava", llava["graph"]),
                                      ("integer_units", ints),
                                      ("apps", apps), ("train", train),
                                      ("train_xlstm", train_xlstm),
                                      ("train_jamba", train_jamba))}
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"), "shape": top["shape"],
            "launches_by_path": by_path}
        if "launches_a_call" in top:
            row["launches_a_call"] = top["launches_a_call"]
        kernels.append(row)
    record = {"card": card, "ptxas": ptxas, "sass": sass,
              "cases": cases, "serve": serve,
              "continuous": cont, "long_prefill": long_, "depth_ab": ab,
              "starcoder2": sc2, "moe": moe, "jamba": jamba,
              "xlstm": xlstm, "whisper": whisper, "llava": llava,
              "integer_units": ints, "apps": apps, "train": train,
              "train_2layer": train_check, "train_xlstm": train_xlstm,
              "train_jamba": train_jamba, "kernels": kernels,
              "phase_seconds": laps,
              "seconds": time.perf_counter() - t_start}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
