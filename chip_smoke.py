#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one NVIDIA H100.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a), prints the card's name and power limit, and runs the repo's
   card tests (``tests/test_torch_gpu.py``, special operands included);
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
   2-layer copy kernels vs plain through both engines at that load
   (equal greedy tokens);
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
    in the first run and none in the second.

Step 2 holds K1 at starcoder2_7b's sites (M = 4, 64 and 512: wq,
wk/wv, wo and w2 bit-equal, w1 with the tanh gelu epilogue within 2
ulp) at every stage count, timed beside f32 ``torch.matmul``, and its
LN divides (K2/K8 over 4 / 64 / 512 rows of 4608) and a 64-token
chunk's combine (K5, 36 heads of 128) bit-equal.  It holds K4 bit-equal
to its plain version, both arms, at the
lockstep step (512 slots, 136 live), the full 4096-slot window and the
continuous tick's paged views, and times beside each the library's
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
``chiprun_out/chip_smoke.json``.
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
SC_D, SC_FF, SC_KV_HEADS, SC_HEADS, SC_HD = 4608, 18432, 4, 36, 128
GELU_ULP = 2

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

# stage counts held against the plain versions (K1 compiles 1-4 and 8;
# at depth >= 2 K1 is K7 and K2/K3/K5 are K8)
DEPTHS = (1, 2, 3, 4, 8)
# the train phase: full-width h2o_danube_1_8b, batch 4 x 128, 3 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 3

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
# the wait between opening the profiler's window and the profiled tick,
# and between the tick's end and closing it
PROFILE_SETTLE_S = 0.05
# the blockwise prefill: over _PLAIN_ATTN_MAX_T (8192) tokens and over
# the 4096-token sliding window
LONG_PROMPT = 8320


def log(msg: str) -> None:
    print(msg, flush=True)


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
    ia = a.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    ib = b.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def abs_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def same_bits(a, b) -> bool:
    """float32 tensors (or arrays) bit-equal, NaN payloads aside: NaN in
    the same places, every other element the same bit pattern."""
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
    operands -- 0, -0, inf, NaN, subnormals, the overflow edge), in a
    child process; every test must pass and none may skip."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", "tests/test_torch_gpu.py"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    log(f"card tests: {tail} ({time.perf_counter() - t0:.1f}s)")
    if out.returncode != 0 or "skipped" in tail or "passed" not in tail:
        print(out.stdout[-6000:], out.stderr[-3000:], file=sys.stderr)
        raise AssertionError(f"card tests failed: {tail}")


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

def kernel_phase(torch, dev, timer):
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

    # K1 at M = 4 (decode), 64 (continuous prefill tick) and 512
    # (lockstep prefill, a train step's 4 x 128 tokens) for each (K, N,
    # epilogue) of the paths, at every stage count (depth >= 2: K7);
    # tolerance: bit-equal, silu <= 2 ulp (CUDA expf)
    rms_tail = be.Epilogue(norm="rms", div_scheme="rapid9", eps=1e-6,
                           keep_prenorm=True)
    k1 = [("wq", D, D, None, False, None), ("wk/wv", D, KV_HEADS * HD, None,
                                            False, None),
          ("wo", D, D, None, True, None), ("wo+ln2", D, D, None, True, rms_tail),
          ("w1", D, D_FF, "silu", False, None), ("w3", D, D_FF, None, False, None),
          ("w2", D_FF, D, None, True, None)]
    for m in (DECODE_M, CHUNK_M, PREFILL_M):
        for site, k, n, act, res, ep in k1:
            x = randn(m, k)
            w = randn(k, n, std=k ** -0.5)
            r = randn(m, n) if res else None
            kw = dict(residual=r, epilogue=ep if ep else be.Epilogue(activation=act))
            ref = log_matmul_plain(x, w, "rapid10", **kw)
            plain_ms = timer(lambda: log_matmul_plain(x, w, "rapid10", **kw),
                             1 if m > 8 else 2)
            exact_ms = timer(lambda: torch.matmul(x, w), 5)
            nbytes = 4 * (m * k + k * n + m * n * (1 + res + (ep is not None)))
            for depth in DEPTHS:
                got = log_matmul(x, w, "rapid10", spec=at(depth), **kw)
                torch.cuda.synchronize()
                pairs = list(zip(got, ref)) if ep else [(got, ref)]
                err = max(abs_max(a, b) for a, b in pairs)
                ulps = max(ulp_max(a, b) for a, b in pairs)
                ok = ulps <= (2 if act == "silu" else 0)
                ms = timer(lambda: log_matmul(x, w, "rapid10", spec=at(depth),
                                              **kw), 5)
                lib = {} if act or res or ep else {
                    "library_ms": exact_ms,
                    "library": "torch.matmul, f32 with TF32 off (exact, "
                               "no epilogue, no RAPID; never called by "
                               "the port)"}
                record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                       f"{site} M={m} K={k} N={n}"
                       + (f" {act}" if act else "") + (" +res" if res else "")
                       + (" +rms(keep_prenorm)" if ep else "")
                       + f" depth={depth}",
                       err, ulps, ok, ms, plain_ms, nbytes,
                       m * n * k * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                       {"exact_matmul_ms": exact_ms, "products": m * n * k,
                        "depth": depth, **lib})
                del got
            del x, w, r, ref

    # K1 / K7 at starcoder2_7b's sites (LN: no norm tail on wo) at M = 4
    # / 64 / 512, every stage count: wq, wk/wv (4 KV heads of 128), wo
    # and w2 with the residual, bit-equal, and w1 with the tanh gelu
    # epilogue within GELU_ULP (the kernel takes torch's CUDA gelu step
    # for step, its fma written out).  The plain version (thousands of
    # launches) is timed once by the host clock between syncs
    sc_sites = [("wq", SC_D, SC_D, None, False),
                ("wk/wv", SC_D, SC_KV_HEADS * SC_HD, None, False),
                ("wo", SC_D, SC_D, None, True),
                ("w1", SC_D, SC_FF, "gelu", False),
                ("w2", SC_FF, SC_D, None, True)]
    for m in (DECODE_M, CHUNK_M, PREFILL_M):
        for site, k, n, act, res in sc_sites:
            x = randn(m, k)
            w = randn(k, n, std=k ** -0.5)
            r = randn(m, n) if res else None
            kw = dict(activation=act, residual=r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = log_matmul_plain(x, w, "rapid10", **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            exact_ms = timer(lambda: torch.matmul(x, w), 5)
            limit = GELU_ULP if act else 0
            for depth in DEPTHS:
                got = log_matmul(x, w, "rapid10", spec=at(depth), **kw)
                torch.cuda.synchronize()
                ulps = ulp_max(got, ref)
                lib = {} if act or res else {
                    "library_ms": exact_ms,
                    "library": "torch.matmul, f32 with TF32 off (exact, "
                               "no epilogue, no RAPID; never called by "
                               "the port)"}
                record("log_matmul" if depth == 1 else "log_matmul_pipelined",
                       f"starcoder2 {site} M={m} K={k} N={n}"
                       + (f" {act}" if act else "") + (" +res" if res else "")
                       + f" depth={depth}", abs_max(got, ref), ulps,
                       ulps <= limit,
                       timer(lambda: log_matmul(x, w, "rapid10",
                                                spec=at(depth), **kw), 5),
                       plain_ms, 4 * (m * k + k * n + m * n * (1 + res)),
                       m * n * k * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                       {"exact_matmul_ms": exact_ms, "products": m * n * k,
                        "depth": depth, **lib,
                        **({"gelu_ulp_bound": GELU_ULP} if act else {})})
                del got
            del x, w, r, ref

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
    # ragged last slab), and starcoder2_7b's LN divides (4 / 64 / 512
    # rows of 4608), at every stage count (depth >= 2: K8);
    # tolerance: denominators and quotients bit-equal.  Library: torch's
    # f32 rms_norm, a yardstick with an exact divide and no RAPID one
    rms_norm = torch.nn.functional.rms_norm
    for rows, n in [(r, D) for r in (1, DECODE_M, CHUNK_M, 37, PREFILL_M)] + [
            (r, SC_D) for r in (DECODE_M, CHUNK_M, PREFILL_M)]:
        x = randn(rows, n, std=3.0)
        ref, rden = rms_div_plain(x, 1e-6, "rapid9", return_denom=True)
        plain_ms = timer(lambda: rms_div_plain(x, 1e-6, "rapid9"), 3)
        lib = {"library_ms": timer.graph(lambda: rms_norm(x, (n,), eps=1e-6),
                                         100),
               "library": "torch.nn.functional.rms_norm, f32 (exact "
                          "divide, no RAPID; never called by the port)"}
        for depth in DEPTHS:
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

    # K3: prefill attention probabilities, B*H*S rows of T = 128, and a
    # ragged 33 x 130 (n % 4 != 0: 4 B copies); every stage count.
    # Library: F.normalize(e, p=1, eps=floor), e / max(sum e, floor) for
    # e >= 0 with an exact divide
    from repro_torch.kernels.fused_div.ref import SOFTMAX_FLOOR
    normalize = torch.nn.functional.normalize
    s = randn(4 * 32 * 128, 128, std=2.0)
    for e in (torch.exp(s - s.amax(dim=-1, keepdim=True)),
              torch.exp(randn(33, 130))):
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
        valid = (sp <= posv[:, None]) & (sp > posv[:, None] - window)
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
    # 256-slot view out of the [65, 16, 8, 80] bf16 page pool through the
    # page table as block_decode_paged does, slot positions from kv_len,
    # a [4] position vector of distinct depths and one inactive slot
    # (kv_len 0: every slot INT32_MAX, output 0)
    n_pages, ps, pps = 65, 16, 16
    pool_k = randn(n_pages, ps, KV_HEADS, HD).to(torch.bfloat16)
    pool_v = randn(n_pages, ps, KV_HEADS, HD).to(torch.bfloat16)
    table = torch.zeros((B, pps), dtype=torch.long, device=dev)
    table[:3] = (torch.randperm(n_pages - 1, generator=g, device=dev)
                 [:3 * pps] + 1).reshape(3, pps)
    kv_len = torch.tensor([131, 98, 201, 0], dtype=torch.int32, device=dev)
    C = pps * ps
    kg = pool_k[table].reshape(B, C, KV_HEADS, HD)
    vg = pool_v[table].reshape(B, C, KV_HEADS, HD)
    j = torch.arange(C, dtype=torch.int32, device=dev)
    sp = torch.where(j[None] < kv_len[:, None], j[None], 2**31 - 1)
    got = k4_row(f"q=[4,8,4,80] paged view=[4,{C},8,80] bf16 "
                 f"kv_len={kv_len.tolist()}", qf, kg, vg, sp,
                 torch.clamp(kv_len - 1, min=0), window)
    if got[3].any():
        raise AssertionError("flash_decode: the inactive slot attends")
    del pool_k, pool_v, kg, vg

    # K5: the online-softmax combine acc / l of a 64-token prefill chunk
    # (64 x 32 heads rows of head_dim 80; starcoder2_7b's: 64 x 36 heads
    # of 128) and of an 8320-token blockwise prefill, at every stage
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
                     (64 * SC_HEADS, SC_HD)):
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
    integer_and_batched_cases(torch, dev, timer, g, record, at)
    return cases


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


def profiled_step(torch, engine):
    """One ``engine.step()`` under torch.profiler: its wall time in ms,
    the profiler's averages of the kernels the card ran in it, and the
    launch counts before and after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    before = counts_now()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        # warm-up step: the tracer runs, its events are dropped
        torch.ones(1, device=engine.device).add_(1)
        torch.cuda.synchronize()
        prof.step()
        # the window opens here; a tick started at once now and then
        # lost its first kernels to the profiler, one started after a
        # wait did not (PERF.md §6)
        time.sleep(PROFILE_SETTLE_S)
        t0 = time.perf_counter()
        engine.step()
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


def profile_ticks(torch, model, params, cuda_graphs: bool = True):
    """A prefill tick (the first 64-token chunk of a 128-token prompt, no
    slot decoding) and a decode-only tick (one slot) under torch.profiler,
    on a warm process and, on the graph route, on graphs already captured
    (a 2-token request drains first): for each, wall time, the device
    time of its kernels, the device's busy share (kernel time / wall; one
    stream, so kernels never overlap) and the kernels that take most of
    it.  The port's kernels the profiler saw in each tick must number
    the launches its counters gained (on the graph route, the launches
    the capture recorded, which each replay adds): proof that a replay
    ran them."""
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
        wall, kern, before, after = profiled_step(torch, engine)
        # the counters' gain (on the graph route: the capture's record,
        # added per replay) against the kernels the card ran
        seen = {}
        for wrappers, names in PROFILED_KERNELS.items():
            pat = re.compile(r"(?<!\w)(%s)\b" % "|".join(names))
            seen[wrappers] = (
                sum(after[w] - before[w] for w in wrappers),
                sum(e.count for e in kern if pat.search(e.key)))
        if any(c != r for c, r in seen.values()) or not seen[
                ("log_matmul",)][1]:
            raise AssertionError(
                f"profiled {route} {tick} tick: launches counted vs kernels "
                f"the profiler saw: {seen}")
        dev = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
        out[tick] = {"wall_ms": wall, "kernel_ms": dev,
                     "busy": dev / wall if dev else None,
                     "launches_vs_profiled": {
                         "+".join(w): list(v) for w, v in seen.items()},
                     "top": [(e.key[:70], e.count,
                              e.self_device_time_total / 1e3) for e in top]}
        busy = (f"busy {dev / wall:.1%}" if dev else
                "device time not measured (the profiler saw no kernels)")
        log(f"profile {route} {tick} tick: wall {wall:.1f} ms, kernels "
            f"{dev:.1f} ms, {busy}; launches counted = kernels profiled "
            f"{ {'+'.join(w): v[0] for w, v in seen.items()} }; top " + "; ".join(
                f"{k} x{n} {t:.1f} ms" for k, n, t in out[tick]["top"]))
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


def starcoder2_phase(torch, dev):
    """Full-width starcoder2_7b (32 layers, d_model 4608, 36 heads over 4
    KV heads of 128, d_ff 18432, LN, the ungated gelu MLP; RAPID rapid10
    / rapid9, f32 params from a seed, bf16 activations and KV) on the
    graph route: the lockstep engine (4 requests of 96-128 prompt tokens,
    8 greedy tokens, cache_n 256) and the continuous engine (the same 4
    through 4 slots, page 16, chunk 64), each with its launches counted
    from 0 and its peak memory; then a 2-layer full-width copy through
    both engines at the same load, kernels (graph route) vs plain
    (eager): the greedy tokens must agree."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

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

    engine = ServeEngine(model, params, cache_n=256)
    timed = TimedEngine(torch, engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_now()
    dec = step_stats(timed.decode_s)
    n_tok = sum(len(o) for o in out) - len(out)
    rec["lockstep"] = {
        "wall_s": wall, "prefill_ms": timed.prefill_s[0] * 1e3,
        "decode": dec, "decode_tokens_per_s": n_tok / sum(timed.decode_s),
        "decode_tokens_per_s_replays": (n_tok - len(out))
        / sum(timed.decode_s[1:]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "trace_counts": dict(engine.trace_counts),
        "tokens": out}
    r = rec["lockstep"]
    log(f"starcoder2 lockstep: prompts {[len(p) for p in prompts]}, prefill "
        f"{r['prefill_ms']:.1f} ms, decode {dec['n']} steps (the first, "
        f"warm-up and capture, {dec['first_ms']:.1f} ms; the replays mean "
        f"{dec['rest_mean_ms']:.2f} ms = "
        f"{r['decode_tokens_per_s_replays']:.1f} tokens/s; all "
        f"{r['decode_tokens_per_s']:.1f} tokens/s), wall {wall:.2f}s, peak "
        f"{r['peak_gib']:.2f} GiB; traces {engine.trace_counts}; kernels "
        f"{json.dumps(counts)}")
    for i, o in enumerate(out):
        log(f"sreq{i}: {o}")
    if any(len(o) != max_new for o in out) or any(
            not 0 <= t < cfg.padded_vocab for o in out for t in o):
        raise AssertionError(f"starcoder2 lockstep tokens: {out}")
    require_launches("starcoder2 lockstep", counts, LOCKSTEP_KERNELS)
    if engine.trace_counts != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"starcoder2 lockstep traced "
                             f"{engine.trace_counts}")
    del engine, timed

    engine = ContinuousServeEngine(model, params, n_slots=4, max_len=256,
                                   page_size=16, prefill_chunk=64)
    timed = TimedEngine(torch, engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    cout, max_queued, ttft = drain(engine, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_now()
    pf = step_stats(timed.prefill_tick_s)
    dc = step_stats(timed.decode_tick_s)
    n_gen = sum(len(o) for o in cout)
    rec["continuous"] = {
        "wall_s": wall, "tokens_per_s": n_gen / wall, "ttft_s": ttft,
        "prefill_tick": pf, "decode_tick": dc,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "trace_counts": dict(engine.trace_counts),
        "tokens": cout}
    r = rec["continuous"]
    log(f"starcoder2 continuous: 4 slots, page 16, chunk 64; {pf['n']} "
        f"prefill ticks (the first {pf['first_ms']:.1f} ms, the replays mean "
        f"{pf['rest_mean_ms']:.1f}), {dc['n']} decode ticks (the first "
        f"{dc['first_ms']:.1f} ms, the replays mean {dc['rest_mean_ms']:.2f})"
        f"; first token after {ttft * 1e3:.1f} ms; {n_gen} tokens in "
        f"{wall:.2f}s = {n_gen / wall:.2f} tokens/s; peak "
        f"{r['peak_gib']:.2f} GiB; traces {engine.trace_counts}; kernels "
        f"{json.dumps(counts)}")
    if any(len(o) != max_new for o in cout) or any(
            not 0 <= t < cfg.padded_vocab for o in cout for t in o):
        raise AssertionError(f"starcoder2 continuous tokens: {cout}")
    require_launches("starcoder2 continuous", counts, CONTINUOUS_KERNELS,
                     ("softmax_div",))
    if engine.trace_counts != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"starcoder2 continuous traced "
                             f"{engine.trace_counts}")
    if engine.alloc.n_free != engine.geom.usable_pages:
        raise AssertionError("starcoder2 continuous: page leak")
    del engine, timed

    # the 2-layer full-width copy at the main path's load (the same 4
    # prompts, 8 greedy tokens), kernels (graph route) vs plain (eager),
    # through both engines as the main path runs them
    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    engines = {
        "lockstep": (lambda graphs: ServeEngine(Model(cfg2), params2,
                                                cache_n=256,
                                                cuda_graphs=graphs),
                     LOCKSTEP_KERNELS, ()),
        "continuous": (lambda graphs: ContinuousServeEngine(
                           Model(cfg2), params2, n_slots=4, max_len=256,
                           page_size=16, prefill_chunk=64,
                           cuda_graphs=graphs),
                       CONTINUOUS_KERNELS, ("softmax_div",))}
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
        require_launches(f"starcoder2 2-layer {path} kernel run", k_counts,
                         must, must_not)
        require_launches(f"starcoder2 2-layer {path} plain run", p_counts,
                         (), p_counts)
        agree = sum(a == b for x, y in zip(k_tok, p_tok)
                    for a, b in zip(x, y))
        log(f"starcoder2 e2e 2-layer {path}: prompts "
            f"{[len(p) for p in prompts]}; kernels {t_k:.2f}s "
            f"{json.dumps(k_counts)}, plain {t_p:.2f}s; greedy tokens equal "
            f"{agree}/{sum(len(o) for o in p_tok)}")
        if k_tok != p_tok:
            raise AssertionError(f"starcoder2 2-layer {path} greedy tokens "
                                 f"differ:\n{k_tok}\n{p_tok}")
        rec[f"e2e_2layer_{path}"] = {"kernels_s": t_k, "plain_s": t_p,
                                     "launches": k_counts, "tokens": k_tok}
    rec["e2e_2layer_equal"] = True
    del params, params2
    torch.cuda.empty_cache()
    return rec


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
    ``launch/k1_times.py`` at depth 1 and 2 in turns (1, 2, 2, 1), one
    process each.  Information: nothing here fails on a time."""
    from repro_torch.kernels.spec import deferred_depth
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

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

    k1 = []
    for depth in (1, 2, 3, 3, 2, 1):
        k1 += k1_times(["--depth", str(depth)])
    for site in sorted({(r["site"], r["M"]) for r in k1}):
        by = {d: [r["ms"] for r in k1 if (r["site"], r["M"]) == site
                  and r["depth"] == d] for d in (1, 2, 3)}
        log(f"depth A/B k1_times {site[0]} M={site[1]}: depth 1 "
            f"{by[1]} ms, depth 2 {by[2]} ms "
            f"({np.mean(by[2]) / np.mean(by[1]) - 1:+.1%}), depth 3 "
            f"{by[3]} ms ({np.mean(by[3]) / np.mean(by[1]) - 1:+.1%})")
    out["k1_times"] = k1
    out["parent_ab"] = parent_ab()
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
    log(f"parent A/B: parent {parent}")
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


def profile_train_step(torch, step, params, opt, batch):
    """One more train step (after the counted run) under torch.profiler:
    wall time, the device time of its kernels, the device's busy share
    (kernel time / wall; one stream) and the kernels that take most of
    it.  The profiler adds host time per launch, so the wall time here
    is longer than the loop's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch, TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall, "kernel_ms": dev,
           "busy": dev / wall if dev else None,
           "top": [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                   for e in top]}
    busy = (f"busy {dev / wall:.1%}" if dev else
            "device time not measured (the profiler saw no kernels)")
    log(f"profile train step: wall {wall:.1f} ms, kernels {dev:.1f} ms, "
        f"{busy}; top " + "; ".join(f"{k} x{n} {t:.1f} ms"
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
    from repro_torch.kernels import plain_versions, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import make_train_step

    cfg2 = cfg.with_(n_layers=2, remat="none")
    params2 = dict(params, blocks=params["blocks"][:2])
    step = make_train_step(Model(cfg2), OptConfig())[1]
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=1).batch_at(0)
    runs = {}
    for route in ("kernels", "plain"):
        reset_launch_counts()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_versions():
                loss, grads = step.loss_and_grads(params2, batch)
        else:
            loss, grads = step.loss_and_grads(params2, batch)
        torch.cuda.synchronize()
        runs[route] = (float(loss), grads, time.perf_counter() - t0,
                       counts_now())
    (lk, gk, tk, ck), (lp, gp, tp, cp) = runs["kernels"], runs["plain"]
    require_launches("train 2-layer kernel run", ck,
                     ("log_matmul@d2+", "rms_div@d2+", "softmax_div@d2+"))
    require_launches("train 2-layer plain run", cp, (), cp)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk, gp))
    rel = abs(lk - lp) / abs(lp)
    log(f"train 2-layer kernels vs plain: loss {lk!r} vs {lp!r} (rel "
        f"{rel:.2e}), worst gradient leaf max|diff|/max|g| {worst:.2e}; "
        f"kernels {tk:.2f}s {json.dumps(ck)}, plain {tp:.2f}s")
    if rel > 1e-5 or worst > 1e-5:
        raise AssertionError(f"train 2-layer: loss rel {rel}, gradient "
                             f"{worst} beyond 1e-5")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": rel,
            "grad_worst_rel_diff": worst, "kernels_s": tk, "plain_s": tp,
            "launches_kernels": ck}


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
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.kernel_timing import card_line

    t_start = time.perf_counter()
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

    card_tests()
    timer = Timer(torch, dev)
    cases = kernel_phase(torch, dev, timer)
    cfg, params, serve = serve_phase(torch, dev)
    cont = continuous_phase(torch, cfg, params, serve["tokens"])
    long_ = long_prefill_phase(torch, dev, cfg, params)
    ab = depth_ab_phase(torch, cfg, params)
    del params
    # the timed engines sit in reference cycles: collect them, and the
    # graphs' memory pools they hold, before the next phases allocate
    gc.collect()
    torch.cuda.empty_cache()
    sc2 = starcoder2_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    ints = integer_units_phase(torch, dev, ab["parent_ab"].get("table3"))
    apps = apps_phase(torch, dev)
    tcfg, tparams, train = train_phase(torch, dev)
    train_check = train_check_phase(torch, tcfg, tparams)
    del tparams
    torch.cuda.empty_cache()

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
                                       sc2["lockstep"]),
                                      ("starcoder2_continuous",
                                       sc2["continuous"]),
                                      ("integer_units", ints),
                                      ("apps", apps), ("train", train))}
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
              "starcoder2": sc2,
              "integer_units": ints, "apps": apps, "train": train,
              "train_2layer": train_check, "kernels": kernels,
              "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
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
