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
   each, bf16 activations and KV cache, ``cache_n=512``; the launch
   counts are set to 0 just before and read just after, and K1-K4 must
   have launched;
4. serves a 2-layer full-width copy once through the kernels and once
   through the plain versions on the card: the greedy tokens must agree,
   and the launch counts show that the first run launched the path's
   kernels and the second none;
5. serves the same model through ``ContinuousServeEngine`` (paged KV,
   chunked prefill, slot recycling): 6 requests of 96-128 prompt tokens,
   16 greedy tokens each, 4 slots, so the queue backs up; K1, K2, K4 and
   K5 must launch, K3 must not, and the page free list must be whole
   after the drain.  The process's first continuous prefill tick is timed
   layer by layer; the same load then runs again on the drained engine
   (warm) and must give the same tokens, and one tick of each kind runs
   under torch.profiler;
6. runs the continuous engine on a 2-layer copy kernels vs plain (the
   greedy tokens must agree), and prefills one 8320-token prompt on a
   2-layer copy, which takes the blockwise attention path (K5) and wraps
   the 4096-slot sliding-window ring cache, then decodes 4 steps; at
   that shape ``_attn_blockwise`` with K5 must equal it with the plain
   K5;
7. drives the paper's integer units (K9 ``rapid_mul``, K10
   ``rapid_div``) through their wrappers as Table III does, at 8 bits
   exhaustively and 2^24 random pairs at 16 (16/8) bits, all four
   schemes, and prints their error beside the paper's (information);
   K9 and K10 must launch;
8. runs the three applications (JPEG, Pan-Tompkins, Harris) under all
   five variants at the reference's QoR sizes, each device stage through
   the kernels and through the plain versions (equal bits required), and
   holds the QoR gates of ``tests/test_apps_qor.py``; then at the timing
   sizes (a 2048^2 frame, a 5-minute ECG record, a 1024^2 scene),
   kernels only, host and device times apart: K1 (batched) and K6 must
   launch.

Step 2 also holds K9/K10 bit-equal to their plain versions (special
operands included) and K1 batched at JPEG's 2048^2 shape, with the
broadcast DCT basis on each side.

It exits non-zero, printing no result, when no CUDA card is present or
when it is run outside a checkout of the repository.  Its last line is
``{"ok": true, "device": {...}}``; the line before holds the per-kernel
record (launches, error, times, bound).  The whole record also goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
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
# fewest int32 ops a RAPID product can take: the LUT index combine and
# the two adds (bits + bits + coefficient); clamps, sign and the f32
# accumulate are extra
INT32_OPS_PER_PRODUCT = 3
FP32_FLOPS_PER_S = 67e12

D, KV_HEADS, G, HD, D_FF = 2560, 8, 4, 80, 6912
# K1's rows: lockstep prefill (4 x 128 tokens), a continuous prefill
# tick (one 64-token chunk) and a decode step (4 tokens)
PREFILL_M, CHUNK_M, DECODE_M = 4 * 128, 64, 4

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

REPLACES = {
    "log_matmul": "src/repro/kernels/log_matmul/log_matmul.py:302",
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
# the blockwise prefill: over _PLAIN_ATTN_MAX_T (8192) tokens and over
# the 4096-token sliding window
LONG_PROMPT = 8320


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing and comparison
# --------------------------------------------------------------------------

class Timer:
    """Mean time of a call by CUDA events, L2 flushed before each run
    (the main path meets every weight cold: no layer repeats)."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()  # warm
        total = 0.0
        for _ in range(reps):
            self.flush_buf.zero_()
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
        them.  ``fn`` must have run once outside the capture."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        g.replay()  # warm
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        del g
        return a.elapsed_time(b) / n


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
        log(f"kernel {kernel:12s} {shape:44s} max_abs={err:.3e} "
            f"max_ulp={ulps} ms={ms:.4f}{call} plain_ms={plain_ms:.3f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
        if not limit_ok:
            raise AssertionError(f"{kernel} {shape}: kernel disagrees with its "
                                 f"plain version (max_abs {err}, {ulps} ulp)")

    # K1 at M = 4 (decode), 64 (continuous prefill tick) and 512
    # (lockstep prefill) for each (K, N, epilogue) of the paths;
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
            got = log_matmul(x, w, "rapid10", **kw)
            ref = log_matmul_plain(x, w, "rapid10", **kw)
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if ep else [(got, ref)]
            err = max(abs_max(a, b) for a, b in pairs)
            ulps = max(ulp_max(a, b) for a, b in pairs)
            ok = ulps <= (2 if act == "silu" else 0)
            ms = timer(lambda: log_matmul(x, w, "rapid10", **kw), 5)
            plain_ms = timer(lambda: log_matmul_plain(x, w, "rapid10", **kw),
                             1 if m > 8 else 2)
            exact_ms = timer(lambda: torch.matmul(x, w), 5)
            nbytes = 4 * (m * k + k * n + m * n * (1 + res + (ep is not None)))
            record("log_matmul", f"{site} M={m} K={k} N={n}"
                   + (f" {act}" if act else "") + (" +res" if res else "")
                   + (" +rms(keep_prenorm)" if ep else ""),
                   err, ulps, ok, ms, plain_ms, nbytes,
                   m * n * k * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
                   {"exact_matmul_ms": exact_ms, "products": m * n * k})
            del x, w, r, got, ref

    # K2: ln1/ln2/final norm of a decode step (4 rows), of a continuous
    # prefill tick (64 rows) and of the lockstep prefill (512 rows);
    # tolerance: denominators and quotients bit-equal
    for rows in (DECODE_M, CHUNK_M, PREFILL_M):
        x = randn(rows, D, std=3.0)
        got, den = fused_rms_div(x, 1e-6, "rapid9", return_denom=True)
        ref, rden = rms_div_plain(x, 1e-6, "rapid9", return_denom=True)
        torch.cuda.synchronize()
        ulps = max(ulp_max(got, ref), ulp_max(den, rden))
        k2 = lambda: fused_rms_div(x, 1e-6, "rapid9")  # noqa: E731
        record("rms_div", f"rows={rows} n={D}", abs_max(got, ref), ulps,
               ulps == 0, timer.graph(k2, 100),
               timer(lambda: rms_div_plain(x, 1e-6, "rapid9"), 3),
               4 * (2 * rows * D), rows * D * 2, FP32_FLOPS_PER_S / 2,
               {"call_ms": timer(k2, 20)})

    # K3: prefill attention probabilities, B*H*S rows of T = 128
    s = randn(4 * 32 * 128, 128, std=2.0)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    got, den = fused_softmax_div(e, "rapid9", return_denom=True)
    ref, rden = softmax_div_plain(e, "rapid9", return_denom=True)
    torch.cuda.synchronize()
    ulps = max(ulp_max(got, ref), ulp_max(den, rden))
    k3 = lambda: fused_softmax_div(e, "rapid9")  # noqa: E731
    record("softmax_div", f"rows={e.shape[0]} n=128", abs_max(got, ref), ulps,
           ulps == 0, timer.graph(k3, 100),
           timer(lambda: softmax_div_plain(e, "rapid9"), 3),
           4 * 2 * e.numel(), e.numel(), FP32_FLOPS_PER_S / 2,
           {"call_ms": timer(k3, 20)})

    # K4: one decode step's attention, 128 prompt + 8 generated tokens in
    # a 512-slot bf16 cache; tolerance: bit-equal (the plain version takes
    # the kernel's steps in its order)
    B, C, pos, window = 4, 512, 135, 4096
    qf = randn(B, KV_HEADS, G, HD, std=HD ** -0.5)
    kc = randn(B, C, KV_HEADS, HD).to(torch.bfloat16)
    vc = randn(B, C, KV_HEADS, HD).to(torch.bfloat16)
    base = torch.arange(C, dtype=torch.int32, device=dev)
    sp = torch.where(base <= pos, base, 2**31 - 1).expand(B, C).contiguous()
    got = flash_decode_attn(qf, kc, vc, sp, pos, window, "rapid9")
    ref = flash_decode_plain(qf, kc, vc, sp, pos, window, "rapid9")
    torch.cuda.synchronize()
    err = abs_max(got, ref)
    ok = same_bits(got, ref)
    live = pos + 1  # slots this step's data needs
    nbytes = (4 * qf.numel() * 2 + 2 * 2 * B * live * KV_HEADS * HD
              + 4 * B * C)
    k4 = lambda: flash_decode_attn(qf, kc, vc, sp, pos, window,  # noqa: E731
                                   "rapid9")
    record("flash_decode", f"q=[4,8,4,80] cache=[4,{C},8,80] bf16 live={live}",
           err, ulp_max(got, ref), ok, timer.graph(k4, 100),
           timer(lambda: flash_decode_plain(qf, kc, vc, sp, pos, window,
                                            "rapid9"), 5),
           nbytes, 2 * 2 * B * KV_HEADS * G * live * HD, FP32_FLOPS_PER_S,
           {"call_ms": timer(k4, 20)})

    # K4 at the continuous decode tick: 4 slots, each gathering its
    # 256-slot view out of the [65, 16, 8, 80] bf16 page pool through the
    # page table as block_decode_paged does, slot positions from kv_len,
    # a [4] position vector of distinct depths and one inactive slot
    # (kv_len 0: every slot INT32_MAX); tolerance: bit-equal
    n_pages, ps, pps = 65, 16, 16
    pool_k = randn(n_pages, ps, KV_HEADS, HD).to(torch.bfloat16)
    pool_v = randn(n_pages, ps, KV_HEADS, HD).to(torch.bfloat16)
    table = torch.zeros((B, pps), dtype=torch.long, device=dev)
    table[:3] = (torch.randperm(n_pages - 1, generator=g, device=dev)
                 [:3 * pps] + 1).reshape(3, pps)
    kv_len = torch.tensor([131, 98, 201, 0], dtype=torch.int32, device=dev)
    posv = torch.clamp(kv_len - 1, min=0)
    C = pps * ps
    kg = pool_k[table].reshape(B, C, KV_HEADS, HD)
    vg = pool_v[table].reshape(B, C, KV_HEADS, HD)
    j = torch.arange(C, dtype=torch.int32, device=dev)
    sp = torch.where(j[None] < kv_len[:, None], j[None], 2**31 - 1)
    got = flash_decode_attn(qf, kg, vg, sp, posv, window, "rapid9")
    ref = flash_decode_plain(qf, kg, vg, sp, posv, window, "rapid9")
    torch.cuda.synchronize()
    ok = same_bits(got, ref) and not bool(got[3].any())
    live = int(kv_len.sum())
    k4p = lambda: flash_decode_attn(qf, kg, vg, sp, posv,  # noqa: E731
                                    window, "rapid9")
    record("flash_decode", f"q=[4,8,4,80] paged view=[4,{C},8,80] bf16 "
           f"kv_len={kv_len.tolist()}", abs_max(got, ref), ulp_max(got, ref),
           ok, timer.graph(k4p, 100),
           timer(lambda: flash_decode_plain(qf, kg, vg, sp, posv, window,
                                            "rapid9"), 5),
           4 * qf.numel() * 2 + 2 * 2 * live * KV_HEADS * HD + 4 * B * (C + 1),
           2 * 2 * KV_HEADS * G * live * HD, FP32_FLOPS_PER_S,
           {"call_ms": timer(k4p, 20)})
    del pool_k, pool_v, kg, vg

    # K5: the online-softmax combine acc / l of a 64-token prefill chunk
    # (64 x 32 heads rows of head_dim 80) and of an 8320-token blockwise
    # prefill; K6 at 2048 x 2048.  Special operands (0, -0, +-inf, NaN,
    # subnormals, the overflow edge) head every operand; tolerance:
    # bit-equal, NaN payloads aside.  Bound: bytes (each operand read
    # once, the output written once), ops = 3 int32 ops per divide.
    specials = torch.tensor(
        [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40,
         -1e-42, 3.4e38, -3.4e38, 1e-38, 2.0**64, 2.0**-64], device=dev)
    edge = torch.tensor([0x7F7FFFFF, 0x7F7FFFFE, 0x00800000, 0x00800001],
                        dtype=torch.int32, device=dev).view(torch.float32)
    special = torch.cat([specials, edge])

    def with_specials(t):
        t.view(-1)[:special.numel()] = special
        return t

    for rows in (64 * 32, LONG_PROMPT * 32):
        a = with_specials(randn(rows, HD))
        b = with_specials(randn(rows).abs() * 40 + 1)
        got = div_rowbcast(a, b, "rapid9")
        ref = div_rowbcast_plain(a, b, "rapid9")
        torch.cuda.synchronize()
        ok = same_bits(got, ref)
        fin = torch.isfinite(ref)
        k5 = lambda: div_rowbcast(a, b, "rapid9")  # noqa: E731
        record("div_rowbcast", f"a=[{rows},{HD}] b=[{rows}]",
               abs_max(got[fin], ref[fin]), 0 if ok else -1, ok,
               timer.graph(k5, 200 if rows < 10**5 else 20),
               timer(lambda: div_rowbcast_plain(a, b, "rapid9"), 3),
               4 * (2 * rows * HD + rows), 3 * rows * HD, INT32_OPS_PER_S,
               {"call_ms": timer(k5, 20)})
        del a, b, got, ref
    a = with_specials(randn(2048, 2048))
    b = with_specials(randn(2048, 2048))
    got = div_elementwise(a, b, "rapid9")
    ref = div_plain(a, b, "rapid9")
    torch.cuda.synchronize()
    ok = same_bits(got, ref)
    fin = torch.isfinite(ref)
    k6 = lambda: div_elementwise(a, b, "rapid9")  # noqa: E731
    record("div", "a=b=[2048,2048]", abs_max(got[fin], ref[fin]),
           0 if ok else -1, ok, timer.graph(k6, 50),
           timer(lambda: div_plain(a, b, "rapid9"), 3),
           4 * 3 * a.numel(), 3 * a.numel(), INT32_OPS_PER_S,
           {"call_ms": timer(k6, 20)})
    del a, b, got, ref
    integer_and_batched_cases(torch, dev, timer, g, record)
    return cases


def integer_and_batched_cases(torch, dev, timer, g, record):
    """K9 / K10 against their plain versions, bit for bit: every pair of
    8-bit operands, then 2^24 random pairs (K9 at 16 bits; K10 with a 16-
    and b 8-bit), each headed by the special operands (0 on either side
    and both, 1, the largest values, a < b, the divider's b = 0).  Then K1
    batched at JPEG's 2048^2 frame, [65536, 8, 8] @ [65536, 8, 8], with
    the DCT basis broadcast (stride 0) on each side in turn.  Bound:
    bytes (two int32 operands in, one int64 result out per pair)."""
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
        a, b = pairs(a_bits or 8, n_bits, n)
        got = fn(a, b, scheme, n_bits)
        ref = plain(a, b, scheme, n_bits)
        torch.cuda.synchronize()
        ok = bool(torch.equal(got, ref))
        err = float((got - ref).abs().max())
        k = lambda: fn(a, b, scheme, n_bits)  # noqa: E731
        m = a.numel()
        record(name, f"pairs={m} {scheme} n_bits={n_bits}"
               + (" a<2^16" if name == "rapid_div" and n else "")
               + (" exhaustive 8-bit" if n is None else ""),
               err, 0 if ok else -1, ok,
               timer.graph(k, 50 if n is None else 10),
               timer(lambda: plain(a, b, scheme, n_bits), 2),
               m * (4 + 4 + 8), m * INT32_OPS_PER_UNIT, INT32_OPS_PER_S,
               {"call_ms": timer(k, 10)})
        del a, b, got, ref

    c = torch.randn((8, 8), generator=g, device=dev)
    blocks = torch.randn((JPEG_BLOCKS, 8, 8), generator=g, device=dev) * 40
    for side in ("x", "w"):
        x = c.expand(JPEG_BLOCKS, 8, 8) if side == "x" else blocks
        w = blocks if side == "x" else c.T.contiguous().expand(
            JPEG_BLOCKS, 8, 8)
        got = log_matmul(x, w, "rapid10")
        ref = log_matmul_plain(x, w, "rapid10")
        torch.cuda.synchronize()
        ok = same_bits(got, ref)
        k1b = lambda: log_matmul(x, w, "rapid10")  # noqa: E731
        record("log_matmul", f"batched [{JPEG_BLOCKS},8,8]@[{JPEG_BLOCKS},8,8]"
               f" {side} broadcast (JPEG 2048^2 DCT)", abs_max(got, ref),
               ulp_max(got, ref), ok, timer.graph(k1b, 20),
               timer(lambda: log_matmul_plain(x, w, "rapid10"), 2),
               4 * (64 + 2 * JPEG_BLOCKS * 64),
               JPEG_BLOCKS * 512 * INT32_OPS_PER_PRODUCT, INT32_OPS_PER_S,
               {"call_ms": timer(k1b, 10), "products": JPEG_BLOCKS * 512})


# --------------------------------------------------------------------------
# phases 3 and 4: serving
# --------------------------------------------------------------------------

class TimedModel:
    """The model with host-clock timing around prefill, decode_step and
    decode_paged (synchronised; paged calls sorted into prefill ticks,
    S > 1, and decode ticks), and a finiteness check on every logits row
    that a request reads.  With ``probe`` set, the first paged call runs
    under :func:`tick_probe`."""

    def __init__(self, torch, model, probe: bool = False):
        self.torch, self.model = torch, model
        self.prefill_s, self.decode_s = [], []
        self.prefill_tick_s, self.decode_tick_s = [], []
        self.probe = {} if probe else None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _timed(self, sink, fn, *a, rows=None):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.probe == {} and fn == self.model.decode_paged:
            with tick_probe(self.torch, self.probe):
                logits, cache = fn(*a)
        else:
            logits, cache = fn(*a)
        self.torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        read = logits if rows is None else logits[rows]
        if not bool(self.torch.isfinite(read).all()):
            raise AssertionError("non-finite logits")
        return logits, cache

    def prefill(self, *a):
        return self._timed(self.prefill_s, self.model.prefill, *a)

    def decode_step(self, *a):
        return self._timed(self.decode_s, self.model.decode_step, *a)

    def decode_paged(self, params, tokens, cache, page_table, offsets,
                     n_valid):
        sink = self.prefill_tick_s if tokens.shape[1] > 1 else \
            self.decode_tick_s
        return self._timed(sink, self.model.decode_paged, params, tokens,
                           cache, page_table, offsets, n_valid,
                           rows=n_valid > 0)


@contextmanager
def tick_probe(torch, out: dict):
    """Where a paged tick spends its time, at next to no cost to it: the
    host clock and a CUDA event after each layer (recording an event does
    not block the host; the wrapper adds ~10 us a layer) and the caching
    allocator's cudaMalloc calls and OOM retries around the tick.  A
    layer whose host time is long while the device waited on it stalled
    on the host (module loading, allocation); one whose device time is
    long ran long on the card.  Fills ``out``."""
    from repro_torch.models import model as model_mod

    orig = model_mod.block_decode_paged
    marks = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return time.perf_counter(), ev

    def block(*a, **k):
        res = orig(*a, **k)
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


def serve_phase(torch, dev):
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import (launch_counts, plain_versions,
                                     reset_launch_counts)
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
    timed = TimedModel(torch, model)
    engine = ServeEngine(timed, params, cache_n=512)
    prompts = prompts_for(cfg.vocab_size)
    max_new = 16

    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    n_dec = sum(len(o) for o in out) - len(out)  # tokens after the first
    dec_s = sum(timed.decode_s)
    log(f"serve: prompts {[len(p) for p in prompts]}, prefill "
        f"{timed.prefill_s[0] * 1e3:.1f} ms, decode {len(timed.decode_s)} "
        f"steps {dec_s * 1e3:.1f} ms ({n_dec / dec_s:.1f} tokens/s, "
        f"{dec_s / len(timed.decode_s) * 1e3:.2f} ms/step), wall {wall:.2f}s")
    log("kernels " + json.dumps(counts))
    for i, o in enumerate(out):
        log(f"req{i}: {o}")
    if any(len(o) != max_new for o in out):
        raise AssertionError(f"expected {max_new} tokens per request")
    if any(not 0 <= t < cfg.padded_vocab for o in out for t in o):
        raise AssertionError("token outside the vocabulary")
    require_launches("lockstep serve", counts, LOCKSTEP_KERNELS)

    # the path end to end: 2-layer full-width copy, kernels vs plain
    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    eng2 = ServeEngine(Model(cfg2), params2, cache_n=512)
    reset_launch_counts()
    t0 = time.perf_counter()
    k_tok = eng2.generate(prompts, max_new=max_new)
    t_k = time.perf_counter() - t0
    k_counts = launch_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    with plain_versions():
        p_tok = eng2.generate(prompts, max_new=max_new)
    t_p = time.perf_counter() - t0
    p_counts = launch_counts()
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
        "prefill_ms": timed.prefill_s[0] * 1e3,
        "decode_ms_per_step": dec_s / len(timed.decode_s) * 1e3,
        "decode_tokens_per_s": n_dec / dec_s,
        "decode_steps": len(timed.decode_s), "launches": counts,
        "tokens": out, "e2e_2layer_equal": True}


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


def profile_ticks(torch, model, params):
    """A prefill tick (the first 64-token chunk of a 128-token prompt, no
    slot decoding) and a decode-only tick (one slot) under torch.profiler,
    on a warm process: for each, wall time, the device time of its
    kernels, the device's busy share (kernel time / wall; one stream, so
    kernels never overlap) and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.scheduler import ContinuousServeEngine

    engine = ContinuousServeEngine(model, params, n_slots=4, max_len=256,
                                   page_size=16, prefill_chunk=64)
    prompt = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, 128).tolist()
    rid = engine.submit(prompt, 16)
    out = {}
    # the first tick prefills chunk 1, the second chunk 2 and decodes the
    # first token, the third only decodes
    for tick in ("prefill", "mixed", "decode"):
        torch.cuda.synchronize()
        if tick == "mixed":
            engine.step()
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
        out[tick] = {"wall_ms": wall, "kernel_ms": dev,
                     "busy": dev / wall if dev else None,
                     "top": [(e.key[:70], e.count,
                              e.self_device_time_total / 1e3) for e in top]}
        busy = (f"busy {dev / wall:.1%}" if dev else
                "device time not measured (the profiler saw no kernels)")
        log(f"profile {tick} tick: wall {wall:.1f} ms, kernels {dev:.1f} ms, "
            f"{busy}; top " + "; ".join(f"{k} x{n} {t:.1f} ms"
                                        for k, n, t in out[tick]["top"]))
    engine.cancel(rid)
    return out


def continuous_phase(torch, cfg, params, lockstep_out):
    """Full-width continuous serving (paged KV, chunked prefill, slot
    recycling): the process's first run, whose first prefill tick is
    probed layer by layer; the same load again on the drained engine
    (warm); a profile of one tick of each kind; then the 2-layer
    kernels-vs-plain comparison."""
    from repro_torch.kernels import (launch_counts, plain_versions,
                                     reset_launch_counts)
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

    timed = TimedModel(torch, Model(cfg), probe=True)
    engine = ContinuousServeEngine(timed, params, n_slots=4, max_len=256,
                                   page_size=16, prefill_chunk=64)
    pool_mb = sum(t.numel() * t.element_size()
                  for t in _leaves(engine.cache)) / 2**20
    prompts = prompts_for(cfg.vocab_size, n_extra=2)
    max_new = 16

    serve_runs = []
    for run in ("cold", "warm"):
        n_pf, n_dc = len(timed.prefill_tick_s), len(timed.decode_tick_s)
        if run == "cold":
            reset_launch_counts()
        t0 = time.perf_counter()
        out, max_queued, ttft = drain(engine, prompts, max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if run == "cold":
            counts = launch_counts()
        pf, dc = timed.prefill_tick_s[n_pf:], timed.decode_tick_s[n_dc:]
        n_gen = sum(len(o) for o in out)
        serve_runs.append({
            "run": run, "wall_s": wall, "tokens_per_s": n_gen / wall,
            "ttft_s": ttft, "prefill_ticks": len(pf),
            "prefill_tick_ms": np.mean(pf) * 1e3, "decode_ticks": len(dc),
            "decode_tick_ms": np.mean(dc) * 1e3,
            "prefill_tick_ms_each": [t * 1e3 for t in pf],
            "decode_tick_ms_each": [t * 1e3 for t in dc],
            "longest_queue": max_queued, "tokens": out})
        log(f"continuous {run}: {len(prompts)} requests "
            f"{[len(p) for p in prompts]}, n_slots 4, page 16, "
            f"{engine.geom.n_pages} pages ({pool_mb:.1f} MiB of pools), "
            f"prefill_chunk 64; longest queue {max_queued}; {len(pf)} "
            f"prefill ticks (mean {np.mean(pf) * 1e3:.1f} ms: the first "
            f"{pf[0] * 1e3:.1f}, the rest median {np.median(pf[1:]) * 1e3:.1f}"
            f"), {len(dc)} decode ticks (mean {np.mean(dc) * 1e3:.2f} ms: the "
            f"first {dc[0] * 1e3:.1f}, the rest median "
            f"{np.median(dc[1:]) * 1e3:.2f}); first token after "
            f"{ttft * 1e3:.1f} ms; {n_gen} tokens in {wall:.2f}s wall = "
            f"{n_gen / wall:.2f} tokens/s")
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
    cold, warm = serve_runs
    out = cold["tokens"]
    probe = timed.probe
    slow = [(i, round(h, 1), round(d, 1)) for i, (h, d) in
            enumerate(zip(probe["host_ms"], probe["device_ms"])) if d > 50]
    log(f"continuous cold first prefill tick: "
        f"{cold['prefill_tick_ms_each'][0]:.1f} ms; per layer host ms median {np.median(probe['host_ms'][:-1]):.2f}, "
        f"device ms median {np.median(probe['device_ms'][:-1]):.2f}; segments "
        f"over 50 ms (index, host ms, device ms; index {cfg.n_layers} is the "
        f"head) {slow}; cudaMalloc calls {probe['num_device_alloc']}, "
        f"cudaFree calls {probe['num_device_free']}, allocator OOM retries "
        f"{probe['num_alloc_retries']}")
    log("kernels " + json.dumps(counts))
    for i, o in enumerate(out):
        log(f"creq{i}: {o}")
    require_launches("continuous serve", counts, CONTINUOUS_KERNELS,
                     ("softmax_div",))
    # the warm run reuses pages the cold run wrote: stale KV must not leak
    # into a new request
    if warm["tokens"] != out:
        raise AssertionError(f"warm rerun's tokens differ:\n{out}\n"
                             f"{warm['tokens']}")
    prof = profile_ticks(torch, Model(cfg), params)

    # information, not a gate: each of the 4 lockstep prompts alone
    # through the lockstep engine (the batch run left-pads them); bf16
    # rounds differently on the two paths (fused ln2 tail vs a separate
    # norm, softmax-then-PV vs PV-then-divide)
    alone = [ServeEngine(Model(cfg), params, cache_n=256).generate(
        [p], max_new=4)[0] for p in prompts[:4]]
    agree = sum(a == b for x, y in zip(alone, out) for a, b in zip(x, y))
    log(f"continuous vs lockstep (each prompt alone, first 4 tokens): "
        f"{agree}/16 equal; lockstep batch run's first tokens "
        f"{[o[0] for o in lockstep_out]}, continuous "
        f"{[o[0] for o in out[:4]]}")

    # 2-layer full-width copy, kernels vs plain: 4 requests of 40-70
    # tokens through 2 slots (admission waits) in 32-token chunks (2-3
    # chunks per prompt)
    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    rng = np.random.default_rng(1)
    prompts2 = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                for n in rng.integers(40, 71, 4)]
    runs = {}
    for route in ("kernels", "plain"):
        t2 = TimedModel(torch, Model(cfg2))
        eng2 = ContinuousServeEngine(t2, params2, n_slots=2, max_len=128,
                                     page_size=16, prefill_chunk=32)
        reset_launch_counts()
        t0 = time.perf_counter()
        if route == "plain":
            with plain_versions():
                toks, q2, _ = drain(eng2, prompts2, 8)
        else:
            toks, q2, _ = drain(eng2, prompts2, 8)
        runs[route] = (toks, time.perf_counter() - t0, launch_counts(),
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
    return {"cold": cold, "warm": warm, "first_tick_probe": probe,
            "launches": counts, "profile": prof,
            "lockstep_alone_agree": agree, "e2e_2layer_equal": True}


def long_prefill_phase(torch, dev, cfg, params):
    """An 8320-token prompt on a 2-layer full-width copy: blockwise
    attention (K5) and a wrapped 4096-slot ring cache, then 4 decode
    steps; and ``_attn_blockwise`` at that shape, K5 vs its plain
    version."""
    from repro_torch.kernels import (launch_counts, plain_versions,
                                     reset_launch_counts)
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine

    cfg2 = cfg.with_(n_layers=2)
    params2 = dict(params, blocks=params["blocks"][:2])
    timed = TimedModel(torch, Model(cfg2))
    engine = ServeEngine(timed, params2, cache_n=LONG_PROMPT + 5)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, LONG_PROMPT).tolist()
    reset_launch_counts()
    out = engine.generate([prompt], max_new=5)[0]  # prefill + 4 decode steps
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"long prefill: {LONG_PROMPT} tokens, 2 layers, window "
        f"{cfg.sliding_window} (ring cache wraps): prefill "
        f"{timed.prefill_s[0] * 1e3:.1f} ms, {len(timed.decode_s)} decode "
        f"steps mean {np.mean(timed.decode_s) * 1e3:.2f} ms; tokens {out}; "
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
    n_k5 = launch_counts()["div_rowbcast"]
    diff = abs_max(got, ref)
    log(f"long prefill: _attn_blockwise [1,{LONG_PROMPT},8,4,80] bf16, K5 "
        f"vs plain K5: max abs diff {diff!r} (K5 launches {n_k5})")
    if n_k5 != 1 or diff != 0.0:
        raise AssertionError(f"_attn_blockwise K5 vs plain: diff {diff}, "
                             f"{n_k5} K5 launches")
    return {"prefill_ms": timed.prefill_s[0] * 1e3,
            "decode_ms_per_step": float(np.mean(timed.decode_s)) * 1e3,
            "launches": counts, "tokens": out, "blockwise_k5_vs_plain": diff}


# --------------------------------------------------------------------------
# phases 7 and 8: the paper's integer units and its three applications
# --------------------------------------------------------------------------

def integer_units_phase(torch, dev):
    """The integer units' own path, as the paper's Table III uses them:
    K9 at 8 bits (every pair of nonzero operands) and 16 bits (2^24
    random nonzero pairs), K10 at 8/4 (every a < 256, 0 < b < 16) and
    16/8 (2^24 random pairs), all four schemes each, through the
    wrappers; the launch counts are set to 0 just before and read just
    after.  Information, not a gate: the mean (ARE) and peak (PRE)
    relative error of the integer outputs against the exact product, and
    against the exact quotient where it is at least 1, beside the
    paper's fixed-point figures."""
    from repro_torch.core import schemes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rapid_div.ops import rapid_div
    from repro_torch.kernels.rapid_mul.ops import rapid_mul

    g = torch.Generator(device=dev).manual_seed(99)

    def operands(a_bits, b_bits, n):
        if n is None:
            a = torch.arange(1, 1 << a_bits, device=dev)
            b = torch.arange(1, 1 << b_bits, device=dev)
            return (a.repeat_interleave(b.numel()).int(),
                    b.repeat(a.numel()).int())
        return (torch.randint(1, 1 << a_bits, (n,), generator=g, device=dev,
                              dtype=torch.int32),
                torch.randint(1, 1 << b_bits, (n,), generator=g, device=dev,
                              dtype=torch.int32))

    rows = []
    reset_launch_counts()
    t0 = time.perf_counter()
    for kind, n_bits, n in (("mul", 8, None), ("mul", 16, INT_PAIRS),
                            ("div", 4, None), ("div", 8, INT_PAIRS)):
        a, b = operands(2 * n_bits if kind == "div" else n_bits, n_bits, n)
        exact = (a.double() * b.double() if kind == "mul"
                 else a.double() / b.double())
        keep = exact >= 1.0
        table = schemes.MUL_SCHEMES if kind == "mul" else schemes.DIV_SCHEMES
        paper = PAPER_MUL if kind == "mul" else PAPER_DIV
        for name in table:
            out = (rapid_mul if kind == "mul" else rapid_div)(a, b, name,
                                                              n_bits)
            re = (out.double()[keep] / exact[keep] - 1.0).abs() * 100.0
            row = {"op": kind, "n_bits": n_bits, "scheme": name,
                   "pairs": int(keep.sum()), "are_pct": float(re.mean()),
                   "pre_pct": float(re.max()),
                   "paper_are_pct": paper[(name, n_bits)][0],
                   "paper_pre_pct": paper[(name, n_bits)][1]}
            rows.append(row)
            log(f"int accuracy {kind} n_bits={n_bits:2d} {name:8s} "
                f"ARE {row['are_pct']:.3f}% PRE {row['pre_pct']:.2f}% over "
                f"{row['pairs']} pairs (paper Table III {row['paper_are_pct']}"
                f"% / {row['paper_pre_pct']}%: fixed-point outputs; these are "
                "the units' truncated integer outputs, so they differ)")
        del a, b, exact, keep
    torch.cuda.synchronize()
    counts = launch_counts()
    require_launches("integer units", counts, ("rapid_mul", "rapid_div"))
    log(f"integer units: {time.perf_counter() - t0:.1f}s, kernels "
        f"{json.dumps(counts)}")
    return {"accuracy": rows, "launches": counts}


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
    from repro_torch.kernels import (launch_counts, plain_versions,
                                     reset_launch_counts)

    names = list(VARIANTS)
    qor_counts = {}

    def both(fn, what):
        """fn() through the kernels (counted) and the plain versions (no
        launch); the two must be bit-equal."""
        reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            qor_counts[k] = qor_counts.get(k, 0) + v
        reset_launch_counts()
        with plain_versions():
            ref = fn()
        torch.cuda.synchronize()
        if any(launch_counts().values()):
            raise AssertionError(f"{what}: the plain route launched "
                                 f"{launch_counts()}")
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
    counts = launch_counts()
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

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(p.name for p in _build.BUILD_DIR.glob('*.so'))} in "
        f"{time.perf_counter() - t0:.1f}s")
    for f in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in f.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {f.stem}: {line.strip()}")

    card_tests()
    timer = Timer(torch, dev)
    cases = kernel_phase(torch, dev, timer)
    cfg, params, serve = serve_phase(torch, dev)
    cont = continuous_phase(torch, cfg, params, serve["tokens"])
    long_ = long_prefill_phase(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    ints = integer_units_phase(torch, dev)
    apps = apps_phase(torch, dev)

    # each kernel's row: its time at the main paths' heaviest shape (K5:
    # the chunked-prefill tick's), its launches summed over the paths'
    # runs (the two serve paths, the integer units' own path, the apps),
    # each read just after that run
    heaviest = {"log_matmul": "w1 M=512", "rms_div": "rows=512",
                "softmax_div": "rows=", "flash_decode": "q=",
                "div_rowbcast": "a=[2048,", "div": "a=b=",
                "rapid_mul": f"pairs={INT_PAIRS} rapid10 n_bits=16",
                "rapid_div": f"pairs={INT_PAIRS} rapid9 n_bits=8"}
    kernels = []
    for name, tag in heaviest.items():
        mine = [c for c in cases if c["kernel"] == name]
        top = next(c for c in mine if c["shape"].startswith(tag))
        by_path = {path: runs["launches"][name] for path, runs in (
            ("lockstep", serve), ("continuous", cont),
            ("integer_units", ints), ("apps", apps))}
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shape": top["shape"],
            "launches_by_path": by_path}
        kernels.append(row)
    record = {"card": card, "cases": cases, "serve": serve,
              "continuous": cont, "long_prefill": long_,
              "integer_units": ints, "apps": apps, "kernels": kernels,
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
