#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one NVIDIA H100.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a), prints the card's name and power limit, and runs the repo's
   card tests (``tests/test_torch_gpu.py``, special operands included);
2. holds each kernel against its plain PyTorch version on the card at
   the shapes of the main path, timing both with CUDA events, and raises
   on a breach of the stated tolerance;
3. serves full-width h2o_danube_1_8b (24 layers, d_model 2560, random
   weights from a seed) with RAPID arithmetic through ``ServeEngine``:
   4 requests of 96-128 prompt tokens, 16 greedy tokens each, bf16
   activations and KV cache, ``cache_n=512``; every kernel launch count
   is set to 0 just before and read just after, and each must be > 0;
4. serves a 2-layer full-width copy once through the kernels and once
   through the plain versions on the card: the greedy tokens must agree,
   and the launch counts show that the first run launched every kernel
   and the second none.

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
PREFILL_M, DECODE_M = 4 * 128, 4

REPLACES = {
    "log_matmul": "src/repro/kernels/log_matmul/log_matmul.py:302",
    "rms_div": "src/repro/kernels/fused_div/fused_div.py:202",
    "softmax_div": "src/repro/kernels/fused_div/fused_div.py:188",
    "flash_decode": "src/repro/kernels/flash_attn/flash_attn.py:113",
}
SOURCES = {
    "log_matmul": "src/repro_torch/csrc/log_matmul.cu",
    "rms_div": "src/repro_torch/csrc/fused_div.cu",
    "softmax_div": "src/repro_torch/csrc/fused_div.cu",
    "flash_decode": "src/repro_torch/csrc/flash_attn.cu",
}


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


def ulp_max(a, b) -> int:
    ia = a.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    ib = b.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def abs_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
    from repro_torch.kernels.fused_div.ops import (fused_rms_div,
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
        log(f"kernel {kernel:12s} {shape:44s} max_abs={err:.3e} "
            f"max_ulp={ulps} ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
        if not limit_ok:
            raise AssertionError(f"{kernel} {shape}: kernel disagrees with its "
                                 f"plain version (max_abs {err}, {ulps} ulp)")

    # K1 at M = 4 (decode) and M = 512 (prefill) for each (K, N, epilogue)
    # of the path; tolerance: bit-equal, silu <= 2 ulp (CUDA expf)
    rms_tail = be.Epilogue(norm="rms", div_scheme="rapid9", eps=1e-6,
                           keep_prenorm=True)
    k1 = [("wq", D, D, None, False, None), ("wk/wv", D, KV_HEADS * HD, None,
                                            False, None),
          ("wo", D, D, None, True, None), ("wo+ln2", D, D, None, True, rms_tail),
          ("w1", D, D_FF, "silu", False, None), ("w3", D, D_FF, None, False, None),
          ("w2", D_FF, D, None, True, None)]
    for m in (DECODE_M, PREFILL_M):
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

    # K2: decode ln1/ln2/final (4 rows) and prefill ln1 (512 rows);
    # tolerance: denominators and quotients bit-equal
    for rows in (DECODE_M, PREFILL_M):
        x = randn(rows, D, std=3.0)
        got, den = fused_rms_div(x, 1e-6, "rapid9", return_denom=True)
        ref, rden = rms_div_plain(x, 1e-6, "rapid9", return_denom=True)
        torch.cuda.synchronize()
        ulps = max(ulp_max(got, ref), ulp_max(den, rden))
        record("rms_div", f"rows={rows} n={D}", abs_max(got, ref), ulps,
               ulps == 0, timer(lambda: fused_rms_div(x, 1e-6, "rapid9"), 20),
               timer(lambda: rms_div_plain(x, 1e-6, "rapid9"), 3),
               4 * (2 * rows * D), rows * D * 2, FP32_FLOPS_PER_S / 2)

    # K3: prefill attention probabilities, B*H*S rows of T = 128
    s = randn(4 * 32 * 128, 128, std=2.0)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    got, den = fused_softmax_div(e, "rapid9", return_denom=True)
    ref, rden = softmax_div_plain(e, "rapid9", return_denom=True)
    torch.cuda.synchronize()
    ulps = max(ulp_max(got, ref), ulp_max(den, rden))
    record("softmax_div", f"rows={e.shape[0]} n=128", abs_max(got, ref), ulps,
           ulps == 0, timer(lambda: fused_softmax_div(e, "rapid9"), 20),
           timer(lambda: softmax_div_plain(e, "rapid9"), 3),
           4 * 2 * e.numel(), e.numel(), FP32_FLOPS_PER_S / 2)

    # K4: one decode step's attention, 128 prompt + 8 generated tokens in
    # a 512-slot bf16 cache; tolerance rtol/atol 1e-5 (sum orders differ)
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
    ok = bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5))
    live = pos + 1  # slots this step's data needs
    nbytes = (4 * qf.numel() * 2 + 2 * 2 * B * live * KV_HEADS * HD
              + 4 * B * C)
    record("flash_decode", f"q=[4,8,4,80] cache=[4,{C},8,80] bf16 live={live}",
           err, ulp_max(got, ref), ok,
           timer(lambda: flash_decode_attn(qf, kc, vc, sp, pos, window,
                                           "rapid9"), 20),
           timer(lambda: flash_decode_plain(qf, kc, vc, sp, pos, window,
                                            "rapid9"), 5),
           nbytes, 2 * 2 * B * KV_HEADS * G * live * HD, FP32_FLOPS_PER_S)
    return cases


# --------------------------------------------------------------------------
# phases 3 and 4: serving
# --------------------------------------------------------------------------

class TimedModel:
    """The model with host-clock timing around prefill and decode_step
    (synchronised), and a finiteness check on every logits row."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.prefill_s, self.decode_s = [], []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _timed(self, sink, fn, *a):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*a)
        self.torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        if not bool(self.torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
        return logits, cache

    def prefill(self, *a):
        return self._timed(self.prefill_s, self.model.prefill, *a)

    def decode_step(self, *a):
        return self._timed(self.decode_s, self.model.decode_step, *a)


def prompts_for(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(96, 129, 4)]


@contextmanager
def plain_versions():
    """Route the model's four kernel calls to their plain versions (on
    the card), for the end-to-end comparison only."""
    from repro_torch.core import ops
    from repro_torch.kernels.flash_attn.ops import flash_decode_plain
    from repro_torch.kernels.fused_div.ops import (rms_div_plain,
                                                   softmax_div_plain)
    from repro_torch.kernels.log_matmul.ops import log_matmul_plain

    swap = {"log_matmul": log_matmul_plain, "fused_rms_div": rms_div_plain,
            "fused_softmax_div": softmax_div_plain,
            "flash_decode_attn": flash_decode_plain}
    saved = {k: getattr(ops, k) for k in swap}
    for k, v in swap.items():
        setattr(ops, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def serve_phase(torch, dev):
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
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
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

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
    # routes: every kernel in the first, none in the second
    if any(v <= 0 for v in k_counts.values()) or any(p_counts.values()):
        raise AssertionError(f"2-layer runs did not split kernels/plain: "
                             f"kernels {k_counts}, plain {p_counts}")
    agree = sum(a == b for ka, pa in zip(k_tok, p_tok) for a, b in zip(ka, pa))
    log(f"e2e 2-layer: kernels {t_k:.2f}s {json.dumps(k_counts)}, plain "
        f"{t_p:.2f}s {json.dumps(p_counts)}, greedy tokens equal "
        f"{agree}/{sum(len(o) for o in p_tok)}")
    if k_tok != p_tok:
        raise AssertionError(f"2-layer greedy tokens differ:\n{k_tok}\n{p_tok}")
    return {"prefill_ms": timed.prefill_s[0] * 1e3,
            "decode_ms_per_step": dec_s / len(timed.decode_s) * 1e3,
            "decode_tokens_per_s": n_dec / dec_s,
            "decode_steps": len(timed.decode_s), "launches": counts,
            "tokens": out, "e2e_2layer_equal": True}


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
    serve = serve_phase(torch, dev)

    heaviest = {"log_matmul": "w1 M=512", "rms_div": "rows=512",
                "softmax_div": "rows=", "flash_decode": "q="}
    kernels = []
    for name, tag in heaviest.items():
        mine = [c for c in cases if c["kernel"] == name]
        top = next(c for c in mine if c["shape"].startswith(tag))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serve["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shape": top["shape"]})
    record = {"card": card, "cases": cases, "serve": serve,
              "kernels": kernels,
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
