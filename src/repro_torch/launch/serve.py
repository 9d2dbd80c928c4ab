"""Serving launcher: batched generation with optional RAPID arithmetic.

``python -m repro_torch.launch.serve --arch h2o_danube_1_8b --approx``
(add ``--continuous`` for the continuous-batching engine: paged KV,
chunked prefill, slot recycling).  ``--arch`` takes every config of the
port, starcoder2_7b (LN, the ungated gelu MLP), the hybrid
jamba_1_5_large_398b and the ssm xlstm_350m included; those two serve
through the lockstep engine only (``--continuous`` raises
``ValueError``, as the reference's continuous engine does: their
recurrent state is not paged).  The encdec family (whisper_medium) is
refused, as the reference's launcher refuses it: its batches carry the
frontend's embeddings, which no engine passes (drive ``Model.prefill``
and ``Model.decode_step`` instead).

Runs on the card (``--device cuda``, the default) with the CUDA kernels,
its decode steps (and the continuous engine's prefill ticks) captured
as CUDA graphs, or on the CPU with their plain versions (``--device
cpu``; use ``--reduced`` there).  Weights are a seeded random init.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, RAPID, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousServeEngine


def check_servable(cfg) -> None:
    """The engines serve token prompts: refuse the families whose batches
    need a frontend's embeddings (encdec, vlm), as the reference's
    launcher does."""
    if cfg.family in ("encdec", "vlm"):
        raise ValueError("serve demo targets pure-text archs (frontend "
                         f"stubs need batches); {cfg.name} is {cfg.family}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--approx", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: paged KV + chunked prefill "
                         "+ slot recycling (repro_torch.serve.scheduler)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.approx:
        cfg = cfg.with_(approx=RAPID)
    check_servable(cfg)
    dev = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(0, dev)
    if args.continuous:
        engine = ContinuousServeEngine(model, params, n_slots=args.batch,
                                       max_len=args.cache,
                                       temperature=args.temperature)
    else:
        engine = ServeEngine(model, params, cache_n=args.cache,
                             temperature=args.temperature)
    prompts = [[1 + (i + j) % 32 for j in range(5 + i)]
               for i in range(args.batch)]
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in out)
    for i, o in enumerate(out):
        print(f"req{i}: {o}")
    mode = "continuous" if args.continuous else "fixed-slot"
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s on {dev}, "
          f"{mode}, approx={'RAPID' if args.approx else 'exact'}); traces "
          f"{engine.trace_counts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
