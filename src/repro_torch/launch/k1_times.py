"""Time kernel K1 (``log_matmul``) at the serve paths' shapes.

    python src/repro_torch/launch/k1_times.py [--src DIR] [--reps N]
        [--depth D ...] [--moe]

On a machine with a CUDA card: builds the kernels of the ``repro_torch``
package found under ``--src`` (default: this checkout's ``src``), times
one K1 call per shape with CUDA events (L2 flushed before each call, as
the serve path meets every weight cold; mean of ``--reps``) and prints
one JSON line per shape with the card's name.  The card sleeps ~0.5 ms
before the first event of each call, so the wrapper's host work is
queued behind it and the events time the device alone.  Pointing
``--src`` at another checkout's ``src`` times that checkout's kernels,
so two versions can be compared in turns inside one process launch each
on the same card (A, B, B, A).  ``--depth`` sets K1's stage count (K
blocks in flight; default: the checkout's own default) where the
checkout's ``log_matmul`` takes a ``spec``; several depths are timed in
the order given, shape by shape.  ``--moe`` times the MoE experts'
batched calls in place of the dense paths' 2-D ones, with the path's
empty capacity slots as rows of zeros (K1 sums those tiles on its full
product path).
"""
from __future__ import annotations

import json
import sys

from kernel_timing import card_line, empty_slots, parse

# rows of K1 on the serve paths: (site, E, M, K, N, activation,
# residual, routed pairs); E = 0 is a 2-D call, M = 4 a decode step, 64
# a continuous prefill tick, 512 the lockstep prefill of 4 x 128 tokens
SHAPES = [("wq", 0, m, 2560, 2560, None, False, None)
          for m in (4, 64, 512)] + [
    ("w1", 0, m, 2560, 6912, "silu", False, None) for m in (4, 64, 512)] + [
    ("w2", 0, m, 6912, 2560, None, True, None) for m in (4, 64, 512)]
MOE_SHAPES = []
# the MoE experts' batched calls: E experts of M = capacity slots, the
# capacity at a decode step of 4 tokens (1), a 64-token prefill chunk
# (5) and the lockstep prefill of 512 tokens (40), for
# qwen3_moe_235b_a22b (128 experts of 4096 x 1536, top-8) and
# llama4_scout_17b_a16e (16 experts of 5120 x 8192, top-1), each with
# the tokens' top-k pairs; the slots they leave empty under even routing
# (``kernel_timing.empty_slots``) are rows of zeros
for _name, _e, _d, _f, _k in (("qwen3", 128, 4096, 1536, 8),
                              ("llama4", 16, 5120, 8192, 1)):
    for _tokens, _cap in ((4, 1), (64, 5), (512, 40)):
        _pairs = _tokens * _k
        MOE_SHAPES += [
                   (f"{_name} w1", _e, _cap, _d, _f, "silu", False, _pairs),
                   (f"{_name} w3", _e, _cap, _d, _f, None, False, _pairs),
                   (f"{_name} w2", _e, _cap, _f, _d, None, False, _pairs)]


def _args(ap):
    ap.add_argument("--depth", type=int, nargs="+", default=[None],
                    help="K blocks in flight, one or several in turn (a "
                         "checkout without stage counts takes only the "
                         "default)")
    ap.add_argument("--moe", action="store_true",
                    help="the MoE experts' batched shapes")


def _at(depth) -> dict:
    """``log_matmul``'s keyword for stage count ``depth`` (None: none)."""
    if depth is None:
        return {}
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    return {"spec": KernelSpec(pipeline=PipelineSpec(depth=depth))}


def main(argv=None) -> int:
    args = parse(__doc__, argv, reps=10, add=_args)
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.log_matmul.ops import log_matmul

    dev = resolve_device("cuda")
    card = card_line()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    for site, e, m, k, n, act, res, pairs in (MOE_SHAPES if args.moe
                                              else SHAPES):
        batch = (e,) if e else ()
        x = torch.randn(batch + (m, k), generator=g, device=dev)
        empty = 0
        if pairs is not None:  # each expert's last slots, pairs spread evenly
            mask = empty_slots(torch, e, m, pairs, dev)
            x[mask] = 0.0
            empty = int(mask.sum())
        w = torch.randn(batch + (k, n), generator=g, device=dev) * k ** -0.5
        r = torch.randn((m, n), generator=g, device=dev) if res else None
        for depth in args.depth:
            kw = _at(depth)
            log_matmul(x, w, "rapid10", activation=act, residual=r,
                       **kw)  # warm
            total = 0.0
            for _ in range(args.reps):
                flush.zero_()
                torch.cuda._sleep(1_000_000)  # covers the wrapper's host time
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                log_matmul(x, w, "rapid10", activation=act, residual=r, **kw)
                b.record()
                b.synchronize()
                total += a.elapsed_time(b)
            print(json.dumps({"src": args.src, "card": card, "site": site,
                              "depth": depth, "E": e, "M": m, "K": k,
                              "N": n, "empty": empty,
                              "ms": total / args.reps}), flush=True)
        del x, w, r
    return 0


if __name__ == "__main__":
    sys.exit(main())
