"""Time the dividers (K2/K3/K5 at depth 1, K8, K6) at the paths' shapes.

    python src/repro_torch/launch/k8_times.py [--src DIR] [--reps N]
        [--depths 1 2 3]

On a machine with a CUDA card: builds the kernels of the ``repro_torch``
package found under ``--src`` (default: this checkout's ``src``) and
times the row dividers, RAPID arm (rapid9), where h2o_danube_1_8b's
paths launch them:

* rms over 1, 4, 64 and 512 rows of 2560 (the final norm of one row,
  a decode step's ln1 / ln2 / final norm, a continuous prefill tick's,
  the lockstep prefill's and a train step's), and over 4 rows of 40 000
  (too wide for two slabs: the deferred depth falls back to 1, where
  K2 streams the row past what a thread holds);
* softmax over 16384 rows of 128 (prefill attention's probabilities)
  and over 33 rows of 130 (a ragged edge: 4 B copies);
* the row broadcast ``a [M, 80] / b [M]`` at 2048 rows (the
  online-softmax combine of a 64-token chunk) and 266240 rows (of an
  8320-token blockwise prefill), and both with ``a`` 4 B past a 16 B
  boundary (``+4B``: the combine hands K5 a view of the caller's
  tensor);
* the elementwise divide K6 (no stage count: depth 1) where the apps
  launch it: 2048 x 2048 (JPEG's quantization of a 2048^2 frame, 65 536
  blocks of 64), 1024 x 1024 (Harris's response) and 59 498 samples
  (Pan-Tompkins's window mean over a 5-minute record), and 2048 x 2048
  with both operands 4 B past a 16 B boundary.

Each shape is timed at every stage count of ``--depths`` that its
block fits (the checkout's own ``row_geometry`` and shared-memory
limit): depth 1 is K2 / K3 / K5, depth >= 2 is K8, through the public
wrappers with an explicit depth and the checkout's own geometry.  At
depth 1 the row broadcast and K6 also time one exact PyTorch call on
the same operands, ``a / b[:, None]`` and ``a / b`` (``library_ms``): a
yardstick the port never calls.
Device time per call by CUDA-graph replay of CALLS launches (the
wrapper's host path costs more than the small kernels, so it is kept
out; a fifth of them past 10**7 elements), the mean of ``--reps``
replays; one JSON line per shape and depth with the card's name.
Pointing ``--src`` at another checkout's ``src`` times that checkout's
kernels, so two versions can be compared in turns on one card (A, B,
B, A).
"""
from __future__ import annotations

import json
import sys

from kernel_timing import card_line, graph_ms, parse

D, HD, EPS = 2560, 80, 1e-6
CALLS = 100
# (name, op, rows, n, elements a start lies past a 16 B boundary); the
# long prefill's combine: 8320 tokens x 32 heads
SHAPES = [("rms 1x2560", "rms", 1, D, 0), ("rms 4x2560", "rms", 4, D, 0),
          ("rms 64x2560", "rms", 64, D, 0),
          ("rms 512x2560", "rms", 512, D, 0),
          ("rms 4x40000", "rms", 4, 40_000, 0),
          ("softmax 16384x128", "softmax", 16384, 128, 0),
          ("softmax 33x130", "softmax", 33, 130, 0),
          ("rowbcast 2048x80", "rowbcast", 2048, HD, 0),
          ("rowbcast 266240x80", "rowbcast", 8320 * 32, HD, 0),
          ("rowbcast 2048x80 +4B", "rowbcast", 2048, HD, 1),
          ("rowbcast 266240x80 +4B", "rowbcast", 8320 * 32, HD, 1),
          ("div 2048x2048", "div", 2048, 2048, 0),
          ("div 1024x1024", "div", 1024, 1024, 0),
          ("div 59498", "div", 1, 59498, 0),
          ("div 2048x2048 +4B", "div", 2048, 2048, 1)]


def main(argv=None) -> int:
    args = parse(__doc__, argv, reps=5, add=lambda ap: ap.add_argument(
        "--depths", type=int, nargs="+", default=[1, 2, 3]))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import budget
    from repro_torch.kernels.fused_div.ops import (div_elementwise,
                                                   div_rowbcast,
                                                   fused_rms_div,
                                                   fused_softmax_div)
    from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,
                                          row_geometry)

    dev = resolve_device("cuda")
    card = card_line()
    g = torch.Generator(device=dev).manual_seed(1234)
    def operand(rows, n, off):  # 4 * off bytes past a 16 B boundary
        flat = torch.randn(rows * n + off, generator=g, device=dev) * 2.0
        return flat[off:].view(rows, n)

    for name, op, rows, n, off in SHAPES:
        x = operand(rows, n, off)
        if op == "softmax":
            x = torch.exp(x - x.amax(dim=-1, keepdim=True))
        b = (operand(rows, n, off) if op == "div" else
             torch.rand((rows,), generator=g, device=dev) * 40 + 1)
        calls = CALLS if rows * n < 10**7 else CALLS // 5
        lib = None
        if op == "div":
            def lib(x=x, b=b):
                x / b
        elif op == "rowbcast":
            def lib(x=x, b=b):
                x / b[:, None]
        family = {"rms": "fused_rms", "softmax": "fused_softmax",
                  "rowbcast": "fused_div_rowbcast", "div": None}[op]
        for depth in args.depths:
            if op == "div" and depth > 1:  # K6 has no stage count
                continue
            if family and (row_geometry(family, rows, n, depth).smem
                           > budget.SMEM_PER_BLOCK):  # refused either way
                continue
            spec = KernelSpec(pipeline=PipelineSpec(depth=depth))
            if op == "rms":
                def fn(x=x, spec=spec):
                    fused_rms_div(x, EPS, "rapid9", spec=spec)
            elif op == "softmax":
                def fn(x=x, spec=spec):
                    fused_softmax_div(x, "rapid9", spec=spec)
            elif op == "rowbcast":
                def fn(x=x, b=b, spec=spec):
                    div_rowbcast(x, b, "rapid9", spec=spec)
            else:
                def fn(x=x, b=b):
                    div_elementwise(x, b, "rapid9")
            row = {"src": args.src, "card": card, "shape": name,
                   "rows": rows, "n": n, "depth": depth,
                   "ms": graph_ms(torch, fn, calls, args.reps)}
            if lib is not None and depth == 1:
                row["library_ms"] = graph_ms(torch, lib, calls, args.reps)
            print(json.dumps(row), flush=True)
        del x, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
