"""Time the row dividers (K2/K3/K5 at depth 1, K8) at the paths' shapes.

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
  8320-token blockwise prefill).

Each shape is timed at every stage count of ``--depths`` that its
block fits (the checkout's own ``row_geometry`` and shared-memory
limit): depth 1 is K2 / K3 / K5, depth >= 2 is K8, through the public
wrappers with an explicit depth and the checkout's own geometry.
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
# (name, op, rows, n); the long prefill's combine: 8320 tokens x 32 heads
SHAPES = [("rms 1x2560", "rms", 1, D), ("rms 4x2560", "rms", 4, D),
          ("rms 64x2560", "rms", 64, D), ("rms 512x2560", "rms", 512, D),
          ("rms 4x40000", "rms", 4, 40_000),
          ("softmax 16384x128", "softmax", 16384, 128),
          ("softmax 33x130", "softmax", 33, 130),
          ("rowbcast 2048x80", "rowbcast", 2048, HD),
          ("rowbcast 266240x80", "rowbcast", 8320 * 32, HD)]


def main(argv=None) -> int:
    args = parse(__doc__, argv, reps=5, add=lambda ap: ap.add_argument(
        "--depths", type=int, nargs="+", default=[1, 2, 3]))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import budget
    from repro_torch.kernels.fused_div.ops import (div_rowbcast,
                                                   fused_rms_div,
                                                   fused_softmax_div)
    from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,
                                          row_geometry)

    dev = resolve_device("cuda")
    card = card_line()
    g = torch.Generator(device=dev).manual_seed(1234)
    for name, op, rows, n in SHAPES:
        x = torch.randn((rows, n), generator=g, device=dev) * 2.0
        if op == "softmax":
            x = torch.exp(x - x.amax(dim=-1, keepdim=True))
        b = torch.rand((rows,), generator=g, device=dev) * 40 + 1
        calls = CALLS if rows * n < 10**7 else CALLS // 5
        family = {"rms": "fused_rms", "softmax": "fused_softmax",
                  "rowbcast": "fused_div_rowbcast"}[op]
        for depth in args.depths:
            if (row_geometry(family, rows, n, depth).smem
                    > budget.SMEM_PER_BLOCK):  # refused on either route
                continue
            spec = KernelSpec(pipeline=PipelineSpec(depth=depth))
            if op == "rms":
                def fn(x=x, spec=spec):
                    fused_rms_div(x, EPS, "rapid9", spec=spec)
            elif op == "softmax":
                def fn(x=x, spec=spec):
                    fused_softmax_div(x, "rapid9", spec=spec)
            else:
                def fn(x=x, b=b, spec=spec):
                    div_rowbcast(x, b, "rapid9", spec=spec)
            ms = graph_ms(torch, fn, calls, args.reps)
            print(json.dumps({"src": args.src, "card": card, "shape": name,
                              "rows": rows, "n": n, "depth": depth,
                              "ms": ms}), flush=True)
        del x, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
