"""Time kernel K1 (``log_matmul``) at the serve paths' 2-D shapes.

    python src/repro_torch/launch/k1_times.py [--src DIR] [--reps N] [--depth D]

On a machine with a CUDA card: builds the kernels of the ``repro_torch``
package found under ``--src`` (default: this checkout's ``src``), times
one K1 call per shape with CUDA events (L2 flushed before each call, as
the serve path meets every weight cold; mean of ``--reps``) and prints
one JSON line per shape with the card's name.  The card sleeps ~0.5 ms
before the first event of each call, so the wrapper's host work is
queued behind it and the events time the device alone.  Pointing ``--src`` at
another checkout's ``src`` times that checkout's kernels, so two
versions can be compared in turns inside one process launch each on the
same card (A, B, B, A).  ``--depth`` sets K1's stage count (K blocks
in flight; default: the checkout's own default) where the checkout's
``log_matmul`` takes a ``spec``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# rows of K1 on the serve paths: (site, M, K, N, activation, residual);
# M = 4 is a decode step, 64 a continuous prefill tick, 512 the
# lockstep prefill of 4 x 128 tokens
SHAPES = [("wq", m, 2560, 2560, None, False) for m in (4, 64, 512)] + [
    ("w1", m, 2560, 6912, "silu", False) for m in (4, 64, 512)] + [
    ("w2", m, 6912, 2560, None, True) for m in (4, 64, 512)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depth", type=int, default=None,
                    help="K blocks in flight (a checkout without stage "
                         "counts takes only the default)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.log_matmul.ops import log_matmul

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kw = {}
    if args.depth is not None:
        from repro_torch.kernels.spec import KernelSpec, PipelineSpec
        kw["spec"] = KernelSpec(pipeline=PipelineSpec(depth=args.depth))
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    for site, m, k, n, act, res in SHAPES:
        x = torch.randn((m, k), generator=g, device=dev)
        w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
        r = torch.randn((m, n), generator=g, device=dev) if res else None
        log_matmul(x, w, "rapid10", activation=act, residual=r, **kw)  # warm
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
                          "depth": args.depth, "M": m, "K": k, "N": n,
                          "ms": total / args.reps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
