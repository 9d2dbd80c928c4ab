"""What the kernel timers in this folder share: the command line, the
card's name and device time by CUDA-graph replay.

``k1_times.py``, ``k4_times.py`` and ``k8_times.py`` run as scripts and
import this file as a module of their own folder, before ``--src``
decides which checkout's ``repro_torch`` they time; so it imports
nothing of ``repro_torch``.  ``chip_smoke.py`` imports it from the
package.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def parse(doc: str, argv, reps: int, add=None) -> argparse.Namespace:
    """A timer's arguments: ``--src`` (the directory holding the
    ``repro_torch`` to time, put first on ``sys.path``), ``--reps`` and
    whatever ``add(parser)`` adds."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--reps", type=int, default=reps)
    if add is not None:
        add(ap)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    return args


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, calls: int, reps: int = 1) -> float:
    """Device ms per call: ``calls`` calls of ``fn`` captured in one CUDA
    graph, replayed ``reps`` times after a warm replay, so no host time
    between launches is counted.  ``fn`` runs once before the capture."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (calls * reps)
