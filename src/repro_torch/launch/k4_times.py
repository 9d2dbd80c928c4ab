"""Time kernel K4 (``flash_decode_attn``) at the serve paths' shapes.

    python src/repro_torch/launch/k4_times.py [--src DIR] [--reps N]
        [--bn SLOTS ...]

On a machine with a CUDA card: builds the kernels of the ``repro_torch``
package found under ``--src`` (default: this checkout's ``src``) and
times K4, RAPID arm, bf16 caches, at three shapes of h2o_danube_1_8b's
attention (8 kv heads of 4 queries, head_dim 80, 4 sequences):

* ``lockstep``: a 512-slot cache with 136 live slots (a 128-token
  prompt and 8 generated tokens);
* ``paged``: the continuous engine's decode tick, 256-slot views
  gathered from a page pool, kv_len 131 / 98 / 201 / 0;
* ``window``: the full 4096-slot window, every slot live.

Positions are an int32 device vector, so a call launches K4 alone.
Device time per call by CUDA-graph replay of CALLS launches (the
wrapper's host path costs more than the kernel, so it is kept out), the
mean of ``--reps`` replays; one JSON line per shape and segment length
with the card's name.  ``--bn`` times the given segment lengths (cache
slots a block walks, a multiple of the 32-slot chunk) through an
explicit spec, for the A/B that picks ``kernels/spec.py``'s default;
without it, the checkout's own geometry.  Pointing ``--src`` at another
checkout's ``src`` times that checkout's kernel, so two versions can be
compared in turns on one card (A, B, B, A); ``--bn`` needs a checkout
whose K4 takes a ``spec``.
"""
from __future__ import annotations

import json
import sys

from kernel_timing import card_line, graph_ms, parse

B, KV, G, HD, WINDOW = 4, 8, 4, 80, 4096
CALLS = 100


def shapes(torch, dev, g):
    """name -> (qf, k, v, slot_positions, pos), made from ``g``."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    out = {}
    qf = randn(B, KV, G, HD, std=HD ** -0.5)
    for name, c, live in (("lockstep", 512, 136), ("window", 4096, 4096)):
        k = randn(B, c, KV, HD).to(torch.bfloat16)
        v = randn(B, c, KV, HD).to(torch.bfloat16)
        base = torch.arange(c, dtype=torch.int32, device=dev)
        sp = torch.where(base < live, base, 2**31 - 1).expand(B, c)
        pos = torch.full((B,), live - 1, dtype=torch.int32, device=dev)
        out[name] = (qf, k, v, sp.contiguous(), pos)
    n_pages, ps, pps = 65, 16, 16
    pool_k = randn(n_pages, ps, KV, HD).to(torch.bfloat16)
    pool_v = randn(n_pages, ps, KV, HD).to(torch.bfloat16)
    table = torch.zeros((B, pps), dtype=torch.long, device=dev)
    table[:3] = (torch.randperm(n_pages - 1, generator=g, device=dev)
                 [:3 * pps] + 1).reshape(3, pps)
    kv_len = torch.tensor([131, 98, 201, 0], dtype=torch.int32, device=dev)
    c = pps * ps
    j = torch.arange(c, dtype=torch.int32, device=dev)
    out["paged"] = (qf, pool_k[table].reshape(B, c, KV, HD),
                    pool_v[table].reshape(B, c, KV, HD),
                    torch.where(j[None] < kv_len[:, None], j[None],
                                2**31 - 1),
                    torch.clamp(kv_len - 1, min=0))
    return out


def main(argv=None) -> int:
    args = parse(__doc__, argv, reps=5, add=lambda ap: ap.add_argument(
        "--bn", type=int, nargs="*", default=None,
        help="segment lengths to time (default: the spec's)"))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attn.ops import flash_decode_attn

    dev = resolve_device("cuda")
    card = card_line()
    cases = shapes(torch, dev, torch.Generator(device=dev).manual_seed(1234))
    for name, (qf, k, v, sp, pos) in cases.items():
        for bn in args.bn or [None]:
            kw = {}
            if bn is not None:
                from repro_torch.kernels.spec import KernelSpec
                kw["spec"] = KernelSpec(bn=bn)
            ms = graph_ms(torch, lambda: flash_decode_attn(
                qf, k, v, sp, pos, WINDOW, "rapid9", **kw),
                CALLS, args.reps)
            print(json.dumps({"src": args.src, "card": card, "shape": name,
                              "C": k.shape[1], "bn": bn, "ms": ms}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
