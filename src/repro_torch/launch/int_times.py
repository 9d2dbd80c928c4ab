"""Time the integer RAPID units K9 / K10 beside int32 ``a * b`` / ``a // b``.

    python src/repro_torch/launch/int_times.py [--src DIR] [--reps N]
                                               [--table3]

On a machine with a CUDA card: builds the kernels of the ``repro_torch``
package found under ``--src`` (default: this checkout's ``src``) and
times, through the public wrappers, K9 (``rapid_mul``, rapid10) and K10
(``rapid_div``, rapid9) at the shapes Table III drives them at:

* 2^24 random pairs, K9 at 16 bits, K10 with a 16-bit a and an 8-bit b;
* every pair of 8-bit operands (65 536 pairs), both units.

Beside each it times one exact PyTorch call on the same int32 operands,
``a * b`` for K9 and ``a // b`` for K10 (b = 0 lifted to 1): a yardstick
that moves the same 12 B a pair and that the port never calls.  Device
time per call by CUDA-graph replay of CALLS launches, the mean of
``--reps`` replays; one JSON line per shape with the card's name.
Pointing ``--src`` at another checkout's ``src`` times that checkout's
kernels, so two versions can be compared in turns on one card (A, B, B,
A).

``--table3`` prints, in place of the times, the paper's Table III
accuracy of that checkout's units (:func:`table3`, one JSON line a row),
which ``chip_smoke.py`` computes with the same operands: two checkouts'
tables can be compared digit for digit.
"""
from __future__ import annotations

import json
import sys

PAIRS = 1 << 24
# (shape, unit, scheme, n_bits, a_bits, pairs; None: every 8-bit pair)
SHAPES = [("mul 2^24 16-bit", "mul", "rapid10", 16, 16, PAIRS),
          ("div 2^24 16/8-bit", "div", "rapid9", 8, 16, PAIRS),
          ("mul 8-bit exhaustive", "mul", "rapid10", 8, 8, None),
          ("div 8-bit exhaustive", "div", "rapid9", 8, 8, None)]




def table3(torch, dev, rapid_mul, rapid_div, schemes) -> list:
    """Table III's accuracy of the integer units, through the wrappers
    ``rapid_mul`` / ``rapid_div``: K9 at 8 bits (every pair of nonzero
    operands) and 16 bits (2^24 random nonzero pairs, seed 99), K10 at
    8/4 (every a < 256, 0 < b < 16) and 16/8 (2^24 random pairs), every
    scheme of ``schemes``.  A row a unit, width and scheme: the mean
    (ARE) and peak (PRE) relative error in % of the integer outputs
    against the exact product, and against the exact quotient where it
    is at least 1."""
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

    def values(out):  # uint32, or int64 results of an older checkout
        if out.dtype == torch.uint32:
            return (out.view(torch.int32).long() & 0xFFFFFFFF).double()
        return out.double()

    rows = []
    for kind, n_bits, n in (("mul", 8, None), ("mul", 16, PAIRS),
                            ("div", 4, None), ("div", 8, PAIRS)):
        a, b = operands(2 * n_bits if kind == "div" else n_bits, n_bits, n)
        exact = (a.double() * b.double() if kind == "mul"
                 else a.double() / b.double())
        keep = exact >= 1.0
        table = schemes.MUL_SCHEMES if kind == "mul" else schemes.DIV_SCHEMES
        for name in table:
            out = (rapid_mul if kind == "mul" else rapid_div)(a, b, name,
                                                              n_bits)
            re = (values(out)[keep] / exact[keep] - 1.0).abs() * 100.0
            rows.append({"op": kind, "n_bits": n_bits, "scheme": name,
                         "pairs": int(keep.sum()), "are_pct": float(re.mean()),
                         "pre_pct": float(re.max())})
        del a, b, exact, keep
    return rows


def main(argv=None) -> int:
    from kernel_timing import card_line, graph_ms, parse

    args = parse(__doc__, argv, reps=5, add=lambda ap: ap.add_argument(
        "--table3", action="store_true",
        help="print the units' Table III accuracy instead of their times"))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.rapid_div.ops import rapid_div
    from repro_torch.kernels.rapid_mul.ops import rapid_mul

    dev = resolve_device("cuda")
    card = card_line()
    if args.table3:
        from repro_torch.core import schemes
        for row in table3(torch, dev, rapid_mul, rapid_div, schemes):
            print(json.dumps(dict(row, src=args.src, card=card)), flush=True)
        return 0
    g = torch.Generator(device=dev).manual_seed(1234)
    for name, unit, scheme, n_bits, a_bits, pairs in SHAPES:
        if pairs is None:
            v = torch.arange(256, dtype=torch.int32, device=dev)
            a, b = v.repeat_interleave(256), v.repeat(256)
        else:
            a = torch.randint(0, 1 << a_bits, (pairs,), generator=g,
                              device=dev, dtype=torch.int32)
            b = torch.randint(0, 1 << n_bits, (pairs,), generator=g,
                              device=dev, dtype=torch.int32)
        calls = 20 if a.numel() > 10**6 else 200
        bnz = b.clamp(min=1)
        if unit == "mul":
            def exact(a=a, b=b):
                a * b
        else:
            def exact(a=a, bnz=bnz):
                a // bnz
        library_ms = graph_ms(torch, exact, calls, args.reps)
        fn = rapid_mul if unit == "mul" else rapid_div

        def call(a=a, b=b, fn=fn, scheme=scheme, n_bits=n_bits):
            fn(a, b, scheme, n_bits)
        ms = graph_ms(torch, call, calls, args.reps)
        print(json.dumps({"src": args.src, "card": card, "shape": name,
                          "pairs": a.numel(), "scheme": scheme,
                          "n_bits": n_bits, "ms": ms,
                          "library_ms": library_ms}), flush=True)
        del a, b, bnz
    return 0


if __name__ == "__main__":
    sys.exit(main())
