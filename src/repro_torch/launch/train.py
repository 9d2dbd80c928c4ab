"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Trains on synthetic data (``SyntheticLM``) with AdamW (or the config's
optimizer) on the config's schedule, block remat as the config says,
and a checkpoint at the end (``--ckpt-dir``, default the checkout's
``build/ckpt``).  Runs on the card (``--device cuda``, the default) with
the CUDA kernels, or on the CPU with their plain versions (``--device
cpu``; use ``--reduced`` there).  ``--approx`` turns on RAPID
arithmetic.  Weights are a seeded random init.  The reference's
``--production-mesh`` / ``--multi-pod`` have no counterpart: the port
trains on one device.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ARCH_IDS, RAPID, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.train.loop import DEFAULT_CKPT_DIR, LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainstep import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke scale)")
    ap.add_argument("--approx", action="store_true",
                    help="enable RAPID approximate mul/div")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.approx:
        cfg = cfg.with_(approx=RAPID)
    dev = resolve_device(args.device)

    model = Model(cfg)
    params = model.init(0, dev)
    oc = OptConfig(name=cfg.optimizer, lr=args.lr, schedule=cfg.lr_schedule,
                   total_steps=args.steps)
    init_opt, train_step = make_train_step(model, oc,
                                           microbatches=args.microbatches)
    opt_state = init_opt(params)
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    lc = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir, log_every=10)
    state = train_loop(train_step, params, opt_state, src, lc)
    print(f"final loss: {state.losses[-1]:.4f} "
          f"(first {state.losses[0]:.4f}) over {state.step} steps on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
