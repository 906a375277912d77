"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --num-layers 2 --steps 50 --ckpt-dir build/ckpts [--grad-compress]

Trains ``--arch`` from a seeded random init on the synthetic language of
``data/pipeline.SyntheticLM`` through ``train/loop.Trainer``, which
checkpoints into ``--ckpt-dir`` every ``--ckpt-every`` steps and at the
end, and resumes from the newest valid checkpoint there: run the same
command again after a preemption and it carries on.  ``--grad-compress``
sends every gradient through the 1-bit error-feedback compression.
``--num-layers`` cuts depth only; ``--reduced`` selects the small test
widths.  Runs on ``--device`` (default cuda; ``--device cpu --reduced``
runs on a host without a card).  Prints the steps completed, the first
and last loss and the median step time.
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpts"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import make_config
    from repro_torch.models import build_model
    from repro_torch.train.loop import LoopConfig, Trainer

    cfg = make_config(args.arch, reduced=args.reduced,
                      num_layers=args.num_layers)
    model = build_model(cfg)
    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      batch_size=args.batch, seq_len=args.seq,
                      peak_lr=args.lr, grad_compress=args.grad_compress)
    res = Trainer(model, args.ckpt_dir, lcfg, device=args.device).run()
    if not res["losses"]:
        print(f"completed={res['completed']} (nothing left to train in "
              f"{args.ckpt_dir})")
        return
    ms = 1e3 * statistics.median(res["step_seconds"])
    print(f"completed={res['completed']} "
          f"loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f} "
          f"median step {ms:.1f} ms on {args.device}")


if __name__ == "__main__":
    main()
