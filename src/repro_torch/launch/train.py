"""Training launcher, on the card unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
        --reduced --steps 200 --ckpt-dir /tmp/run1 [--device cpu]

The JAX package's `repro.launch.train`, with its flags and `--device`:
data pipeline -> train step -> async checkpoints -> watchdog ->
auto-resume (a second run on the same `--ckpt-dir` resumes).  Without
`--device` it trains on the card and exits 2 where there is none.  The
JAX launcher's `--mesh` and `--fake-devices` (TPU meshes) are not
carried over.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; exits 2 without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced as make_reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, train

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (torch.cuda.is_available() is False); "
                 "pass --device cpu")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)

    out = train(
        cfg,
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=not args.no_resume),
        DataConfig(vocab=cfg.vocab_, seq_len=args.seq_len,
                   global_batch=args.global_batch),
        AdamWConfig(lr=args.lr),
        device=device,
    )
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    if not out["history"]:
        print(f"nothing to train: the run is at step {out['final_step']} "
              f"of {args.steps}")
    else:
        print(f"final loss {out['loss']:.4f} after {out['final_step']} "
              f"steps ({out['straggler_events']} straggler events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
