"""Training launcher, on the card unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
        --reduced --steps 200 --ckpt-dir /tmp/run1 [--device cpu]

The JAX package's `repro.launch.train`, with its flags and `--device`:
data pipeline -> train step -> async checkpoints -> watchdog ->
auto-resume (a second run on the same `--ckpt-dir` resumes).  Without
`--device` it trains on the card and exits 2 where there is none.

`--mesh none|host|pod1|pod2` trains under a mesh (`train(mesh=)`): host
is every device of `--device`'s kind as a 1 x N ("data", "model") mesh,
pod1 and pod2 the production shapes (16, 16) and (2, 16, 16)
(`launch.mesh.make_production_mesh`).  `--fake-devices N` makes those
devices N logical shards of `--device`, the port's reading of the JAX
launcher's forced host device count.  A mesh the devices cannot fill
exits 2 with the reason.

    python -m repro_torch.launch.train --arch minitron-8b --reduced \
        --device cpu --mesh host --fake-devices 4
"""

from __future__ import annotations

import argparse

import numpy as np
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
    ap.add_argument("--mesh", choices=["none", "host", "pod1", "pod2"],
                    default="none")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="N logical shards of --device make the mesh "
                         "(the JAX launcher's forced host device count)")
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
    mesh = _mesh(args, device, ap)

    out = train(
        cfg,
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=not args.no_resume),
        DataConfig(vocab=cfg.vocab_, seq_len=args.seq_len,
                   global_batch=args.global_batch),
        AdamWConfig(lr=args.lr),
        device=None if mesh is not None else device,
        mesh=mesh,
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


def _mesh(args, device: torch.device, ap):
    """The mesh `--mesh` names over `--fake-devices` logical shards of
    `device`, or over every real device of its kind; None for "none"."""
    if args.mesh == "none":
        return None
    from repro_torch.launch import mesh as M
    if args.fake_devices:
        devices = [device] * args.fake_devices
    else:
        devices = M.local_devices(device.type)
    try:
        if args.mesh == "host":
            mesh = M.Mesh(np.asarray(devices, dtype=object)
                          .reshape(1, len(devices)), ("data", "model"))
        else:
            mesh = M.make_production_mesh(multi_pod=args.mesh == "pod2",
                                          devices=devices)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh}: {e}")
    print(f"mesh: {mesh.shape} ({mesh.size} shard(s) of {device})")
    return mesh


if __name__ == "__main__":
    raise SystemExit(main())
