"""Serving launcher: batched generation with random weights, on the card
unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \
        --reduced --batch 4 --new-tokens 16 [--device cpu]

The JAX package's `repro.launch.serve`, with the same flags and `--device`.
Weights are drawn on the device from a generator seeded with 0; prompts
(and whisper's frames, pixtral's patches) from numpy seeded with 0.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced as make_reduced
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (torch.cuda.is_available() is False); "
                 "pass --device cpu")

    params = LM.init_params(cfg, max_seq=args.max_len, device=device, seed=0)
    engine = Engine(cfg, params,
                    EngineConfig(batch=args.batch, max_len=args.max_len),
                    device=device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = (rng.normal(size=(args.batch, cfg.enc_seq,
                                         cfg.d_model)) * 0.1
                        ).astype(np.float32)
    if cfg.family == "vlm":
        kw["patches"] = (rng.normal(size=(args.batch, cfg.n_patches,
                                          cfg.d_model)) * 0.1
                         ).astype(np.float32)
    toks, stats = engine.generate(prompts, args.new_tokens, **kw)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    print("generated:", toks[:, :8], "...")
    print(f"prefill {stats['prefill_s']*1e3:.1f} ms; "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
