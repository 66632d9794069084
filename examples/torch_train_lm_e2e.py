"""End-to-end on the PyTorch port: train a ~100M-parameter LM on the
synthetic pipeline with checkpoints and auto-resume, then serve it.

    PYTHONPATH=src python examples/torch_train_lm_e2e.py [--steps 300] \
        [--device cpu]

The port of examples/train_lm_e2e.py (the same model and data), on the card
unless `--device cpu`.  It trains half the steps, stops as a preempted job
would, and a second `train()` on the same checkpoint directory resumes
from the last step and runs to the end; then `Engine` serves the trained
weights and the script prints how often they continue the corpus's +1
pattern.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.train.loop import TrainConfig, train

# ~100M params: 12 layers, d=512, llama-style
CFG_100M = ModelConfig(
    name="repro-100m", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; exits 2 without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (torch.cuda.is_available() is False); "
                 "pass --device cpu")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_100m_ckpt_")
    print(f"~{CFG_100M.param_count()/1e6:.0f}M params on {dev}; "
          f"ckpts -> {ckpt_dir}")
    data = DataConfig(vocab=CFG_100M.vocab_, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    every = max(1, args.steps // 4)
    for steps in (args.steps // 2, args.steps):
        out = train(CFG_100M,
                    TrainConfig(steps=steps, log_every=every,
                                ckpt_every=every, ckpt_dir=ckpt_dir,
                                resume=True),
                    data, AdamWConfig(lr=1e-3), device=dev)
        print(f"stopped after step {out['final_step']}: loss "
              f"{out['loss']:.4f} ({out['straggler_events']} straggler "
              f"events)")

    # serve the trained weights
    eng = Engine(CFG_100M, out["params"],
                 EngineConfig(batch=4, max_len=args.seq_len + 64),
                 device=dev)
    prompts = np.tile(np.arange(16, dtype=np.int32)[None], (4, 1))
    toks, stats = eng.generate(prompts, max_new_tokens=24)
    print("continuations:", toks[:, :12])
    print(f"decode throughput: {stats['decode_tok_per_s']:.1f} tok/s")
    # the synthetic corpus is a noisy +1 (mod 64) walk — a trained model
    # should often continue the pattern:
    expect = (prompts[:, -1:] + 1 + np.arange(toks.shape[1])) % 64
    acc = float((toks == expect).mean())
    print(f"pattern-continuation accuracy: {acc:.2f}")


if __name__ == "__main__":
    main()
