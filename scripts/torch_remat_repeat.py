#!/usr/bin/env python
"""Repeats one reduced float32 train step of the port with remat and
without, on the CPU, and reports every repeat whose gradients part.

Each repeat restores the same weights (the port's init, seed 0) and the
same batch (`repro_torch.train.parity.train_batch`), takes the loss and
gradients with remat and without, and prints the leaves that differ
between the two and from the first repeat's, with their largest |diff|.
Start several at once to load the host:

    PYTHONPATH=src python scripts/torch_remat_repeat.py \
        --arch whisper-large-v3 --repeats 300 [--threads 2] [--deterministic]

The last line is `done <repeats> apart <n> <seconds>s`; exits 1 if any
repeat parted.
"""

import argparse
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper-large-v3")
    ap.add_argument("--repeats", type=int, default=100)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    from repro_torch.models import lm as TLM
    from repro_torch.train import parity
    from repro_torch.train import step as TS

    cfg = parity.reduced_f32(args.arch)
    data = parity.train_batch(cfg, "cpu")
    model = TLM.init_params(cfg, max_seq=parity.SEQ, device="cpu", seed=0)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    first, apart = None, 0
    t0 = time.perf_counter()
    for i in range(args.repeats):
        res = {}
        for remat in (True, False):
            model.load_state_dict(weights)
            loss, _, grads = TS.value_and_grad(
                TS.make_loss_fn(cfg, remat=remat), model, data)
            res[remat] = (float(loss), {k: g.clone()
                                        for k, g in grads.items()})
        (la, ga), (lb, gb) = res[True], res[False]
        first = first or (lb, gb)

        def differ(x, y):
            return {k: float((g - y[k]).abs().max())
                    for k, g in x.items() if not torch.equal(g, y[k])}

        d_remat, d_first = differ(ga, gb), differ(gb, first[1])
        if d_remat or d_first or la != lb or lb != first[0]:
            apart += 1
            print(f"repeat {i}: loss {la!r} / {lb!r} (first {first[0]!r}); "
                  f"remat against plain {d_remat}; plain against the "
                  f"first repeat {d_first}", flush=True)
    print(f"done {args.repeats} apart {apart} "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if apart else 0


if __name__ == "__main__":
    sys.exit(main())
