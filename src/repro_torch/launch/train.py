"""Training launcher: real steps of ``make_train_step`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
      --layers 2 --d-model 256 --steps 20 --batch 8 --seq 128

The port of ``repro.launch.train``, with its flags, plus ``--device``
(``cuda`` by default; ``cpu`` runs on the host) and ``--seed``: the f32
weights are drawn on the device from ``--seed``, the tokens
(``lm_batches``) from ``--seed`` too.  Without ``--layers``/``--d-model``
the config runs at its published size.  A config with ``cross`` layers gets
zeros as its encoder frames or image tokens, as the reference's launcher
gives them.  ``--lr`` is parsed and not used, as in the reference: the
step's cosine schedule is fixed (peak 3e-4, warmup 100, 10000 steps).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.precision import ComputeMode
from repro_torch.data import DataPipeline, lm_batches
from repro_torch.launch.specs import make_train_step
from repro_torch.nn import model as M
from repro_torch.optim import adamw_init


def train_batches(cfg, batch: int, seq: int, steps: int, seed: int):
    """``steps`` batches from ``lm_batches(seed, ...)`` as numpy dicts:
    int64 ``tokens`` and ``labels`` (B, S), and zero ``aux`` frames or image
    tokens for a config with ``cross`` layers."""
    n_aux = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.num_image_tokens
    for toks, labels in lm_batches(seed, batch, seq, cfg.vocab_size, steps):
        item = {"tokens": toks.astype(np.int64), "labels": labels.astype(np.int64)}
        if n_aux:
            item["aux"] = np.zeros((batch, n_aux, cfg.d_model), np.float32)
        yield item


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="not used: the step's cosine schedule is fixed "
                         "(peak 3e-4, warmup 100, total 10000), as in the reference")
    ap.add_argument("--mode", default="relaxed",
                    choices=[m.value for m in ComputeMode])
    ap.add_argument("--checkpoint", default="",
                    help="write {'params': ...} to this npz file at the end")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers or args.d_model:
        cfg = cfg.scaled_down(layers=args.layers or None,
                              d_model=args.d_model or 256)
    mode = ComputeMode(args.mode)
    device = torch.device(args.device)

    params = M.init_params(cfg, args.seed, device, dtype=torch.float32)
    for leaf in M.tree_leaves(params):
        leaf.requires_grad_(True)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, mode)

    batches = train_batches(cfg, args.batch, args.seq, args.steps, args.seed)
    losses = []
    t0 = time.time()
    for i, batch in enumerate(DataPipeline(batches, device=device)):
        params, opt, loss = step_fn(params, opt, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            losses.append(float(loss))
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / max(i, 1):.2f}s/step)", flush=True)
    print(f"final loss {float(loss):.4f} "
          f"(start {losses[0]:.4f}) in {time.time() - t0:.1f}s")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"params": params}, step=args.steps)
        print(f"saved {args.checkpoint}")
    return losses


if __name__ == "__main__":
    main()
