"""LM serving launcher: batched generation with the ServingEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --layers 2 --d-model 256 --batch 4 --prompt-len 32 --gen 32

The port of ``repro.launch.serve``, with its flags, plus ``--device``
(``cuda`` by default; ``cpu`` runs on the host) and ``--seed``: the weights
are drawn on the device from ``--seed``, the prompts from ``--seed + 1`` and
sampling from ``--seed + 2``.  Without ``--layers``/``--d-model`` the config
runs at its published size.  Runs every config in ``repro_torch.configs``; a
config with ``cross`` layers gets zeros as its encoder frames or image
tokens, as the reference's launcher gives them.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import ComputeMode
from repro_torch.nn import model as M
from repro_torch.serving import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--mode", default="relaxed",
                    choices=[m.value for m in ComputeMode])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers or args.d_model:
        cfg = cfg.scaled_down(layers=args.layers or None,
                              d_model=args.d_model or 256)
    mode = ComputeMode(args.mode)
    device = torch.device(args.device)

    params = M.init_params(cfg, args.seed, device, dtype=mode.operand_dtype)
    engine = ServingEngine(cfg, params, max_context=args.prompt_len + args.gen,
                           mode=mode, device=device)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=device)
    aux = None
    if cfg.is_encoder_decoder or cfg.num_image_tokens:
        aux = torch.zeros((args.batch, cfg.encoder_seq or cfg.num_image_tokens,
                           cfg.d_model), device=device)
    res = engine.generate(
        prompts, max_new_tokens=args.gen, aux=aux, temperature=args.temperature,
        generator=torch.Generator(device=device).manual_seed(args.seed + 2))
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={res.steps} device={device}")
    print(f"prefill {res.prefill_seconds * 1e3:.1f} ms; decode "
          f"{res.decode_seconds * 1e3:.1f} ms "
          f"({res.decode_tokens_per_second:.1f} tok/s)")
    print("first row:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
