"""Decode step and prefill times of two checkouts, alternated on one card.

  python3 tools/ab_decode.py BASE_TREE NEW_TREE [--rounds 2] [--out FILE]

For each LM config of ``chip_smoke.py``'s phases 10-11 (Qwen2-7B whole,
granite-moe, hymba, xlstm and whisper whole, llama-vision at 5 of its 100
layers, qwen3-moe at 2 of its 94), at full width, it runs one child process
per tree in the order base, new, new, base (``--rounds`` pairs).  A child
imports ``repro_torch`` from its tree's ``src``, draws bf16 weights on the
card from a seed, and after one untimed pass runs three passes of a
prefill (batch 4, prompt 128, RELAXED, encoder frames or image tokens
zero) and 31 greedy decode steps, as ``ServingEngine.generate`` does at
phases 10-11's sizes; each step is timed on the host clock from the call of
``decode_step`` to its greedy token on the host, and each prefill from its
call to its first token on the host; then it counts the Python calls of
one more step (``cProfile``).  Prints each child's median and least step
ms, its prefills' ms and its call count, and a JSON summary (per tree the
median and the least over its children's steps, the least prefill and the
call count, and new over base); ``--out`` writes the summary to a file as
well.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

#: (config, layers kept or None for all), as chip_smoke.py's phases 10-11.
CONFIGS = [("qwen2-7b", None), ("granite-moe-1b-a400m", None), ("hymba-1.5b", None),
           ("xlstm-350m", None), ("whisper-small", None),
           ("llama-3.2-vision-90b", 5), ("qwen3-moe-235b-a22b", 2)]
SEED = 0
#: Passes of prefill + 31 timed decode steps, after one untimed pass.
TIMED_PASSES = 3


def child(tree: str, arch: str, layers: int) -> None:
    """One tree and config: print the decode steps' ms and the Python calls
    of one step as JSON."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import cProfile
    import dataclasses
    import pstats
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ComputeMode
    from repro_torch.nn import model as M

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen(SEED), "cuda", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda", generator=gen(SEED + 1))
    aux = None
    if cfg.is_encoder_decoder or cfg.num_image_tokens:
        aux = torch.zeros((4, cfg.encoder_seq or cfg.num_image_tokens, cfg.d_model),
                          device="cuda")
    mode = ComputeMode.RELAXED
    ms, prefill_ms = [], []
    with torch.inference_mode():
        for rep in range(1 + TIMED_PASSES):
            t0 = time.perf_counter()
            logits, caches = M.prefill(params, prompts, cfg, capacity=160, aux=aux, mode=mode)
            tok = torch.argmax(logits, dim=-1)[:, None]
            tok.cpu()
            if rep:
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            for i in range(31):
                t0 = time.perf_counter()
                logits, caches = M.decode_step(params, caches, tok, 128 + i, cfg, mode=mode)
                tok = torch.argmax(logits, dim=-1)[:, None]
                tok.cpu()
                if rep:
                    ms.append((time.perf_counter() - t0) * 1e3)
        # The Python calls of one more step (a count, not a time).
        prof = cProfile.Profile()
        prof.enable()
        M.decode_step(params, caches, tok, 128 + 31, cfg, mode=mode)
        prof.disable()
    print(json.dumps({"ms": ms, "prefill_ms": prefill_ms,
                      "python_calls": pstats.Stats(prof).total_calls}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2,
                    help="pairs of children per tree and config (base, new, new, base, ...)")
    ap.add_argument("--out", help="also write the JSON summary to this file")
    args = ap.parse_args(argv)
    summary = {}
    for arch, layers in CONFIGS:
        runs = {"base": [], "new": []}
        order = []
        for r in range(args.rounds):
            order += ["base", "new"] if r % 2 == 0 else ["new", "base"]
        for which in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", getattr(args, which),
                 arch, str(layers or 0)], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return proc.returncode
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[which].append(got)
            print(f"{arch} ({layers or 'all'} layers) {which}: decode step ms median "
                  f"{statistics.median(got['ms']):.2f}, min {min(got['ms']):.2f}; "
                  f"prefill ms {', '.join(f'{t:.2f}' for t in got['prefill_ms'])}; "
                  f"{got['python_calls']} Python calls a step", flush=True)
        summary[arch] = {which: {"median_ms": statistics.median(m for g in v for m in g["ms"]),
                                 "min_ms": min(m for g in v for m in g["ms"]),
                                 "child_medians_ms": [statistics.median(g["ms"]) for g in v],
                                 "prefill_min_ms": min(m for g in v for m in g["prefill_ms"]),
                                 "python_calls": v[0]["python_calls"]}
                         for which, v in runs.items()}
        for stat in ("median_ms", "min_ms", "prefill_min_ms"):
            summary[arch][f"new_over_base_{stat[:-3]}"] = (summary[arch]["new"][stat]
                                                          / summary[arch]["base"][stat])
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        sys.exit(main())
