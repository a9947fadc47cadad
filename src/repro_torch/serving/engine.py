"""Batched LM serving engine: prefill + a decode loop over a KV/state cache.

The port of ``repro.serving.engine``.  ``ServingEngine`` holds the model's
parameters on an explicit ``device`` (the card by default) and serves
batches of prompts of any config family: greedy or temperature sampling,
per-request EOS tracking.  Each :meth:`~ServingEngine.generate` prefills
anew.

Sampling takes an explicit ``torch.Generator``.  Its seed is the base: step
``i`` draws from a fresh generator seeded with :func:`fold_seed` of (base,
i), so every step draws new values, the base seed itself never draws, and
the same base seed repeats the same tokens (the contract of the reference's
``jax.random.fold_in``, on torch's own stream).

Timings synchronize the device before the clock is read, so prefill work
does not leak into the decode window.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.precision import ComputeMode
from ..nn import model as M
from ..nn.config import ModelConfig


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, n_generated)
    prefill_seconds: float
    decode_seconds: float
    steps: int

    @property
    def decode_tokens_per_second(self) -> float:
        b = self.tokens.shape[0]
        return b * self.steps / max(self.decode_seconds, 1e-9)


def fold_seed(seed: int, step: int) -> int:
    """A 63-bit seed derived from (seed, step); distinct steps give
    distinct seeds, and none equals ``seed`` but by a hash collision."""
    digest = hashlib.sha256(f"{seed}/{step}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_context: int,
                 mode: ComputeMode = ComputeMode.RELAXED,
                 window_override: int = 0,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = M.tree_map(lambda t: t.to(self.device), params)
        self.max_context = max_context
        self.mode = mode
        self.window_override = window_override

    def generate(self, prompts, *, max_new_tokens: int,
                 aux=None,
                 eos_id: Optional[int] = None,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """prompts: (B, S) integer tokens.  ``aux``: the encoder frames or
        image tokens (B, S_aux, d_model) of a config with ``cross`` layers.
        Greedy when ``temperature`` is 0 or no ``generator`` is given."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if aux is not None:
            aux = torch.as_tensor(aux, device=self.device)
        b, s = prompts.shape
        if s + max_new_tokens > self.max_context:
            raise ValueError(f"context overflow: {s} + {max_new_tokens} > "
                             f"{self.max_context}")
        base = None if generator is None else generator.initial_seed()
        with torch.inference_mode():
            _sync(self.device)
            t0 = time.perf_counter()
            logits, caches = M.prefill(
                self.params, prompts, self.cfg, capacity=self.max_context,
                aux=aux, mode=self.mode, window_override=self.window_override)
            # The first token is sampled from the prefill's logits, with
            # step 0's seed (never the base seed itself).
            tok = self._sample(logits, temperature,
                               None if base is None else fold_seed(base, 0))
            _sync(self.device)
            t_prefill = time.perf_counter() - t0

            out: List[np.ndarray] = []
            finished = np.zeros((b,), bool)
            t0 = time.perf_counter()
            for i in range(max_new_tokens):
                out.append(tok.cpu().numpy())
                if eos_id is not None:
                    finished |= (out[-1][:, 0] == eos_id)
                    if finished.all():
                        break
                if i == max_new_tokens - 1:
                    break
                logits, caches = M.decode_step(
                    self.params, caches, tok, s + i, self.cfg, mode=self.mode,
                    window_override=self.window_override)
                tok = self._sample(logits, temperature,
                                   None if base is None
                                   else fold_seed(base, i + 1))
            _sync(self.device)
            t_decode = time.perf_counter() - t0
        return GenerationResult(tokens=np.concatenate(out, axis=1),
                                prefill_seconds=t_prefill,
                                decode_seconds=t_decode, steps=len(out))

    def _sample(self, logits: torch.Tensor, temperature: float,
                seed: Optional[int]) -> torch.Tensor:
        """(B, V) logits -> (B, 1) int64 tokens: argmax, or a Gumbel-max
        draw at ``temperature`` from a generator seeded with ``seed``."""
        if temperature <= 0.0 or seed is None:
            return torch.argmax(logits, dim=-1)[:, None]
        g = torch.Generator(device=logits.device).manual_seed(seed)
        u = torch.rand(logits.shape, generator=g, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits.float() / temperature + gumbel,
                            dim=-1)[:, None]
