"""Synthetic datasets (no network access, no datasets).

- :func:`imagenet_like`, the counterpart of
  ``repro.data.synthetic.imagenet_like``: each class has its own spatial
  frequency and angle, plus per-image colour shift and pixel noise, so
  classification is learnable and sensitive to precision.  Drawn from a
  ``torch.Generator`` on the CPU and placed on ``device``, so a seed gives
  the same images on every device (not the JAX package's bits).
- :func:`token_stream` / :func:`lm_batches`: a Zipf-distributed Markov token
  stream for LM training.  numpy code copied from the reference, so a seed
  gives the reference's tokens bit for bit.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple, Union

import numpy as np
import torch

from ..device.profile import torch_device


def imagenet_like(generator: Union[torch.Generator, int], n: int, *,
                  hw: int = 64, num_classes: int = 10,
                  device: "str | torch.device | None" = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (n, 3, hw, hw) f32, labels (n,) int64)."""
    dev = torch_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    labels = torch.randint(0, num_classes, (n,), generator=generator)
    yy, xx = torch.meshgrid(torch.arange(hw, dtype=torch.float32),
                            torch.arange(hw, dtype=torch.float32), indexing="ij")
    lab = labels.float()[:, None, None]
    freqs = lab + 1
    angle = lab * (math.pi / num_classes)
    pattern = torch.sin((xx * torch.cos(angle) + yy * torch.sin(angle))
                        * freqs * (2 * math.pi / hw))
    base = pattern[:, None].repeat(1, 3, 1, 1)
    chroma = torch.randn((n, 3, 1, 1), generator=generator) * 0.1
    noise = torch.randn((n, 3, hw, hw), generator=generator) * 0.25
    return (base + chroma + noise).to(dev), labels.to(dev)


def token_stream(seed: int, length: int, vocab: int) -> np.ndarray:
    """Zipf unigram + order-1 Markov structure (so the loss is reducible):
    ``length`` int32 tokens in [0, vocab)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=length, p=probs)
    # Bigram structure: with p = 0.3 the next token is f(previous).
    follow = rng.permutation(vocab)
    mask = rng.random(length) < 0.3
    toks[1:][mask[1:]] = follow[toks[:-1][mask[1:]]]
    return toks.astype(np.int32)


def lm_batches(seed: int, batch: int, seq_len: int, vocab: int,
               steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` batches of (tokens, labels), each (batch, seq_len) int32,
    the labels the next-token shift of the tokens."""
    need = steps * batch * (seq_len + 1)
    stream = token_stream(seed, need, vocab)
    for s in range(steps):
        chunk = stream[s * batch * (seq_len + 1):(s + 1) * batch * (seq_len + 1)]
        chunk = chunk.reshape(batch, seq_len + 1)
        yield chunk[:, :-1], chunk[:, 1:]
