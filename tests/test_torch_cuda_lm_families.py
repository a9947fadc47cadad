"""The MoE, hybrid-SSM, xLSTM and cross-attention LM families on the card.

Every case is marked ``gpu`` and skips without a card.  They import no JAX:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_lm_families.py``.

Each family's smoke config (random bf16 weights drawn on the card from a
seed) against CPU copies of the same weights: prefill of 16 tokens and 2
decode steps, the CPU's greedy token fed to both, under RELAXED.  Every
logit within ``mode_tolerance(RELAXED)`` of its row's largest |logit|, and
the greedy token equal wherever the CPU's lead exceeds that limit.  The MoE
runs take the CPU's RELAXED expert choices (``RouteReplay``): where the
card's own router would choose others, the CPU's choice must be a near-tie.
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import ComputeMode, mode_tolerance
from repro_torch.nn import model as M
from repro_torch.nn import moe

from _torch_parity import RouteReplay

FAMILIES = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "hymba-1.5b",
            "xlstm-350m", "whisper-small", "llama-3.2-vision-90b"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lockstep(params, cfg, toks, aux, mode, steps=2):
    """Prefill then ``steps`` decode steps; the token fed at each step is
    the one ``toks`` gives (the CPU's greedy choices)."""
    kw = dict(mode=mode)
    z, caches = M.prefill(params, toks[:, :16], cfg, capacity=16 + steps,
                          aux=aux, **kw)
    out = [z.float().cpu()]
    for step in range(steps):
        z, caches = M.decode_step(params, caches, toks[:, 16 + step:17 + step],
                                  16 + step, cfg, **kw)
        out.append(z.float().cpu())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_family_on_the_card_matches_the_cpu(cuda, name):
    cfg = get_smoke_config(name)
    relaxed = ComputeMode.RELAXED
    params = M.init_params(cfg, 0, "cuda", torch.bfloat16)
    cpu = M.tree_map(lambda t: t.cpu(), params)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    n_aux = cfg.encoder_seq or cfg.num_image_tokens
    aux = torch.randn((2, n_aux, cfg.d_model), generator=g) if n_aux else None

    with torch.inference_mode():
        # The CPU's greedy continuation, then every run on those tokens.
        toks = prompt
        z, caches = M.prefill(cpu, prompt, cfg, capacity=18, aux=aux, mode=relaxed)
        for step in range(2):
            nxt = z.argmax(-1, keepdim=True)
            toks = torch.cat([toks, nxt], dim=1)
            z, caches = M.decode_step(cpu, caches, nxt, 16 + step, cfg, mode=relaxed)
        with RouteReplay(moe) as replay:
            z_cpu = _lockstep(cpu, cfg, toks, aux, relaxed)
            replay.start_replay()
            z_card = _lockstep(params, cfg, toks.cuda(),
                               None if aux is None else aux.cuda(), relaxed)
        replay.check_flips()

    rtol = mode_tolerance(relaxed)
    for zc, zh in zip(z_card, z_cpu):
        assert torch.isfinite(zc).all()
        limit = rtol * zh.abs().amax(-1, keepdim=True).clamp_min(1.0)
        assert ((zc - zh).abs() <= limit).all(), \
            (name, float(((zc - zh).abs() / limit).max()))
        top2 = zh.topk(2, dim=-1).values
        lead = (top2[:, 0] - top2[:, 1]) > limit[:, 0]
        assert (zc.argmax(-1) == zh.argmax(-1))[lead].all()
