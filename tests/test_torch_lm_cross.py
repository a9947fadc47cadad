"""Port parity of the encoder-decoder and cross-attention families
(``repro_torch.nn.attention.cross_attention``, ``repro_torch.nn.model``'s
``cross`` kind and ``encode``: whisper-small, llama-3.2-vision-90b) against
the JAX package on the CPU.

Weights and inputs are made with numpy and handed to both packages
(tests/_torch_parity.py: rtol, and rtol x max(|reference|, 1) as atol).
Cross-attention and the encoder: RELAXED ``mode_tolerance``, PRECISE 1e-5
(``LM_RTOL``, f32 sums in another order).  The whole model: PRECISE 1e-5;
RELAXED ``max(mode_tolerance, 2 e_ref)`` (``lm_parity``), where ``e_ref``,
the reference's own RELAXED error against its PRECISE logits, is 1.5-2.1 %
of the row's largest |logit| at the smoke sizes (seeds 1-5 of
``lm_np_params``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.precision import ComputeMode as JaxMode
from repro.nn import attention as jax_attention
from repro.nn import model as JM
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import configs
from repro_torch.core.precision import ComputeMode
from repro_torch.nn import attention
from repro_torch.nn import model as M
from repro_torch.serving import ServingEngine

from _torch_parity import LM_RTOL, assert_close, lm_aux, lm_np_params, lm_parity

jax.config.update("jax_platform_name", "cpu")

CROSS = ["whisper-small", "llama-3.2-vision-90b"]
MODES = [ComputeMode.RELAXED, ComputeMode.PRECISE]


def _cross_np(jcfg, seed):
    """The first cross layer's ``cross`` weights of the smoke config."""
    blocks = lm_np_params(jcfg, seed)["blocks"]
    return {k: np.asarray(v)[0]
            for k, v in blocks[jcfg.block_pattern.index("cross")]["cross"].items()}


def _dt(mode):
    return jnp.float32 if mode is ComputeMode.PRECISE else jnp.bfloat16


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_with_and_without_precomputed_kv(qk_norm, mode):
    """Queries over 7 tokens attend to 23 encoder tokens (no mask, no
    rope; GQA 4:2); the returned K/V, handed back as ``precomputed_kv``
    with no source, give the same output (``knorm`` is not applied again)."""
    cfg = dataclasses.replace(configs.get_smoke_config("llama-3.2-vision-90b"),
                              num_kv_heads=2, qk_norm=qk_norm)
    jcfg = dataclasses.replace(jax_configs.get_smoke_config("llama-3.2-vision-90b"),
                               num_kv_heads=2, qk_norm=qk_norm)
    w = _cross_np(jcfg, seed=3)
    pt = {k: torch.as_tensor(v) for k, v in w.items()}
    pj = {k: jnp.asarray(v) for k, v in w.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    xt, st = (torch.as_tensor(a).to(mode.operand_dtype) for a in (x, src))
    xj, sj = (jnp.asarray(a).astype(_dt(mode)) for a in (x, src))
    jm = JaxMode(mode.value)
    out, (k, v) = attention.cross_attention(pt, xt, st, cfg, mode=mode)
    jout, (jk, jv) = jax_attention.cross_attention(pj, xj, sj, jcfg, mode=jm)
    rtol = LM_RTOL[mode]
    assert k.shape == (2, 23, 2 * cfg.resolved_head_dim)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        assert_close(got, want, mode, rtol=rtol)
    again, kv2 = attention.cross_attention(pt, xt, None, cfg, mode=mode,
                                           precomputed_kv=(k, v))
    jagain, _ = jax_attention.cross_attention(pj, xj, None, jcfg, mode=jm,
                                              precomputed_kv=(jk, jv))
    assert torch.equal(again, out)
    assert torch.equal(kv2[0], k) and torch.equal(kv2[1], v)
    assert_close(again, jagain, mode, rtol=rtol)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_encode_matches_reference(mode):
    """whisper's encoder (2 layers at the smoke size) over 32 frames:
    non-causal self-attention with rope, the MLP, the final norm."""
    cfg = configs.get_smoke_config("whisper-small")
    jcfg = jax_configs.get_smoke_config("whisper-small")
    np_params = lm_np_params(jcfg, seed=5)
    params = M.params_from_reference(cfg, np_params, device="cpu")
    assert len(params["enc_layers"]) == cfg.encoder_layers == 2
    frames = lm_aux(cfg, 2)
    got = M.encode(params, torch.as_tensor(frames), cfg, mode)
    want = JM.encode(jax.tree.map(jnp.asarray, np_params), jnp.asarray(frames),
                     jcfg, JaxMode(mode.value))
    assert got.dtype == mode.operand_dtype
    assert_close(got, want, mode, rtol=LM_RTOL[mode])


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("name", CROSS)
def test_prefill_and_decode_match_the_reference(name, mode):
    """Prefill logits, the self-attention K/V and the cross K/V of every
    cross layer (encoder frames or image tokens), then 4 decode steps
    (teacher forced) that reuse the cross K/V."""
    cfg, jcfg = configs.get_smoke_config(name), jax_configs.get_smoke_config(name)
    caches = lm_parity(cfg, jcfg, lm_np_params(jcfg, seed=1), mode,
                       LM_RTOL[mode])
    se = cfg.encoder_seq or cfg.num_image_tokens
    for i, c in enumerate(caches):
        if M.layer_kind(cfg, i) == "cross":
            assert c[1][0].shape == (2, se, cfg.num_kv_heads * cfg.resolved_head_dim)


@pytest.mark.parametrize("name", CROSS)
def test_prefill_without_aux_raises(name):
    cfg = configs.get_smoke_config(name)
    params = M.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="prefill needs aux="):
        M.prefill(params, torch.zeros((1, 4), dtype=torch.long), cfg)


@pytest.mark.parametrize("name", CROSS)
def test_serving_engine_matches_the_reference_engine(name):
    """``generate(aux=)``: greedy tokens of the port's engine equal the
    reference engine's on the same weights, prompts and frames / image
    tokens (PRECISE)."""
    cfg, jcfg = configs.get_smoke_config(name), jax_configs.get_smoke_config(name)
    np_params = lm_np_params(jcfg, seed=4)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    aux = lm_aux(cfg, 2, seed=6)
    ours = ServingEngine(cfg, M.params_from_reference(cfg, np_params, device="cpu"),
                         max_context=24, mode=ComputeMode.PRECISE, device="cpu")
    ref = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                           max_context=24, mode=JaxMode.PRECISE)
    r1 = ours.generate(prompts, max_new_tokens=6, aux=aux)
    np.testing.assert_array_equal(
        r1.tokens, ours.generate(prompts, max_new_tokens=6, aux=aux).tokens)
    np.testing.assert_array_equal(
        r1.tokens, ref.generate(jnp.asarray(prompts), max_new_tokens=6,
                                aux=jnp.asarray(aux)).tokens)
