"""Port parity of the dense LM serving path (``repro_torch.nn``,
``repro_torch.configs``, ``repro_torch.serving.ServingEngine``,
``repro_torch.launch.serve``) against the JAX package on the CPU.

Weights are made with numpy in the reference's parameter layout and handed
to both packages (``params_from_reference`` unstacks them for the port).
Tolerances: an rtol, and rtol x max(|reference|, 1) as atol
(tests/_torch_parity.py).  Layers: ``mode_tolerance(mode)`` (PRECISE 1e-6,
RELAXED 2e-2).  Whole-model logits and caches: RELAXED 2e-2 and PRECISE
1e-5 (``LM_RTOL``): f32 sums of up to d_ff terms taken in another order by
each library, through every layer, differ by a few f32 ulps at the row's
scale.  The ring-buffer and chunked-attention mirrors keep the reference
tests' own tolerances (3e-4 and 2e-4).
"""
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.precision import ComputeMode as JaxMode
from repro.nn import attention as jax_attention
from repro.nn import layers as jax_layers
from repro.nn import model as JM
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import configs
from repro_torch.core.precision import ComputeMode
from repro_torch.launch import serve
from repro_torch.nn import attention, layers
from repro_torch.nn import model as M
from repro_torch.serving import ServingEngine

from _torch_parity import LM_RTOL, as_np, assert_close, check_greedy
from _torch_parity import lm_np_params as _np_params

jax.config.update("jax_platform_name", "cpu")

DENSE = ["qwen2-7b", "qwen3-32b", "command-r-plus-104b", "gemma2-9b"]
MODES = [ComputeMode.RELAXED, ComputeMode.PRECISE]
B, S = 2, 16


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    name = request.param
    cfg, jcfg = configs.get_smoke_config(name), jax_configs.get_smoke_config(name)
    np_params = _np_params(jcfg)
    params = M.params_from_reference(cfg, np_params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 4))
    return name, cfg, jcfg, params, jparams, toks


@partial(jax.jit, static_argnames=("cfg", "capacity", "mode", "window_override"))
def _jax_prefill(params, tokens, cfg, capacity, mode, window_override):
    return JM.prefill(params, tokens, cfg, capacity=capacity, mode=mode,
                      window_override=window_override)


@partial(jax.jit, static_argnames=("cfg", "mode", "window_override"))
def _jax_decode(params, caches, token, pos, cfg, mode, window_override):
    return JM.decode_step(params, caches, token, pos, cfg, mode=mode,
                          window_override=window_override)


# ------------------------------------------------------------- configs -----
@pytest.mark.parametrize("name", configs.all_arch_names())
def test_configs_equal_the_reference_field_by_field(name):
    ours, ref = configs.get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.scaled_down()) == \
        dataclasses.asdict(ref.scaled_down())
    assert dataclasses.asdict(configs.get_smoke_config(name)) == \
        dataclasses.asdict(jax_configs.get_smoke_config(name))
    assert configs.canonical(name) == jax_configs.canonical(name)
    assert configs.ALIASES == jax_configs.ALIASES
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS


def test_qwen2_7b_full_width():
    cfg = configs.get_config("qwen2_7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (28, 3584, 28, 4, 18944, 152064)
    assert 7.5e9 < M.num_params(cfg) < 7.7e9
    assert M.num_params(cfg) == sum(
        math.prod(leaf.shape)
        for leaf in jax.tree.leaves(JM.abstract_params(
            jax_configs.get_config("qwen2_7b"))))


# ------------------------------------------------------------ the model ----
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_prefill_and_decode_match_the_reference(dense, mode):
    """Prefill logits and caches, then 4 decode steps' logits (teacher
    forced), within LM_RTOL[mode]; the greedy token equal wherever the
    reference's lead over the runner-up exceeds twice that limit."""
    name, cfg, jcfg, params, jparams, toks = dense
    jmode = JaxMode(mode.value)
    cap = S + 4
    logits, caches = M.prefill(params, torch.as_tensor(toks[:, :S]), cfg,
                               capacity=cap, mode=mode)
    jlogits, jcaches = _jax_prefill(jparams, jnp.asarray(toks[:, :S]), jcfg,
                                    cap, jmode, 0)
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab_size)
    assert_close(logits, jlogits, mode, rtol=LM_RTOL[mode])
    period = cfg.pattern_period
    for i, c in enumerate(caches):
        ref = jcaches[i % period]
        assert c.k.dtype == mode.operand_dtype
        assert_close(c.k, ref.k[i // period], mode, rtol=LM_RTOL[mode])
        assert_close(c.v, ref.v[i // period], mode, rtol=LM_RTOL[mode])

    check_greedy(logits, jlogits, LM_RTOL[mode])
    for step in range(4):
        pos = S + step
        tok = toks[:, pos:pos + 1]
        logits, caches = M.decode_step(params, caches, torch.as_tensor(tok),
                                       pos, cfg, mode=mode)
        jlogits, jcaches = _jax_decode(jparams, jcaches, jnp.asarray(tok),
                                       jnp.int32(pos), jcfg, jmode, 0)
        assert_close(logits, jlogits, mode, rtol=LM_RTOL[mode])
        check_greedy(logits, jlogits, LM_RTOL[mode])


def test_sliding_window_decode_ring_buffer(dense):
    """Mirror of tests/test_archs.py: decode with a windowed (ring) cache
    agrees with the reference's windowed forward and with the port's own
    prefill of the whole sequence (PRECISE, rtol = atol = 3e-4)."""
    name, cfg, jcfg, params, jparams, toks = dense
    wo = 8 if cfg.long_context == "sliding_override" else 0
    t = toks[:, :S]
    full = JM.forward(jparams, jnp.asarray(t), jcfg, mode=JaxMode.PRECISE,
                      remat=False, window_override=wo)
    _, caches = M.prefill(params, torch.as_tensor(t[:, :S - 1]), cfg,
                          capacity=S, mode=ComputeMode.PRECISE,
                          window_override=wo)
    if wo:
        assert all(c.capacity == wo for c in caches)
    ld, _ = M.decode_step(params, caches, torch.as_tensor(t[:, S - 1:]),
                          S - 1, cfg, mode=ComputeMode.PRECISE,
                          window_override=wo)
    np.testing.assert_allclose(as_np(ld), np.asarray(full[:, -1]),
                               rtol=3e-4, atol=3e-4)
    whole, _ = M.prefill(params, torch.as_tensor(t), cfg,
                         mode=ComputeMode.PRECISE, window_override=wo)
    np.testing.assert_allclose(as_np(ld), as_np(whole), rtol=3e-4, atol=3e-4)


def test_prefill_ring_layout_matches_reference():
    """A prompt longer than the window: the ring keeps the last `window`
    tokens at slots pos % window, as the reference's roll does."""
    name = "qwen2-7b"
    cfg, jcfg = configs.get_smoke_config(name), jax_configs.get_smoke_config(name)
    np_params = _np_params(jcfg, seed=3)
    params = M.params_from_reference(cfg, np_params, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 13))
    _, caches = M.prefill(params, torch.as_tensor(toks), cfg, capacity=20,
                          mode=ComputeMode.PRECISE, window_override=5)
    _, jcaches = _jax_prefill(jax.tree.map(jnp.asarray, np_params),
                              jnp.asarray(toks), jcfg, 20, JaxMode.PRECISE, 5)
    for i, c in enumerate(caches):
        assert c.capacity == 5
        assert_close(c.k, jcaches[0].k[i], ComputeMode.PRECISE,
                     rtol=LM_RTOL[ComputeMode.PRECISE])


@pytest.mark.parametrize("stage", ["init_params", "num_params", "init_cache",
                                   "prefill"])
def test_unknown_block_kind_raises(stage):
    """A block kind outside the families raises ValueError naming it, as
    the reference's ``_block_defs`` and ``apply_block`` do."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-7b"),
                              block_pattern=("attn", "bogus"))
    good = configs.get_smoke_config("qwen2-7b")
    calls = {
        "init_params": lambda: M.init_params(cfg, 0, device="cpu"),
        "num_params": lambda: M.num_params(cfg),
        "init_cache": lambda: M.init_cache(cfg, 1, 8, device="cpu"),
        # The weights of a valid config; the bogus kind is met in apply_block.
        "prefill": lambda: M.prefill(M.init_params(good, 0, device="cpu"),
                                     torch.zeros((1, 4), dtype=torch.long), cfg),
    }
    with pytest.raises(ValueError, match="unknown block kind 'bogus'"):
        calls[stage]()


# --------------------------------------------------------- the layers -----
def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = np.arange(5)
    p = ComputeMode.PRECISE
    assert_close(layers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)),
                 jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), p)
    assert_close(layers.rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6),
                 jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), p,
                 rtol=1e-5)
    assert_close(layers.softcap(torch.as_tensor(x * 40), 30.0),
                 jax_layers.softcap(jnp.asarray(x * 40), 30.0), p, rtol=1e-5)
    w = {k: (rng.standard_normal(s) / 4).astype(np.float32)
         for k, s in (("wg", (16, 24)), ("wu", (16, 24)), ("wd", (24, 16)))}
    for act in ("silu", "gelu"):
        for mode in MODES:
            assert_close(
                layers.mlp({k: torch.as_tensor(v) for k, v in w.items()},
                           torch.as_tensor(x), activation=act, mode=mode),
                jax_layers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(x), activation=act,
                               mode=JaxMode(mode.value)), mode)
    head = (rng.standard_normal((40, 16)) / 4).astype(np.float32)
    for mode in MODES:
        assert_close(
            layers.unembed(torch.as_tensor(x), torch.as_tensor(head), tied=True,
                           final_cap=30.0, mode=mode),
            jax_layers.unembed(jnp.asarray(x), jnp.asarray(head), tied=True,
                               final_cap=30.0, mode=JaxMode(mode.value)), mode)


# ------------------------------------------------ _chunk_attn's cases -----
def _naive_attn(q, k, v, q_pos, k_pos, causal, window, cap, scale):
    """The reference test's naive softmax attention, in numpy (f64)."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if cap > 0:
        s = np.tanh(s / cap) * cap
    valid = k_pos[None, :] >= 0
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    s = np.where(valid[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("sq,sk,causal,window,cap,kv", [
    (1, 1, True, 0, 0.0, 3), (7, 30, True, 4, 0.0, 3), (16, 16, True, 16, 20.0, 1),
    (40, 60, True, 0, 20.0, 3), (13, 9, False, 0, 0.0, 3),
    (25, 25, True, 4, 0.0, 1), (3, 60, False, 0, 20.0, 1),
    (40, 40, True, 16, 0.0, 3)])
def test_chunked_matches_naive(sq, sk, causal, window, cap, kv):
    """The reference's hypothesis cases on a fixed grid (with GQA at kv=1):
    the port's chunks (7 x 9) against the naive attention and the
    reference's own _chunk_attn, rtol = atol = 2e-4."""
    if causal and sq > sk:
        sq = sk
    b, h, hd = 2, 3, 8
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    q_pos = np.arange(sk - sq, sk) if causal else np.arange(sq)
    k_pos = np.arange(sk)
    scale = 1.0 / math.sqrt(hd)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale,
              q_chunk=7, k_chunk=9)
    got = attention._chunk_attn(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), q_pos=torch.as_tensor(q_pos),
                                k_pos=torch.as_tensor(k_pos), **kw)
    ref = jax_attention._chunk_attn(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_pos=jnp.asarray(q_pos),
                                    k_pos=jnp.asarray(k_pos), **kw)
    want = _naive_attn(q, k, v, q_pos, k_pos, causal, window, cap, scale)
    np.testing.assert_allclose(as_np(got), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(as_np(got), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_chunked_bf16_matches_reference():
    """bf16 operands, f32 accumulation: within RELAXED of the reference."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=6, logit_cap=50.0, scale=0.25)
    pos = np.arange(20)
    got = attention._chunk_attn(*(torch.as_tensor(a).bfloat16() for a in (q, k, k)),
                                q_pos=torch.as_tensor(pos),
                                k_pos=torch.as_tensor(pos), **kw)
    ref = jax_attention._chunk_attn(*(jnp.asarray(a, jnp.bfloat16)
                                      for a in (q, k, k)),
                                    q_pos=jnp.asarray(pos),
                                    k_pos=jnp.asarray(pos), **kw)
    assert got.dtype == torch.bfloat16
    assert_close(got, ref, ComputeMode.RELAXED)


def test_invalid_slots_are_ignored():
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.standard_normal((1, 1, 2, 8)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((1, 10, 2, 8)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((1, 10, 2, 8)).astype(np.float32))
    k_pos_half = torch.where(torch.arange(10) < 5, torch.arange(10), -1)
    scale = 1.0 / math.sqrt(8)
    kw = dict(causal=True, window=0, logit_cap=0.0, scale=scale)
    out_half = attention._chunk_attn(q, k, v, q_pos=torch.tensor([9]),
                                     k_pos=k_pos_half, **kw)
    out_trunc = attention._chunk_attn(q, k[:, :5], v[:, :5],
                                      q_pos=torch.tensor([9]),
                                      k_pos=torch.arange(5), **kw)
    np.testing.assert_allclose(as_np(out_half), as_np(out_trunc),
                               rtol=1e-5, atol=1e-5)
    # A row with no valid key returns the f32-safe average, never NaN.
    none = attention._chunk_attn(q, k, v, q_pos=torch.tensor([9]),
                                 k_pos=torch.full((10,), -1), **kw)
    assert torch.isfinite(none).all()


def test_rope_rotation_is_relative():
    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.standard_normal((1, 1, 1, 16)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((1, 1, 1, 16)).astype(np.float32))

    def score(pq, pk):
        qr = layers.rope(q, torch.tensor([pq]), 10000.0)
        kr = layers.rope(k, torch.tensor([pk]), 10000.0)
        return float(torch.sum(qr * kr))
    assert abs(score(5, 3) - score(105, 103)) < 1e-3
    assert abs(score(5, 3) - score(5, 4)) > 1e-5


def test_ring_positions_match_the_reference():
    for cap, pos in ((8, 3), (8, 7), (8, 8), (8, 21), (5, 12)):
        idx = jnp.arange(cap)
        slot, wraps = pos % cap, pos // cap
        pos_abs = jnp.where(idx <= slot, wraps * cap + idx,
                            (wraps - 1) * cap + idx)
        want = np.asarray(jnp.where(pos_abs <= pos, pos_abs, -1))
        got = attention.ring_positions(cap, pos, "cpu").numpy()
        assert (got == want).all(), (cap, pos)


# ------------------------------------------------------ ServingEngine -----
@pytest.fixture(scope="module")
def qwen_smoke():
    cfg = configs.get_smoke_config("qwen2-7b")
    jcfg = jax_configs.get_smoke_config("qwen2-7b")
    np_params = _np_params(jcfg, seed=11)
    return (cfg, jcfg, M.params_from_reference(cfg, np_params, device="cpu"),
            jax.tree.map(jnp.asarray, np_params))


def test_serving_engine_greedy_deterministic(qwen_smoke):
    """Two calls give equal tokens, equal to the reference engine's on the
    same weights and prompts, and each is the argmax of the port's own
    prefill of the sequence so far (teacher forced)."""
    cfg, jcfg, params, jparams = qwen_smoke
    engine = ServingEngine(cfg, params, max_context=48,
                           mode=ComputeMode.PRECISE, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    r1 = engine.generate(prompts, max_new_tokens=8)
    r2 = engine.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.tokens.shape == (2, 8)
    ref = JaxServingEngine(jcfg, jparams, max_context=48, mode=JaxMode.PRECISE)
    np.testing.assert_array_equal(
        r1.tokens, ref.generate(jnp.asarray(prompts), max_new_tokens=8).tokens)
    seq = np.concatenate([prompts, r1.tokens], axis=1)
    for j in range(8):
        logits, _ = M.prefill(params, torch.as_tensor(seq[:, :16 + j]), cfg,
                              mode=ComputeMode.PRECISE)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      r1.tokens[:, j])


def test_serving_engine_eos_early_stop(qwen_smoke):
    cfg, _, params, _ = qwen_smoke
    engine = ServingEngine(cfg, params, max_context=64,
                           mode=ComputeMode.PRECISE, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
    probe = engine.generate(prompts, max_new_tokens=4)
    eos = int(probe.tokens[0, 1])
    res = engine.generate(prompts, max_new_tokens=32, eos_id=eos)
    assert res.steps <= 32
    finished = (res.tokens == eos).any(axis=1)
    assert finished.all() or res.steps == 32


def test_serving_engine_sampling_seeds_unique_per_step(qwen_smoke):
    """Every step samples with its own folded seed, never the base seed;
    the same base seed repeats the tokens, another one does not."""
    cfg, _, params, _ = qwen_smoke
    engine = ServingEngine(cfg, params, max_context=48,
                           mode=ComputeMode.PRECISE, device="cpu")
    seen = []
    orig = engine._sample

    def spy(logits, temperature, seed):
        assert seed is not None
        seen.append(seed)
        return orig(logits, temperature, seed)

    engine._sample = spy
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    gen = lambda seed: torch.Generator().manual_seed(seed)
    res = engine.generate(prompts, max_new_tokens=6, temperature=0.7,
                          generator=gen(5))
    assert res.tokens.shape == (2, 6)
    assert len(seen) == 6
    assert len(set(seen)) == len(seen), "a sampling seed was reused"
    assert 5 not in set(seen), "the raw base seed leaked into sampling"
    again = engine.generate(prompts, max_new_tokens=6, temperature=0.7,
                            generator=gen(5))
    np.testing.assert_array_equal(res.tokens, again.tokens)
    assert seen[:6] == seen[6:]
    other = engine.generate(prompts, max_new_tokens=6, temperature=0.7,
                            generator=gen(6))
    assert not np.array_equal(res.tokens, other.tokens)


@pytest.mark.parametrize("name", configs.all_arch_names())
def test_serve_launcher_runs_each_dense_arch(name, capsys):
    """Every config of every family, at 2 layers (or one pattern period)
    of width 64 on the CPU; cross configs get zero frames / image tokens."""
    res = serve.main(["--arch", name, "--layers", "2", "--d-model", "64",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={configs.get_config(name).name} batch=2 prompt=8 gen=4" in out
    assert res.tokens.shape == (2, 4)
