"""Port parity of the xLSTM family (``repro_torch.nn.xlstm``, the ``mlstm``
and ``slstm`` kinds of ``repro_torch.nn.model``: xlstm-350m) against the
JAX package on the CPU.

Weights and inputs are made with numpy and handed to both packages
(tests/_torch_parity.py: rtol, and rtol x max(|reference|, 1) as atol).

* The mLSTM cell (f32 inputs): chunkwise against the reference's chunkwise
  cell and against the sequential recurrence, rtol 1e-4, the reference's own
  tests/test_xlstm_chunkwise.py bound (the chunkwise form sums the same
  terms in another order); one decode step, rtol 1e-5.
* The blocks and the whole model: PRECISE 1e-5 (``LM_RTOL``).  RELAXED
  ``max(mode_tolerance, 2 e_ref)`` (``relaxed_rtol``, ``lm_parity``): the
  reference's own RELAXED results stray from its PRECISE ones by ``e_ref``,
  up to 6.7 % of a row's largest |value| for one mLSTM block and 2.3-4.9 %
  of the largest |logit| for the smoke model (seeds 1-6 of
  ``lm_np_params``): the cell divides by max(|n.q|, exp(-m)), which
  amplifies bf16 rounding where |n.q| is small.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.precision import ComputeMode as JaxMode
from repro.nn import xlstm as jax_xlstm
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import configs
from repro_torch.core.precision import ComputeMode
from repro_torch.nn import model as M
from repro_torch.nn import xlstm
from repro_torch.serving import ServingEngine

from _torch_parity import (LM_RTOL, as_np, assert_close, lm_np_params,
                           lm_parity, relaxed_rtol)

jax.config.update("jax_platform_name", "cpu")

NAME = "xlstm-350m"
MODES = [ComputeMode.RELAXED, ComputeMode.PRECISE]
CELL_RTOL = 1e-4


def _cell_inputs(b, s, h, hd, seed):
    """The reference test's inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = (rng.standard_normal((b, s, h, hd)) / np.sqrt(hd)).astype(np.float32)
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    li = (rng.standard_normal((b, s, h)) * 2).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.standard_normal((b, s, h)) * 2, jnp.float32)))
    return q, k, v, li, lf


def _zero_state(pkg, b, h, hd):
    f = torch.float32
    if pkg is xlstm:
        return xlstm.MLSTMState(c=torch.zeros((b, h, hd, hd), dtype=f),
                                n=torch.zeros((b, h, hd), dtype=f),
                                m=torch.full((b, h), -1e30, dtype=f), conv=None)
    return jax_xlstm.MLSTMState(c=jnp.zeros((b, h, hd, hd)), n=jnp.zeros((b, h, hd)),
                                m=jnp.full((b, h), -1e30), conv=None)


def _sequential(q, k, v, li, lf, state):
    """The port's recurrence, one _mlstm_step per time step."""
    carry, ys = (state.c, state.n, state.m), []
    for t in range(q.shape[1]):
        carry, y = xlstm._mlstm_step(carry, (q[:, t], k[:, t], v[:, t],
                                             li[:, t], lf[:, t]))
        ys.append(y)
    return (torch.stack(ys, 1),) + carry


@pytest.mark.parametrize("s,chunk", [(30, 8), (17, 4), (16, 16), (50, 16)])
def test_mlstm_cell_across_chunk_borders(s, chunk):
    """Chunkwise with padding (s % chunk != 0 except 16/16): y and the
    (c, n, m) state against the reference's chunkwise cell and against the
    sequential recurrence."""
    arrs = _cell_inputs(2, s, 2, 8, seed=s)
    t = [torch.as_tensor(a) for a in arrs]
    got = xlstm._mlstm_cell(*t, _zero_state(xlstm, 2, 2, 8), chunk=chunk)
    want = jax_xlstm._mlstm_cell(*(jnp.asarray(a) for a in arrs),
                                 _zero_state(jax_xlstm, 2, 2, 8), chunk=chunk)
    seq = _sequential(*t, _zero_state(xlstm, 2, 2, 8))
    for g, w, r in zip(got, want, seq):
        np.testing.assert_allclose(as_np(g), np.asarray(w), rtol=CELL_RTOL,
                                   atol=CELL_RTOL)
        np.testing.assert_allclose(as_np(g), as_np(r), rtol=CELL_RTOL,
                                   atol=CELL_RTOL)


def test_mlstm_state_continues_across_calls():
    """13 steps, then 17 from the returned state (chunk 8, both calls
    padded): equal to one call over 30 and to the reference's two calls."""
    arrs = _cell_inputs(1, 30, 2, 8, seed=9)
    t = [torch.as_tensor(a) for a in arrs]
    y1, c1, n1, m1 = xlstm._mlstm_cell(*(a[:, :13] for a in t),
                                       _zero_state(xlstm, 1, 2, 8), chunk=8)
    y2, c2, n2, m2 = xlstm._mlstm_cell(
        *(a[:, 13:] for a in t), xlstm.MLSTMState(c1, n1, m1, None), chunk=8)
    whole = xlstm._mlstm_cell(*t, _zero_state(xlstm, 1, 2, 8), chunk=8)
    j = [jnp.asarray(a) for a in arrs]
    jy1, jc1, jn1, jm1 = jax_xlstm._mlstm_cell(*(a[:, :13] for a in j),
                                               _zero_state(jax_xlstm, 1, 2, 8),
                                               chunk=8)
    jy2, jc2, jn2, jm2 = jax_xlstm._mlstm_cell(
        *(a[:, 13:] for a in j), jax_xlstm.MLSTMState(jc1, jn1, jm1, None),
        chunk=8)
    y = torch.cat([y1, y2], 1)
    for got, ref in ((y, whole[0]), (c2, whole[1]), (m2, whole[3]),
                     (y, jnp.concatenate([jy1, jy2], 1)), (c2, jc2), (n2, jn2),
                     (m2, jm2)):
        np.testing.assert_allclose(as_np(got), as_np(ref), rtol=CELL_RTOL,
                                   atol=CELL_RTOL)


def test_mlstm_step_matches_reference():
    """One decode step (S == 1 takes _mlstm_step) from a nonzero state."""
    arrs = _cell_inputs(2, 6, 2, 8, seed=3)
    t = [torch.as_tensor(a) for a in arrs]
    _, c, n, m = xlstm._mlstm_cell(*(a[:, :5] for a in t),
                                   _zero_state(xlstm, 2, 2, 8), chunk=4)
    st = xlstm.MLSTMState(c, n, m, None)
    jst = jax_xlstm.MLSTMState(*(jnp.asarray(as_np(a)) for a in (c, n, m)), None)
    got = xlstm._mlstm_cell(*(a[:, 5:] for a in t), st)
    want = jax_xlstm._mlstm_cell(*(jnp.asarray(a[:, 5:]) for a in arrs), jst)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def _block_np(kind, seed):
    cfg = jax_configs.get_smoke_config(NAME)
    blocks = lm_np_params(cfg, seed)["blocks"]
    return {k: np.asarray(v)[0]
            for k, v in blocks[cfg.block_pattern.index(kind)].items()}


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_continue_their_state(kind, mode):
    """An mLSTM / sLSTM block over 11 tokens, then 7 more from the returned
    state, then 2 decode steps: outputs and every state leaf against the
    reference at each call.  RELAXED within ``relaxed_rtol``: one mLSTM
    block of the reference strays up to 6.7 % of a row's largest |value|
    from its own PRECISE output (seeds 4-6 of ``lm_np_params``)."""
    cfg, jcfg = configs.get_smoke_config(NAME), jax_configs.get_smoke_config(NAME)
    w = _block_np(kind, seed=4)
    pt = {k: torch.as_tensor(v) for k, v in w.items()}
    pj = {k: jnp.asarray(v) for k, v in w.items()}
    block = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    jblock = jax_xlstm.mlstm_block if kind == "mlstm" else jax_xlstm.slstm_block
    x = np.random.default_rng(5).standard_normal((2, 20, cfg.d_model)) \
        .astype(np.float32)

    def run(fn, m, as_input):
        st, outs = None, []
        for a, b in ((0, 11), (11, 18), (18, 19), (19, 20)):
            out, st = fn(as_input(x[:, a:b], m), st, m)
            outs.append((out, st))
        return outs

    ours = run(lambda xi, st, m: block(pt, xi, cfg, state=st, mode=m),
               mode, lambda a, m: torch.as_tensor(a).to(m.operand_dtype))
    jrun = lambda m: run(
        lambda xi, st, jm: jblock(pj, xi, jcfg, state=st, return_state=True,
                                  mode=jm),
        JaxMode(m.value), lambda a, jm: jnp.asarray(a).astype(
            jnp.float32 if jm is JaxMode.PRECISE else jnp.bfloat16))
    ref = jrun(mode)
    rtol = LM_RTOL[mode]
    if mode is ComputeMode.RELAXED:
        exact = jrun(ComputeMode.PRECISE)
        rtol = relaxed_rtol([o for o, _ in ref], [o for o, _ in exact], rtol)
    for (out, st), (jout, jst) in zip(ours, ref):
        assert_close(out, jout, mode, rtol=rtol)
        for got, want in zip(st, jst):
            assert_close(got, want, mode, rtol=rtol)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
def test_prefill_and_decode_match_the_reference(mode):
    """Prefill logits and the mLSTM / sLSTM states, then 4 decode steps
    (teacher forced)."""
    cfg, jcfg = configs.get_smoke_config(NAME), jax_configs.get_smoke_config(NAME)
    caches = lm_parity(cfg, jcfg, lm_np_params(jcfg, seed=1), mode,
                       LM_RTOL[mode])
    assert isinstance(caches[0], xlstm.MLSTMState)
    assert isinstance(caches[1], xlstm.SLSTMState)


def test_prefill_over_two_chunks_matches_the_reference():
    """A 300-token prompt: the mLSTM cell runs two chunks of 256, the second
    padded with inert steps (PRECISE)."""
    cfg, jcfg = configs.get_smoke_config(NAME), jax_configs.get_smoke_config(NAME)
    lm_parity(cfg, jcfg, lm_np_params(jcfg, seed=2), ComputeMode.PRECISE,
              LM_RTOL[ComputeMode.PRECISE], batch=1, seq=300, steps=2)


def test_serving_engine_matches_the_reference_engine():
    cfg, jcfg = configs.get_smoke_config(NAME), jax_configs.get_smoke_config(NAME)
    np_params = lm_np_params(jcfg, seed=4)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    ours = ServingEngine(cfg, M.params_from_reference(cfg, np_params, device="cpu"),
                         max_context=24, mode=ComputeMode.PRECISE, device="cpu")
    ref = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                           max_context=24, mode=JaxMode.PRECISE)
    r1 = ours.generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(r1.tokens, ours.generate(prompts, max_new_tokens=6).tokens)
    np.testing.assert_array_equal(
        r1.tokens, ref.generate(jnp.asarray(prompts), max_new_tokens=6).tokens)


def test_init_params_sets_the_mlstm_conv_tap():
    cfg = configs.get_smoke_config(NAME)
    params = M.init_params(cfg, 0, "cpu")
    mlstm_layer = params["layers"][cfg.block_pattern.index("mlstm")]
    assert torch.all(mlstm_layer["conv_w"][-1] == 1)
    assert torch.all(mlstm_layer["conv_w"][:-1] == 0)
