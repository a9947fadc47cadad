"""Port parity of the LM training path (``repro_torch.nn.model.forward`` /
``loss_fn`` with autograd, ``repro_torch.launch.specs.make_train_step``)
against the JAX package on the CPU.

Weights are made with numpy in the reference's layout
(``_torch_parity.lm_np_params``) and handed to both packages; the
reference's gradients (``jax.value_and_grad(repro.nn.model.loss_fn)``,
stacked ``(G, ...)``) are unstacked with ``params_from_reference`` and
compared leaf by leaf.  One config per block kind: dense (qwen2-7b),
softcap + sandwich norm + local/global (gemma2-9b, window cut to 8 so the
local layers mask), parallel block (command-r-plus), MoE with drops
(granite, capacity factor 1.0), hybrid SSM (hymba, window 8), xLSTM,
encoder-decoder (whisper) and cross-attention to image tokens
(llama-vision).  Batch 2, 24 tokens, ``chunk=16`` (the loss pads to 32),
some labels -1.

Tolerances:

* PRECISE: the loss within rtol 1e-5; each gradient leaf within 1e-4 of
  the leaf's largest |g| (measured: at most 6.4e-6, and 5.5e-5 for the
  xLSTM, whose exponential gates amplify f32 rounding).
* RELAXED: bf16 noise, as ``lm_parity`` holds it: ``e_ref`` is the
  reference's own RELAXED error against its PRECISE run (the loss's
  relative error; for the gradients, the largest over the leaves of
  max |g_relaxed - g_precise| / max |g_precise|), and the limit is
  ``max(mode_tolerance(RELAXED), 2 e_ref)``.  The port's RELAXED loss and
  gradients are held within it of both the reference's PRECISE run
  (accuracy) and its RELAXED run (agreement).  The MoE case is PRECISE
  only: under RELAXED one bf16 ulp can swap near-tied experts.
* Chunked attention, mamba and mLSTM layers across several chunks:
  gradients within 1e-4 of the leaf's largest |g| in f32.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jax_configs
from repro.core.precision import ComputeMode as JaxMode
from repro.launch.specs import make_train_step as jax_make_train_step
from repro.nn import attention as jax_attention
from repro.nn import model as JM
from repro.nn import ssm as jax_ssm
from repro.nn import xlstm as jax_xlstm
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import configs
from repro_torch.core.precision import ComputeMode, mode_tolerance
from repro_torch.launch.specs import default_microbatches, make_train_step
from repro_torch.nn import attention, moe, ssm, xlstm
from repro_torch.nn import model as M
from repro_torch.optim import adamw_init

from _torch_parity import lm_aux, lm_np_params

jax.config.update("jax_platform_name", "cpu")

PRECISE, RELAXED = ComputeMode.PRECISE, ComputeMode.RELAXED
B, S, CHUNK = 2, 24, 16
#: Each gradient leaf under PRECISE, and the layer cases: share of the
#: leaf's largest |g|.
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
#: name -> the config fields changed (in both packages).
CASES = {
    "qwen2-7b": {},
    "gemma2-9b": {"sliding_window": 8},
    "command-r-plus-104b": {},
    "granite-moe-1b-a400m": {"capacity_factor": 1.0},
    "hymba-1.5b": {"sliding_window": 8},
    "xlstm-350m": {},
    "whisper-small": {},
    "llama-3.2-vision-90b": {},
}
PAIRS = [(n, m) for n in CASES for m in (PRECISE, RELAXED)
         if not (n == "granite-moe-1b-a400m" and m is RELAXED)]


def _configs(name):
    cfg, jcfg = configs.get_smoke_config(name), jax_configs.get_smoke_config(name)
    change = dict(CASES[name])
    if "capacity_factor" in change:
        f = change.pop("capacity_factor")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=f))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=f))
    return dataclasses.replace(cfg, **change), dataclasses.replace(jcfg, **change)


@partial(jax.jit, static_argnames=("cfg", "mode", "chunk"))
def _jax_value_and_grad(params, tokens, labels, aux, cfg, mode, chunk):
    return jax.value_and_grad(lambda p: JM.loss_fn(
        p, tokens, labels, cfg, aux=aux, mode=mode, chunk=chunk))(params)


def _inputs(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[0, -5:] = -1
    labels[1, 3] = -1
    return toks, labels, lm_aux(cfg, B)


def _leaf_errors(got, want):
    """max |got - want| / max |want| for each pair of leaves."""
    return [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            for g, w in zip(got, want)]


class _Reference:
    """The reference's loss and gradient leaves (in the port's leaf order)
    per (config, mode), each computed once for the module."""

    def __init__(self):
        self.cache = {}

    def __call__(self, name, mode):
        if (name, mode) not in self.cache:
            cfg, jcfg = _configs(name)
            np_params = lm_np_params(jcfg)
            toks, labels, aux = _inputs(cfg)
            loss, grads = _jax_value_and_grad(
                jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks),
                jnp.asarray(labels), None if aux is None else jnp.asarray(aux),
                jcfg, JaxMode(mode.value), CHUNK)
            leaves = [t.numpy() for t in M.tree_leaves(M.params_from_reference(
                cfg, jax.tree.map(np.asarray, grads), device="cpu"))]
            self.cache[name, mode] = (float(loss), leaves)
        return self.cache[name, mode]


@pytest.fixture(scope="module")
def reference():
    return _Reference()


def _port_loss_and_grads(name, mode, chunk=CHUNK):
    cfg, jcfg = _configs(name)
    params = M.params_from_reference(cfg, lm_np_params(jcfg), device="cpu")
    leaves = list(M.tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    toks, labels, aux = _inputs(cfg)
    loss = M.loss_fn(params, torch.as_tensor(toks), torch.as_tensor(labels), cfg,
                     aux=None if aux is None else torch.as_tensor(aux), mode=mode,
                     chunk=chunk)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("name,mode", PAIRS, ids=[f"{n}-{m.value}" for n, m in PAIRS])
def test_loss_and_every_gradient_match_the_reference(reference, monkeypatch, name, mode):
    dropped = []
    if CASES[name].get("capacity_factor"):
        orig = moe.assign_slots

        def spy(top_idx, num_experts, capacity):
            slot, keep = orig(top_idx, num_experts, capacity)
            dropped.append(int((~keep).sum()))
            return slot, keep
        monkeypatch.setattr(moe, "assign_slots", spy)
    loss, grads = _port_loss_and_grads(name, mode)
    ref_loss, ref_grads = reference(name, mode)
    assert np.isfinite(loss) and all(np.isfinite(g).all() for g in grads)
    assert len(grads) == len(ref_grads)
    assert all(g.shape == r.shape for g, r in zip(grads, ref_grads))
    if dropped:
        assert sum(dropped) > 0, "the capacity factor 1.0 case dropped no pair"
    if mode is PRECISE:
        assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss, ref_loss)
        errs = _leaf_errors(grads, ref_grads)
        assert max(errs) <= GRAD_RTOL, max(errs)
        return
    exact_loss, exact_grads = reference(name, PRECISE)
    rtol = mode_tolerance(RELAXED)
    loss_tol = max(rtol, 2 * abs(ref_loss - exact_loss) / abs(exact_loss))
    assert abs(loss - exact_loss) <= loss_tol * abs(exact_loss)
    assert abs(loss - ref_loss) <= loss_tol * abs(ref_loss)
    tol = max(rtol, 2 * max(_leaf_errors(ref_grads, exact_grads)))
    accuracy = _leaf_errors(grads, exact_grads)
    agreement = _leaf_errors(grads, ref_grads)
    assert max(accuracy) <= tol, (max(accuracy), tol)
    assert max(agreement) <= tol, (max(agreement), tol)


# ------------------------------------------------------------- forward -----
@pytest.mark.parametrize("name", ["qwen2-7b", "hymba-1.5b", "whisper-small"])
def test_forward_matches_the_reference_and_remat_changes_nothing(name):
    cfg, jcfg = _configs(name)
    np_params = lm_np_params(jcfg)
    toks, _, aux = _inputs(cfg)
    ref = JM.forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks), jcfg,
                     aux=None if aux is None else jnp.asarray(aux),
                     mode=JaxMode.PRECISE)
    weights = np.random.default_rng(4).standard_normal(
        (B, S, cfg.vocab_size)).astype(np.float32)
    runs = []
    for policy, remat in (("full", True), ("full", False), ("dots", True)):
        c = dataclasses.replace(cfg, remat_policy=policy)
        params = M.params_from_reference(c, np_params, device="cpu")
        leaves = list(M.tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        logits = M.forward(params, torch.as_tensor(toks), c, mode=PRECISE, remat=remat,
                           aux=None if aux is None else torch.as_tensor(aux))
        grads = torch.autograd.grad((logits * torch.as_tensor(weights)).sum(), leaves)
        runs.append((logits.detach(), grads))
    logits = runs[0][0]
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(np.asarray(ref)).max())
    # A layer checkpoint recomputes the same values: logits and gradients
    # equal bit for bit with and without it, and under "dots".
    for other, grads in runs[1:]:
        assert torch.equal(other, logits)
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


def test_loss_chunks_and_ignored_labels():
    """Any chunk gives the same mean over the valid labels as one
    cross-entropy over the whole logits; all labels -1 give 0."""
    cfg = configs.get_smoke_config("qwen2-7b")
    params = M.init_params(cfg, 0, "cpu")
    toks, labels, _ = _inputs(cfg)
    toks, labels = torch.as_tensor(toks), torch.as_tensor(labels)
    with torch.no_grad():
        logits = M.forward(params, toks, cfg, mode=PRECISE)
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), labels.reshape(-1), ignore_index=-1)
        for chunk in (5, 16, 24, 512):
            got = M.loss_fn(params, toks, labels, cfg, mode=PRECISE, chunk=chunk)
            assert abs(float(got) - float(want)) <= 1e-6 * float(want), chunk
        none = M.loss_fn(params, toks, torch.full_like(labels, -1), cfg, mode=PRECISE)
        assert float(none) == 0.0


def test_forward_needs_aux_for_cross_configs():
    cfg = configs.get_smoke_config("whisper-small")
    params = M.init_params(cfg, 0, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="forward needs aux="):
        M.forward(params, toks, cfg)
    with pytest.raises(ValueError, match="loss_fn needs aux="):
        M.loss_fn(params, toks, toks, cfg)


# ------------------------------------------------- layers over chunks -----
def _grads_vs_reference(port_fn, jax_fn, arrays):
    """Gradients of sum(out * w) through both, w fixed, for every array."""
    out_shape = jax.eval_shape(jax_fn, *map(jnp.asarray, arrays)).shape
    w = np.random.default_rng(9).standard_normal(out_shape).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch.autograd.grad((port_fn(*ts) * torch.as_tensor(w)).sum(), ts)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("cap,window", [(0.0, 0), (30.0, 5)])
def test_chunked_attention_gradients_across_query_and_key_chunks(cap, window):
    rng = np.random.default_rng(1)
    bq, sq, h, kv, hd = 2, 20, 4, 2, 8
    arrays = [rng.standard_normal((bq, sq, n, hd)).astype(np.float32)
              for n in (h, kv, kv)]
    kw = dict(causal=True, window=window, logit_cap=cap, scale=hd ** -0.5,
              q_chunk=8, k_chunk=8)
    pos = np.arange(sq)
    got, ref = _grads_vs_reference(
        lambda q, k, v: attention._chunk_attn(q, k, v, q_pos=torch.as_tensor(pos),
                                              k_pos=torch.as_tensor(pos), **kw),
        lambda q, k, v: jax_attention._chunk_attn(q, k, v, q_pos=jnp.asarray(pos),
                                                  k_pos=jnp.asarray(pos), **kw),
        arrays)
    assert max(_leaf_errors(got, ref)) <= GRAD_RTOL


def test_mlstm_gradients_across_chunks():
    rng = np.random.default_rng(2)
    b, s, h, hd = 2, 20, 2, 8
    arrays = [rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3)]
    arrays += [rng.standard_normal((b, s, h)).astype(np.float32),
               np.log(1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)]

    def state(mod, lib):
        return mod.MLSTMState(c=lib.zeros((b, h, hd, hd)), n=lib.zeros((b, h, hd)),
                              m=lib.full((b, h), -1e30), conv=None)
    got, ref = _grads_vs_reference(
        lambda *a: xlstm._mlstm_cell(*a, state(xlstm, torch), chunk=8)[0],
        lambda *a: jax_xlstm._mlstm_cell(*a, state(jax_xlstm, jnp), chunk=8)[0],
        arrays)
    assert max(_leaf_errors(got, ref)) <= GRAD_RTOL


def test_mlstm_gradients_stay_finite_over_a_long_chunk():
    """Over a 256-step chunk the forget gates' cumulative log reaches -200
    and exp(a_tau - M_t) for tau > t overflows: the reference's gradients
    of the gates are NaN there (it masks after exp), the port's are
    finite (it masks the exponent)."""
    rng = np.random.default_rng(0)
    b, s, h, hd = 1, 256, 2, 8
    arrays = [rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3)]
    arrays += [rng.standard_normal((b, s, h)).astype(np.float32),
               np.log(1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)]
    st = lambda mod, lib: mod.MLSTMState(c=lib.zeros((b, h, hd, hd)), n=lib.zeros((b, h, hd)),
                                         m=lib.full((b, h), -1e30), conv=None)
    got, ref = _grads_vs_reference(
        lambda *a: xlstm._mlstm_cell(*a, st(xlstm, torch))[0],
        lambda *a: jax_xlstm._mlstm_cell(*a, st(jax_xlstm, jnp))[0], arrays)
    assert all(np.isfinite(g).all() for g in got)
    assert not np.isfinite(ref[4]).all()
    assert max(_leaf_errors(got[:3], ref[:3])) <= GRAD_RTOL


def test_mamba_gradients_across_its_256_step_chunks():
    cfg, jcfg = _configs("hymba-1.5b")
    np_params = jax.tree.map(np.asarray, lm_np_params(jcfg))["blocks"][0]["mamba"]
    np_params = {k: v[0] for k, v in np_params.items()}
    x = np.random.default_rng(5).standard_normal((1, 300, cfg.d_model)).astype(np.float32)
    names = sorted(np_params)

    def port(x, *ws):
        return ssm.mamba_mixer(dict(zip(names, ws)), x, cfg, mode=PRECISE)[0]

    def ref(x, *ws):
        return jax_ssm.mamba_mixer(dict(zip(names, ws)), x, jcfg, mode=JaxMode.PRECISE)
    got, want = _grads_vs_reference(port, ref, [x] + [np_params[n] for n in names])
    assert max(_leaf_errors(got, want)) <= GRAD_RTOL


# ------------------------------------------------ TF32 in the backward -----
class _Tf32Seen(TorchDispatchMode):
    """Records torch.backends.cuda.matmul.allow_tf32 at every product."""

    PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")

    def __init__(self):
        super().__init__()
        self.flags = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.PRODUCTS:
            self.flags.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m", "hymba-1.5b",
                                  "xlstm-350m"])
def test_precise_products_run_without_tf32_in_the_backward_too(name):
    """With TF32 turned on for the process, every matrix product of a
    PRECISE loss and of its backward runs with it off."""
    cfg, _ = _configs(name)
    params = M.init_params(cfg, 0, "cpu")
    leaves = list(M.tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss = M.loss_fn(params, toks, toks, cfg, mode=PRECISE)
        with _Tf32Seen() as seen:
            torch.autograd.grad(loss, leaves)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert seen.flags and not any(seen.flags), seen.flags


# -------------------------------------------------------- train_step -----
@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_the_reference(microbatches):
    """Three steps of ``make_train_step`` (PRECISE) from the same weights and
    batches: the losses, the AdamW moments (gradients scaled and summed) and
    the parameters after each step."""
    cfg, jcfg = _configs("qwen2-7b")
    np_params = lm_np_params(jcfg)
    params = M.params_from_reference(cfg, np_params, device="cpu")
    for t in M.tree_leaves(params):
        t.requires_grad_(True)
    opt = adamw_init(params)
    step = make_train_step(cfg, PRECISE, microbatches=microbatches)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jopt = jax_adamw_init(jparams)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxMode.PRECISE, microbatches=microbatches))
    rng = np.random.default_rng(11)
    unstack = lambda tree: [t.numpy() for t in M.tree_leaves(M.params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), device="cpu"))]
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 16))
        labels = rng.integers(0, cfg.vocab_size, (4, 16))
        params, opt, loss = step(params, opt, {"tokens": torch.as_tensor(toks),
                                               "labels": torch.as_tensor(labels)})
        jparams, jopt, jloss = jstep(jparams, jopt, {"tokens": jnp.asarray(toks),
                                                     "labels": jnp.asarray(labels)})
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), i
        assert int(opt.step) == int(jopt.step) == i + 1
        for ours, ref in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
            got = [t.numpy() for t in M.tree_leaves(ours)]
            # nu holds squared gradients: twice the gradients' relative error.
            assert max(_leaf_errors(got, unstack(ref))) <= 2 * GRAD_RTOL, i
        got = [t.detach().numpy() for t in M.tree_leaves(params)]
        np.testing.assert_allclose(np.concatenate([g.ravel() for g in got]),
                                   np.concatenate([r.ravel() for r in unstack(jparams)]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["qwen2-7b", "command-r-plus-104b", "whisper-small"])
def test_default_microbatches_equal_the_reference(name):
    from repro.launch.specs import default_microbatches as jax_default
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    for batch, seq, width in ((4, 1024, 1), (256, 4096, 1), (256, 4096, 16), (1, 128, 1)):
        assert default_microbatches(cfg, batch, seq, width) == \
            jax_default(jcfg, batch, seq, batch_width=width), (batch, seq, width)
