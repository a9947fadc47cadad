"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages; outputs come back
as float32 numpy arrays and are compared under the JAX package's rule:
rtol = mode_tolerance(mode), atol = rtol * max(|reference|, 1).  JAX is
imported only where a helper needs it, so the ``gpu`` cases run on a
machine without JAX (``pytest --noconftest -m gpu``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.precision import ComputeMode, mode_tolerance

FLOAT_MODES = [ComputeMode.PRECISE, ComputeMode.RELAXED, ComputeMode.IMPRECISE]
#: Whole LM models against the reference: RELAXED mode_tolerance; PRECISE
#: 1e-5, as f32 sums of up to d_ff terms taken in another order by each
#: library differ by a few f32 ulps at the row's scale through every layer.
LM_RTOL = {ComputeMode.RELAXED: mode_tolerance(ComputeMode.RELAXED),
           ComputeMode.PRECISE: 1e-5}


def jax_mode(mode: ComputeMode):
    from repro.core.precision import ComputeMode as JaxMode
    return JaxMode(mode.value)


def to_jax(a: np.ndarray):
    import jax.numpy as jnp
    return jnp.asarray(a)


def to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def as_np(t) -> np.ndarray:
    """A JAX array or torch tensor (bf16 included) as float32 numpy."""
    if isinstance(t, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(t).detach().float().cpu().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(t, jnp.float32))


def assert_close(got, want, mode: ComputeMode, rtol: float = None):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = mode_tolerance(mode) if rtol is None else rtol
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


def reference_params(net, seed: int = 0, bias_scale: float = 0.1) -> dict:
    """He-normal weights for a network description (either package's), made
    with numpy and shaped by the JAX package's shape inference, with nonzero
    biases (both packages' own inits set biases to zero, which would hide
    the bias epilogue)."""
    from repro.cnn.params import infer_shapes
    rng = np.random.default_rng(seed)
    shapes = infer_shapes(net)
    params = {}
    for l in net.layers:
        if l.kind not in ("conv", "dense"):
            continue
        in_shape = shapes[l.inputs[0]]
        if l.kind == "conv":
            fan_in = in_shape[0] * l.kernel * l.kernel
            shape = (l.out_channels, in_shape[0], l.kernel, l.kernel)
        else:
            fan_in = int(np.prod(in_shape))
            shape = (fan_in, l.out_channels)
        w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        params[l.name] = {"w": w.astype(np.float32)}
        if l.use_bias:
            b = rng.standard_normal((l.out_channels,)) * bias_scale
            params[l.name]["b"] = b.astype(np.float32)
    return params


def params_to_jax(np_params: dict) -> dict:
    return {n: {k: to_jax(v) for k, v in p.items()} for n, p in np_params.items()}


# ------------------------------------------------------------ the LMs -----
#: Leaves drawn as 0.1 x normal: the reference's init sets them to zero,
#: which would hide ``1 + scale``, the biases, the skip ``D`` and the
#: recurrent gate weights.
LM_VECTORS = {"ln1", "ln2", "ln1_post", "ln2_post", "lnx", "final_norm",
              "enc_final_norm", "qnorm", "knorm", "bq", "bk", "bv", "D",
              "dt_bias", "cell_norm", "r_gates"}


def lm_np_params(cfg, seed: int = 0) -> dict:
    """Numpy weights for a JAX-package ``ModelConfig`` in the reference's
    layout (``blocks`` stacked (G, ...)): matrices normal / sqrt(fan_in)
    (the fan-in is the per-layer input axis, never the stacking axis),
    the vectors of ``LM_VECTORS`` 0.1 x normal, ``A_log`` near log(1..N)
    and depthwise conv taps 0.1 x normal with the last tap 1 (the decays
    and the identity-like conv the reference's init gives)."""
    import math

    import jax
    import jax.numpy as jnp
    from repro.nn import model as JM
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in LM_VECTORS:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "A_log":
            base = np.log(np.arange(1, leaf.shape[-1] + 1))
            return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "conv_w":
            w = 0.1 * rng.standard_normal(leaf.shape)
            w[..., -1, :] = 1.0
            return w.astype(np.float32)
        fan_in = leaf.shape[-1] if name == "embed" else leaf.shape[-2]
        return (rng.standard_normal(leaf.shape) / math.sqrt(fan_in)) \
            .astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        draw, JM.abstract_params(cfg, jnp.float32))


@functools.lru_cache(maxsize=None)
def jax_lm():
    """The reference's ``prefill`` and ``decode_step``, jitted with the
    config, capacity, mode and window static: (prefill(params, tokens,
    aux, cfg, capacity, mode, window_override), decode(params, caches,
    token, pos, cfg, mode, window_override))."""
    import jax
    from repro.nn import model as JM

    @functools.partial(jax.jit, static_argnames=("cfg", "capacity", "mode",
                                                 "window_override"))
    def prefill(params, tokens, aux, cfg, capacity, mode, window_override):
        return JM.prefill(params, tokens, cfg, capacity=capacity, aux=aux,
                          mode=mode, window_override=window_override)

    @functools.partial(jax.jit, static_argnames=("cfg", "mode",
                                                 "window_override"))
    def decode(params, caches, token, pos, cfg, mode, window_override):
        return JM.decode_step(params, caches, token, pos, cfg, mode=mode,
                              window_override=window_override)
    return prefill, decode


def lm_aux(cfg, batch: int, seed: int = 5):
    """Encoder frames or image tokens (B, S_aux, d) for a config with
    ``cross`` layers, else None."""
    n = cfg.encoder_seq or cfg.num_image_tokens
    if not n:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)


def check_greedy(logits, ref_logits, rtol: float) -> None:
    """The greedy token equal wherever the reference's lead over the
    runner-up exceeds twice the limit ``rtol * max(|row|, 1)``."""
    ours, ref = as_np(logits), as_np(ref_logits)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    limit = rtol * np.maximum(np.abs(ref).max(-1), 1.0)
    clear = (top2[:, 1] - top2[:, 0]) > 2 * limit
    assert (ours.argmax(-1)[clear] == ref.argmax(-1)[clear]).all()


def assert_caches_close(caches, ref_caches, cfg, mode: ComputeMode,
                        rtol: float) -> None:
    """Every layer's cache leaves (K/V, recurrent states, conv tails, cross
    K/V) against the reference's pattern position ``i % P``, group
    ``i // P``, each within ``rtol``."""
    import jax
    from repro_torch.nn.model import tree_leaves
    period = cfg.pattern_period
    for i, c in enumerate(caches):
        ours = list(tree_leaves(c))
        ref = jax.tree.leaves(ref_caches[i % period])
        assert len(ours) == len(ref), (i, len(ours), len(ref))
        for a, r in zip(ours, ref):
            assert_close(a, r[i // period], mode, rtol=rtol)


def _run_lm(run_prefill, run_decode, toks, seq: int, steps: int,
            snapshot=lambda caches: caches):
    """Prefill ``toks[:, :seq]`` then ``steps`` teacher-forced decode steps;
    returns (the logits of every call, a ``snapshot`` of the caches after
    prefill, the caches after the last step)."""
    logits, caches = run_prefill(toks[:, :seq])
    out, first = [logits], snapshot(caches)
    for step in range(steps):
        pos = seq + step
        logits, caches = run_decode(caches, toks[:, pos:pos + 1], pos)
        out.append(logits)
    return out, first, caches


def _row_error(got, want) -> float:
    """max |got - want| / max(|want row|, 1) over every row."""
    got, want = as_np(got), as_np(want)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1.0)
    return float((np.abs(got - want) / scale).max())


def relaxed_rtol(relaxed, exact, rtol: float) -> float:
    """``max(rtol, 2 e_ref)``, with ``e_ref`` the largest
    :func:`_row_error` of the reference's RELAXED outputs against its
    PRECISE ones (lists of arrays in the same order): two bf16 runs that
    each stray ``e_ref`` from the exact result differ by up to ``2 e_ref``."""
    return max(rtol, 2 * max(_row_error(r, x) for r, x in zip(relaxed, exact)))


def lm_parity(cfg, jcfg, np_params, mode: ComputeMode, rtol: float, *,
              batch: int = 2, seq: int = 16, steps: int = 4,
              capacity: int = 0, window_override: int = 0, seed: int = 7):
    """Prefill ``seq`` tokens, then ``steps`` decode steps (teacher forced),
    through both packages on the same weights: the logits of every call and
    every cache leaf after prefill and after the last step within ``rtol``,
    the greedy token as :func:`check_greedy` says.

    RELAXED also runs the reference under PRECISE (its exact result) and
    measures the reference's own RELAXED error, ``e_ref``: the largest
    |RELAXED - PRECISE| logit over the run, as a share of its row's largest
    |logit|.  Two bf16 runs that each stray ``e_ref`` from the exact result
    can differ by ``2 e_ref``, and the recurrent families stray more than
    ``mode_tolerance`` (tests/test_torch_lm_ssm.py and
    tests/test_torch_lm_xlstm.py give the numbers).  So RELAXED holds, with
    ``tol = max(rtol, 2 e_ref)``: (a) accuracy, the port's RELAXED logits
    within ``tol`` of the reference's PRECISE ones, row by row; (b)
    agreement, logits and caches within ``tol`` of the reference's RELAXED
    run.  Returns the port's caches after the last step."""
    import jax
    import jax.numpy as jnp
    from repro.core.precision import ComputeMode as JaxMode
    from repro_torch.nn import model as M
    prefill, decode = jax_lm()
    params = M.params_from_reference(cfg, np_params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq + steps))
    aux = lm_aux(cfg, batch)
    cap = capacity or seq + steps

    def port():
        return _run_lm(
            lambda t: M.prefill(
                params, torch.as_tensor(t), cfg, capacity=cap,
                aux=None if aux is None else torch.as_tensor(aux), mode=mode,
                window_override=window_override),
            lambda c, t, pos: M.decode_step(
                params, c, torch.as_tensor(t), pos, cfg, mode=mode,
                window_override=window_override),
            toks, seq, steps,
            # decode_step writes K/V in place: keep the prefill's copy.
            snapshot=lambda c: M.tree_map(torch.clone, c))

    def reference(m: ComputeMode):
        jm = JaxMode(m.value)
        return _run_lm(
            lambda t: prefill(jparams, jnp.asarray(t),
                              None if aux is None else jnp.asarray(aux),
                              jcfg, cap, jm, window_override),
            lambda c, t, pos: decode(jparams, c, jnp.asarray(t),
                                     jnp.int32(pos), jcfg, jm,
                                     window_override),
            toks, seq, steps)

    logits, caches0, caches = port()
    jlogits, jcaches0, jcaches = reference(mode)
    assert all(z.dtype == torch.float32 and z.shape == (batch, cfg.vocab_size)
               for z in logits)
    tol = rtol
    if mode is ComputeMode.RELAXED:
        exact = reference(ComputeMode.PRECISE)[0]
        tol = relaxed_rtol(jlogits, exact, rtol)
        e_port = max(_row_error(z, x) for z, x in zip(logits, exact))
        assert e_port <= tol, (e_port, tol)
    for z, jz in zip(logits, jlogits):
        assert_close(z, jz, mode, rtol=tol)
        check_greedy(z, jz, tol)
    assert_caches_close(caches0, jcaches0, cfg, mode, tol)
    assert_caches_close(caches, jcaches, cfg, mode, tol)
    return caches


class RouteReplay:
    """Holds a run to another run's MoE routing.  The top-k choice is
    discontinuous: bf16 rounding that differs between the card and the CPU
    can swap two experts whose probabilities nearly tie, and the outputs
    then differ by far more than any tolerance.  Inside ``with``, the first
    run records each ``moe.route`` call's probabilities and choices; after
    :meth:`start_replay`, a run takes the recorded choices in the same
    order, with its own probabilities at them (renormalized) as gate
    weights, and its own choices are kept for :meth:`check_flips`."""

    def __init__(self, moe_module):
        self.moe, self.orig = moe_module, moe_module.route
        self.recorded, self.own, self.replaying, self.i = [], [], False, 0

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def start_replay(self):
        self.replaying, self.i = True, 0

    def __call__(self, router_w, x, num_experts, top_k, mode):
        top_p, top_i, probs = self.orig(router_w, x, num_experts, top_k, mode)
        if not self.replaying:
            self.recorded.append((probs.float().cpu(), top_i.cpu()))
            return top_p, top_i, probs
        ref_probs, ref_i = self.recorded[self.i]
        self.i += 1
        self.own.append((probs.float().cpu(), top_i.cpu(), ref_probs, ref_i))
        ti = ref_i.to(x.device)
        tp = probs.gather(1, ti)
        return tp / torch.clamp(tp.sum(-1, keepdim=True), min=1e-9), ti, probs

    def check_flips(self) -> list:
        """Every replayed run made as many route calls as the recorded one,
        and wherever a run's own router chose another set of experts, the
        recorded run's k-th choice led its (k+1)-th by at most twice the
        largest difference between the two runs' probabilities in that
        row: a near-tie that rounding can swap.  Returns the number of such
        rows in each replayed run."""
        if not self.own:
            return []
        n = len(self.recorded)
        assert len(self.own) % n == 0, "a replayed run made another number of route calls"
        flips = [0] * (len(self.own) // n)
        for j, (probs, top_i, ref_probs, ref_i) in enumerate(self.own):
            k = ref_i.shape[1]
            differ = (torch.sort(top_i, -1).values != torch.sort(ref_i, -1).values).any(-1)
            srt = torch.sort(ref_probs, -1, descending=True).values
            gap = srt[:, k - 1] - srt[:, k]
            noise = (probs - ref_probs).abs().amax(-1)
            assert (gap[differ] <= 2 * noise[differ]).all(), \
                "a router chose other experts where the recorded choice led clearly"
            flips[j // n] += int(differ.sum())
        return flips
