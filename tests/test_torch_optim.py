"""Port parity of ``repro_torch.optim`` (AdamW, the cosine schedule)
against the JAX package on the CPU.

Same numpy inputs through both.  Tolerances: the schedule within rtol 1e-6
of the reference's f32 value; AdamW over 5 steps (gradients drawn large
enough that global-norm clipping scales them) within rtol 1e-6, atol
1e-6 x the leaf's largest |value| on the parameters and moments (f32
products taken in another order: a few ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.nn.model import tree_leaves, tree_map
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule, global_norm)

jax.config.update("jax_platform_name", "cpu")
RTOL = 1e-6


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kw", [dict(peak_lr=3e-4, warmup=100, total=10000),
                                dict(peak_lr=1e-3, warmup=5, total=40, floor=0.0),
                                dict(peak_lr=2e-4, warmup=0, total=30)])
def test_cosine_schedule_matches_the_reference(kw):
    steps = list(range(0, kw["total"] + 10)) + [kw["total"] * 3]
    got = [float(cosine_schedule(s, **kw)) for s in steps]
    want = [float(jax_cosine_schedule(s, **kw)) for s in steps]
    _close(got, want)
    # An integer tensor step (the optimizer state's) gives the same values.
    _close([float(cosine_schedule(torch.tensor(s, dtype=torch.int32), **kw))
            for s in steps], want)


def _tree(rng):
    """A nest of dicts and lists, as the LM's parameters are (keys sorted,
    the order in which JAX flattens a dict)."""
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": [{"b": rng.standard_normal((8,)).astype(np.float32),
                        "w": rng.standard_normal((8, 8)).astype(np.float32)}
                       for _ in range(2)]}


@pytest.mark.parametrize("clip_norm,grad_scale", [(1.0, 1.0), (1.0, 0.01), (0.5, 3.0)])
def test_adamw_five_steps_match_the_reference(clip_norm, grad_scale):
    rng = np.random.default_rng(0)
    np_params = _tree(rng)
    params = tree_map(torch.from_numpy, np_params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    state, jstate = adamw_init(params), jax_adamw_init(jparams)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    clipped = []
    for i in range(5):
        np_grads = jax.tree.map(lambda a: (grad_scale * rng.standard_normal(a.shape))
                                .astype(np.float32), np_params)
        # A gradient tree whose dicts list their keys in another order.
        grads = {"layers": [{"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"])}
                            for g in np_grads["layers"]],
                 "embed": torch.from_numpy(np_grads["embed"])}
        jgrads = jax.tree.map(jnp.asarray, np_grads)
        norm = float(global_norm(grads))
        _close(norm, float(jax_global_norm(jgrads)))
        clipped.append(norm > clip_norm)
        lr = cosine_schedule(state.step, peak_lr=1e-2, warmup=2, total=10)
        jlr = jax_cosine_schedule(jstate.step, peak_lr=1e-2, warmup=2, total=10)
        params, state = adamw_update(grads, state, params, lr=lr, clip_norm=clip_norm)
        jparams, jstate = jax_adamw_update(jgrads, jstate, jparams, lr=jlr,
                                           clip_norm=clip_norm)
        assert int(state.step) == int(jstate.step) == i + 1
        for ours, ref in ((params, jparams), (state.mu, jstate.mu), (state.nu, jstate.nu)):
            for a, b in zip(tree_leaves(ours), jax.tree.leaves(ref)):
                _close(a.numpy(), np.asarray(b))
        # The gradients are left as they were.
        assert np.array_equal(grads["embed"].numpy(), np_grads["embed"])
    assert any(clipped) == (grad_scale > 0.1)


def test_adamw_keeps_each_parameter_dtype_and_updates_in_place():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
              "v": torch.ones((3,), dtype=torch.float32)}
    ids = {k: id(v) for k, v in params.items()}
    state = adamw_init(params)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.mu))
    grads = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16),
             "v": torch.full((3,), 0.5)}
    new, state = adamw_update(grads, state, params, lr=0.1)
    assert isinstance(state, AdamWState) and int(state.step) == 1
    assert {k: id(v) for k, v in new.items()} == ids
    assert new["w"].dtype == torch.bfloat16 and new["v"].dtype == torch.float32
    # One step from zero moments: delta = g / (|g| + eps) + 0.1 p per element.
    np.testing.assert_allclose(new["v"].numpy(), 1 - 0.1 * (1 + 0.1), rtol=1e-6)
