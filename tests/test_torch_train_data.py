"""What surrounds the training step in the port: the token stream and
``DataPipeline`` (``repro_torch.data``), checkpoints
(``repro_torch.checkpoint``) and the launcher (``repro_torch.launch.train``),
on the CPU.

* ``token_stream`` / ``lm_batches`` equal the reference's bit for bit.
* ``DataPipeline`` keeps the iterator's order, hands out tensors on the
  requested device, and raises the producer's exception (the reference ends
  the iteration instead).
* Checkpoints round-trip nested dicts, lists and named tuples, bf16
  included, bit for bit; a missing key is ``KeyError``, a shape mismatch
  ``ValueError``; for an f32 tree, each package reads the other's file
  exactly.
* ``launch.train --device cpu --layers 2 --d-model 64 --steps 6`` for a
  dense and a recurrent config: it writes a checkpoint that
  ``load_checkpoint`` reads, and the loss falls: the trained weights give
  the first batch a lower loss than the initial weights do.  (The printed
  first and final losses are of different batches, and six steps of the
  fixed warmup schedule move the loss less than batches differ.)
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.data import lm_batches as jax_lm_batches
from repro.data import token_stream as jax_token_stream
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, lm_batches, token_stream
from repro_torch.launch import train
from repro_torch.nn import model as M
from repro_torch.nn.model import tree_leaves

jax.config.update("jax_platform_name", "cpu")


# --------------------------------------------------------------- data -----
@pytest.mark.parametrize("seed,length,vocab", [(0, 4096, 1024), (7, 1000, 152064)])
def test_token_stream_equals_the_reference_bit_for_bit(seed, length, vocab):
    got, want = token_stream(seed, length, vocab), jax_token_stream(seed, length, vocab)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_lm_batches_equal_the_reference_bit_for_bit():
    ours = list(lm_batches(3, 4, 32, 1024, 5))
    ref = list(jax_lm_batches(3, 4, 32, 1024, 5))
    assert len(ours) == len(ref) == 5
    for (t, l), (rt, rl) in zip(ours, ref):
        assert t.shape == l.shape == (4, 32)
        assert np.array_equal(t, rt) and np.array_equal(l, rl)
        assert np.array_equal(t[:, 1:], l[:, :-1])


def test_pipeline_keeps_order_and_places_tensors_on_the_device():
    items = [{"tokens": np.full((2, 3), i, np.int64), "aux": [np.float32(i)]}
             for i in range(7)]
    got = list(DataPipeline(iter(items), prefetch=2, device="cpu"))
    assert len(got) == 7
    for i, item in enumerate(got):
        assert isinstance(item["tokens"], torch.Tensor)
        assert item["tokens"].device == torch.device("cpu")
        assert torch.equal(item["tokens"], torch.full((2, 3), i))
        assert float(item["aux"][0]) == i


def test_pipeline_raises_the_producers_error():
    def failing():
        yield (np.zeros(2),)
        raise RuntimeError("the data source broke")
    pipe = DataPipeline(failing(), device="cpu")
    assert torch.equal(next(pipe)[0], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="the data source broke"):
        next(pipe)
    with pytest.raises(RuntimeError, match="the data source broke"):
        next(pipe)


def test_pipeline_stops_at_the_end_of_the_data():
    pipe = DataPipeline(iter([np.ones(1)]), device="cpu")
    assert len(list(pipe)) == 1
    with pytest.raises(StopIteration):
        next(pipe)


# --------------------------------------------------------- checkpoints -----
class Pair(NamedTuple):
    first: torch.Tensor
    second: dict


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": torch.randn((5, 3), generator=g),
                       "layers": [{"w": torch.randn((3, 3), generator=g)},
                                  {"w": torch.randn((3, 3), generator=g).to(torch.bfloat16)}]},
            "opt": Pair(first=torch.tensor(3, dtype=torch.int32),
                        second={"mu": torch.randn((2,), generator=g, dtype=torch.float64)})}


def test_checkpoint_round_trip_is_bit_exact_bf16_included(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, step=12)
    target = M.tree_map(torch.zeros_like, tree)
    got, step = load_checkpoint(path, target, device="cpu")
    assert step == 12
    assert isinstance(got["opt"], Pair) and isinstance(got["params"]["layers"], list)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["__meta__", "params/embed", "params/layers/0/w", "params/layers/1/w",
             "opt/first", "opt/second/mu"])
        assert data["params/layers/1/w"].dtype == np.float32


def test_checkpoint_missing_key_and_shape_mismatch(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="checkpoint missing b"):
        load_checkpoint(path, {"b": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="a: shape"):
        load_checkpoint(path, {"a": torch.zeros(4)}, device="cpu")


class JaxPair(NamedTuple):
    first: object
    second: dict


def test_each_package_reads_the_others_checkpoint(tmp_path):
    """An f32 tree of dicts, a list and a named tuple (the field names make
    the keys in both packages)."""
    rng = np.random.default_rng(0)
    arrays = {"embed": rng.standard_normal((4, 2)).astype(np.float32),
              "w0": rng.standard_normal((2, 2)).astype(np.float32),
              "w1": rng.standard_normal((2, 2)).astype(np.float32),
              "mu": rng.standard_normal((3,)).astype(np.float32)}
    ours = {"layers": [{"w": torch.from_numpy(arrays["w0"])},
                       {"w": torch.from_numpy(arrays["w1"])}],
            "embed": torch.from_numpy(arrays["embed"]),
            "opt": Pair(first=torch.from_numpy(arrays["mu"]), second={})}
    theirs = {"layers": [{"w": jnp.asarray(arrays["w0"])}, {"w": jnp.asarray(arrays["w1"])}],
              "embed": jnp.asarray(arrays["embed"]),
              "opt": JaxPair(first=jnp.asarray(arrays["mu"]), second={})}
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(port_file, ours, step=5)
    jax_save_checkpoint(jax_file, theirs, step=5)

    read, step = jax_load_checkpoint(port_file, theirs)
    assert step == 5
    for a, b in zip(jax.tree.leaves(read), jax.tree.leaves(theirs)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    read, step = load_checkpoint(jax_file, ours, device="cpu")
    assert step == 5
    for a, b in zip(tree_leaves(read), tree_leaves(ours)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ launcher -----
@pytest.mark.parametrize("arch", ["qwen2-7b", "xlstm-350m"])
def test_launcher_trains_and_writes_a_checkpoint(tmp_path, capsys, arch):
    path = str(tmp_path / "train.npz")
    losses = train.main(["--arch", arch, "--layers", "2", "--d-model", "64",
                         "--steps", "6", "--batch", "8", "--seq", "128",
                         "--device", "cpu", "--checkpoint", path])
    out = capsys.readouterr().out
    assert "final loss" in out and f"saved {path}" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = get_config(arch).scaled_down(layers=2, d_model=64)
    initial = M.init_params(cfg, 0, "cpu")
    got, step = load_checkpoint(path, {"params": initial}, device="cpu")
    assert step == 6
    toks, labels = next(lm_batches(0, 8, 128, cfg.vocab_size, 6))
    toks, labels = (torch.as_tensor(a.astype(np.int64)) for a in (toks, labels))
    with torch.no_grad():
        before = float(M.loss_fn(initial, toks, labels, cfg))
        after = float(M.loss_fn(got["params"], toks, labels, cfg))
    assert np.isfinite(after) and after < before, (before, after)
