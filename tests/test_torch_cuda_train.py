"""The training path on the card.

Every case is marked ``gpu`` and skips without a card.  They import no JAX:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_train.py``.

* PRECISE gradients on the card with TF32 turned on for the process
  (``allow_tf32 = True`` for matmul and cuDNN): every product of the loss
  and of its backward must still run in full f32, so the loss and every
  gradient equal, bit for bit, the card's run with TF32 off.  Against the
  CPU's: the loss within rtol 1e-5, each gradient leaf within a relative L2
  error of 5e-4 (f32 sums taken in another order; measured on an H100:
  qwen2 and hymba within 1e-4, the xLSTM's worst leaf 1.7e-4, its
  exponential gates amplifying rounding).  The smoke configs (2 layers,
  d_model 256), f32 weights drawn on the CPU from a seed and copied to the
  card, batch 2 x 32 tokens.
* ``save_checkpoint`` / ``load_checkpoint`` of CUDA tensors, f32 and bf16,
  back onto the card bit for bit.
* ``DataPipeline(device="cuda")`` hands out CUDA tensors copied from pinned
  host memory.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import ComputeMode
from repro_torch.data import DataPipeline
from repro_torch.nn import model as M

PRECISE = ComputeMode.PRECISE


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _loss_and_grads(params, toks, cfg):
    leaves = list(M.tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = M.loss_fn(params, toks, toks.roll(-1, dims=1), cfg, mode=PRECISE)
    return float(loss.detach()), [g.cpu() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-7b", "hymba-1.5b", "xlstm-350m"])
def test_precise_gradients_on_the_card_match_the_cpu_with_tf32_on(cuda, name):
    cfg = get_smoke_config(name)
    cpu = M.init_params(cfg, 0, "cpu")
    card = M.tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    runs = []
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            runs.append(_loss_and_grads(card, toks.to(cuda), cfg))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    (loss_card, grads_card), (loss_off, grads_off) = runs
    assert loss_card == loss_off
    assert all(torch.equal(a, b) for a, b in zip(grads_card, grads_off))
    loss_cpu, grads_cpu = _loss_and_grads(cpu, toks, cfg)
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    errs = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip(grads_card, grads_cpu)]
    assert max(errs) <= 5e-4, max(errs)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn((64, 32), device=cuda, generator=g),
            "layers": [{"b": torch.randn((32,), device=cuda, generator=g).to(torch.bfloat16)}],
            "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    path = str(tmp_path / "card.npz")
    save_checkpoint(path, tree, step=7)
    got, step = load_checkpoint(path, M.tree_map(torch.empty_like, tree))
    assert step == 7
    for a, b in zip(M.tree_leaves(got), M.tree_leaves(tree)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_pipeline_copies_batches_to_the_card_from_pinned_memory(cuda, monkeypatch):
    pinned = []
    orig = torch.Tensor.pin_memory

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        pinned.append(out.is_pinned())
        return out
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    items = [{"tokens": np.full((2, 4), i, np.int64)} for i in range(3)]
    got = list(DataPipeline(iter(items), device="cuda"))
    torch.cuda.synchronize()
    assert pinned == [True] * 3
    for i, item in enumerate(got):
        assert item["tokens"].device.type == "cuda"
        assert torch.equal(item["tokens"].cpu(), torch.full((2, 4), i))
