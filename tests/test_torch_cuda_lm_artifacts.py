"""The artifact store and the dense LM on the card.

Every case is marked ``gpu`` and skips without a card.  They import no JAX:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_lm_artifacts.py``.

* A program stored from the card hydrates onto the card (every prepared
  tensor there), with the stored fingerprint, and its replay equals the
  stored program's bit for bit; ``device="cpu"`` hydrates the same bytes
  onto the host.
* The dense LM at the smoke sizes of the four dense configs, on the card
  against CPU copies of the same weights: prefill and decode logits within
  ``mode_tolerance(RELAXED)`` of the row's largest |logit|, with a ring
  cache (``window_override``) where the config allows one.
"""
import pytest
import torch

from repro_torch.artifacts import ArtifactStore
from repro_torch.cnn import alexnet, init_network_params
from repro_torch.configs import get_smoke_config
from repro_torch.core import ComputeMode, PlannerConfig, mode_tolerance, synthesize
from repro_torch.core.precision import QuantizedTensor
from repro_torch.data import imagenet_like
from repro_torch.nn import model as M


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tensors(prepared):
    for p in prepared.values():
        for v in p.values():
            yield from ((v.q, v.scale) if isinstance(v, QuantizedTensor) else (v,))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [ComputeMode.RELAXED, ComputeMode.IMPRECISE_INT8],
                         ids=lambda m: m.value)
def test_store_hydrates_onto_the_card(cuda, mode, tmp_path):
    net = alexnet(scale=0.25, input_hw=99, num_classes=100)
    params = init_network_params(net, 0, "cuda")
    cal = imagenet_like(1, 8, hw=99, num_classes=100, device="cuda")
    program = synthesize(net, params, cal, device="h100",
                         planner_config=PlannerConfig(batch=4), forced_mode=mode)
    store = ArtifactStore(str(tmp_path))
    fp = store.put_program(program)
    loaded = store.load_program(fp)                      # the card by default
    assert loaded is not None and loaded.fingerprint() == fp
    assert all(t.is_cuda for t in _tensors(loaded.prepared))
    x = cal[0][:4]
    a, b = program.for_batch(4)(x), loaded.for_batch(4)(x)
    assert torch.equal(a, b)
    on_host = store.load_program(fp, device="cpu")
    assert on_host.fingerprint() == fp
    assert all(t.device.type == "cpu" for t in _tensors(on_host.prepared))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-32b", "command-r-plus-104b",
                                  "gemma2-9b"])
def test_dense_lm_on_the_card_matches_the_cpu(cuda, name):
    cfg = get_smoke_config(name)
    mode = ComputeMode.RELAXED
    params = M.init_params(cfg, 0, "cuda", torch.bfloat16)
    cpu = M.tree_map(lambda t: t.cpu(), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    wo = 8 if cfg.long_context == "sliding_override" else 0
    rtol = mode_tolerance(mode)

    def close(z, z_cpu):
        limit = rtol * z_cpu.abs().amax(-1, keepdim=True).clamp_min(1.0)
        assert torch.isfinite(z).all()
        assert ((z.float().cpu() - z_cpu).abs() <= limit).all()

    kw = dict(mode=mode, window_override=wo)
    z, caches = M.prefill(params, toks.cuda(), cfg, capacity=20, **kw)
    z_cpu, caches_cpu = M.prefill(cpu, toks, cfg, capacity=20, **kw)
    close(z, z_cpu)
    for step in range(4):
        nxt = z_cpu.argmax(-1, keepdim=True)
        z, caches = M.decode_step(params, caches, nxt.cuda(), 16 + step, cfg, **kw)
        z_cpu, caches_cpu = M.decode_step(cpu, caches_cpu, nxt, 16 + step, cfg, **kw)
        close(z, z_cpu)
