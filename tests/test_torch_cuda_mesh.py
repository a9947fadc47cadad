"""Phase 13(a) of chip_smoke.py at a small size, on the card.

Every case is marked ``gpu`` and skips without a card; they import no JAX:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_cuda_mesh.py``.  A one-rank NCCL group and a 1x1 mesh on
``cuda:0``; for a decode, a prefill and a train step of small configs (2
layers, d_model 256) the step of ``build_lowering`` runs for real on
DTensors (``chip_smoke.mesh_pair``): argument bytes equal to the dry
run's, its FLOPs equal to a ``FlopCounterMode`` count of the real step,
and the result bit for bit the plain step's.  (The predicted peak is held
at full size, in chip_smoke.py.)
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def card_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield make_host_mesh(data=1, model=1, device_type="cuda")
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m", "hymba-1.5b",
                                  "xlstm-350m"])
@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_one_card_mesh_step_matches_the_plain_step_and_the_dry_run(card_mesh, arch, kind):
    sys.path.insert(0, ROOT)
    import chip_smoke

    from repro_torch.configs import get_config
    cfg = get_config(arch).scaled_down(layers=None, d_model=256)
    # The peak is held at full size in chip_smoke.py: at this size the
    # allocator's rounding of small blocks is a share of it.
    res = chip_smoke.mesh_pair(cfg, dict(seq_len=256, global_batch=4, kind=kind), card_mesh,
                               peak_rtol=None)
    assert res["bit_equal"] and res["flops"] == res["dry_flops"]
