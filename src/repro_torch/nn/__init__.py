"""The LM substrate of the port: configs, layers, attention and the dense
model (prefill and decode).  The port of ``repro.nn``; MoE, SSM, xLSTM,
cross-attention, encoders and sharding are ROADMAP.md queue 1's."""
from .attention import KVCache, self_attention
from .config import ModelConfig, MoEConfig, SSMConfig
from .model import (decode_step, init_cache, init_params,
                    params_from_reference, prefill, require_dense)

__all__ = [
    "KVCache", "ModelConfig", "MoEConfig", "SSMConfig", "decode_step",
    "init_cache", "init_params", "params_from_reference", "prefill",
    "require_dense", "self_attention",
]
