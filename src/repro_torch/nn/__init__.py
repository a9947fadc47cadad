"""The LM substrate of the port: configs, layers, attention, the MoE, SSM
and xLSTM blocks, and the model of every family: training (``forward``,
``loss_fn``), prefill and decode, on one card or a DTensor mesh
(``sharding``).  The port of ``repro.nn``."""
from .attention import KVCache, cross_attention, self_attention
from .config import ModelConfig, MoEConfig, SSMConfig
from .model import (abstract_params, active_params, decode_step, encode, forward,
                    init_cache, init_params, loss_fn, num_params, param_axes,
                    params_from_reference, prefill, tree_leaves, tree_map)
from .moe import load_balance_loss, moe_ffn, route
from .ssm import SSMState, mamba_mixer
from .xlstm import MLSTMState, SLSTMState, mlstm_block, slstm_block

__all__ = [
    "KVCache", "MLSTMState", "ModelConfig", "MoEConfig", "SLSTMState",
    "SSMConfig", "SSMState", "abstract_params", "active_params", "cross_attention",
    "decode_step", "encode", "forward", "init_cache", "init_params",
    "load_balance_loss", "loss_fn",
    "mamba_mixer", "mlstm_block", "moe_ffn", "num_params", "param_axes",
    "params_from_reference", "prefill", "route", "self_attention",
    "slstm_block", "tree_leaves", "tree_map",
]
