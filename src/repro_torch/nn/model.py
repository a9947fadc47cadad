"""Model assembly: params, prefill and decode for every architecture family
of the config pool.

The port of ``repro.nn.model``'s serving path.  The block kinds:

* ``attn`` / ``attn_local`` / ``attn_global``: self-attention and an MLP, or
  a mixture of experts where the config has one (``nn/moe.py``);
* ``hybrid``: sliding-window attention and a mamba mixer (``nn/ssm.py``) on
  the same normed input, averaged, then the MLP (hymba);
* ``cross``: self-attention, cross-attention to encoder frames or image
  tokens, then the MLP (whisper, llama-vision); an encoder-decoder config
  runs :func:`encode` over its frames first;
* ``mlstm`` / ``slstm``: the xLSTM blocks (``nn/xlstm.py``).

The reference scans a stack of ``(G, ...)`` parameters over pattern periods;
the port keeps one parameter dict per layer (``params["layers"][i]``, of
kind ``cfg.block_pattern[i % P]``; a hybrid layer nests its mixer under
``"mamba"``, a cross layer its second attention under ``"cross"``; the
encoder's layers are ``params["enc_layers"]``) and runs them in a Python
loop.  :func:`params_from_reference` unstacks the reference's tree into that
form, which is how the tests run both packages on the same weights.

Meshes: every parameter definition carries the reference's logical axes
(:func:`param_axes`), which ``nn/sharding.py`` maps to mesh axes; the
model runs on DTensors as it runs on tensors, and emits the reference's
sharding constraints (the residual stream over the batch axes, the MLP's
hidden over 'model', the attention heads) only under an active mesh, so
with none the one-card paths are unchanged.  :func:`abstract_params` and
``init_cache(abstract=True)`` give shapes on the ``meta`` device for the
dry run; ``init_cache(mesh=)`` a sharded cache.

Training: :func:`forward` (logits) and :func:`loss_fn` (chunked
cross-entropy) run the same blocks with autograd recording; each layer is
checkpointed (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
on each scanned period), or, under ``cfg.remat_policy == "dots"``, keeps its
2-D matrix products and recomputes the rest.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.precision import ComputeMode
from .attention import KVCache, cross_attention, self_attention
from .config import ModelConfig
from .layers import checkpoint_if_recording, embed, mlp, rms_norm, unembed
from . import sharding as S
from .moe import moe_ffn
from .ssm import SSMState, mamba_mixer
from .xlstm import MLSTMState, SLSTMState, mlstm_block, slstm_block

ATTN_KINDS = ("attn", "attn_local", "attn_global", "cross", "hybrid")
BLOCK_KINDS = ATTN_KINDS + ("mlstm", "slstm")

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of a nest of dicts, lists and tuples
    (named tuples keep their type): parameters and caches alike."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> Iterator:
    """Every leaf of the nest, in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Parameters: name -> (shape, logical axes, fan_in), nested; fan_in 0 =
# zero-initialized.  The logical axes are the reference's (without its
# leading "layers" stacking axis); nn/sharding.py maps them to mesh axes.
# ---------------------------------------------------------------------------

Def = Tuple[Tuple[int, ...], Tuple[Optional[str], ...], int]


def _attn_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {"wq": ((d, h * hd), ("embed", "heads"), d),
         "wk": ((d, kv * hd), ("embed", "kv"), d),
         "wv": ((d, kv * hd), ("embed", "kv"), d),
         "wo": ((h * hd, d), ("heads", "embed"), h * hd)}
    if cfg.qkv_bias:
        p.update(bq=((h * hd,), ("heads",), 0), bk=((kv * hd,), ("kv",), 0),
                 bv=((kv * hd,), ("kv",), 0))
    if cfg.qk_norm:
        p.update(qnorm=((hd,), (None,), 0), knorm=((hd,), (None,), 0))
    return p


def _mlp_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": ((d, f), ("embed", "mlp"), d),
            "wu": ((d, f), ("embed", "mlp"), d),
            "wd": ((f, d), ("mlp", "embed"), f)}


def _moe_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {"router": ((d, e), ("embed", None), d),
            "wg": ((e, d, f), ("experts", "embed", None), d),
            "wu": ((e, d, f), ("experts", "embed", None), d),
            "wd": ((e, f, d), ("experts", None, "embed"), f)}


def _mamba_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n, cw = cfg.ssm.state_dim, cfg.ssm.conv_width
    return {"w_in": ((d, 2 * di), ("embed", "inner"), d),
            "conv_w": ((cw, di), (None, "inner"), 0),
            "w_dt": ((di, di), ("inner", None), di),
            "dt_bias": ((di,), ("inner",), 0),
            "A_log": ((di, n), ("inner", "state"), 0),
            "w_B": ((di, n), ("inner", "state"), di),
            "w_C": ((di, n), ("inner", "state"), di),
            "D": ((di,), ("inner",), 0),
            "w_out": ((di, d), ("inner", "embed"), di)}


def _mlstm_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d, h = cfg.d_model, cfg.num_heads
    di = 2 * d
    return {"w_in": ((d, 2 * di), ("embed", "inner"), d),
            "conv_w": ((4, di), (None, "inner"), 0),
            "wq": ((di, di), (None, "inner"), di),
            "wk": ((di, di), (None, "inner"), di),
            "wv": ((di, di), (None, "inner"), di),
            "w_i": ((di, h), (None, None), di),
            "w_f": ((di, h), (None, None), di),
            "cell_norm": ((di // h,), (None,), 0),
            "w_out": ((di, d), ("inner", "embed"), di)}


def _slstm_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d = cfg.d_model
    f43 = max((4 * d // 3 + 127) // 128 * 128, 128)
    return {"w_gates": ((d, 4 * d), ("embed", "inner"), d),
            "r_gates": ((4, d), (None, "inner"), 0),
            "cell_norm": ((d,), (None,), 0),
            "w_ff_g": ((d, f43), ("embed", "mlp"), d),
            "w_ff_u": ((d, f43), ("embed", "mlp"), d),
            "w_ff_d": ((f43, d), ("mlp", "embed"), f43)}


def _layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """One layer's parameter definitions, in the reference's key order;
    ``ValueError`` for an unknown kind."""
    norm = ((cfg.d_model,), (None,), 0)
    p: Dict[str, Any] = {"ln1": norm}
    if kind in ATTN_KINDS:
        p.update(_attn_defs(cfg))
        if kind == "cross":
            p["lnx"] = norm
            p["cross"] = _attn_defs(cfg)
        if kind == "hybrid":
            p["mamba"] = _mamba_defs(cfg)
        if cfg.sandwich_norm:
            p["ln1_post"] = norm
        if not cfg.parallel_block:
            p["ln2"] = norm
            if cfg.sandwich_norm:
                p["ln2_post"] = norm
        if cfg.moe is not None:
            p.update(_moe_defs(cfg))
        elif cfg.d_ff > 0:
            p.update(_mlp_defs(cfg))
    elif kind == "mlstm":
        p.update(_mlstm_defs(cfg))
    elif kind == "slstm":
        p.update(_slstm_defs(cfg))
    else:
        raise ValueError(f"unknown block kind {kind!r}; known: {BLOCK_KINDS}")
    return p


def _top_defs(cfg: ModelConfig) -> Dict[str, Def]:
    d, v = cfg.d_model, cfg.vocab_size
    p = {"embed": ((v, d), ("vocab", "embed"), d),
         "final_norm": ((d,), (None,), 0)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((d, v), ("embed", "vocab"), d)
    if cfg.is_encoder_decoder:
        p["enc_final_norm"] = ((d,), (None,), 0)
    return p


def layer_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.block_pattern[i % cfg.pattern_period]


def _is_def(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def _map_defs(fn: Callable[[Def], Any], defs):
    if _is_def(defs):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def _count(defs) -> int:
    if _is_def(defs):
        return math.prod(defs[0])
    return sum(_count(v) for v in defs.values())


def init_params(cfg: ModelConfig, generator: Union[torch.Generator, int],
                device: "str | torch.device" = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights drawn on ``device``: normal with the reference's
    ``1/sqrt(fan_in)`` scale, norms and biases zero, and the reference's
    fixes of the recurrent blocks: ``A_log = log(1..N)`` (decays in (0, 1)),
    ``dt_bias + 0.1``, and the last tap of every depthwise conv set to 1 (a
    conv of all-zero taps would be dead).  ``generator`` is a
    ``torch.Generator`` on ``device``, or a seed for one."""
    device = torch.device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))

    def draw(d: Def) -> torch.Tensor:
        shape, _, fan_in = d
        if fan_in == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * (1.0 / math.sqrt(fan_in))

    def fix(layer: dict) -> dict:
        if "mamba" in layer:
            m = layer["mamba"]
            n = torch.arange(1, cfg.ssm.state_dim + 1, dtype=torch.float32,
                             device=device)
            m["A_log"] = torch.log(n).to(dtype).expand(m["A_log"].shape).contiguous()
            m["conv_w"][-1] = 1.0
            m["dt_bias"] = m["dt_bias"] + 0.1
        if "conv_w" in layer:
            layer["conv_w"][-1] = 1.0
        return layer

    params = _param_tree(cfg, draw)
    params["layers"] = [fix(layer) for layer in params["layers"]]
    return params


def _param_tree(cfg: ModelConfig, fn: Callable[[Def], Any]) -> Dict[str, Any]:
    """``fn`` of every definition, in the parameter tree's layout and order:
    the top-level leaves, then ``layers``, then ``enc_layers``."""
    tree: Dict[str, Any] = _map_defs(fn, _top_defs(cfg))
    tree["layers"] = [_map_defs(fn, _layer_defs(cfg, layer_kind(cfg, i)))
                      for i in range(cfg.num_layers)]
    if cfg.is_encoder_decoder:
        tree["enc_layers"] = [_map_defs(fn, _layer_defs(cfg, "attn"))
                              for _ in range(cfg.encoder_layers)]
    return tree


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree with each leaf's logical-axes tuple (the
    reference's ``param_axes`` without its ``"layers"`` stacking axis, which
    its rules never shard)."""
    return _param_tree(cfg, lambda d: d[1])


def abstract_params(cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, nothing
    allocated."""
    return _param_tree(cfg, lambda d: torch.empty(d[0], dtype=dtype,
                                                  device="meta"))


def num_params(cfg: ModelConfig) -> int:
    """The parameter count, from the definitions (nothing is allocated)."""
    return (_count(_top_defs(cfg))
            + sum(_count(_layer_defs(cfg, layer_kind(cfg, i)))
                  for i in range(cfg.num_layers))
            + cfg.encoder_layers * _count(_layer_defs(cfg, "attn")))


def active_params(cfg: ModelConfig) -> int:
    """Parameters active per token: a MoE counts top_k of num_experts."""
    total = num_params(cfg)
    if cfg.moe is None:
        return total
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    expert_leaf = 0
    for i in range(cfg.num_layers):
        defs = _layer_defs(cfg, layer_kind(cfg, i))
        expert_leaf += sum(math.prod(defs[n][0]) for n in ("wg", "wu", "wd")
                           if n in defs and len(defs[n][0]) == 3)
    return total - expert_leaf + int(expert_leaf * k / e)


def _as_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":           # ml_dtypes: through the bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(cfg: ModelConfig, np_params: Dict[str, Any], *,
                          device: "str | torch.device" = "cuda",
                          dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's parameter tree (``repro.nn.model.init_params``
    layout; arrays as numpy or anything ``np.asarray`` takes) as the port's.

    ``np_params["blocks"]`` holds one (nested) dict per pattern position,
    each leaf stacked ``(G, ...)`` over the groups; layer ``g * P + p`` of
    the port is entry ``g`` of position ``p``.  ``enc_blocks`` holds one
    dict stacked over the encoder's layers.
    """
    conv = lambda a: _as_tensor(a, device, dtype)
    out: Params = {n: conv(np_params[n]) for n in _top_defs(cfg)}
    blocks = np_params["blocks"]
    period = cfg.pattern_period
    out["layers"] = [tree_map(lambda a: conv(np.asarray(a)[i // period]),
                              blocks[i % period])
                     for i in range(cfg.num_layers)]
    if cfg.is_encoder_decoder:
        out["enc_layers"] = [
            tree_map(lambda a: conv(np.asarray(a)[j]), np_params["enc_blocks"][0])
            for j in range(cfg.encoder_layers)]
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def resolve_window(cfg: ModelConfig, kind: str, window_override: int) -> int:
    if kind in ("attn_local", "hybrid"):
        return cfg.sliding_window
    if window_override > 0:
        return window_override
    return 0


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig,
         mode: ComputeMode) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_ffn(p, h, cfg, mode=mode)
    return mlp(p, h, activation=cfg.ffn_activation, mode=mode)


def apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: "torch.Tensor | range", mode: ComputeMode,
                window_override: int = 0, aux_kv: Optional[torch.Tensor] = None,
                cache=None, cache_pos: Optional[int] = None):
    """One block; returns (x, the layer's cache).  Without ``cache`` (a
    prefill) the cache is new, of the prompt's length; with it (a decode
    step at ``cache_pos``) K/V are written into it in place.  The cache of
    each kind is described in :func:`init_cache`."""
    # The residual stream stays sharded over the batch axes.
    x = S.constrain(x, S.BATCH, None, None)
    if kind in ATTN_KINDS:
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_cache = cache[0] if (cache is not None
                                  and kind in ("hybrid", "cross")) else cache
        attn_out, new_kv = self_attention(
            p, h, cfg, positions=positions, causal=True,
            window=resolve_window(cfg, kind, window_override),
            cache=attn_cache, cache_pos=cache_pos,
            return_cache=cache is None, mode=mode)
        if cfg.sandwich_norm:
            attn_out = rms_norm(attn_out, p["ln1_post"], cfg.norm_eps)

        new_cache = new_kv
        if kind == "hybrid":
            m_out, new_ssm = mamba_mixer(p["mamba"], h, cfg, mode=mode,
                                         state=cache[1] if cache is not None else None)
            new_cache = (new_kv, new_ssm)
            attn_out = 0.5 * (attn_out + m_out)
        elif kind == "cross":
            x_mid = x + attn_out
            hx = rms_norm(x_mid, p["lnx"], cfg.norm_eps)
            c_out, ckv = cross_attention(
                p["cross"], hx, aux_kv, cfg, mode=mode,
                precomputed_kv=cache[1] if cache is not None else None)
            new_cache = (new_kv, ckv)
            x = x_mid + c_out
            f = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, mode)
            if cfg.sandwich_norm:
                f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
            return x + f, new_cache

        if cfg.parallel_block:
            return x + attn_out + _ffn(p, h, cfg, mode), new_cache
        x = x + attn_out
        if cfg.d_ff > 0 or cfg.moe is not None:
            f = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, mode)
            if cfg.sandwich_norm:
                f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
            x = x + f
        return x, new_cache

    if kind in ("mlstm", "slstm"):
        block = mlstm_block if kind == "mlstm" else slstm_block
        out, st = block(p, rms_norm(x, p["ln1"], cfg.norm_eps), cfg, state=cache,
                        mode=mode)
        return x + out, st

    raise ValueError(f"unknown block kind {kind!r}; known: {BLOCK_KINDS}")


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  mode: ComputeMode) -> torch.Tensor:
    x = embed(params["embed"], tokens).to(mode.operand_dtype)
    if cfg.scale_embed:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    return x


def _unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
             mode: ComputeMode) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head, tied=cfg.tie_embeddings,
                   final_cap=cfg.final_logit_softcap, mode=mode)


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig,
            mode: ComputeMode) -> torch.Tensor:
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps),
                    cfg, mode)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           mode: ComputeMode = ComputeMode.RELAXED) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, Se, d):
    non-causal self-attention with rope over ``arange(Se)``, then the MLP,
    per layer; the final norm."""
    x = frames.to(mode.operand_dtype)
    positions = range(x.shape[1])
    for p in params["enc_layers"]:
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        out, _ = self_attention(p, h, cfg, positions=positions, causal=False,
                                window=0, mode=mode)
        x = x + out
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p, h2, activation=cfg.ffn_activation, mode=mode)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _aux_kv(params: Params, aux: Optional[torch.Tensor], cfg: ModelConfig,
            mode: ComputeMode, caller: str) -> Optional[torch.Tensor]:
    """What the ``cross`` layers attend to: the encoder's output over the
    frames, or the image tokens as they come."""
    if not (cfg.is_encoder_decoder or cfg.num_image_tokens):
        return None
    if aux is None:
        what = ("encoder frames (B, encoder_seq, d_model)"
                if cfg.is_encoder_decoder
                else "image tokens (B, num_image_tokens, d_model)")
        raise ValueError(f"{cfg.name}: {caller} needs aux= {what}")
    if cfg.is_encoder_decoder:
        return encode(params, aux, cfg, mode)
    return aux.to(mode.operand_dtype)


# ---------------------------------------------------------------------------
# Training: forward + loss
# ---------------------------------------------------------------------------

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of 2-D matrix products, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_layer(cfg: ModelConfig, fn: Callable, x: torch.Tensor):
    """``fn(x)`` under the config's layer checkpoint: everything recomputed
    in the backward (``"full"``), or all but the 2-D products (``"dots"``)."""
    fn = S.carry_mesh(fn)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, x, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    return checkpoint(fn, x, use_reentrant=False)


def _hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            aux: Optional[torch.Tensor], mode: ComputeMode,
            window_override: int, remat: bool, caller: str) -> torch.Tensor:
    """Embedding, every layer (each layer's cache dropped) and the final
    norm: (B, S) tokens -> (B, S, d) in the mode's operand dtype."""
    aux_kv = _aux_kv(params, aux, cfg, mode, caller)
    x = _embed_tokens(params, tokens, cfg, mode)
    positions = range(tokens.shape[1])
    for i, p in enumerate(params["layers"]):
        def layer(x, p=p, kind=layer_kind(cfg, i)):
            return apply_block(kind, p, x, cfg, positions=positions, mode=mode,
                               window_override=window_override, aux_kv=aux_kv)[0]
        x = _checkpoint_layer(cfg, layer, x) if remat and torch.is_grad_enabled() \
            else layer(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            aux: Optional[torch.Tensor] = None,
            mode: ComputeMode = ComputeMode.RELAXED,
            window_override: int = 0, remat: bool = True) -> torch.Tensor:
    """Training/eval forward: (B, S) tokens -> (B, S, V) logits in f32.

    ``aux``: the encoder frames or image tokens (B, S_aux, d) of a config
    with ``cross`` layers, as :func:`prefill` takes them.  ``remat``: where
    autograd records, checkpoint each layer (the backward recomputes it)."""
    x = _hidden(params, tokens, cfg, aux=aux, mode=mode,
                window_override=window_override, remat=remat, caller="forward")
    return _unembed(params, x, cfg, mode)


def loss_fn(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, *, aux: Optional[torch.Tensor] = None,
            mode: ComputeMode = ComputeMode.RELAXED,
            chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0 (a scalar f32).

    The sequence is padded to a multiple of ``chunk`` with labels -1; the
    logits, their logsumexp and the gold logit are taken ``chunk`` positions
    at a time, each chunk checkpointed, so the whole (B, S, V) tensor never
    exists (at vocab 152k and 4 x 1024 tokens it would be 2.5 GB in f32).
    Layers are checkpointed as :func:`forward`'s ``remat``."""
    x = _hidden(params, tokens, cfg, aux=aux, mode=mode, window_override=0,
                remat=True, caller="loss_fn")
    b, s = tokens.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.cat([x, S.zeros_placed_like(x, (b, pad, x.shape[2]))], dim=1)
        labels = torch.cat([labels, S.zeros_placed_like(labels, (b, pad)) - 1
                            if isinstance(labels, S.DTensor)
                            else labels.new_full((b, pad), -1)], dim=1)

    def chunk_loss(xc, lc):
        return _nll_sums(_unembed(params, xc, cfg, mode), lc)

    if isinstance(x, S.DTensor):
        chunk_loss = functools.partial(_sharded_chunk_loss, params, cfg=cfg,
                                       mode=mode)
    tot = cnt = S.replicated(torch.zeros((), dtype=torch.float32, device=x.device), x)
    for c0 in range(0, s + pad, chunk):
        nll, n = checkpoint_if_recording(chunk_loss, x[:, c0:c0 + chunk],
                                         labels[:, c0:c0 + chunk])
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of -log p(label), count) over the labels >= 0 of a chunk."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _sharded_chunk_loss(params: Params, xc, lc, *, cfg: ModelConfig,
                        mode: ComputeMode):
    """:func:`loss_fn`'s chunk on DTensors, vocabulary-parallel: each rank
    takes the logits of its slice of the vocabulary ('model') for its rows
    (the batch axes); the max, the sum of exponentials and the gold logit
    are reduced over 'model', and the (nll, count) sums are left pending
    over the batch axes."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    mesh = xc.device_mesh
    row = S.resolve(xc.shape, (S.BATCH,), mesh)
    vdim = 0 if cfg.tie_embeddings else 1
    head_axes = [None, None]
    head_axes[vdim] = "model"
    head_spec = S.resolve(head.shape, head_axes, mesh)
    vaxes = ("model",) if head_spec[vdim] else ()
    nv = head.shape[vdim] // S.group_size(mesh, vaxes)

    def local(xl, ll, hl):
        logits = unembed(xl, hl, tied=cfg.tie_embeddings,
                         final_cap=cfg.final_logit_softcap, mode=mode)
        if S.group_size(mesh, vaxes) == 1:
            return _nll_sums(logits, ll)
        m = S.pmax(logits.amax(dim=-1), mesh, vaxes)
        se = S.psum(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, vaxes)
        lo = S.coordinate(mesh, vaxes) * nv
        idx = torch.clamp(ll, min=0).long() - lo
        mine = (idx >= 0) & (idx < nv)
        g = logits.gather(-1, torch.where(mine, idx, torch.zeros_like(idx))[..., None])[..., 0]
        gold = S.psum(torch.where(mine, g, torch.zeros_like(g)), mesh, vaxes)
        valid = (ll >= 0).float()
        return torch.sum((m + torch.log(se) - gold) * valid), torch.sum(valid)

    rows = S.entry_axes(row[0])
    pl = [S.Partial() if a in rows else S.Replicate() for a in S.mesh_axes(mesh)]
    return S.local_map(local, [xc, lc, head], [row, row, head_spec], [pl, pl],
                       split_axes=vaxes)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, kind: str, seq_len: int,
                   window_override: int) -> int:
    w = resolve_window(cfg, kind, window_override)
    return min(seq_len, w) if w > 0 else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               window_override: int = 0, dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cuda",
               abstract: bool = False, mesh=None) -> List[Any]:
    """A zero decode cache for a context of ``seq_len``, one entry a layer
    (``abstract``: ``meta`` tensors of its shapes, nothing allocated;
    ``mesh``: DTensors on it in the reference's layout,
    :func:`sharding.cache_spec`, each rank's zeros its own shard):

    * ``attn`` kinds: a :class:`KVCache` (a ring of the window's size for a
      windowed layer);
    * ``hybrid``: (KVCache, :class:`SSMState`);
    * ``cross``: (KVCache, (k, v)) with the encoder's or image tokens'
      fused K and V, ``encoder_seq or num_image_tokens`` long;
    * ``mlstm``: :class:`MLSTMState`; ``slstm``: :class:`SLSTMState`.

    Recurrent states are f32; conv tails and K/V are ``dtype``.
    """
    width = cfg.num_kv_heads * cfg.resolved_head_dim
    f32 = torch.float32
    if abstract:
        zeros = lambda shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    elif mesh is not None:
        zeros = lambda shape, dt=dtype: S.zeros_sharded(
            shape, dt, mesh, S.cache_spec(shape, mesh), device)
    else:
        zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)

    def kv(kind):
        cap = cache_capacity(cfg, kind, seq_len, window_override)
        return KVCache(zeros((batch, cap, width)), zeros((batch, cap, width)))

    def layer(kind):
        if kind in ("attn", "attn_local", "attn_global"):
            return kv(kind)
        if kind == "cross":
            se = cfg.encoder_seq or cfg.num_image_tokens
            return (kv(kind), (zeros((batch, se, width)),
                               zeros((batch, se, width))))
        if kind == "hybrid":
            di = cfg.ssm.expand * cfg.d_model
            n, cw = cfg.ssm.state_dim, cfg.ssm.conv_width
            return (kv(kind), SSMState(h=zeros((batch, di, n), f32),
                                       conv=zeros((batch, cw - 1, di))))
        if kind == "mlstm":
            di, h = 2 * cfg.d_model, cfg.num_heads
            hd = di // h
            return MLSTMState(c=zeros((batch, h, hd, hd), f32),
                              n=zeros((batch, h, hd), f32),
                              m=zeros((batch, h), f32),
                              conv=zeros((batch, 3, di)))
        if kind == "slstm":
            d = cfg.d_model
            return SLSTMState(*(zeros((batch, d), f32) for _ in range(4)))
        raise ValueError(f"unknown block kind {kind!r}; known: {BLOCK_KINDS}")
    return [layer(layer_kind(cfg, i)) for i in range(cfg.num_layers)]


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            capacity: Optional[int] = None,
            aux: Optional[torch.Tensor] = None,
            mode: ComputeMode = ComputeMode.RELAXED,
            window_override: int = 0) -> Tuple[torch.Tensor, List[Any]]:
    """Process the prompt: (B, S) tokens -> (last-token logits (B, V) in f32,
    one decode cache per layer, as :func:`init_cache` lays them out).
    ``capacity`` (>= S, default S) sizes the K/V caches; a windowed layer
    keeps its last ``window`` tokens at slots ``pos % window``.  ``aux``:
    the encoder frames (B, encoder_seq, d) of an encoder-decoder config, or
    the image tokens (B, num_image_tokens, d) of a vision config."""
    b, s = tokens.shape
    capacity = capacity or s
    if capacity < s:
        raise ValueError(f"prefill of {s} tokens is longer than the cache "
                         f"capacity {capacity}")
    aux_kv = _aux_kv(params, aux, cfg, mode, "prefill")
    x = _embed_tokens(params, tokens, cfg, mode)
    positions = range(s)

    def expand_kv(kvc: KVCache, kind: str) -> KVCache:
        cap = cache_capacity(cfg, kind, capacity, window_override)
        if cap >= s:
            pad = lambda a: torch.cat(
                [a, S.zeros_placed_like(a, (b, cap - s, a.shape[2]))], dim=1)
            return KVCache(pad(kvc.k), pad(kvc.v))
        ring = lambda a: _seq_local(lambda t: torch.roll(t[:, -cap:], s % cap, dims=1), a)
        return KVCache(ring(kvc.k), ring(kvc.v))

    caches = []
    for i, p in enumerate(params["layers"]):
        kind = layer_kind(cfg, i)
        x, nc = apply_block(kind, p, x, cfg, positions=positions, mode=mode,
                            window_override=window_override, aux_kv=aux_kv)
        if kind in ("attn", "attn_local", "attn_global"):
            nc = expand_kv(nc, kind)
        elif kind in ("hybrid", "cross"):
            nc = (expand_kv(nc[0], kind), nc[1])
        caches.append(nc)
    return _logits(params, x[:, -1:], cfg, mode)[:, 0], caches


def _seq_local(fn: Callable, a):
    """``fn(a)`` for an ``fn`` that works along dim 1 (the sequence): on a
    DTensor, on each rank's shard, the sequence gathered first if a mesh
    axis shards it (DTensor has no rule for ``roll``)."""
    if not isinstance(a, S.DTensor):
        return fn(a)
    pl = tuple(S.Replicate() if isinstance(p, S.Shard) and p.dim == 1 else p
               for p in a.placements)
    return S.local_map(fn, [a], [pl], pl)


def decode_step(params: Params, caches: List[Any], token: torch.Tensor,
                pos: int, cfg: ModelConfig, *,
                mode: ComputeMode = ComputeMode.RELAXED,
                window_override: int = 0) -> Tuple[torch.Tensor, List[Any]]:
    """One serving step: the (B, 1) token at position ``pos`` -> (B, V)
    logits in f32 and the layers' caches.  Each layer's new K/V is written
    into its cache in place; recurrent states are returned anew."""
    pos = int(pos)
    x = _embed_tokens(params, token, cfg, mode)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    new_caches = []
    for i, (p, cache) in enumerate(zip(params["layers"], caches)):
        x, nc = apply_block(layer_kind(cfg, i), p, x, cfg, positions=positions,
                            mode=mode, window_override=window_override,
                            cache=cache, cache_pos=pos)
        new_caches.append(nc)
    return _logits(params, x, cfg, mode)[:, 0], new_caches
