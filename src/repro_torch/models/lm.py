"""Composable LM stacks (port of ``repro/models/lm.py``): dense, MoE,
hybrid (Mamba + attention), RWKV (``ssm``), enc-dec and VLM.

One :class:`ModelConfig` describes any of the ten architectures.  Layers are
grouped into the shortest repeating *pattern* (gemma2 -> [local, global],
Jamba -> its 8-layer period, dense -> [layer]) and the parameters of each
pattern position are stacked on a leading repeats axis, as in the
reference; :func:`apply_stack` loops over repeats x pattern in Python and
indexes the stacked leaves.  An enc-dec config adds an encoder stack
(:func:`encode`, over pre-embedded ``frames``) and a cross-attention
sub-block in each decoder layer; a VLM config takes pre-embedded
``patches`` as a bidirectional prefix.

Public API: :func:`lm_spec`, :func:`forward` / :func:`forward_hidden`
(scoring logits), :func:`encode`, :func:`init_cache` / :func:`prefill` /
:func:`decode_step` (serving).  The device is the parameters' device.  The
cache is ``{"layers": [...], "index": int}`` in the reference's layout with
a host-int index; :func:`prefill` and :func:`decode_step` write the new
keys, values and states into its tensors in place and return it with the
index advanced (an enc-dec :func:`prefill` sets each cross layer's
``xk`` / ``xv`` to the encoder's keys and values, as the reference
replaces them).

On the card, :func:`forward_hidden` (hence :func:`forward`) and the cache
path set :func:`repro_torch.device.match_xla_matmul` on each call, so that
bf16 and f32 products accumulate in f32 as XLA's do.

Training (:mod:`repro_torch.train.step`) differentiates
:func:`forward_hidden`; with grad enabled :func:`apply_stack` honours
``cfg.remat`` (see there).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as ckpt

from ..device import match_xla_matmul_on
from ..dist.sharding import constrain, heads_local, is_dtensor
from . import common as cm
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .attention import attention, cache_update
from .common import spec, stack_specs


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 32
    d_ff: int = 256
    vocab: int = 512

    # attention flavour
    use_rope: bool = True
    rope_theta: float = 10_000.0
    window: int = 0                 # sliding-window size for local layers
    local_global_period: int = 0    # >0: layer i local iff i % period != period-1
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_scale: float | None = None
    qkv_bias: bool = False
    parallel_block: bool = False    # command-r: x + attn(h) + ffn(h)
    sandwich_norm: bool = False     # gemma2 pre+post norms

    # norm / act / embeddings
    norm: str = "rms"               # rms | layer
    norm_eps: float = 1e-6
    norm_offset: float = 0.0        # 1.0 => gemma (1+w) convention
    act: str = "silu"
    tie_embeddings: bool = True
    embed_scale: float | None = None     # gemma: sqrt(d_model)
    logit_scale: float = 1.0
    embed_multiplier: float = 1.0        # granite
    residual_multiplier: float = 1.0     # granite
    pos_embed: str = "rope"              # rope | sinusoidal | none

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # hybrid (jamba): attention every `attn_period` layers at `attn_offset`
    attn_period: int = 0
    attn_offset: int = 4
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # rwkv
    rwkv_head_size: int = 64
    wkv_impl: str = "matmul"        # matmul (GLA-chunked) | scan

    # enc-dec
    enc_layers: int = 0

    # runtime knobs
    compute_dtype: str = "bfloat16"
    attn_impl: str = "chunked"      # chunked | naive | pallas
    scan_chunk: int = 256
    q_chunk: int = 512
    k_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots | offloadable

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def cdtype(self) -> torch.dtype:
        return cm.torch_dtype(self.compute_dtype)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                  # attn | mamba | rwkv
    moe: bool = False
    window: int = 0
    causal: bool = True
    cross: bool = False


def layer_kinds(cfg: ModelConfig, *, role: str = "decoder",
                n_layers: int | None = None) -> list[LayerSpec]:
    n = n_layers if n_layers is not None else cfg.n_layers
    out = []
    for i in range(n):
        if cfg.family == "ssm":
            kind = "rwkv"
        elif cfg.attn_period > 0:
            kind = ("attn" if i % cfg.attn_period == cfg.attn_offset
                    else "mamba")
        else:
            kind = "attn"
        moe = (cfg.n_experts > 0
               and i % cfg.moe_period == cfg.moe_offset
               and kind != "rwkv")
        if cfg.local_global_period > 0:
            window = (cfg.window
                      if i % cfg.local_global_period
                      != cfg.local_global_period - 1 else 0)
        else:
            window = cfg.window
        out.append(LayerSpec(
            kind=kind, moe=moe, window=window,
            causal=(role != "encoder"), cross=(role == "xdecoder")))
    return out


def find_pattern(kinds: list[LayerSpec]) -> tuple[list[LayerSpec], int]:
    """Shortest repeating prefix covering the whole layer list."""
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return kinds[:p], n // p
    return kinds, 1


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _norm_spec(cfg: ModelConfig, d: int) -> dict:
    if cfg.norm == "layer":
        return {"w": spec((d,), ("embed",), init="ones"),
                "b": spec((d,), ("embed",), init="zeros")}
    init = "zeros" if cfg.norm_offset else "ones"
    return {"w": spec((d,), ("embed",), init=init)}


def _apply_norm(cfg: ModelConfig, p: dict, x):
    if cfg.norm == "layer":
        return cm.layer_norm(x, p["w"], p["b"], eps=cfg.norm_eps)
    return cm.rms_norm(x, p["w"], eps=cfg.norm_eps, offset=cfg.norm_offset)


def _attn_spec(cfg: ModelConfig) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {
        "wq": spec((d, hq, dh), ("embed", "q_heads", "head")),
        "wk": spec((d, hkv, dh), ("embed", "kv_heads", "head")),
        "wv": spec((d, hkv, dh), ("embed", "kv_heads", "head")),
        "wo": spec((hq, dh, d), ("q_heads", "head", "embed"),
                   fan_in=hq * dh),
    }
    if cfg.qkv_bias:
        s["bq"] = spec((hq, dh), ("q_heads", "head"), init="zeros")
        s["bk"] = spec((hkv, dh), ("kv_heads", "head"), init="zeros")
        s["bv"] = spec((hkv, dh), ("kv_heads", "head"), init="zeros")
    return s


def _ffn_spec(cfg: ModelConfig, ls: LayerSpec) -> dict:
    if ls.moe:
        return moe_mod.moe_spec(cfg.d_model, cfg.d_ff, cfg.n_experts)
    return {
        "w_gu": spec((cfg.d_model, 2 * cfg.d_ff), ("embed", "mlp")),
        "w_down": spec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
    }


def layer_param_spec(cfg: ModelConfig, ls: LayerSpec) -> dict:
    d = cfg.d_model
    if ls.kind == "rwkv":
        return {
            "ln1": _norm_spec(cfg, d),
            "time": rwkv_mod.rwkv_time_spec(d, head_size=cfg.rwkv_head_size),
            "ln2": _norm_spec(cfg, d),
            "chan": rwkv_mod.rwkv_channel_spec(d, cfg.d_ff),
        }
    blk: dict = {"ln": _norm_spec(cfg, d)}
    if ls.kind == "attn":
        blk["attn"] = _attn_spec(cfg)
    else:
        blk["mamba"] = ssm_mod.mamba_spec(
            d, d_inner=cfg.d_inner, d_state=cfg.mamba_d_state,
            d_conv=cfg.mamba_d_conv)
    if cfg.sandwich_norm:
        blk["ln_post"] = _norm_spec(cfg, d)
    if ls.cross:
        blk["ln_x"] = _norm_spec(cfg, d)
        blk["xattn"] = _attn_spec(cfg)
    if not cfg.parallel_block:
        blk["ffn_ln"] = _norm_spec(cfg, d)
        if cfg.sandwich_norm:
            blk["ffn_ln_post"] = _norm_spec(cfg, d)
    blk["ffn"] = _ffn_spec(cfg, ls)
    return blk


def _decoder_role(cfg: ModelConfig) -> str:
    return "xdecoder" if cfg.is_encdec else "decoder"


def _stack_specs_for(cfg: ModelConfig, role: str, n_layers: int):
    kinds = layer_kinds(cfg, role=role, n_layers=n_layers)
    pattern, repeats = find_pattern(kinds)
    blocks = [stack_specs(layer_param_spec(cfg, ls), repeats)
              for ls in pattern]
    return pattern, repeats, blocks


def lm_spec(cfg: ModelConfig) -> dict:
    tree: dict = {
        "embed": spec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                      init="normal", scale=1.0),
        "final_norm": _norm_spec(cfg, cfg.d_model),
    }
    _, _, tree["blocks"] = _stack_specs_for(cfg, _decoder_role(cfg),
                                            cfg.n_layers)
    if not cfg.tie_embeddings:
        tree["unembed"] = spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    if cfg.is_encdec:
        _, _, tree["enc_blocks"] = _stack_specs_for(cfg, "encoder",
                                                    cfg.enc_layers)
        tree["enc_final_norm"] = _norm_spec(cfg, cfg.d_model)
    return tree


def init_params(cfg: ModelConfig, seed: int, *, device=None):
    """Random parameters of ``cfg`` from ``seed``, made on ``device`` (the
    GPU by default) at their storage dtypes (``common.storage_dtype``).
    On the ``meta`` device: the tree's shapes and dtypes, no storage."""
    dev = cm.resolve_device(device)
    return cm.materialize(lm_spec(cfg), cm.seeded_generator(seed, dev),
                          device=dev, compute_dtype=cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _attn_core(cfg: ModelConfig, ls: LayerSpec, p: dict, h, positions, *,
               cache=None, index=None, prefix_len=0, kv_override=None):
    """h (normed input) -> attention output.  ``kv_override`` (keys and
    values of the encoder) makes it cross-attention: RoPE on q only,
    non-causal, no cache."""
    rope = cfg.use_rope and cfg.pos_embed == "rope"
    q = torch.einsum("btd,dhk->bthk", h, p["wq"].to(h.dtype))
    if "bq" in p:
        q = q + p["bq"].to(h.dtype)
    if kv_override is None:
        k = torch.einsum("btd,dhk->bthk", h, p["wk"].to(h.dtype))
        v = torch.einsum("btd,dhk->bthk", h, p["wv"].to(h.dtype))
        if "bk" in p:
            k = k + p["bk"].to(h.dtype)
            v = v + p["bv"].to(h.dtype)
        if rope:
            k = cm.rope(k, positions, theta=cfg.rope_theta)
    else:
        k, v = kv_override
    if rope:
        q = cm.rope(q, positions, theta=cfg.rope_theta)

    kv_len = None
    q_offset = 0
    if cache is not None and kv_override is None:
        k, v = cache_update(cache["k"], cache["v"], k, v, index)
        kv_len = index + h.shape[1]
        q_offset = index
    attn = functools.partial(
        attention, causal=ls.causal and kv_override is None,
        window=ls.window, softcap=cfg.attn_softcap, prefix_len=prefix_len,
        q_offset=q_offset, scale=cfg.attn_scale, kv_len=kv_len,
        impl=cfg.attn_impl, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
    # on a mesh each rank attends over its own batch rows and heads, the
    # keys gathered along the sequence once (heads_local)
    o = heads_local(attn, q, k, v) if is_dtensor(q) else attn(q, k, v)
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(h.dtype))


def _ffn_core(cfg: ModelConfig, ls: LayerSpec, p: dict, h):
    """h (normed) -> (out, aux3) where aux3 = (lb, z, dropped)."""
    if ls.moe:
        y, aux = moe_mod.moe_apply(p, h, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   act=cfg.act)
        return y, torch.stack([aux["moe_load_balance"], aux["moe_z_loss"],
                               aux["moe_dropped_frac"]])
    w_gu = p["w_gu"].to(h.dtype)
    if is_dtensor(w_gu) and h[..., 0].numel() > w_gu.shape[0]:
        # on a mesh, splitting the product sharded over "mlp" into its gate
        # and up halves gathers it whole; with more tokens than model dims
        # the weight's halves are the smaller thing to gather, so run two
        # products on them
        ff = w_gu.shape[-1] // 2
        g, u = h @ w_gu[:, :ff], h @ w_gu[:, ff:]
    else:
        g, u = torch.chunk(h @ w_gu, 2, dim=-1)
    y = cm.ACTIVATIONS[cfg.act](g.float()).to(h.dtype) * u
    return (y @ p["w_down"].to(h.dtype),
            torch.zeros((3,), dtype=torch.float32, device=h.device))


def _rwkv_block(cfg: ModelConfig, p: dict, x, cache):
    """One RWKV block (time mix, channel mix, residuals); ``cache`` is
    updated in place."""
    rm = cfg.residual_multiplier
    h = _apply_norm(cfg, p["ln1"], x)
    y, (tm_shift, tm_state) = rwkv_mod.rwkv_time_mix(
        p["time"], h, head_size=cfg.rwkv_head_size, chunk=cfg.scan_chunk,
        impl=cfg.wkv_impl,
        state=None if cache is None else (cache["tm_shift"],
                                          cache["tm_state"]))
    x = x + rm * y
    h = _apply_norm(cfg, p["ln2"], x)
    y, cm_shift = rwkv_mod.rwkv_channel_mix(
        p["chan"], h, state=None if cache is None else cache["cm_shift"])
    if cache is not None:
        cache["tm_shift"].copy_(tm_shift)
        cache["tm_state"].copy_(tm_state)
        cache["cm_shift"].copy_(cm_shift)
    return x + rm * y


def apply_layer(cfg: ModelConfig, ls: LayerSpec, p: dict, x, positions, *,
                cache=None, index=None, prefix_len=0, enc_kv=None):
    """One attention, Mamba or RWKV block with its FFN (and, in an enc-dec
    decoder, its cross-attention over ``enc_kv``) and residuals.  ``cache``
    (this layer's slice of the serving cache) is updated in place.
    Returns (x, aux3)."""
    rm = cfg.residual_multiplier
    if ls.kind == "rwkv":
        return (_rwkv_block(cfg, p, x, cache),
                torch.zeros((3,), dtype=torch.float32, device=x.device))
    h = _apply_norm(cfg, p["ln"], x)
    if ls.kind == "attn":
        o = _attn_core(cfg, ls, p["attn"], h, positions,
                       cache=None if cache is None else cache["attn"],
                       index=index, prefix_len=prefix_len)
    else:
        o, (conv, ssm) = ssm_mod.mamba_apply(
            p["mamba"], h, d_state=cfg.mamba_d_state, chunk=cfg.scan_chunk,
            impl=cfg.attn_impl,
            state=None if cache is None else (cache["conv"], cache["ssm"]))
        if cache is not None:
            cache["conv"].copy_(conv)
            cache["ssm"].copy_(ssm)
    # a sub-layer's output joins the residual stream at its spec: on a mesh
    # a row-parallel product leaves a partial sum, which DTensor would
    # otherwise carry through the next norm into the next product and run
    # that product whole on every rank of the model axis
    o = constrain(o, ("batch", "seq", None))

    if cfg.parallel_block:
        f, aux = _ffn_core(cfg, ls, p["ffn"], h)
        return x + rm * (o + constrain(f, ("batch", "seq", None))), aux
    if cfg.sandwich_norm:
        o = _apply_norm(cfg, p["ln_post"], o)
    x = x + rm * o
    if ls.cross:
        h = _apply_norm(cfg, p["ln_x"], x)
        x = x + rm * constrain(_attn_core(cfg, ls, p["xattn"], h, positions,
                                          kv_override=enc_kv),
                               ("batch", "seq", None))
    h = _apply_norm(cfg, p["ffn_ln"], x)
    f, aux = _ffn_core(cfg, ls, p["ffn"], h)
    f = constrain(f, ("batch", "seq", None))
    if cfg.sandwich_norm:
        f = _apply_norm(cfg, p["ffn_ln_post"], f)
    return x + rm * f, aux


def _at(tree, r: int):
    """Repeat ``r`` of a tree of stacked leaves (views, no copies)."""
    return cm.tree_map(lambda _, t: t[r], tree) if isinstance(
        tree, dict) else tree[r]


def _cross_kv(cfg: ModelConfig, p_attn: dict, enc_out):
    k = torch.einsum("btd,dhk->bthk", enc_out, p_attn["wk"].to(enc_out.dtype))
    v = torch.einsum("btd,dhk->bthk", enc_out, p_attn["wv"].to(enc_out.dtype))
    if "bk" in p_attn:
        k = k + p_attn["bk"].to(enc_out.dtype)
        v = v + p_attn["bv"].to(enc_out.dtype)
    return k, v


def apply_stack(cfg: ModelConfig, blocks, x, positions, *, role="decoder",
                n_layers=None, caches=None, index=None, prefix_len=0,
                enc_out=None, enc_kv_cached=False):
    """Every layer of the ``role`` stack in order (repeat-major); returns
    (x, aux3).  A cross layer attends to the ``xk`` / ``xv`` of its cache
    when ``enc_kv_cached``, else to the projection of ``enc_out``.

    The stacked leaves are split once with ``unbind`` (views, as indexing;
    under autograd its backward stacks the repeats' gradients in one copy,
    where indexing each repeat would add a zero-filled full-size tensor a
    repeat).  When autograd records the stack (grad enabled, no caches,
    and the input or a parameter requires grad: training), each repeat of
    the pattern runs under :func:`torch.utils.checkpoint.checkpoint` when
    ``cfg.remat`` (the reference's ``jax.checkpoint`` of its scan body, at
    ``cfg.remat_policy``)."""
    pattern, repeats = find_pattern(layer_kinds(cfg, role=role,
                                                n_layers=n_layers))
    split = [{path: t.unbind(0) for path, t in cm.leaves(b)} for b in blocks]

    def repeat(r, x, aux):
        for j, ls in enumerate(pattern):
            p = cm.tree_map(lambda path, _: split[j][path][r], blocks[j])
            cache = None if caches is None else _at(caches[j], r)
            enc_kv = None
            if ls.cross:
                if enc_kv_cached:
                    enc_kv = (cache["xk"], cache["xv"])
                elif enc_out is not None:
                    enc_kv = _cross_kv(cfg, p["xattn"], enc_out)
            x, a = apply_layer(cfg, ls, p, x, positions, cache=cache,
                               index=index, prefix_len=prefix_len,
                               enc_kv=enc_kv)
            # pin the residual stream to its logical sharding between
            # layers, as the reference does
            x = constrain(x, ("batch", "seq", None))
            aux = aux + a
        return x, aux

    training = caches is None and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for b in blocks
                               for _, t in cm.leaves(b)))
    if training and cfg.remat:
        repeat = _rematted(repeat, cfg.remat_policy)
    aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    for r in range(repeats):
        x, aux = repeat(r, x, aux)
    return x, aux


# the products whose outputs the "dots" policy saves: those without batch
# dimensions, as the reference's dots_with_no_batch_dims_saveable.  einsum
# lowers such a product (a projection) to bmm over a batch of one, and a
# batched one (the chunked attention's f32 scores) to bmm over B x heads,
# so a bmm counts when its batch is 1 (also a batched product whose batch
# dimensions all have size 1, which the reference would not save)
_MM = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
_LHS = {torch.ops.aten.bmm.default: 0, torch.ops.aten.baddbmm.default: 1}


def _save_dots(ctx, op, *args, **kwargs):
    unbatched = op in _MM or (op in _LHS and args[_LHS[op]].shape[0] == 1)
    return (ckpt.CheckpointPolicy.MUST_SAVE if unbatched
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _rematted(fn, policy: str):
    """``fn`` under non-reentrant activation checkpointing: ``"nothing"``
    saves nothing inside it, ``"dots"`` saves the outputs of the products
    without batch dimensions."""
    if policy == "nothing":
        kw = {}
    elif policy == "dots":
        kw = {"context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"remat_policy {policy!r}: the port, as the "
                         f"reference, knows 'nothing' and 'dots'")
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def _sinusoid(positions, d):
    half = d // 2
    dim = torch.arange(half, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() / (1e4 ** (dim / half))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(cfg: ModelConfig, params, tokens, positions):
    x = params["embed"].to(cfg.cdtype)[tokens]
    scale = cfg.embed_scale if cfg.embed_scale else 1.0
    x = x * torch.tensor(scale * cfg.embed_multiplier, dtype=cfg.cdtype)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoid(positions, cfg.d_model).to(cfg.cdtype)
    return constrain(x, ("batch", "seq", None))


def unembed(cfg: ModelConfig, params, h):
    """Normed hidden states -> f32 logits (softcapped / scaled)."""
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["unembed"].to(h.dtype)
    logits = logits.float() * cfg.logit_scale
    return cm.softcap(logits, cfg.final_softcap)


def logits_from(cfg: ModelConfig, params, x):
    return unembed(cfg, params, _apply_norm(cfg, params["final_norm"], x))


# ---------------------------------------------------------------------------
# Top-level entry points
# ---------------------------------------------------------------------------


def _tokens(params, tokens):
    """``tokens`` on the parameters' device, with XLA's product precision
    set when that device is the card."""
    dev = params["embed"].device
    match_xla_matmul_on(dev)
    return torch.as_tensor(tokens, dtype=torch.long, device=dev)


def _embeds(params, x):
    """Pre-embedded inputs (``patches``, ``frames``: a tensor or an array
    of floats) on the parameters' device."""
    dev = params["embed"].device
    match_xla_matmul_on(dev)
    return torch.as_tensor(x, device=dev)


def encode(cfg: ModelConfig, params, frames):
    """Encoder stack over pre-embedded frames [B, S, d] (seamless stub)."""
    frames = _embeds(params, frames)
    S = frames.shape[1]
    positions = torch.arange(S, device=frames.device)[None, :]
    x = frames.to(cfg.cdtype)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoid(positions, cfg.d_model).to(cfg.cdtype)
    x, _ = apply_stack(cfg, params["enc_blocks"], x, positions,
                       role="encoder", n_layers=cfg.enc_layers)
    return _apply_norm(cfg, params["enc_final_norm"], x)


def forward(cfg: ModelConfig, params, batch):
    """Full-sequence logits.  ``batch["tokens"]`` [B, T] (a tensor or an
    array of ints); for a VLM optional ``patches`` [B, P, d] (a prefix),
    for an enc-dec ``frames`` [B, S, d] (the source).  Returns (logits
    [B, P + T, vocab] f32, aux3)."""
    h, aux = forward_hidden(cfg, params, batch)
    return unembed(cfg, params, h), aux


def forward_hidden(cfg: ModelConfig, params, batch):
    """Like :func:`forward` but stops at the final-normed hidden states."""
    tokens = _tokens(params, batch["tokens"])
    T = tokens.shape[1]
    dev = tokens.device
    prefix_len = 0
    enc_out = None
    if cfg.family == "vlm" and "patches" in batch:
        patches = _embeds(params, batch["patches"])
        P = patches.shape[1]
        positions = torch.arange(P + T, device=dev)[None, :]
        tok_x = embed_tokens(cfg, params, tokens, positions[:, P:])
        x = torch.cat([patches.to(cfg.cdtype), tok_x], dim=1)
        prefix_len = P
    else:
        positions = torch.arange(T, device=dev)[None, :]
        x = embed_tokens(cfg, params, tokens, positions)
    if cfg.is_encdec:
        enc_out = encode(cfg, params, batch["frames"])
    x, aux = apply_stack(cfg, params["blocks"], x, positions,
                         role=_decoder_role(cfg), prefix_len=prefix_len,
                         enc_out=enc_out)
    return _apply_norm(cfg, params["final_norm"], x), aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, ls: LayerSpec, batch: int,
                      max_len: int, enc_len: int):
    dt = cfg.cdtype
    if ls.kind == "rwkv":
        d, hs = cfg.d_model, cfg.rwkv_head_size
        return {
            "tm_shift": ((batch, 1, d), dt),
            "tm_state": ((batch, d // hs * hs * hs), torch.float32),
            "cm_shift": ((batch, 1, d), dt),
        }
    if ls.kind == "mamba":
        return {
            "conv": ((batch, cfg.mamba_d_conv - 1, cfg.d_inner), dt),
            "ssm": ((batch, cfg.d_inner * cfg.mamba_d_state), torch.float32),
        }
    kv = ((batch, max_len, cfg.n_kv_heads, cfg.d_head), dt)
    c = {"attn": {"k": kv, "v": kv}}
    if ls.cross:
        c["xk"] = c["xv"] = ((batch, enc_len, cfg.n_kv_heads, cfg.d_head),
                             dt)
    return c


def cache_struct(cfg: ModelConfig, batch: int, max_len: int, *,
                 enc_len: int = 0):
    """The decode cache as meta tensors (shapes and dtypes, no storage),
    layer-stacked like the parameters; ``index`` is the host int 0.
    ``enc_len`` is the encoder length of an enc-dec config's ``xk`` /
    ``xv``."""
    pattern, repeats = find_pattern(layer_kinds(cfg,
                                                role=_decoder_role(cfg)))

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        shape, dtype = node
        return torch.empty((repeats,) + shape, dtype=dtype, device="meta")

    return {"layers": [meta(_layer_cache_spec(cfg, ls, batch, max_len,
                                              enc_len))
                       for ls in pattern],
            "index": 0}


_CACHE_AXES = {
    "k": ("batch", "cache_seq", "kv_heads", "head"),
    "v": ("batch", "cache_seq", "kv_heads", "head"),
    "xk": ("batch", "cache_seq", "kv_heads", "head"),
    "xv": ("batch", "cache_seq", "kv_heads", "head"),
    "conv": ("batch", None, "mlp"),
    "ssm": ("batch", "mlp"),
    "tm_shift": ("batch", None, "embed"),
    "tm_state": ("batch", "heads_flat"),
    "cm_shift": ("batch", None, "embed"),
}


def cache_axes(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0):
    """Logical sharding axes matching :func:`cache_struct` leaf for leaf
    (each layer leaf led by ``"layers"``; ``index`` has none)."""
    struct = cache_struct(cfg, batch, max_len, enc_len=enc_len)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return ("layers",) + _CACHE_AXES[name]

    return {"layers": [walk(c) for c in struct["layers"]], "index": ()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, device=None):
    dev = cm.resolve_device(device)
    struct = cache_struct(cfg, batch, max_len, enc_len=enc_len)
    return {"layers": cm.tree_map(
                lambda _, t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                struct["layers"]),
            "index": struct["index"]}


def _run_with_cache(cfg: ModelConfig, params, tokens, cache, *,
                    prefix_embeds=None):
    tokens = _tokens(params, tokens)
    T = tokens.shape[1]
    index = int(cache["index"])
    positions = index + torch.arange(T, device=tokens.device)[None, :]
    x = embed_tokens(cfg, params, tokens, positions)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_embeds = _embeds(params, prefix_embeds)
        P = prefix_embeds.shape[1]
        px = torch.arange(P, device=tokens.device)[None, :]
        x = torch.cat([prefix_embeds.to(cfg.cdtype), x], dim=1)
        positions = torch.cat([px, positions + P], dim=1)
        prefix_len = P
    x, _ = apply_stack(cfg, params["blocks"], x, positions,
                       role=_decoder_role(cfg), caches=cache["layers"],
                       index=index, prefix_len=prefix_len,
                       enc_kv_cached=cfg.is_encdec)
    logits = logits_from(cfg, params, x)
    return logits, {"layers": cache["layers"], "index": index + x.shape[1]}


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt ``batch["tokens"]`` through the model, filling the
    cache.  An enc-dec config first encodes ``batch["frames"]`` and sets each
    cross layer's ``xk`` / ``xv`` in the cache to the encoder's keys and
    values (a tensor of their own, whatever ``enc_len`` the cache was made
    with, as the reference replaces them); a VLM config puts
    ``batch["patches"]``, when given, before the tokens as a bidirectional
    prefix.  Returns (last-position logits, cache)."""
    if cfg.is_encdec:
        enc_out = encode(cfg, params, batch["frames"])
        pattern, repeats = find_pattern(layer_kinds(cfg, role="xdecoder"))
        for j, ls in enumerate(pattern):
            if not ls.cross:
                continue
            cj = cache["layers"][j]
            kv = [_cross_kv(cfg, _at(params["blocks"][j]["xattn"], r),
                            enc_out) for r in range(repeats)]
            cj["xk"] = torch.stack([k for k, _ in kv]).to(cj["xk"].dtype)
            cj["xv"] = torch.stack([v for _, v in kv]).to(cj["xv"].dtype)
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    logits, cache = _run_with_cache(cfg, params, batch["tokens"], cache,
                                    prefix_embeds=prefix)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params, tokens, cache):
    """One-token decode: tokens [B, 1] against the filled cache."""
    logits, cache = _run_with_cache(cfg, params, tokens, cache)
    return logits[:, -1], cache
