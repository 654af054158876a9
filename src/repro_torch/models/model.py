"""Dense, encoder-decoder, vision, MoE, SSM and hybrid models: init /
forward / loss / contiguous-cache decode with the reference's param layout.

Params are plain nested dicts of tensors: stacked ``(L, ...)`` block leaves
under ``params["blocks"]`` and ``x @ W`` orientation, exactly the JAX tree
(``repro_torch.convert.params_from_numpy`` carries a reference tree across
leaf for leaf). The forward is a Python loop over the stacked layers; each
layer reads views ``leaf[i]`` of the stack, so nothing is copied. Any weight
leaf may be a packed ``QTensor``: it is dequantized per layer inside the
loop (``dequant_tree``), so only one layer's dense weights exist at a time.
An MoE block carries ``blocks["moe"]`` (router (L, D, E), experts (L, E,
...)) in place of ``blocks["mlp"]``; a layer's slice of it is (E, ...).
An SSM stack's blocks are ``{"ln1", "ssm"}`` (``models/ssm.py``); a hybrid
(Zamba2) stack holds its Mamba blocks there and ONE dense block under
``params["shared"]``, applied after every ``hybrid_period - 1`` Mamba
blocks (:func:`block_order`). An encoder-decoder stack (``encoder_layers
> 0``) adds non-causal dense encoder blocks under ``params["enc_blocks"]``
(+ ``enc_norm``) and a cross-attention (``xattn``, normed by ``ln_x``) to
each decoder block; a vision stack prepends patch embeddings to the tokens
(``forward(vision_embeds=...)``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch import obs
from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, check_supported

__all__ = ["init_params", "embed_tokens", "lm_head_logits", "forward",
           "lm_loss", "quantizable_paths", "layer_slice", "dequant_tree",
           "init_cache", "decode_step", "prefill", "ffn_sublayer",
           "block_order", "remat_units"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _init_attn(lead, cfg: ModelConfig, normal, dt, dev):
    """One attention's params (self- or cross-) with leading stack dims
    ``lead``: the reference's shapes, scales and biases."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    attn = {
        "wq": normal(lead + (D, hq * hd), D ** -0.5),
        "wk": normal(lead + (D, hkv * hd), D ** -0.5),
        "wv": normal(lead + (D, hkv * hd), D ** -0.5),
        "wo": normal(lead + (hq * hd, D), (hq * hd) ** -0.5),
    }
    if cfg.attn_qkv_bias or cfg.use_bias:
        attn["bq"] = zeros((hq * hd,))
        attn["bk"] = zeros((hkv * hd,))
        attn["bv"] = zeros((hkv * hd,))
    if cfg.use_bias:
        attn["bo"] = zeros((D,))
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones(lead + (hd,), dtype=dt, device=dev)
        attn["k_norm"] = torch.ones(lead + (hd,), dtype=dt, device=dev)
    return attn


def _init_dense_block(lead, cfg: ModelConfig, normal, dt, dev, cross=False):
    """One dense (or MoE) block's params with leading stack dims ``lead``
    (a tuple): the attention projections, then the FFN, then with
    ``cross`` (an encoder-decoder's decoder block) the cross-attention and
    its norm ``ln_x``, drawn in that order."""
    D, F = cfg.d_model, cfg.d_ff

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    block = {"ln1": L.init_norm(lead, D, cfg.norm, dt, dev),
             "attn": _init_attn(lead, cfg, normal, dt, dev),
             "ln2": L.init_norm(lead, D, cfg.norm, dt, dev)}
    if cfg.block_pattern == "moe":
        block["moe"] = L.init_moe(lead, cfg, normal)
    else:
        mlp = {"up": normal(lead + (D, F), D ** -0.5),
               "down": normal(lead + (F, D), F ** -0.5)}
        if cfg.gated_mlp:
            mlp["gate"] = normal(lead + (D, F), D ** -0.5)
        if cfg.use_bias:
            mlp["b_up"] = zeros((F,))
            mlp["b_down"] = zeros((D,))
            if cfg.gated_mlp:
                mlp["b_gate"] = zeros((F,))
        block["mlp"] = mlp
    if cross:
        block["ln_x"] = L.init_norm(lead, D, cfg.norm, dt, dev)
        block["xattn"] = _init_attn(lead, cfg, normal, dt, dev)
    return block


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init with the reference's shapes and scales
    (``repro.models.model.init_params``): stacked dense / MoE blocks, or
    stacked SSM blocks (``ln1`` + ``ssm``) — in a hybrid stack one per
    Mamba block, with the one shared dense block under ``params["shared"]``.
    An encoder-decoder stack's decoder blocks carry ``ln_x`` / ``xattn``,
    and its encoder blocks (dense, no cross-attention) sit under
    ``params["enc_blocks"]`` with their final norm ``params["enc_norm"]``.
    The draws do not reproduce ``jax.random``; ``generator`` must live on
    ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg.param_dtype)
    V, D = cfg.padded_vocab, cfg.d_model

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=dev) * scale

    params = {}
    if cfg.block_pattern in ("dense", "moe"):
        params["blocks"] = _init_dense_block((cfg.n_layers,), cfg, normal, dt,
                                             dev, cross=cfg.is_enc_dec)
    else:
        n = cfg.n_layers if cfg.block_pattern == "ssm" \
            else cfg.hybrid_layout()[0]
        params["blocks"] = {
            "ln1": L.init_norm((n,), D, cfg.norm, dt, dev),
            "ssm": SSM.init_ssm((n,), cfg, generator, dt, dev)}
        if cfg.block_pattern == "hybrid":
            params["shared"] = _init_dense_block((), cfg, normal, dt, dev)
    if cfg.is_enc_dec:
        params["enc_blocks"] = _init_dense_block((cfg.encoder_layers,), cfg,
                                                 normal, dt, dev)
        params["enc_norm"] = L.init_norm((), D, cfg.norm, dt, dev)
    params = {"embed": {"tok": normal((V, D), 0.02)}, **params,
              "final_norm": L.init_norm((), D, cfg.norm, dt, dev)}
    if cfg.pos_emb == "learned":
        params["embed"]["pos"] = normal((cfg.max_seq_len, D), 0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), D ** -0.5)
    return params


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked block tree (views, no copies; a stacked
    QTensor gives layer ``i``'s QTensor)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def dequant_tree(tree, dtype=None):
    """Materialise any QTensor leaves (applied to one layer's slice)."""
    if isinstance(tree, dict):
        return {k: dequant_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.dequantize(dtype or torch.float32)
    return tree


def _merge(tree, override):
    out = dict(tree)
    for k, v in override.items():
        out[k] = _merge(tree[k], v) if isinstance(v, dict) else v
    return out


def _dequant_block(pl, cfg: ModelConfig):
    """One block's leaves with QTensors dequantized to the compute dtype (a
    ``model.dequant`` profiler range when ``obs.enable_profiler()`` is on)."""
    with obs.profile_range("model.dequant"):
        return dequant_tree(pl, _dtype(cfg.compute_dtype))


def _dense_body(pl, cfg: ModelConfig, h, positions, cache=None,
                cache_index: int = 0, *, causal: bool = True, enc_h=None,
                cross=None):
    """One dense block (pre-norm, residuals). A decoder block of an
    encoder-decoder stack (it holds ``xattn``) attends over the encoder
    between its self-attention and its FFN: over ``cross``, the (k, v)
    ``prefill`` cached, or over K/V computed here from the encoder's output
    ``enc_h`` (the full forward); with neither it skips cross-attention, as
    the reference's does. The self-attention and the FFN are the profiler
    ranges ``model.attention`` and ``model.ffn`` when
    ``obs.enable_profiler()`` is on."""
    pl = _dequant_block(pl, cfg)
    a_in = L.apply_norm(h, pl["ln1"], cfg.norm)
    with obs.profile_range("model.attention"):
        a, cache = L.self_attention(pl["attn"], cfg, a_in, positions,
                                    causal=causal, cache=cache,
                                    cache_index=cache_index)
    if "xattn" in pl and (cross is not None or enc_h is not None):
        h, x_in = L.add_norm(h, a, pl["ln_x"], cfg.norm)
        kv = cross if cross is not None else L.cross_kv(pl["xattn"], cfg,
                                                        enc_h)
        a = L.cross_attention(pl["xattn"], cfg, x_in, kv)
    h, m_in = L.add_norm(h, a, pl["ln2"], cfg.norm)
    with obs.profile_range("model.ffn"):
        m = ffn_sublayer(pl, cfg, m_in)
    return h + m, cache


def ffn_sublayer(pl, cfg: ModelConfig, m_in):
    """The block's FFN on its normed input ``m_in``: ``moe_ffn`` when the
    layer's tree holds ``"moe"``, else the dense ``mlp``."""
    if "moe" in pl:
        return L.moe_ffn(pl["moe"], cfg, m_in)
    return L.mlp(pl["mlp"], cfg, m_in)


def _copy_into(dst, src):
    """Write the tree ``src`` into the tree of views ``dst`` in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def _ssm_body(pl, cfg: ModelConfig, h, state=None, decode: bool = False):
    """One SSM block (pre-norm, residual). ``state``: this block's views of
    the decode state, written in place — the state after the sequence
    (prefill) or after the one token (``decode``); None for a plain
    full-sequence forward."""
    pl = _dequant_block(pl, cfg)
    s_in = L.apply_norm(h, pl["ln1"], cfg.norm)
    if state is None:
        return h + SSM.ssm_forward(pl["ssm"], cfg, s_in)
    if decode:
        out, new = SSM.ssm_decode_step(pl["ssm"], cfg, s_in, state)
    else:
        out, new = SSM.ssm_forward(pl["ssm"], cfg, s_in, return_state=True)
    _copy_into(state, new)
    return h + out


def block_order(cfg: ModelConfig):
    """The blocks in the order they run, as (kind, index): ("dense", i) and
    ("ssm", u) name entry i / u of the ``params["blocks"]`` stack;
    ("shared", a) is the a-th application of a hybrid stack's shared
    block. A hybrid stack runs groups of ``hybrid_period - 1`` SSM blocks,
    each followed by the shared block, then the tail SSM blocks (the
    reference's ``_hybrid_forward``)."""
    if cfg.block_pattern in ("dense", "moe"):
        return [("dense", i) for i in range(cfg.n_layers)]
    if cfg.block_pattern == "ssm":
        return [("ssm", u) for u in range(cfg.n_layers)]
    per_group = cfg.hybrid_period - 1
    n_m, n_a = cfg.hybrid_layout()
    order = []
    for a in range(n_a):
        order += [("ssm", u) for u in range(a * per_group, (a + 1) * per_group)]
        order.append(("shared", a))
    return order + [("ssm", u) for u in range(n_a * per_group, n_m)]


def remat_units(cfg: ModelConfig):
    """:func:`block_order` cut into the units the forward runs one after
    another, each under one checkpoint when ``cfg.remat`` is set: one block
    each, except that a hybrid stack's group of ``hybrid_period - 1`` Mamba
    blocks and the shared block after it are one unit (the reference's
    ``_hybrid_forward`` group body; each Mamba block inside it is
    checkpointed again, as the reference's inner scan body is)."""
    units, group = [], []
    for kind, i in block_order(cfg):
        if cfg.block_pattern != "hybrid":
            units.append([(kind, i)])
            continue
        group.append((kind, i))
        if kind == "shared":
            units.append(group)
            group = []
    return units + [[b] for b in group]


# the matmul ops whose outputs a selective remat policy saves: "dots" the
# non-batched ones (the reference's dots_with_no_batch_dims_saveable),
# "dots_all" every one (dots_saveable)
_REMAT_SAVED = {
    "dots": ("mm", "addmm"),
    "dots_all": ("mm", "addmm", "bmm", "baddbmm"),
}


def _remat_context(names):
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {getattr(torch.ops.aten, n) for n in names}

    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` itself, or — when ``cfg.remat`` is set, ``remat_policy`` is
    not "none" and autograd records — ``fn`` under a non-reentrant
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of saved. "dots" and "dots_all" save the matmul outputs
    of :data:`_REMAT_SAVED` (a selective checkpoint); any other policy saves
    nothing inside the unit ("full", as the reference's plain
    ``jax.checkpoint``). The recompute draws no random numbers, so the RNG
    state is not stashed, and the values are those of the first run: the
    gradients equal remat-off's bit for bit."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    kw = {}
    if cfg.remat_policy in _REMAT_SAVED:
        kw["context_fn"] = functools.partial(
            _remat_context, _REMAT_SAVED[cfg.remat_policy])

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return wrapped


def embed_tokens(params, cfg: ModelConfig, tokens, positions):
    """Token (+ learned position) embeddings; ``positions`` is (S,) or, for
    per-sequence depths, (B, S)."""
    h = params["embed"]["tok"][tokens]
    if cfg.pos_emb == "learned":
        h = h + params["embed"]["pos"][positions]
    return h.to(_dtype(cfg.compute_dtype))


def lm_head_logits(params, cfg: ModelConfig, h, *, mask_vocab: bool = False):
    """Final norm + (tied or dedicated, possibly QTensor) LM head.
    ``mask_vocab=True`` sets padded-vocab columns to -inf (the serving
    steps' convention before argmax/sampling)."""
    h = L.apply_norm(h, params["final_norm"], cfg.norm)
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, QTensor):
        head = head.dequantize(h.dtype)
    logits = h @ head.to(h.dtype)
    V = logits.shape[-1]
    if mask_vocab and V > cfg.vocab_size:
        keep = torch.arange(V, device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits, -torch.inf)
    return logits


def _block_params(params, kind, i, layer_override):
    """The params block (kind, i) reads: its slice of the stack, or the
    shared block, with ``layer_override``'s leaves merged in where it names
    this block."""
    if kind == "shared":
        pl, key = params["shared"], "shared"
    else:
        pl, key = layer_slice(params["blocks"], i), i
    if layer_override is not None and layer_override[0] == key:
        pl = _merge(pl, layer_override[1])
    return pl


def _run_encoder(params, cfg: ModelConfig, enc_embeds):
    """An encoder-decoder stack's encoder: the frames ``enc_embeds`` (B, T,
    D) in the compute dtype, through the ``enc_blocks`` non-causally (no
    position embedding is added to the frames), then ``enc_norm``."""
    if enc_embeds is None:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder stack: pass enc_embeds (B, T, "
            f"D), e.g. models.frontends.stub_audio_frames")
    h = enc_embeds.to(_dtype(cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=h.device)

    def body(h, pl):
        return _dense_body(pl, cfg, h, positions, causal=False)[0]

    body = _maybe_remat(body, cfg)
    for i in range(cfg.encoder_layers):
        h = body(h, layer_slice(params["enc_blocks"], i))
    return L.apply_norm(h, params["enc_norm"], cfg.norm)


def _embed_inputs(params, cfg: ModelConfig, tokens, vision_embeds):
    """Token embeddings (learned positions over the S tokens), with the
    patches ``vision_embeds`` (B, P, D) prepended; returns (h (B, P+S, D),
    positions arange(P+S)) — RoPE and the cache run over P+S."""
    S = tokens.shape[1]
    h = embed_tokens(params, cfg, tokens,
                     torch.arange(S, device=tokens.device))
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(h.dtype), h], dim=1)
    return h, torch.arange(h.shape[1], device=tokens.device)


def forward(params, cfg: ModelConfig, tokens, *, enc_embeds=None,
            vision_embeds=None, collect_hidden=False, layer_override=None):
    """Full-sequence causal forward -> logits (B, P+S, V_padded), plus the
    per-block outputs (n, B, P+S, D) when ``collect_hidden``: one per block
    of a dense, MoE or SSM stack (an encoder-decoder's decoder blocks), one
    per application of the shared block in a hybrid stack (the reference's
    taps). ``lm_head_logits`` is the profiler range ``model.head`` when
    ``obs.enable_profiler()`` is on.

    ``vision_embeds`` (B, P, D) are prepended to the token embeddings (P =
    0 without them); ``enc_embeds`` (B, T, D) feed the encoder of an
    encoder-decoder stack (required there), whose output every decoder
    block attends over.

    ``layer_override=(key, tree)`` makes one block read the leaves of
    ``tree`` instead of its own — the search installs one candidate unit
    this way without copying the stack. An int key is an index into the
    ``params["blocks"]`` stack: layer i of a dense or MoE stack (e.g.
    ``{"mlp": {"up": ..., "down": ...}}``, or for one expert ``{"moe":
    {layers.EXPERT_OVERRIDE: (e, unit)}}``), the u-th SSM block of an SSM
    or hybrid stack (``{"ssm": {...}}``; in a hybrid stack that is not
    layer u). The key ``"shared"`` overrides a hybrid stack's shared block
    at every application (``{"mlp": {...}}``).
    """
    check_supported(cfg)
    h, positions = _embed_inputs(params, cfg, tokens, vision_embeds)
    enc_h = _run_encoder(params, cfg, enc_embeds) if cfg.is_enc_dec else None
    ssm_body = _maybe_remat(lambda h, pl: _ssm_body(pl, cfg, h), cfg)

    def run(seg, h, *pls):
        for (kind, _), pl in zip(seg, pls):
            if kind == "ssm":
                h = ssm_body(h, pl) if len(seg) > 1 else _ssm_body(pl, cfg, h)
            else:
                h, _ = _dense_body(pl, cfg, h, positions, enc_h=enc_h)
        return h

    hidden = []
    for seg in remat_units(cfg):
        pls = [_block_params(params, kind, i, layer_override)
               for kind, i in seg]
        h = _maybe_remat(functools.partial(run, seg), cfg)(h, *pls)
        if collect_hidden and (seg[-1][0] == "shared"
                               or cfg.block_pattern != "hybrid"):
            hidden.append(h)
    with obs.profile_range("model.head"):
        logits = lm_head_logits(params, cfg, h)
    if collect_hidden:
        return logits, (torch.stack(hidden) if hidden
                        else h.new_zeros((0,) + tuple(h.shape)))
    return logits


def lm_loss(logits, labels, vocab_size: int, ignore_id: int = -1):
    """Mean next-token CE; positions with label == ignore_id are masked;
    padded vocab ids are masked out of the softmax. Logits whose (B, S) do
    not match the labels' raise ``ValueError`` (the reference's
    ``take_along_axis`` refuses to broadcast them): e.g. a vision forward's
    P+S-1 next-token logits against S-1 labels."""
    if tuple(logits.shape[:-1]) != tuple(labels.shape):
        raise ValueError(
            f"Incompatible shapes: logits {tuple(logits.shape[:-1])} (+ "
            f"vocab) against labels {tuple(labels.shape)}")
    V = logits.shape[-1]
    if V > vocab_size:
        keep = torch.arange(V, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, L.NEG_INF)
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1)


# ---------------------------------------------------------------------------
# Decode over a contiguous KV cache
# ---------------------------------------------------------------------------

def _single_kv(cfg: ModelConfig, batch: int, max_len: int, dt, device):
    """One block's empty KV cache (the ``init_cache`` leaf layout without the
    layer axis): (B, max_len, Hkv, hd) K/V in ``dt``, or int8 codes with
    (B, max_len, Hkv) scales in ``dt``."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=dt, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=dt, device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Empty decode cache on ``device`` (the card unless ``device="cpu"``);
    ``dtype`` defaults to the compute dtype. Dense / MoE: the
    ``_single_kv`` leaves with a leading n_layers axis. SSM: every block's
    ``ssm.init_ssm_state`` stacked (f32 SSD state, conv windows in
    ``dtype``). Hybrid: {"ssm": the same over the Mamba blocks, "attn":
    one KV cache per application of the shared block}. An encoder-decoder
    stack's cache also holds ``"cross": None``, which ``prefill`` fills with
    the decoder blocks' cross-attention (k, v), each (L, B, T, Hkv, Dh)."""
    check_supported(cfg)
    dt = dtype or _dtype(cfg.compute_dtype)
    dev = resolve_device(device)

    def kv(n):
        one = _single_kv(cfg, batch, max_len, dt, dev)
        return {k: v[None].repeat((n,) + (1,) * v.ndim)
                for k, v in one.items()}

    if cfg.block_pattern in ("dense", "moe"):
        cache = kv(cfg.n_layers)
        if cfg.is_enc_dec:
            cache["cross"] = None
        return cache
    if cfg.block_pattern == "ssm":
        return SSM.init_ssm_state(cfg, batch, dt, dev, lead=(cfg.n_layers,))
    n_m, n_a = cfg.hybrid_layout()
    return {"ssm": SSM.init_ssm_state(cfg, batch, dt, dev, lead=(n_m,)),
            "attn": kv(n_a)}


def _cached_blocks(params, cfg: ModelConfig, h, positions, cache, index: int,
                   decode: bool):
    """Run every block against ``cache``, writing it in place: K/V at
    ``index`` onwards, the SSM state after the prompt (prefill) or after
    the one token (``decode``). A decoder block of an encoder-decoder stack
    attends over its slice of ``cache["cross"]`` (skipped while that is
    None, as in the reference)."""
    ssm_cache = cache["ssm"] if cfg.block_pattern == "hybrid" else cache
    cross = cache.get("cross") if cfg.is_enc_dec else None
    for kind, i in block_order(cfg):
        pl = _block_params(params, kind, i, None)
        if kind == "ssm":
            h = _ssm_body(pl, cfg, h, layer_slice(ssm_cache, i), decode)
            continue
        kv = cache["attn"] if kind == "shared" else cache
        h, _ = _dense_body(pl, cfg, h, positions,
                           cache={k: v[i] for k, v in kv.items()
                                  if k != "cross"},
                           cache_index=index,
                           cross=None if cross is None
                           else (cross[0][i], cross[1][i]))
    return h


def decode_step(params, cfg: ModelConfig, tokens, cache, index: int):
    """One decode step. tokens (B, 1) at position ``index`` (a host int);
    returns (logits (B, 1, V), cache).

    Each attention block's K/V are written into ``cache`` (the
    ``init_cache`` tree) IN PLACE at ``index``, and each SSM block's state
    is advanced in place — the reference returns a new cache; the returned
    cache is the same object. Packed QTensor leaves are dequantized one
    block at a time, as in the paged step. Every row sits at position
    ``index`` (RoPE included), as in the reference: left-padded rows of a
    batch rotate their pads too.
    """
    check_supported(cfg)
    index = int(index)
    positions = index + torch.arange(1, device=tokens.device)
    h = embed_tokens(params, cfg, tokens, positions)
    h = _cached_blocks(params, cfg, h, positions, cache, index, decode=True)
    return lm_head_logits(params, cfg, h), cache


def prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
            enc_embeds=None, vision_embeds=None):
    """Process a prompt (B, S) into a fresh ``init_cache(cfg, B, max_len)``
    on the tokens' device: K/V written at positions 0..P+S-1 (P patches of
    ``vision_embeds`` first, as in ``forward``; a decode then starts at
    index P+S), SSM states after the last position. An encoder-decoder
    stack runs its encoder on ``enc_embeds`` once and caches each decoder
    block's cross-attention (k, v) under ``cache["cross"]``, computed from
    that block's dequantized ``xattn`` leaves. Returns (logits (B, P+S,
    V), cache)."""
    check_supported(cfg)
    B = tokens.shape[0]
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    h, positions = _embed_inputs(params, cfg, tokens, vision_embeds)
    if cfg.is_enc_dec:
        enc_h = _run_encoder(params, cfg, enc_embeds)
        shape = (cfg.n_layers, B, enc_h.shape[1], cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        ks, vs = (h.new_empty(shape) for _ in range(2))
        dt = _dtype(cfg.compute_dtype)
        for i in range(cfg.n_layers):
            xattn = dequant_tree(layer_slice(params["blocks"]["xattn"], i), dt)
            ks[i], vs[i] = L.cross_kv(xattn, cfg, enc_h)
        cache["cross"] = (ks, vs)
    h = _cached_blocks(params, cfg, h, positions, cache, 0, decode=False)
    return lm_head_logits(params, cfg, h), cache


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "up", "gate", "down", "w_z", "w_x", "out_proj")
_SKIP_SUBSTR = ("embed", "ln", "norm", "router", "conv", "bias")


def quantizable_paths(params) -> list:
    """Paths (tuples of keys) of weight leaves the PTQ methods quantize."""
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        key = path[-1]
        if key in _QUANT_KEYS and not any(s in str(p) for p in path for s in _SKIP_SUBSTR):
            if hasattr(tree, "ndim") and tree.ndim >= 2:
                out.append(path)

    walk(params, ())
    return out
