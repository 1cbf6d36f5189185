"""Autoregressive greedy decoding with a KV cache, on one device.

The port of ``icikit/models/transformer/decode.py``'s greedy path.
Prefill runs the prompt once through the causal forward (the flash
kernel, ``attention_impl="flash"``) and saves per-layer K/V; each decode
step attends one query position against the cache. The residual stream
stays float32 in both phases, as in JAX; matmuls run in
``compute_dtype`` from weight copies made once per generate call.

The single-token inner step (``TransformerConfig.decode_step``):

- ``"unfused"`` (the default, as in JAX): RoPE, a cache column write and
  ``_masked_attention`` as tensor ops;
- ``"fused"``: one ``decode_step_attention`` launch per layer (RoPE,
  the cache column write in place and the masked attention), MHA with
  the kernel's head dims only; forcing it elsewhere fails loudly;
- ``"auto"``: fused on a CUDA device when the gate accepts the config.

On a CUDA mesh every attention goes through the kernels; on a CPU mesh
(tests) through their plain versions. Sampled decoding is not ported:
``jax.random``'s threefry draws cannot be reproduced in torch, so it
waits for its own slice.
"""

from __future__ import annotations

import torch

from icikit_torch.models.transformer.model import (
    DTYPES,
    MATMUL_KEYS,
    ModelMesh,
    TransformerConfig,
    _dense_ffn_block,
    _layer_keys,
    _n_rep,
    _project_qkv,
    _rms_norm,
    check_ported,
    repeat_kv,
)
from icikit_torch.ops.attention import NEG_INF
from icikit_torch.ops.flash_attention import (
    decode_step_attention,
    decode_step_cache_len,
    decode_step_supported,
    resolve_attention_impl,
)
from icikit_torch.ops.rope import apply_rope, rope_sincos


def _masked_attention(q, ks, vs, mask, scale, n_rep):
    """q (b, 1, h, dh) against the un-repeated cache ks/vs
    (b, T, h/n_rep, dh) under ``mask`` (T,): float32 logits and softmax,
    the weights cast to the cache dtype before the value product. GQA
    groups are served by a grouped einsum, so the cache is never
    repeated to n_heads width."""
    b, one, h, dh = q.shape
    fill = torch.tensor(NEG_INF, device=q.device)
    if n_rep == 1:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              ks.float()) * scale
        logits = torch.where(mask[None, None, None, :], logits, fill)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w.to(vs.dtype).float(),
                           vs.float())
        return out.to(q.dtype)
    qg = q.reshape(b, one, h // n_rep, n_rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          ks.float()) * scale
    logits = torch.where(mask[None, None, None, None, :], logits, fill)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(vs.dtype).float(),
                       vs.float())
    return out.reshape(b, one, h, dh).to(q.dtype)


class _DecodeCtx:
    """The per-layer decode math over one call's weights: the compute-
    dtype copies of every matmul weight are made here, once per
    generate call (each decode step then streams them, the byte model
    of ``bench/decode.py``)."""

    def __init__(self, cfg: TransformerConfig, params: dict):
        self.cfg = cfg
        self.cdt = DTYPES[cfg.compute_dtype]
        self.scale = cfg.d_head ** -0.5
        self.n_rep = _n_rep(cfg)

        def cast(key, w):
            return w.to(self.cdt) if key in MATMUL_KEYS else w

        self.layers = [{k: cast(k, params[k][li]) for k in _layer_keys(cfg)}
                       for li in range(cfg.n_layers)]
        self.emb = params["emb"]
        self.pos = params.get("pos")
        self.ln_f = params["ln_f"]
        self.w_out = cast("w_out", params["w_out"])

    def qkv_proj(self, x, lp):
        h = _rms_norm(x, lp["ln1"]).to(self.cdt)
        return _project_qkv(h, lp, self.cdt)

    def close_attn(self, x, attn, lp):
        o = torch.einsum("bshe,hed->bsd", attn.to(self.cdt), lp["wo"])
        return x + o.float()

    def ffn(self, x, lp):
        return _dense_ffn_block(x, lp, self.cdt, lambda v: v)

    def logits(self, x):
        """float32 logits from hidden state ``x (..., D)``: the product
        runs in the compute dtype and is widened after."""
        h = _rms_norm(x, self.ln_f).to(self.cdt)
        return torch.matmul(h, self.w_out.t()).float()

    def embed(self, tokens, positions):
        x = self.emb[tokens.long()]
        if self.cfg.pos_encoding == "learned":
            x = x + self.pos[positions]
        return x


def _prefill(ctx: _DecodeCtx, prompt, s_prompt: int, total: int,
             fused: bool):
    """Full causal forward over the prompt: the final hidden states
    ``x (b, s, D)`` and per-layer K/V caches of ``total`` columns,
    ``(b, total, hkv, dh)`` for the unfused step or ``(b*h, total, dh)``
    (heads flattened into rows) for the fused one."""
    cfg = ctx.cfg
    b = prompt.shape[0]
    pos = torch.arange(s_prompt, device=prompt.device)
    x = ctx.embed(prompt, pos)
    attention = resolve_attention_impl(cfg.attention_impl)
    kcs, vcs = [], []
    for lp in ctx.layers:
        q, k, v = ctx.qkv_proj(x, lp)
        if cfg.pos_encoding == "rope":
            # the cache stores rotated keys, as every step's are
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        attn = attention(q, repeat_kv(k, ctx.n_rep),
                         repeat_kv(v, ctx.n_rep), causal=True,
                         scale=ctx.scale)
        x = ctx.close_attn(x, attn, lp)
        x = ctx.ffn(x, lp)
        if fused:
            h = k.shape[2]
            k = k.transpose(1, 2).reshape(b * h, s_prompt, -1)
            v = v.transpose(1, 2).reshape(b * h, s_prompt, -1)
        kc = torch.zeros(k.shape[:1] + (total,) + k.shape[2:],
                         dtype=k.dtype, device=k.device)
        vc = torch.zeros_like(kc)
        kc[:, :s_prompt] = k
        vc[:, :s_prompt] = v
        kcs.append(kc)
        vcs.append(vc)
    return x, kcs, vcs


def _resolve_decode_step(cfg: TransformerConfig, device) -> bool:
    """True when the generate should use the fused inner step.
    ``"fused"`` fails loudly when the gate rejects the config, so an
    A/B can never measure the fallback; ``"auto"`` arms it on a CUDA
    device when the gate accepts."""
    mode = cfg.decode_step
    if mode == "unfused":
        return False
    ok = decode_step_supported(cfg.d_head, _n_rep(cfg),
                               DTYPES[cfg.compute_dtype])
    if mode == "fused":
        if not ok:
            raise ValueError(
                "decode_step='fused' but the kernel gate rejects this "
                f"config (d_head={cfg.d_head}, n_rep={_n_rep(cfg)}) — "
                "MHA with d_head 128 or 256 required")
        return True
    return ok and torch.device(device).type == "cuda"


def _decode_step(ctx: _DecodeCtx, token, cur: int, kcs, vcs, fused: bool,
                 positions):
    """One token through every layer; updates the caches at column
    ``cur`` and returns the float32 logits of the next token."""
    cfg = ctx.cfg
    b = token.shape[0]
    pos = positions[cur:cur + 1]
    x = ctx.embed(token[:, None], pos)
    rope = cfg.pos_encoding == "rope"
    sincos = rope_sincos(pos, cfg.d_head, cfg.rope_theta) if rope else None
    if fused:
        # duplicated tables: the kernel's split-half rotation reads
        # concat([c, c]) / concat([s, s])
        if rope:
            cos2 = torch.cat([sincos[0], sincos[0]], dim=-1)
            sin2 = torch.cat([sincos[1], sincos[1]], dim=-1)
        else:
            cos2 = torch.ones((1, cfg.d_head), device=token.device)
            sin2 = torch.zeros((1, cfg.d_head), device=token.device)
    else:
        mask = positions <= cur
    for li, lp in enumerate(ctx.layers):
        q, k, v = ctx.qkv_proj(x, lp)
        if fused:
            h, dh = q.shape[2], q.shape[3]
            attn, _, _ = decode_step_attention(
                q.reshape(b * h, dh).contiguous(),
                k.reshape(b * h, dh).contiguous(),
                v.reshape(b * h, dh).contiguous(),
                kcs[li], vcs[li], cur, cos2, sin2, scale=ctx.scale,
                rope=rope)
            attn = attn.reshape(b, 1, h, dh)
        else:
            if rope:
                q = apply_rope(q, pos, cfg.rope_theta, sincos)
                k = apply_rope(k, pos, cfg.rope_theta, sincos)
            kcs[li][:, cur] = k[:, 0]
            vcs[li][:, cur] = v[:, 0]
            attn = _masked_attention(q, kcs[li], vcs[li], mask, ctx.scale,
                                     ctx.n_rep)
        x = ctx.close_attn(x, attn, lp)
        x = ctx.ffn(x, lp)
    return ctx.logits(x[:, 0])


@torch.no_grad()
def greedy_generate(params: dict, prompt: torch.Tensor, mesh: ModelMesh,
                    cfg: TransformerConfig, n_new: int, *,
                    return_logits: bool = False):
    """Greedy continuation: integer ``prompt`` (B, S) -> (B, S + n_new)
    tokens on the mesh's device (prompt followed by the argmax decode).

    ``params`` must live on the mesh's device. ``return_logits`` also
    returns the float32 logits each new token was chosen from,
    ``(n_new, B, vocab)``."""
    check_ported(cfg)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if mesh.sp != 1:
        raise ValueError("decoding requires sp=1")
    s_prompt = prompt.shape[1]
    total = s_prompt + n_new
    if total > cfg.max_seq:
        raise ValueError(f"prompt + new tokens = {total} exceeds "
                         f"max_seq = {cfg.max_seq}")
    dev = torch.device(mesh.device)
    if params["emb"].device.type != dev.type:
        raise ValueError(f"params live on {params['emb'].device}, the "
                         f"mesh on {dev}")
    prompt = prompt.to(dev)
    ctx = _DecodeCtx(cfg, params)
    fused = _resolve_decode_step(cfg, dev)
    cache_len = decode_step_cache_len(total) if fused else total
    positions = torch.arange(cache_len, device=dev)

    x, kcs, vcs = _prefill(ctx, prompt, s_prompt, cache_len, fused)
    logits = ctx.logits(x[:, -1])
    kept = [logits] if return_logits else None
    toks = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        logits = _decode_step(ctx, toks[-1], s_prompt + i, kcs, vcs, fused,
                              positions)
        if return_logits:
            kept.append(logits)
        toks.append(torch.argmax(logits, dim=-1))
    out = torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                    dim=1)
    return (out, torch.stack(kept)) if return_logits else out


def sample_generate(*args, **kwargs):
    """Not ported: sampled decoding keys every draw by ``jax.random``'s
    threefry, whose bits torch cannot reproduce, so it waits for its own
    slice with a counter-based generator of the port's own."""
    raise NotImplementedError(
        "sample_generate is not ported yet: sampled decode is a later "
        "slice (threefry draws are not reproducible in torch)")
