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

``TransformerConfig.decode_quant = "int8"`` runs the int8 path: the
weights are quantized per output channel once per call
(``maybe_quantize_params``; a caller may pass the quantized dict) and
every projection and the unembedding go through ``ops/quant.qmm``
(``cfg.quant_matvec``: on a CUDA device ``"auto"`` reaches the int8
matvec kernel, B15, wherever its gate accepts the shape); the prefill's
attention runs on the raw projections and its K/V are quantized as
they are stored, into int8 caches with float32 per-(position, head)
scales; a step attends over the int8 caches, fused
(``decode_step_attention_q8``, B14) or unfused. The int8 leaves and
their scales are never cast to the compute dtype.

On a CUDA mesh every attention goes through the kernels; on a CPU mesh
(tests) through their plain versions. Sampled decoding is not ported:
``jax.random``'s threefry draws cannot be reproduced in torch, so it
waits for its own slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
from icikit_torch.models.transformer.quant import (
    is_quantized_params,
    quant_layer_keys,
    quantize_decode_params,
)
from icikit_torch.ops.attention import NEG_INF
from icikit_torch.ops.flash_attention import (
    decode_step_attention,
    decode_step_attention_q8,
    decode_step_cache_len,
    decode_step_supported,
    resolve_attention_impl,
)
from icikit_torch.ops.quant import dequantize_last, qmm, quantize_last
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


def _masked_attention_q8(q, ks, vs, ksc, vsc, mask, scale, n_rep):
    """The int8-cache form of ``_masked_attention``: the single-token
    mask ``(T,)`` as a degenerate per-row window mask ``(1, 1, T)`` of
    :func:`_window_masked_attention_q8`, as in JAX."""
    return _window_masked_attention_q8(q, ks, vs, ksc, vsc,
                                       mask[None, None, :], scale, n_rep)


def _window_masked_attention_q8(q, ks, vs, ksc, vsc, mask, scale, n_rep):
    """Attention of q ``(b, w, h, dh)`` over the int8 caches ``ks``/``vs``
    ``(b, T, h/n_rep, dh)`` with their float32 per-(position, head)
    scales ``ksc``/``vsc`` ``(b, T, h/n_rep)``, under ``mask``
    broadcasting against ``(b, w, T)``. The dequant folds out of both
    products: K's scale multiplies the logit row, V's the weights
    before the value product, so no high-precision copy of the cache is
    formed. float32 products and softmax."""
    b, w_len, h, dh = q.shape
    fill = torch.tensor(NEG_INF, device=q.device)
    ksc_t, vsc_t = ksc.transpose(1, 2), vsc.transpose(1, 2)
    if n_rep == 1:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ks.float())
        logits = logits * ksc_t[:, :, None, :] * scale
        logits = torch.where(mask[:, None, :, :], logits, fill)
        w = torch.softmax(logits, dim=-1)
        wv = w * vsc_t[:, :, None, :]
        out = torch.einsum("bhqk,bkhd->bqhd", wv, vs.float())
        return out.to(q.dtype)
    qg = q.reshape(b, w_len, h // n_rep, n_rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ks.float())
    logits = logits * ksc_t[:, :, None, None, :] * scale
    logits = torch.where(mask[:, None, None, :, :], logits, fill)
    w = torch.softmax(logits, dim=-1)
    wv = w * vsc_t[:, :, None, None, :]
    out = torch.einsum("bgrqk,bkgd->bqgrd", wv, vs.float())
    return out.reshape(b, w_len, h, dh).to(q.dtype)


class _DecodeCtx:
    """The per-layer decode math over one call's weights: the compute-
    dtype copies of every matmul weight are made here, once per
    generate call (each decode step then streams them, the byte model
    of ``bench/decode.py``). Under ``decode_quant="int8"`` ``params`` is
    the quantized dict and nothing is cast: the int8 leaves and their
    float32 scales reach ``qmm`` as they are."""

    def __init__(self, cfg: TransformerConfig, params: dict):
        self.cfg = cfg
        self.cdt = DTYPES[cfg.compute_dtype]
        self.scale = cfg.d_head ** -0.5
        self.n_rep = _n_rep(cfg)
        self.quant = cfg.decode_quant == "int8"
        self.qimpl = cfg.quant_matvec
        keys = quant_layer_keys(cfg) if self.quant else _layer_keys(cfg)

        def cast(key, w):
            return (w.to(self.cdt) if key in MATMUL_KEYS and not self.quant
                    else w)

        self.layers = [{k: cast(k, params[k][li]) for k in keys}
                       for li in range(cfg.n_layers)]
        self.emb = params["emb"]
        self.pos = params.get("pos")
        self.ln_f = params["ln_f"]
        self.w_out = cast("w_out", params["w_out"])
        self.w_out_s = params.get("w_out_s")

    def qproj(self, x, lp, key, k_ndim=1):
        """``x`` through the int8 leaf ``lp[key]`` and its scales."""
        return qmm(x, lp[key], lp[key + "_s"], k_ndim=k_ndim,
                   impl=self.qimpl)

    def qkv_proj(self, x, lp):
        h = _rms_norm(x, lp["ln1"]).to(self.cdt)
        if not self.quant:
            return _project_qkv(h, lp, self.cdt)
        if "wq" in lp:
            q = self.qproj(h, lp, "wq").to(self.cdt)
            kv = self.qproj(h, lp, "wkv").to(self.cdt)
            return q, kv[:, :, 0], kv[:, :, 1]
        qkv = self.qproj(h, lp, "wqkv").to(self.cdt)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def close_attn(self, x, attn, lp):
        if self.quant:
            # wo stored (D, H, Dh): the contraction (H, Dh) last
            return x + self.qproj(attn.to(self.cdt), lp, "wo", k_ndim=2)
        o = torch.einsum("bshe,hed->bsd", attn.to(self.cdt), lp["wo"])
        return x + o.float()

    def ffn(self, x, lp):
        if not self.quant:
            return _dense_ffn_block(x, lp, self.cdt, lambda v: v)
        h2 = _rms_norm(x, lp["ln2"]).to(self.cdt)
        u = F.gelu(self.qproj(h2, lp, "w1"), approximate="tanh").to(self.cdt)
        return x + self.qproj(u, lp, "w2")

    def logits(self, x):
        """float32 logits from hidden state ``x (..., D)``: the product
        runs in the compute dtype and is widened after (under int8, the
        int8 unembedding with float32 accumulation)."""
        h = _rms_norm(x, self.ln_f).to(self.cdt)
        if self.quant:
            return qmm(h, self.w_out, self.w_out_s, impl=self.qimpl)
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
    (heads flattened into rows) for the fused one, as lists ``(kcs,
    vcs, kss, vss)``. Under int8 the caches are int8 and ``kss``/``vss``
    their float32 per-(position, head) scales, ``(b, total, hkv)`` or
    ``(b*h, total)``: K/V are quantized as they are stored (the prompt's
    own attention ran on the raw projections). Otherwise ``kss`` and
    ``vss`` are None."""
    cfg = ctx.cfg
    b = prompt.shape[0]
    pos = torch.arange(s_prompt, device=prompt.device)
    x = ctx.embed(prompt, pos)
    attention = resolve_attention_impl(cfg.attention_impl)
    kcs, vcs = [], []
    kss, vss = ([], []) if ctx.quant else (None, None)
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
        if ctx.quant:
            (k, ksn), (v, vsn) = quantize_last(k), quantize_last(v)
            for scales, sn in ((kss, ksn), (vss, vsn)):
                sc = torch.zeros(sn.shape[:1] + (total,) + sn.shape[2:],
                                 dtype=torch.float32, device=sn.device)
                sc[:, :s_prompt] = sn
                scales.append(sc)
        kc = torch.zeros(k.shape[:1] + (total,) + k.shape[2:],
                         dtype=k.dtype, device=k.device)
        vc = torch.zeros_like(kc)
        kc[:, :s_prompt] = k
        vc[:, :s_prompt] = v
        kcs.append(kc)
        vcs.append(vc)
    return x, (kcs, vcs, kss, vss)


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
                "MHA with d_head % 128 == 0 required")
        return True
    return ok and torch.device(device).type == "cuda"


def _decode_step(ctx: _DecodeCtx, token, cur: int, caches, fused: bool,
                 positions):
    """One token through every layer; updates the caches (``_prefill``'s
    lists) at column ``cur`` and returns the float32 logits of the next
    token."""
    cfg = ctx.cfg
    kcs, vcs, kss, vss = caches
    b = token.shape[0]
    pos = positions[cur:cur + 1]
    x = ctx.embed(token[:, None], pos)
    rope = cfg.pos_encoding == "rope"
    sincos = rope_sincos(pos, cfg.d_head, cfg.rope_theta) if rope else None
    if not fused:
        mask = positions <= cur
    elif not ctx.quant:
        # duplicated tables: the kernel's split-half rotation reads
        # concat([c, c]) / concat([s, s])
        if rope:
            cos2 = torch.cat([sincos[0], sincos[0]], dim=-1)
            sin2 = torch.cat([sincos[1], sincos[1]], dim=-1)
        else:
            cos2 = torch.ones((1, cfg.d_head), device=token.device)
            sin2 = torch.zeros((1, cfg.d_head), device=token.device)
    for li, lp in enumerate(ctx.layers):
        q, k, v = ctx.qkv_proj(x, lp)
        if fused and ctx.quant:
            # JAX's split: RoPE, the fresh column's quantization and the
            # scale-row write as tensor ops, then one B14 launch
            h, dh = q.shape[2], q.shape[3]
            if rope:
                q = apply_rope(q, pos, cfg.rope_theta, sincos)
                k = apply_rope(k, pos, cfg.rope_theta, sincos)
            kq, ksn = quantize_last(k.reshape(b * h, dh))
            vq, vsn = quantize_last(v.reshape(b * h, dh))
            kss[li][:, cur] = ksn
            vss[li][:, cur] = vsn
            attn, _, _ = decode_step_attention_q8(
                q.reshape(b * h, dh).contiguous(), kq, vq,
                dequantize_last(kq, ksn), dequantize_last(vq, vsn),
                kcs[li], vcs[li], kss[li], vss[li], cur, scale=ctx.scale)
            attn = attn.reshape(b, 1, h, dh)
        elif fused:
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
            if ctx.quant:
                (k, ksn), (v, vsn) = quantize_last(k), quantize_last(v)
                kss[li][:, cur] = ksn[:, 0]
                vss[li][:, cur] = vsn[:, 0]
            kcs[li][:, cur] = k[:, 0]
            vcs[li][:, cur] = v[:, 0]
            if ctx.quant:
                attn = _masked_attention_q8(q, kcs[li], vcs[li], kss[li],
                                            vss[li], mask, ctx.scale,
                                            ctx.n_rep)
            else:
                attn = _masked_attention(q, kcs[li], vcs[li], mask,
                                         ctx.scale, ctx.n_rep)
        x = ctx.close_attn(x, attn, lp)
        x = ctx.ffn(x, lp)
    return ctx.logits(x[:, 0])


@torch.no_grad()
def greedy_generate(params: dict, prompt: torch.Tensor, mesh: ModelMesh,
                    cfg: TransformerConfig, n_new: int, *,
                    return_logits: bool = False):
    """Greedy continuation: integer ``prompt`` (B, S) -> (B, S + n_new)
    tokens on the mesh's device (prompt followed by the argmax decode).

    ``params`` must live on the mesh's device; under
    ``decode_quant="int8"`` they may be the fp dict (quantized here) or
    the quantized one. ``return_logits`` also returns the float32
    logits each new token was chosen from, ``(n_new, B, vocab)``."""
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
    ctx = _DecodeCtx(cfg, maybe_quantize_params(params, mesh, cfg))
    fused = _resolve_decode_step(cfg, dev)
    cache_len = (decode_step_cache_len(total, torch.int8, lane=ctx.quant)
                 if fused else total)
    positions = torch.arange(cache_len, device=dev)

    x, caches = _prefill(ctx, prompt, s_prompt, cache_len, fused)
    logits = ctx.logits(x[:, -1])
    kept = [logits] if return_logits else None
    toks = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        logits = _decode_step(ctx, toks[-1], s_prompt + i, caches, fused,
                              positions)
        if return_logits:
            kept.append(logits)
        toks.append(torch.argmax(logits, dim=-1))
    out = torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                    dim=1)
    return (out, torch.stack(kept)) if return_logits else out


def maybe_quantize_params(params: dict, mesh, cfg: TransformerConfig):
    """The int8 path's set-up: the quantized dict when ``cfg`` arms
    ``decode_quant`` and ``params`` is still the fp dict; ``params``
    itself otherwise (a caller that quantized once passes it through)."""
    if cfg.decode_quant != "int8" or is_quantized_params(params):
        return params
    return quantize_decode_params(params, cfg, mesh)


def sample_generate(*args, **kwargs):
    """Not ported: sampled decoding keys every draw by ``jax.random``'s
    threefry, whose bits torch cannot reproduce, so it waits for its own
    slice with a counter-based generator of the port's own."""
    raise NotImplementedError(
        "sample_generate is not ported yet: sampled decode is a later "
        "slice (threefry draws are not reproducible in torch)")
