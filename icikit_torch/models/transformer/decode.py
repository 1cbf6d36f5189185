"""Autoregressive decoding with a KV cache, on the model mesh.

The port of ``icikit/models/transformer/decode.py``'s generate paths:
``greedy_generate`` and ``sample_generate``. Prefill runs the prompt
once through the causal forward (the flash kernel,
``attention_impl="flash"``) and saves per-layer K/V; each decode step
attends one query position against the cache. The residual stream
stays float32 in both phases, as in JAX; matmuls run in
``compute_dtype`` from weight copies made once per generate call.

The mesh is JAX's (dp, tp, sp) with sp = 1, its ranks rows of one
device as in the train step (``model.py``). The batch shards over dp;
a dp rank's rows share every weight and no sum crosses dp, so the dp
ranks fold into the batch and every kernel launch covers them all.
Heads (and with them the caches) shard over tp: each leaf enters by
``model._enter`` (its tp shard a rank, ``quant.decode_param_specs``),
the residual stream is held once a tp rank, ``(tp B, s, D)`` with tp
rank t's rows after rank t - 1's, and the projections run per rank;
``close_attn`` and the FFN close with a psum over tp
(``parallel.model_axes.psum``), as JAX's per-shard program does. A
rank's attention reads only its own heads, so the ranks fold into the
rows of one ``flash_fwd``, ``decode_step`` or ``decode_step_q8``
launch a layer. Under ``vocab_parallel`` each tp rank forms its slice
of the logits, scatters it into a zero row and the psum over tp
assembles the full row (``_DecodeCtx.logits``); otherwise the logits
are replicated over tp and are formed once, from tp rank 0's rows.

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
matvec kernel, B15, wherever its gate accepts the shape), one product a
tp rank (the kernel takes one weight a launch); the prefill's
attention runs on the raw projections and its K/V are quantized as
they are stored, into int8 caches with float32 per-(position, head)
scales; a step attends over the int8 caches, fused
(``decode_step_attention_q8``, B14) or unfused. The int8 leaves and
their scales are never cast to the compute dtype.

Sampling rides JAX's schedule-invariant key discipline: row r draws
from the stream ``fold_in(key, seeds[r])`` and the draw deciding the
token at absolute position p is keyed ``fold_in(stream, p)``, so a
row's tokens depend on its prompt, seed and knobs only, never on the
batch, the mesh or the step count. The keys are JAX's threefry key
data, reproduced bit for bit by ``utils/threefry.py``; the filter
(temperature, top-k by a sort threshold, nucleus from the same sort)
is ``_sample_filter``, the draw the argmax of the key's Gumbel noise
plus the filtered logits (``jax.random.categorical``); a generate makes
its draws' noise ahead of the steps (``_step_noise``).

On a CUDA mesh every attention goes through the kernels; on a CPU mesh
(tests) through their plain versions.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from icikit_torch import chaos
from icikit_torch.models.transformer.model import (
    DTYPES,
    MATMUL_KEYS,
    TP_AXIS,
    ModelMesh,
    TransformerConfig,
    _attn_post,
    _check_mesh_cfg,
    _dense_ffn_block,
    _enter,
    _layer_keys,
    _n_rep,
    _project_qkv,
    _rms_norm,
    check_ported,
    repeat_kv,
)
from icikit_torch.models.transformer.quant import (
    decode_param_specs,
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
from icikit_torch.parallel.model_axes import psum
from icikit_torch.utils import threefry

# the decode dispatch boundary's drill site, as JAX registers it
chaos.register_site("decode.prefill")

# the Gumbel noise a sampled generate makes at once: 64 MiB of float32
# (one chunk for 64 steps of 8 rows at a 32768-token vocab)
NOISE_CHUNK_ELEMS = 1 << 24


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


def _sample_filter(lg, temperature, top_k, top_p):
    """The sampling filter over raw float32 logits ``lg (..., V)``, the
    knobs broadcasting against ``lg[..., 0]``: temperature, then top-k
    by a threshold from one descending sort, then nucleus from the same
    sort (top-k only sends a suffix of it to -inf). ``top_k <= 0`` and
    ``top_p >= 1`` disable the filters; a row with both returns exactly
    its temperature-scaled logits. ``torch.sort`` stands where JAX's
    ``jnp.sort`` does: ties are decided by value, not position."""
    v = lg.shape[-1]
    t = torch.clamp_min(temperature, 1e-6)[..., None]
    x = lg / t
    srt = torch.sort(x, dim=-1, descending=True).values
    kk = torch.clamp(top_k.to(torch.int32) - 1, 0, v - 1).long()
    kk = kk.expand(lg.shape[:-1])[..., None]
    thr_k = torch.where(top_k[..., None] > 0, srt.gather(-1, kk),
                        float("-inf"))
    x = torch.where(x < thr_k, float("-inf"), x)
    srt2 = torch.where(srt < thr_k, float("-inf"), srt)
    probs = torch.softmax(srt2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[..., None]     # the first always kept
    thr_p = torch.where(keep, srt2, float("inf")).amin(-1, keepdim=True)
    out = torch.where(x < thr_p, float("-inf"), x)
    neutral = ((top_k <= 0) & (top_p >= 1.0))[..., None]
    return torch.where(neutral, lg / t, out)


def _draw_scores(lg, noise, knobs, filters: bool = True):
    """Each row's draw scores: its Gumbel ``noise (..., V)`` plus its
    filtered logits (``lg`` and ``knobs`` as :func:`_select_token`'s);
    the draw is their argmax (``jax.random.categorical``)."""
    temperature, top_p, top_k = knobs[..., 0], knobs[..., 1], knobs[..., 2]
    if filters:
        x = _sample_filter(lg, temperature, top_k, top_p)
    else:
        x = lg / torch.clamp_min(temperature, 1e-6)[..., None]
    return noise + x


def _select_token(lg, noise, knobs, filters: bool = True):
    """Each row's token: ``lg (..., V)`` float32 logits, ``noise (...,
    V)`` its draw's Gumbel noise (``threefry.gumbel`` of its key),
    ``knobs (..., 3)`` float32 (temperature, top_p, top_k) broadcasting
    against the rows. ``temperature <= 0`` is the argmax of the raw
    logits, bitwise the greedy path; ``filters=False`` leaves out the
    top-k / top-p machinery and its sort, for calls whose rows all run
    pure temperature sampling."""
    samp = torch.argmax(_draw_scores(lg, noise, knobs, filters), dim=-1)
    return torch.where(knobs[..., 0] > 0.0, samp,
                       torch.argmax(lg, dim=-1)).to(torch.int32)


def _as_knobs(knobs, logits):
    knobs = torch.as_tensor(knobs, dtype=torch.float32,
                            device=logits.device)
    if knobs.dim() == 2 and logits.dim() == 3:
        knobs = knobs[:, None, :]
    return knobs


def select_tokens(logits, keys, knobs, filters: bool = True):
    """The batched keyed selector: ``logits (b, V)`` or ``(b, k, V)``,
    ``keys`` the matching ``(b, 2)`` / ``(b, k, 2)`` key data, ``knobs``
    ``(3,)`` shared or ``(b, 3)`` a row. A row's draw depends on its
    logits, key and knobs only."""
    noise = threefry.gumbel(keys, logits.shape[-1:])
    return _select_token(logits, noise, _as_knobs(knobs, logits), filters)


def draw_gap(logits, keys, knobs, filters: bool = True):
    """The top-2 gap of each draw's scores (Gumbel noise plus filtered
    logits), arguments as :func:`select_tokens`'s: where it is within
    float32 rounding, two correct computations of the same draw may
    pick different tokens (a near-tie)."""
    noise = threefry.gumbel(keys, logits.shape[-1:])
    top = _draw_scores(logits, noise, _as_knobs(knobs, logits),
                       filters).topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def fold_streams(key_data, seeds) -> torch.Tensor:
    """The per-request streams ``fold_in(key, seed)`` of each row's
    int32 ``seeds (b,)``: ``(b, 2)`` key data."""
    key = threefry.as_key_data(key_data)
    seeds = torch.as_tensor(seeds)
    return threefry.fold_in(key.to(seeds.device), seeds)


def fold_positions(streams, pos) -> torch.Tensor:
    """The draw keys ``fold_in(stream, p)`` of the absolute positions
    ``pos (b,)`` or ``(b, k)``: ``(b, 2)`` or ``(b, k, 2)``."""
    pos = torch.as_tensor(pos, device=streams.device)
    return threefry.fold_in(streams if pos.dim() == 1 else streams[:, None],
                            pos)


def request_stream_data(seed: int):
    """The key data (a uint32 numpy array) of the canonical per-request
    stream ``fold_in(key(0), seed)``: bitwise what ``sample_generate``
    derives for a row with key data ``key_data(0)`` and seed ``seed``.
    ``seed`` must fit in uint32, as JAX's ``fold_in`` of a Python int
    requires."""
    seed = int(seed)
    if not 0 <= seed <= threefry.MASK:
        raise OverflowError(f"Python integer {seed} out of bounds for "
                            "uint32")
    return threefry.to_numpy(threefry.fold_in(threefry.key_data(0), seed))


def _make_selector(sampling):
    """``("greedy",)`` or ``("sample", filters)``: select(logits (b, V)
    float32, noise (b, V) the draws' Gumbel noise, knobs (3,)) -> (b,)
    tokens."""
    if sampling[0] == "greedy":
        return lambda logits, noise, knobs: torch.argmax(logits, dim=-1)
    filters = sampling[1] if len(sampling) > 1 else True
    return lambda logits, noise, knobs: _select_token(logits, noise, knobs,
                                                      filters)


def _step_noise(keys, vocab: int):
    """Each step's Gumbel noise ``(b, vocab)`` from the draw keys ``keys
    (b, n_new, 2)``, made for a chunk of steps at once (at most
    NOISE_CHUNK_ELEMS floats): the noise depends only on a draw's key,
    so no step waits on threefry's elementwise launches."""
    chunk = max(1, NOISE_CHUNK_ELEMS // (keys.shape[0] * vocab))
    for c in range(0, keys.shape[1], chunk):
        yield from threefry.gumbel(keys[:, c:c + chunk], (vocab,)).unbind(1)


def _check_sampling_args(cfg, temperature, top_k, top_p):
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if not 0 <= top_k <= cfg.vocab:
        raise ValueError(f"top_k must be in [0, vocab={cfg.vocab}], "
                         f"got {top_k}")


class _DecodeCtx:
    """The per-layer decode math over one call's weights, for every rank
    of the mesh at once: the compute-dtype copies of every matmul weight
    and each tp rank's shard of it are made here, once per generate
    call (each decode step then streams them, the byte model of
    ``bench/decode.py``). Under ``decode_quant="int8"`` ``params`` is
    the quantized dict and nothing is cast: the int8 leaves and their
    float32 scales reach ``qmm`` as they are.

    Activations are ``(tp b, ...)``: tp rank t's rows of the batch after
    rank t - 1's (one copy a rank of the replicated residual stream);
    at tp = 1 that is the single-device layout. ``mesh`` defaults to
    the (1, 1, 1) mesh."""

    def __init__(self, cfg: TransformerConfig, params: dict,
                 mesh: ModelMesh | None = None):
        if mesh is None:
            mesh = ModelMesh(device=params["emb"].device.type)
        self.cfg = cfg
        self.cdt = DTYPES[cfg.compute_dtype]
        self.scale = cfg.d_head ** -0.5
        self.n_rep = _n_rep(cfg)
        self.quant = cfg.decode_quant == "int8"
        self.qimpl = cfg.quant_matvec
        self.tp = mesh.tp
        # a dp rank's tp ranks: the leaves are the same on every dp rank
        self.mesh = ModelMesh(1, mesh.tp, 1, mesh.device)
        specs = decode_param_specs(cfg)
        keys = quant_layer_keys(cfg) if self.quant else _layer_keys(cfg)

        def cast(key, w):
            return (w.to(self.cdt) if key in MATMUL_KEYS and not self.quant
                    else w)

        def enter(key, w, layered):
            w = cast(key, w)
            if self.tp == 1:
                return w
            return _enter(w, specs[key], layered, self.mesh)[0].contiguous()

        stacked = {k: enter(k, params[k], True) for k in keys}
        self.layers = [{k: w[li] for k, w in stacked.items()}
                       for li in range(cfg.n_layers)]
        self.emb = params["emb"]
        self.pos = params.get("pos")
        self.ln_f = params["ln_f"]
        self.vp = cfg.vocab_parallel and self.tp > 1
        # the head: a shard a tp rank under vocab_parallel, else the
        # replicated leaf itself
        head = enter if self.vp else lambda k, w, _: cast(k, w)
        self.w_out = head("w_out", params["w_out"], False)
        self.w_out_s = (head("w_out_s", params["w_out_s"], False)
                        if self.quant else None)

    def psum_tp(self, v):
        """The psum over tp of ``v (tp b, ...)``'s per-rank partials."""
        if self.tp == 1:
            return v
        return psum(v.view(self.tp, -1, *v.shape[1:]), self.mesh,
                    TP_AXIS).view(v.shape)

    def qproj(self, x, w, s, k_ndim=1):
        """``x (tp b, ..., K)`` through each tp rank's int8 leaf and
        scales, one product a rank."""
        if self.tp == 1:
            return qmm(x, w, s, k_ndim=k_ndim, impl=self.qimpl)
        xs = x.view(self.tp, -1, *x.shape[1:])
        return torch.cat([qmm(xs[t], w[t], s[t], k_ndim=k_ndim,
                              impl=self.qimpl) for t in range(self.tp)])

    def qkv_proj(self, x, lp):
        h = _rms_norm(x, lp["ln1"], self.tp).to(self.cdt)
        if not self.quant:
            return _project_qkv(h, lp, self.cdt, self.tp)
        if "wq" in lp:
            q = self.qproj(h, lp["wq"], lp["wq_s"]).to(self.cdt)
            kv = self.qproj(h, lp["wkv"], lp["wkv_s"]).to(self.cdt)
            return q, kv[:, :, 0], kv[:, :, 1]
        qkv = self.qproj(h, lp["wqkv"], lp["wqkv_s"]).to(self.cdt)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def close_attn(self, x, attn, lp):
        if self.quant:
            # wo stored (D, H, Dh): the contraction (H, Dh) last, each
            # rank's partial sums scaled per full output channel
            return x + self.psum_tp(self.qproj(attn.to(self.cdt), lp["wo"],
                                               lp["wo_s"], k_ndim=2))
        return _attn_post(x, attn, lp, self.cdt, self.psum_tp, self.tp)

    def ffn(self, x, lp):
        if not self.quant:
            return _dense_ffn_block(x, lp, self.cdt, self.psum_tp, self.tp)
        h2 = _rms_norm(x, lp["ln2"], self.tp).to(self.cdt)
        u = F.gelu(self.qproj(h2, lp["w1"], lp["w1_s"]),
                   approximate="tanh").to(self.cdt)
        return x + self.psum_tp(self.qproj(u, lp["w2"], lp["w2_s"]))

    def logits(self, x):
        """float32 logits ``(b, V)`` from hidden states ``x (tp b, D)``:
        the product runs in the compute dtype and is widened after
        (under int8, the int8 unembedding with float32 accumulation).
        Replicated over tp, they come from rank 0's rows; under
        ``vocab_parallel`` each rank's slice is scattered into a zero
        row and the psum over tp assembles the row, as in JAX."""
        w = self.w_out
        if not self.vp:
            h = _rms_norm(x[:x.shape[0] // self.tp], self.ln_f).to(self.cdt)
            if self.quant:
                return qmm(h, w, self.w_out_s, impl=self.qimpl)
            return torch.matmul(h, w.t()).float()
        h = _rms_norm(x, self.ln_f).to(self.cdt)
        if self.quant:
            lg = self.qproj(h, w, self.w_out_s)
        else:
            lg = torch.matmul(h.view(self.tp, -1, h.shape[-1]),
                              w.transpose(1, 2)).float()
        tp, v_loc = self.tp, w.shape[1]
        lg = lg.view(tp, -1, v_loc)
        full = lg.new_zeros((tp, lg.shape[1], tp, v_loc))
        ranks = torch.arange(tp, device=lg.device)
        full[ranks, :, ranks] = lg
        return psum(full.view(tp, lg.shape[1], tp * v_loc), self.mesh,
                    TP_AXIS)[0]

    def embed(self, tokens, positions):
        """``tokens (b, w)`` -> the residual stream ``(tp b, w, D)``."""
        x = self.emb[tokens.long()]
        if self.cfg.pos_encoding == "learned":
            x = x + self.pos[positions]
        return x if self.tp == 1 else x.repeat(self.tp, 1, 1)


def _prefill(ctx: _DecodeCtx, prompt, s_prompt: int, total: int,
             fused: bool):
    """Full causal forward over the prompt: the final hidden states
    ``x (tp b, s, D)`` and per-layer K/V caches of ``total`` columns,
    ``(tp b, total, hkv, dh)`` for the unfused step or ``(tp b h, total,
    dh)`` (each rank's heads flattened into rows) for the fused one, as
    lists ``(kcs, vcs, kss, vss)`` (``hkv`` and ``h`` a rank's). Under
    int8 the caches are int8 and ``kss``/``vss`` their float32
    per-(position, head) scales, ``(tp b, total, hkv)`` or ``(tp b h,
    total)``: K/V are quantized as they are stored (the prompt's own
    attention ran on the raw projections). Otherwise ``kss`` and
    ``vss`` are None."""
    cfg = ctx.cfg
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
            rows = k.shape[0] * k.shape[2]
            k = k.transpose(1, 2).reshape(rows, s_prompt, -1)
            v = v.transpose(1, 2).reshape(rows, s_prompt, -1)
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
    """One token ``(b,)`` through every layer; updates the caches
    (``_prefill``'s lists) at column ``cur`` and returns the float32
    logits ``(b, V)`` of the next token."""
    cfg = ctx.cfg
    kcs, vcs, kss, vss = caches
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
        if fused:
            # every rank's heads are rows of the one launch
            b, _, h, dh = q.shape
        if fused and ctx.quant:
            # JAX's split: RoPE, the fresh column's quantization and the
            # scale-row write as tensor ops, then one B14 launch
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


def _check_generate_mesh(mesh: ModelMesh) -> None:
    """What decode refuses on a mesh: a sharded sequence (as JAX does),
    and dp ranks split across processes (not ported)."""
    if mesh.sp != 1:
        raise ValueError("decoding requires sp=1 (sequence is not "
                         "sharded at decode time)")
    if mesh.procs > 1:
        raise NotImplementedError(
            f"decode on a mesh whose dp ranks span {mesh.procs} processes "
            "is not ported yet (ROADMAP A5: decode across processes); "
            "decode on a one-process mesh")


@torch.no_grad()
def _generate(params: dict, prompt: torch.Tensor, mesh: ModelMesh,
              cfg: TransformerConfig, n_new: int, select, streams, knobs,
              return_logits: bool):
    """The generate loop both entry points share (JAX's
    ``_build_generate``): prefill, the first token, then ``n_new - 1``
    steps, each token chosen by ``select(logits, noise, knobs)`` with
    ``noise`` the Gumbel noise of its absolute position's draw key."""
    check_ported(cfg)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    _check_generate_mesh(mesh)
    _check_mesh_cfg(cfg, mesh)
    s_prompt = prompt.shape[1]
    total = s_prompt + n_new
    if total > cfg.max_seq:
        raise ValueError(f"prompt + new tokens = {total} exceeds "
                         f"max_seq = {cfg.max_seq}")
    if prompt.shape[0] % mesh.dp:
        raise ValueError(f"a batch of {prompt.shape[0]} rows does not "
                         f"shard over dp={mesh.dp}")
    dev = torch.device(mesh.device)
    if params["emb"].device.type != dev.type:
        raise ValueError(f"params live on {params['emb'].device}, the "
                         f"mesh on {dev}")
    prompt = prompt.to(dev)
    ctx = _DecodeCtx(cfg, maybe_quantize_params(params, mesh, cfg), mesh)
    fused = _resolve_decode_step(cfg, dev)
    cache_len = (decode_step_cache_len(total, torch.int8, lane=ctx.quant)
                 if fused else total)
    positions = torch.arange(cache_len, device=dev)
    # every draw's noise ahead of its step: the token at position p is
    # keyed fold_in(stream, p), whatever step computes it
    noise = itertools.repeat(None) if streams is None else _step_noise(
        fold_positions(streams, (s_prompt + torch.arange(
            n_new, device=dev)).expand(prompt.shape[0], -1)), cfg.vocab)

    x, caches = _prefill(ctx, prompt, s_prompt, cache_len, fused)
    logits = ctx.logits(x[:, -1])
    kept = [logits] if return_logits else None
    toks = [select(logits, next(noise), knobs)]
    for i in range(n_new - 1):
        logits = _decode_step(ctx, toks[-1], s_prompt + i, caches, fused,
                              positions)
        if return_logits:
            kept.append(logits)
        toks.append(select(logits, next(noise), knobs))
    out = torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                    dim=1)
    return (out, torch.stack(kept)) if return_logits else out


def greedy_generate(params: dict, prompt: torch.Tensor, mesh: ModelMesh,
                    cfg: TransformerConfig, n_new: int, *,
                    return_logits: bool = False):
    """Greedy continuation: integer ``prompt`` (B, S), B a multiple of
    dp, -> (B, S + n_new) tokens on the mesh's device (prompt followed
    by the argmax decode), at any (dp, tp, 1) mesh of one process.

    ``params`` are the global leaves on the mesh's device; under
    ``decode_quant="int8"`` they may be the fp dict (quantized here) or
    the quantized one. ``return_logits`` also returns the float32
    logits each new token was chosen from, ``(n_new, B, vocab)``."""
    chaos.maybe_delay("decode.prefill")   # the generate's host boundary
    chaos.maybe_die("decode.prefill")
    return _generate(params, prompt, mesh, cfg, n_new,
                     _make_selector(("greedy",)), None, None,
                     return_logits)


def maybe_quantize_params(params: dict, mesh, cfg: TransformerConfig):
    """The int8 path's set-up: the quantized dict when ``cfg`` arms
    ``decode_quant`` and ``params`` is still the fp dict; ``params``
    itself otherwise (a caller that quantized once passes it through)."""
    if cfg.decode_quant != "int8" or is_quantized_params(params):
        return params
    return quantize_decode_params(params, cfg, mesh)


def sample_generate(params: dict, prompt: torch.Tensor, mesh: ModelMesh,
                    cfg: TransformerConfig, n_new: int, key,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, seeds=None, *,
                    return_logits: bool = False):
    """Sampled continuation with temperature / top-k / nucleus filters
    on the schedule-invariant key discipline: row r draws from the
    stream ``fold_in(key, seeds[r])`` and the token at absolute position
    p from ``fold_in(stream, p)``, so a row's tokens depend on its
    prompt, seed and knobs only (not on the batch or the mesh).

    ``key``: JAX's key data, a ``(2,)`` uint32 array or tensor
    (``jax.random.key_data(k)``, or ``threefry.key_data(seed)``); the
    draws are JAX's bit for bit (``utils/threefry.py``) but for the
    Gumbel ``log``'s last place. ``seeds``: int32 request seeds a row
    (default ``arange(B)``). ``top_k=0`` and ``top_p=1.0`` disable those
    filters; ``temperature=0`` is greedy, bitwise. Meshes, params and
    ``return_logits`` as :func:`greedy_generate`."""
    _check_sampling_args(cfg, temperature, top_k, top_p)
    chaos.maybe_delay("decode.prefill")
    chaos.maybe_die("decode.prefill")
    dev = torch.device(mesh.device)
    if seeds is None:
        seeds = torch.arange(prompt.shape[0], dtype=torch.int32)
    seeds = torch.as_tensor(seeds, dtype=torch.int32).to(dev)
    streams = fold_streams(threefry.as_key_data(key, dev), seeds)
    knobs = torch.tensor([temperature, top_p, top_k], dtype=torch.float32,
                         device=dev)
    # filters static: pure temperature sampling leaves the sort out
    select = _make_selector(("sample", top_k > 0 or top_p < 1.0))
    return _generate(params, prompt, mesh, cfg, n_new, select, streams,
                     knobs, return_logits)
