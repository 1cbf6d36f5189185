"""Flash attention on Hopper: forward, backward and the fused decode step.

The port of ``icikit/ops/flash_attention.py``. The forward streams K/V
tiles past a resident Q tile with an online softmax or a constant shift
(``ops.cuda_attention.flash_fwd``, the counterpart of the TPU's B3, B4
and B5), so the (s, s) logits never reach device memory; the backward
(``flash_bwd``, B6 and B7) recomputes P once per tile from the saved
lse; past the TPU's dq scratch budget (``_DQ_SCRATCH_BYTES_MAX``) it is
the deterministic two-pass pair ``flash_bwd_dq``/``flash_bwd_dkv`` (B8),
routed as JAX's ``_bwd_call`` routes. ``_Flash`` is the counterpart of
the ``_flash`` custom_vjp: its residuals are (q, k, v, out, lse), and
the lse cotangent folds into delta. The decode step
(``decode_step_attention``, B13) applies RoPE, writes the cache column
in place and attends one token in one launch per layer; its int8 form
(``decode_step_attention_q8``, B14) attends over int8 caches.

Layout ``(batch, seq, heads, head_dim)`` at the public functions, as in
the JAX package. On a CUDA tensor the kernels cover every length (a
ragged last tile is masked) at the head dims of ``FLASH_HEAD_DIMS`` (32,
64, 128 and 256). Two shapes take the dense oracle instead, a route
decided by ``_flash_supported`` before any launch, as JAX's gate sends
its unsupported shapes to the oracle: causal attention with s_q != s_kv
(end-aligned masking, which the kernels do not model), and on a CUDA
device a head dim outside ``FLASH_HEAD_DIMS`` (16, 48 or 96, say). A
direct kernel call at such a head dim raises. On a CPU tensor the
kernels' plain versions run, at every head dim.

``softmax_shift``: the exact fallback of the constant-shift forward
sits inside the kernel (a tile with an overflowing row is redone
online), so the backward always sees final, finite (out, lse) with no
host sync, where JAX re-runs the whole call through a traced cond.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import cuda_attention
from icikit_torch.ops.attention import dense_attention, masked_logits


# The TPU's whole-sequence float32 dq scratch budget, copied from
# icikit/ops/flash_attention.py:626: a backward with s_q * d * 4 bytes of
# dq above it runs the two-pass kernels (B8), at or below it flash_bwd
# (B6/B7), as _bwd_call:734 decides. Read at call time, so a test can
# lower it as it lowers JAX's.
_DQ_SCRATCH_BYTES_MAX = 48 * 1024 * 1024


def bwd_two_pass(sq: int, d: int) -> bool:
    """Does the backward of ``sq`` query rows at head dim ``d`` take the
    two-pass kernels (B8)? The port has no TPU blocks, so JAX's
    one-block case (always B6) has no counterpart: at the default budget
    it never reaches the two-pass route."""
    return sq * d * 4 > _DQ_SCRATCH_BYTES_MAX


def _dense_with_lse(q, k, v, causal, scale):
    """Oracle fallback returning (out, lse): materializes the logits,
    masked with a true -inf so a fully masked row (causal with
    s_q > s_kv) has lse = -inf and a zero output."""
    logits = masked_logits(q, k, causal, scale, fill=-float("inf"))
    lse = torch.logsumexp(logits, dim=-1)
    w = torch.where(torch.isneginf(lse)[..., None],
                    torch.zeros((), device=q.device),
                    torch.exp(logits - lse[..., None]))
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _flash_supported(sq: int, sk: int, d: int, causal: bool,
                     device) -> bool:
    """Does the flash path take this shape on ``device``? The kernels
    cover every length at the head dims of ``FLASH_HEAD_DIMS`` on
    ``cuda``, their plain versions every length and head dim on
    ``cpu``; causal attention with s_q != s_kv, and a ``cuda`` head dim
    the kernels are not built for, go to the oracle."""
    if causal and sq != sk:
        return False
    kind = torch.device(device).type
    if kind == "cuda":
        return d in cuda_attention.FLASH_HEAD_DIMS
    return kind == "cpu"


class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp (``flash_attention.py:822-853``) on
    ``(b, h, s, d)`` tensors: forward ``flash_fwd`` (online, or with
    the constant shift and its in-kernel fallback), residuals (q, k, v,
    out, lse), backward ``flash_bwd`` (or, past the dq scratch budget,
    ``flash_bwd_dq`` and ``flash_bwd_dkv``) with delta = rowsum(dO o O)
    - g_lse computed here, as ``_flash_bwd`` does (the ring schedule will
    need the lse cotangent)."""

    @staticmethod
    def forward(ctx, qt, kt, vt, causal, scale, shift):
        out, lse = cuda_attention.flash_fwd(qt, kt, vt, causal, scale,
                                            shift)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        qt, kt, vt, out, lse = ctx.saved_tensors
        g_out = g_out.contiguous()
        delta = ((g_out.float() * out.float()).sum(dim=-1)
                 - g_lse.float()).contiguous()
        args = (qt, kt, vt, g_out, lse, delta, ctx.causal, ctx.scale)
        if bwd_two_pass(qt.shape[2], qt.shape[3]):
            dq = cuda_attention.flash_bwd_dq(*args)
            dk, dv = cuda_attention.flash_bwd_dkv(*args)
        else:
            dq, dk, dv = cuda_attention.flash_bwd(*args)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: float | None = None,
                             softmax_shift: float | None = None):
    """Flash attention returning the per-row log-sum-exp as well:
    ``(out (b, s_q, h, d), lse (b, h, s_q) float32, nats)``,
    differentiable in q, k and v (the lse cotangent included).

    ``softmax_shift`` (base 2) opts into the constant-shift forward.
    Use it only where a -inf lse cannot occur by design (full causal
    or dense attention: every row sees a key)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _flash_supported(q.shape[1], k.shape[1], q.shape[-1], causal,
                            q.device):
        return _dense_with_lse(q, k, v, causal, scale)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = _Flash.apply(qt, kt, vt, bool(causal), float(scale),
                            None if softmax_shift is None
                            else float(softmax_shift))
    return out.transpose(1, 2), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: float | None = None,
                    softmax_shift: float | None = None) -> torch.Tensor:
    """Fused flash attention; drop-in for ``dense_attention``:
    ``(b, s_q, h, d)`` in q's dtype."""
    if not _flash_supported(q.shape[1], k.shape[1], q.shape[-1], causal,
                            q.device):
        return dense_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    softmax_shift=softmax_shift)[0]


def resolve_attention_impl(name: str):
    """Map a config string to the local attention function."""
    impls = {"flash": flash_attention, "dense": dense_attention}
    if name not in impls:
        raise ValueError(f"unknown attention impl {name!r} "
                         f"(known: {', '.join(sorted(impls))})")
    return impls[name]


# ----------------------------------------------------- fused decode step


def decode_step_supported(d_head: int, n_rep: int, dtype) -> bool:
    """Gate of the fused decode steps (B13, and B14 under int8), JAX's:
    MHA only (GQA keeps an un-repeated cache the kernels do not model)
    and a head dim that is a positive multiple of 128 (the kernels walk
    a row in 128-wide chunks), in float32 or bf16."""
    return (n_rep == 1 and cuda_attention.decode_head_dim_ok(d_head)
            and dtype in (torch.float32, torch.bfloat16))


def decode_step_cache_len(total: int, dtype=None, lane: bool = False) -> int:
    """Cache columns the fused steps want: ``total`` itself, ``lane`` or
    not. The TPU pads to its sublane multiple (``lane=True``: to 128,
    for the int8 step's scale rows); a CTA reads any column count."""
    return total


def decode_step_attention(q, k, v, kcache, vcache, cur: int, cos, sin, *,
                          scale: float, rope: bool):
    """Fused single-token decode attention step (MHA).

    q, k, v ``(rows, dh)`` with rows = b * h; caches ``(rows, total,
    dh)``, updated **in place** at column ``cur``; ``cos``/``sin`` the
    duplicated RoPE tables ``(1, dh)`` float32 (read only when
    ``rope``). Returns ``(attn (rows, dh), kcache, vcache)``; the caches
    returned are the caller's tensors. Check ``decode_step_supported``
    first."""
    attn = cuda_attention.decode_step(q, k, v, kcache, vcache, int(cur),
                                      cos, sin, scale=float(scale),
                                      rope=bool(rope))
    return attn, kcache, vcache


def decode_step_attention_q8(q, kq, vq, kdq, vdq, kcache, vcache, kscale,
                             vscale, cur: int, *, scale: float):
    """Fused single-token decode step over int8 KV caches (MHA), under
    JAX's signature.

    q ``(rows, dh)`` already rotated; ``kq``/``vq`` the fresh column
    quantized ``(rows, dh)`` int8 and ``kdq``/``vdq`` the same column
    dequantized, float32 (the ``t == cur`` patch); int8 caches ``(rows,
    total, dh)``, updated **in place** at column ``cur``; float32 column
    scales ``kscale``/``vscale`` ``(rows, total)`` already holding the
    fresh column's at ``cur`` (the caller writes them). Returns ``(attn
    (rows, dh) float32, kcache, vcache)``; the caches returned are the
    caller's tensors. Check ``decode_step_supported`` first."""
    attn = cuda_attention.decode_step_q8(q, kq, vq, kdq, vdq, kcache,
                                         vcache, kscale, vscale, int(cur),
                                         scale=float(scale))
    return attn, kcache, vcache
