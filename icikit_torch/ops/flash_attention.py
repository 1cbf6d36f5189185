"""Flash attention on Hopper: the forward and the fused decode step.

The port of ``icikit/ops/flash_attention.py``'s inference surface. The
forward streams K/V tiles past a resident Q tile with an online softmax
(``ops.cuda_attention.flash_fwd``, the counterpart of the TPU's B3 and
B5), so the (s, s) logits never reach device memory; the decode step
(``decode_step_attention``, B13) applies RoPE, writes the cache column
in place and attends one token in one launch per layer.

Layout ``(batch, seq, heads, head_dim)`` at the public functions, as in
the JAX package. On a CUDA tensor the kernel covers every length (a
ragged last tile is masked); the one fallback to the dense oracle is a
matter of semantics, as in JAX: causal attention with s_q != s_kv
(end-aligned masking, which the kernel does not model). On a CPU tensor
the kernels' plain versions run.

Not ported yet, and refused loudly: ``softmax_shift`` (the constant-
shift forward, B4, in the train slice) and gradients (the backward
kernels B6-B8).
"""

from __future__ import annotations

import torch

from icikit_torch.ops import cuda_attention
from icikit_torch.ops.attention import dense_attention, masked_logits


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


def _flash_supported(sq: int, sk: int, causal: bool, device) -> bool:
    """Does the flash path take this shape on ``device``? The kernel
    covers every length on ``cuda`` and its plain version every length
    on ``cpu``; causal attention with s_q != s_kv goes to the oracle."""
    if causal and sq != sk:
        return False
    return torch.device(device).type in ("cuda", "cpu")


def _refuse_unported(q, k, v, softmax_shift) -> None:
    if softmax_shift is not None:
        raise NotImplementedError(
            "softmax_shift (the constant-shift forward, TPU kernel B4) "
            "is not ported yet: it comes with the train slice")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward in the port yet (TPU "
            "kernels B6-B8, the train slice); call it under "
            "torch.no_grad()")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: float | None = None,
                             softmax_shift: float | None = None):
    """Flash attention returning the per-row log-sum-exp as well:
    ``(out (b, s_q, h, d), lse (b, h, s_q) float32, nats)``."""
    _refuse_unported(q, k, v, softmax_shift)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _flash_supported(q.shape[1], k.shape[1], causal, q.device):
        return _dense_with_lse(q, k, v, causal, scale)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = cuda_attention.flash_fwd(qt, kt, vt, bool(causal),
                                        float(scale))
    return out.transpose(1, 2), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: float | None = None,
                    softmax_shift: float | None = None) -> torch.Tensor:
    """Fused flash attention; drop-in for ``dense_attention``:
    ``(b, s_q, h, d)`` in q's dtype."""
    _refuse_unported(q, k, v, softmax_shift)
    if not _flash_supported(q.shape[1], k.shape[1], causal, q.device):
        return dense_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]


def resolve_attention_impl(name: str):
    """Map a config string to the local attention function."""
    impls = {"flash": flash_attention, "dense": dense_attention}
    if name not in impls:
        raise ValueError(f"unknown attention impl {name!r} "
                         f"(known: {', '.join(sorted(impls))})")
    return impls[name]


# ----------------------------------------------------- fused decode step


def decode_step_supported(d_head: int, n_rep: int, dtype) -> bool:
    """Gate of the fused decode step: MHA only (GQA keeps an
    un-repeated cache the kernel does not model) and a head dim the
    kernel is built for (128 or 256: the TPU's lane-exact widths that
    fit eight warps of dh/32 elements a lane), in float32 or bf16."""
    return (n_rep == 1 and d_head in cuda_attention.DECODE_HEAD_DIMS
            and dtype in (torch.float32, torch.bfloat16))


def decode_step_cache_len(total: int, dtype=None) -> int:
    """Cache columns the fused step wants: ``total`` itself. The TPU
    pads to its sublane multiple; a CTA reads any column count."""
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
