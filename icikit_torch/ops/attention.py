"""Single-device multi-head attention: the dense oracle the flash
kernel and the decode step are held against.

Layout ``(batch, seq, heads, head_dim)``, as in ``icikit.ops.attention``.
Products take the inputs' values exactly and accumulate in float32
(bf16 inputs are widened first, so a bf16 x bf16 product is exact, as
on the TPU's matrix unit with an fp32 accumulator); the softmax is
float32; the weights are cast to the value dtype before the value
product.
"""

from __future__ import annotations

import torch

# Finite on purpose: exp(NEG_INF - m) underflows to exactly 0 for any
# finite row max, where a true -inf would give NaN for a row whose
# every entry is masked (see ops/flash_attention.py).
NEG_INF = float(torch.finfo(torch.float32).min)


def masked_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  scale: float | None, fill: float = NEG_INF
                  ) -> torch.Tensor:
    """float32 ``(b, h, s_q, s_kv)`` logits with the causal mask applied
    (query and key positions aligned at the sequence end)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_kv = q.shape[1], k.shape[1]
        q_pos = torch.arange(s_q, device=q.device)[:, None] + (s_kv - s_q)
        k_pos = torch.arange(s_kv, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits,
                             torch.tensor(fill, device=q.device))
    return logits


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention, softmax in float32.

    q ``(b, s_q, h, d)``, k and v ``(b, s_kv, h, d)``; returns
    ``(b, s_q, h, d)`` in q's dtype.
    """
    w = torch.softmax(masked_logits(q, k, causal, scale), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
