"""Decoder transformer: configuration, parameters and the layer math.

The port of what ``icikit/models/transformer/model.py`` provides to the
decode path. ``TransformerConfig`` carries every field and default of
the JAX config, so a JAX config maps over field by field; the port
refuses loudly what it has not ported yet (``check_ported``).

The model mesh is (dp, tp, sp) = (1, 1, 1) on one device: the tensor-
parallel ``psum``s that close the column/row matmul pairs in JAX are
the identity at tp = 1. Matmuls run in ``compute_dtype`` from copies of
the float32 master parameters; norm statistics are float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

DP_AXIS, TP_AXIS, SP_AXIS = "dp", "tp", "sp"

# The compute dtypes the attention kernels take.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TransformerConfig:
    """Every field and default of ``icikit.models.transformer.model.
    TransformerConfig``; the JAX docstrings there say what each means.
    The train-only fields are carried for a 1:1 mapping and read by no
    ported code yet."""
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    d_head: int = 32
    d_ff: int = 512
    n_layers: int = 2
    max_seq: int = 128
    compute_dtype: str = "bfloat16"
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_algorithm: str = "xla"
    remat: bool = True
    remat_policy: str = "nothing"
    attention_impl: str = "flash"
    softmax_shift: float | None = 16.0
    pos_encoding: str = "learned"
    rope_theta: float = 10000.0
    n_kv_heads: int = 0
    vocab_parallel: bool = False
    xent_save_exp: bool = True
    xent_fused_bwd: bool = True
    save_stack: str = "xla"
    decode_step: str = "unfused"
    sequence_schedule: str = "ring"
    sp_algorithm: str = "xla"
    scan_unroll: int = 1
    fused_head: bool = True
    grad_dtype: str = "compute"
    draft_head: bool = False
    draft_layers: int = 0
    draft_rank: int = 32
    draft_tied: bool = True
    draft_kl: float = 0.5
    draft_on_policy: bool = False
    decode_quant: str = "none"
    quant_matvec: str = "auto"


@dataclass(frozen=True)
class ModelMesh:
    """The (dp, tp, sp) mesh of the port: one device."""
    dp: int = 1
    tp: int = 1
    sp: int = 1
    device: str = "cuda"

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp, SP_AXIS: self.sp}


def make_model_mesh(dp: int = 1, tp: int = 1, sp: int = 1,
                    device: str = "cuda") -> ModelMesh:
    """The model mesh on ``device`` (the card unless the caller asks for
    the CPU). Only dp = tp = sp = 1 so far: sharding the batch, heads or
    sequence needs the collectives, which the port has not reached."""
    if (dp, tp, sp) != (1, 1, 1):
        raise NotImplementedError(
            f"mesh dp={dp} tp={tp} sp={sp}: the port runs the model on "
            "one device until the collectives are ported (ROADMAP A5)")
    return ModelMesh(dp, tp, sp, device)


def _check_cfg(cfg: TransformerConfig) -> None:
    """The JAX config's validation, copied."""
    if cfg.sequence_schedule not in ("ring", "ulysses", "zigzag"):
        raise ValueError(
            f"unknown sequence_schedule {cfg.sequence_schedule!r} "
            "(known: ring, ulysses, zigzag)")
    if cfg.pos_encoding not in ("learned", "rope"):
        raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r} "
                         "(known: learned, rope)")
    if cfg.pos_encoding == "rope" and cfg.d_head % 2:
        raise ValueError("RoPE requires an even d_head, got "
                         f"{cfg.d_head}")
    if cfg.n_kv_heads and cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} must divide "
                         f"n_heads={cfg.n_heads}")
    if cfg.save_stack not in ("xla", "pallas"):
        raise ValueError(f"unknown save_stack {cfg.save_stack!r} "
                         "(known: xla, pallas)")
    if cfg.decode_step not in ("auto", "fused", "unfused"):
        raise ValueError(f"unknown decode_step {cfg.decode_step!r} "
                         "(known: auto, fused, unfused)")
    if cfg.decode_quant not in ("none", "int8"):
        raise ValueError(f"unknown decode_quant {cfg.decode_quant!r} "
                         "(known: none, int8)")
    if cfg.quant_matvec not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown quant_matvec {cfg.quant_matvec!r} "
                         "(known: auto, pallas, xla)")
    if cfg.decode_quant != "none" and cfg.n_experts:
        raise ValueError("decode_quant currently supports dense FFNs only")
    if cfg.draft_head:
        if not 0 <= cfg.draft_layers <= cfg.n_layers:
            raise ValueError(
                f"draft_layers={cfg.draft_layers} must be in "
                f"[0, n_layers={cfg.n_layers}] (0 = quarter depth)")
        if cfg.draft_rank < 1:
            raise ValueError(f"draft_rank must be >= 1, got "
                             f"{cfg.draft_rank}")
        if not 0.0 <= cfg.draft_kl <= 1.0:
            raise ValueError(f"draft_kl must be in [0, 1], got "
                             f"{cfg.draft_kl}")
        if cfg.save_stack == "pallas":
            raise ValueError("draft_head distillation needs "
                             "save_stack='xla'")
    if cfg.draft_on_policy and not cfg.draft_head:
        raise ValueError("draft_on_policy=True without draft_head")
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r} "
                         f"(known: {', '.join(sorted(DTYPES))})")


def check_ported(cfg: TransformerConfig) -> None:
    """Validate ``cfg`` and refuse what the port has not reached."""
    _check_cfg(cfg)
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "n_experts > 0 (the MoE FFN, moe.py) is not ported yet: it "
            "comes with the train slice (ROADMAP A8)")
    if cfg.decode_quant == "int8":
        raise NotImplementedError(
            "decode_quant='int8' (TPU kernels B14, B15) is not ported "
            "yet: it is the int8 decode slice")
    if cfg.draft_head:
        raise NotImplementedError(
            "draft_head (draft.py, the speculative drafter) is not "
            "ported yet: it comes with speculative decode")


def _is_gqa(cfg: TransformerConfig) -> bool:
    return bool(cfg.n_kv_heads) and cfg.n_kv_heads != cfg.n_heads


def _n_rep(cfg: TransformerConfig) -> int:
    """Query heads served per K/V head."""
    return cfg.n_heads // cfg.n_kv_heads if _is_gqa(cfg) else 1


def _attn_param_keys(cfg: TransformerConfig) -> tuple:
    return ("wq", "wkv") if _is_gqa(cfg) else ("wqkv",)


def _layer_keys(cfg: TransformerConfig) -> tuple:
    """Per-layer parameter names."""
    ffn = ("wr", "we1", "we2") if cfg.n_experts else ("w1", "w2")
    return ("ln1", "ln2", *_attn_param_keys(cfg), "wo", *ffn)


MATMUL_KEYS = ("wq", "wkv", "wqkv", "wo", "w1", "w2", "w_out")


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str = "cuda") -> dict:
    """float32 master parameters with the JAX package's leaf names,
    shapes and ``1/sqrt(fan_in)`` scales, drawn from ``generator``
    (which must live on ``device``). The values differ from JAX's for
    the same seed; tests carry JAX's through ``interop.params_from_jax``.
    """
    check_ported(cfg)
    L, D, H, Dh, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head,
                       cfg.d_ff)

    def norm(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) / math.sqrt(fan_in))

    params = {
        "emb": norm((cfg.vocab, D), D),
        "ln1": torch.ones((L, D), device=device),
        "ln2": torch.ones((L, D), device=device),
        "ln_f": torch.ones((D,), device=device),
        "wo": norm((L, H, Dh, D), H * Dh),
        "w_out": norm((cfg.vocab, D), D),
        "w1": norm((L, D, Fd), D),
        "w2": norm((L, Fd, D), Fd),
    }
    if _is_gqa(cfg):
        params["wq"] = norm((L, D, H, Dh), D)
        params["wkv"] = norm((L, D, 2, cfg.n_kv_heads, Dh), D)
    else:
        params["wqkv"] = norm((L, D, 3, H, Dh), D)
    if cfg.pos_encoding == "learned":
        params["pos"] = norm((cfg.max_seq, D), D)
    return params


def _rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """float32 RMS norm: ``x * rsqrt(mean(x^2) + 1e-6) * g``."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * r) * g


def _project_qkv(h: torch.Tensor, lp: dict, cdt: torch.dtype):
    """(b, s, D) -> q (b, s, H, Dh), k/v (b, s, Hkv, Dh) in ``cdt``.
    GQA K/V heads are repeated at attention time, not here."""
    if "wq" in lp:
        q = torch.einsum("bsd,dhe->bshe", h, lp["wq"].to(cdt))
        kv = torch.einsum("bsd,dthe->bsthe", h, lp["wkv"].to(cdt))
        return q, kv[:, :, 0], kv[:, :, 1]
    qkv = torch.einsum("bsd,dthe->bsthe", h, lp["wqkv"].to(cdt))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Repeat K/V heads to serve their query-head groups (GQA)."""
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _dense_ffn_block(x: torch.Tensor, lp: dict, cdt: torch.dtype,
                     reduce_out) -> torch.Tensor:
    """Pre-norm dense-MLP sublayer. GELU is the tanh approximation, the
    default of ``jax.nn.gelu`` (torch's default is the erf form)."""
    h2 = _rms_norm(x, lp["ln2"]).to(cdt)
    u = F.gelu(torch.matmul(h2, lp["w1"].to(cdt)), approximate="tanh")
    m = torch.matmul(u, lp["w2"].to(cdt))
    return x + reduce_out(m.to(x.dtype))
