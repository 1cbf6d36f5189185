"""Decoder transformer: configuration, parameters, the layer math, the
loss and the train step.

The port of ``icikit/models/transformer/model.py`` for the decode and
train paths. ``TransformerConfig`` carries every field and default of
the JAX config, so a JAX config maps over field by field; the port
refuses loudly what it has not ported yet (``check_ported``).

The model mesh is (dp, tp, sp) = (1, 1, 1) on one device: the tensor-
parallel ``psum``s that close the column/row matmul pairs in JAX are
the identity at tp = 1, and the (dp, sp) psums of the loss too. Matmuls
run in ``compute_dtype`` from copies of the float32 master parameters;
norm statistics are float32. In the train forward the residual stream
is in ``compute_dtype``, as in JAX's ``_forward_local``; a Python loop
over layers takes the place of ``lax.scan``.

The train step (``make_train_step``) differentiates the loss with
autograd through the flash-attention and fused-head kernels and
applies ``FusedAdam`` in place, with no host sync: ``guard="device"``
selects each update against a finiteness flag on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
            "waits with the kernel-free modules of ROADMAP A8, queued "
            "after the last TPU kernels")
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


# ------------------------------------------------------------- train path


def _attn_pre(x, lp, cdt):
    """First half of the attention sublayer: pre-norm + QKV projection."""
    h = _rms_norm(x, lp["ln1"]).to(cdt)
    return _project_qkv(h, lp, cdt)


def _attn_post(x, attn, lp, cdt):
    """Second half: output projection and residual add, in the residual
    dtype."""
    o = torch.einsum("bshe,hed->bsd", attn.to(cdt), lp["wo"].to(cdt))
    return x + o.to(x.dtype)


REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "dots_attn",
                  "except_attn")
PORTED_REMAT_POLICIES = ("nothing", "except_attn")

# The matmul outputs ``jax.checkpoint_policies.dots_saveable`` keeps.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, *args, dots: bool):
    """``jax.checkpoint(fn)`` (recompute everything) or, with ``dots``,
    ``jax.checkpoint(fn, policy=dots_saveable)``."""
    ctx = ((lambda: create_selective_checkpoint_contexts(_dots_saveable))
           if dots else None)
    kw = {"context_fn": ctx} if ctx else {}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def check_train_ported(cfg: TransformerConfig) -> None:
    """Refuse the train-path options the port has not reached, naming
    the ROADMAP item each waits on."""
    check_ported(cfg)
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         f"(known: {', '.join(sorted(REMAT_POLICIES))})")
    # the save stack rematerializes whole layers whatever the policy says
    if (cfg.remat and cfg.save_stack == "xla"
            and cfg.remat_policy not in PORTED_REMAT_POLICIES):
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet (ported: "
            f"{', '.join(PORTED_REMAT_POLICIES)}); it waits with "
            "optim.py/train.py (ROADMAP A8)")
    if cfg.vocab_parallel:
        raise NotImplementedError(
            "vocab_parallel (the Megatron head over tp) is not ported: it "
            "needs the model mesh's tp > 1 (ROADMAP A5)")
    if cfg.grad_dtype not in ("compute", "float32"):
        raise ValueError(f"unknown grad_dtype {cfg.grad_dtype!r} "
                         "(known: compute, float32)")


def _forward_local(params, tokens, cfg: TransformerConfig,
                   head: str = "logits"):
    """The forward on one device: int tokens (b, s) -> float32 logits
    (b, s, V), or with ``head="hidden"`` the final normed hidden state
    (b, s, D) in the compute dtype, which the fused head consumes.
    ``save_stack="pallas"`` runs the whole layer stack through
    ``ops.stack_write.remat_scan_stacked`` (each layer's input saved in
    an explicit stack by the save-stack kernel, the layer rebuilt in the
    backward), whatever ``remat`` says, as JAX decides it before its
    remat branches. Otherwise ``remat``: False, ``"nothing"`` (each
    layer under checkpoint) or ``"except_attn"`` (the projection and the
    FFN checkpointed under the dots policy, attention outside, so the
    backward never re-runs the flash forward)."""
    from icikit_torch.ops.flash_attention import resolve_attention_impl
    from icikit_torch.ops.rope import apply_rope

    cdt = DTYPES[cfg.compute_dtype]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    x = params["emb"][tokens.long()]
    if cfg.pos_encoding == "learned":
        x = x + params["pos"][:s]
    x = x.to(cdt)
    n_rep = _n_rep(cfg)

    # positions rides as an argument, as in JAX, where the save stack's
    # custom-vjp boundary needs it so
    def attention(q, k, v, positions):
        if cfg.pos_encoding == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
        if cfg.attention_impl == "flash" and cfg.softmax_shift is not None:
            return resolve_attention_impl("flash")(
                q, k, v, causal=True, softmax_shift=cfg.softmax_shift)
        return resolve_attention_impl(cfg.attention_impl)(q, k, v,
                                                          causal=True)

    def ffn(x, lp):
        return _dense_ffn_block(x, lp, cdt, lambda m: m)

    def layer(x, lp, positions):
        q, k, v = _attn_pre(x, lp, cdt)
        return ffn(_attn_post(x, attention(q, k, v, positions), lp, cdt),
                   lp)

    def pre(x, lp):
        return _attn_pre(x, lp, cdt)

    def post(x, attn, lp):
        return ffn(_attn_post(x, attn, lp, cdt), lp)

    keys = _layer_keys(cfg)
    if cfg.save_stack == "pallas":
        from icikit_torch.ops.stack_write import remat_scan_stacked

        # the dense FFN has no auxiliary loss (MoE's is not ported)
        no_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, _ = remat_scan_stacked(
            lambda x, lp, positions: (layer(x, lp, positions), no_aux), x,
            {k: params[k] for k in keys}, positions)
    else:
        # unbind, not index: its backward stacks the per-layer gradients
        # once instead of scattering each into a zeroed full-size leaf
        per_layer = {k: params[k].unbind(0) for k in keys}
        for li in range(cfg.n_layers):
            lp = {k: per_layer[k][li] for k in keys}
            if not cfg.remat:
                x = layer(x, lp, positions)
            elif cfg.remat_policy == "except_attn":
                q, k, v = _checkpointed(pre, x, lp, dots=True)
                x = _checkpointed(post, x, attention(q, k, v, positions),
                                  lp, dots=True)
            else:  # "nothing"
                x = _checkpointed(layer, x, lp, positions, dots=False)
    x = _rms_norm(x, params["ln_f"]).to(cdt)
    if head == "hidden":
        return x
    return torch.einsum("bsd,vd->bsv", x,
                        params["w_out"].to(cdt)).float()


def _use_fused_head(cfg: TransformerConfig, b: int, s: int) -> bool:
    if not cfg.fused_head or cfg.vocab_parallel:
        return False
    from icikit_torch.ops.xent import xent_supported
    return xent_supported(b * s, cfg.d_model, cfg.vocab,
                          DTYPES[cfg.compute_dtype])


def _local_loss(params, tokens, targets, cfg: TransformerConfig):
    """Mean token cross-entropy over the batch: the fused head
    (``fused_xent``) where its gate takes the shape, else float32 logits
    and ``log_softmax``. MoE is not ported, so its aux term is 0."""
    b, s = tokens.shape
    if _use_fused_head(cfg, b, s):
        from icikit_torch.ops.xent import fused_xent
        h = _forward_local(params, tokens, cfg, head="hidden")
        w = params["w_out"].to(h.dtype)
        nll = fused_xent(h.reshape(b * s, cfg.d_model), w,
                         targets.reshape(b * s),
                         save_exp=cfg.xent_save_exp,
                         fused_bwd=cfg.xent_fused_bwd).reshape(b, s)
    else:
        logits = _forward_local(params, tokens, cfg)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.sum() / (b * s)


def loss_and_metrics(params: dict, tokens, targets, mesh: ModelMesh,
                     cfg: TransformerConfig, draft_tokens=None,
                     draft_p0: int = 0):
    """Mean token cross-entropy, its gradient dict (one leaf per
    floating parameter, in the leaf's dtype) and the metric dict (empty:
    the draft head is not ported). ``tokens``/``targets``: integer
    ``(B, S)`` on the mesh's device."""
    check_train_ported(cfg)
    if draft_tokens is not None:
        raise NotImplementedError(
            "draft_tokens (on-policy draft distillation) needs the draft "
            "head, which is not ported yet (it comes with speculative "
            "decode)")
    dev = torch.device(mesh.device)
    leaves = {k: v.detach().requires_grad_(torch.is_floating_point(v))
              for k, v in params.items()}
    with torch.enable_grad():
        loss = _local_loss(leaves, tokens.to(dev), targets.to(dev), cfg)
        names = [k for k, v in leaves.items() if v.requires_grad]
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads)), {}


def loss_fn(params, tokens, targets, mesh, cfg: TransformerConfig):
    """Global mean token cross-entropy and the full gradient dict."""
    loss, grads, _ = loss_and_metrics(params, tokens, targets, mesh, cfg)
    return loss, grads


class FusedAdam:
    """Adam as one pass per leaf (``icikit_torch.ops.adam``), for
    ``make_train_step``: the update writes p', m' and v' in place, so
    there is no separable update tree. ``lr`` is a float or a
    ``step -> lr`` callable (step a device tensor). ``mu_dtype`` and
    ``nu_dtype`` store the moments narrow; the arithmetic stays float32.
    ``use_pallas`` runs each floating leaf through the one-pass CUDA
    kernel (``ops.cuda_adam``, the counterpart of the TPU kernel B12)
    instead of PyTorch's elementwise ops."""

    def __init__(self, lr=3e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, use_pallas: bool = False,
                 mu_dtype=None, nu_dtype=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.use_pallas = use_pallas
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    def init(self, params: dict):
        """``(m, v, t)``: zero moments in their storage dtypes and a
        0-d int32 step count, on the parameters' device."""
        def zeros(dtype):
            return {k: torch.zeros_like(
                v, dtype=(dtype if dtype is not None
                          and torch.is_floating_point(v) else v.dtype))
                    for k, v in params.items()}
        dev = next(iter(params.values())).device
        return (zeros(self.mu_dtype), zeros(self.nu_dtype),
                torch.zeros((), dtype=torch.int32, device=dev))


def _grads_finite(loss, grads: dict) -> torch.Tensor:
    """One bool scalar on the device: the loss and every floating
    gradient leaf finite. No host sync."""
    ok = torch.isfinite(loss)
    for g in grads.values():
        if torch.is_floating_point(g):
            ok = ok & torch.isfinite(g).all()
    return ok


# Leaves that feed float32 arithmetic directly (norm statistics, the
# gather and positional add before the cast into the compute stream)
# stay float32 under grad_dtype="compute"; the weight matmuls cast per
# use, so narrowing them only narrows their gradients. Explicit names,
# as in JAX: a new leaf without a verdict fails loudly.
KEEP_FP32 = {"ln1", "ln2", "ln_f", "emb", "pos", "draft_ln"}
NARROW_OK = {"wo", "w_out", "wq", "wkv", "wqkv", "wr", "we1", "we2", "w1",
             "w2", "draft_a", "draft_b", "draft_out"}


def make_train_step(mesh: ModelMesh, cfg: TransformerConfig,
                    optimizer=None, guard: str = "none",
                    grad_check: str = "none", draft_p0: int = 0):
    """The training step: ``step(params, opt_state, tokens, targets) ->
    (params, opt_state, loss)``, or with ``guard="device"`` a fourth
    output, the ``ok`` bool scalar on the device. Returns
    ``(optimizer, step)``. ``optimizer``: a ``FusedAdam`` (default
    ``FusedAdam(3e-4)``, which JAX's ``tests/test_optim.py`` pins to
    ``optax.adam``).

    The update is in place: the returned params and state are the
    tensors passed in, overwritten (JAX donates them instead).
    ``guard="device"`` commits each leaf's update through ``where(ok,
    new, old)``, so a step with a non-finite loss or gradient is skipped
    on the device with no host sync; the step count advances only with
    the update."""
    if guard not in ("none", "device"):
        raise ValueError(f"unknown guard {guard!r} (known: none, device)")
    if grad_check not in ("none", "ring"):
        raise ValueError(f"unknown grad_check {grad_check!r} "
                         "(known: none, ring)")
    if grad_check != "none" and guard != "device":
        raise ValueError(
            "grad_check needs guard='device': the verdict is absorbed "
            "through the on-device where(ok, new, old) select")
    if grad_check == "ring":
        raise NotImplementedError(
            "grad_check='ring' (the checked gradient sync over dp) needs "
            "the checked transport and dp > 1 (ROADMAP A5)")
    check_train_ported(cfg)
    if optimizer is None:
        optimizer = FusedAdam(3e-4)
    if not isinstance(optimizer, FusedAdam):
        raise NotImplementedError(
            "make_train_step takes a FusedAdam: optax transformations "
            "and optim.py are not ported yet (ROADMAP A8)")
    from icikit_torch.ops.adam import adam_apply

    cdt = DTYPES[cfg.compute_dtype]
    opt = optimizer

    def narrow(p: dict) -> dict:
        if cfg.grad_dtype == "float32":
            return p
        unknown = set(p) - KEEP_FP32 - NARROW_OK
        if unknown:
            raise ValueError(
                f"params {sorted(unknown)} have no grad_dtype verdict; "
                "add them to KEEP_FP32 (feeds fp32 arithmetic directly) "
                "or NARROW_OK (cast-per-use matmul weight) in "
                "make_train_step")
        return {k: v if k in KEEP_FP32 or not torch.is_floating_point(v)
                else v.to(cdt) for k, v in p.items()}

    def step(params, opt_state, tokens, targets, sync_taint=None,
             draft_tokens=None):
        if sync_taint is not None:
            raise NotImplementedError(
                "sync_taint belongs to grad_check='ring' (ROADMAP A5)")
        loss, grads, _ = loss_and_metrics(narrow(params), tokens, targets,
                                          mesh, cfg, draft_tokens,
                                          draft_p0)
        m, v, t = opt_state
        t_next = t + 1
        lr = opt.lr(t_next) if callable(opt.lr) else opt.lr
        ok = _grads_finite(loss, grads) if guard == "device" else None
        adam_apply(params, m, v, grads, lr, t_next, opt.b1, opt.b2,
                   opt.eps, use_pallas=opt.use_pallas, ok=ok)
        t.copy_(t_next if ok is None else torch.where(ok, t_next, t))
        if guard == "device":
            return params, (m, v, t), loss, ok
        return params, (m, v, t), loss

    return optimizer, step
