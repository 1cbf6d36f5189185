"""Decoder transformer: configuration, parameters, the layer math, the
loss and the train step.

The port of ``icikit/models/transformer/model.py`` for the decode and
train paths. ``TransformerConfig`` carries every field and default of
the JAX config, so a JAX config maps over field by field; the port
refuses loudly what it has not ported yet (``check_ported``).

The model mesh (dp, tp, sp) is JAX's, rank-vectorised on one device as
the collectives are (``utils/mesh.py``): the R = dp tp sp ranks are
rows, in JAX's order (dp outermost, then tp, then sp). A parameter
leaf's value is JAX's global array; each rank sees its shard by
:func:`param_specs` (heads, kv heads and d_ff split over tp; the head's
vocabulary too under ``vocab_parallel``), entering the per-rank program
through ``parallel.model_axes.pvary`` over the axes it is replicated
on, so its gradient's sum over those axes (the gradient sync over dp
and sp, and over tp for a tp-replicated leaf) is that pvary's backward,
a psum. Tokens shard as JAX's ``P(dp, sp)``. The column/row matmul
pairs close with a psum over tp; the loss is psummed over (dp, sp).
Each dp rank runs the per-rank program of its tp sp ranks, vectorised
over them: their weights batch the matmuls, their rows fold into the
kernels' batch. Across OS processes (``parallel.multihost``) a process
holds a contiguous range of the dp ranks and all of their tp and sp
ranks, so only the dp psums cross the process backend. At (1, 1, 1)
every psum and pvary is the identity and the program is the
single-device one.

Matmuls run in ``compute_dtype`` from copies of the float32 master
parameters; norm statistics are float32. In the train forward the
residual stream is in ``compute_dtype``, as in JAX's ``_forward_local``;
a Python loop over layers takes the place of ``lax.scan``.

The train step (``make_train_step``) differentiates the loss with
autograd through the flash-attention and fused-head kernels and
applies ``FusedAdam`` in place, with no host sync: ``guard="device"``
selects each update against a finiteness flag on the device, and
``grad_check="ring"`` adds the checked digest ring over dp to that flag.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from icikit_torch import chaos
from icikit_torch.parallel.model_axes import pmax, psum, pvary
from icikit_torch.utils.mesh import (RankMesh, process_layout,
                                     require_single_process, split_ranks)

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
    """The (dp, tp, sp) mesh of the port: dp tp sp ranks on ``device``,
    split across ``procs`` processes along dp (process i holds dp ranks
    ``[i dp/procs, (i + 1) dp/procs)`` and all their tp and sp ranks)."""
    dp: int = 1
    tp: int = 1
    sp: int = 1
    device: str = "cuda"
    procs: int = 1
    proc: int = 0

    def __post_init__(self):
        for name in ("dp", "tp", "sp"):
            n = getattr(self, name)
            if not isinstance(n, int) or n < 1:
                raise ValueError(f"{name} must be a positive int, got {n!r}")
        split_ranks(self.dp, self.procs, self.proc)

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp, SP_AXIS: self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp

    @property
    def local(self) -> tuple[int, int]:
        """[lo, hi): the dp ranks this process holds."""
        return split_ranks(self.dp, self.procs, self.proc)

    def local_size(self, axis: str) -> int:
        """The ranks of ``axis`` this process holds."""
        return self.dp // self.procs if axis == DP_AXIS else self.shape[axis]

    def axis_mesh(self, axis: str) -> RankMesh:
        """``axis`` as a flat ``RankMesh``, the mesh a collective over it
        runs on (across processes only dp's ranks are split)."""
        procs = self.procs if axis == DP_AXIS else 1
        return RankMesh(self.shape[axis], self.device, axis, procs,
                        self.proc if procs > 1 else 0)


def make_model_mesh(dp: int = 1, tp: int = 1, sp: int = 1,
                    device: str = "cuda") -> ModelMesh:
    """The (dp, tp, sp) model mesh on ``device`` (the card unless the
    caller asks for the CPU), its ranks rows of one device. With a live
    ``torch.distributed`` group (``parallel.multihost.
    init_distributed``) its dp ranks split across the processes, as
    JAX's mesh spans every process's devices: dp must divide by the
    process count."""
    proc, procs = process_layout()
    if procs > 1 and dp % procs:
        raise ValueError(f"dp={dp} does not divide over {procs} processes "
                         "(a process holds whole dp ranks)")
    return ModelMesh(dp, tp, sp, device, procs, proc)


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


def _check_mesh_cfg(cfg: TransformerConfig, mesh) -> None:
    """JAX's mesh-dependent validation, copied: whole heads, kv heads
    (and the vocabulary under ``vocab_parallel``) a tp rank; ulysses'
    heads over sp; zigzag's two chunks a rank."""
    tp = mesh.shape.get(TP_AXIS, 1)
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} must divide over tp={tp}")
    kv = cfg.n_kv_heads or cfg.n_heads
    if kv % tp:
        raise ValueError(f"n_kv_heads={kv} must divide over tp={tp} "
                         "(each tp shard needs whole K/V head groups)")
    if cfg.vocab_parallel and cfg.vocab % tp:
        raise ValueError(f"vocab_parallel requires vocab={cfg.vocab} "
                         f"divisible by tp={tp}")
    sp = mesh.shape.get(SP_AXIS, 1)
    if (cfg.sequence_schedule == "ulysses" and sp > 1
            and (cfg.n_heads // tp) % sp):
        raise ValueError(
            f"ulysses needs per-tp-shard heads ({cfg.n_heads}/{tp}) "
            f"divisible by sp={sp}")
    if (cfg.sequence_schedule == "zigzag" and sp > 1
            and cfg.max_seq % (2 * sp)):
        raise ValueError(
            f"zigzag needs max_seq={cfg.max_seq} divisible by "
            f"2*sp={2 * sp} (two chunks per device)")


def param_specs(cfg: TransformerConfig) -> dict:
    """The port's form of JAX's ``param_specs``: for each leaf, the dim
    that shards over tp (a rank holds a contiguous block of it), or
    None for a leaf replicated over the mesh. Layer leaves are stacked
    on dim 0; every leaf is replicated over dp and sp (MoE's dp-sharded
    experts are not ported)."""
    _check_cfg(cfg)
    specs = {"emb": None, "ln1": None, "ln2": None, "ln_f": None,
             "wo": 1,                                  # (L, H, Dh, D)
             "w_out": 0 if cfg.vocab_parallel else None,  # (V, D)
             "w1": 2,                                  # (L, D, F)
             "w2": 1}                                  # (L, F, D)
    if _is_gqa(cfg):
        specs["wq"] = 2                                # (L, D, H, Dh)
        specs["wkv"] = 3                               # (L, D, 2, Hkv, Dh)
    else:
        specs["wqkv"] = 3                              # (L, D, 3, H, Dh)
    if cfg.pos_encoding == "learned":
        specs["pos"] = None
    return specs


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str = "cuda", mesh: ModelMesh | None = None) -> dict:
    """float32 master parameters with the JAX package's leaf names,
    shapes and ``1/sqrt(fan_in)`` scales, drawn from ``generator``
    (which must live on ``device``, or on ``mesh``'s device when a mesh
    is given). The values differ from JAX's for the same seed; tests
    carry JAX's through ``interop.params_from_jax``. A leaf is its
    global array on any mesh, so every mesh gets the (1, 1, 1) values;
    ``mesh`` only validates the config against it."""
    check_ported(cfg)
    if mesh is not None:
        _check_mesh_cfg(cfg, mesh)
        device = mesh.device
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


# The layer math below takes ``ranks``: 1 is the single-device form
# (decode, and the train step at tp = sp = 1); with ranks > 1, dim 0 of
# an activation holds ranks x batch rows and a weight leads with the
# ranks, one shard each.


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor,
            ranks: int) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` on each rank, batched over the ranks."""
    if ranks == 1:
        return torch.einsum(eq, x, w)
    a, rest = eq.split(",")
    b, out = rest.split("->")
    y = torch.einsum(f"r{a},r{b}->r{out}",
                     x.view(ranks, -1, *x.shape[1:]), w)
    return y.flatten(0, 1)


def _matmul(x: torch.Tensor, w: torch.Tensor, ranks: int) -> torch.Tensor:
    """``x @ w`` on each rank: one batched product of the ranks."""
    if ranks == 1:
        return torch.matmul(x, w)
    y = torch.matmul(x.view(ranks, -1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def _rms_norm(x: torch.Tensor, g: torch.Tensor,
              ranks: int = 1) -> torch.Tensor:
    """float32 RMS norm: ``x * rsqrt(mean(x^2) + 1e-6) * g``."""
    if ranks > 1:
        return _rms_norm(x.view(ranks, -1, x.shape[-1]),
                         g[:, None, :]).view(x.shape)
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * r) * g


def _project_qkv(h: torch.Tensor, lp: dict, cdt: torch.dtype,
                 ranks: int = 1):
    """(b, s, D) -> q (b, s, H, Dh), k/v (b, s, Hkv, Dh) in ``cdt``
    (per-shard head counts when tp-sharded). GQA K/V heads are repeated
    at attention time, not here."""
    if "wq" in lp:
        q = _einsum("bsd,dhe->bshe", h, lp["wq"].to(cdt), ranks)
        kv = _einsum("bsd,dthe->bsthe", h, lp["wkv"].to(cdt), ranks)
        return q, kv[:, :, 0], kv[:, :, 1]
    qkv = _einsum("bsd,dthe->bsthe", h, lp["wqkv"].to(cdt), ranks)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Repeat K/V heads to serve their query-head groups (GQA)."""
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _dense_ffn_block(x: torch.Tensor, lp: dict, cdt: torch.dtype,
                     reduce_out, ranks: int = 1) -> torch.Tensor:
    """Pre-norm dense-MLP sublayer; ``reduce_out`` closes the column/row
    tensor-parallel pair. GELU is the tanh approximation, the default of
    ``jax.nn.gelu`` (torch's default is the erf form)."""
    h2 = _rms_norm(x, lp["ln2"], ranks).to(cdt)
    u = F.gelu(_matmul(h2, lp["w1"].to(cdt), ranks), approximate="tanh")
    m = _matmul(u, lp["w2"].to(cdt), ranks)
    return x + reduce_out(m.to(x.dtype))


# ------------------------------------------------------------- train path


def _attn_pre(x, lp, cdt, ranks):
    """First half of the attention sublayer: pre-norm + QKV projection."""
    h = _rms_norm(x, lp["ln1"], ranks).to(cdt)
    return _project_qkv(h, lp, cdt, ranks)


def _attn_post(x, attn, lp, cdt, reduce_out, ranks):
    """Second half: output projection, tp reduction and residual add, in
    the residual dtype."""
    o = _einsum("bshe,hed->bsd", attn.to(cdt), lp["wo"].to(cdt), ranks)
    return x + reduce_out(o.to(x.dtype))


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
    if cfg.grad_dtype not in ("compute", "float32"):
        raise ValueError(f"unknown grad_dtype {cfg.grad_dtype!r} "
                         "(known: compute, float32)")


def _forward_local(params, tokens, cfg: TransformerConfig, mesh: ModelMesh,
                   head: str = "logits"):
    """The forward of one dp rank's tp x sp ranks (R of them), vectorised
    over them: int tokens ``(R b, s)`` (rank (t, r) holds rows ``[(t sp
    + r) b, ...)``, the batch rows of this dp rank and sequence block r)
    -> float32 logits ``(R b, s, V)`` (``V/tp`` under
    ``vocab_parallel``), or with ``head="hidden"`` the final normed
    hidden state ``(R b, s, D)`` in the compute dtype, which the fused
    head consumes. ``params`` are the ranks' shards (:func:`_enter`):
    with R > 1 each leaf's rank dim follows its layer dim. Activations
    are replicated over tp (each tp psum closes a column/row pair).

    ``save_stack="pallas"`` runs the whole layer stack through
    ``ops.stack_write.remat_scan_stacked`` (each layer's input saved in
    an explicit stack by the save-stack kernel, the layer rebuilt in the
    backward), whatever ``remat`` says, as JAX decides it before its
    remat branches. Otherwise ``remat``: False, ``"nothing"`` (each
    layer under checkpoint) or ``"except_attn"`` (the projection and the
    FFN checkpointed under the dots policy, attention outside, so the
    backward never re-runs the flash forward)."""
    from icikit_torch.models.attention.ring import ring_attention_shard
    from icikit_torch.models.attention.ulysses import \
        ulysses_attention_shard
    from icikit_torch.models.attention.zigzag import zigzag_attention_shard
    from icikit_torch.ops.flash_attention import resolve_attention_impl
    from icikit_torch.ops.rope import apply_rope

    cdt = DTYPES[cfg.compute_dtype]
    tp, sp = mesh.tp, mesh.sp
    ranks = tp * sp
    rb, s = tokens.shape
    b = rb // ranks
    dev = tokens.device
    tok = tokens.long()
    if ranks == 1:
        positions = torch.arange(s, device=dev)
        x = params["emb"][tok]
    else:
        # rank (t, r) holds this shard's global positions r s + [0, s)
        start = torch.arange(sp, device=dev).repeat(tp) * s
        pos_r = start[:, None] + torch.arange(s, device=dev)   # (R, s)
        positions = pos_r.repeat_interleave(b, dim=0)         # (R b, s)
        emb = params["emb"]
        offs = (torch.arange(ranks, device=dev)
                * emb.shape[1]).repeat_interleave(b)[:, None]
        x = emb.reshape(-1, emb.shape[-1])[tok + offs]
    if cfg.pos_encoding == "learned":
        pos = params["pos"]
        if ranks == 1:
            x = x + pos[:s]
        else:
            rows = pos.gather(1, pos_r[..., None].expand(-1, -1,
                                                         pos.shape[-1]))
            x = (x.view(ranks, b, s, -1) + rows[:, None]).view(rb, s, -1)
    x = x.to(cdt)
    n_rep = _n_rep(cfg)

    def psum_tp(v):
        if tp == 1:
            return v
        return psum(v.view(tp, -1, *v.shape[1:]), mesh, TP_AXIS).view(
            v.shape)

    def sp_blocks(v):      # (R b, s, ...) -> (sp, tp b, s, ...)
        return v.view(tp, sp, b, *v.shape[1:]).movedim(1, 0).reshape(
            sp, tp * b, *v.shape[1:])

    # positions rides as an argument, as in JAX, where the save stack's
    # custom-vjp boundary needs it so
    def attention(q, k, v, positions):
        if cfg.pos_encoding == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if sp == 1:   # the full sequence is local: the fused kernel
            k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
            if (cfg.attention_impl == "flash"
                    and cfg.softmax_shift is not None):
                return resolve_attention_impl("flash")(
                    q, k, v, causal=True, softmax_shift=cfg.softmax_shift)
            return resolve_attention_impl(cfg.attention_impl)(
                q, k, v, causal=True)
        qb, kb, vb = sp_blocks(q), sp_blocks(k), sp_blocks(v)
        if cfg.sequence_schedule == "ulysses":
            out = ulysses_attention_shard(
                qb, kb, vb, mesh.axis_mesh(SP_AXIS), SP_AXIS, causal=True,
                scale=None, algorithm=cfg.sp_algorithm,
                local=cfg.attention_impl)
        elif cfg.sequence_schedule == "zigzag":
            # ring and zigzag rotate the un-repeated K/V blocks (GQA
            # shrinks each ring message by n_rep)
            out = zigzag_attention_shard(qb, kb, vb, sp, True, None)
        else:
            out = ring_attention_shard(qb, kb, vb, sp, True, None)
        return out.view(sp, tp, b, *out.shape[2:]).movedim(0, 1).reshape(
            rb, *out.shape[2:])

    def ffn(x, lp):
        return _dense_ffn_block(x, lp, cdt, psum_tp, ranks)

    def layer(x, lp, positions):
        q, k, v = _attn_pre(x, lp, cdt, ranks)
        return ffn(_attn_post(x, attention(q, k, v, positions), lp, cdt,
                              psum_tp, ranks), lp)

    def pre(x, lp):
        return _attn_pre(x, lp, cdt, ranks)

    def post(x, attn, lp):
        return ffn(_attn_post(x, attn, lp, cdt, psum_tp, ranks), lp)

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
    x = _rms_norm(x, params["ln_f"], ranks).to(cdt)
    if head == "hidden":
        return x
    return _einsum("bsd,vd->bsv", x, params["w_out"].to(cdt), ranks).float()


def _vocab_parallel_nll(logits, targets, mesh: ModelMesh):
    """Token NLL from vocab-sharded logits ``(R b, s, V/tp)`` (rows as
    in :func:`_forward_local`): the Megatron head. The max (a stability
    shift outside autograd, whose gradient cancels) and the log-sum-exp
    reduce over tp; the rank owning each target id contributes its logit
    through a masked psum."""
    tp, sp = mesh.tp, mesh.sp
    rb, s, v_loc = logits.shape

    def over_tp(f, v):      # (R b, s) -> (tp, sp b, s), f, back
        return f(v.view(tp, -1, s), mesh, TP_AXIS).view(rb, s)

    m = over_tp(pmax, logits.max(dim=-1).values)
    z = over_tp(psum, torch.exp(logits - m[..., None]).sum(-1))
    r_tp = torch.arange(tp, device=logits.device).repeat_interleave(
        rb // tp)[:, None]
    loc = targets.long() - r_tp * v_loc
    own = (loc >= 0) & (loc < v_loc)
    tl = logits.gather(-1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt_logit = over_tp(psum, torch.where(own, tl, torch.zeros_like(tl)))
    return m + torch.log(z) - tgt_logit


def _use_fused_head(cfg: TransformerConfig, b: int, s: int) -> bool:
    """Does the fused head take a rank's ``(b, s)`` tokens? JAX's gate on
    the local T = b s (never under ``vocab_parallel``, whose
    distributed head runs the unfused logits)."""
    if not cfg.fused_head or cfg.vocab_parallel:
        return False
    from icikit_torch.ops.xent import xent_supported
    return xent_supported(b * s, cfg.d_model, cfg.vocab,
                          DTYPES[cfg.compute_dtype])


def _local_loss(params, tokens, targets, cfg: TransformerConfig,
                mesh: ModelMesh, denom: int) -> torch.Tensor:
    """The per-rank losses ``(R,)`` of one dp rank's tp x sp ranks: each
    rank's token cross-entropy summed over the global token count
    ``denom``. The fused head (``fused_xent``, one call a rank with that
    rank's copy of ``w_out``) where its gate takes a rank's tokens, else
    float32 logits and ``log_softmax`` (or the vocab-parallel head).
    MoE is not ported, so its aux term is 0."""
    ranks = mesh.tp * mesh.sp
    rb, s = tokens.shape
    b = rb // ranks
    if _use_fused_head(cfg, b, s):
        from icikit_torch.ops.xent import fused_xent

        def head(h, w, t):
            return fused_xent(h.reshape(b * s, cfg.d_model), w,
                              t.reshape(b * s), save_exp=cfg.xent_save_exp,
                              fused_bwd=cfg.xent_fused_bwd)

        h = _forward_local(params, tokens, cfg, mesh, head="hidden")
        w = params["w_out"].to(h.dtype)
        if ranks == 1:
            nll = head(h, w, targets)
        else:
            nll = torch.stack([head(*a) for a in zip(
                h.view(ranks, b, s, -1).unbind(0), w.unbind(0),
                targets.view(ranks, b, s).unbind(0))])
    else:
        logits = _forward_local(params, tokens, cfg, mesh)
        if cfg.vocab_parallel:
            nll = _vocab_parallel_nll(logits, targets, mesh)
        else:
            logp = F.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if ranks == 1:
        loss = (nll.sum() / denom).reshape(1)
    else:
        loss = nll.reshape(ranks, -1).sum(1) / denom
    if cfg.vocab_parallel and mesh.tp > 1:
        # every tp rank holds the same value; the psum mirrors JAX's,
        # which makes the replication explicit
        loss = psum(loss.view(mesh.tp, -1), mesh, TP_AXIS).view(-1) / mesh.tp
    return loss


def _enter(leaf: torch.Tensor, tp_dim, layered: bool,
           mesh: ModelMesh) -> torch.Tensor:
    """A global leaf as its ranks see it: ``(dp_l, [L,] [R,] *shard)``
    with dp_l this process's dp ranks and R = tp sp (no R dim when R is
    1). A leaf sharded over tp (``tp_dim``) splits into contiguous
    blocks, one a tp rank; ``pvary`` copies it to the ranks of every
    axis it is replicated on, and its backward is their psum."""
    at = 1 if layered else 0
    tp, sp = mesh.tp, mesh.sp
    if tp_dim is not None and tp > 1:
        x = leaf.unflatten(tp_dim, (tp, -1)).movedim(tp_dim, at)
        axes = {DP_AXIS: 0, SP_AXIS: at + 2}
    else:
        x = leaf.unsqueeze(at)
        axes = {DP_AXIS: 0, TP_AXIS: at + 1, SP_AXIS: at + 2}
    x = pvary(x.unsqueeze(at + 1).unsqueeze(0), mesh, axes)
    if tp * sp == 1:
        return x.squeeze(at + 2).squeeze(at + 1)
    return x.flatten(at + 1, at + 2)


def _rank_rows(x: torch.Tensor, mesh: ModelMesh) -> tuple:
    """This process's ``(B, S)`` rows of tokens, sharded ``P(dp, sp)``:
    one ``(R b, s)`` tensor a local dp rank, its tp x sp ranks' rows as
    :func:`_forward_local` reads them."""
    dp_l, tp, sp = mesh.local_size(DP_AXIS), mesh.tp, mesh.sp
    big_b, big_s = x.shape
    if big_b % dp_l or big_s % sp:
        raise ValueError(f"tokens {tuple(x.shape)} do not shard over "
                         f"{dp_l} dp ranks here and sp={sp}")
    b, s = big_b // dp_l, big_s // sp
    x = x.reshape(dp_l, b, sp, s).permute(0, 2, 1, 3).unsqueeze(1)
    return x.expand(dp_l, tp, sp, b, s).reshape(dp_l, -1, s).unbind(0)


def _global_loss(losses: list, mesh: ModelMesh) -> torch.Tensor:
    """The loss every rank holds: the per-rank losses psummed over sp,
    then dp (the dp sum crossing processes last)."""
    x = torch.stack([l.detach() for l in losses]).view(
        len(losses), mesh.tp, mesh.sp)
    x = psum(psum(x, mesh, SP_AXIS, 2), mesh, DP_AXIS, 0)
    return x[0, 0, 0]


def loss_and_metrics(params: dict, tokens, targets, mesh: ModelMesh,
                     cfg: TransformerConfig, draft_tokens=None,
                     draft_p0: int = 0):
    """Mean token cross-entropy over the global batch, its gradient dict
    (one leaf per floating parameter, in the leaf's dtype) and the
    metric dict (empty: the draft head is not ported). ``tokens`` /
    ``targets``: integer ``(B, S)`` on the mesh's device, sharded as
    JAX's ``P(dp, sp)``; across processes, this process's rows of the
    batch (its dp ranks').

    Each dp rank's program runs on its copies of the leaves; the
    objective differentiated is the sum of every rank's loss over tp
    (the tp replicas hold the same value), so each leaf's gradient is
    its pvary's psum of the ranks' cotangents."""
    check_train_ported(cfg)
    _check_mesh_cfg(cfg, mesh)
    if draft_tokens is not None:
        raise NotImplementedError(
            "draft_tokens (on-policy draft distillation) needs the draft "
            "head, which is not ported yet (it comes with speculative "
            "decode)")
    dev = torch.device(mesh.device)
    specs = param_specs(cfg)
    layered = set(_layer_keys(cfg))
    leaves = {k: v.detach().requires_grad_(torch.is_floating_point(v))
              for k, v in params.items()}
    with torch.enable_grad():
        entered = {k: _enter(v, specs[k], k in layered, mesh).unbind(0)
                   for k, v in leaves.items()}
        rows = zip(_rank_rows(tokens.to(dev), mesh),
                   _rank_rows(targets.to(dev), mesh))
        b = tokens.shape[0] // mesh.local_size(DP_AXIS)
        denom = b * tokens.shape[1] * mesh.dp
        losses = [_local_loss({k: v[d] for k, v in entered.items()}, tok,
                              tgt, cfg, mesh, denom)
                  for d, (tok, tgt) in enumerate(rows)]
        objective = losses[0].sum()
        for l in losses[1:]:
            objective = objective + l.sum()
        if mesh.tp > 1:
            objective = objective / mesh.tp
        names = [k for k, v in leaves.items() if v.requires_grad]
        grads = torch.autograd.grad(objective, [leaves[k] for k in names])
    return _global_loss(losses, mesh), dict(zip(names, grads)), {}


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


# the corruption site of the checked gradient sync, JAX's name
GRAD_SYNC_SITE = "collective.train.grad_sync"
chaos.register_site(GRAD_SYNC_SITE)


def grad_sync_n_steps(mesh) -> int:
    """Exchange steps of the ``grad_check="ring"`` digest ring: the
    ``n_steps`` a ``chaos.traced_corrupt_spec(GRAD_SYNC_SITE, ...)``
    drill targets (its ``p`` is dp)."""
    return mesh.shape[DP_AXIS] - 1


def _rank_shards(g: torch.Tensor, tp_dim, mesh: ModelMesh) -> torch.Tensor:
    """Each local rank's shard of a global gradient leaf, ``(dp_l, tp,
    sp, *shard)`` (a view: the ranks of a replicated axis share it)."""
    tp, sp = mesh.tp, mesh.sp
    if tp_dim is not None and tp > 1:
        x = g.unflatten(tp_dim, (tp, -1)).movedim(tp_dim, 0)
    else:
        x = g.unsqueeze(0).expand(tp, *g.shape)
    return x.unsqueeze(1).unsqueeze(0).expand(
        mesh.local_size(DP_AXIS), tp, sp, *x.shape[1:])


def _make_grad_sync_check(mesh: ModelMesh, cfg: TransformerConfig):
    """JAX's checked-collective verdict over the step's gradient sync
    (``icikit/models/transformer/model.py:1084-1165``), rank-vectorised.

    Each rank folds its shards of the dp-reduced gradient leaves (one
    explicit psum over dp, the bytes every replica commits) into one
    digest (``transport.segment_checksum``, the fold I1 on the card) and
    the digests circulate over dp on the checked transport: every hop is
    checksummed, so an in-flight flip (the
    ``corrupt:collective.train.grad_sync`` drill) fails the verdict, and
    so does a replica whose digest differs from what reaches it. What it
    cannot see is JAX's too: a corruption inside the sync that every
    replica receives alike. Returns ``(check(grads, taint) -> ok bool
    scalar, n_exchange_steps)``."""
    from icikit_torch.ops.cuda_integrity import segment_checksum
    from icikit_torch.parallel import transport
    from icikit_torch.parallel.shmap import shift_perm

    require_single_process(mesh, "grad_check='ring' (checked mode)")
    specs = param_specs(cfg)
    keys = tuple(sorted(specs))   # every ported leaf is dp-replicated
    dp = mesh.dp
    n_steps = grad_sync_n_steps(mesh)

    def check(grads: dict, taint) -> torch.Tensor:
        dig = None
        for k in keys:
            if not torch.is_floating_point(grads[k]):
                continue
            x = psum(_rank_shards(grads[k], specs[k], mesh), mesh, DP_AXIS)
            cs = segment_checksum(x.reshape(mesh.size, -1))
            dig = cs if dig is None else dig ^ cs
        dig = dig.view(dp, -1)
        tracker = transport.Tracker(DP_AXIS, taint)
        equal = torch.ones((), dtype=torch.bool, device=dig.device)
        with transport.checked(tracker):
            cur = dig
            for _ in range(n_steps):
                cur = transport.ppermute(cur, shift_perm(dp, 1))
                equal = equal & (cur == dig).all()
        return tracker.verdict(dp, dig.device).all() & equal

    return check, n_steps


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
    the update.

    ``grad_check="ring"`` (with ``guard="device"``) absorbs the checked
    gradient-sync verdict (:func:`_make_grad_sync_check`) into ``ok``:
    the step takes a trailing ``sync_taint``, ``chaos.
    traced_corrupt_spec(GRAD_SYNC_SITE, grad_sync_n_steps(mesh), dp)``
    for a drill, ``chaos.TAINT_OFF`` (or None) for none. Without the
    ring the taint is ignored, as in JAX."""
    if guard not in ("none", "device"):
        raise ValueError(f"unknown guard {guard!r} (known: none, device)")
    if grad_check not in ("none", "ring"):
        raise ValueError(f"unknown grad_check {grad_check!r} "
                         "(known: none, ring)")
    if grad_check != "none" and guard != "device":
        raise ValueError(
            "grad_check needs guard='device': the verdict is absorbed "
            "through the on-device where(ok, new, old) select")
    check_train_ported(cfg)
    _check_mesh_cfg(cfg, mesh)
    sync_check = (_make_grad_sync_check(mesh, cfg)[0]
                  if grad_check == "ring" else None)
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
        loss, grads, _ = loss_and_metrics(narrow(params), tokens, targets,
                                          mesh, cfg, draft_tokens,
                                          draft_p0)
        m, v, t = opt_state
        t_next = t + 1
        lr = opt.lr(t_next) if callable(opt.lr) else opt.lr
        ok = _grads_finite(loss, grads) if guard == "device" else None
        if sync_check is not None:
            ok = ok & sync_check(grads, chaos.TAINT_OFF if sync_taint is None
                                 else sync_taint)
        adam_apply(params, m, v, grads, lr, t_next, opt.b1, opt.b2,
                   opt.eps, use_pallas=opt.use_pallas, ok=ok)
        t.copy_(t_next if ok is None else torch.where(ok, t_next, t))
        if guard == "device":
            return params, (m, v, t), loss, ok
        return params, (m, v, t), loss

    return optimizer, step
