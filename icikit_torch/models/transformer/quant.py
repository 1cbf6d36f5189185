"""Decode-path weight quantization: the int8 parameter dict.

The port of ``icikit/models/transformer/quant.py``.
``quantize_decode_params`` derives, once per generate call or once by
the caller, the dict the int8 decode path reads
(``cfg.decode_quant = "int8"``):

- every decode matmul weight is re-laid-out output-channels first,
  contraction last, and quantized per channel (``ops/quant.
  quantize_last``), its float32 scale stored under ``<name>_s``;
- the other leaves (embedding, norm scales, positional table) stay
  float32;
- the contraction is last in every layout, so one product
  (``ops/quant.qmm``) serves the unembedding and every projection, and
  the per-layer scales stack on dim 0 like their weights.

Layouts (fp leaf -> int8 leaf + scale):

====== ======================= ======================= ==============
leaf   fp layout               int8 layout             scale
====== ======================= ======================= ==============
wqkv   (L, D, 3, H, Dh)        (L, 3, H, Dh, D)        (L, 3, H, Dh)
wq     (L, D, H, Dh)           (L, H, Dh, D)           (L, H, Dh)
wkv    (L, D, 2, Hkv, Dh)      (L, 2, Hkv, Dh, D)      (L, 2, Hkv, Dh)
wo     (L, H, Dh, D)           (L, D, H, Dh)           (L, D)
w1     (L, D, F)               (L, F, D)               (L, F)
w2     (L, F, D)               (L, D, F)               (L, D)
w_out  (V, D)                  (V, D)  (unchanged)     (V,)
====== ======================= ======================= ==============

On the model mesh every int8 leaf shards over tp as its fp leaf does
(``quant_param_specs``, in ``model.param_specs``' form: the dim of each
leaf that shards over tp, or None): the fp leaf's tp dim moved with the
layout's transpose, and each scale with its channel dim. The scales of
``wo`` and ``w2`` are replicated: tp splits their contraction, and the
tp psum after the product closes the partial sums, each already scaled
per full output channel. ``w_out`` and its scale shard over tp only
under ``vocab_parallel``. The leaves are quantized whole, before they
are sharded, so a shard's scales are the (1, 1, 1) scales.

The teacher-forced parity metric (``measure_top1_agreement``,
``_build_forced``) waits for speculative decode's window pass (ROADMAP
A9).
"""

from __future__ import annotations

from icikit_torch.models.transformer.model import (TransformerConfig,
                                                   _check_mesh_cfg,
                                                   _layer_keys,
                                                   param_specs)
from icikit_torch.ops.quant import quantize_last

SCALE_SUFFIX = "_s"

# fp leaf -> (permutation bringing the contraction dim(s) last, k_ndim)
_LAYOUTS = {
    "wqkv": ((0, 2, 3, 4, 1), 1),
    "wq": ((0, 2, 3, 1), 1),
    "wkv": ((0, 2, 3, 4, 1), 1),
    "wo": ((0, 3, 1, 2), 2),        # contraction = (H, Dh)
    "w1": ((0, 2, 1), 1),
    "w2": ((0, 2, 1), 1),
    "w_out": (None, 1),             # already (V, D)
    "draft_out": (None, 1),
}


def quant_weight_keys(cfg: TransformerConfig) -> tuple:
    """The parameter leaves the int8 decode path stores quantized."""
    keys = [k for k in _layer_keys(cfg) if k in _LAYOUTS]
    keys.append("w_out")
    if cfg.draft_head and not cfg.draft_tied:
        keys.append("draft_out")
    return tuple(keys)


def is_quantized_params(params) -> bool:
    """True when ``params`` is already the quantized dict."""
    return ("w_out" + SCALE_SUFFIX) in params


def quantize_decode_params(params: dict, cfg: TransformerConfig,
                           mesh=None) -> dict:
    """fp params -> the int8 decode dict (int8 leaves and ``_s`` scales,
    the other leaves passed through), on the leaves' device. Each leaf
    is quantized whole; with ``mesh``, the config is checked against it
    and each rank later sees its shard by :func:`quant_param_specs`."""
    if mesh is not None:
        _check_mesh_cfg(cfg, mesh)
    if cfg.decode_quant != "int8":
        raise ValueError("quantize_decode_params needs a config with "
                         f"decode_quant='int8', got {cfg.decode_quant!r}")
    if is_quantized_params(params):
        return params
    out = dict(params)
    for k in quant_weight_keys(cfg):
        perm, k_ndim = _LAYOUTS[k]
        w = params[k]
        if perm is not None:
            w = w.permute(perm)
        if k_ndim > 1:
            # a multi-axis contraction (wo's (H, Dh)): one scale per
            # output channel, over the flattened contraction
            q, s = quantize_last(w.reshape(*w.shape[:-k_ndim], -1))
            q = q.reshape(w.shape)
        else:
            q, s = quantize_last(w)
        out[k] = q.contiguous()
        out[k + SCALE_SUFFIX] = s.contiguous()
    return out


def quant_param_specs(cfg: TransformerConfig) -> dict:
    """The tp dim of every leaf of the int8 dict (None: replicated), in
    ``model.param_specs``' form: an int8 leaf's is its fp leaf's dim
    moved with the layout's transpose; a scale shards on that dim when
    it is an output channel dim and is replicated when it lies in the
    contraction."""
    specs = dict(param_specs(cfg))
    for k in quant_weight_keys(cfg):
        perm, k_ndim = _LAYOUTS[k]
        fp_dim = specs[k] if k != "draft_out" else specs["w_out"]
        dim = (fp_dim if fp_dim is None or perm is None
               else perm.index(fp_dim))
        ndim = len(perm) if perm is not None else 2
        specs[k] = dim
        specs[k + SCALE_SUFFIX] = (dim if dim is not None
                                   and dim < ndim - k_ndim else None)
    return specs


def decode_param_specs(cfg: TransformerConfig) -> dict:
    """The specs the decode path shards its leaves by: the int8 dict's
    when ``decode_quant="int8"``, the fp leaves' otherwise."""
    return (quant_param_specs(cfg) if cfg.decode_quant == "int8"
            else param_specs(cfg))


def quant_layer_keys(cfg: TransformerConfig) -> tuple:
    """Per-layer keys the quantized decode layers read: the fp layer
    keys plus the stacked scale leaves."""
    base = _layer_keys(cfg)
    return base + tuple(k + SCALE_SUFFIX for k in base if k in _LAYOUTS)
