"""Model presets and parameter counts (copies of ``icikit.bench.train``'s
``PRESETS`` and ``matmul_param_count``); the train bench itself comes
with the train slice."""

from __future__ import annotations

PRESETS = {
    "tiny": dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=512,
                 n_layers=2, max_seq=128),
    # tiny at the fused decode step's head width (d_head 128)
    "tiny128": dict(vocab=256, d_model=128, n_heads=2, d_head=128,
                    d_ff=512, n_layers=2, max_seq=128),
    "small": dict(vocab=32768, d_model=512, n_heads=4, d_head=128,
                  d_ff=2048, n_layers=8, max_seq=1024),
    "base": dict(vocab=32768, d_model=1024, n_heads=8, d_head=128,
                 d_ff=4096, n_layers=12, max_seq=1024),
}


def matmul_param_count(cfg) -> int:
    """Matmul parameters: per layer q, k, v, o and the two MLP
    matrices, plus the head and the embedding."""
    kv_heads = cfg.n_kv_heads or cfg.n_heads
    per_layer = (cfg.d_model * cfg.n_heads * cfg.d_head       # q proj
                 + 2 * cfg.d_model * kv_heads * cfg.d_head    # k, v proj
                 + cfg.n_heads * cfg.d_head * cfg.d_model     # wo
                 + 2 * cfg.d_model * cfg.d_ff)                # w1, w2
    return (cfg.n_layers * per_layer
            + cfg.d_model * cfg.vocab                         # head
            + cfg.vocab * cfg.d_model)                        # embedding
