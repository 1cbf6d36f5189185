"""Decoder transformer — the port of ``icikit.models.transformer``.

Ported so far, on one device: the configuration, parameter init, the
greedy decode path (``greedy_generate``, through the flash forward and
fused decode-step kernels) and the train step (``loss_fn``,
``make_train_step`` with ``FusedAdam``, through the flash forward and
backward and the fused cross-entropy head kernels). MoE, pipelines,
sampled, speculative and int8 decode come in later slices.
"""

from icikit_torch.models.transformer.decode import (  # noqa: F401
    greedy_generate,
    sample_generate,
)
from icikit_torch.models.transformer.model import (  # noqa: F401
    FusedAdam,
    TransformerConfig,
    init_params,
    loss_and_metrics,
    loss_fn,
    make_model_mesh,
    make_train_step,
)
