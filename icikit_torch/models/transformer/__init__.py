"""Decoder transformer — the port of ``icikit.models.transformer``.

Ported so far: the configuration, parameter init and the greedy decode
path (``greedy_generate``) on one device, through the flash forward and
fused decode-step kernels. Training, MoE, pipelines, sampled,
speculative and int8 decode come in later slices.
"""

from icikit_torch.models.transformer.decode import (  # noqa: F401
    greedy_generate,
    sample_generate,
)
from icikit_torch.models.transformer.model import (  # noqa: F401
    TransformerConfig,
    init_params,
    make_model_mesh,
)
