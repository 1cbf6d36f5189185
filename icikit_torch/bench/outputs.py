"""Where the port's study CLIs may write.

The JAX package's studies keep their records at the repo root
(``SCALING.md``, ``SORTSCALING.md``, ``scaling.jsonl``,
``sort_scaling.jsonl``, ``crossover.jsonl``) and their figures under
``docs/figs/``. The port's twins write files of their own
(``SCALING_TORCH.md``, ``scaling_torch.jsonl``, ``docs/figs_torch/``
and so on) and refuse a path that names one of JAX's, so a run on the
card never overwrites the reference's measurements.
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
JAX_RECORDS = ("SCALING.md", "SORTSCALING.md", "scaling.jsonl",
               "sort_scaling.jsonl", "crossover.jsonl")
JAX_FIGS = Path("docs") / "figs"


def check_output(path) -> None:
    """Raise ``ValueError`` when ``path`` is one of the JAX package's
    records or lies in its figure directory."""
    p = Path(os.path.abspath(path))
    if p.parent == _REPO_ROOT and p.name in JAX_RECORDS:
        raise ValueError(f"{path} holds the JAX package's records; the "
                         "port writes its own files")
    figs = _REPO_ROOT / JAX_FIGS
    if p == figs or figs in p.parents:
        raise ValueError(f"{path} is the JAX package's figure directory; "
                         "the port writes docs/figs_torch/")
