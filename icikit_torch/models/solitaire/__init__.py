"""Peg-solitaire dynamic-load-balancing study (reference
``Dynamic-Load-Balancing/``, SURVEY.md C21-C25), on the card.

The port of ``icikit.models.solitaire``. The reference pairs a serial
exponential-cost DFS puzzle solver with an MPI master/worker task farm;
the variable per-puzzle cost is the load imbalance the farm exists to
absorb. Here:

- boards are uint32 bitmasks, and a batch's DFS is one launch of a CUDA
  kernel, one thread a board (``game.py``, ``csrc/solitaire.cu``);
- scheduling happens at the *batch* level: static equal chunks per
  worker vs. a dynamic host-side work queue feeding workers as they
  drain (``scheduler.py``), a worker being a CUDA stream of the card —
  the pull-model master/worker protocol
  (``Dynamic-Load-Balancing/src/main.cc:83-193``);
- datasets use the reference's on-disk format (count line + 25-char
  board rows) with difficulty-graded generators (``dataset.py``).
"""

from icikit_torch.models.solitaire.game import (  # noqa: F401
    BoardBatch,
    parse_board,
    render_board,
    pretty_board,
    render_solution,
    solve_batch,
    solve_one_py,
    replay_moves,
)
from icikit_torch.models.solitaire.dataset import (  # noqa: F401
    load_dataset,
    save_dataset,
    generate_dataset,
)
from icikit_torch.models.solitaire.scheduler import (  # noqa: F401
    solve_static,
    solve_dynamic,
    solve_host,
    SolveReport,
)
