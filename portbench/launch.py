"""What the process that launches a run needs before it may import torch:
the check for cards, the check for forbidden modules, and the entry of a
spawned rank.  A multi-chip run starts its rank processes first and
imports torch only after they have sent their results, so that its own
import does not delay theirs."""

from __future__ import annotations

import sys
from typing import List

# Top-level module names a run may not have loaded once its window has
# closed: JAX, its parts, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "cs744_ddp_tpu")


class NoCard(RuntimeError):
    """The host has fewer CUDA devices than the cell's ranks."""


def check_cards(world: int) -> None:
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < world:
        raise NoCard(f"the cell needs {world} CUDA device(s); this host "
                     f"has {have}: no result")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def rank_entry(*args) -> None:
    """A spawned rank's target: ``worker.rank_main``, imported in the
    rank's own process."""
    from .worker import rank_main
    rank_main(*args)
