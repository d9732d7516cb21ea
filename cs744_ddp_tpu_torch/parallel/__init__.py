"""Data parallelism over ``torch.distributed``: the process group and its
counted collectives (``mesh``), gradient bucketing (``bucketing``) and the
gradient-sync strategies (``strategies``)."""

from . import bucketing, mesh, strategies
from .mesh import Group, initialize_distributed
from .strategies import STRATEGIES, get_strategy

__all__ = ["Group", "STRATEGIES", "bucketing", "get_strategy",
           "initialize_distributed", "mesh", "strategies"]
