"""Static analysis of the port: its sources and its programs.

- ``costmodel``   — analytic FLOPs/HBM/wire bytes of a program, counted
                   from the aten operators one call dispatches on meta
                   tensors (``CountingGroup`` for the collectives).
- ``stats``       — the collective-accounting API (``collective_stats``,
                   ``collective_chain_depth``, ``bytes_of_type``) over a
                   step's link record (``parallel.mesh.Group.step_links``).
- ``memlife``     — peak live bytes of one call on meta tensors, the
                   in-place state (the port's donation) proven in bytes.
- ``audit``       — a rule engine certifying each program the port
                   dispatches (collective contract per strategy, dtype
                   leaks, in-place state, peak memory, host syncs, baked
                   constants, the uint8 ingest edge), wired into ``cli.py
                   --audit``/``--audit-zoo``/``--verify-static`` and the
                   telemetry manifest.
- ``dispatch``    — static host-round-trip certifier: closed-form
                   per-epoch bounds from the window structure, pinned
                   EXACTLY against the Trainer's ``host_round_trips``.
- ``megaplan``    — K-epoch feasibility planner on the H100's budget.
- ``pylint_rules`` — AST lint for repo invariants the runtime can't see
                   (unfenced timing, device work on threads, lock
                   ownership, span hygiene).
- ``lockgraph``   — whole-package lock-order deadlock detector.
- ``wire_schema`` — wire-protocol schema conformance against
                   ``serve/wire.py``.
- ``lint``        — the entry: ``python -m cs744_ddp_tpu_torch.analysis.lint``.

No counterpart: the reference's ``hlo_ir`` (an HLO parser) and
``utils/hlo_stats.py``, since nothing the port runs produces HLO text.
"""

from .stats import bytes_of_type, collective_chain_depth, collective_stats

__all__ = ["bytes_of_type", "collective_chain_depth", "collective_stats"]
