"""Faults planted in the program, for the calibration of the limits
(``calibrate.py``) and the tests that see ``correct`` come out false.
Never used by a benchmark run.

Each is a context manager that replaces one function of the program for
as long as it is open; build the Trainer inside it.

  * ``unchanged_state``: the SGD update does nothing, so every step
    returns the state it was given;
  * ``half_batch``: the step trains the first half of its rows, the
    loss their mean;
  * ``no_exchange``: the bucketed all-reduce of ``ddp`` returns each
    rank's own gradients (the exchange between chips left out);
  * ``altered_answer``: the loss a step reports is off by one.
"""

from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def _patched(module, name: str, fn) -> Iterator[None]:
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def unchanged_state():
    from cs744_ddp_tpu_torch.ops import sgd
    return _patched(sgd, "update", lambda orig: lambda *a, **k: None)


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    from cs744_ddp_tpu_torch.train import step

    def prepare(orig):
        def fn(images, *a, **k):
            return orig(images[:images.shape[0] // 2], *a, **k)
        return fn

    def cross_entropy(orig):
        return lambda logits, labels: orig(logits,
                                           labels[:logits.shape[0]])

    with _patched(step, "prepare", prepare), \
            _patched(step, "cross_entropy", cross_entropy):
        yield


def no_exchange():
    from cs744_ddp_tpu_torch.parallel import strategies
    return _patched(strategies, "bucketed_psum",
                    lambda orig: lambda grads, group, **k: list(grads))


def altered_answer():
    from cs744_ddp_tpu_torch.train import step
    return _patched(step, "cross_entropy",
                    lambda orig: lambda logits, labels:
                    orig(logits, labels) + 1.0)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_answer": altered_answer}


def faulty_rank_main(fault: str, *args) -> None:
    """``launch.rank_entry`` with ``fault`` planted in its process: a
    spawned rank's target for the tests of a multi-chip cell."""
    from .launch import rank_entry
    with FAULTS[fault]():
        rank_entry(*args)
