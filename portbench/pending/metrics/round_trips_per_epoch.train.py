"""Rank 0's device-to-host round trips over the traced epoch
(``Trainer.trace_counts()["host_round_trips"]``): one a window and one
for the tail.  Nothing to read where the program has no such count."""

LAYER = "host loop (train/loop.py)"
UNIT = "count"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    counts = ctx.trace.get("trace_counts")
    if counts is None:
        return None
    return float(counts["host_round_trips"])
