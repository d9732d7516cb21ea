"""The device's idle milliseconds in the traced epoch's eager tail step:
the gaps under the program's ``cs744.tail_step`` range (``partition``),
averaged over the ranks.  Read under the profiler, which lengthens the
tail.  Nothing to read where the program has no such ranges."""

LAYER = "host loop (train/loop.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    if not all(t.get("ranges") for t in ctx.traces):
        return None
    return sum(t["partition"]["tail"] for t in ctx.traces) \
        / len(ctx.traces) / 1e3
