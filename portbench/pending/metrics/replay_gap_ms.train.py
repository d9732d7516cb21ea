"""The device's idle milliseconds in the traced epoch's gaps that end at a
graph replay's kernel, outside ``cs744.tail_step``: the gaps between the
kernels of the replayed step (``partition``), averaged over the ranks.
Read under the profiler, which lengthens these gaps.  Nothing to read
where the program has no such ranges."""

LAYER = "window (train/step.py TrainWindow, GraphStep)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    if not all(t.get("ranges") for t in ctx.traces):
        return None
    return sum(t["partition"]["replay"] for t in ctx.traces) \
        / len(ctx.traces) / 1e3
