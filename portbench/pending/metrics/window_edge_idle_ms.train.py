"""The device's idle milliseconds at the traced epoch's window edges: every
gap inside the epoch that is neither under ``cs744.tail_step`` nor ended
by a graph replay's kernel (the staging, the window's fills, its fetch's
copy, the host's work after it; ``partition``), averaged over the ranks.
Read under the profiler, which lengthens the edges.  Nothing to read
where the program has no such ranges."""

LAYER = "host loop (train/loop.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    if not all(t.get("ranges") for t in ctx.traces):
        return None
    return sum(t["partition"]["window_edge"] for t in ctx.traces) \
        / len(ctx.traces) / 1e3
