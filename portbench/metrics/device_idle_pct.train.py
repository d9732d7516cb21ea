"""The device's idle share of the traced epoch: 100 - the union of its
kernel intervals over the epoch's wall time, averaged over the ranks."""

LAYER = "device (H100)"
UNIT = "%"
BETTER = "lower"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    busy = sum(t["busy_us"] for t in ctx.traces)
    wall = sum(t["wall_us"] for t in ctx.traces)
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
