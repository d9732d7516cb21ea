"""The whole step's share of the card's bf16 peak for a model with routed
experts: sequences a second a chip in the measured window x the FLOPs a
sequence, the routed experts' part counted from the rows they were given.

FLOPs a sequence = 6 x (the architecture plug-in's MACs a sequence without
the routed experts, ``macs_per_example_unrouted``) + 6 x the plug-in's
MACs of one held expert's SwiGLU on one row (``routed_macs_per_row``) x
the held rows a step (``counters["moe"]["rows"]`` over the traced epoch's
steps: every expert layer's forward counts its held rows once) / the
sequences a step.  The rows are what the router gave the held experts, not
the mean load; the program's recomputation in the backward is not
counted.  Nothing to read without the program's expert counters or a
plug-in with those costs."""

from portbench import plugins, yardstick

LAYER = "whole step (train/step.py make_step_body)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_images_per_s"
SOURCE = "host_clock"


def read(ctx):
    rows = ctx.trace["counters"].get("moe", {}).get("rows", 0)
    arch = plugins.architecture(ctx.config, ctx.root)
    if rows <= 0 or not hasattr(arch, "routed_macs_per_row"):
        return None
    per_step = ctx.traffic["global_batch"] // ctx.traffic["world"]
    macs = arch.macs_per_example_unrouted(ctx.config, ctx.traffic) \
        + arch.routed_macs_per_row(ctx.config) * rows / ctx.steps / per_step
    return 100.0 * (ctx.images_per_s / ctx.chips) * 6 * macs \
        / yardstick.H100_BF16_PEAK_FLOPS
