"""The whole step's share of the card's peak: examples a second a chip in
the measured window x the model's FLOPs an example (``yardstick``: 6 x the
architecture plug-in's MACs an example, for the CIFAR classifiers the
convolutions' and linear layers' of an image, from the shapes) over the
bf16 dense peak, whatever the precision."""

from portbench import yardstick

LAYER = "whole step (train/step.py make_step_body)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_images_per_s"
SOURCE = "host_clock"


def read(ctx):
    return yardstick.mfu_pct(ctx.images_per_s / ctx.chips, ctx.config,
                             ctx.traffic, ctx.root)
