"""The whole step's share of the card's peak: images a second a chip in
the measured window x the model's FLOPs an image (``yardstick``: 6 x the
convolutions' and linear layers' MACs, from the architecture's shapes)
over the bf16 dense peak, whatever the precision."""

from portbench import yardstick

LAYER = "whole step (train/step.py make_step_body)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_images_per_s"
SOURCE = "host_clock"


def read(ctx):
    return yardstick.mfu_pct(ctx.images_per_s / ctx.chips, ctx.config)
