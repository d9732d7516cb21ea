"""Train/eval steps and the epoch loop."""
