"""The plain reference: the cells' first training steps in plain PyTorch,
f32 with TF32 off.  It imports nothing of the program."""
