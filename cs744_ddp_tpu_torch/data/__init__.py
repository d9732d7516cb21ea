"""CIFAR-10 data: host splits and epoch order (NumPy), device augmentation
(PyTorch)."""
