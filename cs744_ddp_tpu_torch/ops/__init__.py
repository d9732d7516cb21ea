"""Loss, optimizer and the fused BN->ReLU->MaxPool op with its CUDA kernels."""
