"""Point-cloud ops.  Each op with a kernel runs its CUDA kernel for a CUDA
tensor and its plain PyTorch version for a CPU tensor."""
