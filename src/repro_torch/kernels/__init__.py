"""The port's hand-written Hopper kernels (K1 paged flash-decode and K2 flash
attention in CUDA C++ under ``csrc/``, K3 RMSNorm in Triton), each beside
its plain PyTorch version; ``ops`` holds the model-layout wrappers."""
