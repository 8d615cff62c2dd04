"""The port's hand-written Hopper kernels (K1 paged flash-decode, K2 flash
attention and K4 softmax cross-entropy forward and backward in CUDA C++
under ``csrc/``; K3 RMSNorm and K5 AdamW in Triton), each beside its plain
PyTorch version; ``ops`` holds the model-layout wrappers."""
