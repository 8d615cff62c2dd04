"""The port's hand-written Hopper kernels (K1 paged flash-decode over native
or int8 pools, K2 flash attention, K4 softmax cross-entropy forward and
backward, K6 the Mamba2 SSD scan and K7 the RWKV6 WKV recurrence in CUDA
C++ under ``csrc/``; K3 RMSNorm and K5 AdamW in Triton), each beside its
plain PyTorch version; ``ops`` holds the model-layout wrappers and
``quant`` the int8 KV row format."""
