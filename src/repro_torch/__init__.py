"""PyTorch/CUDA port of ``repro``: paged continuous-batching serving of the
dense decoder configs on an NVIDIA H100, through hand-written kernels.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor JAX).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when CUDA is asked for and absent."""
