"""Hand-written Hopper (sm_90a) CUDA kernels, their plain PyTorch versions
(``ref``), the ``nvcc`` + ``ctypes`` build step (``build``), the
wrappers the SC layer calls (``ops``) and the paged KV cache kernels
(``paged_attn``).

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain version for a CPU tensor; nothing falls back from one to the other.
"""
