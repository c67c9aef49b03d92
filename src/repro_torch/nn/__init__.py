"""LM building blocks of the port: norms, RoPE, the SwiGLU MLP and
attention (prefill, dense decode, paged decode)."""
