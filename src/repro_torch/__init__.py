"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors ``repro``'s module paths and public names so each
counterpart is easy to find.  It imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro``; the pieces of ``repro`` that are plain
numpy are kept here as copies.

Entry points that create tensors take ``device`` (default ``"cuda"``) and
raise when that device is missing; they never fall back to the CPU.  The
CPU path exists for tests, which pass ``device="cpu"`` explicitly.
"""
from repro_torch.device import resolve_device  # noqa: F401
