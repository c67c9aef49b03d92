"""Int8 gradient compression (chunked max-abs scaling) with error feedback,
the reference's ``repro/dist/compress.py`` in PyTorch.

It simulates the wire format of a compressed gradient all-reduce: a
gradient is flattened, cut into chunks of ``chunk`` values and quantized to
int8 with one float32 scale per chunk.  ``int8_roundtrip`` is quantize then
dequantize, what the receiving side sees; ``int8_roundtrip_ef`` carries the
quantization residual to the next step (error feedback), so the running
sum of compressed gradients tracks the true sum.

The arithmetic is the reference's step for step, so equal inputs give
equal bits: the chunk's absmax divided by 127 (a division, as the source
writes it), a zero scale replaced by 1, the float32 quotient rounded half
to even and clipped to ±127, and the float32 product cast back.
"""
from __future__ import annotations

import torch


def _roundtrip_f32(flat32: torch.Tensor, chunk: int) -> torch.Tensor:
    n = flat32.shape[0]
    pad = (-n) % chunk
    ch = torch.nn.functional.pad(flat32, (0, pad)).reshape(-1, chunk)
    scale = ch.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(ch / safe).clamp(-127, 127).to(torch.int8)
    deq = q.to(torch.float32) * safe        # all-zero chunks -> exactly 0
    return deq.reshape(-1)[:n]


def int8_roundtrip(g: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Quantize-dequantize ``g`` through the int8 wire format.  Shape and
    dtype are kept; the largest error is half an int8 step of the chunk's
    scale (<= |g|_max / 254)."""
    out = _roundtrip_f32(g.to(torch.float32).reshape(-1), int(chunk))
    return out.reshape(g.shape).to(g.dtype)


def int8_roundtrip_ef(g: torch.Tensor, residual: torch.Tensor,
                      chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """The error-feedback form: compress ``g + residual`` and return
    ``(compressed, new_residual)``, the uncompressed remainder carried
    forward."""
    corrected = g.to(torch.float32) + residual.to(torch.float32)
    out32 = _roundtrip_f32(corrected.reshape(-1), int(chunk)).reshape(g.shape)
    new_res = (corrected - out32).to(residual.dtype)
    return out32.to(g.dtype), new_res
