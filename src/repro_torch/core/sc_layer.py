"""The paper's stochastic first layer (§IV.B): unipolar split-weight SC dot
product + sign activation, and the all-binary baseline.

Weights split into positive and negative unipolar streams; ``x∘w_pos`` and
``x∘w_neg`` run in the stochastic domain (AND multipliers + TFF adder tree),
two counters convert them to binary, and a comparator gives the sign.

The reference (``repro.core.sc_layer``) has three bit-identical routes:
lookup table, materialized streams, and its Pallas kernels.  The port has
one: the streams are generated by the ``sng_pack`` kernel and reduced by the
``sc_dot`` kernel (both weight banks are one operand, streamed in one
``sng_pack`` and read in one ``ops.sc_dot_posneg``, so X is read once), at
every supported precision, N = 4..256.  ``counts_via_table`` of
the reference is the oracle it is held to bit for bit.

Rounding and float32 order of operations follow the reference so the
integer levels are bitwise equal (``torch.round`` and ``jnp.round`` both
round half to even).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import sng
from repro_torch.core.arith import tree_depth
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SCConfig:
    """Configuration of the stochastic first layer."""
    bits: int = 4                  # stream length N = 2**bits
    scheme: str = "ramp_lowdisc"   # SNG scheme for (activation, weight) streams
    s0_mode: str = "alt"           # TFF initial-state assignment in the tree
    adder: str = "tff"             # "tff" (paper's new) | "ideal"
    soft_threshold: float = 0.0    # |g_pos-g_neg| <= tau (value units) -> 0
    weight_scale: bool = True      # normalize kernels to full [-1,1] range

    @property
    def length(self) -> int:
        return 1 << self.bits


def quantize_levels(x01: torch.Tensor, bits: int) -> torch.Tensor:
    """Map [0,1] activations to integer stream levels 0..N."""
    N = 1 << bits
    return torch.clip(torch.round(x01 * N), 0, N).to(torch.int32)


def weight_bank_levels(w: torch.Tensor, bits: int, scale: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``w`` (..., K, O) as one (..., K, 2 O) tensor of levels, the positive
    bank's O columns then the negative bank's, and the per-kernel scale;
    weight scaling normalizes each output kernel to the range [-1, 1]."""
    N = 1 << bits
    if scale:
        s = torch.amax(torch.abs(w), dim=tuple(range(w.ndim - 1)),
                       keepdim=True)
        s = torch.clamp(s, min=1e-8)
    else:
        s = torch.ones((1,) * (w.ndim - 1) + (w.shape[-1],), dtype=w.dtype,
                       device=w.device)
    wn = w / s
    both = torch.cat([torch.clamp(wn, min=0), torch.clamp(-wn, min=0)], -1)
    levels = torch.clip(torch.round(both * N), 0, N).to(torch.int32)
    return levels, s.reshape(s.shape[-1])


def quantize_weights(w: torch.Tensor, bits: int, scale: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split ``w`` (..., K, O) into (pos_levels, neg_levels, per-kernel scale)
    (views of :func:`weight_bank_levels`' one tensor)."""
    levels, s = weight_bank_levels(w, bits, scale)
    O = w.shape[-1]
    return levels[..., :O], levels[..., O:], s


def _sign(diff: torch.Tensor, soft_threshold: float) -> torch.Tensor:
    """{-1, 0, +1}: zero where ``|diff| <= soft_threshold`` (float32)."""
    return torch.where(torch.abs(diff) <= soft_threshold, 0.0,
                       torch.sign(diff)).to(torch.float32)


def sc_dot_sign(x01: torch.Tensor, w: torch.Tensor, cfg: SCConfig
                ) -> torch.Tensor:
    """Stochastic-domain ``sign(x∘w)`` exactly as in Fig. 3.

    x01: (..., K) activations in [0,1];  w: (K, O) float weights.
    Returns (..., O) float32 in {-1, 0, +1}.
    """
    if cfg.adder not in ("tff", "ideal"):
        raise ValueError(f"adder {cfg.adder!r} is not ported (tff | ideal)")
    N = cfg.length
    lead, k = x01.shape[:-1], x01.shape[-1]
    x_lvl = quantize_levels(x01, cfg.bits).reshape(-1, k)
    banks, _scale = weight_bank_levels(w, cfg.bits, cfg.weight_scale)
    codes_a, codes_b = sng.codes_tensors(cfg.scheme, cfg.bits, x01.device)
    x_stream = sng.generate(x_lvl, codes_a, N)            # (M, K, Wd)
    c_pos, c_neg = ops.sc_dot_posneg(
        x_stream, sng.generate(banks, codes_b, N),        # (K, 2 O, Wd)
        s0_mode=cfg.s0_mode, adder=cfg.adder, length=N)
    # Undo the tree's 2^-depth scale and the 1/N stream scale -> value units.
    diff = (c_pos - c_neg).to(torch.float32) * (2.0 ** tree_depth(k)) / N
    return _sign(diff, cfg.soft_threshold).reshape(lead + (w.shape[-1],))


def binary_dot_sign(x01: torch.Tensor, w: torch.Tensor, bits: int,
                    soft_threshold: float = 0.0, weight_scale: bool = True
                    ) -> torch.Tensor:
    """The all-binary baseline: k-bit quantized weights, 8-bit activations,
    exact integer dot product (in float32, exact below 2^24), sign."""
    x_lvl = quantize_levels(x01, 8)                       # 8-bit sensor ADC
    pos, neg, _ = quantize_weights(w, bits, weight_scale)
    acc = torch.matmul(x_lvl.to(torch.float32), (pos - neg).to(torch.float32))
    diff = acc / (256.0 * (1 << bits))
    return _sign(diff, soft_threshold)


def extract_patches(x: torch.Tensor, ksize: int, padding: str = "SAME"
                    ) -> torch.Tensor:
    """im2col: (B, H, W, C) -> (B, H', W', C*ksize*ksize).

    Features are ordered ``(C, kh, kw)``, exactly as
    ``jax.lax.conv_general_dilated_patches`` orders them (and as
    ``F.unfold`` does).
    """
    B, H, W, C = x.shape
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        lo, hi = (ksize - 1) // 2, ksize // 2
        xc = F.pad(xc, (lo, hi, lo, hi))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding}")
    Ho, Wo = xc.shape[2] - ksize + 1, xc.shape[3] - ksize + 1
    cols = F.unfold(xc, kernel_size=ksize)                # (B, C*k*k, Ho*Wo)
    return cols.transpose(1, 2).reshape(B, Ho, Wo, C * ksize * ksize)


def sc_conv2d_sign(x: torch.Tensor, w: torch.Tensor, cfg: SCConfig,
                   padding: str = "SAME") -> torch.Tensor:
    """Stochastic first-layer convolution.

    x: (B, H, W, C) in [0,1];  w: (kh, kw, C, O) HWIO.
    Returns (B, H', W', O) in {-1, 0, +1}.  As in the reference, the weights
    are flattened HWIO as ``(kh, kw, C)`` against patches ordered
    ``(C, kh, kw)``; the two agree at C = 1.
    """
    kh, kw, C, O = w.shape
    patches = extract_patches(x, kh, padding)
    return sc_dot_sign(patches, w.reshape(kh * kw * C, O), cfg)


def binary_conv2d_sign(x: torch.Tensor, w: torch.Tensor, bits: int,
                       soft_threshold: float = 0.0, padding: str = "SAME"
                       ) -> torch.Tensor:
    """All-binary quantized first-layer convolution baseline."""
    kh, kw, C, O = w.shape
    patches = extract_patches(x, kh, padding)
    return binary_dot_sign(patches, w.reshape(kh * kw * C, O), bits,
                           soft_threshold)
