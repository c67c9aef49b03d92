"""LeNet-5 (Keras-library variant, paper Fig. 3) in PyTorch.

Topology: conv 32@5x5 (SAME) -> maxpool 2x2 -> conv 64@5x5 (SAME) ->
maxpool 2x2 -> dense 512 -> dropout 0.5 (training only, drawn from a
``torch.Generator``) -> dense 10.

The public layout is the reference's: activations NHWC, conv weights HWIO,
dense weights (in, out), parameters a nested dict
``{"conv1"|"conv2"|"dense1"|"dense2": {"w", "b"}}``.  The first layer is
swappable between the paper's three designs: ``"float"`` (fp32 conv + ReLU),
``"binary"`` (k-bit quantized weights + sign) and ``"sc"`` (the stochastic
layer, through the port's CUDA kernels on the card).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import sc_layer
from repro_torch.core.sc_layer import SCConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    image_size: int = 28
    channels: int = 1
    conv1_filters: int = 32
    conv2_filters: int = 64
    ksize: int = 5
    dense: int = 512
    classes: int = 10
    dropout: float = 0.5


def _he_normal(shape: tuple[int, ...], fan_in: int,
               gen: torch.Generator) -> torch.Tensor:
    """He-normal as the reference initializes: truncated at 2 sigma, with the
    standard deviation corrected for the truncation."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=gen)


def init(seed: int = 0, cfg: LeNetConfig = LeNetConfig(),
         device: str | torch.device = "cuda"
         ) -> dict[str, dict[str, torch.Tensor]]:
    """Random parameters from a seeded torch ``Generator``, drawn on the CPU
    so a seed gives the same weights on every device.  They are not the
    reference's numbers for the same seed; ``repro_torch.convert`` shares
    the reference's weights instead."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ks, c1, c2 = cfg.ksize, cfg.conv1_filters, cfg.conv2_filters
    flat = (cfg.image_size // 4) * (cfg.image_size // 4) * c2
    shapes = {"conv1": ((ks, ks, cfg.channels, c1), ks * ks * cfg.channels),
              "conv2": ((ks, ks, c1, c2), ks * ks * c1),
              "dense1": ((flat, cfg.dense), flat),
              "dense2": ((cfg.dense, cfg.classes), cfg.dense)}
    return {name: {"w": _he_normal(shape, fan_in, gen).to(dev),
                   "b": torch.zeros(shape[-1], device=dev)}
            for name, (shape, fan_in) in shapes.items()}


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME conv, stride 1: x NHWC, w HWIO -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding="same")
    return y.permute(0, 2, 3, 1) + b


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID: NHWC -> NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def first_layer(params, x: torch.Tensor, mode: str = "float",
                sc_cfg: SCConfig | None = None, bits: int = 8,
                soft_threshold: float = 0.0, sc_impl: str = "table"
                ) -> torch.Tensor:
    """First-layer feature maps (B, 28, 28, conv1_filters).

    x: (B, H, W, C) in [0, 1].  The quantized and stochastic modes have no
    bias: the activation is ``sign(x ∘ w)`` as in the paper's Fig. 3 engine.
    """
    w = params["conv1"]["w"]
    if mode == "float":
        return torch.relu(_conv(x, w, params["conv1"]["b"]))
    if mode == "binary":
        return sc_layer.binary_conv2d_sign(x, w, bits, soft_threshold)
    if mode == "sc":
        if sc_cfg is None:
            raise ValueError("mode='sc' needs an SCConfig")
        return sc_layer.sc_conv2d_sign(x, w, sc_cfg, impl=sc_impl)
    raise ValueError(f"unknown first-layer mode {mode}")


def tail(params, h1: torch.Tensor, cfg: LeNetConfig = LeNetConfig(), *,
         train: bool = False, generator: torch.Generator | None = None
         ) -> torch.Tensor:
    """Everything after the first layer, the binary-domain remainder that
    the paper retrains.  h1: (B, 28, 28, conv1_filters) -> logits
    (B, classes).  With ``train`` the dense layer's units are kept with
    probability ``1 - cfg.dropout`` (the mask drawn from ``generator``, on
    h1's device) and the kept ones scaled by ``1 / keep``."""
    h = _maxpool(h1)
    h = torch.relu(_conv(h, params["conv2"]["w"], params["conv2"]["b"]))
    h = _maxpool(h)
    h = h.reshape(h.shape[0], -1)                  # NHWC order, as dense1's rows
    h = torch.relu(h @ params["dense1"]["w"] + params["dense1"]["b"])
    if train and cfg.dropout > 0:
        keep = 1.0 - cfg.dropout
        mask = torch.rand(h.shape, generator=generator,
                          device=h.device) < keep
        h = torch.where(mask, h / keep, 0.0)
    return h @ params["dense2"]["w"] + params["dense2"]["b"]


def apply(params, x: torch.Tensor, cfg: LeNetConfig = LeNetConfig(), *,
          mode: str = "float", sc_cfg: SCConfig | None = None, bits: int = 8,
          soft_threshold: float = 0.0, train: bool = False,
          generator: torch.Generator | None = None, sc_impl: str = "table"
          ) -> torch.Tensor:
    """First layer then tail.  x: (B, H, W, C) in [0, 1].  Outside the
    float mode the first layer is frozen (detached), as the reference's
    ``stop_gradient``."""
    h1 = first_layer(params, x, mode, sc_cfg, bits, soft_threshold, sc_impl)
    if mode != "float":
        h1 = h1.detach()
    return tail(params, h1, cfg, train=train, generator=generator)
