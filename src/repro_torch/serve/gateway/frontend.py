"""The separable at-sensor stage and its link-payload accounting.

Two partitions of the hybrid LeNet pipeline across the sensor->host link:

  sc      — the paper's design point: conv1 (+ the 2x2 sign max-pool) runs at
            the sensor, and the link carries ternary features packed at
            2 bits/value.  On the card conv1 runs through the port's
            ``sng_pack`` and ``sc_dot`` CUDA kernels, at every precision.
  binary  — the conventional baseline: raw 8-bit pixels cross the link and
            conv1 runs host-side.

Both compute the same function (sign conv1 -> pool -> binary tail), so the
difference is what the paper claims: energy and bytes moved.  The charges
are the reference's, float for float, so the two ledgers agree exactly.

The SC first layer quantizes and packs the conv1 weight streams on every
call (one small ``sng_pack`` launch next to the one for the frame
streams); they depend only on the parameters and could be packed once at
load, which is left for the PRs that make the path fast.

Both stages make nothing on the host per call, so the gateway captures
each bucket's stage into a CUDA graph (``serve/capture.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import energy
from repro_torch.core.sc_layer import SCConfig
from repro_torch.models import lenet
from repro_torch.models.lenet import LeNetConfig
from repro_torch.serve.gateway.telemetry import E_LINK_PJ_PER_BYTE


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    mode: str = "sc"                 # "sc" | "binary"
    bits: int = 4                    # stream length 2**bits / MAC width
    # near-sensor engine geometry: 8 first-layer kernels keep the packed
    # feature payload (2 bits x 14x14x8 = 392 B) under the raw-pixel payload
    # (784 B) that the binary partition must move.
    lenet: LeNetConfig = LeNetConfig(conv1_filters=8, conv2_filters=16,
                                     dense=64)

    @property
    def sc_cfg(self) -> SCConfig:
        return SCConfig(bits=self.bits, adder="tff")


# --------------------------------------------------------------------------
# Link payload and energy accounting.
# --------------------------------------------------------------------------

def link_bytes_per_frame(spec: FrontendSpec) -> int:
    """Bytes/frame crossing the sensor->host link."""
    c = spec.lenet
    if spec.mode == "sc":
        n_values = (c.image_size // 2) ** 2 * c.conv1_filters
        return -(-2 * n_values // 8)          # 2-bit ternary, packed
    if spec.mode == "binary":
        return c.image_size ** 2 * c.channels  # raw 8-bit pixels
    raise ValueError(spec.mode)


def link_energy_nj(n_bytes: int) -> float:
    """Energy to move ``n_bytes`` over the sensor->host link."""
    return n_bytes * E_LINK_PJ_PER_BYTE * 1e-3


def frame_energy_nj(spec: FrontendSpec) -> float:
    """First-layer compute energy/frame from the calibrated Table-3 model,
    projected onto this spec's layer geometry."""
    c = spec.lenet
    r = energy.scaled_report(
        spec.bits,
        k_window=c.ksize * c.ksize * c.channels,
        n_units=c.image_size ** 2,
        n_kernels=c.conv1_filters)
    return r.sc_energy_nj if spec.mode == "sc" else r.bin_energy_nj


def lm_token_energy_nj(spec: FrontendSpec, d_model: int) -> float:
    """Per-token first-projection energy for the LM path: one
    ``d_model``-wide dot-product window per token (one unit, ``n_kernels``
    weight passes) through the same calibrated Table-3 model the frame path
    charges, so frame and prompt requests land in the ledger in the same
    joules."""
    r = energy.scaled_report(spec.bits, k_window=d_model, n_units=1,
                             n_kernels=spec.lenet.conv1_filters)
    return r.sc_energy_nj if spec.mode == "sc" else r.bin_energy_nj


def migration_energy_nj(spec: FrontendSpec, n_bytes: int) -> float:
    """Energy charged for moving ``n_bytes`` of KV blocks between gateway
    slices (``serve/shard/``): each byte priced as one 8-bit window pass
    through the calibrated k-bit binary datapath
    (``energy.scaled_report(k_window=8, n_units=1, n_kernels=1)``: a move
    between hosts rides the binary partition) plus the per-byte link cost,
    as the reference prices it.  Charged onto the migrated request's
    ledger entry, so the fleet total stays conserved."""
    r = energy.scaled_report(spec.bits, k_window=8, n_units=1, n_kernels=1)
    return n_bytes * (r.bin_energy_nj + E_LINK_PJ_PER_BYTE * 1e-3)


def sensor_latency_s(spec: FrontendSpec) -> float:
    """At-sensor processing latency before the payload hits the link: the SC
    engine streams 2**bits cycles/frame; the binary partition transmits
    immediately."""
    if spec.mode != "sc":
        return 0.0
    c = spec.lenet
    passes = c.conv1_filters / energy.N_KERNELS
    return energy.frame_time_us(spec.bits) * passes * 1e-6


# --------------------------------------------------------------------------
# The two pipeline stages (functions of (params, batch)).
# --------------------------------------------------------------------------

def pack_ternary(h: torch.Tensor) -> torch.Tensor:
    """(B, ...) values in {-1,0,1} -> (B, ceil(n/4)) uint8, 2 bits/value.
    This is the wire format: its size matches link_bytes_per_frame."""
    B = h.shape[0]
    q = (h + 1.0).to(torch.uint8).reshape(B, -1)        # {0,1,2}
    pad = (-q.shape[1]) % 4
    if pad:
        q = torch.cat([q, q.new_zeros(B, pad)], dim=1)
    q = q.reshape(B, -1, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def unpack_ternary(packed: torch.Tensor, shape: tuple[int, ...]
                   ) -> torch.Tensor:
    """Inverse of :func:`pack_ternary` -> float32 values in {-1,0,1}."""
    B = packed.shape[0]
    # made on the device: a table built from a host list is a copy from
    # pageable memory, which a captured stage may not hold
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    vals = (packed[..., None] >> shifts) & 3             # (B, n/4, 4)
    n = 1
    for d in shape:
        n *= d
    return vals.reshape(B, -1)[:, :n].to(torch.float32).reshape(
        (B,) + tuple(shape)) - 1.0


def _pooled_shape(cfg: LeNetConfig) -> tuple[int, int, int]:
    return (cfg.image_size // 2, cfg.image_size // 2, cfg.conv1_filters)


def sensor_stage(params, frames_u8: torch.Tensor, spec: FrontendSpec
                 ) -> torch.Tensor:
    """At-sensor compute.  frames_u8: (B, 28, 28, 1) uint8 on the device.

    Returns the link payload: 2-bit-packed pooled ternary features for
    "sc", the untouched frames for "binary" (the sensor is a pass-through).
    """
    if spec.mode == "binary":
        return frames_u8
    x01 = frames_u8.to(torch.float32) / 255.0
    h1 = lenet.first_layer(params, x01, mode="sc", sc_cfg=spec.sc_cfg)
    return pack_ternary(lenet._maxpool(h1))


def gateway_stage(params, payload: torch.Tensor, spec: FrontendSpec
                  ) -> torch.Tensor:
    """Host-side compute: the binary-domain remainder (plus conv1 for the
    binary partition).  Returns class logits (B, classes)."""
    cfg = spec.lenet
    if spec.mode == "binary":
        x01 = payload.to(torch.float32) / 255.0
        h1 = lenet.first_layer(params, x01, mode="binary", bits=spec.bits)
        h = lenet._maxpool(h1)
    else:
        h = unpack_ternary(payload, _pooled_shape(cfg))
    h = torch.relu(lenet._conv(h, params["conv2"]["w"], params["conv2"]["b"]))
    h = lenet._maxpool(h)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ params["dense1"]["w"] + params["dense1"]["b"])
    return h @ params["dense2"]["w"] + params["dense2"]["b"]
