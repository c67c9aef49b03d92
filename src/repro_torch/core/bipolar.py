"""Bipolar stochastic arithmetic, and why the paper rejects it (§IV.B).

In the bipolar encoding a stream X represents ``2 p_X - 1`` in [-1, 1]:
multiplication becomes XNOR, addition stays the scaled adder tree.  It
handles negative weights directly, but the sign activation's decision
point (value 0) maps to unipolar probability 0.5, where a stream's variance
peaks, and a fixed tree's all-zero padding leaves encode -1, a bias the
unipolar design lacks.  The paper's split-unipolar design instead compares
two binary counters.  :func:`decision_point_errors` measures both designs
near the decision point, the split-unipolar one through the SC layer's
kernel route.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import arith, bitstream, sc_layer, sng
from repro_torch.device import resolve_device


def to_level(value: torch.Tensor, bits: int) -> torch.Tensor:
    """Bipolar value v in [-1, 1] -> unipolar stream level round((v+1)/2 N)."""
    N = 1 << bits
    return torch.clip(torch.round((value + 1.0) * 0.5 * N), 0, N) \
        .to(torch.int32)


def from_count(count: torch.Tensor, length: int) -> torch.Tensor:
    """Bipolar value of a stream with ``count`` ones: 2 c / N - 1."""
    return 2.0 * count.to(torch.float32) / length - 1.0


def mult(x: torch.Tensor, y: torch.Tensor, length: int) -> torch.Tensor:
    """Bipolar multiplier: XNOR (Gaines), the tail bits kept zero."""
    masks = bitstream.word_masks(length, x.device)
    return ((x ^ y) ^ masks) & masks


def dot_bipolar(x_val: torch.Tensor, w_val: torch.Tensor, bits: int,
                scheme: str = "ramp_lowdisc", s0_mode: str = "alt"
                ) -> torch.Tensor:
    """Bipolar stochastic estimate of ``sum_k x_k w_k``.

    x_val: (..., K) in [-1, 1]; w_val: (K, O) in [-1, 1].  XNOR products,
    the TFF tree (the adder does not care about the encoding), and the
    zero-padded leaves' bias (each encodes -1) taken out analytically.
    """
    N = 1 << bits
    K = x_val.shape[-1]
    codes_a, codes_b = sng.codes_tensors(scheme, bits, x_val.device)
    xs = sng.generate(to_level(x_val, bits), codes_a, N)      # (..., K, Wd)
    ws = sng.generate(to_level(w_val, bits), codes_b, N)      # (K, O, Wd)
    prod = mult(xs[..., :, None, :], ws, N)                   # (..., K, O, Wd)
    counts = bitstream.popcount(prod.transpose(-3, -2))       # (..., O, K)
    root = arith.tff_tree_counts(counts, s0_mode=s0_mode)     # (..., O)
    depth = arith.tree_depth(K)
    # root bipolar value = (sum_K v_i + pad * (-1)) / 2^depth
    return from_count(root, N) * (1 << depth) + ((1 << depth) - K)


def sign_bipolar(x_val, w_val, bits, **kw) -> torch.Tensor:
    """sign(x∘w) through the bipolar path (the design the paper rejects)."""
    return torch.sign(dot_bipolar(x_val, w_val, bits, **kw))


def decision_point_errors(bits: int, n: int = 512, K: int = 16,
                          seed: int = 0,
                          device: str | torch.device = "cuda"):
    """Error of the dot estimate near the sign activation's decision point.

    Draws (x, w) with numpy (as the reference does) with the exact dot
    pushed toward 0, and returns (bipolar_abs_err, split_unipolar_abs_err)
    numpy arrays for the samples whose exact |dot| is in the smallest
    quartile.  The split-unipolar counts come from the SC layer's route
    (``sc_layer.bank_counts``: the kernels on the card).
    """
    dev = resolve_device(device)
    N = 1 << bits
    rng = np.random.default_rng(seed)
    x = rng.random((n, K)).astype(np.float32)              # sensor data [0,1]
    w = rng.normal(0, 0.25, (K, 1)).astype(np.float32)
    w = np.clip(w - (x @ w).mean() / K / np.maximum(x.mean(), 1e-6), -1, 1)
    exact = (x @ w)[:, 0]
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    # bipolar path: x encoded into [-1, 1] estimates 2 sum(x w) - sum(w)
    est_b = dot_bipolar(2 * xt - 1, wt, bits).cpu().numpy()[:, 0]
    est_b = (est_b + w.sum()) / 2.0
    # split-unipolar path (the paper's design)
    cfg = sc_layer.SCConfig(bits=bits)
    banks, _ = sc_layer.weight_bank_levels(wt, bits, scale=False)
    cp, cn = sc_layer.bank_counts(sc_layer.quantize_levels(xt, bits), banks,
                                  cfg)
    est_s = (cp.cpu().numpy().astype(np.float32)
             - cn.cpu().numpy().astype(np.float32))[:, 0] \
        * (2.0 ** sc_layer.tree_depth(K)) / N
    near0 = np.abs(exact) <= np.quantile(np.abs(exact), 0.25)
    return np.abs(est_b - exact)[near0], np.abs(est_s - exact)[near0]
