"""Parameters of the reference package -> the port's parameters.

The caller hands the reference's parameter tree over as nested dicts of
numpy arrays (for example ``jax.tree.map(np.asarray, params)``), so this
module imports no JAX.

LeNet: both packages keep ``{"conv1"|"conv2"|"dense1"|"dense2": {"w",
"b"}}`` in the same layouts (HWIO convs, (in, out) dense), so the conversion
is a copy into float32 tensors.

LM: both packages keep the same nested names, the same (in, out) dense
layout and the same stacked leading layer axis, so the conversion is a copy
into tensors of the config's dtype (bfloat16 arrays arrive as ml_dtypes
``bfloat16`` and are carried over bit for bit).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

LENET_LAYERS = ("conv1", "conv2", "dense1", "dense2")


def lenet_params_from_jax(params_np: dict, device: str | torch.device = "cuda"
                          ) -> dict[str, dict[str, torch.Tensor]]:
    """Nested dicts of numpy arrays -> nested dicts of float32 tensors."""
    dev = resolve_device(device)
    return {layer: {k: torch.tensor(np.asarray(params_np[layer][k]),
                                    dtype=torch.float32, device=dev)
                    for k in ("w", "b")}
            for layer in LENET_LAYERS}


def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype)


def lm_params_from_jax(params_np: dict, cfg,
                       device: str | torch.device = "cuda") -> dict:
    """The reference's LM parameter tree (nested dicts of numpy arrays) ->
    the port's, same names and layouts, in ``cfg.dtype`` on ``device``."""
    dev = resolve_device(device)

    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else
                _tensor(v, cfg.dtype, dev) for k, v in p.items()}
    return walk(params_np)
