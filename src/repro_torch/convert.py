"""Parameters of the reference package -> the port's parameters.

Both packages keep LeNet's parameters as ``{"conv1"|"conv2"|"dense1"|
"dense2": {"w", "b"}}`` in the same layouts (HWIO convs, (in, out) dense), so
the conversion is a copy into float32 tensors.  The caller hands the
reference's parameter tree over as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so this module imports no JAX.
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
