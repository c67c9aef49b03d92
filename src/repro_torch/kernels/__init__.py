"""Hand-written Hopper (sm_90a) CUDA kernels, their plain PyTorch versions
(``ref``), the ``nvcc`` + ``ctypes`` build step (``build``), the
wrappers the SC layer calls (``ops``) and the paged KV cache kernels
(``paged_attn``).

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain version for a CPU tensor; nothing falls back from one to the other.

Each wrapper counts its launches in Python (an integer attribute on the
function).  :data:`COUNTERS` lists every such counter in one place, for
the captured steps (``serve/capture.py``, which add a step's launches once
per replay) and for the checks that read them.
"""
from __future__ import annotations

import importlib

# every launch counter of the wrappers: name -> (module under
# repro_torch.kernels, wrapper, attribute).  The cascade tick's merge runs
# in the suffix pass's epilogue: the calls of
# paged_decode_attention_with_state that merged, counted beside the
# launches as "merge_attn_states (fused)".
COUNTERS = {
    "sng_pack": ("sng_pack", "sng_pack", "launches"),
    "sc_dot": ("sc_dot", "sc_dot", "launches"),
    "paged_decode_attention": ("paged_attn", "paged_decode_attention",
                               "launches"),
    "scatter_kv_rows": ("paged_attn", "scatter_kv_rows", "launches"),
    "paged_decode_attention_with_state": (
        "paged_attn", "paged_decode_attention_with_state", "launches"),
    "cascade_prefix_attention": ("paged_attn", "cascade_prefix_attention",
                                 "launches"),
    "merge_attn_states": ("paged_attn", "merge_attn_states", "launches"),
    "merge_attn_states (fused)": (
        "paged_attn", "paged_decode_attention_with_state", "fused_merges"),
    "flash_attention": ("flash_attn", "flash_attention", "launches"),
    "flash_attention_bwd": ("flash_attn", "flash_attention_bwd",
                            "launches"),
}


def _counter(name: str) -> tuple[object, str]:
    module, fn, attr = COUNTERS[name]
    mod = importlib.import_module(f"{__name__}.{module}")
    return getattr(mod, fn), attr


def read_counts() -> dict[str, int]:
    """Every counter of :data:`COUNTERS`, by name."""
    out = {}
    for name in COUNTERS:
        fn, attr = _counter(name)
        out[name] = getattr(fn, attr)
    return out


def add_counts(delta: dict[str, int]) -> None:
    """Add ``delta[name]`` to each named counter (a negative value takes
    launches back)."""
    for name, n in delta.items():
        if n:
            fn, attr = _counter(name)
            setattr(fn, attr, getattr(fn, attr) + n)


def reset_counts() -> None:
    """Every counter of :data:`COUNTERS` to 0."""
    for name in COUNTERS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
