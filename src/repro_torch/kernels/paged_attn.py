"""Paged KV cache kernels: wrappers of ``csrc/paged_attn.cu``.

``paged_decode_attention`` replaces the TPU kernel of the same name in
``repro/kernels/paged_attn.py``: one-query decode attention that reads K/V
in place through a block table, with GQA, a ``lens`` mask, a trailing
window and the current token's row spliced in.  ``scatter_kv_rows``
replaces the TPU kernel of the same name: the decode tick's in-place write
of one K and one V row per (layer, lane).  Both are bound by bytes on the
H100 (see the source for the design).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 227 * 1024        # per-block shared memory on the H100


@functools.cache
def _lib():
    lib = build.load("paged_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attn_launch.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.paged_attn_launch.restype = i
    lib.paged_attn_smem_bytes.argtypes = [i] * 4
    lib.paged_attn_smem_bytes.restype = ctypes.c_longlong
    lib.scatter_rows_launch.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.scatter_rows_launch.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype,
           vectors: bool = True):
    """Device, dtype and contiguity; ``vectors``: the kernel reads ``t`` in
    16-byte vectors, so it must be 16-byte aligned."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vectors and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _window(window: int | None) -> int:
    return int(window) if window else ref.NO_WINDOW


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, tables: torch.Tensor,
                           lens: torch.Tensor, *, window: int | None = None,
                           new_kv: tuple[torch.Tensor, torch.Tensor] | None
                           = None) -> torch.Tensor:
    """q: (B, Hq, D); k_arena, v_arena: (num_blocks, bs, Hkv, D) float32 or
    bfloat16; tables: (B, nb) int32; lens: (B,) int32; ``window`` a Python
    int (None or 0: no window); ``new_kv`` (k1, v1) each (B, Hkv, D).
    Returns (B, Hq, D) in the arena's dtype (see
    :func:`repro_torch.kernels.ref.paged_decode_attention`)."""
    if not q.is_cuda:
        return ref.paged_decode_attention(q, k_arena, v_arena, tables, lens,
                                          window, new_kv)
    dev, dt = q.device, v_arena.dtype
    if dt not in DTYPES:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 "
                        f"arenas, got {dt}")
    B, Hq, D = q.shape
    num_blocks, bs, Hkv, D2 = k_arena.shape
    nb = tables.shape[1] if tables.dim() == 2 else -1
    if (D2 != D or v_arena.shape != k_arena.shape or Hq % Hkv
            or tables.shape != (B, nb) or lens.shape != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, arenas "
            f"{tuple(k_arena.shape)}/{tuple(v_arena.shape)}, tables "
            f"{tuple(tables.shape)}, lens {tuple(lens.shape)}")
    if (D * k_arena.element_size()) % 16:
        raise ValueError(f"paged_decode_attention needs rows of whole 16-byte "
                         f"vectors; D={D} in {dt} is not")
    for name, t, want, vec in (("q", q, dt, False),
                               ("k_arena", k_arena, dt, True),
                               ("v_arena", v_arena, dt, True),
                               ("tables", tables, torch.int32, False),
                               ("lens", lens, torch.int32, False)):
        _check(name, t, dev, want, vec)
    k1 = v1 = None
    if new_kv is not None:
        k1, v1 = new_kv
        for name, t in (("k1", k1), ("v1", v1)):
            _check(name, t, dev, dt)
            if t.shape != (B, Hkv, D):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {(B, Hkv, D)}")
    win = _window(window)
    if not 0 < win < 1 << 31:
        raise ValueError(f"window must be positive, got {window}")
    lib = _lib()
    if lib.paged_attn_smem_bytes(bs, Hq // Hkv, D, DTYPES[dt]) > \
            MAX_SMEM_BYTES:
        raise ValueError(f"paged_decode_attention: block_size {bs}, "
                         f"{Hq // Hkv} queries per KV head and D={D} need "
                         "more shared memory than a block has")
    if B > 65535 or max(q.numel(), k_arena.numel()) >= 1 << 62:
        raise ValueError("paged_decode_attention: too large for one launch")
    out = torch.empty((B, Hq, D), dtype=dt, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.paged_attn_launch(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            tables.data_ptr(), lens.data_ptr(),
            None if k1 is None else k1.data_ptr(),
            None if v1 is None else v1.data_ptr(), out.data_ptr(),
            B, num_blocks, bs, nb, Hkv, Hq // Hkv, D, win, DTYPES[dt],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def scatter_kv_rows(k_arena: torch.Tensor, v_arena: torch.Tensor,
                    k_rows: torch.Tensor, v_rows: torch.Tensor,
                    wbids: torch.Tensor, offs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """In place: ``arena[l, wbids[b], 0, offs[b]] = rows[l, b]`` for arenas
    (L, num_blocks, 1, bs, Hkv, D) and rows (L, S, Hkv, D); wbids, offs
    (S,) int32.  Returns the two arenas (the same tensors)."""
    if not k_arena.is_cuda:
        return ref.scatter_kv_rows(k_arena, v_arena, k_rows, v_rows, wbids,
                                   offs)
    dev, dt = k_arena.device, k_arena.dtype
    if dt not in DTYPES:
        raise TypeError(f"scatter_kv_rows takes float32 or bfloat16 arenas, "
                        f"got {dt}")
    L, num_blocks, one, bs, Hkv, D = k_arena.shape
    S = wbids.shape[0] if wbids.dim() == 1 else -1
    if (one != 1 or v_arena.shape != k_arena.shape
            or k_rows.shape != (L, S, Hkv, D) or v_rows.shape != k_rows.shape
            or offs.shape != (S,)):
        raise ValueError(
            f"shape mismatch: arenas {tuple(k_arena.shape)}, rows "
            f"{tuple(k_rows.shape)}/{tuple(v_rows.shape)}, wbids "
            f"{tuple(wbids.shape)}, offs {tuple(offs.shape)}")
    if (Hkv * D * k_arena.element_size()) % 16:
        raise ValueError("scatter_kv_rows needs rows of whole 16-byte "
                         "vectors")
    for name, t, want, vec in (("k_arena", k_arena, dt, True),
                               ("v_arena", v_arena, dt, True),
                               ("k_rows", k_rows, dt, True),
                               ("v_rows", v_rows, dt, True),
                               ("wbids", wbids, torch.int32, False),
                               ("offs", offs, torch.int32, False)):
        _check(name, t, dev, want, vec)
    if L > 65535 or S > 1 << 30:
        raise ValueError("scatter_kv_rows: too large for one launch")
    if S == 0:
        return k_arena, v_arena
    with torch.cuda.device(dev):
        err = _lib().scatter_rows_launch(
            k_arena.data_ptr(), v_arena.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), wbids.data_ptr(), offs.data_ptr(), L,
            num_blocks, bs, S, Hkv * D, DTYPES[dt],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_kv_rows kernel launch failed: CUDA "
                           f"error {err}")
    scatter_kv_rows.launches += 1
    return k_arena, v_arena


scatter_kv_rows.launches = 0
