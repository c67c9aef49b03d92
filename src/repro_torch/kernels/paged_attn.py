"""Paged KV cache kernels: wrappers of ``csrc/paged_attn.cu`` and
``csrc/cascade_attn.cu``.

Each replaces the TPU kernel of the same name in
``repro/kernels/paged_attn.py``:

- ``paged_decode_attention``: one-query decode attention that reads K/V in
  place through a block table, with GQA, a ``lens`` mask, a trailing window
  and the current token's row spliced in.  Each lane's chain is split
  across CTAs in fixed runs of whole blocks (:func:`paged_split_plan`, a
  function of the table width alone, so the wrapper never reads ``lens``
  on the host); each CTA double-buffers its rows with ``cp.async`` and
  writes a float32 partial state, and a second launch merges the splits in
  order and normalizes (flash-decoding);
- ``scatter_kv_rows``: the decode tick's in-place write of one K and one V
  row per (layer, lane), from the layers' own row tensors;
- ``paged_decode_attention_with_state``: the same sweep restarted at an
  absolute offset ``q0``, over table entries of ``block_stride`` positions
  each (a shard of the split-KV fallback holds part of every block),
  returning its unnormalized float32 softmax state (the cascade's
  per-lane suffix pass, a fallback shard's sweep), or, given the prefix
  pass's
  states, merged with them and normalized in its epilogue (the cascade
  tick's ``merge_attn_states``, fused: no launch of its own);
- ``cascade_prefix_attention``: one multi-query pass per shared prefix
  chain, each chain row read once per group of lanes;
- ``merge_attn_states``: the log-sum-exp merge of two states, normalized
  (the TPU function's own API, bit for bit the fused merge), and
  ``merge_attn_states_n`` over S stacked states (a split-KV fallback's
  shards, more than two).

The two cascade passes split their sweep across CTAs by
:func:`cascade_split_plan` (runs of whole blocks until the grid fills the
card, a function of the shapes alone, so neither wrapper reads
``group_len``, ``lane_lens`` or ``lens`` on the host); with more than one
split each CTA writes a float32 partial state and a second launch merges
the splits in order into the state itself, normalizing nothing.

All are bound by bytes on the H100 (see the sources for the design).

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
MIN_CTAS = 2 * 132                 # two CTAs per SM of the H100


@functools.cache
def _lib():
    lib = build.load("paged_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attn_launch.argtypes = [p] * 11 + [i] * 11 + [p]
    lib.paged_attn_launch.restype = i
    lib.paged_attn_smem_bytes.argtypes = [i] * 3
    lib.paged_attn_smem_bytes.restype = ctypes.c_longlong
    lib.paged_attn_state_launch.argtypes = [p] * 14 + [i] * 12 + [p]
    lib.paged_attn_state_launch.restype = i
    lib.paged_attn_merge_launch.argtypes = \
        [p] * 12 + [ctypes.c_longlong] + [p] * 4 + [i] * 11 + [p]
    lib.paged_attn_merge_launch.restype = i
    lib.scatter_rows_launch.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.scatter_rows_launch.restype = i
    return lib


@functools.cache
def _cascade_lib():
    lib = build.load("cascade_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cascade_prefix_launch.argtypes = [p] * 12 + [i] * 12 + [p]
    lib.cascade_prefix_launch.restype = i
    lib.cascade_prefix_smem_bytes.argtypes = [i] * 4
    lib.cascade_prefix_smem_bytes.restype = ctypes.c_longlong
    lib.merge_states_launch.argtypes = [p] * 7 + [ctypes.c_longlong, i, p]
    lib.merge_states_launch.restype = i
    lib.merge_states_n_launch.argtypes = [p] * 4 + [i, ctypes.c_longlong, i,
                                                    p]
    lib.merge_states_n_launch.restype = i
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


def _attn_args(name: str, k_arena: torch.Tensor, D: int,
               window: int | None) -> int:
    """The checks every attention kernel makes of its arena's dtype and row
    width and of the window; returns the window the kernel takes."""
    dt = k_arena.dtype
    if dt not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 arenas, got {dt}")
    if (D * k_arena.element_size()) % 16:
        raise ValueError(f"{name} needs rows of whole 16-byte vectors; "
                         f"D={D} in {dt} is not")
    win = _window(window)
    if not 0 < win < 1 << 31:
        raise ValueError(f"window must be positive, got {window}")
    return win


def _sweep_args(name: str, q: torch.Tensor, k_arena: torch.Tensor,
                v_arena: torch.Tensor, tables: torch.Tensor,
                lens: torch.Tensor, window: int | None,
                new_kv: tuple[torch.Tensor, torch.Tensor] | None) -> tuple:
    """The checks of the one-query sweeps (flat and with state) on CUDA
    tensors.  Returns the launch's integer arguments after the pointers:
    (B, num_blocks, bs, nb, Hkv, n_rep, D, win, dtype code)."""
    dev, dt = q.device, k_arena.dtype
    B, Hq, D = q.shape
    win = _attn_args(name, k_arena, D, window)
    num_blocks, bs, Hkv, D2 = k_arena.shape
    nb = tables.shape[1] if tables.dim() == 2 else -1
    if (D2 != D or v_arena.shape != k_arena.shape or Hq % Hkv
            or tables.shape != (B, nb) or lens.shape != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, arenas "
            f"{tuple(k_arena.shape)}/{tuple(v_arena.shape)}, tables "
            f"{tuple(tables.shape)}, lens {tuple(lens.shape)}")
    for arg, t, want, vec in (("q", q, dt, False),
                              ("k_arena", k_arena, dt, True),
                              ("v_arena", v_arena, dt, True),
                              ("tables", tables, torch.int32, False),
                              ("lens", lens, torch.int32, False)):
        _check(arg, t, dev, want, vec)
    if new_kv is not None:
        for arg, t in zip(("k1", "v1"), new_kv):
            _check(arg, t, dev, dt)
            if t.shape != (B, Hkv, D):
                raise ValueError(f"{arg} has shape {tuple(t.shape)}, "
                                 f"expected {(B, Hkv, D)}")
    if D * k_arena.element_size() > 512:
        raise ValueError(f"{name} takes rows of at most 512 bytes; D={D} in "
                         f"{dt} is more")
    if _lib().paged_attn_smem_bytes(Hq // Hkv, D, DTYPES[dt]) > \
            MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {Hq // Hkv} queries per KV head and "
                         f"D={D} need more shared memory than a block has")
    if nb * bs >= 1 << 30:
        raise ValueError(f"{name}: tables of {nb} blocks of {bs} are too "
                         "long")
    if B > 65535 or max(q.numel(), k_arena.numel()) >= 1 << 62:
        raise ValueError(f"{name}: too large for one launch")
    return B, num_blocks, bs, nb, Hkv, Hq // Hkv, D, win, DTYPES[dt]


def _ptrs(*ts: torch.Tensor | None) -> list[int | None]:
    return [None if t is None else t.data_ptr() for t in ts]


def _scratch(splits: int, rows: int, D: int, dev: torch.device) -> tuple:
    """(buffer, acc, m, l): the float32 partial states of a split launch,
    acc (splits, rows, D) then m and l (splits, rows), as pointers into one
    allocation that the caller keeps alive across its launches; Nones for
    one split (the kernel then writes the output itself).  Under a CUDA
    graph capture it comes from the graph's pool and is released after
    the sweep and its combine are both recorded."""
    if splits == 1:
        return None, None, None, None
    n = splits * rows
    buf = torch.empty(n * (D + 2), dtype=torch.float32, device=dev)
    acc = buf.data_ptr()
    return buf, acc, acc + 4 * n * D, acc + 4 * n * (D + 1)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


SPLIT_POSITIONS = 512     # positions per split of a lane's chain


def paged_split_plan(nb: int, bs: int) -> tuple[int, int]:
    """(splits, blocks per split bps) of ``paged_decode_attention``: split
    z of a lane sweeps table entries ``[z * bps, (z + 1) * bps)``, whole
    blocks of about ``SPLIT_POSITIONS`` positions, and the splits cover the
    ``nb`` entries exactly once.  A function of the table's shape alone:
    the wrapper never reads ``lens`` on the host."""
    bps = max(1, SPLIT_POSITIONS // bs)
    return -(-nb // bps), bps


# a cascade split holds at least two of the kernels' 64-position ring
# chunks: a run of one saves less than the combine launch it adds (H100)
MIN_SPLIT_POSITIONS = 128


def cascade_split_plan(rows: int, Hkv: int, nb: int, bs: int
                       ) -> tuple[int, int]:
    """(splits, blocks per split bps) of the cascade's two passes:
    ``cascade_prefix_attention`` (rows = G groups, nb = npre chain
    entries) and ``paged_decode_attention_with_state`` (rows = B lanes, nb
    suffix table entries).  Split z sweeps table entries ``[z * bps, (z +
    1) * bps)``, whole blocks of at least ``MIN_SPLIT_POSITIONS``
    positions (or the whole table), and the splits cover the ``nb``
    entries exactly once; they are the fewest that bring ``rows * Hkv *
    splits`` CTAs up to ``MIN_CTAS``.  A function of the shapes alone: the
    wrappers never read ``group_len``, ``lane_lens`` or ``lens`` on the
    host, and a split that holds no attended position writes the empty
    state."""
    ctas = rows * Hkv
    want = -(-MIN_CTAS // ctas) if ctas < MIN_CTAS else 1
    bps = max(1, min(nb, max(-(-nb // want),
                             -(-MIN_SPLIT_POSITIONS // bs))))
    return -(-nb // bps), bps


# values of cascade_split_plan's module constants that force a plan of the
# cascade passes, for checks that patch them (``mock.patch.object``): one
# split, as planned, and one block per split.  A captured tick
# (``serve/capture.py``) froze the plan of its capture, so these checks
# call the wrappers directly, never a captured step.
CASCADE_FORCED_PLANS = {"one split": {"MIN_CTAS": 0}, "planned": {},
                        "one block": {"MIN_CTAS": 1 << 30,
                                      "MIN_SPLIT_POSITIONS": 1}}


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
    name = "paged_decode_attention"
    args = _sweep_args(name, q, k_arena, v_arena, tables, lens, window,
                       new_kv)
    B, Hq, D = q.shape
    nb, bs = tables.shape[1], k_arena.shape[1]
    splits, bps = paged_split_plan(nb, bs)
    if splits > 65535:
        raise ValueError(f"{name}: {splits} splits are too many for one "
                         "launch")
    out = torch.empty(q.shape, dtype=k_arena.dtype, device=q.device)
    if B == 0:
        return out
    _buf, acc, m, l = _scratch(splits, B * Hq, D, q.device)
    k1, v1 = new_kv if new_kv is not None else (None, None)
    with torch.cuda.device(q.device):
        err = _lib().paged_attn_launch(
            *_ptrs(q, k_arena, v_arena, tables, lens, k1, v1, out), acc, m,
            l, *args[:8], splits, bps, args[8],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_with_state(
        q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
        tables: torch.Tensor, lens: torch.Tensor, *,
        window: int | None = None, q0: torch.Tensor | None = None,
        new_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        prefix: tuple | None = None, block_stride: int | None = None):
    """The flat sweep over each lane's suffix table, positions starting at
    ``q0`` (B,) int32 (None: 0), table entry j holding positions ``q0 +
    j * block_stride + i`` for the arena's bs rows i (``block_stride`` None:
    bs, contiguous blocks; more: a shard of the split-KV fallback, which
    holds bs positions of every ``block_stride``-position block).  Operands
    as :func:`paged_decode_attention`.  Returns the float32 state (acc (B,
    Hq, D), m (B, Hq), l (B, Hq)), see
    :func:`repro_torch.kernels.ref.paged_decode_attention_with_state`.

    ``prefix`` = (acc (G, Lc, Hq, D), m, l (G, Lc, Hq) float32, lane_slot
    (B,) int32): the prefix pass's states in group layout and each lane's
    flat slot ``g * Lc + c`` (-1: in no group).  The kernel's epilogue then
    merges them into the suffix state (``merge_attn_states``, fused) and
    normalizes, and the call returns (B, Hq, D) in the arena's dtype: bit
    for bit the state, placed group states, ``merge_attn_states`` and the
    cast, in the launches of the state alone (see
    :func:`repro_torch.kernels.ref.paged_decode_attention_merged`); the
    fused merge takes contiguous blocks only."""
    bs = k_arena.shape[1]
    if block_stride not in (None, bs) and prefix is not None:
        raise ValueError("the fused prefix merge sweeps contiguous blocks; "
                         f"block_stride={block_stride} with bs={bs}")
    if not q.is_cuda:
        if prefix is not None:
            return ref.paged_decode_attention_merged(
                q, k_arena, v_arena, tables, lens, window, q0, new_kv,
                prefix)
        return ref.paged_decode_attention_with_state(
            q, k_arena, v_arena, tables, lens, window, q0, new_kv,
            block_stride)
    name = "paged_decode_attention_with_state"
    args = _sweep_args(name, q, k_arena, v_arena, tables, lens, window,
                       new_kv)
    stride = bs if block_stride is None else int(block_stride)
    if stride < bs or args[3] * stride >= 1 << 30:
        raise ValueError(f"{name}: block_stride={block_stride} with "
                         f"{args[3]} entries of {bs} rows")
    B, Hq, D = q.shape
    if q0 is None:
        q0 = torch.zeros((B,), dtype=torch.int32, device=q.device)
    _check("q0", q0, q.device, torch.int32, False)
    if q0.shape != (B,):
        raise ValueError(f"q0 has shape {tuple(q0.shape)}, expected {(B,)}")
    if prefix is not None:
        slots = _prefix_args(name, prefix, B, Hq, D, q.device)
        out = torch.empty((B, Hq, D), dtype=k_arena.dtype, device=q.device)
    else:
        acc = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if B == 0:
        return out if prefix is not None else (acc, m, l)
    splits, bps = cascade_split_plan(B, args[4], args[3], args[2])
    if splits > 65535:
        raise ValueError(f"{name}: {splits} splits are too many for one "
                         "launch")
    _buf, sacc, sm, sl = _scratch(splits, B * Hq, D, q.device)
    k1, v1 = new_kv if new_kv is not None else (None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if prefix is not None:
            err = _lib().paged_attn_merge_launch(
                *_ptrs(q, k_arena, v_arena, tables, lens, q0, k1, v1,
                       *prefix), slots, out.data_ptr(), sacc, sm, sl,
                *args[:8], splits, bps, args[8], stream)
        else:
            err = _lib().paged_attn_state_launch(
                *_ptrs(q, k_arena, v_arena, tables, lens, q0, k1, v1, acc, m,
                       l), sacc, sm, sl, *args[:3], stride, *args[3:8],
                splits, bps, args[8], stream)
    _raise_on(err, name)
    paged_decode_attention_with_state.launches += 1
    if prefix is None:
        return acc, m, l
    paged_decode_attention_with_state.fused_merges += 1
    return out


paged_decode_attention_with_state.launches = 0
# calls that merged the prefix states in the epilogue: the cascade tick's
# merge_attn_states, fused
paged_decode_attention_with_state.fused_merges = 0


def _prefix_args(name: str, prefix: tuple, B: int, Hq: int, D: int,
                 dev: torch.device) -> int:
    """The checks of a fused suffix pass's prefix states; returns the group
    slots G * Lc."""
    acc, m, l, lane_slot = prefix
    G, Lc = acc.shape[:2] if acc.dim() == 4 else (-1, -1)
    if (acc.shape != (G, Lc, Hq, D) or m.shape != (G, Lc, Hq)
            or l.shape != m.shape or lane_slot.shape != (B,)):
        raise ValueError(
            f"{name}: prefix shapes acc {tuple(acc.shape)}, m "
            f"{tuple(m.shape)}, l {tuple(l.shape)}, lane_slot "
            f"{tuple(lane_slot.shape)} for {B} lanes of {Hq} x {D}")
    for arg, t, want in (("prefix acc", acc, torch.float32),
                         ("prefix m", m, torch.float32),
                         ("prefix l", l, torch.float32),
                         ("lane_slot", lane_slot, torch.int32)):
        _check(arg, t, dev, want, False)
    return G * Lc


def cascade_prefix_attention(
        qg: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
        group_tables: torch.Tensor, group_len: torch.Tensor,
        lane_lens: torch.Tensor, *, window: int | None = None
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qg: (G, Lc, Hq, D) in the arena's dtype; arenas (num_blocks, bs, Hkv,
    D); group_tables (G, npre), group_len (G,), lane_lens (G, Lc) int32.
    Returns the float32 state (acc (G, Lc, Hq, D), m, l (G, Lc, Hq)), see
    :func:`repro_torch.kernels.ref.cascade_prefix_attention`."""
    if not qg.is_cuda:
        return ref.cascade_prefix_attention(qg, k_arena, v_arena,
                                            group_tables, group_len,
                                            lane_lens, window)
    name = "cascade_prefix_attention"
    dev, dt = qg.device, k_arena.dtype
    G, Lc, Hq, D = qg.shape
    win = _attn_args(name, k_arena, D, window)
    num_blocks, bs, Hkv, D2 = k_arena.shape
    npre = group_tables.shape[1] if group_tables.dim() == 2 else -1
    if (D2 != D or v_arena.shape != k_arena.shape or Hq % Hkv
            or group_tables.shape != (G, npre) or group_len.shape != (G,)
            or lane_lens.shape != (G, Lc)):
        raise ValueError(
            f"shape mismatch: qg {tuple(qg.shape)}, arenas "
            f"{tuple(k_arena.shape)}/{tuple(v_arena.shape)}, group_tables "
            f"{tuple(group_tables.shape)}, group_len "
            f"{tuple(group_len.shape)}, lane_lens {tuple(lane_lens.shape)}")
    for arg, t, want, vec in (("qg", qg, dt, False),
                              ("k_arena", k_arena, dt, True),
                              ("v_arena", v_arena, dt, True),
                              ("group_tables", group_tables, torch.int32,
                               False),
                              ("group_len", group_len, torch.int32, False),
                              ("lane_lens", lane_lens, torch.int32, False)):
        _check(arg, t, dev, want, vec)
    lib = _cascade_lib()
    # a group whose queries overflow a block is swept in tiles of queries;
    # only a row too wide for one query's buffers is refused
    if lib.cascade_prefix_smem_bytes(max(Lc, 1), Hq // Hkv, D,
                                     DTYPES[dt]) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: one query at D={D} needs more shared "
                         "memory than a block has")
    if G > 65535 or Hkv > 65535 or npre * bs >= 1 << 30 or \
            max(qg.numel(), k_arena.numel()) >= 1 << 62:
        raise ValueError(f"{name}: too large for one launch")
    acc = torch.empty((G, Lc, Hq, D), dtype=torch.float32, device=dev)
    m = torch.empty((G, Lc, Hq), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    if G == 0 or Lc == 0:
        return acc, m, l
    splits, bps = cascade_split_plan(G, Hkv, npre, bs)
    if splits > 65535:
        raise ValueError(f"{name}: {splits} splits are too many for one "
                         "launch")
    _buf, sacc, sm, sl = _scratch(splits, G * Lc * Hq, D, dev)
    with torch.cuda.device(dev):
        err = lib.cascade_prefix_launch(
            *_ptrs(qg, k_arena, v_arena, group_tables, group_len, lane_lens,
                   acc, m, l),
            sacc, sm, sl, G, num_blocks, bs, npre, Lc, Hkv, Hq // Hkv, D,
            win, splits, bps, DTYPES[dt],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    cascade_prefix_attention.launches += 1
    return acc, m, l


cascade_prefix_attention.launches = 0


def merge_attn_states(acc1: torch.Tensor, m1: torch.Tensor,
                      l1: torch.Tensor, acc2: torch.Tensor, m2: torch.Tensor,
                      l2: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp merge of two float32 states, then the normalize: acc
    (B, Hq, D), m and l (B, Hq).  Returns (B, Hq, D) float32, see
    :func:`repro_torch.kernels.ref.merge_attn_states`."""
    if not acc1.is_cuda:
        return ref.merge_attn_states(acc1, m1, l1, acc2, m2, l2)
    name = "merge_attn_states"
    dev = acc1.device
    rows = acc1.shape[:-1]
    for arg, t, shape in (("acc1", acc1, acc1.shape), ("acc2", acc2,
                                                       acc1.shape),
                          ("m1", m1, rows), ("l1", l1, rows), ("m2", m2, rows),
                          ("l2", l2, rows)):
        _check(arg, t, dev, torch.float32, False)
        if t.shape != shape:
            raise ValueError(f"{arg} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    out = torch.empty_like(acc1)
    if acc1.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _cascade_lib().merge_states_launch(
            *_ptrs(acc1, m1, l1, acc2, m2, l2, out), m1.numel(),
            acc1.shape[-1], torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    merge_attn_states.launches += 1
    return out


merge_attn_states.launches = 0


def merge_attn_states_n(acc: torch.Tensor, m: torch.Tensor,
                        l: torch.Tensor) -> torch.Tensor:
    """:func:`merge_attn_states` over S >= 2 float32 states stacked on a
    leading axis, merged in order: acc (S, *rows, D), m and l (S, *rows).
    Returns (*rows, D) float32, see
    :func:`repro_torch.kernels.ref.merge_attn_states_n`.  Its launches
    count as ``merge_attn_states``' (the same function of more states)."""
    if not acc.is_cuda:
        return ref.merge_attn_states_n(acc, m, l)
    name = "merge_attn_states_n"
    dev = acc.device
    S, rows = acc.shape[0], acc.shape[1:-1]
    for arg, t, shape in (("acc", acc, acc.shape), ("m", m, (S, *rows)),
                          ("l", l, (S, *rows))):
        _check(arg, t, dev, torch.float32, False)
        if t.shape != shape or S < 2:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)} with S >= 2")
    out = torch.empty(acc.shape[1:], dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _cascade_lib().merge_states_n_launch(
            *_ptrs(acc, m, l, out), S, m[0].numel(), acc.shape[-1],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    merge_attn_states.launches += 1
    return out


def _layer_rows(name: str, rows, L: int, shape: tuple, dev: torch.device,
                dtype) -> list[int]:
    """Pointers to the L layers' rows, each ``shape``: of a stacked (L,
    *shape) tensor, or of a sequence of L tensors.  The launch takes them
    by value, so a captured tick replays the addresses of its capture:
    right because the tick's rows are allocated inside its graph."""
    if isinstance(rows, torch.Tensor):
        if rows.shape != (L, *shape):
            raise ValueError(f"{name} has shape {tuple(rows.shape)}, "
                             f"expected {(L, *shape)}")
        _check(name, rows, dev, dtype)
        step = rows[0].numel() * rows.element_size() if L else 0
        return [rows.data_ptr() + i * step for i in range(L)]
    rows = list(rows)
    if len(rows) != L:
        raise ValueError(f"{name} holds {len(rows)} layers, expected {L}")
    for i, t in enumerate(rows):
        if t.shape != shape:
            raise ValueError(f"{name}[{i}] has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        _check(f"{name}[{i}]", t, dev, dtype)
    return [t.data_ptr() for t in rows]


def scatter_kv_rows(k_arena: torch.Tensor, v_arena: torch.Tensor, k_rows,
                    v_rows, wbids: torch.Tensor, offs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """In place: ``arena[l, wbids[b], 0, offs[b]] = rows[l][b]`` for arenas
    (L, num_blocks, 1, bs, Hkv, D); ``k_rows`` and ``v_rows`` each stacked
    (L, S, Hkv, D) or a sequence of L tensors (S, Hkv, D), the tick's rows
    as its layers made them (the kernel takes the layers' pointers, so no
    stacked copy is written); wbids, offs (S,) int32.  Returns the two
    arenas (the same tensors)."""
    if not k_arena.is_cuda:
        return ref.scatter_kv_rows(k_arena, v_arena, k_rows, v_rows, wbids,
                                   offs)
    dev, dt = k_arena.device, k_arena.dtype
    if dt not in DTYPES:
        raise TypeError(f"scatter_kv_rows takes float32 or bfloat16 arenas, "
                        f"got {dt}")
    L, num_blocks, one, bs, Hkv, D = k_arena.shape
    S = wbids.shape[0] if wbids.dim() == 1 else -1
    if one != 1 or v_arena.shape != k_arena.shape or offs.shape != (S,):
        raise ValueError(
            f"shape mismatch: arenas {tuple(k_arena.shape)}/"
            f"{tuple(v_arena.shape)}, wbids {tuple(wbids.shape)}, offs "
            f"{tuple(offs.shape)}")
    row_bytes = Hkv * D * k_arena.element_size()
    if row_bytes % 16:
        raise ValueError("scatter_kv_rows needs rows of whole 16-byte "
                         "vectors")
    for name, t, want, vec in (("k_arena", k_arena, dt, True),
                               ("v_arena", v_arena, dt, True),
                               ("wbids", wbids, torch.int32, False),
                               ("offs", offs, torch.int32, False)):
        _check(name, t, dev, want, vec)
    kp = _layer_rows("k_rows", k_rows, L, (S, Hkv, D), dev, dt)
    vp = _layer_rows("v_rows", v_rows, L, (S, Hkv, D), dev, dt)
    if S > 65535 or row_bytes >= 1 << 31:
        raise ValueError("scatter_kv_rows: too large for one launch")
    if S == 0 or L == 0:
        return k_arena, v_arena
    with torch.cuda.device(dev):
        err = _lib().scatter_rows_launch(
            k_arena.data_ptr(), v_arena.data_ptr(),
            (ctypes.c_void_p * L)(*kp), (ctypes.c_void_p * L)(*vp),
            wbids.data_ptr(), offs.data_ptr(), L, num_blocks, bs, S,
            row_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "scatter_kv_rows")
    scatter_kv_rows.launches += 1
    return k_arena, v_arena


scatter_kv_rows.launches = 0
