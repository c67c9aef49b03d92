"""Stochastic dot product (AND + popcount + TFF tree): wrapper of
``csrc/sc_dot.cu``.

Replaces the TPU kernel ``repro/kernels/sc_dot.py`` ``sc_dot_pallas``.  On
the H100 its least time is set by the bytes of X (its counts take less on
the b1 tensor cores).  Persistent CTAs keep W in shared memory and stream X
through a two-stage ``cp.async`` ring; each thread owns 4 windows x 4
outputs and folds their TFF trees in registers; streams of N <= 16 bits pair
two leaves per popcount; N = 256 runs on the b1 tensor cores (see the source
for the design).  A tree of more than 1,024 leaves is reduced as subtrees of
1,024 (one launch, a plane of partial roots each), whose roots a second
small kernel folds through the upper levels.  :func:`sc_dot_plan` is the
launch plan, a function of the shapes and the SM count that the CPU tests
check.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.arith import tree_depth
from repro_torch.kernels import build, ref

MODES = {"zero": 0, "one": 1, "alt": 2}
IDEAL = 3
SUB_LEAVES = 1024             # leaves of one tree in registers; K above it
                              # reduces subtrees of this size, then folds
MAX_WD = 8
# Wd = 8 (N = 256) runs on the b1 tensor cores (mma.sync m16n8k256 AND-POPC),
# the faster of the two routes there (PERF.md), for trees of up to this many
# leaves: W of one 8-column tile (8 KB per 32 leaves) and two X stages of 64
# windows fit shared memory.  Larger trees and operands off 16-byte
# alignment take the popcounts; a check that times or tests both routes at
# the same shapes patches this to 0.
MMA_MAX_LEAVES = 256
# the plan's limits, as csrc/sc_dot.cu has them
MAX_THREADS = 256
SMEM_MAX = 232448             # bytes of shared memory a block can take
SMEM_PER_SM = 233472          # bytes per SM (1 KB of it reserved per block)
W_BUDGET = 131072             # bytes of W a CTA keeps; more tiles O on the grid
RM = RO = 4                   # popc route: a thread's windows x outputs
CHUNK = 32                    # leaves per staged X row
N_PLAN = 11                   # ints in the plan passed to the kernel


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of ``sc_dot.cu``: ``grid_y`` O tiles of ``ot`` columns,
    ``grid_x`` persistent CTAs of ``threads`` walking the ``m_tiles`` tiles of
    ``tm`` windows.  popc route: ``groups`` window groups of 4 windows, each
    of ``ot / 4`` threads (4 outputs each), X rows of ``x_stride`` words;
    mma route: ``groups`` warps along M, ``ot / (8 nt)`` along O, each
    ``4 / nt`` x ``nt`` tiles of 16 windows x 8 outputs."""
    threads: int
    grid_x: int
    grid_y: int
    ot: int
    groups: int
    tm: int
    x_stride: int
    w_words: int
    stage_words: int
    smem: int
    nt: int
    mma: bool
    m_tiles: int

    @functools.cached_property
    def ints(self) -> ctypes.Array:
        return (ctypes.c_int * N_PLAN)(
            self.threads, self.grid_x, self.grid_y, self.ot, self.groups,
            self.tm, self.x_stride, self.w_words, self.stage_words, self.smem,
            self.nt)


def leaves_per_popcount(length: int | None, wd: int, adder: str) -> int:
    """Leaves that share one popcount: streams of N <= 16 bits sit 32 / P
    bits apart in one word (2 for the TFF tree, which needs each pair's sum;
    up to 32 / N for the ideal adder).  Only for one-word streams whose
    length the caller states (see :func:`sc_dot`'s contract on ``length``)."""
    if length is None or wd != 1:
        return 1
    if adder == "tff":
        return 2 if length <= 16 else 1
    return next((p for p in (8, 4, 2) if length <= 32 // p), 1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _busiest(M: int, tm: int, grid_y: int, sms: int) -> int:
    """Windows on the busiest SM when the tiles spread evenly."""
    return _ceil(_ceil(M, tm) * grid_y, sms) * tm


@functools.cache
def sc_dot_plan(M: int, K: int, O: int, Wd: int, pack: int, mma: bool,
                sms: int) -> Plan:
    """The launch plan at these shapes on ``sms`` SMs: W of an O tile fits
    ``W_BUDGET``, the O tile's columns fill the threads' output groups,
    two X stages and W fit ``SMEM_MAX``, and the tile of windows is the
    largest among those that leave the busiest SM the fewest windows."""
    kp = 1 << tree_depth(K)
    cl = min(kp, CHUNK)
    if mma:
        n8 = _ceil(O, 8)
        cap = max(1, W_BUDGET // (kp * 32 * 8))          # O tiles of 8 columns
        tiles8 = min(n8, cap, 32)
        nt = 4 if tiles8 >= 4 else 2 if tiles8 >= 2 else 1
        wo = _ceil(tiles8, nt)
        ot = wo * nt * 8
        w_bytes = kp * ot * 32
        row_bytes = max(cl, 4) * 32
        rows_per_group = 64 // nt
        x_stride = 0
        fits = [g for g in range(MAX_THREADS // 32 // wo, 0, -1)
                if w_bytes + 2 * g * rows_per_group * row_bytes <= SMEM_MAX]
        lanes = wo * 32
    else:
        rows = max(kp, pack) // pack * (Wd if pack == 1 else 1)
        ot = min(_ceil(O, 4) * 4, max(4, W_BUDGET // (4 * rows) // 4 * 4),
                 4 * MAX_THREADS)
        w_bytes = 4 * rows * ot
        x_stride = _ceil(max(cl, pack) * Wd, 4) * 4 + 4
        row_bytes = 4 * x_stride
        rows_per_group = RM
        nt = 0
        lanes = ot // RO
        fits = [g for g in range(MAX_THREADS // lanes, 0, -1)
                if w_bytes + 2 * g * RM * row_bytes <= SMEM_MAX]
    if not fits:
        raise ValueError(f"sc_dot: no launch plan fits shared memory at "
                         f"K={K}, O={O}, Wd={Wd}")
    grid_y = _ceil(O, ot)
    groups = min(fits, key=lambda g: (
        _busiest(M, g * rows_per_group, grid_y, sms), -g))
    tm = groups * rows_per_group
    threads = _ceil(groups * lanes, 32) * 32
    stage_bytes = tm * row_bytes
    smem = w_bytes + 2 * stage_bytes
    m_tiles = _ceil(M, tm)
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), MAX_THREADS // threads))
    grid_x = min(m_tiles, max(1, sms * per_sm // grid_y))
    return Plan(threads, grid_x, grid_y, ot, groups, tm, x_stride,
                w_bytes // 4, stage_bytes // 4, smem, nt, mma, m_tiles)


def subtrees(K: int) -> int:
    """Subtrees of ``SUB_LEAVES`` leaves that hold K's leaves when the tree
    is larger than one (0: one tree)."""
    return -(-K // SUB_LEAVES) if K > SUB_LEAVES else 0


@functools.cache
def _launch_plan(M: int, K: int, O: int, Wd: int, adder: str,
                 length: int | None, aligned: bool, index: int,
                 mma_max_leaves: int) -> tuple[int, int, ctypes.Array]:
    """(leaves per popcount, tensor-core route, the plan's ints) of a call,
    made once per shape: the host's cost per call stays a dictionary
    lookup.  K above ``SUB_LEAVES`` is planned as its subtrees, which share
    the SMs."""
    pack = leaves_per_popcount(length, Wd, adder)
    sub = subtrees(K)
    k_tree = SUB_LEAVES if sub else K
    mma = Wd == 8 and aligned and not sub and \
        1 << tree_depth(k_tree) <= mma_max_leaves
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return pack, int(mma), sc_dot_plan(M, k_tree, O, Wd, pack, mma,
                                       max(1, sms // max(1, sub))).ints


@functools.cache
def _launcher():
    fn = build.load("sc_dot").sc_dot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sc_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
           s0_mode: str = "alt", adder: str = "tff", *,
           length: int | None = None) -> torch.Tensor:
    """x_packed: (M, K, Wd) int32;  w_packed: (K, O, Wd) int32 (uint32 bit
    patterns).  Returns (M, O) int32 TFF-tree root counts over K leaves
    (zero leaves up to the next power of two), or ``sum >> depth`` for
    ``adder="ideal"``.  ``length``: the streams' bit count N.  It is a
    contract, not checked: every word's bits at and above N must be zero,
    as ``sng_pack`` writes streams of N bits; at N <= 16 the kernel then
    pairs leaves per popcount, and stray high bits would be counted into
    the neighbouring leaf.  A CUDA tensor launches the kernel (any K >= 1,
    Wd <= 8; above ``SUB_LEAVES`` leaves the subtrees' pass and its fold,
    one count); a CPU tensor runs :func:`repro_torch.kernels.ref.sc_dot`.
    Operands whose int32 offsets would overflow, M x max(K x Wd, O) >=
    2**31, run as launches over slices of M."""
    if not x_packed.is_cuda:
        return ref.sc_dot(x_packed, w_packed, s0_mode, adder)
    if adder == "ideal":
        mode = IDEAL
    elif adder == "tff" and s0_mode in MODES:
        mode = MODES[s0_mode]
    else:
        raise ValueError(f"unknown adder/s0_mode {adder!r}/{s0_mode!r}")
    dev = x_packed.device
    if w_packed.device != dev:
        raise ValueError("x_packed and w_packed must be on the same device")
    if x_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError("sc_dot takes int32 packed words")
    if not (x_packed.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("sc_dot takes contiguous tensors")
    M, K, Wd = x_packed.shape
    O = w_packed.shape[1]
    if w_packed.shape[0] != K or w_packed.shape[2] != Wd:
        raise ValueError(f"shape mismatch: x {tuple(x_packed.shape)}, "
                         f"w {tuple(w_packed.shape)}")
    if K < 1 or not 1 <= Wd <= MAX_WD:
        raise ValueError(f"sc_dot kernel needs K >= 1 and 1 <= Wd <= "
                         f"{MAX_WD}; got K={K}, Wd={Wd}")
    if length is not None and not 1 <= length <= 32 * Wd:
        raise ValueError(f"length {length} does not fit {Wd} words")
    rows = ((1 << 31) - 1) // max(K * Wd, O)
    if rows < 1:
        raise ValueError(f"sc_dot: one window of K={K}, Wd={Wd} or O={O} "
                         "outputs overflows int32 offsets")
    if M > rows:
        return torch.cat([sc_dot(x_packed[m:m + rows], w_packed, s0_mode,
                                 adder, length=length)
                          for m in range(0, M, rows)])
    out = torch.empty((M, O), dtype=torch.int32, device=dev)
    if M == 0 or O == 0:
        return out
    sub = subtrees(K)
    part = torch.empty((sub, M, O), dtype=torch.int32, device=dev) \
        if sub else None
    xp, wp = x_packed.data_ptr(), w_packed.data_ptr()
    pack, mma, ints = _launch_plan(M, K, O, Wd, adder, length,
                                   (xp | wp) % 16 == 0, dev.index,
                                   MMA_MAX_LEAVES)
    with torch.cuda.device(dev):
        err = _launcher()(xp, wp, out.data_ptr(),
                          0 if part is None else part.data_ptr(), M, K, O,
                          Wd, mode, pack, mma, ints,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_dot kernel launch failed: CUDA error {err}")
    sc_dot.launches += 1
    return out


sc_dot.launches = 0
