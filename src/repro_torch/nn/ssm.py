"""The Mamba-style selective SSM of the hybrid family's blocks (hymba's
parallel attention + SSM heads): a diagonal state, data-dependent dt, B
and C.

    h_t = exp(dt_t * A) h_{t-1} + (dt_t x_t) B_t;   y_t = (h_t C_t) + D x_t

:func:`selective_scan` is the prompt's form: an outer loop over chunks of
``chunk`` steps carries h (B, d, N) in float32, and within a chunk the
recurrence runs as the reference's associative scan over ``(a, u)`` pairs
with the combine ``(a1 * a2, u1 * a2 + u2)``, in the same odd/even
recursion (:func:`associative_scan`), so the port groups the products as
the reference does; the pairs are stacked on one axis, so each step of
the recursion is one operation on both.  :func:`selective_step` is a
decode tick's one step.  The state is float32 throughout; the inputs are
widened where the reference widens them and the output cast back to x's
dtype.

Plain PyTorch on every device: the reference computes the scan in XLA
(``lax.scan`` and ``lax.associative_scan``), with no TPU kernel to port.

The reference module's RWKV6 half (``wkv6_chunked``, ``wkv6_step``) comes
with the rwkv family (ROADMAP.md §1).
"""
from __future__ import annotations

import torch


def _combine(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """The combine on stacked pairs ``e = (a, u)`` (axis 0): ``(a1 * a2,
    u1 * a2 + u2)``, each element rounded as the reference rounds it (the
    product, then the sum)."""
    out = e1 * e2[:1]
    out[1] += e2[1]
    return out


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 2 (``even`` as long as
    ``odd`` or one longer)."""
    n = even.shape[2] + odd.shape[2]
    out = even.new_empty(even.shape[:2] + (n,) + even.shape[3:])
    out[:, :, 0::2] = even
    out[:, :, 1::2] = odd
    return out


def _scan(e: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along axis 2 of the stacked pairs ``e`` (2, B, n,
    ...) by ``jax.lax.associative_scan``'s recursion: combine adjacent
    pairs, scan the half-length result (the odd outputs), then combine
    each odd output with the next even input (the even outputs, after the
    first element as it is)."""
    n = e.shape[2]
    if n < 2:
        return e
    odd = _scan(_combine(e[:, :, 0:n - 1:2], e[:, :, 1::2]))
    even = _combine(odd if n % 2 else odd[:, :, :-1], e[:, :, 2::2])
    return _interleave(torch.cat([e[:, :, :1], even], dim=2), odd)


def associative_scan(a: torch.Tensor, u: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs ``(a, u)`` along axis 1 under the
    combine ``(a1 * a2, u1 * a2 + u2)``, in the reference's recursion
    (:func:`_scan`, on the pairs stacked so each step is one operation on
    both)."""
    out = _scan(torch.stack([a, u]))
    return out[0], out[1]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D_skip: torch.Tensor,
                   chunk: int = 32, state0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, S, d); A_log (d, N); Bm, Cm (B, S, N); D_skip (d,);
    ``state0`` an optional (B, d, N) initial state (a resumed prompt).
    Returns (y (B, S, d) in x's dtype, the final state (B, d, N) float32).

    S must be a multiple of ``chunk`` (the reference asserts it; here a
    ``ValueError``).  The chunk loop threads the state exactly, so a scan
    resumed from its state at a chunk boundary gives the uninterrupted
    scan's bits."""
    B, S, d = x.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"selective_scan needs S % chunk == 0: S={S}, "
                         f"chunk={chunk}")
    N = A_log.shape[-1]
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))                          # (d, N)
    D = D_skip.to(f32)
    h = x.new_zeros((B, d, N), dtype=f32) if state0 is None else \
        state0.to(f32)
    ys = []
    for c0 in range(0, S, chunk):
        xc, dtc, bc, cc = (t[:, c0:c0 + chunk].to(f32)
                           for t in (x, dt, Bm, Cm))
        e = xc.new_empty((2,) + dtc.shape + (N,))         # (a, u) stacked
        torch.exp(dtc[..., None] * A, out=e[0])            # (B, C, d, N)
        torch.mul((dtc * xc)[..., None], bc[:, :, None, :], out=e[1])
        e = _scan(e)
        hs = e[0] * h[:, None] + e[1]
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, cc) + D * xc)
        h = hs[:, -1].contiguous()
    return torch.cat(ys, dim=1).to(x.dtype), h


def selective_step(x1: torch.Tensor, dt1: torch.Tensor, A_log: torch.Tensor,
                   B1: torch.Tensor, C1: torch.Tensor, D_skip: torch.Tensor,
                   h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x1, dt1 (B, d); B1, C1 (B, N); h (B, d, N)
    float32.  Returns (y (B, d) in x1's dtype, the new state)."""
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))
    dt = dt1.to(f32)
    a = torch.exp(dt[..., None] * A)
    u = (dt * x1.to(f32))[..., None] * B1.to(f32)[:, None, :]
    h_new = a * h + u
    y = torch.einsum("bdn,bn->bd", h_new, C1.to(f32)) \
        + D_skip.to(f32) * x1.to(f32)
    return y.to(x1.dtype), h_new
