"""The recurrent sequence mixers: RWKV6's time-mix core (the rwkv
family's wkv) and the Mamba-style selective SSM of the hybrid family's
blocks (hymba's parallel attention + SSM heads).

RWKV6, per head (k-dim D, v-dim D), with a data-dependent decay w_t in
(0, 1) and a bonus u:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T;   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

:func:`wkv6_chunked` is the prompt's form, the reference's algorithm: an
outer loop over chunks carries the (B, H, D, D) float32 state exactly;
within a chunk, with b the inclusive cumulative log-decay, the inter-chunk
term ``(r * exp(b_excl)) @ S0``, the strictly lower-triangular pairwise
term over ``exp(b_excl_i - b_j)`` (each factor <= 1, so it is computed
stably from the pairwise differences), the ``u`` bonus and the state
update.  :func:`wkv6_step` is a decode tick's one step.  The roundings are
the reference's: r, k, v stay in the compute dtype and each chunk widens
them; the log-decay is rounded back to the compute dtype before the
cumulative sum.

The selective SSM:

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

Plain PyTorch on every device: the reference computes both in XLA
(``lax.scan``, ``lax.associative_scan`` and plain ``jnp``), with no TPU
kernel to port.
"""
from __future__ import annotations

import torch


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, chunk: int = 16,
                 state0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D), w the per-step decay in (0, 1); u (H, D);
    ``state0`` an optional (B, H, D, D) initial state (a continued
    stream).  Returns (out (B, S, H, D) in r's dtype, the final state (B,
    H, D, D) float32).

    S must be a multiple of ``chunk`` (the reference asserts it; here a
    ``ValueError``)."""
    B, S, H, D = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"wkv6_chunked needs S % chunk == 0: S={S}, "
                         f"chunk={chunk}")
    f32 = torch.float32
    # the log-decay rounded to the compute dtype, as the reference stacks it
    lw = torch.log(torch.clamp(w.to(f32), 1e-8, 1.0)).to(r.dtype)
    uu = u.to(f32)
    strict = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)[:, :, None]
    S0 = r.new_zeros((B, H, D, D), dtype=f32) if state0 is None else \
        state0.to(f32)
    outs = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lwc = (t[:, c0:c0 + chunk].transpose(1, 2).to(f32)
                           for t in (r, k, v, lw))          # (B, H, C, D)
        b = torch.cumsum(lwc, dim=2)                # inclusive log-decay
        b_excl = b - lwc                            # decay before step i
        # inter-chunk: o_i += (r_i * exp(b_excl_i)) @ S0
        o = (rc * torch.exp(b_excl)) @ S0
        # intra-chunk (j < i): sum_d r_id k_jd exp(b_excl_id - b_jd)
        diff = b_excl[:, :, :, None, :] - b[:, :, None, :, :]
        diff = torch.where(strict, diff, -torch.inf)  # (B, H, C, C, D)
        scores = torch.einsum("bhcd,bhjd,bhcjd->bhcj", rc, kc,
                              torch.exp(diff))
        o = o + scores @ vc
        # the current token's bonus: r_i . diag(u) k_i v_i^T
        bonus = torch.einsum("bhcd,hd,bhcd->bhc", rc, uu, kc)
        o = o + bonus[..., None] * vc
        # S1 = diag(exp(b_C)) S0 + sum_j exp(b_C - b_j) k_j v_j^T
        bC = b[:, :, -1:, :]
        k_scaled = kc * torch.exp(bC - b)
        S0 = torch.exp(bC)[:, :, 0, :, None] * S0 + \
            k_scaled.transpose(-1, -2) @ vc
        outs.append(o)
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return out.to(r.dtype), S0


def wkv6_step(r1: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
              w1: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  r1, k1, v1, w1 (B, H, D), widened to float32;
    state (B, H, D, D) float32.  Returns (out (B, H, D) float32, the new
    state)."""
    f32 = torch.float32
    r1, k1, v1, w1 = (x.to(f32) for x in (r1, k1, v1, w1))
    kv = k1[..., :, None] * v1[..., None, :]                # (B, H, D, D)
    # r against the state as a product and a sum over D, not a batched
    # matrix product: on the card that product's kernel depends on the
    # B x H batch count and rounds a lane alone apart from the lanes
    # together, and the recurrent state would carry the difference
    out = (r1[..., :, None] * (state + u.to(f32)[..., None] * kv)).sum(-2)
    return out, w1[..., None] * state + kv


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
        e = torch.stack([torch.exp(dtc[..., None] * A),    # (a, u) stacked
                         (dtc * xc)[..., None] * bc[:, :, None, :]])
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
