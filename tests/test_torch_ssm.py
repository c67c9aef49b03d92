"""The port's selective SSM (``repro_torch.nn.ssm``) and the hybrid block's
causal conv against the reference's (``repro.nn.ssm``,
``repro.models.lm._causal_conv``) on the same seeded inputs: the scan at
chunks 1, 8 and 32, with and without an initial state, and the decode step
within 1e-5 in float32 (one bf16 case within 2e-2); the associative scan
bit for bit the reference's recursion; a scan resumed at a chunk boundary
bit for bit the uninterrupted one; a length the reference refuses raises
in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro_torch.models import lm
from repro_torch.nn import ssm

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

TOL = 1e-5
# bf16 inputs and outputs: y is rounded to bf16 (8 bits of mantissa) on
# both sides, so the two differ by about one bf16 ulp of |y| <= 8
BF16_TOL = 2e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _inputs(seed, B=2, S=32, d=24, N=8, dtype=np.float32):
    """x, dt (positive, as the block's softplus makes it), A_log (the
    initializer's log(1..N)), B, C, D_skip and a state."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, d))
    dt = np.log1p(np.exp(rng.normal(-2, 1, (B, S, d))))
    A_log = np.log(np.tile(np.arange(1, N + 1), (d, 1)))
    Bm, Cm = rng.normal(0, 1, (B, S, N)), rng.normal(0, 1, (B, S, N))
    D = rng.normal(1, 0.1, (d,))
    h0 = rng.normal(0, 1, (B, d, N)).astype(np.float32)
    return tuple(a.astype(np.float32).astype(dtype)
                 for a in (x, dt, A_log, Bm, Cm, D)), h0


def _jnp(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _torch(arrays):
    out = []
    for a in arrays:
        if a.dtype.name == "bfloat16":
            out.append(torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16))
        else:
            out.append(torch.from_numpy(a))
    return tuple(out)


@pytest.mark.parametrize("chunk", [1, 8, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_selective_scan_matches_reference(chunk, with_state):
    arrays, h0 = _inputs(chunk)
    state = h0 if with_state else None
    y, h = ssm.selective_scan(*_torch(arrays), chunk=chunk,
                              state0=None if state is None else _t(state))
    jy, jh = jssm.selective_scan(*_jnp(arrays), chunk=chunk,
                                 state0=None if state is None
                                 else jnp.asarray(state))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == jy.shape and h.shape == jh.shape
    _close(y, jy)
    _close(h, jh)


def test_selective_scan_bf16_matches_reference():
    """bf16 x, dt, B, C, D and A_log: the state stays float32 and y comes
    back in bf16 on both sides."""
    import ml_dtypes
    arrays, h0 = _inputs(5, dtype=ml_dtypes.bfloat16)
    y, h = ssm.selective_scan(*_torch(arrays), chunk=8, state0=_t(h0))
    jy, jh = jssm.selective_scan(*_jnp(arrays), chunk=8,
                                 state0=jnp.asarray(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y, np.asarray(jy, np.float32), BF16_TOL)
    _close(h, jh, BF16_TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16, 32])
def test_associative_scan_is_the_reference_recursion(n):
    """The odd/even recursion of ``jax.lax.associative_scan`` under the
    SSM's combine, element for element: the same products in the same
    grouping, so the bits agree."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1, (2, n, 6, 4)).astype(np.float32)
    u = rng.normal(0, 1, (2, n, 6, 4)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]
    ja, ju = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(u)), axis=1)
    ta, tu = ssm.associative_scan(_t(a), _t(u))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_selective_step_matches_reference():
    rng = np.random.default_rng(3)
    B, d, N = 3, 24, 8
    x1, dt1 = rng.normal(0, 1, (B, d)), np.abs(rng.normal(0, 0.1, (B, d)))
    A_log = np.log(np.tile(np.arange(1, N + 1), (d, 1)))
    B1, C1 = rng.normal(0, 1, (B, N)), rng.normal(0, 1, (B, N))
    D = np.ones(d)
    h = rng.normal(0, 1, (B, d, N))
    arrays = tuple(a.astype(np.float32) for a in (x1, dt1, A_log, B1, C1, D,
                                                  h))
    y, hn = ssm.selective_step(*_torch(arrays))
    jy, jhn = jssm.selective_step(*_jnp(arrays))
    _close(y, jy)
    _close(hn, jhn)
    assert torch.equal(_t(arrays[-1]), _t(h.astype(np.float32)))


@pytest.mark.parametrize("S", [1, 5])
def test_causal_conv_matches_reference(S):
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (2, S, 16)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 16)).astype(np.float32)
    prev = rng.normal(0, 1, (2, 3, 16)).astype(np.float32)
    out, taps = lm._causal_conv(_t(x), _t(w), _t(prev))
    jout, jtaps = jlm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(prev))
    _close(out, jout)
    np.testing.assert_array_equal(taps.numpy(), np.asarray(jtaps))


@pytest.mark.parametrize("chunk,cut", [(1, 7), (8, 16), (8, 24)])
def test_resumed_scan_is_bitwise_the_uninterrupted_one(chunk, cut):
    """A scan resumed from its own state at a chunk boundary gives the
    uninterrupted scan's outputs and final state bit for bit (the chunk
    loop threads the state exactly), as the fold's resume relies on."""
    arrays, _ = _inputs(11)
    x, dt, A_log, Bm, Cm, D = _torch(arrays)
    y, h = ssm.selective_scan(x, dt, A_log, Bm, Cm, D, chunk=chunk)
    y1, h1 = ssm.selective_scan(x[:, :cut], dt[:, :cut], A_log, Bm[:, :cut],
                                Cm[:, :cut], D, chunk=chunk)
    y2, h2 = ssm.selective_scan(x[:, cut:], dt[:, cut:], A_log, Bm[:, cut:],
                                Cm[:, cut:], D, chunk=chunk, state0=h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


def test_refused_length_raises_in_both_packages():
    """S not a multiple of the chunk: the reference asserts, the port
    raises a ValueError naming the constraint."""
    arrays, _ = _inputs(2, S=20)
    with pytest.raises(AssertionError):
        jssm.selective_scan(*_jnp(arrays), chunk=16)
    with pytest.raises(ValueError, match="S % chunk == 0"):
        ssm.selective_scan(*_torch(arrays), chunk=16)
