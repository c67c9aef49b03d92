"""The port's GPipe schedule (``repro_torch.dist.pipeline.gpipe_apply``)
against the reference test's sequential oracle (``tests/test_pipeline.py``:
4 stages of ``tanh(x @ w + b)``, 6 microbatches of (2, 8), float32)
computed in JAX, within 1e-5; also at one microbatch, one stage and fewer
microbatches than stages, against the reference's own ``gpipe_apply`` on
a one-device stage mesh, and with a gradient through the stages.  Every
stage here is the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.pipeline import gpipe_apply as jgpipe_apply
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch.dist.pipeline import gpipe_apply
from repro_torch.launch.mesh import make_mesh

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)


def _case(n_stages: int, n_micro: int, B: int = 2, d: int = 8):
    """The reference test's parameters and stream (rng 0)."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (n_stages, d, d)).astype(np.float32)
    b = rng.normal(0, 0.1, (n_stages, d)).astype(np.float32)
    xs = rng.normal(0, 1, (n_micro, B, d)).astype(np.float32)
    return {"w": w, "b": b}, xs


def _sequential(params, xs):
    """The reference test's oracle, in JAX: each microbatch through the
    stages in order."""
    def seq(x):
        for s in range(params["w"].shape[0]):
            x = jnp.tanh(x @ params["w"][s] + params["b"][s])
        return x
    return np.asarray(jnp.stack([seq(jnp.asarray(xs[m]))
                                 for m in range(xs.shape[0])]))


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _port(params, xs, n_stages: int):
    mesh = make_mesh((n_stages,), ("stage",), "cpu")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    return gpipe_apply(_stage, tp, torch.from_numpy(xs), mesh)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 6), (4, 1), (1, 6),
                                              (4, 2), (3, 5)])
def test_gpipe_matches_sequential(n_stages, n_micro):
    params, xs = _case(n_stages, n_micro)
    got = _port(params, xs, n_stages)
    assert got.shape == xs.shape and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), _sequential(params, xs),
                               rtol=1e-5, atol=1e-5)


def test_gpipe_one_stage_matches_reference_gpipe():
    """On a one-device ``"stage"`` mesh the reference's ``gpipe_apply``
    runs in this process: the port's equals it (one stage, 6
    microbatches)."""
    params, xs = _case(1, 6)
    want = jgpipe_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(xs), jmake_mesh((1,), ("stage",)))
    np.testing.assert_allclose(_port(params, xs, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gpipe_gradient_matches_sequential():
    """The gradient of the pipeline's summed output with respect to every
    stage's weights equals JAX's gradient of the sequential oracle."""
    params, xs = _case(4, 6)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    mesh = make_mesh((4,), ("stage",), "cpu")
    out = gpipe_apply(_stage, tp, torch.from_numpy(xs), mesh)
    gw, gb = torch.autograd.grad(out.sum(), (tp["w"], tp["b"]))

    def total(p):
        x = jnp.asarray(xs)
        for s in range(4):
            x = jnp.tanh(x @ p["w"][s] + p["b"][s])
        return x.sum()
    want = jax.grad(total)({k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(gw.numpy(), np.asarray(want["w"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want["b"]),
                               rtol=1e-5, atol=1e-5)
