"""Hybrid stochastic-binary pipeline (§IV + §V.B): pretrain -> swap the first
layer into the stochastic (or quantized binary) domain -> cache its features
-> retrain the binary remainder -> evaluate.

This is the paper's third contribution: retraining the binary tail absorbs
the noise of the short-stream stochastic first layer.  The first layer is
frozen during retraining, so the main path needs no straight-through
estimator; :class:`ste_sign` is the reference's optional one.

Everything runs on the parameters' device.  On the card the SC designs'
features come from the ``sng_pack`` and ``sc_dot`` kernels (``core/
sc_layer.py`` gives each design's route); the float convolutions, the
dense products, their gradients and AdamW are PyTorch's, in float32 (TF32
off inside every entry point).  The steps run eagerly.  Random draws: the
minibatches are the reference's (``np.random.default_rng((seed, step))``);
dropout comes from a ``torch.Generator``, so its masks are not the
reference's.

Cached features are int8 tensors on the device; every function that takes
them also takes the reference's numpy int8 arrays, with the same results.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.sc_layer import SCConfig
from repro_torch.data import mnist_synth
from repro_torch.models import lenet
from repro_torch.train import optim

TRAINABLE = ("conv2", "dense1", "dense2")     # conv1 stays frozen


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    mode: str = "sc"                 # "sc" | "binary" | "float"
    sc: SCConfig = SCConfig()
    bits: int = 4                    # binary-baseline quantization bits
    soft_threshold: float = 0.0
    # "table" | "streams": the reference's route, kept for its signature.
    # It has no effect in the port, where each adder takes one route
    # whatever the value (core/sc_layer.py); sc_dot_sign only checks it.
    sc_impl: str = "table"


@contextlib.contextmanager
def _full_float32():
    """TF32 off for matmuls and cuDNN convolutions while inside, as the
    reference computes in float32; the caller's settings come back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _device(params) -> torch.device:
    return params["conv1"]["w"].device


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def _grads(loss: torch.Tensor, tree: dict) -> dict:
    return optim.unflatten(tree, list(torch.autograd.grad(
        loss, optim.leaves(tree))))


def _requiring_grad(tree: dict) -> dict:
    return optim.unflatten(tree, [t.detach().requires_grad_()
                                  for t in optim.leaves(tree)])


# -- stage 1: float pretraining ----------------------------------------------

@_full_float32()
def float_train_step(params, opt_state, x, y, generator: torch.Generator,
                     cfg: lenet.LeNetConfig, opt_cfg: optim.AdamWConfig):
    """One AdamW step of the float network on images ``x`` (B, 28, 28, 1)
    in [0, 1] and labels ``y``, dropout from ``generator``.  Returns
    (params, opt_state, loss)."""
    dev = _device(params)
    p = _requiring_grad(params)
    logits = lenet.apply(p, torch.as_tensor(x, device=dev), cfg, mode="float",
                         train=True, generator=generator)
    loss = loss_fn(logits, torch.as_tensor(y, device=dev))
    params, opt_state = optim.apply(params, _grads(loss, p), opt_state,
                                    opt_cfg)
    return params, opt_state, loss.detach()


# -- stage 2: first-layer feature caching -----------------------------------

@_full_float32()
def cache_first_layer(params, images, hybrid: HybridConfig,
                      batch: int = 64) -> torch.Tensor:
    """images: uint8 (n, 28, 28, 1), numpy or a tensor.  Returns the first
    layer's features, int8 (n, 28, 28, C1) on the parameters' device, each
    batch's images / 255 in float32 as the reference scales them."""
    dev = _device(params)
    imgs = torch.as_tensor(images).to(dev)
    outs = []
    with torch.no_grad():
        for i in range(0, imgs.shape[0], batch):
            xb = imgs[i:i + batch].to(torch.float32) / 255.0
            outs.append(lenet.first_layer(
                params, xb, hybrid.mode, hybrid.sc, hybrid.bits,
                hybrid.soft_threshold, hybrid.sc_impl).to(torch.int8))
    return torch.cat(outs)


# -- stage 3: retrain the binary tail on cached features ----------------------

@_full_float32()
def tail_train_step(params, opt_state, h1, y, generator: torch.Generator,
                    cfg: lenet.LeNetConfig, opt_cfg: optim.AdamWConfig):
    """One AdamW step of conv2, dense1 and dense2 on cached features ``h1``
    (float32), conv1 frozen.  ``opt_state`` covers those three layers.
    Returns (params, opt_state, loss)."""
    dev = _device(params)
    trainable = {k: params[k] for k in TRAINABLE}
    p = _requiring_grad(trainable)
    logits = lenet.tail({**params, **p}, torch.as_tensor(h1, device=dev), cfg,
                        train=True, generator=generator)
    loss = loss_fn(logits, torch.as_tensor(y, device=dev))
    trainable, opt_state = optim.apply(trainable, _grads(loss, p), opt_state,
                                       opt_cfg)
    return {**params, **trainable}, opt_state, loss.detach()


def retrain_tail(params, feats, labels, cfg: lenet.LeNetConfig, *,
                 steps: int = 400, batch: int = 128, lr: float = 1e-3,
                 seed: int = 0):
    """Retrain conv2/dense1/dense2 on cached first-layer features, on the
    reference's minibatches; dropout from a generator seeded with ``seed``.
    The features, labels and every step's indices go to the device once."""
    dev = _device(params)
    opt_cfg = optim.AdamWConfig(lr=lr)
    opt_state = optim.init({k: params[k] for k in TRAINABLE}, opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.as_tensor(feats, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    idx = torch.as_tensor(mnist_synth.batch_indices(
        feats.shape[0], batch, seed, steps), device=dev)
    for step in range(steps):
        params, opt_state, _ = tail_train_step(
            params, opt_state, feats[idx[step]].to(torch.float32),
            labels[idx[step]], gen, cfg, opt_cfg)
    return params


# -- evaluation ---------------------------------------------------------------

def _accuracy(logits_of, inputs: torch.Tensor, labels, batch: int) -> float:
    labels = torch.as_tensor(labels, device=inputs.device)
    correct = torch.zeros((), dtype=torch.int64, device=inputs.device)
    with torch.no_grad():
        for i in range(0, inputs.shape[0], batch):
            pred = torch.argmax(logits_of(inputs[i:i + batch]), -1)
            correct += (pred == labels[i:i + batch]).sum()
    return int(correct) / inputs.shape[0]


@_full_float32()
def evaluate_cached(params, feats, labels, cfg: lenet.LeNetConfig,
                    batch: int = 256) -> float:
    """Classification accuracy from cached first-layer features."""
    feats = torch.as_tensor(feats, device=_device(params))
    return _accuracy(lambda h: lenet.tail(params, h.to(torch.float32), cfg),
                     feats, labels, batch)


@_full_float32()
def evaluate(params, images, labels, cfg: lenet.LeNetConfig,
             hybrid: HybridConfig, batch: int = 256) -> float:
    """End-to-end accuracy of a hybrid design on raw uint8 images."""
    imgs = torch.as_tensor(images).to(_device(params))
    return _accuracy(lambda xb: lenet.apply(
        params, xb.to(torch.float32) / 255.0, cfg, mode=hybrid.mode,
        sc_cfg=hybrid.sc, bits=hybrid.bits,
        soft_threshold=hybrid.soft_threshold, sc_impl=hybrid.sc_impl),
        imgs, labels, batch)


# -- beyond the paper: a straight-through estimator ----------------------------

class ste_sign(torch.autograd.Function):
    """``sign`` forward (0 at 0); the gradient passes where ``|x| <= 1``
    and is 0 elsewhere.  Call as ``ste_sign.apply(x)``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.where(x == 0, 0.0, torch.sign(x))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return torch.where(torch.abs(x) <= 1.0, g, 0.0)
