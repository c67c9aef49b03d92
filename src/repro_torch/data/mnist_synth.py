"""Procedural synthetic handwritten-digit dataset (offline MNIST stand-in).

The container has no network access, so we generate a deterministic 28x28
8-bit greyscale digit dataset with the same shape/dtype/label contract as
MNIST.  Digits are rendered from polyline stroke skeletons with random affine
jitter (shift/rotate/scale), stroke thickness, blur, and sensor noise.

Absolute accuracies on this set differ from the paper's MNIST numbers; the
claims we validate (EXPERIMENTS.md) are the *relative* ones — hybrid-vs-binary
accuracy gap after retraining, adder ordering, the 2-bit collapse — which are
properties of the arithmetic, not the dataset.  This substitution is recorded
per-experiment.
"""
from __future__ import annotations

import functools

import numpy as np

# Stroke skeletons on a [0,1]^2 canvas (x right, y down), per digit.
_STROKES: dict[int, list[list[tuple[float, float]]]] = {
    0: [[(0.5, 0.12), (0.76, 0.3), (0.76, 0.7), (0.5, 0.88), (0.24, 0.7),
         (0.24, 0.3), (0.5, 0.12)]],
    1: [[(0.35, 0.3), (0.55, 0.12), (0.55, 0.88)], [(0.35, 0.88), (0.75, 0.88)]],
    2: [[(0.25, 0.3), (0.45, 0.12), (0.7, 0.22), (0.72, 0.45), (0.25, 0.88),
         (0.78, 0.88)]],
    3: [[(0.25, 0.18), (0.7, 0.18), (0.45, 0.45), (0.72, 0.62), (0.6, 0.85),
         (0.25, 0.82)]],
    4: [[(0.62, 0.88), (0.62, 0.12), (0.22, 0.62), (0.8, 0.62)]],
    5: [[(0.72, 0.12), (0.3, 0.12), (0.28, 0.48), (0.6, 0.45), (0.74, 0.68),
         (0.55, 0.88), (0.25, 0.8)]],
    6: [[(0.65, 0.12), (0.35, 0.4), (0.27, 0.7), (0.5, 0.88), (0.7, 0.72),
         (0.62, 0.5), (0.3, 0.55)]],
    7: [[(0.22, 0.12), (0.78, 0.12), (0.45, 0.88)], [(0.35, 0.5), (0.65, 0.5)]],
    8: [[(0.5, 0.12), (0.72, 0.28), (0.5, 0.48), (0.28, 0.28), (0.5, 0.12)],
        [(0.5, 0.48), (0.75, 0.68), (0.5, 0.88), (0.25, 0.68), (0.5, 0.48)]],
    9: [[(0.7, 0.45), (0.4, 0.5), (0.3, 0.28), (0.55, 0.12), (0.72, 0.3),
         (0.68, 0.65), (0.45, 0.88)]],
}


def _render(digit: int, rng: np.random.Generator, size: int = 28) -> np.ndarray:
    """Rasterize one digit with random affine jitter and noise -> uint8 (28,28)."""
    canvas = np.zeros((size, size), dtype=np.float32)
    angle = rng.uniform(-0.26, 0.26)               # ±15°
    scale = rng.uniform(0.8, 1.15)
    dx, dy = rng.uniform(-0.1, 0.1, size=2)
    ca, sa = np.cos(angle), np.sin(angle)
    thick = rng.uniform(0.9, 1.7)
    for stroke in _STROKES[digit]:
        pts = np.asarray(stroke, dtype=np.float32)
        # jitter control points slightly for handwriting variance
        pts = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
        # affine about canvas center
        c = pts - 0.5
        pts = np.stack([ca * c[:, 0] - sa * c[:, 1] + 0.5 + dx,
                        sa * c[:, 0] + ca * c[:, 1] + 0.5 + dy], axis=1) * scale \
            + (1 - scale) * 0.5
        # draw segments with dense sampling
        for p0, p1 in zip(pts[:-1], pts[1:]):
            n = max(2, int(np.hypot(*(p1 - p0)) * size * 3))
            ts = np.linspace(0, 1, n)[:, None]
            xy = p0[None] * (1 - ts) + p1[None] * ts
            px = np.clip((xy * size).astype(np.int32), 0, size - 1)
            canvas[px[:, 1], px[:, 0]] = 1.0
    # thickness via box blur iterations
    k = int(round(thick))
    for _ in range(max(1, k)):
        canvas = np.maximum(canvas, 0.6 * (
            np.roll(canvas, 1, 0) + np.roll(canvas, -1, 0)
            + np.roll(canvas, 1, 1) + np.roll(canvas, -1, 1)) / 2)
    canvas = np.clip(canvas, 0, 1)
    # soft blur
    blur = (canvas
            + np.roll(canvas, 1, 0) + np.roll(canvas, -1, 0)
            + np.roll(canvas, 1, 1) + np.roll(canvas, -1, 1)) / 5.0
    img = 255 * (0.85 * blur + 0.15 * canvas)
    img += rng.normal(0, 6, img.shape)             # sensor noise
    return np.clip(img, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=4)
def dataset(n_train: int = 8000, n_test: int = 2000, seed: int = 0
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic dataset: (x_train u8 (n,28,28,1), y_train, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.stack([_render(int(d), rng) for d in labels])[..., None]
    return (imgs[:n_train], labels[:n_train], imgs[n_train:], labels[n_train:])


def batch_indices(n: int, batch: int, seed: int, steps: int) -> np.ndarray:
    """(steps, batch) int64: row ``step`` holds the indices that
    ``np.random.default_rng((seed, step))`` draws from ``range(n)``, so any
    (seed, step) is recomputable and a whole run's draws go to a device in
    one copy."""
    out = np.empty((steps, batch), dtype=np.int64)
    for step in range(steps):
        out[step] = np.random.default_rng((seed, step)).integers(0, n,
                                                                 size=batch)
    return out


def batches(x: np.ndarray, y: np.ndarray, batch: int, seed: int, steps: int):
    """Deterministic stateless batch iterator: any (seed, step) is recomputable,
    which is what makes straggler recovery / elastic restart trivial."""
    for idx in batch_indices(x.shape[0], batch, seed, steps):
        yield x[idx].astype(np.float32) / 255.0, y[idx]
