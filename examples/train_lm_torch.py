"""Train a ~100M-parameter LM for a few hundred steps on the deterministic
token pipeline with the PyTorch port: the port arm of ``train_lm.py``
(the same model and arguments), driving the public API (init, the
train step with AdamW, asynchronous checkpoints) on the card.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      [--ckpt-dir DIR] [--device cpu]   (checkpoints: build/lm_ckpt)
"""
import argparse
import dataclasses
import pathlib
import time

import torch

from repro_torch.ckpt import manager as ckpt
from repro_torch.configs import stablelm_3b as base
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.train import optim
from repro_torch.train.step import TrainConfig, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    # the checkout's git-ignored build/: no other run's checkpoints share it
    ap.add_argument("--ckpt-dir", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "build" / "lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # ~100M params: a width-512, 8-layer llama-style decoder
    cfg = dataclasses.replace(
        base.config(), name="lm-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, d_head=64, d_ff=1536, vocab=50304, remat="none")
    print(f"params: {lm.count_params(cfg)/1e6:.1f}M")
    tcfg = TrainConfig(microbatches=1, adamw=optim.AdamWConfig(
        lr=3e-4, weight_decay=0.1, grad_clip=1.0))
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = optim.init(params, tcfg.adamw)
    step_fn = make_train_step(cfg, tcfg)
    pipe = TokenPipeline(0, 8, 512, cfg.vocab)
    mgr = ckpt.CheckpointManager(args.ckpt_dir, keep=2, save_interval=100)
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next().items()}
        params, opt, m = step_fn(params, opt, batch)
        if step % 20 == 0:
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"({(time.time()-t0)/(step+1)*1000:.0f} ms/step)")
        if mgr.should_save(step):
            mgr.save_async(step, (params, opt))
    mgr.wait()
    print(f"final loss {float(m['loss']):.4f} — done")


if __name__ == "__main__":
    main()
