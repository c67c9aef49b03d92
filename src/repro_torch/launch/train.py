"""Training launcher: mesh setup, sharded init, the checkpoint / restart
loop.

The reference's launcher (``repro/launch/train.py``) with the same command
line and log lines.  Its contract:
  - RESTART: at launch the latest intact checkpoint (atomic directories,
    CRC32) is restored and the data pipeline resumes from its step, so
    re-running the same command after killing the process continues the
    run, bit for bit the run that was never killed.
  - ELASTIC: pass another ``--mesh`` and the same checkpoint re-shards
    onto it (specs are functions of the mesh, ``dist/sharding.py``).
  - Batches are a stateless (seed, step) map (``data/tokens.py``).
  - ASYNC CHECKPOINTS: the copy to host memory is synchronous, the file
    writes overlap the next steps (``CheckpointManager.save_async``).

``--mesh`` takes the reference's grammar (``"1"``, ``"2x2"``, ``"2x4
data,model"``; three dims are ``("pod", "data", "model")``); the mesh's
devices are laid over ``--device``'s (every coordinate ``cuda:0`` on one
card).  The parameters are placed by ``lm.param_specs``, the optimizer
state ZeRO-1 sharded, and the step is ``make_train_step(cfg, tcfg,
mesh)``; a mesh of one coordinate (``"1"``, ``"1x1"``) runs the
one-device step.  It runs on the card unless ``--device cpu`` is given.

Example (the CPU, the reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --smoke --device cpu --mesh 2x2x2 --steps 20 --batch 8 --seq 128 \\
      --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import configs
from repro_torch.ckpt import manager as ckpt
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.train import optim
from repro_torch.train.step import TrainConfig, make_train_step


def parse_mesh(spec: str, device: str | torch.device = "cuda") -> shd.Mesh:
    """``"1"`` | ``"2x2"`` | ``"2x4 data,model"`` style, as the
    reference's: without names, up to two dims are ``("data", "model")``
    and three ``("pod", "data", "model")``.  A malformed spec raises
    ``ValueError``."""
    if " " in spec:
        dims, names = spec.split(" ")
        shape = tuple(int(x) for x in dims.split("x"))
        axes = tuple(names.split(","))
    else:
        shape = tuple(int(x) for x in spec.split("x"))
        axes = ("data", "model")[:len(shape)] if len(shape) <= 2 else \
            ("pod", "data", "model")
    if len(axes) != len(shape):
        raise ValueError(f"--mesh {spec!r}: {len(shape)} dims, axes {axes}")
    return make_mesh(shape, axes, device)


def main(argv=None) -> dict[int, float]:
    """Run the launcher; returns each step's loss (float32 as a float),
    by step, for the steps this run took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.config(args.arch))
    mesh = parse_mesh(args.mesh, args.device)
    mesh_shape = shd.mesh_shape_dict(mesh)
    print(f"arch={cfg.name} params~{lm.count_params(cfg)/1e6:.1f}M "
          f"mesh={mesh_shape}")

    tcfg = TrainConfig(
        microbatches=args.microbatches,
        adamw=optim.AdamWConfig(lr=args.lr, weight_decay=0.1, grad_clip=1.0,
                                master_dtype=torch.float32))
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    specs = None
    if math.prod(mesh_shape.values()) > 1:
        specs = shd.named(mesh, lm.param_specs(cfg, mesh_shape))
        params = shd.shard(params, specs)
    else:       # one coordinate: the one-device step
        mesh = None
    opt_state = optim.init(params, tcfg.adamw)
    train_step = make_train_step(cfg, tcfg, mesh)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = ckpt.CheckpointManager(args.ckpt_dir, keep=3,
                                     save_interval=args.ckpt_every)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            (params, opt_state), manifest = mgr.restore_latest(
                (params, opt_state), shardings=None if specs is None else (
                    specs, shd.shardings_of(opt_state)))
            start_step = manifest["step"]
            print(f"resumed from step {start_step}")

    pipe = TokenPipeline(args.seed, args.batch, args.seq, cfg.vocab,
                         start_step=start_step)
    losses = {}
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.next().items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses[step] = metrics["loss"]
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(losses[step])
            dt = (time.time() - t0) / max(1, step - start_step + 1)
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt*1000:.0f} ms/step)", flush=True)
            assert math.isfinite(loss), "loss diverged"
        if mgr and mgr.should_save(step):
            mgr.save_async(step + 1, (params, opt_state),
                           extra={"arch": cfg.name})
    if mgr:
        mgr.save_sync(args.steps, (params, opt_state),
                      extra={"arch": cfg.name})
        mgr.wait()
    print("done")
    return {step: float(loss) for step, loss in losses.items()}


if __name__ == "__main__":
    main()
