"""The paper's system end to end on the PyTorch/CUDA port: pretrain
LeNet-5 in float -> swap the first layer into the stochastic domain (the
``sng_pack`` and ``sc_dot`` kernels on the card) -> retrain the binary
remainder -> report accuracy + energy, the hybrid pipeline of Fig. 3.

Run:  PYTHONPATH=src python examples/near_sensor_lenet_torch.py [--bits 4]
      [--steps 400] [--retrain-steps 250] [--full-lenet] [--device cuda]
"""
import argparse
import time

import torch

from repro_torch.core import energy, hybrid
from repro_torch.core.sc_layer import SCConfig
from repro_torch.data import mnist_synth
from repro_torch.models import lenet
from repro_torch.train import optim


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--retrain-steps", type=int, default=250)
    ap.add_argument("--full-lenet", action="store_true",
                    help="paper-size LeNet (32/64 filters); default reduced")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    cfg = (lenet.LeNetConfig() if args.full_lenet
           else lenet.LeNetConfig(conv1_filters=16, conv2_filters=32,
                                  dense=128))
    xtr, ytr, xte, yte = mnist_synth.dataset(6000, 1500)
    print(f"LeNet-5 ({cfg.conv1_filters}/{cfg.conv2_filters} filters), "
          f"synthetic digit set {len(xtr)}/{len(xte)} (offline MNIST stand-in)")

    # -- stage 1: float pretraining ----------------------------------------
    params = lenet.init(0, cfg, device=args.device)
    dev = params["conv1"]["w"].device
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    opt = optim.init(params, opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.as_tensor(xtr).to(dev)
    labels = torch.as_tensor(ytr).to(dev)
    idx = torch.as_tensor(mnist_synth.batch_indices(len(xtr), 64, 0,
                                                    args.steps), device=dev)
    t0 = time.time()
    for step in range(args.steps):
        xb = images[idx[step]].to(torch.float32) / 255.0
        params, opt, loss = hybrid.float_train_step(
            params, opt, xb, labels[idx[step]], gen, cfg, opt_cfg)
        if step % 100 == 0:
            print(f"  pretrain step {step:4d} loss {float(loss):.3f}")
    acc_float = hybrid.evaluate(params, xte, yte, cfg,
                                hybrid.HybridConfig(mode="float"))
    print(f"float baseline: {100*(1-acc_float):.2f}% misclassification "
          f"({time.time()-t0:.0f}s)")

    # -- stage 2: swap first layer into the stochastic domain ---------------
    hcfg = hybrid.HybridConfig(mode="sc",
                               sc=SCConfig(bits=args.bits, adder="tff"))
    feats_tr = hybrid.cache_first_layer(params, xtr, hcfg)
    feats_te = hybrid.cache_first_layer(params, xte, hcfg)
    acc_before = hybrid.evaluate_cached(params, feats_te, yte, cfg)
    print(f"hybrid @{args.bits}-bit BEFORE retraining: "
          f"{100*(1-acc_before):.2f}%")

    # -- stage 3: retrain the binary remainder ------------------------------
    params_rt = hybrid.retrain_tail(params, feats_tr, ytr, cfg,
                                    steps=args.retrain_steps, batch=128)
    acc_after = hybrid.evaluate_cached(params_rt, feats_te, yte, cfg)
    print(f"hybrid @{args.bits}-bit AFTER retraining:  "
          f"{100*(1-acc_after):.2f}%  "
          f"(float {100*(1-acc_float):.2f}%)")

    # -- energy story --------------------------------------------------------
    r = energy.report(args.bits)
    print(f"energy @{args.bits}-bit: SC {r.sc_energy_nj:.2f} nJ/frame vs "
          f"binary {r.bin_energy_nj:.2f} -> {r.efficiency_gain:.1f}x saving")


if __name__ == "__main__":
    main()
