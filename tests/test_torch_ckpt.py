"""The port's checkpoints (``repro_torch.ckpt.manager``): the reference's
seven ``tests/test_ckpt.py`` cases on the port's manager; the on-disk
format shared with the reference, a smoke model's (params, opt_state)
written by either package restored by the other bit for bit (bf16
included, with the same keys, dtypes, CRC32s and leaf files); and the
launcher killed after a checkpoint and run again, giving the
uninterrupted run's losses and parameters bit for bit; the launcher's
``--mesh`` grammar against the reference's ``parse_mesh``, and a run on
the (2, 2, 2) ``("pod", "data", "model")`` mesh resumed on another."""
import filecmp
import functools
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import manager as jckpt
from repro.models import lm as jlm
from repro.train import optim as joptim
from repro_torch import configs
from repro_torch.ckpt import manager as ckpt
from repro_torch.convert import lm_params_from_jax
from repro_torch.dist import sharding as shd
from repro_torch.launch import train as launcher
from repro_torch.train import optim

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(0, 1, (4, 8)).astype(np.float32)),
        "b": {"w": torch.from_numpy(rng.normal(0, 1, (3, 3))).to(
                  torch.bfloat16),
              "step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_roundtrip_including_bf16(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 5, tree)
    restored, manifest = ckpt.restore(tmp_path, _zeros(tree))
    assert manifest["step"] == 5
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_crc_detects_corruption(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, 1, tree)
    victim = sorted(path.glob("leaf_*.npy"))[0]
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        ckpt.restore(tmp_path, _zeros(tree))


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, {"only": torch.zeros((2,))})


def test_latest_pointer_and_fallback(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    ckpt.save(tmp_path, 9, _tree(1))
    assert ckpt.latest_step(tmp_path) == 9
    (tmp_path / "LATEST").unlink()          # a lost pointer
    assert ckpt.latest_step(tmp_path) == 9  # recovered by the scan


def test_atomicity_tmp_dirs_ignored(tmp_path):
    ckpt.save(tmp_path, 3, _tree())
    # a crashed half-save leaves a tmp dir, which must be invisible
    (tmp_path / ".tmp_step_0000000099_123").mkdir()
    assert ckpt.latest_step(tmp_path) == 3
    ckpt.gc_tmp(tmp_path)
    assert not list(tmp_path.glob(".tmp_*"))


def test_manager_retention_and_async(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=2, save_interval=10)
    for step in (10, 20, 30):
        mgr.save_async(step, _tree(step))
    mgr.wait()
    steps = sorted(int(p.name.split("_")[-1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [20, 30]
    restored, manifest = mgr.restore_latest(_zeros(_tree()))
    assert manifest["step"] == 30
    assert torch.equal(restored["a"], _tree(30)["a"])


def test_should_save_interval(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, save_interval=100)
    assert not mgr.should_save(0)
    assert mgr.should_save(100)
    assert not mgr.should_save(101)


def test_save_async_snapshots_before_in_place_updates(tmp_path):
    """The launcher updates params in place right after ``save_async``:
    the checkpoint holds the values at the call."""
    tree = _tree()
    want = [t.clone() for t in _leaves(tree)]
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save_async(1, tree)
    for t in _leaves(tree):
        t.add_(1)
    mgr.wait()
    got, _ = ckpt.restore(tmp_path, _zeros(tree))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got), want))


@functools.cache
def _smoke_bf16():
    """(reference params, port params) of the bf16 stablelm-3b smoke
    model: the reference's jitted ``init``, carried over."""
    jcfg = jconfigs.smoke_config("stablelm_3b")
    jparams = jax.jit(lambda key: jlm.init(key, jcfg, {})[0])(
        jax.random.key(0))
    return jparams, lm_params_from_jax(
        jax.tree.map(np.asarray, jparams),
        configs.smoke_config("stablelm_3b"), "cpu")


def _reference_state():
    """The bf16 stablelm-3b smoke model and AdamW state with a float32
    master, both packages: (reference tree, port tree)."""
    jparams, params = _smoke_bf16()
    params = optim.unflatten(params, [t.clone()
                                      for t in optim.leaves(params)])
    jacfg = joptim.AdamWConfig(master_dtype=jnp.float32)
    jopt = joptim.init(jparams, jacfg)
    jopt["step"] = jnp.int32(3)
    opt = optim.init(params, optim.AdamWConfig(master_dtype=torch.float32))
    return (jparams, jopt), (params, opt)


def _as_f32(a):
    return np.asarray(a).astype(np.float32)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    (jparams, jopt), port = _reference_state()
    rng = np.random.default_rng(1)
    jopt["m"] = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype), jopt["m"])
    jckpt.save(tmp_path, 3, (jparams, jopt), extra={"arch": "x"})
    (params, opt), manifest = ckpt.restore(tmp_path, port)
    assert manifest["step"] == 3 and manifest["extra"] == {"arch": "x"}
    want = jax.tree.leaves((jparams, jopt))
    got = _leaves((params, opt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert ckpt._NAMES[a.dtype] == str(np.asarray(b).dtype)
        assert np.array_equal(_as_f32(a.float()), _as_f32(b))
    assert params["embed"].dtype == torch.bfloat16
    assert int(opt["step"]) == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    (jparams, jopt), (params, opt) = _reference_state()
    gen = torch.Generator().manual_seed(2)
    opt["v"] = optim.unflatten(opt["v"], [
        torch.rand(t.shape, generator=gen) for t in optim.leaves(opt["v"])])
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    ckpt.save(tmp_path / "port", 3, (params, opt))
    restored, manifest = jckpt.restore(tmp_path / "port",
                                       jax.tree.map(jnp.zeros_like,
                                                    (jparams, jopt)))
    for a, b in zip(jax.tree.leaves(restored), _leaves((params, opt))):
        assert np.array_equal(_as_f32(a), _as_f32(b.float()))
    # the same tree written by both packages: the same manifest entries
    # and the same leaf files, byte for byte
    jckpt.save(tmp_path / "ref", 3, restored)
    mine = json.loads((tmp_path / "port" / "step_0000000003" /
                       "manifest.json").read_text())["leaves"]
    theirs = json.loads((tmp_path / "ref" / "step_0000000003" /
                         "manifest.json").read_text())["leaves"]
    assert [{k: m[k] for k in ("key", "file", "shape", "dtype", "crc32")}
            for m in mine] == \
        [{k: m[k] for k in ("key", "file", "shape", "dtype", "crc32")}
         for m in theirs]
    assert "[0]['blocks']['attn']['wq']" in [m["key"] for m in mine]
    assert "[1]['master']['embed']" in [m["key"] for m in mine]
    for m in mine:
        assert filecmp.cmp(tmp_path / "port" / "step_0000000003" / m["file"],
                           tmp_path / "ref" / "step_0000000003" / m["file"],
                           shallow=False)


ARGS = ["--arch", "stablelm-3b", "--smoke", "--device", "cpu", "--steps",
        "8", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
        "--log-every", "1"]


def test_launcher_killed_and_resumed_is_bitwise(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --smoke`` killed
    (SIGKILL) once a checkpoint exists, then the same command again: it
    resumes from the latest intact checkpoint and gives, for every step it
    runs, the uninterrupted run's loss, and at the end its parameters and
    optimizer state, bit for bit.  Every run uses one intra-op thread."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    killed = tmp_path / "killed"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--ckpt-dir", str(killed)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        t0 = time.time()
        while ckpt.latest_step(killed) is None and proc.poll() is None:
            assert time.time() - t0 < 120
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait()
    at = ckpt.latest_step(killed)
    assert at is not None and at < 8, at
    resumed = launcher.main([*ARGS, "--ckpt-dir", str(killed)])
    assert f"resumed from step {at}" in capsys.readouterr().out
    whole = launcher.main([*ARGS, "--ckpt-dir", str(tmp_path / "whole")])
    assert sorted(resumed) == list(range(at, 8))
    assert all(resumed[s] == whole[s] for s in resumed)
    for name in ("killed", "whole"):
        assert ckpt.latest_step(tmp_path / name) == 8
    a = tmp_path / "killed" / "step_0000000008"
    b = tmp_path / "whole" / "step_0000000008"
    for leaf in json.loads((a / "manifest.json").read_text())["leaves"]:
        assert filecmp.cmp(a / leaf["file"], b / leaf["file"],
                           shallow=False), leaf["key"]


def test_parse_mesh_and_launcher_on_pod_data_model(tmp_path, capsys):
    """``--mesh 2x2x2 --device cpu --smoke``: the arch line is the
    reference's (its name, parameter count and ``mesh_shape_dict``), each
    logged step the reference's format, every loss finite; the same run
    with checkpoints, its last one lost (killed after the checkpoint of
    step 3), run again on ``"1x4 data,model"``: it resumes from step 3
    and goes on, its loss within 1e-2 of the uninterrupted run's (bf16:
    the model shards' partial sums round differently)."""
    args = ["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--ckpt-every", "2",
            "--log-every", "1", "--steps", "4"]
    straight = launcher.main([*args, "--mesh", "2x2x2"])
    out = capsys.readouterr().out.splitlines()
    jcfg = jconfigs.smoke_config("stablelm-3b")
    assert out[0] == (f"arch={jcfg.name} params~"
                      f"{jlm.count_params(jcfg)/1e6:.1f}M mesh="
                      f"{{'pod': 2, 'data': 2, 'model': 2}}")
    for s in range(4):
        assert out[1 + s].startswith(f"step {s:5d} loss "
                                     f"{straight[s]:.4f} (")
        assert out[1 + s].endswith(" ms/step)")
        assert np.isfinite(straight[s])
    assert out[-1] == "done"
    first = launcher.main([*args, "--mesh", "2x2x2",
                           "--ckpt-dir", str(tmp_path)])
    assert first == straight
    assert ckpt.latest_step(tmp_path) == 4
    (tmp_path / "LATEST").unlink()
    for f in (tmp_path / "step_0000000004").iterdir():
        f.unlink()
    (tmp_path / "step_0000000004").rmdir()
    capsys.readouterr()
    resumed = launcher.main([*args, "--mesh", "1x4 data,model",
                             "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 4}" in out
    assert "resumed from step 3" in out
    assert sorted(resumed) == [3]
    assert abs(resumed[3] - straight[3]) <= 1e-2 * abs(straight[3])


def test_parse_mesh_matches_reference():
    """``parse_mesh`` takes the reference's grammar: ``"1"``, ``"2x2"``,
    ``"2x4 data,model"`` and three dims, as ``mesh_shape_dict``s equal to
    the reference's for the same spec; a malformed spec raises."""
    from repro.launch import train as jlauncher
    for spec in ("1", "1x1", "2x2", "2x4 data,model", "2x2x2",
                 "4x2 data,model", "2x1x4 pod,data,model"):
        mesh = launcher.parse_mesh(spec, "cpu")
        shape = tuple(int(x) for x in spec.split(" ")[0].split("x"))
        axes = tuple(spec.split(" ")[1].split(",")) if " " in spec else \
            (("data", "model")[:len(shape)] if len(shape) <= 2 else
             ("pod", "data", "model"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jlauncher, "make_mesh", lambda s, a: (s, a))
            assert jlauncher.parse_mesh(spec) == (shape, axes)
        assert shd.mesh_shape_dict(mesh) == dict(zip(axes, shape))
        assert set(mesh.device_list) == {CPU}
    for bad in ("2x", "axb", "2x2 data", "2x2 data,model extra"):
        with pytest.raises(ValueError):
            launcher.parse_mesh(bad, "cpu")
