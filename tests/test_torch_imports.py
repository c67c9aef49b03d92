"""The port stands alone: nothing under src/repro_torch/, chip_smoke.py or the
port's example imports JAX or the reference package, and importing the
port's gateway and training modules leaves JAX unloaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "near_sensor_lenet_torch.py",
     ROOT / "examples" / "train_lm_torch.py"]


def _imported(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            names.append(node.args[0].value)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    names = _imported(ast.parse(path.read_text(), str(path)))
    assert not [n for n in names if _forbidden(n)], names


def test_files_found():
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert "chip_smoke.py" in rel
    assert "src/repro_torch/serve/gateway/gateway.py" in rel
    assert "src/repro_torch/kernels/ops.py" in rel
    assert "src/repro_torch/kernels/paged_attn.py" in rel
    assert "src/repro_torch/serve/kvcache/paged.py" in rel
    assert "src/repro_torch/serve/spec.py" in rel
    assert "src/repro_torch/serve/capture.py" in rel
    assert "src/repro_torch/serve/obs/recompile.py" in rel
    assert "src/repro_torch/train/optim.py" in rel
    assert "src/repro_torch/core/hybrid.py" in rel
    assert "src/repro_torch/core/bipolar.py" in rel
    assert "examples/near_sensor_lenet_torch.py" in rel
    assert "examples/train_lm_torch.py" in rel
    for module in ("data/tokens.py", "dist/compress.py", "train/step.py",
                   "ckpt/manager.py", "launch/train.py",
                   "dist/collectives.py", "dist/pipeline.py"):
        assert f"src/repro_torch/{module}" in rel


def test_gateway_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serve.gateway.gateway, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.serve.spec, repro_torch.serve.kvcache.paged, "
            "repro_torch.configs.stablelm_3b, repro_torch.serve.capture, "
            "repro_torch.serve.obs.recompile, repro_torch.core.hybrid, "
            "repro_torch.core.bipolar, repro_torch.train.optim, "
            "repro_torch.train.step, repro_torch.ckpt.manager, "
            "repro_torch.data.tokens, repro_torch.dist.compress, "
            "repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
