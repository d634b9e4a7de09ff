"""The port stands alone: it imports no JAX and nothing of the JAX package
(nor do chip_smoke.py, scripts/converge_torch.py,
scripts/diag_floaters_torch.py and scripts/twin_memory.py), and chip_smoke.py refuses to report a
result without a GPU or without the package beside it."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "lidar4d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lidar4d_tpu", "orbax")
LAZY_ONLY = ("cv2", "imageio", "tensorboardX")   # only inside functions that write files


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "scripts" / "converge_torch.py",
                                        ROOT / "scripts" / "diag_floaters_torch.py",
                                        ROOT / "scripts" / "twin_memory.py"]


def _imports(tree):
    """(module top name, is at module level) for every import in a file."""
    top_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in top_level
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], id(node) in top_level


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for name, top in _imports(ast.parse(path.read_text())):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (top and name in LAZY_ONLY), f"{path.name} imports {name} at module level"


def test_import_loads_no_jax_module():
    code = ("import sys, lidar4d_tpu_torch, lidar4d_tpu_torch.models, lidar4d_tpu_torch.sim, "
            "lidar4d_tpu_torch.interop, lidar4d_tpu_torch.cli.config, "
            "lidar4d_tpu_torch.ops.hash_onehot, lidar4d_tpu_torch.ops.plane_onehot, "
            "lidar4d_tpu_torch.ops.chamfer, lidar4d_tpu_torch.ops.rays, "
            "lidar4d_tpu_torch.train.train_step, lidar4d_tpu_torch.train.flow_cache, "
            "lidar4d_tpu_torch.data.synthetic, lidar4d_tpu_torch.data.kitti360, "
            "lidar4d_tpu_torch.utils.pointcloud, lidar4d_tpu_torch.utils.misc, "
            "lidar4d_tpu_torch.eval.meters, lidar4d_tpu_torch.train.refine, "
            "lidar4d_tpu_torch.train.checkpoints, lidar4d_tpu_torch.train.trainer, "
            "lidar4d_tpu_torch.cli.main_lidar4d, lidar4d_tpu_torch.cli.main_lidar4d_sim, "
            "lidar4d_tpu_torch.cli.preprocess, lidar4d_tpu_torch.data.preprocess, "
            "lidar4d_tpu_torch.native; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lidar4d_tpu', 'orbax', 'cv2', 'imageio', 'tensorboardX')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip()
    assert out == "[]"


def _result_lines(stdout):
    lines = []
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "kernels" in obj):
            lines.append(obj)
    return lines


def test_chip_smoke_fails_without_cuda():
    """Run here, where torch has no CUDA: non-zero exit and no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert _result_lines(proc.stdout) == []


def test_chip_smoke_fails_alone(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repository."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert _result_lines(proc.stdout) == []
