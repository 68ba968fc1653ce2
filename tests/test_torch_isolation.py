"""The port stands alone: it imports neither JAX nor the reference package
(nor scikit-learn or PyYAML, which the card's installation lacks, at import
time), its kernel modules import without nvcc, and its entry points do not
pick the CPU by themselves."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pevit_tpu_torch
from pevit_tpu_torch.ops import KERNELS, _build
from pevit_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pevit_tpu")
NOT_AT_IMPORT = FORBIDDEN + ("sklearn", "yaml")  # the config imports yaml inside its YAML reader


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(pevit_tpu_torch.__path__, "pevit_tpu_torch."))


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    for m in ("serve", "ops.attention", "train.trainer", "train.optim", "config.cfg_node",
              "evaluation.metrics"):
        assert "pevit_tpu_torch." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {NOT_AT_IMPORT!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", ["chip_smoke.py"] + [
    str(p.relative_to(REPO)) for p in sorted((REPO / "pevit_tpu_torch").rglob("*.py"))])
def test_no_forbidden_import_statement(path):
    assert not _imported_roots(REPO / path) & set(FORBIDDEN)


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)}
    code = ("import pevit_tpu_torch.ops as o, os\n"
            "print([k.launches for k in o.KERNELS], os.path.exists(o.BUILD_DIR))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.split("]")[0] == "[" + ", ".join(["0"] * len(KERNELS))
    assert [k.name for k in KERNELS] == ["attention_fwd", "fused_mlp_fwd", "fused_mlp_bwd"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    kernel = _build.Kernel("attention_fwd", "attention_fwd.cu", [], replaces="-")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.start_build()


def test_resolve_device_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_sources_ship_as_package_data():
    setup = (REPO / "setup.py").read_text()
    assert "csrc/*.cu" in setup
    for k in KERNELS:
        assert k.source.is_file() and k.source.suffix == ".cu"
