"""The port stands alone: it imports neither JAX nor the reference package
(nor scikit-learn, PyYAML, regex or PIL, which the card's installation
lacks, at import time), it reads and writes its config and tokenizes with
all four of them blocked, its kernel modules import without nvcc, and its
entry points do not pick the CPU by themselves."""

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
NOT_AT_IMPORT = FORBIDDEN + ("sklearn", "yaml", "regex", "PIL")  # PIL only inside image decoders
MISSING_ON_THE_CARD = ("yaml", "regex", "PIL", "sklearn")


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


def test_config_and_tokenizer_work_without_the_cards_missing_packages():
    """With PyYAML, regex, PIL and scikit-learn blocked, as on the card:
    every module imports, the model YAML is read, the config dumps and
    reads back, and a prompt tokenizes."""
    code = (
        "import importlib, sys\n"
        f"for name in {MISSING_ON_THE_CARD!r}: sys.modules[name] = None\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "from pevit_tpu_torch.config import get_default_config\n"
        "from pevit_tpu_torch.config.yaml_subset import load\n"
        "from pevit_tpu_torch.data.tokenizer import tokenize\n"
        "cfg = get_default_config()\n"
        "cfg.merge_from_file('resources/model/vitb32_CLIP.yaml')\n"
        "assert cfg.MODEL.SPEC.TEXT.WIDTH == 512 and load(cfg.dump())['TRAIN']['END_EPOCH'] == 10\n"
        "print(tokenize('a photo of a cat')[0, :7].tolist())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[49406, 320, 1125, 539, 320, 2368, 49407]"


@pytest.mark.parametrize("path", ["chip_smoke.py", "tools/fp32_check_mutants.py",
                                  "tools/fp32_grad_witness.py", "tools/profile_port_step.py",
                                  "tools/k3_fp32_variants.py",
                                  "tools/fp32_train_throughput.py",
                                  "tools/fp32_logit_spread.py", "tools/kernel_ab.py",
                                  "tools/fused_mlp_ab.py", "tools/gemm_stamps.py"] + [
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


def test_a_reused_build_returns_its_nvcc_log(monkeypatch, tmp_path):
    """``build_all`` returns nvcc's log for every kernel, a reused library's
    read from the log kept beside it, so ptxas's registers and spills are
    checked on every run; a library whose log is gone is built again."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
                    'echo call >> "$NVCC_CALLS"\necho "ptxas info : Used 168 registers"\n')
    nvcc.chmod(0o755)
    calls = tmp_path / "calls"
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parents[1]))
    monkeypatch.setenv("NVCC_CALLS", str(calls))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    kernel = _build.Kernel("attention_fwd", "attention_fwd.cu", [], replaces="-")
    want = {"attention_fwd": "ptxas info : Used 168 registers\n"}
    assert _build.build_all([kernel]) == want and kernel.library_path().exists()
    assert _build.build_all([kernel]) == want and calls.read_text().count("call") == 1
    kernel.library_path().with_suffix(".log").unlink()
    assert _build.build_all([kernel]) == want and calls.read_text().count("call") == 2
    assert sorted(p.suffix for p in (tmp_path / "build").iterdir()) == [".log", ".so"]


def test_library_path_follows_shared_headers(monkeypatch, tmp_path):
    """An edit to a ``csrc/*.cuh`` header renames every kernel's library, so
    a build never reuses one compiled from the old header."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// one\n")
    kernel = _build.Kernel("k", "k.cu", [], replaces="-")
    first = kernel.library_path()
    assert first.parent == tmp_path / "build" and kernel.library_path() == first
    (csrc / "shared.cuh").write_text("// two\n")
    second = kernel.library_path()
    assert second != first
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert kernel.library_path() not in (first, second)


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
    assert "csrc/*.cu" in setup and "csrc/*.cuh" in setup
    for k in KERNELS:
        assert k.source.is_file() and k.source.suffix == ".cu"
