"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its own
shared library for ``sm_90a`` (Hopper), loaded with ``ctypes``.  Nothing is
built or loaded at import time: a library is built at its first launch, or
ahead of time by :func:`build_all`, which starts one ``nvcc`` per source and
waits for all of them.  Builds land in ``BUILD_DIR`` (listed in .gitignore),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is reused;
nvcc's log (ptxas's registers and spills) is kept beside each library, so a
reused build still reports it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CUDA_ROOT = "/usr/local/cuda"  # where the toolkit sits unless CUDA_HOME says otherwise

_LOCK = threading.Lock()


class KernelLaunchError(RuntimeError):
    """A kernel's C launcher returned a CUDA error: the card failed, not the
    caller's input."""


class KernelBuildError(RuntimeError):
    """A kernel's library could not be built: no ``nvcc``, or ``nvcc``
    failed on the source."""


class KernelInputError(ValueError):
    """A kernel's wrapper was given CUDA tensors that its kernel does not
    take (device, dtype, shape, layout or alignment)."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), CUDA_ROOT):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


class Kernel:
    """One CUDA kernel: its source, its library, and its launch count.

    ``replaces`` names the reference's Pallas kernel as ``file:line``.

    ``launches`` goes up by one for every successful launch through
    :meth:`launch` and nowhere else, so a caller can reset it, drive a path,
    and read how often the path went through the kernel.
    """

    def __init__(self, name: str, source: str, argtypes: list, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def library_path(self) -> Path:
        """Keyed by the source, every header beside it and the flags, so that
        an edit to a shared header rebuilds every kernel."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless its library and its log
        exist; returns ``(process, tmp_path, final_path)`` or None —
        :func:`_finish` waits."""
        out = self.library_path()
        if out.exists() and out.with_suffix(".log").exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _bind(self):
        with _LOCK:
            if self._fn is None:
                path = self.library_path()
                if not path.exists():
                    _finish(self.start_build())
                fn = getattr(ctypes.CDLL(str(path)), self.name)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C launcher (which enqueues on the given stream and returns
        ``cudaGetLastError()``); raise on a CUDA error, else count it."""
        err = self._bind()(*args)
        if err != 0:
            raise KernelLaunchError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


def _finish(build) -> str:
    """Wait for one build; install its library and its log beside it, or
    raise with nvcc's log."""
    if build is None:
        return ""
    proc, tmp, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) for {out.name}:\n{log}")
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)
    return log


def build_all(kernels) -> dict:
    """Build every kernel's library at once (one ``nvcc`` per source, all
    started together); returns ``{name: nvcc log}`` for every kernel, read
    from beside its library where an earlier build is reused.  Every build
    is waited for before a failure is raised."""
    kernels = list(kernels)
    builds = {k.name: k.start_build() for k in kernels}
    errors = []
    for build in builds.values():
        try:
            _finish(build)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return {k.name: k.library_path().with_suffix(".log").read_text() for k in kernels}


def device_kind(op: str, *tensors) -> str:
    """``"cuda"`` or ``"cpu"``, the one device type of ``tensors``, as an
    operator chooses its kernel or its plain version when it runs; raises
    on mixed devices or any other device."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"{op} runs on CUDA or CPU tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return kinds.pop()


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a raw pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
