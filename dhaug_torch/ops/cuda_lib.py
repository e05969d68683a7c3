"""Build, load and call the port's CUDA kernels (route: nvcc + ctypes).

Every ``csrc/*.cu`` source listed in :data:`LIBRARIES` becomes a shared
library with a plain C interface (no PyTorch headers).  :func:`build`
compiles them at first use into ``dhaug_torch/_build/<hash>/``, one ``nvcc``
per source, all started together; the hash covers every file under
``csrc/`` and the flags, so an edit to any source or header rebuilds them
all.  Nothing is built at import time.

The wrappers (``ops/fk_cuda.py``, ``models/trunk_cuda.py``) check their
tensors with :func:`check_tensor` and raise through :func:`raise_on` when a
launcher returns a CUDA error code.

Nothing links ``libcuda``: the trunk kernel's TMA descriptors are encoded
with ``cuTensorMapEncodeTiled``, which ``trunk_kernels.cu`` takes from the
driver the CUDA runtime has already loaded, through
``cudaGetDriverEntryPoint`` (``...ByVersion`` from CUDA 12.5 on).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# library name -> its source; each library exports <prefix>_error_string
LIBRARIES = {"fk_kernels": "fk_kernels.cu", "trunk_kernels": "trunk_kernels.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# filled by build(): per library, its path, the seconds nvcc took (0.0 when
# it was already built) and ptxas' register/spill report
BUILD_INFO: dict = {}
_LOADED: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return found


def _source_hash() -> str:
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build() -> dict:
    """Compile every library not built yet for these sources, in parallel,
    and return {name: library path}."""
    out_dir = BUILD_ROOT / _source_hash()
    libs = {name: out_dir / f"lib{name}.so" for name in LIBRARIES}
    pending = {}
    for name, src in LIBRARIES.items():
        if libs[name].exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.so"
        log = open(out_dir / f"{name}.{os.getpid()}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        pending[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                         log, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in LIBRARIES}
    failed = []
    for name, (proc, log, tmp, t0) in pending.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        text = Path(log.name).read_text()
        os.remove(log.name)
        if rc != 0:
            failed.append(f"nvcc {LIBRARIES[name]} failed ({rc}):\n{text}")
            continue
        (out_dir / f"{name}.ptxas.txt").write_text(text)
        os.replace(tmp, libs[name])  # atomic: a concurrent build never sees a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, lib in libs.items():
        report = out_dir / f"{name}.ptxas.txt"
        BUILD_INFO[name] = {"library": str(lib), "seconds": seconds[name],
                            "ptxas": report.read_text() if report.exists() else ""}
    return libs


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (built on first use), loaded once per process."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build()[name]))
    return _LOADED[name]


def check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
                 device: torch.device, align: int = 4) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` whose data starts on an ``align``-byte boundary."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must start on a {align}-byte boundary")


def launch_on(device: torch.device, launch):
    """``launch(stream)`` with the current stream of ``device``, entering a
    ``torch.cuda.device`` context only when ``device`` is not the current
    one (the context costs host time on every call)."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream().cuda_stream)


def raise_on(error_string, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (``error_string`` is
    the library's ``<prefix>_error_string``)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(rc).decode()}")
