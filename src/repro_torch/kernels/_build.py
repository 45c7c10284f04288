"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each source becomes its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared header and the
flags, so an edited source rebuilds and an unchanged one is reused. The
build directory (`build/` at the repository root) is listed in
`.gitignore`. `torch.utils.cpp_extension.load` is not used: a source that
includes PyTorch's headers takes minutes to compile, a plain C one seconds.

Nothing here runs at import time: a library is built on the first launch
of its kernel (or by `build(...)`, which starts every missing nvcc at once
so the sources compile in parallel). There is no fallback: a failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = [
    "SOURCES", "NVCC_FLAGS", "build", "load", "build_dir", "lib_path", "nvcc", "ptxas_report",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flashd_fwd", "flashd_decode", "flashd_varlen", "flashd_bwd", "fa2_fwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """`build/kernels` at the repository root (src/repro_torch/kernels → root)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> Path:
    """build/kernels/<name>-<hash>.so: the library this source, the headers
    and the flags build to."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library among `names`, all nvcc processes at
    once. Returns seconds per library built (0.0 where one was cached)."""
    names = list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = lib_path(name)
        if lib.exists():
            continue
        tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    secs = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    if name not in _LOADED:
        lib = lib_path(name)
        if not lib.exists():
            build([name])
        _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]


def ptxas_report(name: str) -> str:
    """ptxas' register / shared-memory / spill lines from the last build."""
    log = lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(
        ln.strip() for ln in log.read_text().splitlines()
        if "registers" in ln or "spill" in ln
    )
