"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each kernel family becomes its own shared library with a plain C
interface, from one translation unit or several (`UNITS`: K2 / K3's,
K4's and K5's head dims are split over units so that nvcc compiles them in
parallel). Each unit is compiled on its own, then the library is linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o build/kernels/<name>-<hash>.<unit>.o csrc/<unit>.cu
    nvcc -shared -o build/kernels/<name>-<hash>.so build/kernels/<name>-<hash>.*.o

The file name carries a hash of the units, the shared headers and the
flags, so an edited source rebuilds and an unchanged one is reused. The
build directory (`build/` at the repository root) is listed in
`.gitignore`. `torch.utils.cpp_extension.load` is not used: a source that
includes PyTorch's headers takes minutes to compile, a plain C one seconds.

Nothing here runs at import time: a library is built on the first launch
of its kernel (or by `build(...)`, which starts every missing unit's nvcc
at once so they compile in parallel). There is no fallback: a failed build
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
    "SOURCES", "UNITS", "NVCC_FLAGS", "build", "load", "build_dir", "lib_path", "nvcc",
    "ptxas_report",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flashd_fwd", "flashd_decode", "flashd_varlen", "flashd_bwd", "fa2_fwd")
# the translation units of a library (csrc/<unit>.cu), where there is more than one
UNITS = {
    "flashd_decode": ("flashd_decode", "flashd_decode_hd64", "flashd_decode_hd128",
                      "flashd_decode_hd256"),
    "flashd_varlen": ("flashd_varlen", "flashd_varlen_hd96", "flashd_varlen_hd128",
                      "flashd_varlen_hd256"),
    "flashd_bwd": ("flashd_bwd", "flashd_bwd_hd256"),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    """build/kernels/<name>-<hash>.so: the library these units, the headers
    and the flags build to."""
    h = hashlib.sha256()
    units = [CSRC / f"{u}.cu" for u in UNITS.get(name, (name,))]
    for f in (*units, *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every unit of every missing library among `names`, all nvcc
    processes at once, then link each library. Returns the seconds from the
    start to each library's link (0.0 where one was cached); the ptxas log
    of its units lands beside it (`<lib>.log`)."""
    names = list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}.tmp"
    pending = {}  # library → [(unit, process, object, log), …]
    for name in names:
        lib = lib_path(name)
        if lib.exists():
            continue
        pending[name] = []
        for unit in UNITS.get(name, (name,)):
            obj = lib.parent / f"{lib.stem}.{unit}.{tag}.o"
            log = obj.with_suffix(".log")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(CSRC / f"{unit}.cu")]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
            pending[name].append((unit, proc, obj, log))
    secs = {name: 0.0 for name in names}
    errors = []
    while pending:
        for name, units in list(pending.items()):
            if any(proc.poll() is None for _, proc, _, _ in units):
                continue
            del pending[name]
            lib = lib_path(name)
            text = "".join(log.read_text() for _, _, _, log in units)
            failed = [u for u, proc, _, _ in units if proc.returncode != 0]
            if not failed:
                tmp = lib.parent / f"{lib.name}.{tag}"
                link = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                                       *(str(o) for _, _, o, _ in units)],
                                      capture_output=True, text=True)
                text += link.stdout + link.stderr
                if link.returncode == 0:
                    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
                else:
                    failed = ["the link"]
            lib.with_suffix(".log").write_text(text)
            for _, _, obj, log in units:
                obj.unlink(missing_ok=True)
                log.unlink(missing_ok=True)
            secs[name] = time.perf_counter() - t0
            if failed:
                errors.append(f"nvcc failed for {name} ({', '.join(failed)}):\n{text}")
        if pending:
            time.sleep(0.1)
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
