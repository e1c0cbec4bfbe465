"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``ctypes``.

Each source has a plain C interface and no PyTorch headers, so ``nvcc``
compiles it in seconds.  Every source becomes its own shared library,
named after the hash of its text and the flags, in ``build/repro_torch/``
at the root of the checkout; a library whose name is already there is
loaded as it is, and an edited source gets a new name and is rebuilt.
:func:`build_all` starts one ``nvcc`` per source, all together, and waits
for all of them.

Nothing here runs at import time: the CPU tests import every module of the
package on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: ``--fmad=false`` keeps every ``a * b + c`` a separately rounded multiply
#: and add: the LIF update must round exactly like the reference's
#: elementwise f32 expression (an FMA can flip a spike at threshold).
#: ``-Xptxas=-v`` changes no code: ptxas reports each kernel's registers,
#: shared memory and spills, kept beside the library (:func:`ptxas_report`).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current text."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    _log_path(out).write_text(log)
    os.replace(tmp, out)     # atomic: a concurrent build sees all or nothing


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(name: str) -> list:
    """``(kernel, usage)`` for each kernel ptxas compiled from
    ``csrc/<name>.cu``: its mangled name, and its registers, shared memory
    and spills as ptxas printed them."""
    path = _log_path(library_path(name))
    rows = []
    for line in (path.read_text().splitlines() if path.exists() else ()):
        if "Compiling entry function" in line:
            rows.append((line.split("'")[1], []))
        elif rows and ("Used" in line or "spill" in line):
            rows[-1][1].append(line.split(":", 1)[-1].strip())
    return [(kernel, "; ".join(usage)) for kernel, usage in rows]


def build_all(names) -> None:
    """Compile every named source that is not built yet, all in parallel."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, st in started.items():     # wait for every nvcc, even on error
        try:
            _finish(name, st)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
