"""Build and load the CUDA kernels (plain C interface + ctypes).

``load_library()`` compiles ``csrc/cheb_bsr.cu`` with ``nvcc`` for
``sm_90a`` into ``_build/`` beside this file (listed in ``.gitignore``) on
first use, keyed by a hash of the source, and loads it with ``ctypes``.
Nothing is compiled at import time, and a failed build raises: there is no
fallback to the plain versions for CUDA tensors. ``ptxas -v``'s report of
each kernel's registers and spills is kept beside the library and read
with ``build_report()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "build_report", "parse_ptxas_report"]

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "csrc" / "cheb_bsr.cu"
_BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _compile(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so concurrent first uses never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    target.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, target)


def _target() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libcheb_bsr_{digest}.so"


def build_report() -> str:
    """``ptxas -v`` output of the current source's build ("" before it)."""
    report = _target().with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""


def parse_ptxas_report(text: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per compiled kernel (mangled name) from
    ``ptxas -v`` output."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            lib.cheb_step_launch.argtypes = [
                _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
            ]
            lib.cheb_step_launch.restype = _I
            lib.cheb_union_launch.argtypes = [
                _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P,
            ]
            lib.cheb_union_launch.restype = _I
            lib.cheb_adjoint_union_launch.argtypes = [
                _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P,
            ]
            lib.cheb_adjoint_union_launch.restype = _I
            _lib = lib
        return _lib
