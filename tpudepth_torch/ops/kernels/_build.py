"""Build the CUDA sources under ``tpudepth_torch/csrc`` with ``nvcc`` into
shared libraries with a plain C interface, and load them with ``ctypes``.

A library is named after its source and the hash of the source, of every
header it includes with quotes (``csrc/*.cuh``, followed recursively), and of
the flags, in ``tpudepth_torch/_build/``; it is rebuilt whenever any of them
changes. Nothing is
built or loaded at import time. A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this process
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of tpudepth_torch "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return found


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def inputs(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file it includes with quotes, followed
    recursively (the headers of shared device code), in a fixed order."""
    seen: List[Path] = []
    todo = [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in inputs(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: another process never loads a partial .so
    build_logs[name] = out


def build(names: Iterable[str]) -> List[Path]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together. Returns the library paths."""
    names = list(names)
    targets = [_target(n) for n in names]
    procs = [(n, t, _start(n, t)) for n, t in zip(names, targets)
             if not t.is_file()]
    try:
        for n, t, p in procs:
            _finish(n, t, p)
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return targets


def sources() -> List[str]:
    """Names of every CUDA source of the package."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
