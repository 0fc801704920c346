"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc and load them.

Each source has a plain C interface and is compiled at first use into a
shared library under ``<repo>/build/torch_kernels/``, named after the source
and a hash of its text, of every header it includes from ``csrc/`` and of the
flags, then loaded with ``ctypes``. Nothing is compiled at import time.
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
from typing import Dict, List, Sequence

from .. import PROJECT_PATH

SOURCE_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(PROJECT_PATH) / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes from ``csrc/``, directly
    or through another header (``#include "..."``), in the order first met."""
    files = [SOURCE_DIR / f"{name}.cu"]
    for path in files:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = SOURCE_DIR / inc.decode()
            if header.exists() and header not in files:
                files.append(header)
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources_of(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every missing library of ``names``, all nvcc processes at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            path = build([name])[name]
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
