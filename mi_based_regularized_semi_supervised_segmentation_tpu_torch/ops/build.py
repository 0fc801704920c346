"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc and load them,
and its host C++ sources (``csrc/*.cpp``) with the host compiler.

Each source has a plain C interface and is compiled at first use into a
shared library under ``<repo>/build/torch_kernels/`` (CUDA) or
``<repo>/build/torch_host/`` (host), named after the source and a hash of its
text, of every header it includes from ``csrc/``, of the flags (and for the
host, of the compiler and the CPU), then loaded with ``ctypes``. A library is written to a
temporary file and renamed into place, so processes that build at the same
moment do not read each other's half-written files. Nothing is compiled at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shlex
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

HOST_BUILD_DIR = Path(PROJECT_PATH) / "build" / "torch_host"
# native/Makefile's flags: ISO C++17 (not gnu++17) keeps floating-point
# contraction off, which the host pipeline's bits rely on
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
HOST_LIBS = ("-lz",)

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


def cxx() -> list:
    """The host compiler: ``$CXX`` (split as a shell would), else g++."""
    return shlex.split(os.environ.get("CXX") or "g++")


def host_cpu() -> str:
    """The CPU that ``-march=native`` compiles for: the machine type and
    /proc/cpuinfo's first model name and flags (``Features`` on Arm) lines."""
    lines = [platform.machine()]
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for key in ("model name", "flags", "Features"):
            lines += [line for line in cpuinfo.read_text().splitlines()
                      if line.split(":", 1)[0].strip() == key][:1]
    return "\n".join(lines)


def host_library_path(name: str) -> Path:
    """``build/torch_host/lib<name>_<hash>.so`` for ``csrc/<name>.cpp``: the
    hash covers the source, the compiler, the flags and the host CPU, so a
    ``-march=native`` library is never loaded on another CPU."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join([*cxx(), *HOST_FLAGS, *HOST_LIBS]).encode())
    digest.update(host_cpu().encode())
    return HOST_BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with the host compiler unless its library
    is there; raises ``RuntimeError`` with the compiler's output if it fails."""
    path = host_library_path(name)
    if path.exists():
        return path
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*cxx(), *HOST_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cpp"), *HOST_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as error:  # no such compiler
        raise RuntimeError(f"{' '.join(cmd)}: {error}") from error
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited with {proc.returncode}: "
                           f"{build_logs[name].strip() or '(no output)'}")
    os.replace(tmp, path)
    return path
