"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use and is keyed by a hash of the sources and
the flags, under ``build/torch_kernels/`` at the repository root.
:func:`build_all` starts one ``nvcc`` per source at once.
``csrc/<name>.cc`` is host C++ (the text parser), built by ``g++`` the
same way (:func:`build_host`, :func:`load_host`).

No ``--use_fast_math``: it lets the compiler fold away ``isnan``, and
the walk's NaN routing is part of its contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"

# the host library's flags, then the extra flag sets tried in order until
# one builds: -march=native and -fopenmp where the compiler and the CPU
# take them (the JAX package's native build tries the same)
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
GXX_EXTRAS = (["-march=native", "-fopenmp"], ["-fopenmp"],
              ["-march=native"], [])

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built from csrc/ at first use")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):   # headers a source may include
        h.update(p.name.encode())
        h.update(p.read_bytes())
    if not src.exists():
        raise FileNotFoundError(src)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source, or return None when it is built."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent builder sees all or none
    return log


def build_all(names: List[str]) -> Dict[str, str]:
    """Build every named source at once (one nvcc each, all started
    together); returns each build's compiler log ("" when cached)."""
    started = {n: _start(n) for n in names}
    return {n: ("" if s is None else _finish(n, s))
            for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib


def loaded() -> List[str]:
    """The libraries loaded so far: CUDA sources by name, host ones as
    ``host:<name>``."""
    return sorted(_libs)


def _host_target(name: str) -> Path:
    src = CSRC / f"{name}.cc"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(repr(GXX_EXTRAS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-host-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> str:
    """Build ``csrc/<name>.cc`` for the host with ``g++`` unless it is
    built; returns the compiler's log ("" when cached). Raises with every
    attempt's log when no flag set builds."""
    out = _host_target(name)
    if out.exists():
        return ""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; csrc/{name}.cc is "
                           "built for the host at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    logs = []
    for extra in GXX_EXTRAS:
        cmd = [gxx, *GXX_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cc")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode == 0:
            os.replace(tmp, out)   # atomic, as the CUDA builds
            return logs[-1]
    raise RuntimeError(f"g++ failed for csrc/{name}.cc with every flag "
                       "set:\n" + "\n".join(logs))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cc``, built on first
    use."""
    key = f"host:{name}"
    lib = _libs.get(key)
    if lib is None:
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                build_host(name)
                lib = ctypes.CDLL(str(_host_target(name)))
                _libs[key] = lib
    return lib
