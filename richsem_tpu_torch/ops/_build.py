"""Build the hand-written CUDA kernels, and the host codec, at first use and
load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds. The host route builds ``csrc/<name>.c`` (plain
C that runs on the CPU: the JPEG codec, ``jpeg_host.c``) with the host C
compiler instead (:func:`build_host`, :func:`load_host`), on every machine,
the CPU-only one included. The shared library goes to
``build/richsem_tpu_torch/<name>-<hash>.so`` at the root of the checkout,
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited kernel or header is rebuilt
and an unchanged one is reused. ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside it as ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU-only test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "richsem_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_CC = "cc"
HOST_FLAGS = ("-O2", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()  # the data loader's threads load the codec at once


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: cannot build the CUDA kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> str:
    """Path of the shared library for ``csrc/<name>.cu`` at its current source
    and headers."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; -> .so path."""
    so = library_path(name)
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(so[: -len(".so")] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so


def build_all(names: Sequence[str]) -> None:
    """Compile several sources at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(build, names))


def build_log(name: str) -> str:
    """nvcc's report for the current build of ``csrc/<name>.cu`` ('' if none)."""
    log = library_path(name)[: -len(".so")] + ".log"
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name))
    return _LIBS[name]


def host_library_path(name: str) -> str:
    """Path of the shared library for ``csrc/<name>.c`` at its current source
    and :data:`HOST_FLAGS`."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, f"{name}.c"), "rb") as f:
        h.update(f"{name}.c".encode() + b"\0" + f.read())
    h.update(" ".join((HOST_CC,) + HOST_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.c`` with the host C compiler (``cc -O2 -shared
    -fPIC``) unless an up-to-date build exists; -> .so path. Raises, naming
    the compiler, when it is missing or fails."""
    so = host_library_path(name)
    if os.path.isfile(so):
        return so
    cc = shutil.which(HOST_CC)
    if cc is None:
        raise RuntimeError(f"the host C compiler {HOST_CC!r} is not on PATH: cannot build "
                           f"csrc/{name}.c")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cc, *HOST_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.c")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{HOST_CC} failed for {name}.c (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.c``; cached per process."""
    with _HOST_LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build_host(name))
        return _LIBS[name]
