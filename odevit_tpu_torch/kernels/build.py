"""Builds the CUDA sources under ``odevit_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, which is loaded with ``ctypes``.
Libraries go to ``build/odevit_tpu_torch/`` beside the package, named by a
hash of every file in ``csrc`` (a source may include another, and the
``.cuh`` headers), so an edited source or header is rebuilt. Several sources
build in parallel: one ``nvcc`` each, all started together. A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "odevit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of each source built by this process (register and
# shared-memory use, from ``-Xptxas -v``)
build_logs: Dict[str, str] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit (``CUDA_HOME``)."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        path = candidate if os.path.exists(candidate) else None
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    srcs = sources()
    # every file of csrc counts: a source includes others and headers
    text = b"".join(p.read_bytes() for p in sorted(CSRC.iterdir())
                    if p.is_file())
    digest = hashlib.sha256(srcs[name].name.encode() + text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, Path]:
    """Compile the listed sources (default: all) that have no current
    library. Returns {name: library path}; raises if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KeyError(f"no CUDA source for {missing} in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]
