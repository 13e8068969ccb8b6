"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source is a plain C interface over its kernel (no PyTorch headers), so
one nvcc call takes seconds. It is compiled at first use for ``sm_90a``
into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build` starts one nvcc per source, all together, and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

from repro_torch.kernels import KERNELS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_NVCC.exists():
        return str(CUDA_NVCC)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where :func:`build` puts the shared library of kernel ``name``."""
    src = CSRC / KERNELS[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = tuple(KERNELS)) -> dict[str, str]:
    """Compile every kernel in ``names`` that is not built yet, one nvcc
    process per source started together. Returns each name's compiler
    output (``-Xptxas -v``: registers, shared memory, spills); a failed
    build raises with nvcc's output."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    logs = {n: library_path(n).with_suffix(".log") for n in names}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            text, _ = proc.communicate()
            logs[n].write_text(text)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n}: nvcc exit {proc.returncode}\n{text}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: (logs[n].read_text() if logs[n].exists() else "")
            for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
