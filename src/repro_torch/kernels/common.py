"""Shared kernel utilities: ``cdiv``, the device resolver, and the
builder/loader for the hand-written CUDA kernels under ``csrc/``.

Build route: each ``csrc/<name>.cu`` is compiled on first use by one
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
and loaded with ``ctypes``.  Libraries land in ``<repo>/build/`` under
a name that carries a digest of the source and flags, so an edited
source never loads a stale library.  ``build_kernels`` starts one
``nvcc`` per source, all together, and waits for all of them.

Dispatch rule (every wrapper in ``kernels/*/ops.py``): a CUDA tensor
goes to the kernel, or the wrapper raises; the plain PyTorch version
runs only for a tensor that lies on the CPU.  There is no fallback.
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

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another one.  With no CUDA and no explicit request this
    raises — the package never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(),
                          digest_size=6).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_kernels(names: Iterable[str],
                  force: bool = False) -> Dict[str, float]:
    """Compile every named source that has no current library (every
    one with ``force``), one ``nvcc`` per source started together;
    returns the seconds each build took (0.0 when the library was
    already current).  The compiler's ``-Xptxas -v`` report is kept
    beside each library as ``<name>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took: Dict[str, float] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and not force:
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load_kernel(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use),
    with ``signatures`` (``{function: (argtypes, restype)}``) applied
    once.  Every source also exports ``<name>_error_string``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned a CUDA
    error (a refused launch never runs, and a later synchronize would
    not report it)."""
    if err != 0:
        what = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {what}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
