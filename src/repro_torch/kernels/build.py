"""Build the port's CUDA sources and load them through ``ctypes``.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/repro_torch/`` at the root of the checkout.  The library's file name
carries the content hash of the source and of every ``csrc/*.cuh`` header it
may include, so a source is rebuilt only when it or a header changes.
PyTorch's own extension builder is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.

Nothing here runs at import time; :func:`load` builds on demand.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the source and the
    shared headers as they are now."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def start_build(name: str) -> subprocess.Popen | None:
    """Start compiling ``name`` unless its library is up to date; returns the process."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.out_path = out  # type: ignore[attr-defined]
    return proc


def finish_build(proc: subprocess.Popen | None) -> str:
    """Wait for a build from :func:`start_build`; returns nvcc's output, raises on failure."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)  # type: ignore[attr-defined]
    return log


def build_all() -> dict[str, str]:
    """Compile every source of ``csrc/`` that is not up to date, in parallel.

    Returns ``{name: nvcc output}``; the output holds ptxas's register and
    shared-memory report for each kernel.
    """
    procs = {name: start_build(name) for name in sorted(p.stem for p in CSRC.glob("*.cu"))}
    return {name: finish_build(proc) for name, proc in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            finish_build(start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


def bind(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """:func:`load`, with ``{function: (argtypes, restype)}`` declared on first use.

    Declare every pointer and the stream as ``ctypes.c_void_p``: an
    undeclared argument goes through as a 32-bit int and cuts the pointer.
    """
    lib = load(name)
    if not getattr(lib, "_bound", False):
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._bound = True
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error (``<name>_error_string`` names it)."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def current_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it, without
    making a Stream object on every launch (PyTorch's own compiler reads
    it the same way)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream
