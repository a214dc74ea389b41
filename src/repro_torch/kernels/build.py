"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by the
hash of their source and the shared headers (``csrc/*.cuh``), so an
edited source is rebuilt on first use and an unchanged one is loaded as it
is. ``build_all`` starts one ``nvcc`` per source at once and waits for all
of them.

Nothing here runs at import: the CPU tests import every module, and a
host without a card may have no ``nvcc`` at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

#: kernel name -> C functions it exports, with their ctypes signatures
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_double
SIGNATURES = {
    "dft_power": {"dft_power_launch": ([_P, _P, _I, _I, _I, _P], _I),
                  "dft_power_fft_launch": ([_P, _P, _P, _I, _I, _I, _P, _I,
                                            _P], _I)},
    "autocorr": {"autocorr_launch": ([_P, _P, _P] + [_I] * 6 + [_P], _I),
                 "autocorr_constants": ([_P], _I)},
    "dirty_delta": {"dirty_delta_launch": ([_P, _I, _P, _L, _P], _I)},
    "ssm_scan": {"ssm_scan_launch": ([_P] * 12, _I)},
    "flash_attention": {"flash_attention_launch": ([_P] * 6
                                                   + [_I, _I, _F, _P], _I)},
    "decode_attention": {"decode_attention_launch": ([_P] * 11 + [_F, _P],
                                                     _I)},
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """``nvcc`` from PyTorch's own toolkit lookup (``CUDA_HOME``, ``PATH``,
    the toolkit's default prefix), imported only when a build runs."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):       # shared headers
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Launch one ``nvcc`` into a temporary file; returns
    (name, process, temporary path, final path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path,
            out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)                     # atomic: readers see whole files
    return log


def build_all(names: Optional[List[str]] = None, *,
              verbose: bool = False) -> float:
    """Compile every kernel whose library is missing, all ``nvcc`` runs in
    parallel. Returns the wall seconds spent; prints the assembler's
    register/shared-memory report when ``verbose``."""
    names = list(SIGNATURES) if names is None else names
    t0 = time.perf_counter()
    with _LOCK:
        started = [_start(n) for n in names if not library_path(n).exists()]
        errors = []
        for job in started:
            try:
                log = _finish(*job)
                if verbose:
                    print(f"[nvcc {job[0]}]\n{log.strip()}")
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use, with argtypes set."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LOADED:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (args, res) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _LOADED[name] = lib
    return _LOADED[name]
