"""Build the port's native code from the package sources, at first use.

- CUDA kernels: one ``nvcc`` per ``csrc/*.cu`` into a shared library with a
  plain C interface for ``sm_90a`` (Hopper), loaded with ``ctypes``. The
  kernels load their tiles by TMA from tensor maps that the library
  encodes on the host with libcuda's ``cuTensorMapEncodeTiled``, reached
  at run time through the runtime's ``cudaGetDriverEntryPoint``
  (``cudaGetDriverEntryPointByVersion`` from CUDA 12.5; ``csrc/sm90.cuh``),
  so no library links ``-lcuda``.
- The rANS coder: ``g++`` on ``ops/cpp/onedc_rans.cpp``.

Libraries land in ``build/onedc_tpu_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of source, ``csrc/*.cuh`` headers and
flags: an edited source or header builds anew and a stale library is never
loaded. A library is written under a
temporary name and renamed into place, so concurrent processes that build the
same source do not see a half-written file. ``ptxas -v`` output (registers,
shared memory, spills) is kept beside each CUDA library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR.parent / "build" / "onedc_tpu_torch"

CUDA_SOURCES = {
    "flash_attention": PKG_DIR / "csrc" / "flash_attention.cu",
    "flash_attention_bwd": PKG_DIR / "csrc" / "flash_attention_bwd.cu",
    "conv3x3": PKG_DIR / "csrc" / "conv3x3.cu",
}
# headers the CUDA sources include: part of every CUDA library's hash
CUDA_HEADERS = sorted((PKG_DIR / "csrc").glob("*.cuh"))
RANS_SOURCE = PKG_DIR / "ops" / "cpp" / "onedc_rans.cpp"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pedantic",
             "-Werror", "-pthread", "-shared")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """nvcc of $CUDA_HOME (default: the toolkit's install prefix), else the
    one on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _library_path(name: str, src: Path, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    if src.suffix == ".cu":
        for header in CUDA_HEADERS:
            digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(compiler: str, name: str, src: Path,
             flags: Sequence[str]) -> Path:
    out = _library_path(name, src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.so")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_cuda(name: str) -> Path:
    return _compile(_nvcc(), name, CUDA_SOURCES[name], NVCC_FLAGS)


def build_rans() -> Path:
    return _compile(os.environ.get("CXX", "g++"), "onedc_rans", RANS_SOURCE,
                    GXX_FLAGS)


def build_all() -> Dict[str, Path]:
    """Build every kernel library and the rANS coder, all compilers started
    together (one process per source)."""
    jobs = {name: (build_cuda, name) for name in CUDA_SOURCES}
    jobs["onedc_rans"] = (build_rans,)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(fn, *args)
                for name, (fn, *args) in jobs.items()}
        return {name: fut.result() for name, fut in futs.items()}


def load_library(name: str, signatures: Dict[str, Tuple]) -> ctypes.CDLL:
    """Build (if needed) and load one library once per process, declaring
    ``signatures``: function name -> (restype, [argtypes])."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_rans() if name == "onedc_rans" else build_cuda(name)
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The ``ptxas -v`` lines of a built CUDA library (registers, spills)."""
    log = _library_path(name, CUDA_SOURCES[name], NVCC_FLAGS).with_suffix(
        ".log")
    return "\n".join(line for line in log.read_text().splitlines()
                     if "registers" in line or "spill" in line)
