"""Build and load the port's native libraries.

Each CUDA source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded through ``ctypes``
(seconds to build, where a source that includes PyTorch's headers takes
minutes). The host sources, the frame format's codec (``host_codec.cpp``)
and the Parquet decoder (``rtpu_parquet.cpp``), compile the same way with
the host C++ compiler, with ``-DRTPU_WITH_ZSTD`` and libzstd where the
system has its header. Libraries build at first use, from the sources in the
package only, into ``_build/`` beside them; the file name carries a digest
of the source and the flags, so an edited source builds anew. ``build()``
starts one compiler per source, all together, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: library name -> its CUDA source under csrc/
SOURCES = {"murmur3": "murmur3.cu", "string_search": "string_search.cu"}
#: library name -> its host C++ source under csrc/
HOST_SOURCES = {"host_codec": "host_codec.cpp",
                "rtpu_parquet": "rtpu_parquet.cpp"}
_ZSTD_HEADER = Path("/usr/include/zstd.h")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit")


def host_cxx() -> str:
    for name in ("g++", "c++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler: building the port's host "
                       "libraries needs g++, c++ or clang++")


def _command(name: str, out: Path) -> List[str]:
    """The compile command of library ``name`` into ``out``."""
    if name in HOST_SOURCES:
        zstd = (["-DRTPU_WITH_ZSTD"] if _ZSTD_HEADER.is_file() else [])
        cmd = [host_cxx(), "-O3", "-fPIC", "-shared", "-std=c++17", *zstd,
               "-o", str(out), str(CSRC / HOST_SOURCES[name])]
        return cmd + (["-lzstd"] if zstd else [])
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / SOURCES[name])]


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        src, flags = CSRC / HOST_SOURCES[name], str(_ZSTD_HEADER.is_file())
    else:
        src, flags = CSRC / SOURCES[name], " ".join(NVCC_FLAGS)
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile the named libraries (default: every CUDA one) that are not
    built yet, with one compiler per source running at once. Returns, per
    library compiled, its build seconds and the compiler's output
    (``-Xptxas -v`` register and spill counts). Raises if any compile
    fails."""
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter(),
                         Path(cmd[0]).name)
    done: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, target, t0, compiler) in running.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: {compiler} exited {proc.returncode}\n"
                          f"{output}")
            continue
        os.replace(tmp, target)
        done[name] = (time.perf_counter() - t0, output)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
