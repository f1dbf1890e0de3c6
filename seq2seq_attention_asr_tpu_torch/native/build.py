"""Build the port's native C++ helpers into shared libraries (ctypes ABI).

Each source in this directory (``editdist.cpp``, ``packing.cpp``,
``flacdec.cpp``) is compiled by ``g++ -O3 -std=c++17 -shared -fPIC`` at
first use into ``seq2seq_attention_asr_tpu_torch/_build/`` (listed in
.gitignore), under a name that carries a digest of the source and the
flags, so an edit rebuilds it and an unchanged one is loaded as it is.
The compiler writes to a temporary name that is then renamed into place,
so that processes building the same library at once (test workers) never
load half a file. The JAX package's committed libraries are never
loaded.

Unlike the JAX package's helpers, which fall back to numpy quietly when
g++ is missing, a failed build raises RuntimeError with the compiler's
output. Usage: ``python -m seq2seq_attention_asr_tpu_torch.native.build``
builds all three.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
SOURCES = {"editdist": "editdist.cpp", "packing": "packing.cpp", "flacdec": "flacdec.cpp"}
# Seconds each library took to build in this process (absent: loaded as built).
BUILD_SECONDS: Dict[str, float] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    text = (HERE / SOURCES[name]).read_bytes() + " ".join(FLAGS).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha1(text).hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """The library `name`, compiled first if it is not built yet."""
    out = library_path(name)
    if out.exists():
        return out
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError(f"native {name}: g++ not found, the C++ helper cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *FLAGS, str(HERE / SOURCES[name]), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native {name}: g++ failed:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built at first use and loaded once."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def build_all() -> None:
    for name in SOURCES:
        build(name)


if __name__ == "__main__":
    build_all()
