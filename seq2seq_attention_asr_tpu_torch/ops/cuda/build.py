"""Build and bind the hand-written CUDA kernels.

Each source in ``seq2seq_attention_asr_tpu_torch/csrc/`` has a plain C
interface and is compiled by nvcc for ``sm_90a`` into its own shared
library under ``seq2seq_attention_asr_tpu_torch/_build/`` (listed in
.gitignore), at first use; kernels whose entry points share a source
share its library. The library name carries a digest of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edit rebuilds it
and an unchanged one is loaded as it is. A kernel may name preprocessor
macros to define, which builds its source into a library of its own
(part of a large source, compiled beside the rest). ``build_all`` starts
one nvcc per library at once.

Every C entry point takes device pointers, sizes and the caller's CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()`` right after the launch; ``Kernel.launch`` raises
on a nonzero code and counts the launches that went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class Kernel:
    """One CUDA source (built with the macros `defines` defined), its C
    entry point, and a count of its launches."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 defines: tuple = ()):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.defines = tuple(defines)
        self.flags = NVCC_FLAGS + [f"-D{d}" for d in self.defines]
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        text = self.source.read_bytes()
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            text += header.read_bytes()
        digest = hashlib.sha1(text + " ".join(self.flags).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _bind(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def helper(self, symbol: str, argtypes: list):
        """Another C function of the same library (building it first if
        needed), e.g. a query of the device that sizes a launch; calls
        of it are not launches."""
        if self._fn is None:
            build_all([self])
        fn = getattr(ctypes.CDLL(str(self.library_path())), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point (building it first if needed); raise
        on a launch error, count the launch otherwise."""
        if self._fn is None:
            build_all([self])
        rc = self._bind()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {rc}")
        self.launches += 1


def _start_build(source: Path, flags: List[str], out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def build_all(kernels: Iterable[Kernel]) -> List[Kernel]:
    """Build every library that is not built yet, one nvcc per library,
    all started together; then load every kernel."""
    kernels = list(kernels)
    started = {}
    for k in kernels:
        out = k.library_path()
        if out not in started and not out.exists():
            started[out] = (k.source, _start_build(k.source, k.flags, out))
    built = {}
    try:
        for out, (source, (proc, tmp, t0)) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source.name}:\n{log}")
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
            built[out] = (time.perf_counter() - t0, log)
    finally:
        for _, (_, (proc, _, _)) in started.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k in kernels:
        k.build_seconds, k.build_log = built.get(k.library_path(), (None, ""))
        k._bind()
    return kernels


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(name: str, t: torch.Tensor, shape, device: torch.device,
          dtype: torch.dtype = torch.float32) -> None:
    """What a kernel's entry point takes: `dtype` (float32, or bfloat16
    for the bf16 entries), contiguous, on its device, of `shape`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def io_dtype(t: torch.Tensor) -> torch.dtype:
    """The IO type of the entry a wrapper launches for input `t`: the
    bf16 entry's for bfloat16, else the float32 entry's, whose check
    refuses every other type."""
    return torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32


def widen(x: torch.Tensor) -> torch.Tensor:
    """x widened to float32 where it is bfloat16 (exactly), else x as it
    is: where a plain version takes a bf16 entry's inputs."""
    return x.float() if x.dtype == torch.bfloat16 else x


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even) and widened back: where a
    bf16 entry rounds a product's operand, the plain versions round."""
    return x.to(torch.bfloat16).float()


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when every one lies on a CUDA device (the kernel runs).
    Anything else is refused."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(types)}: the kernel takes CUDA tensors, its plain version CPU tensors")
