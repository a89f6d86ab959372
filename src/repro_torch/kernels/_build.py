"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is one kernel with a plain C entry point.  At
first use every source is compiled by its own ``nvcc`` process, all
started together, into a shared library under ``kernels/build/``
(named by a hash of the sources and flags, so a changed source
rebuilds), and loaded with ``ctypes``.  Every pointer and the stream
pass as ``c_void_p``; every entry point returns ``cudaGetLastError()``
and a ``CudaKernel`` raises when that is not 0.

``CudaKernel`` is also where launches are counted: its ``launches``
integer and every open ``launch_audit()`` scope go up by one each time
it launches its kernel, and nowhere else.  A kernel may have variants
for other pixel types (``"u8"``: uint8 pixels, the C entry point
``<symbol>_u8``, the same template body in the same source); a variant's
launch counts under its kernel's ``launches`` and also under its own
entry of ``variant_launches``.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}     # source stem -> nvcc output (ptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch are built from "
            "kernels/csrc at first use and need the CUDA toolkit")
    return found


def build_all() -> float:
    """Compile every ``csrc/*.cu`` source that is not built yet, one
    ``nvcc`` per source, all in parallel, and load them.  Returns the
    seconds spent.  Safe to call again: built libraries are reused."""
    t0 = time.perf_counter()
    with _LOCK:
        sources = sorted(CSRC.glob("*.cu"))
        headers = sorted(CSRC.glob("*.cuh"))
        hdr_bytes = b"".join(h.read_bytes() for h in headers)
        pending = []
        for src in sources:
            if src.stem in _LIBS:
                continue
            digest = hashlib.sha256(src.read_bytes() + hdr_bytes
                                    + " ".join(NVCC_FLAGS).encode())
            out = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
            if out.is_file():
                _LIBS[src.stem] = ctypes.CDLL(str(out))
                continue
            pending.append((src, out))
        if pending:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src, out in pending:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                BUILD_LOG[src.stem] = log
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log}")
                    continue
                os.replace(tmp, out)
                _LIBS[src.stem] = ctypes.CDLL(str(out))
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


class LaunchAudit:
    """Counter bound to one ``launch_audit()`` scope."""

    __slots__ = ("count",)

    def __init__(self) -> None:
        self.count = 0


_AUDIT_STACK: contextvars.ContextVar[tuple[LaunchAudit, ...]] = \
    contextvars.ContextVar("repro_torch_launch_audits", default=())


@contextlib.contextmanager
def launch_audit():
    """Yield a ``LaunchAudit`` whose ``.count`` observes every kernel
    launch made inside the ``with`` block.  Scopes nest (an inner audit
    also feeds enclosing ones) and are thread-isolated."""
    audit = LaunchAudit()
    token = _AUDIT_STACK.set(_AUDIT_STACK.get() + (audit,))
    try:
        yield audit
    finally:
        _AUDIT_STACK.reset(token)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ARG = {"p": _P, "i": _I, "f": _F}


#: Suffix of each pixel-type variant's C entry point.
VARIANT_SUFFIX = {"f32": "", "u8": "_u8"}


def variant_of(pixels: torch.Tensor) -> str:
    """The variant a kernel runs for ``pixels``: "u8" for uint8, else
    "f32"."""
    return "u8" if pixels.dtype == torch.uint8 else "f32"


class CudaKernel:
    """One hand-written kernel: its C entry points in
    ``csrc/<source>.cu``, one per variant in ``variants``, and its launch
    count.  ``signature`` lists the argument kinds ("p" pointer, "i"
    int, "f" float), without the trailing stream; every variant takes
    the same arguments."""

    def __init__(self, source: str, symbol: str, signature: str,
                 variants: tuple[str, ...] = ("f32",)) -> None:
        self.source = source
        self.symbol = symbol
        self.signature = signature
        self.variants = variants
        self.launches = 0
        self.variant_launches = dict.fromkeys(variants, 0)
        self._fns: dict[str, object] = {}

    def reset(self) -> None:
        """Set every launch count of this kernel to 0."""
        self.launches = 0
        self.variant_launches = dict.fromkeys(self.variants, 0)

    def _entry(self, variant: str):
        if variant not in self._fns:
            build_all()
            fn = getattr(_LIBS[self.source],
                         self.symbol + VARIANT_SUFFIX[variant])
            fn.argtypes = [ARG[c] for c in self.signature] + [_P]
            fn.restype = _I
            self._fns[variant] = fn
        return self._fns[variant]

    def __call__(self, device: torch.device, *args,
                 variant: str = "f32") -> None:
        """Launch ``variant`` on ``device``'s current stream; raise on
        any error the launch reports.  Pointers are passed as Python
        ints."""
        if variant not in self.variants:
            raise ValueError(f"{self.symbol} has no {variant!r} variant "
                             f"(it has {self.variants})")
        fn = self._entry(variant)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}{VARIANT_SUFFIX[variant]}: CUDA launch "
                f"failed with error {err}")
        self.launches += 1
        self.variant_launches[variant] += 1
        for audit in _AUDIT_STACK.get():
            audit.count += 1


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """Check that a kernel's tensors are contiguous and on one CUDA
    device; return that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"kernel inputs must share one CUDA device, got {t.device} "
                f"and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev
