"""Builds and loads the CUDA kernels, and counts their launches.

Each ``csrc/<name>.cu`` (one library of one or more kernels) compiles on
its own with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/lib<name>-<digest>.so`` at the root of the checkout,
exposing a plain C interface that the wrappers call through ``ctypes``. The
digest covers the sources, the shared headers and the flags, so a stale
library is never loaded. Building happens at first use (or all at once, in
parallel, through ``build_all``); nothing is built when a module is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper issued: a wrapper
adds one right after its kernel was launched and nowhere else, so the count
shows whether a run really went through the kernel. Under a CUDA graph
capture a launch is only recorded, not run: ``recording_launches`` keeps
those counts apart, and each replay of the graph adds them
(``count_replay``), so ``LAUNCHES`` still counts launches that ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
KERNELS = ("quant_page", "transcode_page", "paged_attention", "dequant_page",
           "paged_quant_attention", "cxl_line", "decode_glue")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Dict[str, int] = {
    "quant_pages": 0,
    "transcode_pages": 0,
    "fused_tiered_attention": 0,
    "dequant_pages": 0,
    "paged_quant_attention": 0,
    "cxl_encode_pages": 0,
    "cxl_decode_pages": 0,
    "rmsnorm": 0,
    "qkv_epilogue": 0,
    "silu_mul": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}

# The launches of the capture under way (``recording_launches``), else None.
_RECORDED: Optional[Dict[str, int]] = None


def count_launch(kernel: str) -> None:
    (LAUNCHES if _RECORDED is None else _RECORDED)[kernel] += 1


@contextlib.contextmanager
def recording_launches():
    """Counts the launches made inside the block apart from ``LAUNCHES``
    and yields them: the launches a CUDA graph capture puts into the graph,
    which run only when it is replayed."""
    global _RECORDED
    _RECORDED = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _RECORDED
    finally:
        _RECORDED = None


def count_replay(launches: Dict[str, int]) -> None:
    """One replay of a graph that holds ``launches`` (per kernel)."""
    for k, n in launches.items():
        LAUNCHES[k] += n


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source at first use"
        )
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, str]:
    """Compile every kernel library that is missing, one ``nvcc`` per source,
    all started together. Returns {name: compiler output} for the sources
    compiled now (with ``verbose``, ``-Xptxas -v`` adds each kernel's
    registers, shared memory and spills). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def check_operand(kernel: str, name: str, t, dtypes, device, shape=None) -> None:
    """Validate one operand before its pointer reaches a kernel: a
    contiguous tensor of an accepted dtype (and shape) on the kernel's CUDA
    device, aligned for the element pairs the kernels load."""
    if not isinstance(dtypes, tuple):
        dtypes = (dtypes,)
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{kernel}: {name} must be contiguous and pair-aligned")


def check_aligned(kernel: str, name: str, t, nbytes: int) -> None:
    """Raise unless ``t``'s data pointer is aligned to the ``nbytes``-byte
    vectors its kernel loads or stores (the geometry is fixed by the shapes;
    no narrower path is taken for an odd pointer)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{kernel}: {name} must be {nbytes}-byte aligned for the kernel's "
                         f"vectors (data pointer {t.data_ptr():#x})")


def on_card(t) -> bool:
    """Whether a wrapper launches its kernel on ``t``: true for a CUDA
    tensor, which then launches or raises. A CPU or ``meta`` tensor takes
    the wrapper's plain version. The port's one choice of kernel or plain."""
    return t.device.type == "cuda"


def capturing(device) -> bool:
    """Whether a CUDA graph capture is under way on ``device``'s current
    stream (False on the CPU, where nothing is captured)."""
    import torch

    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
