"""Build and load the hand-written CUDA kernels of ``isegprobe_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``csrc/build/`` (git-ignored) under a name that hashes the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.

Building happens at first use, never at import: the CPU tests import every
module on machines without ``nvcc``. :func:`build` compiles several sources
at once, one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("attention", "layernorm", "edt", "mha", "jbu", "attn_variants",
           "quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# one entry of nvcc's -Xptxas -v report; the "Used N registers" line
# follows an entry function's properties, not a device function's
_PTXAS_ENTRY = re.compile(
    r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) bytes "
    r"spill stores, (\d+) bytes spill loads(?:\s*ptxas info\s*: Used (\d+) "
    r"registers)?")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: the name hashes the
    source, every shared header ``csrc/*.cuh`` (a source may include any of
    them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.
    Returns nvcc's output (the ptxas register and spill report, read by
    :func:`ptxas_entries`) for each source compiled by this call; raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            reports[name] = log
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {name}.cu (exit {proc.returncode}) ---\n"
                            f"{log}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return reports


def ptxas_entries(log: str) -> dict[str, dict]:
    """Per function of a :func:`build` report (nvcc ``-Xptxas -v``):
    registers (None where the report gives none), stack frame and spill
    bytes."""
    return {name: {"registers": int(regs) if regs else None,
                   "stack_bytes": int(stack), "spill_stores": int(stores),
                   "spill_loads": int(loads)}
            for name, stack, stores, loads, regs in
            _PTXAS_ENTRY.findall(log)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.iseg_error_string.argtypes = [ctypes.c_int]
            lib.iseg_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = lib.iseg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def current_stream(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` PyTorch is using for ``t``'s device (read
    without building a ``torch.cuda.Stream``: ~0.1 µs, not ~3)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
