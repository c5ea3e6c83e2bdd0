"""Build the CUDA sources of ``tst_torch/csrc`` into one shared library.

The kernels have a plain ``extern "C"`` interface and are bound with ctypes,
so the library is compiled by ``nvcc`` alone (no PyTorch headers): seconds,
not minutes. Each ``.cu`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one library. It is built
at first use into ``tst_torch/_build/`` under a name keyed by a hash of the
sources, so a changed source rebuilds and a stale library is never loaded.
Only the sources in the package are used.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: Hopper with the architecture-specific features (wgmma, setmaxnreg)
GENCODE = "arch=compute_90a,code=sm_90a"


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc's output (ptxas resource usage)


_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from tst_torch/csrc at first use")


def nvcc_command(nvcc: str, srcs: List[Path], out: Path,
                 compile_only: bool = False) -> List[str]:
    """``nvcc`` linking ``srcs`` (sources or objects) into the shared library
    ``out``, or, with ``compile_only``, compiling one source to an object."""
    return [nvcc, "-gencode", GENCODE, "-std=c++17", "-O3",
            "-c" if compile_only else "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), *map(str, srcs)]


def library_path() -> Path:
    return BUILD_DIR / f"libtst_kernels_{source_hash()}.so"


def _run(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> BuildResult:
    """Compile the sources unless a library for this source hash exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_suffix(f".{tag}")
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    try:
        log = _run([nvcc_command(nvcc, [src], obj, compile_only=True)
                    for src, obj in zip(sources(), objs)])
        log += _run([nvcc_command(nvcc, objs, tmp)])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return BuildResult(out, seconds, log)


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of a CUDA tensor's device's current stream,
    as an int, through torch's raw-stream accessor: a fraction of a
    microsecond, against several for ``torch.cuda.current_stream``, which
    matters for the decode step's 168 small launches."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and then cached."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build().path))
    return _LIB
