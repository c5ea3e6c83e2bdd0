# The port's own copy of tst/native/fast_pack.py: the port imports nothing of
# tst, builds tst_torch/native/csrc/fast_pack.cpp and never loads the JAX
# package's library. tests/test_torch_native_pack.py holds the two to equal
# results.
"""ctypes binding + on-demand build of the native packing kernel.

Build model: compile ``csrc/fast_pack.cpp`` with the system g++ on first use
into ``tst_torch/_build/`` (gitignored), under a name keyed by a hash of the
source, the flags and the host's machine type, so a changed source rebuilds
and a library built elsewhere is never loaded (no pybind11; the C ABI +
ctypes keeps the binding dependency-free). The reference's ``-march=native``
is dropped: the loop is byte moves, and a library keyed by the machine type
alone must run on any CPU of that type. ``native_available()`` is False when
no compiler exists; ``tokenize_dataset(backend="auto")`` then keeps the
Python path and ``backend="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "fast_pack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """The library for this source, these flags and this machine type."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"libtst_fast_pack_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    """g++ into a temporary name, then an atomic rename: a concurrent
    process never loads half a file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load_so(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.pack_byte_batch.restype = ctypes.c_int
    lib.pack_byte_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    out = library_path()
    if not out.exists() and not _compile(out):
        _build_failed = True
        return None
    try:
        return _load_so(out)
    except (OSError, AttributeError):
        # an incompatible or damaged library: rebuild once, then give up
        # cleanly (callers keep the Python path)
        out.unlink(missing_ok=True)
        if _compile(out):
            try:
                return _load_so(out)
            except (OSError, AttributeError):
                pass
        _build_failed = True
        return None


def native_available() -> bool:
    global _lib
    if _lib is not None:
        return True
    if _build_failed:
        return False
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
    return _lib is not None


def pack_byte_batch(
    prompts: bytes,
    p_off: np.ndarray,  # int64 [n+1]
    targets: bytes,
    t_off: np.ndarray,  # int64 [n+1]
    L: int,
    pad_id: int,
    bos_id: int,
    eos_id: int,
    names: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """→ (tokens int32 [n,L], loss_mask f32 [n,L], answer_pos [n], lengths [n]).

    Exact semantics of the Python ByteTokenizer packing path (tested). A
    sample whose target nearly fills ``L`` raises ValueError naming it by
    ``names[i]`` (the sample id, as the Python path does), else by index."""
    if not native_available():
        raise RuntimeError("native fast_pack unavailable (no g++?)")
    n = len(p_off) - 1
    tokens = np.empty((n, L), np.int32)
    loss_mask = np.empty((n, L), np.float32)
    answer_pos = np.empty(n, np.int32)
    lengths = np.empty(n, np.int32)
    p_off = np.ascontiguousarray(p_off, np.int64)
    t_off = np.ascontiguousarray(t_off, np.int64)
    rc = _lib.pack_byte_batch(
        prompts, p_off.ctypes.data, targets, t_off.ctypes.data,
        ctypes.c_int64(n), ctypes.c_int64(L),
        ctypes.c_int32(pad_id), ctypes.c_int32(bos_id), ctypes.c_int32(eos_id),
        tokens.ctypes.data, loss_mask.ctypes.data,
        answer_pos.ctypes.data, lengths.ctypes.data,
    )
    if rc != 0:
        i = -rc - 1
        raise ValueError(f"sample {names[i] if names is not None else i}: "
                         f"target alone nearly fills bucket {L}")
    return tokens, loss_mask, answer_pos, lengths
