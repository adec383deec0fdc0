"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface. At first use they
are compiled for Hopper (``sm_90a``), one ``nvcc`` process per source,
all started together, linked into one shared library under ``_build/``
(named by a hash of the sources and flags, so an edited source rebuilds)
and loaded with ``ctypes``. Nothing is built or loaded at import: the
CPU tests import every module of the package on machines without
``nvcc`` or a card.

``LAUNCHES`` counts each kernel's launches; a wrapper adds one
(``count``) where it launches its kernel and nowhere else, so a run can
show that its main path went through the kernels. The counts are the
recorder's ``launch.<kernel>`` counters (``utils/trace.py``), which take
each count under a lock: classic loop closure's PGO launches from its own
thread. Inside ``recorded()`` a thread's launches are noted, not counted:
a CUDA graph's capture launches nothing, and its replays count what it
noted.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections.abc import MutableMapping
from pathlib import Path

import torch

from dpvo_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("corr", "segsum", "segsum_bf16", "spd_solve", "corr_window", "corr_sw_fused",
           "corr_v3_fused", "corr_bwd")


class _Launches(MutableMapping):
    """Each kernel's launches: the recorder's counters, read and set."""

    def __getitem__(self, name):
        if name not in KERNELS:
            raise KeyError(name)
        return trace.COUNTS.get("launch." + name, 0)

    def __setitem__(self, name, n):
        if name not in KERNELS:
            raise KeyError(name)
        trace.put("launch." + name, n)

    def __delitem__(self, name):
        raise TypeError("a kernel's launch count cannot be deleted")

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self):
        return len(KERNELS)

    def __repr__(self):
        return repr(dict(self))


LAUNCHES = _Launches()

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each entry point: every one returns cudaGetLastError()
_SIGNATURES = {
    # gmap, fmap1, fmap2, coords, ii1, jj1, valid, out,
    # E, Np, mem, C, H1, W1, H2, W2, is_bf16, clamp, stream
    "dpvo_corr_features": [_VP] * 8 + [_I] * 10 + [_VP],
    # g, fmap1, fmap2, coords, ii1, jj1, valid, df1, wins, boxes,
    # E, Np, mem, C, H1, W1, H2, W2, feat_bf16, g_bf16, stream
    "dpvo_corr_backward": [_VP] * 10 + [_I] * 10 + [_VP],
    # g, gmap, ii1, jj1_order, starts, wins, boxes, dfm1, dfm2,
    # mem, C, H1, W1, H2, W2, feat_bf16, g_bf16, stream
    "dpvo_corr_backward_maps": [_VP] * 9 + [_I] * 8 + [_VP],
    # f1, fmap, jj, valid, corner y, corner x, out, E, mem, H, W, C, stream
    "dpvo_corr_window": [_VP] * 7 + [_I] * 5 + [_VP],
    # f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf, out, E, mem, H, W, C, stream
    "dpvo_corr_sw_fused": [_VP] * 12 + [_I] * 5 + [_VP],
    "dpvo_corr_v3_fused": [_VP] * 12 + [_I] * 5 + [_VP],
    # payload, kd, order, out, partials, arrivals, E, K, Md, chunk, is_bf16, stream
    "dpvo_segment_sum": [_VP] * 6 + [_I] * 5 + [_VP],
    # S, y, x, n, stream
    "dpvo_spd_solve": [_VP] * 3 + [_I, _VP],
}

_lock = threading.Lock()
_lib = None
_recording = threading.local()   # .launches: the dict of an open recorded()


def count(name: str, n: int = 1):
    """n launches of kernel `name` (thread-safe), or noted in this
    thread's open ``recorded()``."""
    if name not in KERNELS:
        raise KeyError(name)
    noted = getattr(_recording, "launches", None)
    if noted is not None:
        noted[name] = noted.get(name, 0) + n
    else:
        trace.count("launch." + name, n)


@contextlib.contextmanager
def recorded():
    """Yields a dict that takes this thread's launches inside, by kernel,
    in place of the counters."""
    outer = getattr(_recording, "launches", None)
    _recording.launches = noted = {}
    try:
        yield noted
    finally:
        _recording.launches = outer


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library and return its path
    (a no-op when the library for these sources already exists). The
    compiler's resource report (``-Xptxas -v``) is kept beside it."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libdpvo_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib_path.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp_lib, lib_path)
    return lib_path


def load():
    """The loaded kernel library (built at first use). Raises when there
    is no card or no compiler: a CUDA request never falls back."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def require_cuda(name: str, *tensors):
    """Check that every tensor of a kernel request lies on one CUDA
    device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel takes CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def check(name: str, rc: int):
    """Raise on a failed launch (the C side returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
