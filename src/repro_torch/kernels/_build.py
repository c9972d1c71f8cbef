"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into ``kernels/_build/``
(listed in ``.gitignore``).  The library name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale one is never
loaded.  All missing libraries are compiled together, one ``nvcc`` process
per source.  Nothing here falls back: a missing compiler or a failed build
raises ``RuntimeError`` with the compiler's output.

The launch functions return the ``cudaError_t`` of their launch; the
wrappers in ``kernels/ops.py`` raise when it is not 0.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# launcher name -> (source stem, exported launch function, argument types)
SIGNATURES = {
    "minmax_relax": ("minmax_relax", "minmax_relax_launch",
                     (_P, _P, _P, _I, _I, _I, _P)),
    "ell_superstep": ("ell_superstep", "ell_superstep_launch",
                      (_P,) * 8 + (_I,) * 5 + (_P,)),
    "column_fingerprints": ("column_fingerprints",
                            "column_fingerprints_launch",
                            (_P, _P, _P, _P, _P, _P, _I, _I, _P)),
    "panel_update": ("panel_update", "panel_update_launch",
                     (_P, _P, _P, _P) + (_I,) * 8 + (_P,)),
    "panel_update_mapped": ("panel_update", "panel_update_mapped_launch",
                            (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _P)),
    "panel_update_empty": ("panel_update", "panel_update_empty_launch",
                           (_I, _P)),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        (_P,) * 6 + (_I,) * 9 + (_F, _I) + (_L,) * 12
                        + (_P,)),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "flash_attention_bwd_launch",
                            (_P,) * 12 + (_I,) * 11 + (_F, _I) + (_L,) * 24
                            + (_P,)),
    "flash_attention_bwd_chunks": ("flash_attention_bwd",
                                   "flash_attention_bwd_chunks", (_I,) * 8),
    "rwkv6_scan": ("rwkv6_scan", "rwkv6_scan_launch",
                   (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "mamba_scan": ("mamba_scan", "mamba_scan_launch",
                   (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "rwkv6_scan_bwd": ("rwkv6_scan_bwd", "rwkv6_scan_bwd_launch",
                       (_P,) * 16 + (_I,) * 4 + (_P,)),
    "rwkv6_scan_bwd_saved": ("rwkv6_scan_bwd", "rwkv6_scan_bwd_saved",
                             (_I,)),
    "mamba_scan_bwd": ("mamba_scan_bwd", "mamba_scan_bwd_launch",
                       (_P,) * 20 + (_I,) * 4 + (_P,)),
    "mamba_scan_bwd_layout": ("mamba_scan_bwd", "mamba_scan_bwd_layout",
                              (_I,)),
}
# the sources, one library each
SOURCES = tuple(sorted({src for src, _, _ in SIGNATURES.values()}))

_LOCK = threading.Lock()
_FUNCS: Dict[str, object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under torch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME);"
                       " the repro_torch CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library (source stem) in ``names`` not built yet, all at
    once.  Returns {name: seconds} for the ones compiled (the wall time of
    the parallel build); the compiler's ``-Xptxas -v`` report of each lands
    in ``_build/<name>.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    dt = time.perf_counter() - t0
    return {name: dt for name in todo}


def launcher(name: str):
    """The ctypes launch function of kernel library ``name``, building the
    libraries first if needed."""
    with _LOCK:
        fn = _FUNCS.get(name)
        if fn is None:
            build()
            source, symbol, argtypes = SIGNATURES[name]
            lib = ctypes.CDLL(str(library_path(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[name] = fn
        return fn
