"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The build happens on
first use, into ``build/kernels/`` beside the package (listed in
``.gitignore``); the library's name carries a hash of its source, of
every header of ``csrc/`` it includes (``#include "..."``, followed
recursively) and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused. A comparison build (another revision's
sources, or extra ``-D`` defines) lands beside them under its own hash.
``nvcc -Xptxas -v`` prints each kernel's registers, shared memory and
spills; its output, and the seconds nvcc took, is kept beside the
library as ``<library>.log``.

Flags: ``sm_90a``, no ``--use_fast_math`` and ``-fmad=false``, so the
kernels round every operation as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str, csrc: Path | None = None) -> list:
    """``<csrc>/<name>.cu`` (``csrc/`` of the package by default) and every
    header of that directory it includes, directly or through another
    header, in first-include order."""
    csrc = CSRC_DIR if csrc is None else Path(csrc)
    found, todo = [], [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo.extend(csrc / inc.decode()
                    for inc in _INCLUDE.findall(path.read_bytes()))
    return found


def library_path(name: str, csrc: Path | None = None,
                 defines=()) -> Path:
    """Where the library of ``<csrc>/<name>.cu`` built with the extra
    ``-D`` ``defines`` lies: its name hashes the sources, the flags and
    the defines."""
    h = hashlib.sha1()
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join([*NVCC_FLAGS, *(f"-D{d}" for d in defines)]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, csrc: Path | None = None, defines=()) -> Path:
    """Compile ``<csrc>/<name>.cu`` (with ``-D`` each of ``defines``)
    unless its library is already built; returns the library's path.
    Raises with nvcc's output on failure."""
    csrc = CSRC_DIR if csrc is None else Path(csrc)
    lib = library_path(name, csrc, defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-o", str(tmp), str(csrc / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
    log += f"nvcc took {time.perf_counter() - t0:.1f} s\n"
    Path(str(lib) + ".log").write_text(log)
    os.replace(tmp, lib)
    return lib


def build_all(specs) -> list:
    """Build several libraries at once, one nvcc each; ``specs`` are
    ``(name, csrc, defines)`` as :func:`build` takes them. Returns their
    paths in order."""
    specs = list(specs)
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        return list(pool.map(lambda spec: build(*spec), specs))


def build_log(name: str, defines=()) -> str:
    """nvcc's ``-Xptxas -v`` report of the built library."""
    return Path(str(library_path(name, defines=defines)) + ".log").read_text()


class CudaLaunchError(RuntimeError):
    """A kernel launcher returned a CUDA error; ``code`` is the
    ``cudaError_t`` (``utils/resilience.py`` sorts it)."""

    def __init__(self, kernel: str, code: int):
        super().__init__(f"{kernel} kernel launch failed: CUDA error {code}")
        self.kernel = kernel
        self.code = int(code)


def check_launch(kernel: str, err: int) -> None:
    """Raises :class:`CudaLaunchError` unless ``err`` (a launcher's
    ``cudaError_t``) is 0."""
    if err != 0:
        raise CudaLaunchError(kernel, err)


def check_cuda(*tensors) -> None:
    """Raises unless every tensor lies on a CUDA device: a kernel reads
    device pointers only."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got one on "
                             f"{t.device}")


def abi(lib: ctypes.CDLL, symbol: str) -> int:
    """The launch interface's version that ``lib`` exports as ``symbol``
    (an ``int symbol()``); 1 where it exports none, as the libraries did
    before their interfaces carried a version."""
    if not hasattr(lib, symbol):
        return 1
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [], ctypes.c_int
    return int(fn())


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with the extra
    ``-D`` ``defines``, built on first use."""
    lib = _loaded.get((name, tuple(defines)))
    return lib if lib is not None else load_all([(name, defines)])[0]


def load_all(specs) -> list:
    """The loaded libraries of ``specs`` (``(name, defines)`` each, as
    :func:`load` takes them), in order; those not built yet are built
    together (:func:`build_all`), so that a render which needs several
    waits for one compiler and not one after another."""
    keys = [(name, tuple(defines)) for name, defines in specs]
    with _lock:
        todo = [key for key in dict.fromkeys(keys) if key not in _loaded]
        if todo:
            paths = build_all((name, None, defines) for name, defines in todo)
            for key, path in zip(todo, paths):
                _loaded[key] = ctypes.CDLL(str(path))
        return [_loaded[key] for key in keys]
