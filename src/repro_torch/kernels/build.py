"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source under ``kernels/<family>/csrc/`` exposes a plain C
interface, so it compiles in seconds without PyTorch's headers into
``build/torch_kernels/<stem>-<hash>.so`` at the root of the checkout. The
hash covers the source and the flags, so an edited source never loads a
stale library. Nothing builds at import time: a kernel's wrapper calls
:func:`load` at its first launch, and ``chip_smoke.py`` calls :func:`build`
on every source at once to compile them in parallel. :func:`load` is safe
to call from many threads: the first caller builds and loads, the others
wait for it.
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
from pathlib import Path
from typing import Dict, Iterable

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}
# held around the check, the build and the load: two threads reaching a
# kernel's first launch together would otherwise both run nvcc into the
# same temporary file, and one's cleanup would delete the other's output
_LOAD_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump``, beside the ``nvcc`` that builds."""
    path = Path(nvcc()).parent / "cuobjdump"
    if not os.access(path, os.X_OK):
        raise RuntimeError(f"cuobjdump not found beside {nvcc()}")
    return str(path)


# "/*0a50*/  @P0 HMMA.1688.F32.TF32 R4, R8, R12, R4 ;" -> "HMMA.1688..."
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z][\w.]*)")


def count_sass(library: Path, opcode: str) -> int:
    """How many SASS instructions of a library have an opcode starting
    with ``opcode`` (as ``HMMA``, a tensor-core product), by
    ``cuobjdump -sass``."""
    out = subprocess.run([cuobjdump(), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return sum(1 for m in _SASS_OPCODE.finditer(out)
               if m.group(1).startswith(opcode))


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:12]}.so"


def build(sources: Iterable[Path]) -> Dict[Path, dict]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns ``{source: {"library", "seconds",
    "log"}}``; ``log`` holds ptxas's register and shared-memory report.
    Raises RuntimeError naming the source if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[Path, dict] = {}
    running = []
    t0 = time.perf_counter()
    try:
        for src in sources:
            src = Path(src)
            lib = library_path(src)
            if lib.exists():
                out[src] = {"library": lib, "seconds": 0.0, "log": ""}
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((src, lib, tmp, proc))
        for src, lib, tmp, proc in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, lib)
            out[src] = {"library": lib,
                        "seconds": time.perf_counter() - t0, "log": log}
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing.
    Concurrent callers build it once."""
    lib = library_path(source)
    with _LOAD_LOCK:
        if lib not in _LOADED:
            build([source])
            _LOADED[lib] = ctypes.CDLL(str(lib))
        return _LOADED[lib]
