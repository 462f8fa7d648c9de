"""Build the CUDA sources under ``repro_torch/csrc`` with nvcc at first use
and bind their plain C interfaces with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``<checkout>/build/repro_torch/<name>-<digest>.so`` (the directory is listed
in ``.gitignore``); the digest covers the source and the flags, so an edited
source never loads a stale library. Nothing is built or loaded at import:
the first kernel launch builds its library, and :func:`build` builds several
at once, one nvcc process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("dequant_matmul_2d.cu", "flexround_quant.cu", "qmatmul_int8.cu")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/"
                       "bin); the CUDA kernels of repro_torch build with it")


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> List[str]:
    """Compile every source whose library is missing, all nvcc processes in
    parallel; returns the sources built. The compiler's ``-Xptxas -v``
    report goes to ``<library>.log`` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    try:
        for src in sources:
            lib = library_path(src)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            log = open(lib.with_suffix(".log"), "w")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, lib, tmp, log,
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        for src, lib, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed ({rc}) on {src}:\n"
                    + lib.with_suffix(".log").read_text()[-4000:])
            os.replace(tmp, lib)
        return [p[0] for p in procs]
    finally:
        for _, _, _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


class CudaLibrary:
    """One csrc source, built at first use, its C functions bound by name.

    ``functions`` maps each exported C name to its argument types; every
    function returns a ``cudaError_t`` as int, and the source also exports
    ``<stem>_error_string(int)``. ``init`` names a function of no arguments
    that runs once, right after the library loads.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 init: Optional[str] = None):
        self.source = source
        self.functions = dict(functions)
        self.init = init
        self._lib = None

    def _load(self):
        if self._lib is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{Path(self.source).stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
            if self.init is not None:
                self._check(self.init, getattr(lib, self.init)())
        return self._lib

    def call(self, name: str, *args) -> None:
        """Launch ``name`` and raise if the launch reported a CUDA error."""
        self._check(name, getattr(self._load(), name)(*args))

    def _check(self, name: str, rc: int) -> None:
        lib = self._lib
        if rc != 0:
            msg = getattr(lib, f"{Path(self.source).stem}_error_string")(rc)
            raise RuntimeError(f"{name}: CUDA call failed with error {rc} "
                               f"({msg.decode()})")
