"""Build and load the port's hand-written CUDA kernels.

At first use every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and the
objects are linked into one shared library with a plain C interface. The
library is named by a hash of the sources, the headers and the flags (an
edited source rebuilds it), lives under ``build/epik_tpu_torch/`` at the
repository root, and is loaded with ``ctypes``.
Each C entry point takes pointers, sizes and the stream, launches on that
stream and returns ``cudaGetLastError()``; :func:`check` raises on a nonzero
value.

Nothing is built or imported when this module is imported: the CPU tests
import every module of the port on machines with no ``nvcc``.
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

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "KernelLibrary", "build_info",
           "check", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "epik_tpu_torch"
#: -fmad=false: no multiply-add is contracted into an FMA, so the finish
#: kernel's scores round exactly like the plain PyTorch version's
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float
_PROTOTYPES = {
    # (plane, cell, rows, perm, out, R, W, bw, scale, stream)
    "epik_rowgather_sum": [_VP, _INT, _VP, _VP, _VP, _INT, _INT, _INT, _F32, _VP],
    # (plane, cell, rows, perm, S, C, R, W, bw, stream)
    "epik_rowgather_sum_counts": [_VP, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    # (plane, cell, rows, perm, m, amb, amb64, A, slot, delta, out, R, W, bw, B, K, k,
    #  log_eps, scale, G, stream)
    "epik_rowgather_sum_topk": [_VP, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP,
                                _INT, _INT, _INT, _INT, _INT, _INT, _F32, _F32, _INT, _VP],
    # (plane, rows, perm, m, amb, amb64, A, slot, delta, out, R, W, bw, K, col0, k, log_eps,
    #  G, stream)
    "epik_rowgather_sum_cols": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP, _INT,
                                _INT, _INT, _INT, _INT, _INT, _F32, _INT, _VP],
    # (plane, cell, rows, perm, m, amb, amb64, A, slot, delta, hit, out, R, W, bw, B, K, k,
    #  log_eps, G, stream)
    "epik_rowgather_sum_counts_topk": [_VP, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _VP, _VP,
                                       _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _F32, _INT,
                                       _VP],
    # (plane, rows, perm, m, amb, amb64, A, slot, delta, hit, out, cnt, R, W, bw, K, col0, k,
    #  log_eps, G, stream)
    "epik_rowgather_sum_counts_cols": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP,
                                       _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _F32, _INT,
                                       _VP],
    # (G, bw, B, K) -> bytes
    "epik_rowgather_shifted_group_smem": [_INT, _INT, _INT, _INT],
    "epik_rowgather_counts_group_smem": [_INT, _INT, _INT, _INT],
    # () -> bytes, or minus a CUDA error
    "epik_rowgather_group_smem_limit": [],
    # (G, bw, B, K, cell, cols) -> blocks an SM, or minus a CUDA error
    "epik_rowgather_shifted_group_blocks_per_sm": [_INT, _INT, _INT, _INT, _INT, _INT],
    "epik_rowgather_counts_group_blocks_per_sm": [_INT, _INT, _INT, _INT, _INT, _INT],
    # (R, B, K, variant, out int[3])
    "epik_finish_topk_layout": [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)],
    # (Sp, ld, m, out, R, B, K, k, log_eps, ws, blocks, stream)
    "epik_finish_topk": [_VP, ctypes.c_int64, _VP, _VP, _INT, _INT, _INT, _INT,
                         _F32, _VP, _INT, _VP],
    # (S, ld, C, ldc, m, out, R, B, K, k, log_eps, full, ws, blocks, stream)
    "epik_finish_topk_counts": [_VP, ctypes.c_int64, _VP, ctypes.c_int64, _VP, _VP, _INT,
                                _INT, _INT, _INT, _F32, _INT, _VP, _INT, _VP],
    # (bwl, K, counts, out int64[6])
    "epik_finish_cols_layout": [_INT, _INT, _INT, ctypes.POINTER(ctypes.c_int64)],
    # (S, ld, C, ldc, m, out, cnt, R, bwl, K, col0, k, log_eps, ws, blocks, cache_n, smem,
    #  stream)
    "epik_finish_cols_partial": [_VP, ctypes.c_int64, _VP, ctypes.c_int64, _VP, _VP, _VP, _INT,
                                 _INT, _INT, _INT, _INT, _F32, _VP, _INT, _INT, ctypes.c_int64,
                                 _VP],
    # (p, m, out, sq, R, PP, B, K, k, log_eps, scale, stream)
    "epik_accumulate_packed_topk": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
                                    ctypes.c_float, ctypes.c_float, _VP],
    # (p, out, R, PP, B, stream)
    "epik_accumulate_packed_sums": [_VP, _VP, _INT, _INT, _INT, _VP],
    # (b, s, S, C, R, PP, B, counts, stream)
    "epik_accumulate_sums": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    # (b, s, ptr, S, C, R, B, stream)
    "epik_accumulate_sums_csr": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
    # (B, counts, row_ptr, out int[5])
    "epik_accumulate_sums_layout": [_INT, _INT, _INT, ctypes.POINTER(_INT)],
    # (buf, combo, rows, lens, m, R, Lmax, k, stream)
    "epik_tokenize_combo": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
}
#: entry points that return something else than a CUDA error code
_RESTYPES = {
    "epik_rowgather_shifted_group_smem": ctypes.c_longlong,
    "epik_rowgather_counts_group_smem": ctypes.c_longlong,
    "epik_rowgather_group_smem_limit": ctypes.c_longlong,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class KernelLibrary:
    """The compiled kernel library, built and loaded once per process.

    ``load`` runs under a lock: the pipeline places batches from several
    worker threads at once, and only one of them may run ``nvcc``."""

    def __init__(self, csrc: Path = CSRC, build_dir: Path = BUILD_DIR):
        self.csrc = csrc
        self.build_dir = build_dir
        self._lock = threading.Lock()
        self._lib = None
        #: seconds spent in nvcc by this process (0.0 when the hashed
        #: library was already on disk), and nvcc's output (-Xptxas -v)
        self.build_seconds: float | None = None
        self.build_log = ""

    def sources(self) -> list[Path]:
        return sorted(self.csrc.glob("*.cu"))

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted([*self.sources(), *self.csrc.glob("*.cuh")]):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return self.build_dir / f"libepik_tpu_torch_{h.hexdigest()[:16]}.so"

    def _compile(self, out: Path) -> None:
        """One nvcc per source, all running at once, then one link."""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in self.sources():
            obj = self.build_dir / f"{tag}.{src.stem}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        self.build_log = "".join(logs)
        failed = [(src.name, p.returncode, log) for src, p, log
                  in zip(self.sources(), procs, logs) if p.returncode != 0]
        if not failed:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
            self.build_log += link.stdout + link.stderr
            if link.returncode != 0:
                failed.append(("link", link.returncode, link.stdout + link.stderr))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        os.replace(tmp, out)  # atomic: another process never loads half a file

    def load(self):
        with self._lock:
            if self._lib is None:
                out = self.path()
                t0 = time.monotonic()
                if not out.exists():
                    self._compile(out)
                self.build_seconds = time.monotonic() - t0
                lib = ctypes.CDLL(str(out))
                for name, argtypes in _PROTOTYPES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _RESTYPES.get(name, ctypes.c_int)
                lib.epik_cuda_error_string.argtypes = [ctypes.c_int]
                lib.epik_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib


_LIBRARY = KernelLibrary()


def library():
    """The loaded kernel library (built on first call)."""
    return _LIBRARY.load()


def build_info() -> KernelLibrary:
    """The process's kernel library object (build time and nvcc output)."""
    return _LIBRARY


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().epik_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
