"""Kernel selection, launch counters and the CUDA build of the port.

**Selection follows the tensor's device** (the port's counterpart of
``repro/kernels/backend.py``'s lowering plans):

* a CUDA tensor launches the hand-written kernel, or the wrapper raises —
  there is no fallback;
* a CPU tensor runs the kernel's plain PyTorch version;
* ``kernel_backend="ref"`` asks for the plain version even on the card.  Only
  comparison runs use it (``chip_smoke.py`` holds each kernel against its
  plain version on the same inputs).

**Build.**  Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/repro_torch/``
at the root of the source checkout the package runs from (for an installed
copy, under the working directory), named by a hash of the sources and
flags, and are built at first use; :func:`build` compiles every missing one
with all ``nvcc`` processes started together.

**Launch counters.**  Every kernel has a plain integer count that its wrapper
bumps once per launch and nowhere else, so a run can show that its main path
went through the kernels (:func:`launch_counts`, :func:`reset_launch_counts`).

**Threads.**  A server launches from its dispatch thread while the main
thread may launch too (sampling queries decodes from the index).  One lock
serializes building and loading the libraries, so two threads never start
``nvcc`` on the same output, and each kernel's counter is bumped under its
own lock.  Every thread launches on ``torch.cuda.current_stream()``, which is
per thread but, unless a caller sets another, the same default stream for
all of them: launches from different threads are ordered on that one stream,
so no cross-stream hazard arises.
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

import torch

KERNEL_BACKENDS = ("auto", "ref")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[3]
BUILD_DIR = (_CHECKOUT if (_CHECKOUT / "pyproject.toml").is_file()
             else Path.cwd()) / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# held while a library is built or loaded (re-entrant: loading builds)
_BUILD_LOCK = threading.RLock()


def check_kernel_backend(kernel_backend: str) -> None:
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                         f"got {kernel_backend!r}")


def use_kernel(t: torch.Tensor, kernel_backend: str = "auto") -> bool:
    """True: launch the CUDA kernel on ``t``'s card.  False: run the plain
    version — because ``t`` lies on the CPU, or because the caller asked for
    ``"ref"``."""
    check_kernel_backend(kernel_backend)
    if t.device.type == "cuda":
        return kernel_backend == "auto"
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class CudaKernel:
    """One ``csrc`` source, its shared library and its launch counter."""

    def __init__(self, name: str, source: str, argtypes: tuple):
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._err = None
        self._count_lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _load(self):
        with _BUILD_LOCK:
            if self._fn is not None:          # another thread loaded it
                return
            path = self.library_path()
            if not path.exists():
                build([self])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = (ctypes.c_int,)
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn                      # last: published when ready

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the current stream and
        returns ``cudaGetLastError()``), raise on an error, count the launch."""
        if self._fn is None:
            self._load()
        code = self._fn(*args, stream())
        if code != 0:
            raise RuntimeError(f"{self.name}: CUDA error {code}: "
                               f"{self._err(code).decode()}")
        with self._count_lock:
            self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int
# levels: (data, counts, n_blocks, length) x 3, block; then the word tables
_LEVEL_ARGS = (_P, _P, _I, _I) * 3 + (_I,)
_TABLE_ARGS = (_P, _P, _P, _P)

WAVELET_COUNT = CudaKernel(
    "wavelet_count", "wavelet_descent.cu",
    _LEVEL_ARGS + _TABLE_ARGS + (_P, _P, _P, _P, _I, _P))
BEAM_LOOP = CudaKernel(
    "beam_loop", "beam_step.cu",
    _LEVEL_ARGS + _TABLE_ARGS
    + (_P, _I, _I)                    # sep_pos, n, n_docs
    + (_P, _P, _P, _I)                # words, wmask, idf_w, Q
    + (_P, _P, _P, _P, _P, _I)        # pool scores/d0/d1/tf/size, cap
    + (_P, _P, _I)                    # out_docs, out_scores, k
    + (_P, _P, _P, _P, _P)            # n_out, iters, pops, overflowed, status
    + (_I, _I, _I, _I, _P, _P))       # conjunctive, max_pops, max_trips, B,
                                      # summaries, stream
# one bytemap level: (data, counts, n_blocks, length, block)
_BYTEMAP_ARGS = (_P, _P, _I, _I, _I)
BYTE_RANK = CudaKernel(
    "byte_rank", "byte_rank.cu",
    _BYTEMAP_ARGS + (_P, _P, _P, _I, _P))   # bytes, pos, out, M, stream
SEGMENT_TF = CudaKernel(
    "segment_tf", "segment_tf.cu",
    _BYTEMAP_ARGS + (_I, _P, _P, _I, _P))   # byte, bounds, out, D, stream
BITMAP_RANK1 = CudaKernel(
    "bitmap_rank1", "bitmap_rank.cu",
    # words, counts, n_blocks, n_bits, pos, out, M, stream
    (_P, _P, _I, _I, _P, _P, _I, _P))
SCORED_TOPK = CudaKernel(
    "scored_topk", "topk_score.cu",
    # cands, query, row_ok, B, C, d, dtype, k, vec, rs, su, sp, nslice, gx,
    # shmem, part_s, part_i, list_s, list_i, tickets, out_s, out_i, stream
    (_P, _P, _P) + (_I,) * 12 + (_P,) * 8)
_F = ctypes.c_float
DRB_WALK = CudaKernel(
    "drb_walk", "drb_walk.cu",
    _LEVEL_ARGS + _TABLE_ARGS
    + (_P, _P, _P, _I, _I)            # sep_pos, doc_len, occ, n, n_docs
    + (_P, _P, _I, _I, _P)            # bitmaps: words, counts, n_blocks,
                                      # n_bits, bit_off
    + (_P, _P, _P, _P, _P, _I)        # words, valid, idf_w, df_w, row_ok, Q
    + (_I, _P, _F, _F, _F, _F)        # bm25, avg_dl, 1 - b, b, k1 + 1, k1
    + (_I, _I, _I)                    # P, k, max_pops
    + (_P,) * 7                       # p, nd, top_s, top_d, it, cands, padded
    + (_I, _P, _I, _P))               # ws_bytes, scratch, B, stream
DRB_OR = CudaKernel(
    "drb_or", "drb_or.cu",
    _LEVEL_ARGS + _TABLE_ARGS
    + (_P, _P, _I)                    # sep_pos, doc_len, n_docs
    + (_P, _P, _I, _I, _P)            # bitmaps: words, counts, n_blocks,
                                      # n_bits, bit_off
    + (_P, _P, _P)                    # has_bm, df, idf
    + (_P, _P, _I, _I, _I)            # words, wmask, B, Q, cap
    + (_I, _P, _F, _F, _F, _F)        # bm25, avg_dl, 1 - b, b, k1 + 1, k1
    + (_I,)                           # k
    + (_P,) * 8                       # top_s, top_d, n_found, iters, pops,
                                      # overflowed, certified, bound
    + (_P, ctypes.c_longlong, _P))    # scratch, its ints, stream
WTBC_DECODE = CudaKernel(
    "wtbc_decode", "wtbc_decode.cu",
    _LEVEL_ARGS
    + (_P, _P, _P, _I, _I)            # offsets per level, s, c
    + (_P, _P, _I, _P))               # pos, out, M, stream
WTBC_LOCATE = CudaKernel(
    "wtbc_locate", "wtbc_locate.cu",
    _LEVEL_ARGS + _TABLE_ARGS
    + (_P, _P, _P, _I, _P))           # words, js, out, M, stream
KERNELS = (WAVELET_COUNT, BEAM_LOOP, BITMAP_RANK1, BYTE_RANK, SEGMENT_TF,
           SCORED_TOPK, DRB_WALK, DRB_OR, WTBC_DECODE, WTBC_LOCATE)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        with k._count_lock:
            k.launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def build(kernels=KERNELS) -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together.  Returns the wall seconds taken.  Each
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept next to its library as ``<library>.log``."""
    with _BUILD_LOCK:
        return _build(kernels)


def _build(kernels) -> float:
    t0 = time.perf_counter()
    todo = [k for k in kernels if not k.library_path().exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in todo:
        out = k.library_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / k.source)]
        procs.append((k, tmp, out, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for k, tmp, out, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            tail = out.with_suffix(".log").read_text()[-4000:]
            failed.append(f"{k.source}:\n{tail}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0
