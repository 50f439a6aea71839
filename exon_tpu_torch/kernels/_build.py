"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/`` (``*.cu``, with the ``*.cuh`` headers they share)
are compiled for ``sm_90a``, one ``nvcc`` per source, all started together,
and linked into one shared library with a plain C interface, loaded with
``ctypes``. Nothing enables fast math: the
float parse of ``parse_number.cu`` must round as the host does. The
library lands in ``build/exon_tpu_torch/<hash>/`` at the repository root,
where ``<hash>`` is a content hash of the sources, so an edited source is
rebuilt on its next use and an unchanged one is built once.

Nothing here runs at import time: the first kernel launch calls ``library()``.
CPU tensors never reach this module (each wrapper runs its plain twin for
them), so the CPU path needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "exon_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_F64 = ctypes.c_double
# argtypes of every C entry point; pointers and the stream are c_void_p so
# ctypes passes them at full width
SIGNATURES = {
    "exon_compact_mask": [_P, _I64, _P, _P, _U64, _U64, _P, _P, _P],
    "exon_gather_var_offsets": [_P, _P, _I64, _P, _P, _U64, _U64, _P, _P,
                                _P, _I64, _P, _P],
    "exon_gather_var_copy": [_P, _I64, _P, _P, _P, _I64, _I64, _I64, _P,
                             _P],
    "exon_like_match": [_P, _P, _I64, _P, _I32, _P, _I32, _P, _P],
    "exon_like_find": [_P, _P, _I64, _P, _I32, _P, _I32, _P, _P],
    "exon_hash_aggregate": [_I64, _I32, _P, _P, _P, _P, _I64, _I32, _I32,
                            _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P],
    "exon_expand_offsets": [_P, _I64, _P, _P, _U64, _U64, _P, _P, _I64, _P],
    "exon_expand_write": [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P],
    "exon_row_hash": [_P, _P, _I64, _P, _P],
    "exon_string_eq": [_P, _P, _I64, _P, _P, _P, _P, _I64, _P, _P, _I64, _P,
                       _P],
    "exon_sort_keys": [_P, _I32, _I64, _I32, _P, _P],
    "exon_line_index": [_P, _I64, _P, _P, _U64, _U64, _P, _I64, _P, _P],
    "exon_text_records": [_P, _I64, _P, _I64, _I64, _I32, _I32, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _U64, _P],
    "exon_gather_spans": [_P, _I64, _P, _P, _P, _I64, _I64, _I32, _I32, _P,
                          _P, _P],
    "exon_string_cmp": [_P, _P, _P, _I64, _P, _I32, _I32, _P, _P],
    "exon_parse_number": [_P, _P, _I64, _P, _I64, _I32, _P, _P, _P, _P],
    "exon_format_int_offsets": [_P, _P, _I64, _P, _P, _U64, _U64, _P, _P],
    "exon_format_int_write": [_P, _P, _I64, _P, _P],
    "exon_sw_score": [_P, _P, _I64, _P, _P, _I32, _I32, _P, _P, _P],
    "exon_count_bytes": [_P, _I64, _P, _I64, _P, _I32, _I32, _P, _P],
    "exon_map_bytes": [_P, _I64, _P, _I64, _P, _I32, _P, _P],
    "exon_map_bytes_widen": [_P, _I64, _P, _I32, _P, _P],
    "exon_map_bytes_narrow": [_P, _I64, _P, _P],
    "exon_list_bins_peak": [_P, _P, _P, _I64, _F64, _F64, _P, _P],
    "exon_list_bins_bins": [_P, _P, _P, _I64, _F64, _F64, _I32, _I32, _P,
                            _P],
    "exon_map_lookup": [_P, _P, _P, _P, _I64, _P, _I32, _P, _P],
    "exon_polya_tail": [_P, _I64, _P, _I64, _P, _I32, _I32, _P, _P, _P],
    "exon_span_concat_offsets": [_P, _I32, _P, _P, _I32, _I64, _I32, _P, _P,
                                 _U64, _U64, _P, _P, _I64, _P, _P],
    "exon_span_concat_write": [_P, _I32, _P, _P, _I32, _I64, _I32, _P, _P,
                               _I64, _I32, _P, _P],
    "exon_window_bounds": [_P, _I32, _I32, _I64, _P, _P, _U64, _U64, _P, _P,
                           _P],
    "exon_window_frame": [_P, _P],
    "exon_bucket_rank": [_I64, _P, _P, _P, _I32, _I32, _P, _P, _U64, _U64,
                         _P, _P, _P, _P],
    "exon_bucket_move": [_I64, _P, _P, _P, _I32, _I64, _I32, _P, _P],
}

_lib = None
build_log: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """A hash of the sources, the headers they include and the flags."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile the sources unless a library for their hash exists; returns
    its path. ``build_log`` records the seconds taken and nvcc's output."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libexon_tpu_torch_kernels.so"
    if lib_path.exists():
        build_log.update(seconds=0.0, cached=True, path=str(lib_path))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f".tmp{os.getpid()}"
    t0 = time.perf_counter()
    objs = [out_dir / f"{src.stem}{tag}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources(), objs)]
    output, failed = [], []
    try:
        for src, proc in zip(sources(), procs):
            _out, err = proc.communicate()
            output.append(err)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libexon_tpu_torch_kernels{tag}.so"
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, lib_path)
    build_log.update(seconds=time.perf_counter() - t0, cached=False,
                     path=str(lib_path), output="".join(output))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if status != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {status}")


def stream_of(tensor) -> int:
    """The raw handle of the current stream on the tensor's card (the call
    Triton's launcher makes; ``torch.cuda.current_stream`` would build a
    Stream object on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


def on_cuda(t, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device, since a wrapper has neither a kernel nor a twin for it."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for tensors on {t.device}")
