"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together, into an
object file; the objects link into one shared library with a plain C interface,
loaded with ``ctypes``. Nothing is built at import: the first CUDA launch (or an
explicit :func:`build`) does it. The library is named by a hash of the sources
and flags, under ``src/repro_torch/_build/`` (git-ignored), so an edited source
rebuilds and an unchanged one loads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("act_quantize.cu", "qgemm_w8a8.cu", "qgemm_decode.cu", "qgemm_wgmma.cu",
           "flash_attention.cu", "paged_attention.cu", "paged_attention_mma.cu",
           "dense_attention.cu", "dense_attention_spill.cu")
HEADERS = ("common.cuh", "hopper.cuh", "dense_attention.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points: name -> argtypes (every entry returns a cudaError_t as int)
SIGNATURES = {
    # x, x_dtype, bcol, alpha_ptr, alpha_val, row_max, q, a, M, K, rows_per_expert, bits,
    # body, splits, stream
    "repro_act_quantize": [_P, _I, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # qx, qw, a, sw, out, M, N, K, experts, vec_a, vec_b, stream
    "repro_qgemm_w8a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # qx, qw, a, sw, out, M, N, K, ldw, experts, splits, stream
    "repro_qgemm_w8a8_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # qx, qw, a, sw, out, M, N, K, ldw, experts, splits, stream
    "repro_qgemm_w8a8_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # qx, qw, a, sw, occ, out, M, N, K, vec_a, vec_b, stream
    "repro_qgemm_w8a8_sparse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qx, qw, a, sw, occ, out, M, N, K, ldw, splits, stream
    "repro_qgemm_w8a8_sparse_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qx, qw, a, sw, occ, out, M, N, K, ldw, splits, stream
    "repro_qgemm_w8a8_sparse_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qx, qw4, a, sw, out, M, N, K, group, experts, vec_a, vec_b, stream
    "repro_qgemm_w4a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # qx, qw4, a, sw, out, M, N, K, group, experts, splits, stream
    "repro_qgemm_w4a8_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # qx, qw4, a, sw, out, M, N, K, group, experts, splits, stream
    "repro_qgemm_w4a8_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, kv_len, dtype, B, H, Hkv, Sq, Sk, D, causal, window, softcap, scale, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                              _P],
    # q, q_dtype, k, v, kv_dtype, k_scale, v_scale, cur_len, q_len, o, scratch, B, W,
    # H, Hkv, T, D, rows, window, softcap, scale, stream
    "repro_dense_attention": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _F, _P],
    # q, q_dtype, k_pages, v_pages, kv_dtype, k_scale, v_scale, page_table, kv_len,
    # q_len, o, B, Hkv, R, D, P, ps, maxP, q_win, window, softcap, scale, stream
    "repro_paged_attention": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _F, _F, _P],
    # q, k_pages, v_pages, kv_dtype, k_scale, v_scale, page_table, kv_len, q_len, o,
    # part_acc, part_ml, B, Hkv, R, D, P, ps, maxP, q_win, n_parts, part_len, window,
    # softcap, scale, stream
    "repro_paged_attention_bf16": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # q, k_new, v_new, k_pages, v_pages, kv_dtype, k_scale, v_scale, page_table,
    # q_start, q_len, kv_len, o, part_acc, part_ml, Nt, B, Hkv, G, D, P, ps, maxP,
    # chunk_cap, n_parts, part_len, window, softcap, scale, stream
    "repro_ragged_prefill_bf16": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # q, q_dtype, k_new, v_new, k_pages, v_pages, kv_dtype, k_scale, v_scale,
    # page_table, q_start, q_len, kv_len, o, Nt, B, Hkv, G, D, P, ps, maxP, chunk_cap,
    # window, softcap, scale, stream
    "repro_ragged_prefill": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at first use")
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernels if the hashed library is missing. Returns (library
    path, compiler log; empty when the library was already built). ``verbose``
    adds ``-Xptxas -v`` (registers, shared memory and spills per kernel) to the
    log; it does not change the code, so it shares the library's name."""
    extra = ("-Xptxas", "-v") if verbose else ()
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"--- {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                               *(str(obj) for _, obj, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)       # atomic: a concurrent loader sees all or none
    return lib_path, "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError()``)."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
