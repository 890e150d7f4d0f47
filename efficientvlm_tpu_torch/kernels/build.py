"""Build and load the port's CUDA kernels (csrc/*.cu) for sm_90a.

At first use, each source is compiled by its own `nvcc` process (all started
together), the objects are linked into one shared library with a plain C
interface, and the library is loaded with ctypes. The library lives in
`build/kernels/<hash>/` under the repository root (git-ignored); the hash
covers every file in csrc/ and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is downloaded: only the
repository's sources and the CUDA toolkit's headers are used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
LIB_NAME = "libevlm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # image, w, bias, pos, cls, gamma, beta, out, batch, height, width, patch, d,
    # vec16, eps, stream
    "evlm_patch_embed": [_P] * 8 + [_I] * 6 + [_F, _P],
    # patches, w, bias, pos, gamma, beta, ws, out, batch, n_patches, k, d, vec16,
    # eps, stream
    "evlm_patch_embed_im2col": [_P] * 8 + [_I] * 5 + [_F, _P],
    # x, enc, wq, bq, wk, bk, wv, bv, wo, bo, key_bias, gates, ln_gamma, ln_beta,
    # ws_q, ws_k, ws_v, ws_ctx, ws_out, out, probs, pitch, batch, tq, s, d, de, heads,
    # head_dim, core, probs_rows, probs_ks, ln_route, vec16, gates16, ln_eps, stream
    "evlm_fused_attention": [_P] * 21 + [_I] * 14 + [_F, _P],
    # x, wq, bq, wo, bo, k_bank, v_bank, kv_rows, key_bias, gates, ws_q, ws_ctx, out,
    # n, batch, tq, s, d, heads, head_dim, vec16, gates16, stream
    "evlm_fused_attention_bank": [_P] * 13 + [_I] * 9 + [_P],
    # a, b, bias, row_add, c, period, out_f32, vec16, m, n, k, act, stream
    "evlm_gemm_bias": [_P] * 5 + [_I] * 7 + [_P],
    # x, w1, b1, w2, b2, gamma, beta, ws_inter, out, m, d, i, act, vec16_1, vec16_2,
    # eps, stream
    "evlm_fused_ffn": [_P] * 9 + [_I] * 6 + [_F, _P],
    # a, b, bias, row_add, residual, gamma, beta, out, period, group,
    # out_group_stride, out_offset, vec16, m, n, k, eps, stream
    "evlm_gemm_ln": [_P] * 8 + [_I] * 8 + [_F, _P],
    # n, gather
    "evlm_gemm_ln_clusters": [_I] * 2,
    # q, k, v, key_bias, gates, out, probs, pitch, batch, tq, s, heads, head_dim,
    # gates16, scale, stream
    "evlm_attn_core": [_P] * 7 + [_I] * 7 + [_F, _P],
    # q, k, v, key_bias, gates, out, probs, pitch, batch, tq, s, heads, rows, ks,
    # gates16, scale, stream
    "evlm_attn_probs": [_P] * 7 + [_I] * 8 + [_F, _P],
    # q, k, v, key_bias, gates, out, batch, tq, s, heads, gates16, scale, stream
    "evlm_attn_wgmma": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, bias, out, ws, tickets, dims (18 ints), scale, stream
    "evlm_flash_attention": [_P] * 8 + [_F, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> tuple[str, str, float]:
    """Compile csrc/*.cu into the hashed build directory unless it is there.
    Returns (library path, compiler log, build seconds; 0 when reused)."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(lib_path):
        with open(log_path) as f:
            return lib_path, f.read(), 0.0
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT)
    try:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, src[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, objs, failed = [], [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src}\n{out}")
            objs.append(obj)
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", *objs,
                               "-o", os.path.join(tmp, LIB_NAME)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        text = "\n".join(log)
        with open(os.path.join(tmp, "build.log"), "w") as f:
            f.write(text)
        try:
            os.rename(tmp, out_dir)
        except OSError:  # another process finished the same build first
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return lib_path, text, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build()[0])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
