"""JPEG decode at a target size on the host (the port's copy of
efficientvlm_tpu/data/fastjpeg.py over its own csrc/fastjpeg.cpp).

At first use the C++ extension is built with g++ and libjpeg into
build/fastjpeg/<hash>/ under the repository root (git-ignored; the hash
covers the source and Python's include path). Where the compiler, libjpeg's
headers or Python's are missing, decode_resize falls back to PIL's draft
mode (also a DCT-scaled decode) and a bilinear resize; available() says
whether the native decoder is the one in use and decoder() names it.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "fastjpeg.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "fastjpeg")

_lock = threading.Lock()
_state = {"tried": False, "mod": None, "why": ""}


def _compile() -> str:
    """The built extension's path (built if missing); raises OSError or
    subprocess.SubprocessError where it cannot be built."""
    include = sysconfig.get_paths()["include"]
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + include.encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, digest)
    out = os.path.join(out_dir, "_fastjpeg.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}", SOURCE, "-ljpeg",
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent build of the same source is harmless
    except subprocess.CalledProcessError as e:
        raise OSError(f"g++ failed: {e.stderr.strip().splitlines()[-1:]}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                spec = importlib.util.spec_from_file_location("_fastjpeg", _compile())
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _state["mod"] = mod
            except (OSError, ImportError, subprocess.SubprocessError) as e:
                _state["why"] = f"{type(e).__name__}: {e}"
        return _state["mod"]


def available() -> bool:
    """True when the native decoder is built and loaded."""
    return _load() is not None


def decoder() -> str:
    """The decoder decode_resize uses, and why where it is PIL's."""
    if available():
        return "fastjpeg (libjpeg, DCT-scaled decode + bilinear)"
    return f"PIL draft decode + bilinear (fastjpeg unavailable: {_state['why']})"


def decode_resize(data: bytes, out_h: int, out_w: int) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [out_h, out_w, 3]."""
    mod = _load()
    if mod is not None:
        buf = mod.decode_resize(data, out_h, out_w)
        return np.frombuffer(buf, np.uint8).reshape(out_h, out_w, 3)
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.draft("RGB", (out_w, out_h))
    img = img.convert("RGB").resize((out_w, out_h), Image.BILINEAR)
    return np.asarray(img)


def decode_resize_file(path: str, out_h: int, out_w: int) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_resize(f.read(), out_h, out_w)
