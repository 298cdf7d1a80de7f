"""Builds a C++ source of the port into a shared library at first use.

The library goes to ``seevcn_torch/_build/<stem>-<hash>.so``, named by a
hash of the source and the flags, so that a changed source or flag builds
anew and an unchanged one is loaded as built. Used by the native IO
library (``utils/native_io.py``) and the JPEG decoder (``data/jpeg.py``).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def library_path(source: Path, flags: list[str], stem: str) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:12]}.so"


def build_shared(source: Path, flags: list[str], stem: str) -> Path:
    """Compile ``source`` with ``flags`` unless its current build exists (a
    temporary file, then os.replace, so that concurrent builders never load
    half a file). Raises if the source or g++ (or ``$CXX``) is missing or
    the compile fails."""
    out = library_path(source, flags, stem)
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler for {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out
