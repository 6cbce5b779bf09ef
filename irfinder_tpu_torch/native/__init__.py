"""ctypes bindings to the port's host C++ components (csrc/host/).

Each component is one C++ source with a plain C interface, compiled with
``g++`` into ``irfinder_tpu_torch/_build/`` at first use with the flags of the
JAX package's native/<component>/Makefile.  The library name carries a hash of
the source, the flags and the libraries, so an edited source builds anew; the
build writes a temp file and ``os.replace``s it, so a concurrent build never
loads a partial library.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC")

#: component -> (extra flags, libraries), as each Makefile has them
COMPONENTS = {
    "bamdecode": (("-pthread",), ("-lz",)),
    "oracle": ((), ()),
    "tabfmt": ((), ()),
    "winflat": ((), ()),
}

_LIBDEFLATE_PROBE = (
    "#include <libdeflate.h>\n"
    "int main(){libdeflate_free_decompressor(libdeflate_alloc_decompressor());return 0;}\n"
)


@functools.lru_cache(maxsize=None)
def have_libdeflate() -> bool:
    """The bamdecode Makefile's compile-and-link probe: headers without a
    linkable library fall back to zlib instead of failing the link."""
    r = subprocess.run(
        [CXX, "-x", "c++", "-", "-ldeflate", "-o", os.devnull],
        input=_LIBDEFLATE_PROBE, capture_output=True, text=True,
    )
    return r.returncode == 0


def _flags(component: str) -> tuple:
    extra, libs = COMPONENTS[component]
    if component == "bamdecode" and have_libdeflate():
        extra, libs = extra + ("-DHAVE_LIBDEFLATE",), libs + ("-ldeflate",)
    return CXXFLAGS + extra, libs


def ensure_built(component: str) -> str:
    """Build ``component`` if the library for its current source is missing;
    returns the library path.  Raises RuntimeError when the build fails."""
    flags, libs = _flags(component)
    src = os.path.join(SRC_DIR, f"{component}.cpp")
    h = hashlib.sha256(" ".join((CXX, *flags, *libs)).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    lib = os.path.join(BUILD_DIR, f"lib{component}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    r = subprocess.run(
        [CXX, *flags, "-shared", "-o", tmp, src, *libs], capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"native build failed for {component}:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)
    return lib
