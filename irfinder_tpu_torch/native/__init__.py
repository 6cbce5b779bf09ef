"""ctypes bindings to the port's host C++ components (csrc/host/).

Each component is one C++ source with a plain C interface, compiled with
``g++`` into ``irfinder_tpu_torch/_build/`` at first use with the flags of the
JAX package's native/<component>/Makefile (the decoder inflates BGZF itself and
links no compression library).  The library name carries a hash of
the source, the flags and the libraries, so an edited source builds anew; the
build writes a temp file and ``os.replace``s it, so a concurrent build never
loads a partial library.  A component with a standalone program (the trim
filter) builds it the same way, from the same source with
``-D<COMPONENT>_MAIN``, as its Makefile's executable target does.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC")

#: component -> (extra flags, libraries), as each Makefile has them; the
#: decoder brings its own inflater, so it links no compression library; the
#: table formatter renders row chunks on threads of its own
COMPONENTS = {
    "bamdecode": (("-pthread",), ()),
    "oracle": ((), ()),
    "tabfmt": (("-pthread",), ()),
    "trim": ((), ()),
    "winflat": ((), ()),
}


def _flags(component: str) -> tuple:
    extra, libs = COMPONENTS[component]
    return CXXFLAGS + extra, libs


def ensure_built(component: str, executable: bool = False) -> str:
    """Build ``component`` if the library (or, with ``executable``, the
    standalone program) for its current source is missing; returns its path.
    Raises RuntimeError when the build fails."""
    flags, libs = _flags(component)
    if executable:
        flags, name = flags + (f"-D{component.upper()}_MAIN",), component
    else:
        flags, name = flags + ("-shared",), f"lib{component}"
    src = os.path.join(SRC_DIR, f"{component}.cpp")
    h = hashlib.sha256(" ".join((CXX, *flags, *libs)).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    out = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}" + ("" if executable else ".so"))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(
        [CXX, *flags, "-o", tmp, src, *libs], capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"native build failed for {component}:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out
