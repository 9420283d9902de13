"""Native (C++) runtime components, loaded via ctypes.

Built on demand with g++ from the committed sources into the checkout's
cache directory (``g2o_tpu.utils.cache``); all callers must degrade
gracefully (pure-Python fallback) when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

from g2o_tpu.utils.cache import CACHE_ROOT

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


_SOURCES = ("fastparse.cpp", "symchol.cpp", "hostchol.cpp")


def _build_lib() -> str | None:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    cache = os.path.join(CACHE_ROOT, "native")
    os.makedirs(cache, exist_ok=True)
    out = os.path.join(cache, f"libg2o_native_{digest}.so")
    if os.path.exists(out):
        return out
    # concurrent builders (test workers) each write their own file and
    # rename it into place atomically
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", *srcs, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception as e:  # no compiler / failed build -> fallback
        print(f"g2o_tpu.native: build failed ({e}); using pure-Python IO",
              file=sys.stderr)
        return None


def get_lib():
    """The fastparse shared library, or None when unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.g2o_parse_file.restype = ctypes.c_void_p
    lib.g2o_parse_file.argtypes = [ctypes.c_char_p]
    lib.g2o_parse_buffer.restype = ctypes.c_void_p
    lib.g2o_parse_buffer.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.g2o_num_blocks.restype = ctypes.c_int
    lib.g2o_num_blocks.argtypes = [ctypes.c_void_p]
    lib.g2o_block_tag.restype = ctypes.c_char_p
    lib.g2o_block_tag.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.g2o_block_rows.restype = ctypes.c_long
    lib.g2o_block_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.g2o_block_cols.restype = ctypes.c_int
    lib.g2o_block_cols.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.g2o_block_copy.restype = None
    lib.g2o_block_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.g2o_free.restype = None
    lib.g2o_free.argtypes = [ctypes.c_void_p]
    # symbolic Cholesky analysis
    lib.g2o_symchol.restype = ctypes.c_void_p
    lib.g2o_symchol.argtypes = [ctypes.c_int32, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int32]
    lib.g2o_sym_nnz.restype = ctypes.c_int64
    lib.g2o_sym_nnz.argtypes = [ctypes.c_void_p]
    lib.g2o_sym_nlevels.restype = ctypes.c_int32
    lib.g2o_sym_nlevels.argtypes = [ctypes.c_void_p]
    for fn in ("g2o_sym_perm", "g2o_sym_parent", "g2o_sym_rows",
               "g2o_sym_depth"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.g2o_sym_colptr.restype = None
    lib.g2o_sym_colptr.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.g2o_sym_release.restype = None
    lib.g2o_sym_release.argtypes = [ctypes.c_void_p]
    # host scalar sparse Cholesky (numeric phase)
    lib.g2o_hostchol_sym.restype = ctypes.c_void_p
    lib.g2o_hostchol_sym.argtypes = [ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.g2o_hostchol_lnz.restype = ctypes.c_int64
    lib.g2o_hostchol_lnz.argtypes = [ctypes.c_void_p]
    lib.g2o_hostchol_factor.restype = ctypes.c_int32
    lib.g2o_hostchol_factor.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_double)]
    lib.g2o_hostchol_solve.restype = None
    lib.g2o_hostchol_solve.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_double)]
    lib.g2o_hostchol_release.restype = None
    lib.g2o_hostchol_release.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class HostCholesky:
    """Reusable host sparse-Cholesky handle over a fixed upper-CSC pattern
    (``native/hostchol.cpp``).  ``factor(Ax)`` + ``solve(b)`` per system;
    the symbolic structure is computed once."""

    def __init__(self, n: int, Ap, Ai):
        import numpy as np

        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.n = int(n)
        self._Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        self._Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        self._h = lib.g2o_hostchol_sym(
            self.n, self._Ap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._Ai.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not self._h:
            raise RuntimeError("hostchol symbolic phase failed")
        self.lnz = int(lib.g2o_hostchol_lnz(self._h))

    def factor(self, Ax) -> int:
        """0 on success, -(i+1) when not PD at scalar column i."""
        import numpy as np

        Ax = np.ascontiguousarray(Ax, dtype=np.float64)
        return int(self._lib.g2o_hostchol_factor(
            self._h, Ax.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))

    def solve(self, b):
        import numpy as np

        out = np.array(b, dtype=np.float64, copy=True)
        self._lib.g2o_hostchol_solve(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.g2o_hostchol_release(h)
            except Exception:
                pass
            self._h = None


def symbolic_analysis(n: int, pairs, min_size: int = 32):
    """Native symbolic block-Cholesky analysis (ordering + etree + exact L
    structure + level depths).  ``pairs``: (M, 2) int array of unique
    undirected off-diagonal block pairs.  Returns a dict of numpy arrays,
    or None when the native library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    pairs = np.ascontiguousarray(np.asarray(pairs, dtype=np.int32).reshape(-1, 2))
    h = lib.g2o_symchol(
        n, pairs.shape[0],
        pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), min_size)
    if not h:
        return None
    try:
        nnz = lib.g2o_sym_nnz(h)
        perm = np.empty(n, dtype=np.int32)
        parent = np.empty(n, dtype=np.int32)
        depth = np.empty(n, dtype=np.int32)
        colptr = np.empty(n + 1, dtype=np.int64)
        rows = np.empty(nnz, dtype=np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.g2o_sym_perm(h, perm.ctypes.data_as(i32p))
        lib.g2o_sym_parent(h, parent.ctypes.data_as(i32p))
        lib.g2o_sym_depth(h, depth.ctypes.data_as(i32p))
        lib.g2o_sym_colptr(
            h, colptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if nnz:
            lib.g2o_sym_rows(h, rows.ctypes.data_as(i32p))
        return {"perm": perm, "parent": parent, "depth": depth,
                "colptr": colptr, "rows": rows,
                "nlevels": int(lib.g2o_sym_nlevels(h))}
    finally:
        lib.g2o_sym_release(h)


def parse_blocks(path_or_text, *, is_text: bool = False):
    """Parse a .g2o-style file into ``{tag: (values (R, C) float64 NaN-padded,
    ncols (R,) int32)}`` using the native tokenizer.  Returns None when the
    native library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    if is_text:
        data = path_or_text.encode()
        h = lib.g2o_parse_buffer(data, len(data))
    else:
        h = lib.g2o_parse_file(os.fsencode(path_or_text))
    if not h:
        raise IOError(f"fastparse: cannot read {path_or_text!r}")
    try:
        out = {}
        for i in range(lib.g2o_num_blocks(h)):
            tag = lib.g2o_block_tag(h, i).decode()
            rows = lib.g2o_block_rows(h, i)
            cols = lib.g2o_block_cols(h, i)
            vals = np.empty((rows, cols), dtype=np.float64)
            ncols = np.empty((rows,), dtype=np.int32)
            lib.g2o_block_copy(
                h, i,
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ncols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            out[tag] = (vals, ncols)
        return out
    finally:
        lib.g2o_free(h)
