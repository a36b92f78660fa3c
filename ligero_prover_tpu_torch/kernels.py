"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link.  The build
runs at first use, never at import, and is keyed on a hash of the sources,
headers and flags: an edited source gets a new library name, and an
unchanged one is loaded from ``build/`` without compiling.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception.
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
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signature of every entry point: (argtypes), all returning a cudaError_t
SIGNATURES = {
    # x, y, out, n, y_rows, mode (0 = mont_mul, 1 = mulmod), stream
    "ligero_mont_mul": (_P, _P, _P, _I64, _I64, _I32, _P),
    # state_in, pending_in, rows, state_out, pending_out, C, B,
    # has_pending, valid_count, planar (rows (8, B, C) instead of
    # (B, C, 8)), tile (columns per CTA: 32 or 128), stream
    "ligero_sha256_absorb": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                             _I32, _I32, _P),
    # x, tw (stage t0's plane), y, B, log2(N), in_n (DIT input width),
    # s (stages in the pass), dit, stream
    "ligero_planar_pass": (_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P),
    # x, x_limb_stride, y, y_limb_stride, y_div, z, z_limb_stride, out, n,
    # mode (0 addmod, 1 submod, 2 mont_mul, 3 mulmod, 4 mont_scalar,
    # 5 mulmod_fma: z + x*y; z is read in mode 5 only), stream
    "ligero_planar_eltwise": (_P, _I64, _P, _I64, _I64, _P, _I64, _P, _I64,
                              _I32, _P),
    # e, e_limb_stride, B, n, tri (T, 3) int32, T, pair (P, 2) int32, P,
    # out (8, T+P, n), stream: the quadratic test's terms
    "ligero_planar_quad_terms": (_P, _I64, _I64, _I64, _P, _I64, _P, _I64,
                                 _P, _P),
    # slots (64, X), tw, tw_limb_stride, tw_lbc, tw_lc (element i reads
    # tw[:, (i >> tw_lbc) << tw_lc | i & (2^tw_lc - 1)]; mode 1 only),
    # out (8, X), X, mode (0 final, 1 mid, 2 pack), stream
    "ligero_renorm": (_P, _P, _I64, _I64, _I64, _P, _I64, _I32, _P),
    # x (8, X), out (8, X), X, stream
    "ligero_digitize": (_P, _P, _I64, _P),
    # blocks, threads, stream: an empty kernel, the launch floor
    "ligero_empty": (_I32, _I32, _P),
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libligero_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact source set is already built.
    Records the wall time and the ``ptxas`` reports in :data:`build_info`."""
    out = library_path()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    tmp_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = tmp_dir / f"{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode, text) for s, p, text
              in zip(_sources(), procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{text}" for name, rc, text in failed))
    tmp = tmp_dir / out.name
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(o) for o in objs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log="".join(logs))
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
