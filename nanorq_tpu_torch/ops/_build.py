"""Build and load the CUDA kernels of `csrc/`.

`nvcc` compiles every `csrc/*.cu` for sm_90a (Hopper), one process per
source, all started together, and links them into one shared library with a
plain C interface, loaded with ctypes -- no PyTorch headers, so a build
takes seconds.  The library lands in `nanorq_tpu_torch/_build/`
under a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads at once.  A missing `nvcc`, a failed build or a failed
load raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_lib = None
# what the last build or load did: {"seconds", "built", "path", "log"}
build_info: dict = {}


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME / $CUDA_PATH / /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), DEFAULT_CUDA_HOME):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _bind(lib) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.nrq_gather_xor.argtypes = [vp, i64, i64, vp, i64, i64, vp, i32, vp, vp]
    lib.nrq_gf2_matmul.argtypes = [i64, vp, i64, i64, i64, i64, vp, i64, i64, vp, i64, i32, vp]
    lib.nrq_gf256_m4r.argtypes = [i64, vp, i64, i64, i64, i64, vp, i64, i64, vp, i64, i32, vp]
    lib.nrq_gf256_logexp.argtypes = [i64, vp, i64, i64, i64, vp, i64, i64, vp, vp, vp, i64, i32, vp]
    lib.nrq_gather_v1.argtypes = [vp, i64, i64, vp, i64, i64, i32, i32, vp, vp, vp]
    lib.nrq_gather_v2.argtypes = [vp, i64, i64, vp, i64, i64, vp, i32, i32, vp, vp, vp, vp]
    lib.nrq_gather_db.argtypes = [vp, i64, i64, vp, i64, i64, i32, vp, vp, vp]
    for fn in (lib.nrq_gather_xor, lib.nrq_gf2_matmul, lib.nrq_gf256_m4r, lib.nrq_gf256_logexp,
               lib.nrq_gather_v1, lib.nrq_gather_v2, lib.nrq_gather_db):
        fn.restype = ctypes.c_int


def load():
    """The kernel library (built on first use); raises if it cannot be had."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs = sources()
        out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
        path = os.path.join(out_dir, "libnanorq_cuda.so")
        built, log = False, ""
        if not os.path.isfile(path):
            nvcc = find_nvcc()
            cu = [s for s in srcs if s.endswith(".cu")]
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cu]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, c],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for c, o in zip(cu, objs)]
            for c, p in zip(cu, procs):  # every compile is waited for, even after a failure
                out, _ = p.communicate()
                log += out
            bad = [(c, p.returncode) for c, p in zip(cu, procs) if p.returncode != 0]
            if bad:
                raise RuntimeError(f"nvcc failed on {bad}:\n{log}")
            r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True)
            log += r.stdout + r.stderr
            for o in objs:
                os.remove(o)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{log}")
            os.replace(tmp, path)  # atomic: concurrent builds never see a partial file
            built = True
        lib = ctypes.CDLL(path)
        _bind(lib)
        build_info.update(seconds=time.perf_counter() - t0, built=built, path=path, log=log)
        _lib = lib
        return lib
