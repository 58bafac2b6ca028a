"""Build and load the port's CUDA kernels (``csrc/*.cu``) for ``sm_90a``.

Each source is compiled by its own ``nvcc`` process, all started together,
into an object file; the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library's name carries a hash
of the sources, the headers they include and the flags, so an edited source
is rebuilt on first use and an unchanged one is loaded as built. Output goes to ``conan_fgw_tpu_torch/_build``.
A build holds the directory's lock (``utils/filelock.py``): processes that
start at once (the ranks of a data-parallel run) build once, and none links
an object file another is still writing.

Nothing here runs at import time: ``load_library()`` builds on first call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from conan_fgw_tpu_torch.utils.filelock import locked

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("cfconv.cu", "cfconv_wgmma.cu", "cfconv_large.cu", "fgw.cu", "fgw_team.cu")
# headers the sources include: their bytes go into the library's hash too
HEADERS = ("wgmma_tf32.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# largest dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

_P, _I, _F, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
SIGNATURES = {
    # name: (restype, argtypes); every pointer and the stream are c_void_p
    "cfconv_fwd": (_I, [_P] * 10 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "cfconv_bwd": (_I, [_P] * 16 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "cfconv_partial_floats": (_I, [_I, _I]),
    "cfconv_slabs": (_I, [_I, _I]),
    "cfconv_fwd_wgmma": (_I, [_P] * 12 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "cfconv_bwd_wgmma": (_I, [_P] * 18 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "cfconv_wgmma_plan": (_I, [_I] * 8 + [_P]),
    "cfconv_bwd_large": (_I, [_P] * 17 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "cfconv_large_scratch_floats": (_Z, [_I, _I, _I]),
    "fgw_couplings": (_I, [_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _F, _I, _F, _P]),
    "fgw_smem": (_Z, [_I, _I]),
    "fgw_couplings_large": (_I, [_P] * 10 + [_I, _I, _I, _F, _F, _I, _F, _I, _F, _P]),
    "fgw_team_plan": (_I, [_I, _I, _I, _P]),
    "fgw_couplings_cluster": (_I, [_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _F, _I, _F, _P]),
    "fgw_cluster_limit": (_I, []),
    "fgw_cluster_rows": (_I, [_I]),
    "fgw_cluster_smem": (_Z, [_I, _I]),
    "fgw_cluster_active": (_I, [_I, _I]),
    "fgw_couplings_stream": (_I, [_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _F, _I, _F, _P]),
    "fgw_stream_limit": (_I, []),
    "fgw_stream_rows": (_I, [_I]),
    "fgw_stream_smem": (_Z, [_I, _I]),
    "fgw_stream_plan": (_I, [_I, _I]),
    "fgw_stream_active": (_I, [_I, _I]),
    "cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile (if needed) and return ``(library path, seconds spent)``.

    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``ptxas_<hash>.txt``.
    """
    tag = _digest()
    lib = BUILD_DIR / f"libconan_kernels_{tag}.so"
    if lib.exists():
        return lib, 0.0
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with locked(BUILD_DIR / ".lock"):
        if lib.exists():  # built by another process while this one waited
            return lib, time.perf_counter() - t0
        _compile(nvcc, tag, lib)
    return lib, time.perf_counter() - t0


def _compile(nvcc: str, tag: str, lib: Path) -> None:
    """Compile the sources in parallel and link ``lib`` (the build lock held)."""
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    report = []
    failed = []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        report.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(report))
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *(str(obj) for _, obj, _ in procs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
    (BUILD_DIR / f"ptxas_{tag}.txt").write_text("\n".join(report))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build on first use and load the kernels' shared library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
