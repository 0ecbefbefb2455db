"""Build and load the port's CUDA kernels.

Every ``pyvbmp_tpu_torch/csrc/*.cu`` is compiled with ``nvcc`` at the first
launch of any kernel in a process, into ``pyvbmp_tpu_torch/_build/`` (keyed
by a hash of the sources, the headers beside them and the flags; one nvcc per source, all run at once,
then one link), and the shared library is bound with ``ctypes``.  Each
kernel's C entry point returns 0 on a clean launch and the
``cudaGetLastError()`` code otherwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_library = None


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _bind(lib):
    """Declare each entry point's argument types: pointers and the stream
    as c_void_p (ctypes would cut them to 32-bit ints), sizes as c_int."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # leaves, outputs, chunk totals; T, size, N, chunks, L, offset, reverse
        "logsemiring_scan_f32": [vp] * 3 + [ci] * 7 + [vp],
        "kalman_plane_scan_f32": [vp] * 18 + [ci] * 7 + [vp],
        "kalman_lane_scan_f32": [vp] * 18 + [ci] * 7 + [vp],
        "weighted_outer_f32": [vp] * 4 + [ci] * 7 + [vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci


def build(csrc_dir, build_dir):
    """Build (once per hash of the sources and the ``*.cuh`` headers they
    include) every ``*.cu`` of ``csrc_dir`` into one shared library under
    ``build_dir`` and load it; returns the bound
    ``ctypes.CDLL``.  The compiler's report (registers, spills) is kept
    beside the library as ``<name>.log``, with each source's compile time."""
    sources = sorted(Path(csrc_dir).glob("*.cu"))
    headers = sorted(Path(csrc_dir).glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    build_dir = Path(build_dir)
    so = build_dir / f"libpyvbmp_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _find_nvcc()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]

        def compile_one(src, obj):
            t0 = time.perf_counter()
            done = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            took = f"nvcc {src.name}: {time.perf_counter() - t0:.1f} s\n"
            return done.returncode, done.stdout + took

        with ThreadPoolExecutor(len(sources)) as pool:
            results = list(pool.map(compile_one, sources, objs))
        logs = [log for _, log in results]
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = None
        if all(rc == 0 for rc, _ in results):
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            logs.append(link.stdout + link.stderr)
        so.with_suffix(".log").write_text("".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError(
                "building the CUDA kernels failed:\n" + "".join(logs)[-4000:]
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    return lib


def load_library():
    """The package's kernels (``csrc/`` built into ``_build/``), built and
    loaded once per process."""
    global _library
    if _library is None:
        _library = build(CSRC_DIR, BUILD_DIR)
    return _library
