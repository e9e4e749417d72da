"""Builds the port's CUDA kernels with nvcc, and its host C++ library with
the host compiler, and loads them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface. At first use, one nvcc
process per source compiles it for ``sm_90a``, all started together, and
one more links the objects into ``libcap2det_kernels.so``. The library
lives under ``build/torch_kernels/<hash>/`` at the repository root (listed
in ``.gitignore``), keyed by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so a changed
source builds anew and an unchanged one is reused. Nothing outside the
repository is used except the CUDA toolkit.

The host library (``csrc/host/*.cc``, selective search) is built by the
host C++ compiler alone, never by nvcc, with the flags of the JAX
package's ``native/Makefile``, into ``build/torch_host/<hash>/``, keyed by
the sources, the flags and the compiler's ``--version``: the same source,
flags and compiler give the same bits as the JAX package's library.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libcap2det_kernels.so"
HOST_SRC = CSRC / "host"
HOST_BUILD_ROOT = BUILD_ROOT.parent / "torch_host"
HOST_LIB_NAME = "libcap2det_host.so"
HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread"]
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_lock = threading.Lock()
_lib = None
_host_lib = None
build_info = {}
host_build_info = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def _sources():
    # csrc/*.cu only: the host sources under csrc/host/ never go to nvcc.
    return sorted(CSRC.glob("*.cu"))


def _key(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, tool="nvcc"):
    """Runs the commands concurrently; raises with the output of the first
    that fails. Returns their combined output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                "%s failed (%d): %s\n%s" % (tool, p.returncode, " ".join(cmd),
                                            out)
            )
    return "".join(outs)


def _build(sources, final_dir):
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources]
        log = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
             for src, obj in zip(sources, objs)]
        )
        log += _run_all(
            [[nvcc, "-shared", "-o", str(tmp / LIB_NAME),
              *[str(o) for o in objs]]]
        )
        (tmp / "build.log").write_text(log)
        try:
            os.rename(tmp, final_dir)
        except OSError:
            if not (final_dir / LIB_NAME).is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        key = _key(sources)
        final_dir = BUILD_ROOT / key
        t0 = time.perf_counter()
        built = not (final_dir / LIB_NAME).is_file()
        if built:
            _build(sources, final_dir)
        _lib = ctypes.CDLL(str(final_dir / LIB_NAME))
        build_info.update(
            key=key,
            built=built,
            seconds=time.perf_counter() - t0,
            sources=[str(s.relative_to(CSRC.parent.parent)) for s in sources],
            log=(final_dir / "build.log").read_text()
            if (final_dir / "build.log").is_file() else "",
        )
        return _lib


def _cxx():
    """The host C++ compiler: $CXX, else g++, else c++."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler found ($CXX, g++, c++): the host library "
        "cannot be built")


def _host_key(cxx, sources):
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(version.encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def host_library():
    """The loaded host library (``csrc/host/*.cc``), built first if needed
    by the host compiler. Raises when it cannot be built: there is no
    fallback."""
    global _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        cxx = _cxx()
        sources = sorted(HOST_SRC.glob("*.cc"))
        key = _host_key(cxx, sources)
        final_dir = HOST_BUILD_ROOT / key
        t0 = time.perf_counter()
        built = not (final_dir / HOST_LIB_NAME).is_file()
        if built:
            HOST_BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=HOST_BUILD_ROOT))
            try:
                log = _run_all([[cxx, *HOST_CXX_FLAGS, "-shared", "-o",
                                 str(tmp / HOST_LIB_NAME),
                                 *[str(s) for s in sources]]], tool=cxx)
                (tmp / "build.log").write_text(log)
                try:
                    os.rename(tmp, final_dir)
                except OSError:
                    if not (final_dir / HOST_LIB_NAME).is_file():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        _host_lib = ctypes.CDLL(str(final_dir / HOST_LIB_NAME))
        host_build_info.update(
            key=key, built=built, seconds=time.perf_counter() - t0,
            compiler=cxx,
            sources=[str(s.relative_to(CSRC.parent.parent)) for s in sources])
        return _host_lib


def function(name, argtypes):
    """A C function of the library with its argument types declared
    (pointers and the stream as c_void_p, so ctypes never truncates them
    to 32 bits) and an int return code."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def aligned(*tensors):
    """True when every tensor's data starts on a 16-byte boundary, as the
    kernels' 16-byte lanes need."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check(rc, name):
    """Raises if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, rc))
