"""Build and load the port's CUDA kernels (``gple_tpu_torch/csrc/*.cu``).

The sources have a plain C interface, so they compile with ``nvcc`` alone in
seconds (no PyTorch headers), one ``nvcc`` per source, all started together,
and link into one shared library, which is loaded with ``ctypes``.  The library goes to ``gple_tpu_torch/_build/``, named by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rbf_gram.cu", "rbf_predict.cu", "rbf_vjp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signatures of the exported launchers (pointers and the stream as void*)
_SIGNATURES = {
    "rbf_gram": [_P] * 4 + [_I] * 4 + [_L] * 8 + [_P],
    "rbf_predict_mean": [_P] * 6 + [_I] * 7 + [_L] * 11 + [_P],
    "rbf_gram_vjp": [_P] * 6 + [_I] * 4 + [_L] * 11 + [_P],
    "rbf_predict_vjp": [_P] * 7 + [_I] * 5 + [_L] * 14 + [_P],
}

_C_TYPES = {"int": _I, "long long": _L}


def c_prototypes(path: Path) -> dict:
    """name -> ctypes of each parameter, for every function that the
    ``extern "C"`` block of the source ``path`` defines."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    protos = {}
    for name, params in re.findall(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
        kinds = []
        for param in params.split(","):
            ctype = " ".join(param.split()[:-1])  # drop the parameter's name
            kinds.append(_P if "*" in ctype else _C_TYPES[ctype])
        protos[name] = kinds
    return protos


_lib = None
#: what the last build did: {"seconds": float, "log": str, "path": str}
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, the ``PATH``, or the toolkit's
    default install prefix; raises when there is none."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def compile_library(sources, target: Path, defines=()) -> str:
    """Compile ``sources`` (paths) into the shared library ``target``: one
    ``nvcc -c`` per source, all started together, then one link.  Returns the
    compilers' output; raises RuntimeError on a failed compile or link."""
    nvcc = find_nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = str(Path(tmp) / (Path(src).stem + ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen([nvcc, *flags, *defines, "-c", "-o", obj, str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = [(proc.communicate()[0], proc.returncode) for proc in procs]
        log = "".join(out for out, _ in outs)
        if any(rc != 0 for _, rc in outs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(target), *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    return log


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first use."""
    global _lib
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"gple_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    log = "cached"
    if not target.exists():
        # build beside the target and rename: a concurrent build never loads
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            log = compile_library([CSRC / s for s in SOURCES], Path(tmp))
        except RuntimeError:
            os.unlink(tmp)
            raise
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for prefix, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{prefix}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log, path=str(target))
    _lib = lib
    return lib
