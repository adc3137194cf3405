"""Build the CUDA sources with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

``-fmad=false`` keeps multiply and add separately rounded, as the plain
PyTorch versions compute them; ``--use_fast_math`` is never used (the
derived-feature columns are cancellation-prone). Libraries go into
``build/repro_torch_kernels/`` at the repository root, named by a hash
of their sources, so an edited source is rebuilt and a stale library is
never loaded. :func:`build` starts one nvcc per source, all at once.

A :class:`CudaKernel` is one C entry point: it builds and loads its
library at the first launch (never at import: the CPU tests import every
module), checks the C function's ``cudaError_t`` return and counts its
launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc() -> str:
    """Path of nvcc: PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this host")


def _library_path(name: str, build_dir: Path) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):     # headers feed every source
        if p.suffix == ".cuh" or p.stem == name:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return build_dir / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str], build_dir: Optional[Path] = None
          ) -> Dict[str, Tuple[Path, str]]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one nvcc
    process per source, all started together. Returns ``{name: (library
    path, ptxas report)}``; the report is empty for a library that was
    already built. Raises with nvcc's output if any build fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, str, subprocess.Popen]] = []
    out: Dict[str, Tuple[Path, str]] = {}
    for name in names:
        lib = _library_path(name, build_dir)
        if lib.exists():
            out[name] = (lib, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, lib)        # atomic: concurrent builds agree
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One C entry point ``name`` of ``csrc/<name>.cu``.

    ``argtypes`` are the ctypes of its arguments (``c_void_p`` for each
    pointer and the stream, ``c_int`` for an int); it returns the
    ``cudaError_t`` of its launches as an int. ``replaces`` names the TPU
    kernel it ports (file:line of the Pallas entry); ``device_fns`` the
    ``__global__`` functions one call launches, which is how a profiler
    trace tells this kernel's device time apart. An entry that chooses
    between kernels names them in ``variants``; ``launches_by_variant``
    then counts each launch under the variant it ran; an entry whose
    launches differ in kind (attention's causal or full mask) names the
    kinds in ``kinds``, and ``launches_by_kind`` counts each launch under
    the kind it was given (a kind not named in ``kinds``, such as K1's
    ``"tile 128"``, gets its count at its first launch). ``symbol`` names
    another C entry of the same library (default: ``name``); only
    ring_scatter's empty-kernel floor and its round size use it."""

    def __init__(self, name: str, argtypes: List, replaces: str,
                 device_fns: Tuple[str, ...],
                 variants: Tuple[str, ...] = (), symbol: str = "",
                 kinds: Tuple[str, ...] = ()):
        self.name = name
        self.symbol = symbol or name
        self.argtypes = argtypes
        self.replaces = replaces
        self.device_fns = device_fns
        self.source = f"src/repro_torch/csrc/{name}.cu"
        self.launches = 0
        self.launches_by_variant = {v: 0 for v in variants}
        self.launches_by_kind = {k: 0 for k in kinds}
        self._fn = None

    def reset_counts(self) -> None:
        """Set every launch count to 0."""
        self.launches = 0
        self.launches_by_variant = dict.fromkeys(self.launches_by_variant, 0)
        self.launches_by_kind = dict.fromkeys(self.launches_by_kind, 0)

    def load(self, build_dir: Optional[Path] = None):
        if self._fn is None:
            path, _ = build([self.name], build_dir)[self.name]
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, variant: Optional[str] = None,
               kind: Optional[str] = None) -> None:
        """Call the C entry; raise if it reports an error: a positive
        return is a ``cudaError_t``, a negative one a driver ``CUresult``
        (negated). Counts the launch, under ``variant`` and ``kind`` too
        if given."""
        rc = self.load()(*args)
        if rc > 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError_t {rc}")
        if rc < 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"driver CUresult {-rc}")
        self.launches += 1
        if variant is not None:
            self.launches_by_variant[variant] += 1
        if kind is not None:
            self.launches_by_kind[kind] = self.launches_by_kind.get(kind,
                                                                    0) + 1


def check_args(dev, checks) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` in ``checks``
    is a contiguous tensor of that dtype and shape on the card ``dev``."""
    for name, t, dtype, shape in checks:
        if (t.device != dev or not t.is_cuda or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{name}: need a contiguous {tuple(shape)} {dtype} tensor on "
                f"the card ({dev}), got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
