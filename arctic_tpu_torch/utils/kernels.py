"""Build, load and call the port's CUDA kernels.

All ``csrc/*.cu`` files compile with nvcc (one process per source, all
started together) and link into ONE shared library with a plain C
interface, loaded through ctypes (no PyTorch headers: a build takes
seconds). The build happens at first use, into ``build/arctic_tpu_torch/``
beside the package, under a file name carrying the hash of the sources and
flags. A missing nvcc or a failed compile raises; nothing falls back.

Each kernel's Python wrapper is registered with :func:`kernel` — its name,
route, source file and the TPU kernel it replaces — and counts its launches
in a plain integer attribute ``launches``. The wrapper itself lives beside
the kernel's plain torch version in ``ops/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "arctic_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)
# Where nvcc is looked for after PATH and $CUDA_HOME/bin.
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the launchers; each returns its cudaError_t as an int.
_SIGNATURES = {
    "arctic_raster_tiles": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "arctic_pack_shade_rows": (_P, _P, _I, _I, _P, _P),
    "arctic_select_interp": (_P, _P, _I, _I, _I, _P, _P),
    "arctic_tap_resolve": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "arctic_tile_tap_resolve": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P),
    "arctic_window_lut_q": (_P, _I, _I, _P, _I, _P, _P),
    "arctic_pcf_eval": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _P, _P),
    "arctic_transpose_pack_rows": (_P, _I, _P, _P),
    "arctic_pack_shade_rows_tm": (_P, _P, _P, _I, _I, _I, _P, _P),
    "arctic_window_lut": (_P, _I, _I, _I, _P, _P),
    "arctic_pcf_resolve": (_P, _I, _P, _P, _I, _P, _P),
    "arctic_bvh_trace": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # Seven planes, then host pointers to the strides and the packed frame
    # parameters, which the launcher copies into the kernel's arguments.
    "arctic_shade_lights": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    "arctic_pcf_runs": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P),
}
# C signatures of the queries (no stream); each returns its cudaError_t.
_QUERIES = {
    "arctic_pcf_eval_stride": (_P,),
    "arctic_bvh_trace_attributes": (_P,),
    "arctic_pack_shade_rows_attributes": (_P,),
    "arctic_pack_shade_rows_tm_attributes": (_P,),
    "arctic_shade_lights_attributes": (_P,),
    "arctic_pcf_runs_attributes": (_P,),
}

# Every registered kernel wrapper, in registration order.
KERNELS: list = []


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = list(NVCC_FALLBACKS)
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        f"{', '.join(NVCC_FALLBACKS)}): the CUDA kernels of arctic_tpu_torch "
        "cannot be built, and CUDA tensors have no other path"
    )


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/*.cu into build_dir (once per source hash); returns the
    library path. Raises RuntimeError naming the command and nvcc's stderr."""
    out = Path(build_dir) / f"libarctic_kernels_{source_digest()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        cus = [s for s in sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in cus]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(cus, objs)]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in compiles
        ]
        errs = [proc.communicate()[1] for proc in procs]  # every process ends
        for cmd, proc, err in zip(compiles, procs, errs):
            _raise_on_failure(cmd, proc.returncode, err)
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", "-o", lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_on_failure(link, proc.returncode, proc.stderr)
        os.replace(lib, out)  # atomic: a concurrent build sees all of it or none
    return out


def _raise_on_failure(cmd, returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"kernel build failed (exit {returncode}): {' '.join(cmd)}\n{stderr}")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in (_SIGNATURES | _QUERIES).items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.arctic_cuda_error_string.argtypes = [ctypes.c_int]
    lib.arctic_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the tensors' device and PyTorch's current
    stream there; raise on a refused launch. Tensor arguments pass as
    device pointers and must share one device."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {len(devices)} devices, need one")
    (device,) = devices
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    lib = library()
    with torch.cuda.device(device):
        code = getattr(lib, name)(*conv, torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(lib, f"{name} launch", code)


def query_int(name: str, device) -> int:
    """The int that query ``name`` (``int name(int* out)``) gives on
    ``device``; raise on a CUDA error."""
    return query_ints(name, device, 1)[0]


def query_ints(name: str, device, n: int, *args) -> list[int]:
    """The ``n`` ints that query ``name`` (``int name(args..., int* out)``)
    writes on ``device``; raise on a CUDA error."""
    out = (ctypes.c_int * n)()
    lib = library()
    with torch.cuda.device(device):
        code = getattr(lib, name)(*args, out)
    _raise_on_error(lib, name, code)
    return list(out)


def attributes(query: str, device) -> dict:
    """One kernel's registers and local (spill) bytes a thread, its block
    size and the blocks an SM holds at once, as the card's runtime reports
    them through attribute query ``query`` (four ints)."""
    regs, local, threads, blocks = query_ints(query, device, 4)
    return dict(registers=regs, spill_bytes=local, block=threads, blocks_per_sm=blocks)


def _raise_on_error(lib, what: str, code: int) -> None:
    if code != 0:
        msg = lib.arctic_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def kernel(name: str, source: str, replaces: str, plain, counters: tuple = ()):
    """Register a kernel wrapper: its metadata (every kernel is CUDA C++),
    its plain torch version (``.plain``, same signature), a launch counter
    (``.launches``, which the wrapper bumps where it launches the kernel)
    and the wrapper's own ``counters`` (plain integers it bumps itself);
    reset_launch_counts zeroes them all."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _recording is not None:
                _recording.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)

        wrapper.kernel_name = name
        wrapper.route = "cuda"
        wrapper.source = source
        wrapper.replaces = replaces
        wrapper.plain = plain
        wrapper.counters = ("launches", *counters)
        for counter in wrapper.counters:
            setattr(wrapper, counter, 0)
        KERNELS.append(wrapper)
        return wrapper

    return deco


_recording: dict | None = None


@contextlib.contextmanager
def record_calls():
    """Record every kernel-wrapper call made inside the block, as
    {kernel name: [(args, kwargs), ...]} — the exact inputs a run gave each
    kernel, for comparing it with its plain version afterwards."""
    global _recording
    outer, _recording = _recording, {}
    try:
        yield _recording
    finally:
        _recording = outer


def reset_launch_counts() -> None:
    for fn in KERNELS:
        for counter in fn.counters:
            setattr(fn, counter, 0)


def launch_counts() -> dict:
    return {fn.kernel_name: fn.launches for fn in KERNELS}


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
