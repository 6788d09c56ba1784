"""Build, load and dispatch the hand-written CUDA kernels.

The port's counterpart of rtlsdr_ft8d_tpu/ops/knobs.py and of Pallas'
`interpret=` switch, with one rule instead of knobs: a CPU tensor goes
to the plain PyTorch version, a CUDA tensor goes to the kernel, and any
other device raises. There is no environment override and no fallback:
a missing nvcc, a failed build or a refused launch on a CUDA tensor
raises.

csrc/*.cu are compiled together, at first use, into one shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/libft8kernels-<hash>.so csrc/*.cu

keyed by a hash of the sources and flags, and loaded with ctypes. Every
C entry takes device pointers and the CUDA stream as `void*` and returns
its `cudaGetLastError()`.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_NVCC_TOOLKIT_PATH = "/usr/local/cuda/bin/nvcc"

P = ctypes.c_void_p        # every device pointer and the stream
I = ctypes.c_int

_lib = None                # the loaded library, once per process
KERNELS: dict = {}         # name -> Kernel, filled as the ops modules load


def on_cuda(t: torch.Tensor) -> bool:
    """The dispatch rule: True for a CUDA tensor (launch the kernel),
    False for a CPU tensor (plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check(t: torch.Tensor, dtype: torch.dtype, shape=None, device=None):
    """Validate a kernel operand; returns its data pointer."""
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t.data_ptr()


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libft8kernels-{h.hexdigest()[:16]}.so")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access(_NVCC_TOOLKIT_PATH, os.X_OK):
        nvcc = _NVCC_TOOLKIT_PATH
    if nvcc is None:
        raise RuntimeError("nvcc not found (neither on PATH nor at "
                           f"{_NVCC_TOOLKIT_PATH}): the CUDA kernels cannot "
                           "be built")
    return nvcc


def build() -> tuple[str, float]:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns (library path, seconds spent compiling)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cu = [p for p in sources() if p.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def load():
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; "
                           "torch.cuda.is_available() is False")
    path, _ = build()
    lib = ctypes.CDLL(path)
    lib.ft8_cuda_error_string.argtypes = [I]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


class Kernel:
    """One C entry of the library. `launches` counts successful launches
    of the kernel; nothing else adds to it."""

    def __init__(self, name, symbol, argtypes, source, replaces):
        self.name = name
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.source = source          # path in the repo
        self.replaces = replaces      # file:line of the Pallas kernel
        self.launches = 0
        KERNELS[name] = self

    def __call__(self, device: torch.device, *args):
        lib = load()
        fn = getattr(lib, self.symbol)
        fn.argtypes = list(self.argtypes) + [P]     # + stream
        fn.restype = I
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            msg = lib.ft8_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{msg} ({err})")
        self.launches += 1
