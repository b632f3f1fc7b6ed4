"""Build, binding and wrappers of the hand-written CUDA kernels.

`csrc/table_pass.cu` is compiled on first use with ``nvcc`` for
``sm_90a`` into a plain-C shared library under ``bithtm_tpu_torch/_build``
(keyed by a hash of the sources and flags) and loaded with ctypes.
Nothing here runs when the module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on the current CUDA stream, raises if the launch
reports an error, and counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .active_set import act_scale, cell_words

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("table_pass.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_SHARED_BYTES = 232_448  # what one Hopper block may opt in to

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # syn, perm, act_prev, pun_word, cols, bits, v_out,
    # B, C, J, A, W, D, K, punishment, threshold, scale, stream
    "table_update": [_VP] * 7 + [_I] * 7 + [_F, _F, _I, _VP],
    # syn, perm, cols, bits, v_out, B, C, J, A, W, D, K, threshold,
    # scale, stream
    "act_conn": [_VP] * 5 + [_I] * 7 + [_F, _I, _VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{path}); the CUDA kernels need the CUDA "
                           "toolkit to build")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libbithtm_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels unless a build of these sources exists (or
    ``force``); returns the library path."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


class CudaKernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = ctypes.CDLL(str(build()))
            fn = getattr(lib, self.name)
            fn.argtypes = _ARGTYPES[self.name]
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


TABLE_UPDATE = CudaKernel("table_update")
ACT_CONN = CudaKernel("act_conn")
KERNELS = (TABLE_UPDATE, ACT_CONN)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, align: int = 1) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         f"aligned")


def _check_active_set(syn, perm, cols, bits, cell_dim: int, synapses: int):
    if syn.dim() != 3:
        raise ValueError(f"syn must be (B, C, J), got {tuple(syn.shape)}")
    B, C, J = syn.shape
    A = cols.shape[-1]
    W = cell_words(cell_dim)
    dev = syn.device
    # the tables are read with 16-byte vector loads
    _check("syn", syn, torch.int32, (B, C, J), dev, align=16)
    _check("perm", perm, torch.float32, (B, C, J), dev, align=16)
    _check("cols", cols, torch.int32, (B, A), dev)
    _check("bits", bits, torch.int32, (B, A, W), dev)
    if J % synapses or J // synapses > 32:
        raise ValueError(f"J={J} must be G*K with K={synapses} and G <= 32 "
                         f"(one punishment bit per segment)")
    if B > 65535:
        raise ValueError(f"B={B} streams exceed the grid's y extent 65535")
    if 1 + act_scale(synapses) > 127:
        raise ValueError(f"K={synapses} > 125 packs activity wider than "
                         f"u8, which the kernels do not take")
    smem = (C * cell_dim + 31) // 32 * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"the active-cell bitmap needs {smem} bytes of "
                         f"shared memory; a block has {MAX_SHARED_BYTES}")
    return B, C, J, A, W


def table_update_cuda(syn, perm, act_prev, pun_word, cols, bits,
                      cell_dim: int, synapses: int, punishment: float,
                      perm_threshold: float) -> torch.Tensor:
    """CUDA `table_update`: punishes ``perm`` in place and returns the
    packed activity (B, C, J) u8 (see `active_set.table_update_ref`)."""
    B, C, J, A, W = _check_active_set(syn, perm, cols, bits, cell_dim,
                                      synapses)
    _check("act_prev", act_prev, torch.uint8, (B, C, J), syn.device,
           align=16)
    _check("pun_word", pun_word, torch.int32, (B, C), syn.device)
    v = torch.empty((B, C, J), dtype=torch.uint8, device=syn.device)
    with torch.cuda.device(syn.device):
        stream = torch.cuda.current_stream().cuda_stream
        TABLE_UPDATE(syn.data_ptr(), perm.data_ptr(), act_prev.data_ptr(),
                     pun_word.data_ptr(), cols.data_ptr(), bits.data_ptr(),
                     v.data_ptr(), B, C, J, A, W, cell_dim, synapses,
                     punishment, perm_threshold, act_scale(synapses),
                     stream)
    return v


def act_conn_cuda(syn, perm, cols, bits, cell_dim: int,
                  perm_threshold: float, synapses: int) -> torch.Tensor:
    """CUDA `act_conn`: packed activity (B, C, J) u8 over a read-only
    table (see `active_set.synapse_activation_conn_ref`)."""
    B, C, J, A, W = _check_active_set(syn, perm, cols, bits, cell_dim,
                                      synapses)
    v = torch.empty((B, C, J), dtype=torch.uint8, device=syn.device)
    with torch.cuda.device(syn.device):
        stream = torch.cuda.current_stream().cuda_stream
        ACT_CONN(syn.data_ptr(), perm.data_ptr(), cols.data_ptr(),
                 bits.data_ptr(), v.data_ptr(), B, C, J, A, W, cell_dim,
                 synapses, perm_threshold, act_scale(synapses), stream)
    return v
