"""Build, binding and wrappers of the hand-written CUDA kernels.

The sources in `csrc/` (`table_pass.cu`, `serving_pass.cu`,
`small_take.cu` and `sp_pass.cu`; all but `small_take.cu` share
`active_bitmap.cuh`) are compiled on first use with ``nvcc`` for
``sm_90a``, one process per source started together, and linked into a
plain-C shared library under ``bithtm_tpu_torch/_build`` (keyed by a
hash of the sources and flags), loaded with ctypes. Nothing here runs
when the module is imported.

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
SOURCES = ("table_pass.cu", "serving_pass.cu", "small_take.cu",
           "sp_pass.cu")
HEADERS = ("active_bitmap.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
MAX_SHARED_BYTES = 232_448  # what one Hopper block may opt in to
MAX_SMALL_TABLE = 2048      # words of a small_table_take table (8 KB)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # syn, perm, act_prev, pun_word, cols, bits, v_out,
    # B, C, J, A, W, D, K, punishment, threshold, scale, stream
    "table_update": [_VP] * 7 + [_I] * 7 + [_F, _F, _I, _VP],
    # syn, perm, cols, bits, v_out, B, C, J, A, W, D, K, threshold,
    # scale, stream
    "act_conn": [_VP] * 5 + [_I] * 7 + [_F, _I, _VP],
    # rows, cols, bits, out, B, R, A, W, C, D, stream
    "serving_activation": [_VP] * 4 + [_I] * 6 + [_VP],
    # word, cols, bits, v_out, B, C, J, A, W, D, scale, stream
    "act_frozen": [_VP] * 4 + [_I] * 7 + [_VP],
    # syn, cols, bits, out, B, R, J, A, W, C, D, stream
    "synapse_activation": [_VP] * 4 + [_I] * 7 + [_VP],
    # table, idx, out, B, Wc, n, stream
    "small_table_take": [_VP] * 3 + [_I] * 3 + [_VP],
    # perm, delta, cols, pack, B, C, I_pad, A, quantized, threshold_f,
    # threshold_i, stream
    "sp_update_pack": [_VP] * 4 + [_I] * 5 + [_F, _I, _VP],
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
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libbithtm_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels unless a build of these sources exists (or
    ``force``); returns the library path."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    steps = [(cmd, p.communicate()[0], p.returncode)
             for cmd, p in zip(compiles, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        steps.append((link, res.stdout, res.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, log, rc in steps:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{log}")
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
SERVING_ACTIVATION = CudaKernel("serving_activation")
ACT_FROZEN = CudaKernel("act_frozen")
SYNAPSE_ACTIVATION = CudaKernel("synapse_activation")
SMALL_TABLE_TAKE = CudaKernel("small_table_take")
SP_UPDATE_PACK = CudaKernel("sp_update_pack")
KERNELS = (TABLE_UPDATE, ACT_CONN, SERVING_ACTIVATION, ACT_FROZEN,
           SYNAPSE_ACTIVATION, SMALL_TABLE_TAKE, SP_UPDATE_PACK)


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


def _check_set(cols, bits, B: int, C: int, cell_dim: int,
               dev: torch.device) -> tuple[int, int]:
    """The (B, A) cols + (B, A, W) bits active set over C*cell_dim cells,
    whose bitmap each block builds in shared memory. Returns (A, W)."""
    A = cols.shape[-1]
    W = cell_words(cell_dim)
    _check("cols", cols, torch.int32, (B, A), dev)
    _check("bits", bits, torch.int32, (B, A, W), dev)
    if B > 65535:
        raise ValueError(f"B={B} streams exceed the grid's y extent 65535")
    smem = (C * cell_dim + 31) // 32 * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"the active-cell bitmap needs {smem} bytes of "
                         f"shared memory; a block has {MAX_SHARED_BYTES}")
    return A, W


def _check_table(name: str, table, dtype: torch.dtype, cols, bits,
                 cell_dim: int, synapses: int):
    """A (B, C, J) table read with 16-byte vector loads, J = G*K."""
    if table.dim() != 3:
        raise ValueError(f"{name} must be (B, C, J), got "
                         f"{tuple(table.shape)}")
    B, C, J = table.shape
    _check(name, table, dtype, (B, C, J), table.device, align=16)
    if J % synapses or J // synapses > 32:
        raise ValueError(f"J={J} must be G*K with K={synapses} and G <= 32 "
                         f"(one bit per segment in a column's words)")
    if 1 + act_scale(synapses) > 127:
        raise ValueError(f"K={synapses} > 125 packs activity wider than "
                         f"u8, which the kernels do not take")
    A, W = _check_set(cols, bits, B, C, cell_dim, table.device)
    return B, C, J, A, W


def _check_active_set(syn, perm, cols, bits, cell_dim: int, synapses: int):
    B, C, J, A, W = _check_table("syn", syn, torch.int32, cols, bits,
                                 cell_dim, synapses)
    _check("perm", perm, torch.float32, (B, C, J), syn.device, align=16)
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


def serving_activation_cuda(rows, cols, bits, column_dim: int,
                            cell_dim: int) -> torch.Tensor:
    """CUDA `serving_activation`: (B, R, 128) u8, g+1 where the word's
    presynaptic cell is active, over the main and extension rows of a
    compact serving table (see `serving.serving_activation_ref`)."""
    if rows.dim() != 3 or rows.shape[-1] != 128:
        raise ValueError(f"rows must be (B, R, 128), got "
                         f"{tuple(rows.shape)}")
    B, R, _ = rows.shape
    _check("rows", rows, torch.int32, (B, R, 128), rows.device, align=16)
    A, W = _check_set(cols, bits, B, column_dim, cell_dim, rows.device)
    out = torch.empty((B, R, 128), dtype=torch.uint8, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        SERVING_ACTIVATION(rows.data_ptr(), cols.data_ptr(), bits.data_ptr(),
                           out.data_ptr(), B, R, A, W, column_dim, cell_dim,
                           stream)
    return out


def act_frozen_cuda(frozen_word, cols, bits, cell_dim: int,
                    synapses: int) -> torch.Tensor:
    """CUDA `act_frozen`: packed activity (B, C, J) u8 over a frozen word
    table (see `active_set.synapse_activation_frozen_ref`)."""
    B, C, J, A, W = _check_table("frozen_word", frozen_word, torch.int32,
                                 cols, bits, cell_dim, synapses)
    v = torch.empty((B, C, J), dtype=torch.uint8, device=frozen_word.device)
    with torch.cuda.device(frozen_word.device):
        stream = torch.cuda.current_stream().cuda_stream
        ACT_FROZEN(frozen_word.data_ptr(), cols.data_ptr(), bits.data_ptr(),
                   v.data_ptr(), B, C, J, A, W, cell_dim, act_scale(synapses),
                   stream)
    return v


def synapse_activation_cuda(syn, cols, bits, column_dim: int,
                            cell_dim: int) -> torch.Tensor:
    """CUDA `synapse_activation`: (B, R, J) u8, 1 where the slot's
    presynaptic cell is in the active set (see
    `active_set.synapse_activation_ref`)."""
    if syn.dim() != 3:
        raise ValueError(f"syn must be (B, R, J), got {tuple(syn.shape)}")
    B, R, J = syn.shape
    _check("syn", syn, torch.int32, (B, R, J), syn.device, align=16)
    A, W = _check_set(cols, bits, B, column_dim, cell_dim, syn.device)
    out = torch.empty((B, R, J), dtype=torch.uint8, device=syn.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(syn.device):
        stream = torch.cuda.current_stream().cuda_stream
        SYNAPSE_ACTIVATION(syn.data_ptr(), cols.data_ptr(), bits.data_ptr(),
                           out.data_ptr(), B, R, J, A, W, column_dim,
                           cell_dim, stream)
    return out


def small_table_take_cuda(table, idx) -> torch.Tensor:
    """CUDA `small_table_take`: out[b, ...] = table[b, idx[b, ...]] where
    0 <= idx < Wc, 0 elsewhere (see `active_set.take_small_table_ref`)."""
    if table.dim() != 2 or idx.dim() < 2:
        raise ValueError(f"table must be (B, Wc) and idx (B, ...), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    B, Wc = table.shape
    if not 1 <= Wc <= MAX_SMALL_TABLE:
        raise ValueError(f"table width {Wc} is outside [1, "
                         f"{MAX_SMALL_TABLE}], what one block stages in "
                         f"shared memory")
    _check("table", table, torch.int32, (B, Wc), table.device)
    _check("idx", idx, torch.int32, (B, *idx.shape[1:]), table.device)
    out = torch.empty_like(idx)
    n = idx[0].numel()
    if B * n == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        SMALL_TABLE_TAKE(table.data_ptr(), idx.data_ptr(), out.data_ptr(), B,
                         Wc, n, stream)
    return out


def sp_update_pack_cuda(permanence, delta_row, active_cols, threshold
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA `sp_update_pack`: the Hebbian update of the active rows of
    ``permanence`` (B, C, I_pad), int16 units or float32, in place, and
    the (B, C, I_pad/8) u8 connected table of every row (see
    `spatial_pooler.sp_update_pack_ref`). ``delta_row`` (B, I_pad) is
    int32 units for an int16 table, float32 for a float32 one."""
    if permanence.dim() != 3:
        raise ValueError(f"permanence must be (B, C, I_pad), got "
                         f"{tuple(permanence.shape)}")
    B, C, I_pad = permanence.shape
    dev = permanence.device
    if permanence.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"permanence must be int16 or float32, got "
                        f"{permanence.dtype}")
    quantized = permanence.dtype == torch.int16
    if I_pad % 1024:
        raise ValueError(f"I_pad={I_pad} must be 8*S with S a multiple of "
                         f"128 (ops/overlap.py input_words)")
    if quantized and threshold != int(threshold):
        raise ValueError(f"an int16 table takes an integer threshold in "
                         f"units, got {threshold}")
    _check("permanence", permanence, permanence.dtype, (B, C, I_pad), dev,
           align=16)
    _check("delta_row", delta_row,
           torch.int32 if quantized else torch.float32, (B, I_pad), dev,
           align=16)
    A = active_cols.shape[-1]
    _check("active_cols", active_cols, torch.int32, (B, A), dev)
    if B > 65535:
        raise ValueError(f"B={B} streams exceed the grid's y extent 65535")
    if (C + 31) // 32 * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"the active-column bitmap of C={C} columns "
                         f"exceeds {MAX_SHARED_BYTES} bytes")
    pack = torch.empty((B, C, I_pad // 8), dtype=torch.uint8, device=dev)
    if pack.numel() == 0:
        return permanence, pack
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        SP_UPDATE_PACK(permanence.data_ptr(), delta_row.data_ptr(),
                       active_cols.data_ptr(), pack.data_ptr(), B, C, I_pad,
                       A, int(quantized), float(threshold),
                       int(threshold) if quantized else 0, stream)
    return permanence, pack
