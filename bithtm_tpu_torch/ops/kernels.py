"""Build, binding and wrappers of the hand-written CUDA kernels.

The sources in `csrc/` (`table_pass.cu`, `serving_pass.cu`,
`small_take.cu`, `sp_pass.cu`, `overlap_pass.cu`, `count_pass.cu`,
`grow_pass.cu`, `learn_pass.cu`, `decide_pass.cu`, `pack_pass.cu`,
`select_pass.cu`, `serving_count_pass.cu` and `anomaly_pass.cu`; all
include `launch.cuh`,
`table_pass.cu`, `serving_pass.cu`, `sp_pass.cu` and
`serving_count_pass.cu` also `active_bitmap.cuh`) are compiled on first use with
``nvcc`` for ``sm_90a``, one process per source started together, and
linked into a plain-C shared library under ``bithtm_tpu_torch/_build``
(keyed by a hash of the sources and flags), loaded with ctypes. Nothing
here runs when the module is imported.

Each wrapper first chooses its kernel's path from the shapes alone
(`_bitmap`, `_streams`, `_act_bytes`, `_delta`, `_grow_keys`,
`_rows_mode`, `_fill_path`, `_learn_loads`, `decide_split`,
`_pack_path`, `_select_path`,
`_row_claims`, `_segment_regs`, `_steps`, the decisions' mode: the
bitmap in shared or in
global memory, the packed activity's type, the streams in grid y or
folded into grid x, the SP delta row staged or read from global memory,
the growth keys' form and where they live, the SP selection's grid, where
it keeps its keys and its winners and how it places them, how the SP's
row update finds repeated columns, the registers a lane tallies a
compact serving row's segments in, whether the active rows are
read where they lie in the tables or from gathered rows, how the fill
reads its cells, whether the learning pass takes a column in 16-byte
vectors, the decisions' blocks a stream, the pack's loads, the lanes
the anomaly stages give a step; README.md,
port section) and
reports it (`CudaKernel.path`) before any tensor is read. Only the
stream-words limit (`_stream_words`: the kernels index a stream's words
in int32) still raises. Then it checks
device, dtype, shape, contiguity and alignment in one pass over its
tensors (`_ptr`); allocates the output and any scratch, and calls the C
entry point with the tensors' device index and the raw handle of that
device's current stream: the entry point makes the device current only
if it is not, and launches on that stream. The wrapper raises if the
launch reports an error and counts its launches (`launch_counts`, and
by path `path_counts`). A kernel that is quick on the device
(`small_table_take`, about 3 us) is bound by this host issue, so it
holds no device context, builds no stream object and takes no attribute
lookup on the ctypes function.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .active_set import act_dtype, act_scale, cell_words
from .overlap import input_words

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("table_pass.cu", "serving_pass.cu", "small_take.cu",
           "sp_pass.cu", "overlap_pass.cu", "count_pass.cu", "grow_pass.cu",
           "learn_pass.cu", "decide_pass.cu", "pack_pass.cu",
           "select_pass.cu", "serving_count_pass.cu", "anomaly_pass.cu")
HEADERS = ("active_bitmap.cuh", "launch.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
MAX_SHARED_BYTES = 232_448  # what one Hopper block may opt in to
# the active-cell bitmap a block builds in shared memory: C*D cells
MAX_BITMAP_CELLS = 8 * MAX_SHARED_BYTES   # 1,859,584
MAX_STREAM_WORDS = 1 << 30  # a stream's words, indexed in int32 on the card
MAX_GRID_Y = 65_535         # streams of a kernel with one grid row a stream
# `sp_select`: a warp a stream up to 64 winners and 128 columns; the
# columns whose keys a block of 1,024 threads holds in registers (16 a
# thread; a cluster of two blocks, 8 a thread, past 8,192 columns at up to
# 132 streams and 512 winners); the winners placed by counting up to 512
# of them, else by the LSD radix sort, whose two lists (16 bytes a winner)
# a block keeps in shared memory up to SELECT_LIST_BYTES, else a cluster
# of 8 blocks a stream sorts them in global memory
SELECT_WARP_COLUMNS = 128
SELECT_WARP_WINNERS = 64
SELECT_REG_COLUMNS = 16_384
SELECT_CLUSTER_COLUMNS = 8192
SELECT_CLUSTER_STREAMS = 132
SELECT_RANK_WINNERS = 512
SELECT_LIST_BYTES = 160 * 1024
SELECT_SORT_BLOCKS = 8
# `sp_rows`: the columns whose first-claim bitmaps a block keeps in shared
# memory; the blocks a launch aims at (two on each of the H100's 132 SMs)
# and the units a run holds at most where that makes more runs
SP_ROWS_BITMAP_COLUMNS = 65_536
SP_ROWS_FILL_BLOCKS = 264
SP_ROWS_RUN_UNITS = 48
# `column_decide`: the warps a block holds (a column each at a time), the
# blocks a launch aims to keep resident (two of 1,024 threads on each of
# the H100's 132 SMs), the columns a warp takes before a stream is split
# over more blocks, and the streams a split launch takes at most (the
# rows of its meeting place, `g_meet` in csrc/decide_pass.cu)
DECIDE_WARPS = 32
DECIDE_FILL_BLOCKS = 264
DECIDE_WARP_COLUMNS = 2
DECIDE_SPLIT_STREAMS = 1024
# the anomaly stages (`anomaly_likelihood`, `seasonal_zscore`): a thread
# a step up to a window of ANOMALY_LANE_WINDOW slots (a block a stream,
# the windows' history in shared memory), a warp a step past it (a
# stream's steps over several blocks, the windows read from the inputs);
# the order of a step's sums follows from the path
ANOMALY_LANE_WINDOW = 4096

_VP, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_longlong)
# every entry point ends with (device, stream); `bitmaps` is the global
# bitmap scratch (None: the bitmap in shared memory)
_ARGTYPES = {
    # syn, perm, act_prev, pun_word, cols, bits, bitmaps, v_out,
    # B, C, column_dim, J, A, W, D, K, punishment, threshold, scale,
    # act_bytes
    "table_update": [_VP] * 8 + [_I] * 8 + [_F, _F, _I, _I, _I, _VP],
    # syn, perm, cols, bits, bitmaps, v_out, B, C, column_dim, J, A, W,
    # D, K, threshold, scale, act_bytes
    "act_conn": [_VP] * 6 + [_I] * 8 + [_F, _I, _I, _I, _VP],
    # rows, cols, bits, bitmaps, out, B, R, A, W, C, D
    "serving_activation": [_VP] * 5 + [_I] * 6 + [_I, _VP],
    # word, cols, bits, bitmaps, v_out, B, C, J, A, W, D, scale,
    # act_bytes, fold
    "act_frozen": [_VP] * 5 + [_I] * 9 + [_I, _VP],
    # syn, cols, bits, bitmaps, out, B, R, J, A, W, C, D
    "synapse_activation": [_VP] * 5 + [_I] * 7 + [_I, _VP],
    # table, table_stride, keys, out, B, Wc, n, mask
    "small_table_take": [_VP, _I, _VP, _VP] + [_I] * 4 + [_I, _VP],
    # perm, delta, cols, col_bitmaps, pack, B, C, I_pad, A, quantized,
    # threshold_f, threshold_i, fold
    "sp_update_pack": [_VP] * 5 + [_I] * 5 + [_F, _I, _I, _I, _VP],
    # perm, pack, bits, cols, B, C, I, I_pad, A, quantized, on_f, off_f,
    # threshold_f, on_i, off_i, threshold_i, fold
    "sp_rows": [_VP] * 4 + [_I] * 6 + [_F] * 3 + [_I] * 4 + [_I, _VP],
    # connected, bits, out, B, C, S, I, fold
    "sp_overlap": [_VP] * 3 + [_I] * 5 + [_I, _VP],
    # v, potential, connected, seg_cell, matching_word, prediction, B, C,
    # G, K, scale, act_bytes, D, theta_m, theta_a
    "seg_counts": [_VP] * 6 + [_I] * 9 + [_I, _VP],
    # syn, act, act_bytes, row_cols, Ct, G, fresh, learn, cols, bits, rnd,
    # chosen, n_chosen, lidx, lvalid, lpos, cand, counts, scratch, B, R,
    # K, A, D, L, Wc, samp, key_bits, cell_form, global_keys
    "grow_select": [_VP, _VP, _I, _VP, _I, _I] + [_VP] * 13 + [_I] * 11
    + [_I, _VP],
    # syn, perm, act, cols, potential, connected, live, B, Ct, A, G, K,
    # scale, act_bytes
    "row_counts": [_VP] * 7 + [_I] * 7 + [_I, _VP],
    # syn, perm, act, cols, learn, fresh, lpos, chosen, n_chosen, counts,
    # wrote, B, Ct, A, G, K, L, kk, inc, dec, perm_init, act_bytes, vec
    "learn_rows": [_VP] * 11 + [_I] * 7 + [_F] * 3 + [_I, _I] + [_I, _VP],
    # pred, seg_cell, cols, pot, conn, live, u_seg, u_least, step,
    # act_bits, winner_bits, col_burst, learn, new_seg, counts, B, Ct, A,
    # G, D, mode, theta_m, theta_a, eps, evict, split
    "column_decide": [_VP] * 15 + [_I] * 8 + [_F, _I, _I] + [_I, _VP],
    # mask, out, rows, D
    "pack_bits": [_VP] * 2 + [_LL, _I] + [_I, _VP],
    # ov, duty, boosted, cols, mask, duty_out, list, B, C, A, scale,
    # momentum, one_minus
    "sp_select": [_VP] * 7 + [_I] * 3 + [_F] * 3 + [_I, _VP],
    # rows, ext_col, cols, bits, seg_cell, bitmaps, counts, matching_word,
    # prediction, B, R, E, A, W, C, D, G, theta_m, theta_a
    "serving_counts": [_VP] * 9 + [_I] * 10 + [_I, _VP],
    # scores_in, pos_in, count_in, short_in, x, x_ts, x_bs, x_f64,
    # scores_out, pos_out, count_out, short_out, lik, T, B, W, R, m,
    # one_minus
    "anomaly_likelihood": [_VP] * 5 + [_LL, _LL, _I] + [_VP] * 5 + [_I] * 4
    + [_F, _F] + [_I, _VP],
    # lag_in, resid_in, pos_in, x, x_ts, x_bs, x_f64, lag_out, resid_out,
    # pos_out, z, T, B, L, W, P, eps
    "seasonal_zscore": [_VP] * 4 + [_LL, _LL, _I] + [_VP] * 4 + [_I] * 5
    + [_F] + [_I, _VP],
}
# the grid queries of the row-range kernels, which launch nothing:
# table_pass_grid (punish, C, J, D, global, act_bytes, device, blocks
# out, threads out), word_pass_grid (serving, C, J, D, global, device,
# blocks out, threads out), serving_counts_grid (C, D, G, global, flags,
# device, blocks out, threads out)
_GRID_ARGTYPES = {
    "table_pass_grid": [_I] * 7 + [ctypes.POINTER(_I)] * 2,
    "word_pass_grid": [_I] * 6 + [ctypes.POINTER(_I)] * 2,
    "serving_counts_grid": [_I] * 6 + [ctypes.POINTER(_I)] * 2,
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


@functools.cache
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


def _stream(device: int) -> int:
    """The raw handle of device ``device``'s current CUDA stream, read
    without building a `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(device)


class CudaKernel:
    """One C entry point of the kernel library, with the path its
    wrapper chose last (`path`, set from the shapes before any tensor is
    read) and its launches by path (`paths`), whose sum is its launch
    count."""

    def __init__(self, name: str):
        self.name = name
        self.path: tuple[str, ...] = ()
        self.paths: dict[tuple[str, ...], int] = {}
        self._fn = None

    @property
    def launches(self) -> int:
        return sum(self.paths.values())

    def bind(self):
        """The ctypes function, its argument types set once."""
        if self._fn is None:
            fn = getattr(_library(), self.name)
            fn.argtypes = _ARGTYPES[self.name]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def choose(self, *path: str) -> tuple[str, ...]:
        """Reports the path the wrapper chose; returns it."""
        self.path = path
        return path

    def launch(self, *args) -> None:
        """Calls the entry point on the path chosen last; raises if it
        reports an error, else counts the launch under that path."""
        err = (self._fn or self.bind())(*args)
        if err:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.paths[self.path] = self.paths.get(self.path, 0) + 1


TABLE_UPDATE = CudaKernel("table_update")
ACT_CONN = CudaKernel("act_conn")
SERVING_ACTIVATION = CudaKernel("serving_activation")
ACT_FROZEN = CudaKernel("act_frozen")
SYNAPSE_ACTIVATION = CudaKernel("synapse_activation")
SMALL_TABLE_TAKE = CudaKernel("small_table_take")
SP_UPDATE_PACK = CudaKernel("sp_update_pack")
SP_ROWS = CudaKernel("sp_rows")
SP_OVERLAP = CudaKernel("sp_overlap")
SEG_COUNTS = CudaKernel("seg_counts")
GROW_SELECT = CudaKernel("grow_select")
ROW_COUNTS = CudaKernel("row_counts")
LEARN_ROWS = CudaKernel("learn_rows")
COLUMN_DECIDE = CudaKernel("column_decide")
PACK_BITS = CudaKernel("pack_bits")
SP_SELECT = CudaKernel("sp_select")
SERVING_COUNTS = CudaKernel("serving_counts")
ANOMALY_LIKELIHOOD = CudaKernel("anomaly_likelihood")
SEASONAL_ZSCORE = CudaKernel("seasonal_zscore")
KERNELS = (TABLE_UPDATE, ACT_CONN, SERVING_ACTIVATION, ACT_FROZEN,
           SYNAPSE_ACTIVATION, SMALL_TABLE_TAKE, SP_UPDATE_PACK, SP_ROWS,
           SP_OVERLAP, SEG_COUNTS, GROW_SELECT, ROW_COUNTS, LEARN_ROWS,
           COLUMN_DECIDE, PACK_BITS, SP_SELECT, SERVING_COUNTS,
           ANOMALY_LIKELIHOOD, SEASONAL_ZSCORE)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def path_counts() -> dict[str, dict[str, int]]:
    """Each kernel's launches by path, a path's names joined by "+"
    (`small_table_take`, which has one path, is left out). A launch on
    the "global" bitmap path or the "gmem_delta" path is two kernels on
    the card: the bitmap build (`build_bitmaps` or
    `build_column_bitmaps_kernel`), then the pass; it counts once."""
    return {k.name: {"+".join(p): n for p, n in k.paths.items()}
            for k in KERNELS if any(k.paths)}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.paths = {}


def _grid(name: str, *args: int) -> tuple[int, int]:
    fn = getattr(_library(), name)
    fn.argtypes = _GRID_ARGTYPES[name]
    fn.restype = ctypes.c_int
    blocks, threads = _I(), _I()
    err = fn(*args, ctypes.byref(blocks), ctypes.byref(threads))
    if err:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return blocks.value, threads.value


def table_pass_grid(punish: bool, C: int, J: int, cell_dim: int,
                    device: int = 0, synapses: int = 64
                    ) -> tuple[int, int, tuple[str, str]]:
    """(blocks, threads a block, path) of the row-range grid that
    `table_update` (``punish``) or `act_conn` launches on card ``device``
    for tables of rows of J = G*``synapses`` slots over C*cell_dim cells
    (`csrc/active_bitmap.cuh` `range_grid`); the path is the bitmap's
    ("smem" or "global") and the activity's type ("u8", "bf16", "f32")."""
    path = (_bitmap(C, cell_dim), _act_name(synapses))
    blocks, threads = _grid("table_pass_grid", int(punish), C, J, cell_dim,
                            int(path[0] == "global"), _act_bytes(synapses),
                            device)
    return blocks, threads, path


def word_pass_grid(serving: bool, C: int, J: int, cell_dim: int,
                   device: int = 0) -> tuple[int, int, tuple[str]]:
    """(blocks, threads a block, path) of the row-range grid that
    `serving_activation` (``serving``: rows of 128 words, J unused) or
    `synapse_activation` (rows of J words) launches on card ``device``
    over C*cell_dim cells; the path is the bitmap's ("smem" or
    "global")."""
    path = (_bitmap(C, cell_dim),)
    blocks, threads = _grid("word_pass_grid", int(serving), C, J, cell_dim,
                            int(path[0] == "global"), device)
    return blocks, threads, path


def serving_counts_grid(flags: bool, C: int, cell_dim: int, G: int,
                        device: int = 0) -> tuple[int, int, tuple[str, ...]]:
    """(blocks, threads a block, path) of the row-range grid that
    `serving_counts` launches on card ``device`` for G segments over
    C*cell_dim cells, in its flags form (``flags``) or counts form; the
    path is the wrappers' (bitmap, form, tally)."""
    path = (_bitmap(C, cell_dim), "flags" if flags else "counts",
            _segment_regs(G))
    blocks, threads = _grid("serving_counts_grid", C, cell_dim, G,
                            int(path[0] == "global"), int(flags), device)
    return blocks, threads, path


def _ptr(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
         device: int, align: int = 1, view: bool = False) -> int:
    """The data pointer of ``t``, once it is a contiguous CUDA tensor on
    card ``device`` (the index of the call's first tensor; -1 off the
    card), of ``dtype`` and ``shape`` (None: any), ``align``-byte
    aligned. A ``view`` is a row view that `_row_view` has checked, and
    need not be contiguous."""
    if device < 0 or t.get_device() != device:
        on = f" on cuda:{device}" if device >= 0 else ""
        raise ValueError(f"{name} must be a CUDA tensor{on}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    ptr = t.data_ptr()
    if ptr % align or not (view or t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         f"aligned")
    return ptr


def _row_view(name: str, t: torch.Tensor, B: int, n: int) -> int:
    """The row stride of a (B, n) ``t`` whose rows may be a strided view:
    unit stride within a row, rows that do not overlap, a row stride
    below 2^31. Checked from the shape and strides alone."""
    if t.dim() != 2 or tuple(t.shape) != (B, n):
        raise ValueError(f"{name} must have shape {(B, n)}, got "
                         f"{tuple(t.shape)}")
    row, lane = t.stride()
    if lane != 1 or not (n <= row < 1 << 31 or B == 1):
        raise ValueError(f"{name} rows must have unit stride and not "
                         f"overlap, got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")
    return row


# ---- the paths, chosen from shapes before any tensor is read
# (README.md, port section), and the one limit left


def _stream_words(n: int) -> None:
    """The kernels index a stream's n words in int32: the one limit a
    wrapper still raises on (a stream of 2^30 words is 4 GB of table)."""
    if n > MAX_STREAM_WORDS:
        raise ValueError(f"a stream's {n} words exceed {MAX_STREAM_WORDS} "
                         f"(the kernels' int32 stream-words limit)")


def _bitmap(C: int, cell_dim: int) -> str:
    """Where the active-cell bitmap of C*D cells lives: "smem", built by
    each block in shared memory, up to what a block may hold; "global",
    built once a stream into a global scratch, past it."""
    return "smem" if C * cell_dim <= MAX_BITMAP_CELLS else "global"


def _streams(B: int) -> str:
    """`act_frozen`, `sp_update_pack`, `sp_rows` and `sp_overlap` run one
    grid row a stream ("grid_y") up to the grid's y extent, and fold the
    streams into grid x past it ("grid_x_streams")."""
    return "grid_y" if B <= MAX_GRID_Y else "grid_x_streams"


_ACT_NAMES = {torch.uint8: "u8", torch.bfloat16: "bf16",
              torch.float32: "f32"}


def _act_name(synapses: int) -> str:
    """The packed activity's type at K = ``synapses`` (`act_dtype`)."""
    return _ACT_NAMES[act_dtype(synapses)]


def _act_bytes(synapses: int) -> int:
    return act_dtype(synapses).itemsize


def _delta(C: int, I_pad: int) -> str:
    """Where `sp_update_pack` reads the delta row and the active-column
    bitmap: staged in shared memory ("smem_delta") while 4*I_pad +
    4*ceil(C/32) bytes fit a block, else from global memory
    ("gmem_delta")."""
    smem = 4 * I_pad + (C + 31) // 32 * 4
    return "smem_delta" if smem <= MAX_SHARED_BYTES else "gmem_delta"


def _grow_keys(cell_form: bool, Wc: int) -> tuple[str, str]:
    """`grow_select`'s path: the key form ("cell" up to 2^16 cells, else
    "index") and where a row's keys live: "smem", beside the candidate
    list in shared memory, while a list and one key row (8*Wc bytes) fit
    a block, else "global", in a (B, L, Wc) scratch."""
    return ("cell" if cell_form else "index",
            "smem" if 8 * Wc <= MAX_SHARED_BYTES else "global")


def _rows_mode(cols) -> str:
    """Where `row_counts`, `learn_rows` and `grow_select` read the active
    rows: "table", at the active columns ``cols`` of the state's tables,
    or "rows", gathered rows (``cols`` None: a column shard's rows)."""
    return "rows" if cols is None else "table"


def _fill_path(kk: int) -> str:
    """`learn_rows`' fill at kk chosen cells a row: "shfl" up to 32 (a
    row's cells read once, one a lane, and passed to their slots by
    shuffles), else "load" (each written slot reads its cell)."""
    return "shfl" if kk <= 32 else "load"


def _learn_loads(K: int) -> str:
    """`learn_rows`' loads at K slots a row: "v16" (a warp a column, eight
    slots a lane in 16-byte vectors) where the activity is u8 and K a
    multiple of 8, so that each lane's slots lie in one row and each
    column's in whole vectors; else "scalar" (a warp a row, a slot a
    lane): K = 125 and 127, the bf16 and f32 activity."""
    return "v16" if act_dtype(K) == torch.uint8 and K % 8 == 0 else "scalar"


def decide_split(B: int, A: int) -> int:
    """`column_decide`'s blocks a stream (csrc/decide_pass.cu): one where
    B streams of A columns fill DECIDE_FILL_BLOCKS blocks or a block's
    DECIDE_WARPS warps take every column at DECIDE_WARP_COLUMNS a warp
    (path "stream"); else ("split") as many as fill the blocks, up to one
    a DECIDE_WARPS * DECIDE_WARP_COLUMNS columns, at up to
    DECIDE_SPLIT_STREAMS streams."""
    if B > DECIDE_SPLIT_STREAMS:
        return 1
    most = -(-A // (DECIDE_WARPS * DECIDE_WARP_COLUMNS))
    return max(1, min(most, DECIDE_FILL_BLOCKS // max(B, 1)))


def _pack_path(D: int) -> str:
    """`pack_bits`' path at D bools a row: "ballot" where D is a multiple
    of 32 (every word 32 whole bytes), else a thread a word reading V-byte
    vectors, V the larger of 8 and 4 dividing D ("v8", "v4"), or single
    bytes ("v1")."""
    if D % 32 == 0:
        return "ballot"
    return next(f"v{v}" for v in (8, 4, 1) if D % v == 0)


def _select_path(B: int, C: int, A: int) -> tuple[str, str, str]:
    """`sp_select`'s path for B streams of C columns and A winners: the
    grid and where the keys live: "warp" (a warp a stream, its keys in
    registers) up to SELECT_WARP_WINNERS winners and SELECT_WARP_COLUMNS
    columns; "cluster" (two blocks a stream, its keys in their registers)
    past SELECT_CLUSTER_COLUMNS up to SELECT_REG_COLUMNS columns at up to
    SELECT_CLUSTER_STREAMS streams and SELECT_RANK_WINNERS winners; else a
    block a stream with its keys in registers ("regs") up to
    SELECT_REG_COLUMNS columns, else read again from the boosted values it
    wrote ("global"). How the winners are placed: "rank" (by counting the
    pairs above each) up to SELECT_RANK_WINNERS, else "lsd" (a stable LSD
    radix sort of the list by the block), or "cluster_lsd" (by a cluster
    of SELECT_SORT_BLOCKS blocks a stream) where the lists live in global
    memory. Where their (key, column) lists live: "smem", or "global" (a
    (B, 2A) int64 scratch) where the sort's two lists pass
    SELECT_LIST_BYTES."""
    if A <= SELECT_WARP_WINNERS and C <= SELECT_WARP_COLUMNS:
        grid = "warp"
    elif (SELECT_CLUSTER_COLUMNS < C <= SELECT_REG_COLUMNS
          and B <= SELECT_CLUSTER_STREAMS and A <= SELECT_RANK_WINNERS):
        grid = "cluster"
    else:
        grid = "regs" if C <= SELECT_REG_COLUMNS else "global"
    places = "rank" if A <= SELECT_RANK_WINNERS else "lsd"
    if places == "lsd" and 16 * A > SELECT_LIST_BYTES:
        return grid, "global", "cluster_lsd"
    return grid, "smem", places


def sp_rows_runs(B: int, I_pad: int, A: int) -> tuple[int, int, int]:
    """`sp_rows`' grid from the shapes (csrc/sp_pass.cu `RowGrid`):
    (tiles a row, units a run, runs a stream). A unit is a tile of 128
    packed bytes of one row; a stream's A * tiles units, tile-major, are
    cut into runs of one block each, about SP_ROWS_FILL_BLOCKS over the B
    streams, or runs of at most SP_ROWS_RUN_UNITS units where that makes
    more."""
    tiles = I_pad // 1024
    units = A * tiles
    if units == 0:
        return tiles, 0, 0
    runs = min(max(1, SP_ROWS_FILL_BLOCKS // max(B, 1),
                   -(-units // SP_ROWS_RUN_UNITS)), units)
    per = -(-units // runs)
    return tiles, per, -(-units // per)


def _row_claims(C: int) -> str:
    """How `sp_rows` finds the entries that repeat an earlier entry's
    column: "bitmap", each block marking its stream's columns in two
    C-bit bitmaps in shared memory, up to SP_ROWS_BITMAP_COLUMNS columns,
    else "scan" (each unit checks the entries before its own)."""
    return "bitmap" if C <= SP_ROWS_BITMAP_COLUMNS else "scan"


def _segment_regs(G: int) -> str:
    """`serving_counts`' tally at G segments: "g4", "g8", "g16" or "g32",
    the byte fields (four a register) in which a lane counts a row's
    words by segment before the warp sums them."""
    return next(f"g{n}" for n in (4, 8, 16, 32) if G <= n)


def _steps(window: int) -> str:
    """How the anomaly stages take a step of a ``window``-slot window:
    "lane" (a thread a step, the window's history in shared memory) up
    to ANOMALY_LANE_WINDOW slots, else "warp" (a warp a step, the window
    read from the series and the carried rings). The path fixes the
    order in which a step's sums add, so it depends on the window
    alone."""
    return "lane" if window <= ANOMALY_LANE_WINDOW else "warp"


_SERIES_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def _series_name(x) -> str:
    """The type of an anomaly stage's (T, B) input series: "f32", or
    "f64", which the kernel rounds to float32 as it reads it."""
    if x.dim() != 2:
        raise ValueError(f"the series must be (T, B), got {tuple(x.shape)}")
    if x.dtype not in _SERIES_NAMES:
        raise TypeError(f"the series must be float32 or float64, got "
                        f"{x.dtype}")
    return _SERIES_NAMES[x.dtype]


def _bitmap_scratch(path: str, B: int, C: int, cell_dim: int, device):
    """The global bitmap path's scratch (B streams of C*D bits, each row
    rounded up to 16 bytes: `bitmap_stride` in active_bitmap.cuh) and its
    pointer; None on the shared-memory path."""
    if path != "global":
        return None, None
    stride = ((C * cell_dim + 31) // 32 + 3) // 4 * 4
    scratch = torch.empty((B, stride), dtype=torch.int32, device=device)
    return scratch, scratch.data_ptr()


def _active_set(cols, bits, B: int, cell_dim: int, device: int):
    """The (B, A) cols + (B, A, W) bits active set, whose bitmap the
    kernel builds. Returns (A, W, cols pointer, bits pointer)."""
    A = cols.shape[-1]
    W = cell_words(cell_dim)
    cols_p = _ptr("cols", cols, torch.int32, (B, A), device)
    bits_p = _ptr("bits", bits, torch.int32, (B, A, W), device)
    return A, W, cols_p, bits_p


def _table(kernel: CudaKernel, name: str, table, dtype: torch.dtype, cols,
           bits, cell_dim: int, synapses: int, stream_rows: bool = False,
           column_dim: int | None = None):
    """A (B, C, J) table read with 16-byte vector loads, J = G*K, and its
    active set (``stream_rows``: a kernel with one grid row a stream).
    The table's C rows and the bitmap's ``column_dim`` columns (default
    C) may differ: a model-parallel rank holds a shard of C rows whose
    synapses target cells of all ``column_dim`` columns, so the stream
    limit is checked on the rows and the bitmap's path chosen on
    ``column_dim``. Reports ``kernel``'s path (bitmap, activity type and,
    with ``stream_rows``, streams) before it reads a tensor. Returns (B,
    C, J, A, W, device, table, cols and bits pointers, bitmap scratch and
    its pointer, path)."""
    if table.dim() != 3:
        raise ValueError(f"{name} must be (B, C, J), got "
                         f"{tuple(table.shape)}")
    B, C, J = table.shape
    if J % synapses or J // synapses > 32:
        raise ValueError(f"J={J} must be G*K with K={synapses} and G <= 32 "
                         f"(one bit per segment in a column's words)")
    if column_dim is not None and column_dim < 1:
        raise ValueError(f"column_dim must be >= 1, got {column_dim}")
    _stream_words(C * J)
    width = C if column_dim is None else column_dim
    path = kernel.choose(_bitmap(width, cell_dim), _act_name(synapses),
                         *((_streams(B),) if stream_rows else ()))
    dev = table.get_device()
    table_p = _ptr(name, table, dtype, None, dev, align=16)
    A, W, cols_p, bits_p = _active_set(cols, bits, B, cell_dim, dev)
    scratch, bm_p = _bitmap_scratch(path[0], B, width, cell_dim,
                                    table.device)
    return B, C, J, A, W, dev, table_p, cols_p, bits_p, scratch, bm_p, path


def table_update_cuda(syn, perm, act_prev, pun_word, cols, bits,
                      cell_dim: int, synapses: int, punishment: float,
                      perm_threshold: float,
                      column_dim: int | None = None) -> torch.Tensor:
    """CUDA `table_update`: punishes ``perm`` in place and writes the
    packed activity (B, C, J) in `act_dtype(synapses)` over
    ``act_prev``, which it returns (see `active_set.table_update_ref`).
    ``column_dim`` (default C): the columns of the cell space the active
    set spans, for a column shard of C rows."""
    B, C, J, A, W, dev, syn_p, cols_p, bits_p, _scratch, bm_p, _ = _table(
        TABLE_UPDATE, "syn", syn, torch.int32, cols, bits, cell_dim,
        synapses, column_dim=column_dim)
    dtype = act_dtype(synapses)
    perm_p = _ptr("perm", perm, torch.float32, syn.shape, dev, align=16)
    act_p = _ptr("act_prev", act_prev, dtype, syn.shape, dev, align=16)
    pun_p = _ptr("pun_word", pun_word, torch.int32, (B, C), dev)
    TABLE_UPDATE.launch(syn_p, perm_p, act_p, pun_p, cols_p, bits_p, bm_p,
                        act_p, B, C, column_dim or C, J, A, W, cell_dim,
                        synapses, punishment, perm_threshold,
                        act_scale(synapses), dtype.itemsize, dev,
                        _stream(dev))
    return act_prev


def _act_out(out, shape, dtype, device: torch.device
             ) -> tuple[torch.Tensor, int]:
    """The packed activity's output on ``device`` and its pointer:
    ``out`` (a state's activity buffer, checked) or a new tensor."""
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
        return out, out.data_ptr()
    return out, _ptr("out", out, dtype, shape, device.index, align=16)


def act_conn_cuda(syn, perm, cols, bits, cell_dim: int,
                  perm_threshold: float, synapses: int,
                  column_dim: int | None = None, out=None) -> torch.Tensor:
    """CUDA `act_conn`: packed activity (B, C, J) in
    `act_dtype(synapses)` over a read-only table (see
    `active_set.synapse_activation_conn_ref`), written into ``out`` where
    given (the state's activity buffer) else into a new tensor;
    ``column_dim`` as for `table_update_cuda`."""
    B, C, J, A, W, dev, syn_p, cols_p, bits_p, _scratch, bm_p, _ = _table(
        ACT_CONN, "syn", syn, torch.int32, cols, bits, cell_dim, synapses,
        column_dim=column_dim)
    dtype = act_dtype(synapses)
    perm_p = _ptr("perm", perm, torch.float32, syn.shape, dev, align=16)
    v, v_p = _act_out(out, syn.shape, dtype, syn.device)
    ACT_CONN.launch(syn_p, perm_p, cols_p, bits_p, bm_p, v_p, B, C,
                    column_dim or C, J, A, W, cell_dim, synapses,
                    perm_threshold, act_scale(synapses), dtype.itemsize, dev,
                    _stream(dev))
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
    _stream_words(R * 128)
    path = SERVING_ACTIVATION.choose(_bitmap(column_dim, cell_dim))
    dev = rows.get_device()
    rows_p = _ptr("rows", rows, torch.int32, None, dev, align=16)
    A, W, cols_p, bits_p = _active_set(cols, bits, B, cell_dim, dev)
    out = torch.empty((B, R, 128), dtype=torch.uint8, device=rows.device)
    if out.numel() == 0:
        return out
    _scratch, bm_p = _bitmap_scratch(path[0], B, column_dim, cell_dim,
                                     rows.device)
    SERVING_ACTIVATION.launch(rows_p, cols_p, bits_p, bm_p, out.data_ptr(),
                              B, R, A, W, column_dim, cell_dim, dev,
                              _stream(dev))
    return out


def _serving_table(kernel: CudaKernel, form: str, rows, ext_col, cols,
                   bits, column_dim: int, cell_dim: int, G: int):
    """A compact serving table's (B, R, 128) ``rows`` and (B, E)
    ``ext_col`` with R = C*M + E for C = ``column_dim``, its active set
    and G segments. Reports ``kernel``'s path (bitmap, ``form``, tally)
    before it reads a tensor. Returns (B, R, E, A, W, device, rows,
    ext_col, cols and bits pointers, bitmap scratch and its pointer)."""
    if rows.dim() != 3 or rows.shape[-1] != 128 or ext_col.dim() != 2:
        raise ValueError(f"rows must be (B, R, 128) and ext_col (B, E), "
                         f"got {tuple(rows.shape)} and "
                         f"{tuple(ext_col.shape)}")
    B, R, _ = rows.shape
    E = ext_col.shape[1]
    if (column_dim < 1 or cell_dim < 1 or not 1 <= G <= 32 or R < E
            or (R - E) % column_dim):
        raise ValueError(f"a serving table of {R} rows and {E} extension "
                         f"rows does not fit {column_dim} columns, or D="
                         f"{cell_dim} < 1, or G={G} is not in [1, 32]")
    _stream_words(R * 128)
    path = kernel.choose(_bitmap(column_dim, cell_dim), form,
                         _segment_regs(G))
    dev = rows.get_device()
    rows_p = _ptr("rows", rows, torch.int32, None, dev, align=16)
    ext_p = _ptr("ext_col", ext_col, torch.int32, (B, E), dev)
    A, W, cols_p, bits_p = _active_set(cols, bits, B, cell_dim, dev)
    scratch, bm_p = _bitmap_scratch(path[0], B, column_dim, cell_dim,
                                    rows.device)
    return B, R, E, A, W, dev, rows_p, ext_p, cols_p, bits_p, scratch, bm_p


def serving_counts_cuda(rows, ext_col, cols, bits, column_dim: int,
                        cell_dim: int, num_segments: int) -> torch.Tensor:
    """CUDA `serving_counts`, counts form: the (B, C, G) int32 connected-
    active counts of a compact serving table's ``rows`` and ``ext_col``
    (see `serving.serving_counts_ref`), in one pass over the words."""
    G = num_segments
    (B, R, E, A, W, dev, rows_p, ext_p, cols_p, bits_p, _scratch,
     bm_p) = _serving_table(SERVING_COUNTS, "counts", rows, ext_col, cols,
                            bits, column_dim, cell_dim, G)
    counts = torch.empty((B, column_dim, G), dtype=torch.int32,
                         device=rows.device)
    if B:
        SERVING_COUNTS.launch(rows_p, ext_p, cols_p, bits_p, None, bm_p,
                              counts.data_ptr(), None, None, B, R, E, A, W,
                              column_dim, cell_dim, G, 0, 0, dev,
                              _stream(dev))
    return counts


def serving_flags_cuda(rows, ext_col, cols, bits, seg_cell, column_dim: int,
                       cell_dim: int, matching_threshold: int,
                       activation_threshold: int) -> tuple:
    """CUDA `serving_counts`, flags form: from a compact serving table's
    ``rows`` and ``ext_col`` and the (B, C, G) int32 owner cells, the
    matching word (B, C) int32 (bit g where the count >= ``matching_
    threshold``) and the (B, W, C) int32 prediction words, W =
    ceil(D/32) (bit d of word w where a segment with count >= ``activation_
    threshold`` is owned by cell 32w + d); it writes no counts (see
    `serving.serving_flags_ref`)."""
    if seg_cell.dim() != 3:
        raise ValueError(f"seg_cell must be (B, C, G), got "
                         f"{tuple(seg_cell.shape)}")
    G = seg_cell.shape[-1]
    (B, R, E, A, W, dev, rows_p, ext_p, cols_p, bits_p, _scratch,
     bm_p) = _serving_table(SERVING_COUNTS, "flags", rows, ext_col, cols,
                            bits, column_dim, cell_dim, G)
    cell_p = _ptr("seg_cell", seg_cell, torch.int32, (B, column_dim, G),
                  dev)
    word = torch.empty((B, column_dim), dtype=torch.int32, device=rows.device)
    pred = torch.empty((B, W, column_dim), dtype=torch.int32,
                       device=rows.device)
    if B:
        SERVING_COUNTS.launch(rows_p, ext_p, cols_p, bits_p, cell_p, bm_p,
                              None, word.data_ptr(), pred.data_ptr(), B, R,
                              E, A, W, column_dim, cell_dim, G,
                              int(matching_threshold),
                              int(activation_threshold), dev, _stream(dev))
    return word, pred


def act_frozen_cuda(frozen_word, cols, bits, cell_dim: int,
                    synapses: int, out=None) -> torch.Tensor:
    """CUDA `act_frozen`: packed activity (B, C, J) in
    `act_dtype(synapses)` over a frozen word table (see
    `active_set.synapse_activation_frozen_ref`), written into ``out``
    where given, else into a new tensor."""
    (B, C, J, A, W, dev, word_p, cols_p, bits_p, _scratch, bm_p,
     path) = _table(
        ACT_FROZEN, "frozen_word", frozen_word, torch.int32, cols, bits,
        cell_dim, synapses, stream_rows=True)
    dtype = act_dtype(synapses)
    v, v_p = _act_out(out, frozen_word.shape, dtype, frozen_word.device)
    if v.numel() == 0:
        return v
    ACT_FROZEN.launch(word_p, cols_p, bits_p, bm_p, v_p, B, C, J, A,
                      W, cell_dim, act_scale(synapses), dtype.itemsize,
                      int(path[-1] == "grid_x_streams"), dev,
                      _stream(dev))
    return v


def synapse_activation_cuda(syn, cols, bits, column_dim: int,
                            cell_dim: int) -> torch.Tensor:
    """CUDA `synapse_activation`: (B, R, J) u8, 1 where the slot's
    presynaptic cell is in the active set (see
    `active_set.synapse_activation_ref`)."""
    if syn.dim() != 3:
        raise ValueError(f"syn must be (B, R, J), got {tuple(syn.shape)}")
    B, R, J = syn.shape
    _stream_words(R * J)
    path = SYNAPSE_ACTIVATION.choose(_bitmap(column_dim, cell_dim))
    dev = syn.get_device()
    syn_p = _ptr("syn", syn, torch.int32, None, dev, align=16)
    A, W, cols_p, bits_p = _active_set(cols, bits, B, cell_dim, dev)
    out = torch.empty((B, R, J), dtype=torch.uint8, device=syn.device)
    if out.numel() == 0:
        return out
    _scratch, bm_p = _bitmap_scratch(path[0], B, column_dim, cell_dim,
                                     syn.device)
    SYNAPSE_ACTIVATION.launch(syn_p, cols_p, bits_p, bm_p, out.data_ptr(), B,
                              R, J, A, W, column_dim, cell_dim, dev,
                              _stream(dev))
    return out


def small_table_take_cuda(table, keys, mask: int = -1,
                          in_place: bool = False) -> torch.Tensor:
    """CUDA `small_table_take`: out[b, ...] = table[b, k] with k = keys[b,
    ...] & mask where 0 <= k < Wc, 0 elsewhere, for a (B, Wc) table of any
    width whose rows may be a strided view (unit stride within a row;
    see `active_set.take_small_table_ref`); ``in_place`` writes out over
    ``keys`` and allocates nothing."""
    shape, kshape = table.shape, keys.shape
    if (len(shape) != 2 or len(kshape) < 2 or kshape[0] != shape[0]
            or shape[1] < 1 or not -(1 << 31) <= mask < 1 << 31):
        raise ValueError(f"table must be (B, Wc) with Wc >= 1, keys (B, ...) "
                         f"and mask an int32; got {tuple(shape)}, "
                         f"{tuple(kshape)} and {mask}")
    B, Wc = shape
    n = keys.numel() // B if B else 0
    _stream_words(n)
    row = _row_view("table", table, B, Wc)
    dev = table.get_device()
    table_p = _ptr("table", table, torch.int32, None, dev, view=True)
    keys_p = _ptr("keys", keys, torch.int32, None, dev)
    out = keys if in_place else torch.empty_like(keys)
    if n:
        SMALL_TABLE_TAKE.launch(table_p, row, keys_p,
                                keys_p if in_place else out.data_ptr(), B,
                                Wc, n, mask, dev, _stream(dev))
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
    path = SP_UPDATE_PACK.choose(_delta(C, I_pad), _streams(B))
    dev = permanence.get_device()
    perm_p = _ptr("permanence", permanence, permanence.dtype, None, dev,
                  align=16)
    delta_p = _ptr("delta_row", delta_row,
                   torch.int32 if quantized else torch.float32, (B, I_pad),
                   dev, align=16)
    A = active_cols.shape[-1]
    cols_p = _ptr("active_cols", active_cols, torch.int32, (B, A), dev)
    pack = torch.empty((B, C, I_pad // 8), dtype=torch.uint8,
                       device=permanence.device)
    if pack.numel() == 0:
        return permanence, pack
    col_bitmaps = col_p = None
    if path[0] == "gmem_delta":  # each stream's active-column bitmap
        col_bitmaps = torch.empty((B, (C + 31) // 32), dtype=torch.int32,
                                  device=permanence.device)
        col_p = col_bitmaps.data_ptr()
    SP_UPDATE_PACK.launch(perm_p, delta_p, cols_p, col_p, pack.data_ptr(), B,
                          C, I_pad, A, int(quantized), float(threshold),
                          int(threshold) if quantized else 0,
                          int(path[1] == "grid_x_streams"), dev,
                          _stream(dev))
    return permanence, pack


def sp_rows_cuda(permanence, connected, input_bits, active_cols, d_on,
                 d_off, threshold) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA `sp_rows`: the Hebbian update of the active rows of
    ``permanence`` (B, C, I_pad), int16 units or float32, and of their
    packed rows in ``connected`` (B, C, I_pad/8) u8, in place, toward the
    (B, I) bool ``input_bits``; ``d_on`` / ``d_off`` are the delta of an
    active / inactive input lane and ``threshold`` the connected
    threshold, in the table's units (`spatial_pooler.hebbian_steps`; see
    `spatial_pooler.sp_rows_ref`). Returns (permanence, connected)."""
    if permanence.dim() != 3 or input_bits.dim() != 2:
        raise ValueError(f"permanence must be (B, C, I_pad) and input_bits "
                         f"(B, I), got {tuple(permanence.shape)} and "
                         f"{tuple(input_bits.shape)}")
    B, C, I_pad = permanence.shape
    I = input_bits.shape[-1]
    if permanence.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"permanence must be int16 or float32, got "
                        f"{permanence.dtype}")
    quantized = permanence.dtype == torch.int16
    if I_pad % 1024 or I > I_pad:
        raise ValueError(f"I_pad={I_pad} must be 8*S with S a multiple of "
                         f"128 (ops/overlap.py input_words) and hold "
                         f"I={I} inputs")
    if quantized and not all(v == int(v) for v in (d_on, d_off, threshold)):
        raise ValueError(f"an int16 table takes integer deltas and "
                         f"threshold in units, got {d_on}, {d_off} and "
                         f"{threshold}")
    path = SP_ROWS.choose(_streams(B), _row_claims(C))
    dev = permanence.get_device()
    perm_p = _ptr("permanence", permanence, permanence.dtype, None, dev,
                  align=16)
    conn_p = _ptr("connected", connected, torch.uint8, (B, C, I_pad // 8),
                  dev, align=16)
    bits_p = _ptr("input_bits", input_bits, torch.bool, (B, I), dev)
    A = active_cols.shape[-1]
    cols_p = _ptr("active_cols", active_cols, torch.int32, (B, A), dev)
    if B * C * A:
        units = [int(v) if quantized else 0 for v in (d_on, d_off,
                                                      threshold)]
        SP_ROWS.launch(perm_p, conn_p, bits_p, cols_p, B, C, I, I_pad, A,
                       int(quantized), float(d_on), float(d_off),
                       float(threshold), *units,
                       int(path[0] == "grid_x_streams"), dev, _stream(dev))
    return permanence, connected


def sp_overlap_cuda(connected, input_bits) -> torch.Tensor:
    """CUDA `sp_overlap`: (B, C) int32 overlap counts of a (B, C, S) u8
    packed connected table with the (B, I) bool inputs, S =
    `input_words(I)`; the kernel packs the inputs itself (see
    `overlap.overlaps_ref`). Any C: a column shard's table holds its
    rows only."""
    if connected.dim() != 3 or input_bits.dim() != 2:
        raise ValueError(f"connected must be (B, C, S) and input_bits (B, "
                         f"I), got {tuple(connected.shape)} and "
                         f"{tuple(input_bits.shape)}")
    B, C, S = connected.shape
    I = input_bits.shape[-1]
    if S != input_words(I):
        raise ValueError(f"connected rows of S={S} bytes do not hold "
                         f"I={I} inputs (input_words: {input_words(I)})")
    _stream_words(C * S // 4)
    path = SP_OVERLAP.choose(_streams(B))
    dev = connected.get_device()
    conn_p = _ptr("connected", connected, torch.uint8, None, dev, align=16)
    bits_p = _ptr("input_bits", input_bits, torch.bool, (B, I), dev)
    out = torch.empty((B, C), dtype=torch.int32, device=connected.device)
    if out.numel() == 0:
        return out
    SP_OVERLAP.launch(conn_p, bits_p, out.data_ptr(), B, C, S, I,
                      int(path[0] == "grid_x_streams"), dev, _stream(dev))
    return out


def seg_counts_cuda(packed, num_segments: int, synapses: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA `seg_counts`: the (B, C, G*K) packed activity in
    `act_dtype(K)` -> (potential, connected) int32 (B, C, G), the exact
    decode of each segment's sum (see
    `active_set.seg_counts_packed_ref`)."""
    if packed.dim() != 3:
        raise ValueError(f"packed must be (B, C, G*K), got "
                         f"{tuple(packed.shape)}")
    B, C, J = packed.shape
    G, K = num_segments, synapses
    if K < 1 or G < 0 or J != G * K:
        raise ValueError(f"packed rows of J={J} values are not G={G} "
                         f"segments of K={K}")
    dtype = act_dtype(K)
    _stream_words(C * J * dtype.itemsize // 4)
    SEG_COUNTS.choose(_act_name(K))
    dev = packed.get_device()
    v_p = _ptr("packed", packed, dtype, None, dev, align=16)
    potential = torch.empty((B, C, G), dtype=torch.int32,
                            device=packed.device)
    connected = torch.empty_like(potential)
    if potential.numel() == 0:
        return potential, connected
    SEG_COUNTS.launch(v_p, potential.data_ptr(), connected.data_ptr(), None,
                      None, None, B, C, G, K, act_scale(K), dtype.itemsize, 0,
                      0, 0, dev, _stream(dev))
    return potential, connected


def seg_flags_cuda(packed, seg_cell, synapses: int, matching_threshold: int,
                   activation_threshold: int, cell_dim: int,
                   prediction: bool = True) -> tuple:
    """CUDA `seg_counts`, flags form: the (B, C, G*K) packed activity and
    the (B, C, G) int32 owner cells -> (matching_word (B, C) int32, bit g
    where potential >= ``matching_threshold``; the (B, W, C) int32
    prediction words, only with ``prediction``, else None), W =
    ceil(D/32): bit d of word w where a matching segment with connected
    >= ``activation_threshold`` is owned by cell 32w + d (see
    `active_set.seg_counts_flags_ref`). It writes no counts."""
    if packed.dim() != 3 or seg_cell.dim() != 3:
        raise ValueError(f"packed must be (B, C, G*K) and seg_cell (B, C, "
                         f"G), got {tuple(packed.shape)} and "
                         f"{tuple(seg_cell.shape)}")
    B, C, J = packed.shape
    G, K = seg_cell.shape[-1], synapses
    if K < 1 or G < 1 or G > 32 or J != G * K or cell_dim < 1:
        raise ValueError(f"packed rows of J={J} values are not G={G} <= 32 "
                         f"segments of K={K}, or D={cell_dim} < 1")
    dtype = act_dtype(K)
    _stream_words(C * J * dtype.itemsize // 4)
    SEG_COUNTS.choose(_act_name(K), "flags")
    dev = packed.get_device()
    v_p = _ptr("packed", packed, dtype, None, dev, align=16)
    cell_p = _ptr("seg_cell", seg_cell, torch.int32, (B, C, G), dev)
    word = torch.empty((B, C), dtype=torch.int32, device=packed.device)
    pred = torch.empty((B, cell_words(cell_dim), C), dtype=torch.int32,
                       device=packed.device) if prediction else None
    if word.numel():
        SEG_COUNTS.launch(v_p, None, None, cell_p, word.data_ptr(),
                          None if pred is None else pred.data_ptr(), B, C, G,
                          K, act_scale(K), dtype.itemsize, cell_dim,
                          int(matching_threshold), int(activation_threshold),
                          dev, _stream(dev))
    return word, pred


def _active_rows(name: str, table, learn, cols):
    """The geometry of the active rows of a (B, Ct, J) ``table`` with (B,
    R) ``learn`` flags: at the (B, A) columns ``cols`` ("table" mode) or,
    with ``cols`` None, the table's own Ct = A columns ("rows" mode); R =
    A*G. Returns (B, Ct, A, G, K)."""
    if table.dim() != 3 or learn.dim() != 2 or learn.shape[0] != \
            table.shape[0]:
        raise ValueError(f"{name} must be (B, Ct, G*K) and the rows' flags "
                         f"(B, R), got {tuple(table.shape)} and "
                         f"{tuple(learn.shape)}")
    B, Ct, J = table.shape
    R = learn.shape[1]
    A = Ct if cols is None else cols.shape[-1]
    G = R // A if A else 0
    if G < 1 or R != A * G or J % G:
        raise ValueError(f"{R} rows are not G segments of each of A={A} "
                         f"columns of J={J} slots")
    return B, Ct, A, G, J // G


def grow_select_cuda(syn_rows, act_rows, learn_rows, prev_cols,
                     prev_winner_bits, rnd, cell_dim: int, samp: int,
                     key_bits: int, cell_form: bool, row_cols=None,
                     new_seg=None) -> tuple:
    """CUDA `grow_select`: `_grow`'s lists and candidate selection for
    the active rows of the (B, Ct, J) int32 synapse table ``syn_rows``
    and its activity ``act_rows`` (bool, or the packed activity in its
    own type; nonzero = active), the (B, R) bool learning flags, the (B,
    A) previous active columns and their (B, A, ceil(D/32)) int32 winner
    words, and (B, L, Wc) int32 random words. The rows lie at the columns
    ``row_cols`` (B, R/G) of the tables, or, where it is None, are the
    table's own (a (B, R, K) table of rows, or gathered (B, R/G, G*K)
    rows); ``new_seg`` (B, R) bool rows read as empty -> (chosen (B, L,
    kk), n_chosen (B, L), lidx (B, L), lvalid (B, L) bool, lpos (B, R),
    cand_cell (B, Wc), counts (4, B)) int32 but lvalid, kk = min(samp,
    Wc): the cells (``cell_form``) or the index-form keys of the n_chosen
    smallest keys, ascending (see `temporal_memory.grow_select_ref`)."""
    if (syn_rows.dim() != 3 or prev_cols.dim() != 2 or rnd.dim() != 3
            or learn_rows.dim() != 2):
        raise ValueError(f"syn_rows must be (B, R, K), learn_rows (B, R), "
                         f"prev_cols (B, A) and rnd (B, L, Wc), got "
                         f"{tuple(syn_rows.shape)}, "
                         f"{tuple(learn_rows.shape)}, "
                         f"{tuple(prev_cols.shape)} and {tuple(rnd.shape)}")
    B, Ct, J = syn_rows.shape
    R = learn_rows.shape[1]
    A = prev_cols.shape[1]
    L, Wc = rnd.shape[1:]
    shift = 1 if cell_form else 2
    A_rows = Ct if row_cols is None else row_cols.shape[-1]
    G = R // A_rows if A_rows and R % A_rows == 0 else 0
    K = J // G if G and J % G == 0 else 0
    if R < 1 or K < 1 or Wc < 1 or samp < 1 or cell_dim < 1 or not \
            1 <= key_bits <= 31 - shift:
        raise ValueError(f"grow_select needs R, K, Wc, samp, D >= 1 and key "
                         f"bits in [1, {31 - shift}], got R={R} K={K} "
                         f"Wc={Wc} samp={samp} D={cell_dim} bits={key_bits}")
    W = cell_words(cell_dim)
    if tuple(prev_winner_bits.shape) != (B, A, W):
        raise ValueError(f"prev_winner_bits must hold the winner words of "
                         f"the (B, A) columns, (B, A, ceil(D/32)) = "
                         f"{(B, A, W)}, got {tuple(prev_winner_bits.shape)}")
    _stream_words(Ct * J)
    _stream_words(L * Wc)
    _stream_words(A * W)
    path = GROW_SELECT.choose(*_grow_keys(cell_form, Wc))
    dev = syn_rows.get_device()
    syn_p = _ptr("syn_rows", syn_rows, torch.int32, None, dev)
    if act_rows.dtype not in (torch.bool, torch.uint8, torch.bfloat16,
                              torch.float32):
        raise TypeError(f"act_rows must be bool or a packed activity type, "
                        f"got {act_rows.dtype}")
    act_p = _ptr("act_rows", act_rows, act_rows.dtype, (B, Ct, J), dev)
    learn_p = _ptr("learn_rows", learn_rows, torch.bool, (B, R), dev)
    rcols_p = None if row_cols is None else _ptr(
        "row_cols", row_cols, torch.int32, (B, A_rows), dev)
    fresh_p = None if new_seg is None else _ptr(
        "new_seg", new_seg, torch.bool, (B, R), dev)
    cols_p = _ptr("prev_cols", prev_cols, torch.int32, (B, A), dev)
    bits_p = _ptr("prev_winner_bits", prev_winner_bits, torch.int32,
                  (B, A, W), dev)
    rnd_p = _ptr("rnd", rnd, torch.int32, (B, L, Wc), dev)
    kk = min(samp, Wc)

    def new(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=syn_rows.device)

    out = (new(B, L, kk), new(B, L), new(B, L), new(B, L, dtype=torch.bool),
           new(B, R), new(B, Wc), new(4, B))
    if B == 0:
        return out
    scratch = scratch_p = None
    if path[1] == "global":
        scratch = new(B, L, Wc)
        scratch_p = scratch.data_ptr()
    GROW_SELECT.launch(syn_p, act_p, act_rows.element_size(), rcols_p, Ct, G,
                       fresh_p, learn_p, cols_p, bits_p, rnd_p,
                       *(t.data_ptr() for t in out), scratch_p, B, R, K, A,
                       cell_dim, L, Wc, samp, key_bits, int(cell_form),
                       int(path[1] == "global"), dev, _stream(dev))
    return out


def row_counts_cuda(syn, perm, act, cols, num_segments: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA `row_counts`: the (potential, connected, live) int32 (B, A, G)
    counts of the active rows of the (B, Ct, G*K) synapse tables (int32
    syn, float32 perm, act in `act_dtype(K)`), at the (B, A) columns
    ``cols`` or, with ``cols`` None, of gathered rows (Ct = A); see
    `temporal_memory.row_counts_ref`."""
    G = num_segments
    if syn.dim() != 3 or G < 1 or syn.shape[-1] % G:
        raise ValueError(f"syn must be (B, Ct, G*K) with G={G}, got "
                         f"{tuple(syn.shape)}")
    B, Ct, J = syn.shape
    K = J // G
    A = Ct if cols is None else cols.shape[-1]
    _stream_words(Ct * J)
    dtype = act_dtype(K)
    ROW_COUNTS.choose(_act_name(K), _rows_mode(cols))
    dev = syn.get_device()
    syn_p = _ptr("syn", syn, torch.int32, None, dev)
    perm_p = _ptr("perm", perm, torch.float32, (B, Ct, J), dev)
    act_p = _ptr("act", act, dtype, (B, Ct, J), dev)
    cols_p = None if cols is None else _ptr("cols", cols, torch.int32,
                                            (B, A), dev)
    out = tuple(torch.empty((B, A, G), dtype=torch.int32, device=syn.device)
                for _ in range(3))
    if out[0].numel():
        ROW_COUNTS.launch(syn_p, perm_p, act_p, cols_p,
                          *(t.data_ptr() for t in out), B, Ct, A, G, K,
                          act_scale(K), dtype.itemsize, dev, _stream(dev))
    return out


def learn_rows_cuda(syn, perm, act, cols, learn, new_seg, lpos, chosen,
                    n_chosen, counts, increment: float, decrement: float,
                    permanence_initial: float, want_mask: bool = False):
    """CUDA `learn_rows`: the learning pass over the active rows of the
    (B, Ct, G*K) synapse tables, syn (int32) and perm (float32) updated
    in place, act in `act_dtype(K)` read, at the (B, A) columns ``cols``
    or, with ``cols`` None, of gathered rows (Ct = A); ``learn`` and
    ``new_seg`` (B, R) bool, R = A*G; ``lpos`` (B, R) int32 each row's
    place in `grow_select`'s list; ``chosen`` (B, L, kk) cells and
    ``n_chosen`` (B, L) int32; rows 0 and 1 of the (4, B) int32
    ``counts`` gain the slots grown and the overflow. Returns the (B, R,
    K) bool mask of the slots grown with ``want_mask``, else None (see
    `temporal_memory.learn_rows_ref`)."""
    if chosen.dim() != 3 or n_chosen.dim() != 2:
        raise ValueError(f"chosen must be (B, L, kk) and n_chosen (B, L), "
                         f"got {tuple(chosen.shape)} and "
                         f"{tuple(n_chosen.shape)}")
    B, Ct, A, G, K = _active_rows("syn", syn, learn, cols)
    R = A * G
    L, kk = chosen.shape[1:]
    if kk < 1 or tuple(n_chosen.shape) != (B, L):
        raise ValueError(f"learn_rows needs kk >= 1 chosen cells a row and "
                         f"n_chosen (B, L) = {(B, L)}, got kk={kk} and "
                         f"{tuple(n_chosen.shape)}")
    _stream_words(Ct * G * K)
    _stream_words(L * kk)
    dtype = act_dtype(K)
    path = LEARN_ROWS.choose(_act_name(K), _rows_mode(cols), _fill_path(kk),
                             _learn_loads(K))
    vec = path[3] == "v16"
    dev = syn.get_device()
    syn_p = _ptr("syn", syn, torch.int32, None, dev, align=16 if vec else 1)
    cols_p = None if cols is None else _ptr("cols", cols, torch.int32,
                                            (B, A), dev)
    perm_p = _ptr("perm", perm, torch.float32, (B, Ct, G * K), dev,
                  align=16 if vec else 1)
    act_p = _ptr("act", act, dtype, (B, Ct, G * K), dev,
                 align=8 if vec else 1)
    learn_p = _ptr("learn", learn, torch.bool, (B, R), dev)
    fresh_p = _ptr("new_seg", new_seg, torch.bool, (B, R), dev)
    lpos_p = _ptr("lpos", lpos, torch.int32, (B, R), dev)
    chosen_p = _ptr("chosen", chosen, torch.int32, None, dev)
    n_p = _ptr("n_chosen", n_chosen, torch.int32, (B, L), dev)
    counts_p = _ptr("counts", counts, torch.int32, (4, B), dev)
    wrote = (torch.empty((B, R, K), dtype=torch.bool, device=syn.device)
             if want_mask else None)
    if B * R:
        LEARN_ROWS.launch(syn_p, perm_p, act_p, cols_p, learn_p, fresh_p,
                          lpos_p, chosen_p, n_p, counts_p,
                          None if wrote is None else wrote.data_ptr(), B, Ct,
                          A, G, K, L, kk, float(increment), float(decrement),
                          float(permanence_initial), dtype.itemsize, int(vec),
                          dev, _stream(dev))
    return wrote


# `column_decide`'s modes, by what a step asks of it: the bursting columns
# and the activity words only (no winner cells), the winner selection too,
# or the learning step's decisions too (`temporal_memory.column_decide_ref`)
DECIDE_MODES = ("burst", "winner", "learn")


def column_decide_cuda(prediction, seg_cell, cols, pot, conn, live, u_seg,
                       u_least, step, cell_dim: int, mode: str,
                       matching_threshold: int, activation_threshold: int,
                       epsilon: float, evict: bool) -> tuple:
    """CUDA `column_decide`: the column decisions of a step, per stream
    and active column, from the previous prediction words ``prediction``
    (B, W, Ct) int32, W = ceil(D/32), the owners ``seg_cell`` (B, Ct, G)
    int32 (``mode`` "learn": the new owners written over it in place),
    at the (B, A) columns ``cols`` or, with ``cols`` None, of gathered
    rows (Ct = A); the row counts ``pot``, ``conn``, ``live`` (B, A, G)
    int32, the draws ``u_seg`` (B, A, G) and ``u_least`` (B, A, D) float32
    and ``step`` (B,) int32, as far as ``mode`` reads them (`DECIDE_MODES`;
    "burst" reads the words alone). ``epsilon`` is rounded to float32 once.
    Returns (act_bits, winner_bits (B, A, W) int32, col_burst (B, A) bool,
    learn, new_seg (B, A*G) bool or None, counts (7 with "learn", else 3,
    B) int32); see `temporal_memory.column_decide_ref`."""
    if mode not in DECIDE_MODES:
        raise ValueError(f"mode must be one of {DECIDE_MODES}, got {mode!r}")
    if prediction.dim() != 3:
        raise ValueError(f"prediction must be (B, W, Ct), got "
                         f"{tuple(prediction.shape)}")
    B, W, Ct = prediction.shape
    A = Ct if cols is None else cols.shape[-1]
    D = cell_dim
    G = 1 if mode == "burst" else seg_cell.shape[-1]
    if D < 1 or W != cell_words(D) or not 1 <= G <= 32:
        raise ValueError(f"prediction words of W={W} do not hold D={D} "
                         f"cells, or G={G} is not in [1, 32]")
    _stream_words(W * Ct)
    split = decide_split(B, A)
    COLUMN_DECIDE.choose(mode, _rows_mode(cols),
                         "split" if split > 1 else "stream")
    dev = prediction.get_device()
    pred_p = _ptr("prediction", prediction, torch.int32, None, dev)
    cols_p = None if cols is None else _ptr("cols", cols, torch.int32,
                                            (B, A), dev)
    rows = (B, A, G)
    cell_p = pot_p = conn_p = live_p = useg_p = uleast_p = step_p = None
    if mode != "burst":
        cell_p = _ptr("seg_cell", seg_cell, torch.int32, (B, Ct, G), dev)
        pot_p = _ptr("pot", pot, torch.int32, rows, dev)
        useg_p = _ptr("u_seg", u_seg, torch.float32, rows, dev)
        uleast_p = _ptr("u_least", u_least, torch.float32, (B, A, D), dev)
    if mode == "learn":
        conn_p = _ptr("conn", conn, torch.int32, rows, dev)
        live_p = _ptr("live", live, torch.int32, rows, dev)
        step_p = _ptr("step", step, torch.int32, (B,), dev)

    def new(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=prediction.device)

    learning = mode == "learn"
    out = (new(B, A, W), new(B, A, W), new(B, A, dtype=torch.bool),
           new(B, A * G, dtype=torch.bool) if learning else None,
           new(B, A * G, dtype=torch.bool) if learning else None,
           new(7 if learning else 3, B))
    if B * A == 0:
        out[-1].zero_()
        return out
    COLUMN_DECIDE.launch(pred_p, cell_p, cols_p, pot_p, conn_p, live_p,
                         useg_p, uleast_p, step_p,
                         *(None if t is None else t.data_ptr() for t in out),
                         B, Ct, A, G, D, DECIDE_MODES.index(mode),
                         int(matching_threshold), int(activation_threshold),
                         float(epsilon), int(evict), split, dev,
                         _stream(dev))
    return out


def pack_bits_cuda(mask) -> torch.Tensor:
    """CUDA `pack_bits`: (..., D) bool, contiguous -> (..., W) int32
    words, W = ceil(D/32), bit d of word d//32, zeros past D (see
    `active_set.pack_bits_ref`)."""
    if mask.dim() < 1:
        raise ValueError("mask must have a last axis of D bools")
    D = mask.shape[-1]
    W = cell_words(D)
    path = PACK_BITS.choose(_pack_path(D))
    dev = mask.get_device()
    align = 1 if path[0] in ("ballot", "v1") else int(path[0][1:])
    mask_p = _ptr("mask", mask, torch.bool, None, dev, align=align)
    out = torch.empty((*mask.shape[:-1], W), dtype=torch.int32,
                      device=mask.device)
    if out.numel() == 0:
        return out
    PACK_BITS.launch(mask_p, out.data_ptr(), mask.numel() // D, D, dev,
                     _stream(dev))
    return out


def sp_select_cuda(overlaps, duty_cycle, k: int, scale: float,
                   momentum: float, one_minus: float) -> tuple:
    """CUDA `sp_select`: the SP's column selection of a step for the
    (B, C) int32 ``overlaps`` and float32 ``duty_cycle``: the boosted
    overlaps, the ``k`` winners (B, k) int32 in the order of a stable
    descending sort, their (B, C) bool mask and the new duty cycles, each
    a new tensor; ``scale``, ``momentum`` and ``one_minus`` are the
    float32 scalars of `regularization.select_scalars` (see
    `regularization.sp_select_ref`)."""
    if overlaps.dim() != 2:
        raise ValueError(f"overlaps must be (B, C), got "
                         f"{tuple(overlaps.shape)}")
    B, C = overlaps.shape
    if not 0 <= k <= C:
        raise ValueError(f"k={k} winners must be in [0, C={C}]")
    path = SP_SELECT.choose(*_select_path(B, C, k))
    dev = overlaps.get_device()
    ov_p = _ptr("overlaps", overlaps, torch.int32, None, dev, align=16)
    duty_p = _ptr("duty_cycle", duty_cycle, torch.float32, (B, C), dev,
                  align=16)

    def new(n, dtype):
        return torch.empty((B, n), dtype=dtype, device=overlaps.device)

    out = (new(C, torch.float32), new(k, torch.int32), new(C, torch.bool),
           new(C, torch.float32))
    if B * C == 0:
        return out
    scratch = new(2 * k, torch.int64) if path[1] == "global" else None
    SP_SELECT.launch(ov_p, duty_p, *(t.data_ptr() for t in out[:3]),
                     out[3].data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     B, C, k, scale, momentum, one_minus, dev, _stream(dev))
    return out


def _series_state(names, state, shapes, device: int) -> list:
    """The pointers of an anomaly stage's input state (None: a fresh
    state, which the kernel starts from zeros: null pointers), each
    tensor checked against its (dtype, shape)."""
    if state is None:
        return [None] * len(names)
    return [_ptr(n, t, dtype, shape, device, align=4)
            for n, t, (dtype, shape) in zip(names, state, shapes)]


def anomaly_likelihood_cuda(state, scores, window: int,
                            short_momentum: float, exclude_recent: int
                            ) -> tuple:
    """CUDA `anomaly_likelihood`: the likelihood over the (T, B) series
    ``scores`` (float32 or float64, any strides) from ``state``, the
    tuple (scores (B, window) float32, pos, count (B,) int32, short_mean
    (B,) float32), or None for a fresh state. Returns the new state's
    four tensors and the (T, B) float32 likelihoods, each a new tensor
    (see `encoders.anomaly_likelihood_steps_ref`)."""
    typ = _series_name(scores)
    path = ANOMALY_LIKELIHOOD.choose(_steps(window), typ)
    T, B = scores.shape
    dev = scores.get_device()
    x_p = _ptr("scores", scores, scores.dtype, None, dev, view=True)
    ring = (torch.float32, (B, window))
    vec_i, vec_f = (torch.int32, (B,)), (torch.float32, (B,))
    in_p = _series_state(("state.scores", "state.pos", "state.count",
                          "state.short_mean"), state,
                         (ring, vec_i, vec_i, vec_f), dev)

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=scores.device)

    out = (new((B, window), torch.float32), new((B,), torch.int32),
           new((B,), torch.int32), new((B,), torch.float32),
           new((T, B), torch.float32))
    if B == 0:
        return out
    ts, bs = scores.stride()
    ANOMALY_LIKELIHOOD.launch(*in_p, x_p, ts, bs, int(path[1] == "f64"),
                              *(t.data_ptr() for t in out), T, B, window,
                              exclude_recent, short_momentum,
                              1.0 - short_momentum, dev, _stream(dev))
    return out


def seasonal_zscore_cuda(state, values, period: int, lag_len: int,
                         window: int, eps: float) -> tuple:
    """CUDA `seasonal_zscore`: the z-scores over the (T, B) series
    ``values`` (float32 or float64, any strides) from ``state``, the tuple
    (lag (B, lag_len), resid (B, window) float32, pos (B,) int32), or None
    for a fresh state; the median runs over lag_len // period lags.
    Returns the new state's three tensors and the (T, B) float32
    z-scores, each a new tensor (see `encoders.seasonal_zscore_steps_ref`)."""
    typ = _series_name(values)
    if not 1 <= period <= lag_len:
        raise ValueError(f"period must be in [1, {lag_len}] (the lag ring's "
                         f"length), got {period}")
    path = SEASONAL_ZSCORE.choose(_steps(window), typ)
    T, B = values.shape
    dev = values.get_device()
    x_p = _ptr("values", values, values.dtype, None, dev, view=True)
    in_p = _series_state(("state.lag", "state.resid", "state.pos"), state,
                         ((torch.float32, (B, lag_len)),
                          (torch.float32, (B, window)),
                          (torch.int32, (B,))), dev)

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=values.device)

    out = (new((B, lag_len), torch.float32),
           new((B, window), torch.float32), new((B,), torch.int32),
           new((T, B), torch.float32))
    if B == 0:
        return out
    ts, bs = values.stride()
    SEASONAL_ZSCORE.launch(*in_p, x_p, ts, bs, int(path[1] == "f64"),
                           *(t.data_ptr() for t in out), T, B, lag_len,
                           window, period, eps, dev, _stream(dev))
    return out
