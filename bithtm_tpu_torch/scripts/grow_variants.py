"""What holds `grow_select` back: variants of its source timed in turns.

`ncu` and `nsys` do not run where the card is, so a kernel's time is
taken apart by timing variants of it: copies of `csrc/grow_pass.cu`, each
with one part cut out or changed by a text patch (`VARIANTS`), built
with nvcc into libraries of their own and called through the tree's own
wrapper (`ops.kernels.grow_select_cuda`, on `testing.grow_inputs` at the
main paths' geometries). A variant whose patch does not match the
source is reported as not applicable. Variants that cut a part out give
wrong results; they are timed, never checked. Each variant's ms a call
is the median of ``--rounds`` rounds, the variants in turns within a
round, each a CUDA graph of 20 calls replayed 10 times (CUDA events).
``--ptxas`` prints each build's registers, shared memory and spills
(`nvcc -Xptxas -v`).

Run on the card from the root of the tree to study (whose package is
the one imported):

  python -m bithtm_tpu_torch.scripts.grow_variants [--ptxas]
      [--shapes bench,16k_tuned] [--rounds 5] [--variants a,b]

Prints one JSON line: {shape: {variant: ms}}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess

import torch

from .. import testing
from ..ops import kernels

# B, C, D, A, G, K, Wc, L, samp (chip_smoke.py GROW_MAIN)
SHAPES = {
    "bench": (256, 2048, 32, 41, 4, 64, 128, 88, 32),
    "16k_tuned": (64, 16384, 64, 328, 4, 64, 384, 336, 32),
    "16k_auto": (64, 16384, 64, 328, 4, 64, 768, 824, 32),
}

# name: [(text in the source, its replacement)]. The first six are the
# suspects of the earlier kernel, which selected by successive warp
# minima (one warp a row, rows of a block behind one staging of the
# list); the rest cut the stages of the kernel that replaced it.
_MINIMA = ("  uint32_t last = 0;\n  for (int j = 0; j < m; ++j) {",
           "  uint32_t last = 0;\n"
           "  for (int i = lane; i < m; i += 32) out[i] = (int)keys[i];\n"
           "  for (int j = 0; j < 0; ++j) {")
_RND = ("bits_r = static_cast<uint32_t>(__ldg(rnd_r + i))",
        "bits_r = static_cast<uint32_t>(i * 2654435761u)")
_SEARCH = ("for (int i = lower_bound(list, n_cand, s);",
           "for (int i = n_cand;")
VARIANTS = {
    "base": [],
    # (a) the serial rounds of successive minima: the m smallest keys
    # written unsorted, with no round
    "no_minima": [_MINIMA],
    # (b) the row's dependent loads: no random words read
    "no_rnd_loads": [_RND],
    # (c) the staging: 16 rows a block behind one staging, not 4
    "rows16": [("constexpr int kWarps = 4;", "constexpr int kWarps = 16;")],
    # (d) the per-target binary searches: none
    "no_search": [_SEARCH],
    # what is left with (a), (b) and (d) cut
    "no_minima_rnd_search": [_MINIMA, _RND, _SEARCH],
    # the kernel that replaced it: the prologue alone (no row work); the
    # prologue and the rows' loads (no keys, targets or selection); no
    # selection; no target lookups; binary searches for the targets (no
    # hash table); no first bound from the guess
    "new_prologue_only": [("      if (r < R && cap_grow > 0) {",
                           "      if (false) {")],
    "new_loads_only": [("  if (n_grow == 0 || n_cand == 0) {",
                        "  if (true) {")],
    "new_no_select": [(
        "  return select_row<kCell>(keys, n_cand, n_grow, c_valid, guess, "
        "c_guess,\n                           cap, out, (1u << bits) - 1u, "
        "lane);", "  return 0;")],
    "new_no_search": [(
        "      pos[u] = target[u] ? find_cell(list, table, hash_bits, n_cand, "
        "s[u])\n                         : -1;", "      pos[u] = -1;")],
    "new_bsearch": [("      hash_bits = hb;", "      hash_bits = 0;")],
    "new_no_guess": [("  if (c_hi > cap) {\n    if (c_guess >= m) {",
                      "  if (false) {\n    if (c_guess >= m) {")],
}


def build(name: str, patches, flags, ptxas: bool) -> tuple[str, object]:
    """The variant's library path and its nvcc process (None where a
    patch does not match)."""
    src = (kernels.CSRC / "grow_pass.cu").read_text()
    for old, new in patches:
        if old not in src:
            return "", None
        src = src.replace(old, new)
    out = kernels.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in kernels.HEADERS:
        shutil.copy(kernels.CSRC / header, out / header)
    (out / "grow_pass.cu").write_text(src)
    lib = out / "libgrow.so"
    cmd = [kernels._nvcc(), *flags, *(["-Xptxas", "-v"] if ptxas else []),
           "-shared", "-o", str(lib), str(out / "grow_pass.cu")]
    return str(lib), subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """ms a call of ``fn`` in a CUDA graph of n calls (CUDA events over
    ``reps`` replays after one)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.grow_variants",
        description=__doc__.split("\n")[0])
    p.add_argument("--shapes", default="bench,16k_tuned")
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--ptxas", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grow_variants times the card only: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    names = args.variants.split(",")
    procs = {n: build(n, VARIANTS[n], kernels.NVCC_FLAGS, args.ptxas)
             for n in names}
    libs = {}
    for n, (lib, proc) in procs.items():
        if proc is None:
            print(f"variant {n}: not applicable to this source")
            continue
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log}")
        if args.ptxas:
            print(f"variant {n} (ptxas):\n" + "\n".join(
                line for line in log.splitlines()
                if "registers" in line or "spill" in line
                or "Compiling entry" in line))
        libs[n] = ctypes.CDLL(lib)
    out = {}
    library = kernels._library
    try:
        for shape in args.shapes.split(","):
            geo = SHAPES[shape]
            x = testing.grow_inputs(sum(geo), *geo, device=dev)
            times = {n: [] for n in libs}
            for r in range(args.rounds):
                order = list(libs)[r % len(libs):] + list(libs)[
                    :r % len(libs)]
                for n in order:
                    kernels._library = lambda lib=libs[n]: lib
                    kernels.GROW_SELECT._fn = None
                    times[n].append(graph_ms(
                        lambda: kernels.grow_select_cuda(**x)))
            out[shape] = {n: statistics.median(t) for n, t in times.items()}
            print(f"{shape} {geo}: " + ", ".join(
                f"{n} {ms:.4f}" for n, ms in out[shape].items())
                  + " ms a call in a graph of 20")
            del x
            torch.cuda.empty_cache()
    finally:
        kernels._library = library
        kernels.GROW_SELECT._fn = None
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
