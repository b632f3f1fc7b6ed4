"""The port's verification and study tools (`bithtm_tpu_torch/scripts`),
each driven through its ``main`` with ``--device cpu`` at a toy size, and
the keys of the report it prints checked; and the package's isolation:
no module of `bithtm_tpu_torch`, the scripts included, imports `jax` or
`bithtm_tpu`.
"""

import ast
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.scripts import (parity_check, profile_step,
                                      soak_16k_autocap, soak_evict_pressure,
                                      soak_fast_stack, wrapper_ab,
                                      grow_variants)
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "bithtm_tpu_torch"


@pytest.fixture(autouse=True)
def one_thread():
    """Each toy run on one intra-op thread: under the test runner's
    workers, more threads than cores slow these small ops tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def printed_report(capsys) -> dict:
    """The JSON object a script prints as its last line."""
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parity_check_tiny_and_sp(capsys):
    out = parity_check.main(["--device", "cpu", "--size", "tiny",
                             "--steps", "4", "--sp"])
    assert printed_report(capsys) == json.loads(json.dumps(out))
    assert set(out) == {"tm", "sp", "device"}
    assert out["tm"]["steps"] == 4 and out["tm"]["size"] == "tiny"
    assert out["tm"]["learning_segments"] > 0
    assert {"port_s", "oracle_s", "pool_occupancy"} <= set(out["tm"])
    assert out["sp"] == {"int16": 30, "float32": 30}
    assert out["device"] == "cpu"


def learned_checkpoint(path, sp_dtype: str, steps: int = 30) -> str:
    """A checkpoint of 3 streams of the tiny size after ``steps``
    learning steps, its SP permanences in ``sp_dtype``."""
    cfg = bt.HTMConfig(sp=bt.SPConfig(input_dim=64, column_dim=32,
                                      active_columns=5,
                                      permanence_dtype=sp_dtype),
                       tm=parity_check.make_cfg("tiny"))
    gen = torch.Generator().manual_seed(3)
    state = bt.htm_init_batch(cfg, 3, gen, "cpu")
    xs = torch.from_numpy(parity_check.bench_inputs(64, 3, steps))
    state, _ = bt.htm_scan(cfg, state, xs, True,
                           draws=bt.TorchDraws(cfg.tm, 3, "cpu", gen))
    checkpoint.save(str(path), state)
    return str(path)


def test_parity_check_from_a_learned_state(tmp_path, capsys):
    """``--from_state``: a checkpoint of a learned state, its first two
    streams judged over learning then inference steps of the whole
    step."""
    out = parity_check.main([
        "--device", "cpu", "--size", "tiny", "--from_state",
        learned_checkpoint(tmp_path / "ckpt", "int16"), "--input_dim",
        "64", "--steps", "4", "--inference_steps", "2"])
    assert printed_report(capsys)["tm"]["from_state"] is True
    tm = out["tm"]
    assert tm["sp_dtype"] == "int16"
    assert (tm["streams"], tm["learning_steps"], tm["inference_steps"]) == (
        2, 4, 2)
    assert tm["learning_segments"] > 0
    assert {"new_segments", "punished_segments", "correct", "port_s",
            "oracle_s"} <= set(tm)


def test_parity_check_from_state_takes_the_states_sp_dtype(tmp_path):
    """The SP's permanence type comes from the checkpoint, not a flag:
    a float32 state is judged as float32."""
    out = parity_check.main([
        "--device", "cpu", "--size", "tiny", "--from_state",
        learned_checkpoint(tmp_path / "ckpt", "float32", steps=8),
        "--input_dim", "64", "--steps", "2", "--inference_steps", "1"])
    assert out["tm"]["sp_dtype"] == "float32"
    assert out["tm"]["learning_steps"] == 2


def test_profile_step_reports_each_call_site(capsys):
    out = profile_step.main(["--device", "cpu", "--batch", "2",
                             "--column_dim", "64", "--cell_dim", "4",
                             "--input_dim", "64", "--trace_steps", "2"])
    assert printed_report(capsys)["sites"] == out["sites"]
    assert out["time"] == "cpu" and out["graph_busy_ms"] is None
    for site in ("sp_step.overlap", "sp_step.select", "sp_step.update",
                 "tm_step.row_counts", "tm_step.column_decide",
                 "tm_step._learn", "tm_step._learn/_grow",
                 "tm_step._learn/learn_rows",
                 "tm_step.table_pass", "tm_step.count_decode",
                 "htm_step.metrics"):
        assert out["sites"][site] > 0, site
    # the learning step's prediction words come from the count decode
    assert "tm_step.prediction_words" not in out["sites"]
    top = sum(ms for name, ms in out["sites"].items() if "/" not in name)
    assert out["ranges_ms"] == pytest.approx(top)


@pytest.mark.parametrize("table", ["packed", "frozen"])
def test_profile_step_serves_from_a_table(table, capsys):
    """``--serve --serve_table``: the packed form's counts and words run
    under the one site `tm_step.serving_counts` (no table pass, no count
    decode, no prediction words); the frozen form's under the table pass
    and the count decode; the mode names the form."""
    out = profile_step.main(["--device", "cpu", "--batch", "2",
                             "--column_dim", "64", "--cell_dim", "4",
                             "--input_dim", "64", "--trace_steps", "2",
                             "--serve", "--serve_table", table])
    assert printed_report(capsys)["sites"] == out["sites"]
    assert out["mode"] == f"serve {table}"
    served = {"tm_step.serving_counts"}
    forward = {"tm_step.table_pass", "tm_step.count_decode"}
    want, absent = (served, forward) if table == "packed" else (forward,
                                                                 served)
    for site in want | {"sp_step.overlap", "sp_step.select",
                        "tm_step.column_decide"}:
        assert out["sites"][site] > 0, site
    assert not (absent | {"tm_step.prediction_words", "tm_step._learn"}
                ) & set(out["sites"])
    with pytest.raises(SystemExit):
        profile_step.main(["--device", "cpu", "--serve_table", table])


def test_lost_launches_counts_kernels_with_no_device_event():
    """`profile_step.lost_launches`: a host `cudaLaunchKernel` whose
    correlation id no device event carries is a kernel the profiler
    dropped (profile_step then profiles the steps again); other runtime
    calls and launches that ran count for nothing."""
    import types

    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA

    def event(name, device, i):
        return types.SimpleNamespace(name=name, device_type=device, id=i)

    ran = [event("cudaLaunchKernel", cpu, 1), event("table_pass", cuda, 1),
           event("cudaMemcpyAsync", cpu, 2), event("Memcpy DtoD", cuda, 2),
           event("cudaStreamIsCapturing", cpu, 3)]
    assert profile_step.lost_launches(ran) == 0
    dropped = ran + [event("cudaLaunchKernel", cpu, 4),
                     event("cudaLaunchKernelExC", cpu, 5)]
    assert profile_step.lost_launches(dropped) == 2


def test_device_events_keep_the_work_the_profile_issued():
    """`utils.profiling.device_events`: device events whose host runtime
    call (launch, copy, graph launch) is in the profile, less the names
    skipped; a device event with no such call (the warm-up phase's work
    that outlasted it, the profiler's step ranges) is left out."""
    import types

    from bithtm_tpu_torch.utils.profiling import device_events

    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA

    def event(name, device, i):
        return types.SimpleNamespace(name=name, device_type=device, id=i)

    events = [
        event("cudaLaunchKernel", cpu, 1), event("table_pass", cuda, 1),
        event("cudaGraphLaunch", cpu, 2), event("sp_select", cuda, 2),
        event("seg_flags", cuda, 2), event("cudaMemcpyAsync", cpu, 3),
        event("Memcpy DtoD", cuda, 3), event("gemm", cuda, 4),
        event("ProfilerStep#1", cpu, 5), event("ProfilerStep#1", cuda, 5),
        event("cudaLaunchKernel", cpu, 6), event("sp_step.select", cuda, 6)]
    prof = types.SimpleNamespace(events=lambda: events)
    names = [e.name for e in device_events(prof, ("sp_step.",))]
    assert names == ["table_pass", "sp_select", "seg_flags", "Memcpy DtoD"]


def test_call_site_ranges_change_no_bit():
    """A step with the ranges on equals the step without them, leaf for
    leaf and metric for metric."""
    from bithtm_tpu_torch.utils.profiling import call_sites

    cfg = bt.make_htm_config(64, 64, 4, active_columns=4,
                             segment_activation_threshold=2,
                             segment_matching_threshold=2,
                             segment_sampling_synapses=8)
    x = torch.from_numpy(np.random.RandomState(0).rand(6, 2, 64) < 0.2)
    runs = []
    for on in (False, True):
        gen = torch.Generator().manual_seed(1)
        state = bt.htm_init_batch(cfg, 2, gen, "cpu")
        draws = bt.TorchDraws(cfg.tm, 2, "cpu", gen)
        with (call_sites() if on else contextlib.nullcontext()):
            state, m = bt.htm_scan(cfg, state, x, True, draws=draws)
        runs.append((bt.htm_state_to_numpy(state), m))
    (s0, m0), (s1, m1) = runs
    for part in ("sp", "tm"):
        for name in s0[part]:
            assert np.array_equal(s0[part][name], s1[part][name]), name
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_soak_fast_stack_reports_each_chunk(capsys):
    out = soak_fast_stack.main(["--device", "cpu", "--batch", "2",
                                "--chunks", "2", "--chunk", "32",
                                "--column_dim", "256"])
    assert printed_report(capsys)["steps"] == out["steps"] == 64
    assert [c["step"] for c in out["chunks"]] == [32, 64]
    for c in out["chunks"]:
        assert {"bursting", "correct", "incorrect", "dropped", "evicted",
                "pool_occupancy_frac", "ms_per_step"} <= set(c)
    assert "tm_dropped_new_segments" in out["drops"]
    assert "record" not in out     # held to the JAX record at 2000 x 256


def test_soak_16k_autocap_escalates_and_banks_no_drop(capsys):
    """At 2048 x 64 (the index-keyed path above 2^16 cells) from caps of
    8: the first chunk escalates and the banked run drops nothing."""
    out = soak_16k_autocap.main(["--device", "cpu", "--batch", "2",
                                 "--steps", "64", "--chunk", "32",
                                 "--column_dim", "2048", "--cell_dim", "64",
                                 "--tuned", "8:8"])
    assert printed_report(capsys)["escalated_at_step"] == 0
    assert out["tuned_drops"] > 0
    assert not any(out["banked_drops"].values())
    assert [c["step"] for c in out["chunks"]] == [0, 32]
    for key in ("end_to_end_ms_per_step", "safe_steady_ms_per_step",
                "tuned_steady_ms_per_step", "bursting_last"):
        assert key in out


def test_soak_evict_pressure_reports_each_window(capsys):
    out = soak_evict_pressure.main(["--device", "cpu", "--steps", "64",
                                    "--batch", "2", "--window", "16"])
    assert printed_report(capsys)["steps"] == 64
    assert [w["step"] for w in out["windows"]] == [16, 32, 48, 64]
    for w in out["windows"]:
        assert {"evicted_per_step", "drops", "syn_drops", "s_pred_mean",
                "s_pred_max", "streams_at_full", "burst_s",
                "ms_per_step"} <= set(w)
        assert w["drops"] == 0
    assert out["windows"][-1]["evicted_per_step"] > 0


@pytest.mark.parametrize("script", [parity_check, profile_step,
                                    soak_fast_stack, soak_16k_autocap,
                                    soak_evict_pressure],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_scripts_need_the_card_unless_told(script, capsys):
    """Without a card and without ``--device cpu`` a script exits with an
    error (a message, so a non-zero status) before it runs anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu") as exit_:
        script.main([])
    assert isinstance(exit_.value.code, str)   # printed, status 1
    assert not capsys.readouterr().out


def test_wrapper_ab_needs_the_card(capsys):
    """`scripts/wrapper_ab.py` times the card only: without one it exits
    with a message before it builds or runs anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device") as exit_:
        wrapper_ab.main(["--part", "pack"])
    assert isinstance(exit_.value.code, str)
    assert not capsys.readouterr().out


def test_grow_variants_needs_the_card(capsys):
    """`scripts/grow_variants.py` times the card only: without one it
    exits with a message before it builds or runs anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device") as exit_:
        grow_variants.main(["--variants", "base"])
    assert isinstance(exit_.value.code, str)
    assert not capsys.readouterr().out


def test_grow_variants_patch_the_current_source():
    """Every variant of the current `grow_select` (the `new_` ones) finds
    the text it patches in `csrc/grow_pass.cu`, so none of them silently
    turns into the unpatched kernel; the variants of the earlier kernel
    (successive warp minima) do not apply to it."""
    src = (kernels.CSRC / "grow_pass.cu").read_text()
    for name, patches in grow_variants.VARIANTS.items():
        found = all(old in src for old, _ in patches)
        assert found == (name == "base" or name.startswith("new_")), name


@pytest.mark.parametrize("kernel", ["learn_rows", "seg_flags",
                                    "column_decide", "sp_select",
                                    "serving_counts", "sp_rows"])
def test_variants_patch_the_studied_source(kernel):
    """Every variant of the `learn_rows`, flags-form, `column_decide`,
    `sp_select`, `serving_counts` and `sp_rows` studies finds the text it
    patches in its source, so none silently times the unpatched kernel."""
    source, variants, _ = grow_variants.STUDIES[kernel]
    src = (kernels.CSRC / source).read_text()
    for name, patches in variants.items():
        assert all(old in src for old, _ in patches), name
        assert all(src.count(old) == 1 for old, _ in patches), name


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    """Every module of the package, the scripts included, names neither
    `jax` nor `bithtm_tpu` in an import, and each imports in a process
    where both are blocked."""
    modules = sorted(PKG.rglob("*.py"))
    assert (PKG / "scripts" / "parity_check.py") in modules
    for path in modules + [REPO / "chip_smoke.py"]:
        bad = _imported_roots(path) & {"jax", "jaxlib", "bithtm_tpu"}
        assert not bad, (path, bad)
    names = [".".join(p.relative_to(REPO).with_suffix("").parts)
             .removesuffix(".__init__") for p in modules]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['bithtm_tpu'] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and\n"
            "       m.split('.')[0] in ('jax', 'jaxlib', 'bithtm_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
