"""The port's measuring tools (``cap2det_tpu_torch/tools/bench_*.py``,
``profile_step.py``, ``benchlib.py``) on the CPU at tiny sizes, held to
the JAX tools' names (read from the root ``tools/`` files).

* ``bench_components``, ``bench_backbone_parts`` and ``bench_eval`` run
  with ``--device cpu`` and print the JAX tools' names, ``pallas`` read
  as ``kernel`` and ``xla`` as ``plain``; without a card and without
  ``--device cpu`` they raise.
* ``bench_opt_ab`` with the root tool's flags, variants, shape, step
  count variable and JSON keys, its arms in alternating turns, at a tiny
  size on the CPU.
* ``profile_step.aggregate`` on a chrome trace built here (kernels, a
  copy, nested host operations with known times) gives the stated
  per-kernel totals, busy share, gaps and the host operation open across
  each gap; on a CPU trace it fails for want of device events.
* The helpers moved out of ``chip_smoke.py`` into ``benchlib`` (the
  card's name and limit, the busy share, the host CPU), ``time_rounds``
  on the CPU, and ``bench --e2e`` at a tiny size.
* The import guard (``tests/test_torch_no_jax_imports.py``) covers the
  new files as it stands.
"""

import ast
import importlib.util
import io
import json
import os
import re
import subprocess
import types
from contextlib import redirect_stdout

import pytest
import torch

from cap2det_tpu_torch import bench
from cap2det_tpu_torch.tools import (bench_backbone_parts, bench_components,
                                     bench_eval, bench_opt_ab, benchlib,
                                     profile_step)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_FILES = ["cap2det_tpu_torch/bench.py",
             "cap2det_tpu_torch/tools/benchlib.py",
             "cap2det_tpu_torch/tools/bench_components.py",
             "cap2det_tpu_torch/tools/bench_backbone_parts.py",
             "cap2det_tpu_torch/tools/bench_eval.py",
             "cap2det_tpu_torch/tools/profile_step.py",
             "cap2det_tpu_torch/tools/bench_opt_ab.py"]


def _jax_source(name):
    with open(os.path.join(ROOT, "tools", name)) as f:
        return f.read()


def _lines(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_bench_components_prints_the_jax_names(monkeypatch):
    monkeypatch.setattr(bench_components, "CANVAS_HW", (64, 96))
    monkeypatch.setattr(bench_components, "ROUNDS", 1)
    lines = _lines(bench_components.main, [
        "--device", "cpu", "--steps", "1", "--proposals", "16",
        "--classes", "3"])
    jax_names = set(re.findall(r'record\(\s*"(\w+)"',
                               _jax_source("bench_components.py")))
    want = {n.replace("pallas", "kernel").replace("xla", "plain")
            for n in jax_names}
    got = [line["component"] for line in lines if "component" in line]
    # The kernels run on the card only, as the JAX tool's Pallas ones run
    # on the TPU only.
    assert set(got) == want - {"roi_kernel_fwd", "roi_kernel_fwdbwd"}
    assert len(got) == len(set(got)) == 14
    (summary,) = [line["summary"] for line in lines if "summary" in line]
    assert list(summary) == got and all(ms > 0 for ms in summary.values())
    assert all(line["device"].startswith("cpu") for line in lines)


def test_bench_components_runs_the_folds_card_path(monkeypatch):
    """The components that differentiate a stage fold it as the card
    does (``bn_fold``'s launches walked on the CPU): only what the step
    trains requires a gradient, never a moving statistic."""
    from tests.test_torch_bn_fold import walk_the_kernels

    walk_the_kernels(monkeypatch)
    monkeypatch.setattr(bench_components, "CANVAS_HW", (64, 96))
    monkeypatch.setattr(bench_components, "ROUNDS", 1)
    lines = _lines(bench_components.main, [
        "--device", "cpu", "--steps", "1", "--proposals", "16",
        "--classes", "3", "--components",
        "first_stage_fwdbwd_4e,second_stage"])
    got = [line["component"] for line in lines if "component" in line]
    assert got == ["first_stage_fwdbwd_4e", "second_stage_fwd",
                   "second_stage_fwdbwd"]


def test_bench_backbone_parts_prints_the_jax_names(monkeypatch):
    jax_source = _jax_source("bench_backbone_parts.py")
    jax_convs = [tuple(int(v) for v in m) for m in re.findall(
        r"\((\d+), (\d+), (\d+), (\d+), (\d+)\),", jax_source)]
    assert bench_backbone_parts.RAW_CONVS == jax_convs
    assert (bench_backbone_parts.BATCH, bench_backbone_parts.H,
            bench_backbone_parts.W) == (2, 1024, 1536)

    monkeypatch.setattr(bench_backbone_parts, "H", 64)
    monkeypatch.setattr(bench_backbone_parts, "W", 96)
    monkeypatch.setattr(bench_backbone_parts, "ROUNDS", 1)
    monkeypatch.setattr(bench_backbone_parts, "RAW_CONVS",
                        [(8, 12, 16, 8, 3), (4, 6, 16, 16, 1)])
    lines = _lines(bench_backbone_parts.main,
                   ["--device", "cpu", "--steps", "1"])
    got = [line["part"] for line in lines]
    want = (["conv3x3_8x12_16_8", "conv1x1_4x6_16_16"]
            + re.findall(r'record\("(\w+)"', jax_source)
            + re.findall(r'"(Mixed_\w+)": \(', jax_source))
    assert sorted(got) == sorted(want) and len(got) == 2 + 4 + 7 + 3
    assert all(line["ms"] > 0 for line in lines)
    assert all("tflops_per_s" in line for line in lines[:2])


def test_bench_eval_prints_the_jax_metrics():
    lines = _lines(bench_eval.main, [
        "--device", "cpu", "--examples", "2", "--proposals", "16",
        "--min_dims", "64,48"])
    jax_metrics = re.findall(r'"metric": "(\w+)"', _jax_source(
        "bench_eval.py"))
    assert [line["metric"] for line in lines] == jax_metrics
    first = lines[0]
    assert first["examples_measured"] == 1 and first["value"] > 0
    assert 0.0 < first["nms_share"] < 1.0
    assert lines[1]["value"] == pytest.approx(
        first["value"] * bench_eval.VOC07_TEST_IMAGES)
    assert lines[2]["largest_canvas"] == [64, 96]


def test_bench_opt_ab_keeps_the_jax_tools_flags_and_keys(monkeypatch):
    jax_source = _jax_source("bench_opt_ab.py")
    for name in ("BATCH", "CANVAS_HW", "NUM_PROPOSALS", "NUM_CLASSES"):
        (value,) = re.findall(r"^%s = (.+)$" % name, jax_source, re.M)
        assert getattr(bench_opt_ab, name) == eval(value), name
    assert re.findall(r'add_argument\("(--\w+)"', jax_source) == [
        "--variant"]
    (choices,) = re.findall(r'choices=\[(.*?)\]', jax_source)
    variants = re.findall(r'"(\w+)"', choices)
    assert variants == ["fused", "unfused", "both"]
    assert 'os.environ.get("AB_STEPS", "8")' in jax_source
    jax_keys = {prefix + name for prefix in re.findall(
        r'results\["(\w+_)" \+ name\]', jax_source)
        for name in variants[:2]}
    assert jax_keys == {"opt_fused", "opt_unfused", "step_fused",
                        "step_unfused"}

    monkeypatch.setattr(bench_opt_ab, "CANVAS_HW", (64, 96))
    monkeypatch.setattr(bench_opt_ab, "NUM_PROPOSALS", 16)
    monkeypatch.setattr(bench_opt_ab, "NUM_CLASSES", 3)
    monkeypatch.setenv("AB_STEPS", "1")
    lines = _lines(bench_opt_ab.main, ["--device", "cpu", "--turns", "2"])
    turns, (last,) = lines[:-1], lines[-1:]
    assert [(t["turn"], t["variant"]) for t in turns] == [
        (0, "fused"), (0, "unfused"), (1, "unfused"), (1, "fused")]
    assert jax_keys <= set(last) and all(last[k] > 0 for k in jax_keys)
    assert last["steps"] == 1 and last["turns"] == 2
    assert all(line["device"].startswith("cpu") and "power_limit" in line
               for line in lines)

    # One arm: its keys only.
    monkeypatch.setattr(bench_opt_ab, "_Arm", lambda device, fused: (
        types.SimpleNamespace(update=lambda: None, step=types.SimpleNamespace(
            run=lambda: None))))
    (_, last) = _lines(bench_opt_ab.main, ["--device", "cpu", "--turns", "1",
                                          "--variant", "unfused"])
    assert {k for k in last if k.startswith(("opt_", "step_"))
            and not k.endswith(("_min", "_max"))} == {"opt_unfused",
                                                      "step_unfused"}


@pytest.mark.parametrize("main", [
    bench_components.main, bench_backbone_parts.main, bench_eval.main,
    profile_step.main, bench_opt_ab.main],
    ids=["components", "backbone_parts", "eval", "profile_step",
         "opt_ab"])
def test_tools_raise_without_a_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


# -- profile_step's aggregation -----------------------------------------------


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0, "args": args}


def _trace():
    """Two steps. Host: a step span 0-100 and 100-190, inside each a
    loss span and ops; device: kernels and a copy with known gaps."""
    return {"traceEvents": [
        _x("cap2det/step", "user_annotation", 0, 100),
        _x("cap2det/step/forward", "user_annotation", 5, 50),
        _x("aten::conv2d", "cpu_op", 10, 20),
        _x("aten::item", "cpu_op", 60, 30),
        _x("cap2det/step", "user_annotation", 100, 90),
        _x("cap2det/step/update", "user_annotation", 110, 70),
        _x("cudaLaunchKernel", "cuda_runtime", 120, 2),
        # device: conv 12-30, copy 28-40 (overlaps), conv 70-80,
        # gemm 112-118, conv 150-160, and a flow event that is no span.
        _x("conv_kernel", "kernel", 12, 18),
        _x("Memcpy HtoD", "gpu_memcpy", 28, 12),
        _x("conv_kernel", "kernel", 70, 10),
        _x("gemm", "kernel", 112, 6),
        _x("conv_kernel", "kernel", 150, 10),
        {"ph": "s", "name": "flow", "cat": "ac2g", "ts": 1, "id": 1},
        _x("cap2det/step", "gpu_user_annotation", 12, 150),
    ]}


def test_aggregate_gives_the_stated_totals():
    agg = profile_step.aggregate(_trace(), steps=2, top=2, gaps=3)
    # kernels: conv 38 us, copy 12, gemm 6 -> per step /2, in ms.
    assert agg["total_device_ms_per_step"] == pytest.approx(0.056 / 2)
    assert agg["kernels"] == [
        {"ms_per_step": pytest.approx(0.019), "count": 3,
         "name": "conv_kernel"},
        {"ms_per_step": pytest.approx(0.006), "count": 1,
         "name": "Memcpy HtoD"}]
    # union 12-40, 70-80, 112-118, 150-160: 28 + 10 + 6 + 10 = 54 us of
    # a 0-190 window.
    assert agg["busy_ms"] == pytest.approx(0.054)
    assert agg["window_ms"] == pytest.approx(0.190)
    assert agg["busy_share"] == pytest.approx(54 / 190)
    assert agg["idle_gaps"] == 3 and agg["idle_ms"] == pytest.approx(0.094)
    # gaps 40-70 (30), 80-112 (32), 118-150 (32): the innermost host
    # event open across each, and the one open where it ended.
    assert agg["gaps"] == [
        {"gap_ms": pytest.approx(0.032), "start_ms": pytest.approx(0.118),
         "host_op": "cap2det/step/update", "host_category": "user_annotation",
         "host_op_at_end": "cap2det/step/update"},
        {"gap_ms": pytest.approx(0.032), "start_ms": pytest.approx(0.080),
         "host_op": None, "host_category": None,
         "host_op_at_end": "cap2det/step/update"},
        {"gap_ms": pytest.approx(0.030), "start_ms": pytest.approx(0.040),
         "host_op": "cap2det/step", "host_category": "user_annotation",
         "host_op_at_end": "aten::item"}]


def test_aggregate_fails_on_a_cpu_trace(tmp_path):
    x = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function("cap2det/step"):
                x = torch.relu(x @ x)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert benchlib.load_trace(path)  # host events are there
    with pytest.raises(RuntimeError, match="no device events"):
        profile_step.aggregate(path, steps=2)


def test_profile_step_on_the_cpu_fails_for_want_of_device_events(
        monkeypatch, tmp_path):
    monkeypatch.setitem(bench.SHAPES, "tiny", dict(
        batch=1, canvas_hw=(64, 96), num_proposals=8, num_classes=3,
        full_freeze=True))
    monkeypatch.setattr(profile_step, "WARMUP_STEPS", 1)
    with pytest.raises(RuntimeError, match="no device events"):
        profile_step.main(["--device", "cpu", "--shape", "tiny",
                           "--steps", "2", "--trace_dir", str(tmp_path)])
    # The kept trace holds the program's own spans, one set a step.
    names = [e["name"] for e in benchlib.load_trace(
        str(tmp_path / "trace.json")) if e.get("cat") == "user_annotation"]
    for name in ("cap2det/step", "cap2det/step/forward",
                 "cap2det/step/backward", "cap2det/step/update",
                 "cap2det/model/bn_fold"):
        assert names.count(name) == 2, name


# -- benchlib, and the helpers moved out of chip_smoke.py ---------------------


def test_chip_smoke_uses_the_moved_helpers():
    source = open(os.path.join(ROOT, "chip_smoke.py")).read()
    tree = ast.parse(source)
    defined = {node.name for node in tree.body
               if isinstance(node, ast.FunctionDef)}
    moved = {"card_name_and_limit", "cuda_ms", "device_ms", "busy_share",
             "host_cpu"}
    assert not moved & defined
    (imported,) = [node for node in tree.body
                   if isinstance(node, ast.ImportFrom)
                   and node.module == "cap2det_tpu_torch.tools.benchlib"]
    assert {alias.name for alias in imported.names} == moved


def test_busy_share_of_a_trace_file_and_dict(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace()))
    assert benchlib.busy_share(str(path)) == benchlib.busy_share(_trace())
    assert benchlib.busy_share(_trace()) == (pytest.approx(0.054),
                                             pytest.approx(0.190))


def test_card_name_and_limit_reads_nvidia_smi(monkeypatch):
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")

    monkeypatch.setattr(subprocess, "run", run)
    assert benchlib.card_name_and_limit() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None:
                        "NVIDIA H100 80GB HBM3")
    assert benchlib.device_fields("cuda") == {
        "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    assert benchlib.bf16_peak_flops("cuda") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None:
                        "Some Other Card")
    with pytest.raises(KeyError, match="no bfloat16 peak"):
        benchlib.bf16_peak_flops("cuda")


def test_host_cpu_and_device_fields_on_the_cpu():
    name, cores = benchlib.host_cpu()
    assert name and cores == os.cpu_count()
    fields = benchlib.device_fields("cpu")
    assert fields["device"].startswith("cpu: ") and fields[
        "power_limit"] is None


def test_time_rounds_on_the_cpu_reads_the_host_clock():
    calls = []
    timing = benchlib.time_rounds(lambda: calls.append(1), "cpu", iters=3,
                                  rounds=4, warmup=2)
    assert len(calls) == 2 + 3 * 4
    assert timing["clock"] == "host" and timing["rounds"] == 4
    assert timing["ms"] == timing["host_ms"]
    assert timing["ms_min"] <= timing["ms"] <= timing["ms_max"]


def test_e2e_on_the_cpu(monkeypatch):
    """``train()`` over synthetic records at a tiny size: one line with
    the JAX bench's e2e keys."""
    monkeypatch.setattr(bench, "NUM_PROPOSALS", 8)
    monkeypatch.setattr(bench, "NUM_CLASSES", 3)
    monkeypatch.setattr(bench, "E2E_RECORDS", 6)
    monkeypatch.setattr(bench, "E2E_IMAGE_HW", (48, 64))
    monkeypatch.setattr(bench, "E2E_WARM", 1)
    monkeypatch.setattr(bench, "E2E_HOST_BATCHES", 2)
    (line,) = _lines(bench.main, ["--e2e", "--device", "cpu",
                                  "--e2e_min_dim", "64",
                                  "--measure_steps", "2"])
    assert line["metric"] == "cap2det_e2e_train_images_per_sec"
    assert line["value"] > 0 and line["host_pipeline_images_per_sec"] > 0
    assert line["host_workers"] >= 1 and line["min_dimension"] == 64
    # The feed reads through the host library; the Python reader's rate
    # is measured beside it, in turns.
    assert line["record_reader"] == "native.read_records_native"
    assert line["host_pipeline_python_reader_images_per_sec"] > 0
    assert [len(v) for v in line["host_pipeline_turns"].values()] == [2, 2]
    assert line["first_step_wait_s"] >= 0 and line["host_library_s"] >= 0


# -- the import guard ----------------------------------------------------------


def test_the_import_guard_covers_the_new_files():
    spec = importlib.util.spec_from_file_location(
        "import_guard", os.path.join(ROOT, "tests",
                                     "test_torch_no_jax_imports.py"))
    guard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guard)
    covered = {str(p.relative_to(guard.ROOT)) for p in guard.SOURCES}
    assert set(NEW_FILES) <= covered
    for path in NEW_FILES:
        source = open(os.path.join(ROOT, path)).read()
        assert guard.forbidden_imports(source) == []
        # Nor the JAX package's root modules.
        for node in ast.walk(ast.parse(source)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not {n.split(".")[0] for n in names} & {
                "bench", "__graft_entry__", "benchlib"}, (path, names)
