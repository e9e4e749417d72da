"""The port's run scripts (``cap2det_tpu_torch/scripts/``).

The orchestration test is the counterpart of
``tests/test_orchestration.py``: on its tiny pipeline, with ``--device
cpu``, ``scripts.train`` runs the trainer beside the eval daemon, then
``scripts.eval_once`` and ``cli.export_main`` run, and the artifacts a
user relies on are there. Two more cases show that ``scripts.train``
leaves no process behind when the trainer fails or when it is sent
SIGTERM.

The pipeline tests hold every pipeline the scripts write to the shell
scripts' own: the test reads ``scripts/*.sh`` as text, lets bash run
their variable set-up and expand their heredocs, and compares character
for character; each text must also parse with the port's schema.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.scripts import (flickr_run, quality_run, steps,
                                       text_run, train)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEPARATOR = "----- next pipeline -----"
WORK = "/data/work dir/q"  # a space, as a user's path may hold
GONE_SECS = 30.0
STARTED_SECS = 5.0

PIPELINE = """
train_reader {
  cap2det_reader {
    input_pattern: "%(rec)s"
    is_training: true
    shuffle_buffer_size: 8
    batch_size: 4
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    max_num_proposals: 8
    batch_resize_scale_value: 1.0
  }
}
eval_reader {
  cap2det_reader {
    input_pattern: "%(rec)s"
    is_training: false
    batch_size: 1
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    max_num_proposals: 8
  }
}
model {
  [Cap2DetModel.ext] {
    midn_loss_weight: 1.0
    oicr_loss_weight: 0.5
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: 1.0
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 1
    oicr_iou_threshold: 0.6
    midn_post_processor { max_size_per_class: 5 max_total_size: 10 }
    oicr_post_processor { max_size_per_class: 5 max_total_size: 10 }
    eval_min_dimension: 64
    label_extractor { groundtruth_extractor { label_file: '%(lab)s' } }
  }
}
train_config {
  max_steps: 6
  learning_rate: 0.01
  optimizer { adagrad {} }
  save_checkpoints_steps: 3
  log_step_count_steps: 3
}
eval_config { steps: 8 }
"""


# -- the orchestration -------------------------------------------------------


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A working directory holding configs/smoke.pbtxt over 8 seeded
    localizable records, and the environment the scripts run in."""
    root = tmp_path_factory.mktemp("scripts")
    classes = ["redthing", "greenthing"]
    record = str(root / "train.record")
    synthetic.write_localizable_dataset(
        record, num_examples=8, seed=4, classes=classes, image_hw=(96, 128),
        num_distractors=7)
    label_file = synthetic.write_label_file(str(root / "labels.txt"),
                                            classes)
    (root / "configs").mkdir()
    (root / "configs" / "smoke.pbtxt").write_text(
        PIPELINE % {"rec": record, "lab": label_file})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return root, env


def _script(staged, name, *args, timeout=480):
    root, env = staged
    return subprocess.run(
        [sys.executable, "-m", "cap2det_tpu_torch.scripts." + name, *args],
        cwd=str(root), env=env, capture_output=True, text=True,
        timeout=timeout)


def _pids(stderr):
    """{'eval daemon': pid, 'trainer': pid} from scripts.train's stderr."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(eval daemon|trainer): pid (\d+)", stderr, re.MULTILINE)}


def _group_gone(pgid, within=GONE_SECS):
    """True once no process is left in process group `pgid`."""
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.2)
    return False


def test_a_failed_step_ends_the_run_with_its_code(tmp_path, capsys):
    log = str(tmp_path / "step.log")
    ran = []

    def run(argv):
        steps.run("cap2det_tpu_torch.scripts.no_such_step", log=log)
        ran.append("the next step")

    assert steps.main(run) == 1 and ran == []
    assert "No module named cap2det_tpu_torch.scripts.no_such_step" in (
        capsys.readouterr().err)


def test_train_and_eval_once_default_to_the_card():
    for prog in ("train", "eval_once", "train_text"):
        args, extra = train.parse(["coco17_text"], prog)
        assert (args.device, args.model_dir, extra) == (
            "cuda", os.path.join("logs", "coco17_text"), [])
    args, extra = train.parse(["smoke", "m", "--max_steps", "3", "--device",
                               "cpu"], "train")
    assert (args.device, args.model_dir, extra) == (
        "cpu", "m", ["--max_steps", "3"])


def test_train_then_eval_once_then_export(staged):
    root, env = staged
    model_dir = str(root / "model")
    out = _script(staged, "train", "smoke", model_dir, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.isdir(os.path.join(model_dir, "ckpt", "6")), os.listdir(
        os.path.join(model_dir, "ckpt"))
    assert os.path.exists(os.path.join(model_dir, "metrics.jsonl"))
    assert os.path.getsize(os.path.join(model_dir, "eval.log")) > 0
    pids = _pids(out.stderr)
    assert set(pids) == {"eval daemon", "trainer"}, out.stderr[-3000:]
    assert all(_group_gone(pid) for pid in pids.values())
    # The trainer's own count of kernel launches: none on the CPU, where
    # the wrappers run their plain versions.
    assert re.search(r"kernel launches: \{\"roi_crop_maxpool\": 0,",
                     out.stderr), out.stderr[-3000:]

    out = _script(staged, "eval_once", "smoke", model_dir, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    with open(os.path.join(model_dir, "eval_metrics.jsonl")) as fid:
        rows = [json.loads(line) for line in fid]
    assert rows and rows[-1]["step"] == 6
    assert any(f.startswith("eval_report_") and f.endswith(".csv")
               for f in os.listdir(model_dir)), os.listdir(model_dir)
    assert os.path.exists(os.path.join(model_dir, "saved_ckpts",
                                       "saved_info.txt"))

    out_json = str(root / "detections.json")
    out = subprocess.run(
        [sys.executable, "-m", "cap2det_tpu_torch.cli.export_main",
         "--pipeline_proto", str(root / "configs" / "smoke.pbtxt"),
         "--model_dir", model_dir, "--output_json", out_json,
         "--max_examples", "3", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=480)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(out_json) as fid:
        detections = json.load(fid)
    entries = list(detections.values())
    assert len(entries) == 3
    first = entries[0]
    assert {"detection_boxes", "detection_scores",
            "detection_classes"} <= set(first)
    boxes = np.asarray(first["detection_boxes"], np.float32)
    assert boxes.ndim == 2 and boxes.shape[1] == 4


def test_a_failed_trainer_leaves_no_daemon(staged):
    root, _ = staged
    model_dir = str(root / "failed")
    out = _script(staged, "train", "smoke", model_dir, "--device", "cpu",
                  "--pretrained_checkpoint", str(root / "no_such_backbone"))
    assert out.returncode == 1, out.stderr[-3000:]
    assert "no_such_backbone" in out.stderr
    pids = _pids(out.stderr)
    assert set(pids) == {"eval daemon", "trainer"}, out.stderr[-3000:]
    assert all(_group_gone(pid) for pid in pids.values())
    assert os.path.getsize(os.path.join(model_dir, "eval.log")) > 0


def test_sigterm_stops_the_trainer_and_the_daemon(staged):
    root, env = staged
    proc = subprocess.Popen(
        [sys.executable, "-m", "cap2det_tpu_torch.scripts.train", "smoke",
         str(root / "stopped"), "--device", "cpu", "--max_steps", "100000"],
        cwd=str(root), env=env, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        while len(_pids("".join(lines))) < 2:
            line = proc.stderr.readline()
            assert line, "".join(lines)[-3000:]
            lines.append(line)
        time.sleep(STARTED_SECS)  # both children are past their imports
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 128 + signal.SIGTERM
    finally:
        proc.kill()
        proc.communicate()
    pids = _pids("".join(lines))
    assert all(_group_gone(pid) for pid in pids.values())


# -- the pipelines against the shell scripts' heredocs ----------------------


def shell_pipelines(script, *args):
    """The pipelines `scripts/<script>` writes when run with `args`: its
    variable set-up (from ``set -euo pipefail`` to ``REPO=``, and its
    ``EVAL_N=`` line) and each ``cat > ...pbtxt <<EOF`` heredoc, expanded
    by bash."""
    with open(os.path.join(REPO, "scripts", script)) as fid:
        lines = fid.read().splitlines()
    start = lines.index("set -euo pipefail")
    end = next(i for i, l in enumerate(lines) if l.startswith("REPO="))
    body = lines[start:end] + [l for l in lines[end:]
                               if l.startswith("EVAL_N=")]
    for i, line in enumerate(lines):
        if line.startswith("cat > ") and line.endswith(".pbtxt\" <<EOF"):
            body += ["echo '%s'" % SEPARATOR, "cat <<EOF"]
            body += lines[i + 1:lines.index("EOF", i) + 1]
    out = subprocess.run(["bash", "-c", "\n".join(body), script,
                          *[str(a) for a in args]],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return out.split(SEPARATOR + "\n")[1:]


@pytest.mark.parametrize("class_set", [9, 80])
@pytest.mark.parametrize("caption_style", ["exact", "synonyms"])
@pytest.mark.parametrize("extractor", sorted(quality_run.EXTRACTOR_LINES))
def test_quality_run_pipeline_equals_the_shell(extractor, caption_style,
                                               class_set):
    num_images, max_steps = 240, 4250
    (want,) = shell_pipelines("quality_run.sh", WORK, num_images, max_steps,
                              8, extractor, caption_style, class_set)
    args = quality_run.parse([WORK, str(num_images), str(max_steps), "8",
                              extractor, caption_style, str(class_set)])
    got = quality_run.pipeline_text(
        WORK, args.extractor, args.max_steps,
        quality_run.eval_examples(args.num_images))
    assert got == want
    cfg = schema.loads_pipeline(got)
    ext = cfg.model.cap2det_model.label_extractor
    assert ext.which_oneof().startswith(extractor)
    assert cfg.eval_config.steps == 36
    assert cfg.train_config.max_steps == max_steps


def test_quality_run_defaults_are_the_shell_defaults():
    args = quality_run.parse([WORK])
    assert (args.num_images, args.max_steps, args.nproc, args.extractor,
            args.caption_style, args.class_set, args.device) == (
                240, 1500, 1, "groundtruth", "exact", 9, "cuda")
    (want,) = shell_pipelines("quality_run.sh", WORK)
    assert quality_run.pipeline_text(WORK, "groundtruth", 1500, 36) == want


@pytest.mark.parametrize("max_steps", [None, 2000])
def test_text_run_pipeline_equals_the_shell(max_steps):
    argv = [WORK] + ([str(max_steps)] if max_steps else [])
    (want,) = shell_pipelines("text_run_tpu.sh", *argv)
    args = text_run.parse(argv)
    assert args.device == "cuda"
    got = text_run.pipeline_text(WORK, args.max_steps)
    assert got == want
    cfg = schema.loads_pipeline(got)
    assert cfg.model.text_model.text_classifier.hidden_units == 400
    assert cfg.train_config.max_steps == (max_steps or 100000)


@pytest.mark.parametrize("sizes", [(), (120, 500, 600), (40, 30, 20)])
def test_flickr_run_pipelines_equal_the_shell(sizes):
    argv = [WORK] + [str(s) for s in sizes]
    want_text, want_flickr = shell_pipelines("flickr_run_tpu.sh", *argv)
    args = flickr_run.parse(argv)
    assert args.device == "cuda"
    eval_n = quality_run.eval_examples(args.num_images)
    got_text = flickr_run.text_pipeline_text(WORK, args.text_steps, eval_n)
    got_flickr = flickr_run.flickr_pipeline_text(WORK, args.max_steps,
                                                 eval_n)
    assert got_text == want_text and got_flickr == want_flickr
    assert schema.loads_pipeline(got_text).model.text_model is not None
    ext = schema.loads_pipeline(got_flickr).model.cap2det_model
    assert ext.label_extractor.which_oneof() == (
        "text_classifier_match_extractor")


def test_text_run_inputs(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    text_run.write_inputs(str(tmp_path))
    with open(os.path.join(REPO, "data", "coco_open_vocab.txt")) as fid:
        base = [l.rstrip("\n") for l in fid]
    vocab = (tmp_path / "open_vocab.txt").read_text().split("\n")
    assert vocab[:len(base)] == base and len(vocab) > len(base)
    emb = np.load(str(tmp_path / "open_vocab_300d.npy"))
    want = (np.random.RandomState(0).randn(len(vocab), 300) * 0.5).astype(
        np.float32)
    np.testing.assert_array_equal(emb, want)
    sizes = [os.path.getsize(str(tmp_path / ("text_%s.record" % split)))
             for split in ("train", "eval")]
    assert sizes[0] > sizes[1] > 0


def test_quality_run_summary(tmp_path):
    def write(name, rows):
        (tmp_path / name).write_text(
            "".join(json.dumps(r) + "\n" for r in rows))

    key = "iter%d/PascalBoxes_Precision/mAP@0.5IOU"
    write("eval_metrics.jsonl", [
        {"step": 250, key % 0: 0.1, key % 1: 0.3,
         "eval/seconds_per_checkpoint": 4.0},
        {"step": 500, key % 0: float("nan"), key % 1: float("nan"),
         "eval/seconds_per_checkpoint": 2.0},
        {"step": 600, key % 0: float("nan"), key % 1: 0.05,
         "eval/seconds_per_checkpoint": 2.0},
        {"step": 750, key % 0: 0.2, key % 1: 0.25,
         "eval/seconds_per_checkpoint": 3.0}])
    write("metrics.jsonl", [{"step": 25, "global_step/sec": 0.1},
                            {"step": 50, "global_step/sec": 20.0},
                            {"step": 75, "global_step/sec": 25.0}])
    got = quality_run.summary(str(tmp_path))
    assert got["best_step"] == 250 and got["best_map"] == 0.3
    assert got["curve"][750] == 0.25 and np.isnan(got["curve"][500])
    assert got["curve"][600] == 0.05  # a NaN iteration is passed over
    assert got["step_ms_median"] == pytest.approx(45.0)
    assert got["eval_s_median"] == 2.5
