"""The run scripts: the layer above the CLIs (the port's counterparts of
the shell scripts in ``scripts/``, one module each, under the same name).

  train         trainer plus a background eval daemon   (train.sh)
  eval_once     one evaluation of the newest checkpoint (eval_once.sh)
  train_text    the text classifier's training run      (train_text.sh)
  quality_run   scenes -> selective search -> records -> train -> every
                checkpoint evaluated                    (quality_run.sh)
  text_run      coco17_text on synthetic captions       (text_run_tpu.sh)
  flickr_run    the flickr30k tool chain, the text classifier, then
                Cap2Det with text_classifier_match      (flickr_run_tpu.sh)

Each runs as ``python -m cap2det_tpu_torch.scripts.<name>``, starts every
step as ``sys.executable -m cap2det_tpu_torch.<module>`` and passes
``--device`` (``cuda`` unless the caller asks for ``cpu``) to every CLI
it starts. A failing step ends the run with that step's exit code, after
printing the end of its log.
"""
