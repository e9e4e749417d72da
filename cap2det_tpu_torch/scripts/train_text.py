"""Text-classifier training (the port's counterpart of
``scripts/train_text.sh``): trains the caption classifier whose
checkpoint warm-starts the text_classifier_match label extractor, with
the eval daemon beside it, as ``scripts.train`` does.

  python -m cap2det_tpu_torch.scripts.train_text <config-name> \\
      [model_dir] [extra train_main args...] [--device cuda|cpu]

``model_dir`` defaults to ``logs/<config-name>``; exits with the
trainer's exit code.
"""

from __future__ import annotations

import sys

from cap2det_tpu_torch.scripts import train

if __name__ == "__main__":
    sys.exit(train.main(prog="train_text"))
