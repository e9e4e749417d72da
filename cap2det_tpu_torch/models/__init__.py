# Importing the model modules registers them.
from cap2det_tpu_torch.models import cap2det, text_model  # noqa: F401
