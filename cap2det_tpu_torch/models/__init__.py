from cap2det_tpu_torch.models import cap2det  # noqa: F401  (registers models)
