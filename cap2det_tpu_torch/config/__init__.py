from cap2det_tpu_torch.config import pbtxt  # noqa: F401
from cap2det_tpu_torch.config.schema import (  # noqa: F401
    Pipeline,
    load_pipeline,
    loads_pipeline,
)
