"""Multi-GPU: the data-parallel group, process-group start-up and
H-sharded serving (port of ``tensorflow_ocr_tpu/parallel/``), one
process per GPU over ``torch.distributed``. Importing it starts no
process group."""

from tensorflow_ocr_tpu_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    make_mesh,
    shard_batch,
)
