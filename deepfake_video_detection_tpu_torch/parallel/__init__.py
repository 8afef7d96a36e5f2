"""Multi-device training over ``torch.distributed``: the counterpart of
``deepfake_video_detection_tpu/parallel``, with the same names."""

from deepfake_video_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate,
)
from deepfake_video_detection_tpu_torch.parallel.multihost import (  # noqa: F401
    global_batch_from_local,
    local_batch_size,
)
from deepfake_video_detection_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_blocks,
)
