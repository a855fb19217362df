"""Multi-device scaling (SURVEY.md section 2, parallelism inventory).

The reference's parallelism is patch-grid data parallelism inside one OpenCL
kernel plus a single host<->GPU queue (``src/FftMethod.cpp:398``,
``README.md:85-88``).  The equivalents here:

1. patch-grid parallelism  -> the batch dimensions of the jitted kernels;
2. host/device pipelining  -> donated buffers + async dispatch;
3. multi-chip throughput   -> pure data parallelism over frame pairs via a
   ``jax.sharding.Mesh`` (:func:`make_mesh`) with batch-sharded inputs —
   no collectives are required by the math, and the only cross-device
   reduction (fleet-wide statistics) is an all-reduce (NVLink between the
   GPUs of one host).
"""

from mrs_optic_flow_tpu.parallel.sharding import (  # noqa: F401
    make_mesh,
    shard_batch,
    sharded_flow_step,
)
from mrs_optic_flow_tpu.parallel.pipeline import (  # noqa: F401
    BatchPipeline,
    LongRangeOutput,
    PipelineOutput,
)
