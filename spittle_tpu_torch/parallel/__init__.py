"""The mesh layer (dp, tp, pp and ep over torch.distributed) and serving:
the batching transcription server and its HTTP front."""

from .mesh import batch_sharding, make_mesh, shard_params, whisper_param_specs
from .pipeline_parallel import pipeline_apply, stack_to_stages
from .serving import BatchingTranscriptionServer, bucket_for

__all__ = [
    "batch_sharding",
    "make_mesh",
    "shard_params",
    "whisper_param_specs",
    "pipeline_apply",
    "stack_to_stages",
    "BatchingTranscriptionServer",
    "bucket_for",
]
