from baddiffusion_tpu_torch.pipelines.pipeline import DiffusionPipeline, PipelineOutput, batch_sampling, batchify
from baddiffusion_tpu_torch.pipelines.sampler import chain_prologue, sample_loop, to_images

__all__ = [
    "DiffusionPipeline",
    "PipelineOutput",
    "batch_sampling",
    "batchify",
    "chain_prologue",
    "sample_loop",
    "to_images",
]
