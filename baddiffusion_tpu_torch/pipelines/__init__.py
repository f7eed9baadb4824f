from baddiffusion_tpu_torch.pipelines.ldm import LDMPipeline
from baddiffusion_tpu_torch.pipelines.pipeline import (
    DiffusionPipeline,
    PipelineOutput,
    batch_sampling,
    batch_sampling_save,
    batchify,
)
from baddiffusion_tpu_torch.pipelines.sampler import (
    chain_images,
    chain_prologue,
    sample_chain,
    sample_loop,
    sample_sde_ve,
    to_images,
)

__all__ = [
    "DiffusionPipeline",
    "LDMPipeline",
    "PipelineOutput",
    "batch_sampling",
    "batch_sampling_save",
    "batchify",
    "chain_images",
    "chain_prologue",
    "sample_chain",
    "sample_loop",
    "sample_sde_ve",
    "to_images",
]
