"""baddiffusion_tpu_torch — the PyTorch/CUDA port of baddiffusion_tpu.

A second package beside the JAX one, held against it module by module on the
same inputs and weights. It imports torch (plus numpy, PIL and safetensors)
and nothing of JAX or of ``baddiffusion_tpu``. Public functions keep the JAX
package's NHWC layout. Every TPU kernel on the ported path is a CUDA kernel
written by hand for Hopper (``csrc/``), built with nvcc at first use.

Ported so far: backdoor DDPM sampling on the UNet (``models``, ``schedulers``,
``pipelines``, ``io``, ``data.triggers``), with the GroupNorm+SiLU and
attention kernels (``ops``); the backdoor train step (``attack``,
``data.poison``, ``training.optim``, ``training.train``); the trainer
around it (``data.datasets``, ``data.prefetch``, ``training.ema``,
``training.checkpoint``, ``training.trainer``, ``utils``); and the sampler
zoo (``schedulers``, the SDE-VE and Karras-VE engines in ``pipelines``, the
scheduler half of ``factory``); and what a user runs: ``config`` and ``cli``
(train / resume / sampling / measure / train+measure), the model half of
``factory``, the measure (``metrics``, ``models.inception``) and the ANP
defense (``defense``, ``anp_cli``); the latent and score models; the
reference's recipes (``examples``); and scale-out over ranks (``parallel``:
one process a device, data-parallel, FSDP and tensor-parallel training, the
multi-rank CLI, measure and ANP).
"""

__version__ = "0.1.0"
