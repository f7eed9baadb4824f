"""baddiffusion_tpu_torch — the PyTorch/CUDA port of baddiffusion_tpu.

A second package beside the JAX one, held against it module by module on the
same inputs and weights. It imports torch (plus numpy, PIL and safetensors)
and nothing of JAX or of ``baddiffusion_tpu``. Public functions keep the JAX
package's NHWC layout. Every TPU kernel on the ported path is a CUDA kernel
written by hand for Hopper (``csrc/``), built with nvcc at first use.

Ported so far: backdoor DDPM sampling on the UNet (``models``, ``schedulers``,
``pipelines``, ``io``, ``data.triggers``), with the GroupNorm+SiLU and
attention kernels (``ops``).
"""

__version__ = "0.1.0"
