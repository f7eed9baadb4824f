"""The reference's own recipes, as modules of the port (ports of the JAX
package's ``examples/attack_demo.py``, ``examples/defense_demo.py`` and
``examples/train_sde_ve.py``):

    python -m baddiffusion_tpu_torch.examples.attack_demo [--steps 3000] [--out attack_demo_out]
    python -m baddiffusion_tpu_torch.examples.defense_demo --ckpt attack_demo_out [--steps 300]
    python -m baddiffusion_tpu_torch.examples.train_sde_ve [--steps 4000] [--n 256] [--out sde_ve_out]

Each has a ``run(...)`` with the script's flags as parameters (and a few
more, so that a test can run it at a tiny size) and a ``main()`` that parses
the JAX script's flags with its defaults. They run on the card unless the
caller asks for the CPU (``device="cpu"``, ``--gpu cpu``).
"""
