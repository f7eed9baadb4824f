"""The JAX package's examples, as modules of the port (each the port of
``examples/<name>.py``). The reference's own recipes:

    python -m baddiffusion_tpu_torch.examples.attack_demo [--steps 3000] [--out attack_demo_out]
    python -m baddiffusion_tpu_torch.examples.defense_demo --ckpt attack_demo_out [--steps 300]
    python -m baddiffusion_tpu_torch.examples.train_sde_ve [--steps 4000] [--n 256] [--out sde_ve_out]

and the sweeps and analyses:

    python -m baddiffusion_tpu_torch.examples.sampling_batch_sweep [--batches ...] [--segments ...]
    python -m baddiffusion_tpu_torch.examples.sampler_sweep --ckpt RUN
    python -m baddiffusion_tpu_torch.examples.bf16_drift [--ckpt attack_demo_out]
    python -m baddiffusion_tpu_torch.examples.anp_dose_response --ckpt RUN
    python -m baddiffusion_tpu_torch.examples.anp_frontier --ckpt RUN
    python -m baddiffusion_tpu_torch.examples.stage_fake_datasets [NAME ...]
    python -m baddiffusion_tpu_torch.examples.profile_attribution [train|sample]
    python -m baddiffusion_tpu_torch.examples.mfu_analysis [--measure] [--sampling]
    python -m baddiffusion_tpu_torch.examples.accum_variants [--variants loop remat_full]

Each has a ``run(...)`` (``train_main``/``sampling_main`` for
``mfu_analysis``) with the script's flags as parameters (and a few more, so
that a test can run it at a tiny size) and a ``main()`` that parses the JAX
script's flags with its defaults; their outputs default to the git-ignored
``torch_examples_out/``, never to the repo root's JSON files (the JAX
package's results). They run on the card unless the caller asks for the CPU
(``device="cpu"``, ``--gpu cpu``).
"""
