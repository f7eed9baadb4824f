"""Run configuration: flags, per-mode merging, run-dir naming, persistence
(port of ``baddiffusion_tpu/config.py``).

The reference's ``baddiffusion.py:16-248``:
  - 5 modes (train / resume / sampling / measure / train+measure) with
    per-mode allow-lists; a flag a mode does not use raises
  - resume, sampling and measure reload ``args.json`` from the run dir,
    then apply only the mode's allowed flags
  - run dir ``res_{ckpt}_{ds}_ep{E}_c{clean}_p{poison}_{trigger}-{target}[_{postfix}]``,
    refused when it exists unless ``--overwrite``
  - learning rate and grad-accum by dataset: 32 px → global batch 128,
    256 px → 64; ``grad_accum = global_batch // --batch``
  - ``args.json`` and ``config.json`` (train), ``sampling.json`` or
    ``measure.json`` for those modes

``--gpu`` selects the device, as in the reference: unset is ``cuda``,
``N`` is ``cuda:N``, ``cpu`` is the CPU (how the tests ask for it). It is
read from the command line of each run only, never from a run dir's
``args.json``, so a run trained on the CPU is not measured there by default.
One process drives one device: the JAX package's multi-process run-dir
handshake is not ported (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import torch

from baddiffusion_tpu_torch.data.datasets import DatasetLoader
from baddiffusion_tpu_torch.data.triggers import Backdoor
from baddiffusion_tpu_torch.device import resolve_device
from baddiffusion_tpu_torch.utils.logging import Log

MODE_TRAIN = "train"
MODE_RESUME = "resume"
MODE_SAMPLING = "sampling"
MODE_MEASURE = "measure"
MODE_TRAIN_MEASURE = "train+measure"
MODES = [MODE_TRAIN, MODE_RESUME, MODE_SAMPLING, MODE_MEASURE, MODE_TRAIN_MEASURE]

DEFAULT_PROJECT = "Default"
DEFAULT_BATCH = 512
DEFAULT_EVAL_MAX_BATCH = 256
DEFAULT_EPOCH = 50
DEFAULT_LEARNING_RATE_32 = 2e-4
DEFAULT_LEARNING_RATE_256 = 8e-5
DEFAULT_CLEAN_RATE = 1.0
DEFAULT_POISON_RATE = 0.007
DEFAULT_TRIGGER = Backdoor.TRIGGER_BOX_14
DEFAULT_TARGET = Backdoor.TARGET_CORNER

NOT_MODE_TRAIN_OPTS = ["sample_ep"]
NOT_MODE_TRAIN_MEASURE_OPTS = ["sample_ep"]
MODE_RESUME_OPTS = ["project", "mode", "gpu", "ckpt"]
MODE_SAMPLING_OPTS = ["project", "mode", "eval_max_batch", "gpu", "fclip", "ckpt", "sample_ep", "sched"]
MODE_MEASURE_OPTS = ["project", "mode", "eval_max_batch", "gpu", "fclip", "ckpt", "sample_ep", "sched"]
IGNORE_ARGS = ["overwrite", "is_save_all_model_epochs"]
EXTRA_OPTS = ["fake_size", "measure_sample_n", "measure_steps", "sampling_steps", "profile_steps", "split_method",
              "eval_dtype", "remat", "param_sharding", "model_parallel", "capture_every", "image_size", "async_ckpt",
              "sample_segment"]

SCHED_CHOICES = [
    "DDPM-SCHED", "DDIM-SCHED",
    "DPM_SOLVER_PP_O1-SCHED", "DPM_SOLVER_O1-SCHED",
    "DPM_SOLVER_PP_O2-SCHED", "DPM_SOLVER_O2-SCHED",
    "DPM_SOLVER_PP_O3-SCHED", "DPM_SOLVER_O3-SCHED",
    "UNIPC-SCHED", "PNDM-SCHED", "DEIS-SCHED", "HEUN-SCHED", "LMSD-SCHED",
    "SCORE-SDE-VE-SCHED",
]


@dataclass
class TrainingConfig:
    project: str = DEFAULT_PROJECT
    mode: str = MODE_TRAIN
    dataset: Optional[str] = None
    sched: Optional[str] = None
    batch: int = DEFAULT_BATCH
    epoch: int = DEFAULT_EPOCH
    eval_max_batch: int = DEFAULT_EVAL_MAX_BATCH
    learning_rate: Optional[float] = None
    clean_rate: float = DEFAULT_CLEAN_RATE
    poison_rate: float = DEFAULT_POISON_RATE
    trigger: str = DEFAULT_TRIGGER
    target: str = DEFAULT_TARGET
    dataset_load_mode: str = DatasetLoader.MODE_FIXED
    gpu: Optional[str] = None  # this run's device (see device_from_gpu)
    ckpt: Optional[str] = None
    overwrite: bool = False
    postfix: str = ""
    fclip: str = "o"
    save_image_epochs: int = 20
    save_model_epochs: int = 5
    is_save_all_model_epochs: bool = False
    sample_ep: Optional[int] = None
    result: str = "."

    eval_sample_n: int = 16
    measure_sample_n: int = 2048
    batch_32: int = 128
    batch_256: int = 64
    gradient_accumulation_steps: int = 1
    learning_rate_32_scratch: float = 2e-4
    learning_rate_256_scratch: float = 2e-5
    lr_warmup_steps: int = 500
    # the reference's 'fp16' + grad scaler is bf16 compute on f32 parameters
    # here, as in the JAX package; "no" trains in f32
    mixed_precision: str = "bf16"
    seed: int = 0
    dataset_path: str = "datasets"
    ckpt_dir: str = "ckpt"
    data_ckpt_dir: str = "data.json"
    ep_model_dir: str = "epochs"

    # derived
    output_dir: Optional[str] = None
    clip: Optional[bool] = None

    # the JAX package's extension flags (not in the reference surface)
    fake_size: int = 512  # FAKE dataset size (offline runs)
    split_method: str = "seeded"  # poison split: seeded numpy permutation | "hf" train_test_split
    eval_dtype: str = "fp32"  # sampling/measure UNet compute: fp32 (reference parity) | bf16
    remat: str = "auto"  # train-step recomputation: auto | on | off
    param_sharding: str = "replicated"  # the JAX package's mesh layouts; one device here
    model_parallel: int = 1
    sampling_steps: int = 1000  # inference steps of the train-time sample grids
    capture_every: Optional[int] = None  # movie-frame stride (None: about 50 frames)
    image_size: Optional[int] = None  # overrides the dataset's image size
    # the JAX package's bound on an XLA sampling program's length; parsed
    # here, and refused by every run (an eager chain has no program to bound)
    sample_segment: Optional[int] = None
    measure_steps: Optional[int] = None  # measure's inference steps; None: each pipeline's default
    profile_steps: int = 0  # >0: torch.profiler trace of N train steps under <out>/profile
    async_ckpt: bool = False  # write the trainer state in the background

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, sort_keys=True, default=str)

    @property
    def device(self) -> torch.device:
        return resolve_device(device_from_gpu(self.gpu))


def device_from_gpu(gpu: Optional[str]) -> str:
    """``--gpu`` → a device: unset is ``cuda``, ``N`` is ``cuda:N``, ``cpu``
    (or any device string torch reads) is itself. A list of cards
    (``0,1``) asks for more than one device, which the port does not drive
    yet (ROADMAP Queue 1 item 11)."""
    if gpu is None or gpu == "":
        return "cuda"
    if "," in gpu:
        raise NotImplementedError(f"--gpu {gpu}: one process drives one device (ROADMAP Queue 1 item 11)")
    return f"cuda:{gpu}" if gpu.isdigit() else gpu


def naming_fn(config: TrainingConfig) -> str:
    add_on = f"_{config.postfix}" if config.postfix else ""
    return (
        f"res_{config.ckpt}_{config.dataset}_ep{config.epoch}"
        f"_c{config.clean_rate}_p{config.poison_rate}"
        f"_{config.trigger}-{config.target}{add_on}"
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="baddiffusion_tpu_torch — BadDiffusion on PyTorch/CUDA")
    parser.add_argument("--project", "-pj", type=str)
    parser.add_argument("--mode", "-m", required=True, type=str, choices=MODES)
    parser.add_argument(
        "--dataset", "-ds", type=str,
        choices=[DatasetLoader.MNIST, DatasetLoader.CIFAR10, DatasetLoader.CELEBA,
                 DatasetLoader.CELEBA_HQ, DatasetLoader.LSUN_CHURCH,
                 DatasetLoader.LSUN_BEDROOM, DatasetLoader.FAKE],
    )
    parser.add_argument("--batch", "-b", type=int)
    parser.add_argument("--sched", "-sc", type=str, choices=SCHED_CHOICES)
    parser.add_argument("--eval_max_batch", "-eb", type=int)
    parser.add_argument("--epoch", "-e", type=int)
    parser.add_argument("--learning_rate", "-lr", type=float)
    parser.add_argument("--clean_rate", "-cr", type=float)
    parser.add_argument("--poison_rate", "-pr", type=float)
    parser.add_argument("--trigger", "-tr", type=str)
    parser.add_argument("--target", "-ta", type=str)
    parser.add_argument("--dataset_load_mode", "-dlm", type=str,
                        choices=[DatasetLoader.MODE_FIXED, DatasetLoader.MODE_FLEX])
    parser.add_argument("--gpu", "-g", type=str, help="device: unset = cuda, N = cuda:N, cpu = the CPU")
    parser.add_argument("--ckpt", "-c", type=str)
    parser.add_argument("--overwrite", "-o", action="store_true", default=None)
    parser.add_argument("--postfix", "-p", type=str)
    parser.add_argument("--fclip", "-fc", type=str, choices=["w", "o"])
    parser.add_argument("--save_image_epochs", "-sie", type=int)
    parser.add_argument("--save_model_epochs", "-sme", type=int)
    parser.add_argument("--is_save_all_model_epochs", "-isame", action="store_true", default=None)
    parser.add_argument("--sample_ep", "-se", type=int)
    parser.add_argument("--result", "-res", type=str)
    # the JAX package's extension flags (accepted in every mode)
    parser.add_argument("--fake_size", type=int, help="FAKE dataset size (offline runs)")
    parser.add_argument("--split_method", type=str, choices=["seeded", "hf"],
                        help="poison-split membership: seeded numpy perm (default) or HF train_test_split(seed)")
    parser.add_argument("--eval_dtype", type=str, choices=["fp32", "bf16"],
                        help="UNet compute dtype for sampling/measure (default fp32, reference parity)")
    parser.add_argument("--remat", type=str, choices=["auto", "on", "off"],
                        help="train-step recomputation (default auto: 256 px above micro-batch 16)")
    parser.add_argument("--param_sharding", type=str, choices=["replicated", "fsdp"],
                        help="multi-device parameter layout (fsdp is not ported: ROADMAP Queue 1 item 11)")
    parser.add_argument("--model_parallel", type=int,
                        help="tensor-parallel axis size (above 1 is not ported: ROADMAP Queue 1 item 11)")
    parser.add_argument("--measure_sample_n", type=int, help="override eval sample count (default 2048)")
    parser.add_argument("--measure_steps", type=int, help="override measure-time inference steps (default: pipeline's)")
    parser.add_argument("--sampling_steps", type=int, help="inference steps for train-time sample grids")
    parser.add_argument("--capture_every", type=int,
                        help="movie-frame stride (1 = reference's every-step trajectory; default ~50 frames)")
    parser.add_argument("--image_size", type=int,
                        help="override the dataset-keyed image size (default: 32/64/256 per dataset)")
    parser.add_argument("--sample_segment", type=int,
                        help="the JAX package's bound on a sampling program's length; refused here "
                        "(an eager chain has no program to bound)")
    parser.add_argument("--profile_steps", type=int, help="write a torch.profiler trace of N train steps to <out>/profile")
    parser.add_argument("--async_ckpt", action="store_true", default=None,
                        help="overlap checkpoint disk writes with training")
    return parser


def setup(argv: Optional[List[str]] = None) -> TrainingConfig:
    args = build_parser().parse_args(argv)
    config = TrainingConfig()

    if args.mode in (MODE_RESUME, MODE_SAMPLING, MODE_MEASURE):
        with open(os.path.join(args.ckpt, "args.json")) as f:
            args_data = json.load(f)
        for key, value in args_data.items():
            if value is not None and hasattr(config, key):
                setattr(config, key, value)
        config.output_dir = args.ckpt
        config.gpu = None  # the device is this run's choice alone

    for key, value in vars(args).items():
        if args.mode == MODE_TRAIN and key not in NOT_MODE_TRAIN_OPTS and value is not None:
            setattr(config, key, value)
        elif args.mode == MODE_TRAIN_MEASURE and key not in NOT_MODE_TRAIN_MEASURE_OPTS and value is not None:
            setattr(config, key, value)
        elif args.mode == MODE_RESUME and key in MODE_RESUME_OPTS and value is not None:
            setattr(config, key, value)
        elif args.mode == MODE_SAMPLING and key in MODE_SAMPLING_OPTS and value is not None:
            setattr(config, key, value)
        elif args.mode == MODE_MEASURE and key in MODE_MEASURE_OPTS and value is not None:
            setattr(config, key, value)
        elif value is not None and key not in IGNORE_ARGS and key not in EXTRA_OPTS:
            raise NotImplementedError(f"Argument: {key}={value} isn't used in mode: {args.mode}")
    for key in EXTRA_OPTS:
        if getattr(args, key, None) is not None:
            setattr(config, key, getattr(args, key))

    if isinstance(config.sample_ep, int) and config.sample_ep < 0:
        config.sample_ep = None

    # fclip → clip (baddiffusion.py:187-193)
    config.clip = {"w": True, "o": False}.get(config.fclip)

    # learning rate and grad-accum by dataset (baddiffusion.py:195-217)
    if config.dataset in (DatasetLoader.CIFAR10, DatasetLoader.MNIST, DatasetLoader.FAKE):
        global_batch = config.batch_32
        if config.learning_rate is None:
            config.learning_rate = (
                config.learning_rate_32_scratch if config.ckpt is None else DEFAULT_LEARNING_RATE_32
            )
    elif config.dataset in (DatasetLoader.CELEBA, DatasetLoader.CELEBA_HQ,
                            DatasetLoader.LSUN_CHURCH, DatasetLoader.LSUN_BEDROOM):
        global_batch = config.batch_256
        if config.learning_rate is None:
            config.learning_rate = (
                config.learning_rate_256_scratch if config.ckpt is None else DEFAULT_LEARNING_RATE_256
            )
    else:
        raise NotImplementedError(f"dataset {config.dataset!r}")
    if global_batch % config.batch != 0:
        raise ValueError(f"batch size {config.batch} should be divisible to {global_batch} for dataset {config.dataset}")
    if global_batch < config.batch:
        raise ValueError(f"batch size {config.batch} should be smaller or equal to {global_batch} for dataset {config.dataset}")
    config.gradient_accumulation_steps = int(global_batch // config.batch)

    # resume continues the original learning-rate schedule: the policy above
    # sees ckpt = the run dir (never None), which would turn a scratch run's
    # rate into the fine-tune default; the run's config.json holds the rate
    # it trained with
    if args.mode == MODE_RESUME and args.learning_rate is None:
        cfg_path = os.path.join(args.ckpt, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                stored = json.load(f)
            if stored.get("learning_rate") is not None:
                config.learning_rate = float(stored["learning_rate"])

    if args.mode in (MODE_TRAIN, MODE_TRAIN_MEASURE):
        config.output_dir = os.path.join(config.result, naming_fn(config))

    Log.info(f"MODE: {config.mode}")
    if config.mode in (MODE_TRAIN, MODE_TRAIN_MEASURE):
        if not config.overwrite and os.path.isdir(config.output_dir):
            raise ValueError(
                f"Output directory: {config.output_dir} has already been created, "
                "please set overwrite flag --overwrite or -o"
            )
        os.makedirs(config.output_dir, exist_ok=True)
        with open(os.path.join(config.output_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
        config.save_json(os.path.join(config.output_dir, "config.json"))
    elif config.mode == MODE_SAMPLING:
        config.save_json(os.path.join(config.output_dir, "sampling.json"))
    if config.mode in (MODE_MEASURE, MODE_TRAIN_MEASURE):
        # train+measure records measure.json too (baddiffusion.py:233-234)
        config.save_json(os.path.join(config.output_dir, "measure.json"))

    print(f"Argument Final: {dataclasses.asdict(config)}")
    return config
