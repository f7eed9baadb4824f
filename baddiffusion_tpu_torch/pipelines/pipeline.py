"""DiffusionPipeline: a UNet + scheduler bundle with HF-layout IO (port of
``baddiffusion_tpu/pipelines/pipeline.py``), and the batched samplers
``batch_sampling`` and ``batch_sampling_save``.

``__call__`` keeps the JAX surface (``init=``, ``save_every_step``,
``capture_every``, ``start_from``, ``compute_dtype``) for every scheduler of
the zoo: SDE-VE and Karras-VE run their own engines, as the JAX
``_sample_fn`` dispatches them. Images come back as NHWC float32 numpy arrays
in [0, 1] (or, with ``output_type="pt"``, as tensors on the device with the
chain's sample before clipping). With ``compute_dtype`` the UNet runs on a
copy of its weights cast once per call (``UNet2DModel.compute_copy``: the
GroupNorm affines stay f32); the scheduler update stays f32.

With ``mesh`` set (a ``parallel.make_mesh`` mesh; every rank calls the
pipeline alike), a call splits its batch over the data ranks, padded with
copies of row 0: every rank draws the initial latent and each step's noise
for the whole batch, in the one-rank order, and keeps its rows; the result is
all-gathered, so the images are the one-rank call's. The JAX package's
``mesh_sample_shardings`` has no counterpart beyond this.

With ``segment_steps`` set, a chain runs as segments of at most that many
steps (``pipelines/segments.py``), dispatched as the JAX package dispatches
them: not for Karras-VE, and only when a segment is shorter than the chain.
On the CPU the segments run eagerly; on the card each is a CUDA graph,
captured at the first call of a shape and replayed after, so a call costs
one launch a segment. At most ``GRAPH_CACHE_SIZE`` captured chains are
kept a pipeline, the least recently used dropped first (with its graphs and
their memory): a measure's last, shorter chunk captures anew. The graphs
read one copy of the UNet in the compute dtype, refreshed from the live
weights at every call. A chain on a mesh holds no collective, so each rank
captures its own; its graphs draw at the whole batch and keep the rank's
rows, so the whole batch's shape is part of the cache key.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.io import load_unet, save_unet
from baddiffusion_tpu_torch.models.unet2d import UNet2DModel
from baddiffusion_tpu_torch.parallel.distributed import take_rows
from baddiffusion_tpu_torch.parallel.layout import all_gather_dim
from baddiffusion_tpu_torch.parallel.mesh import DATA_AXIS, axis
from baddiffusion_tpu_torch.pipelines.sampler import (
    Chain,
    NoiseSource,
    chain_images,
    noise_drawer,
    pad_batch_for_mesh,
    sample_chain,
    trim_padded,
)
from baddiffusion_tpu_torch.pipelines.segments import GraphedChain, compute_twin, refresh_twin
from baddiffusion_tpu_torch.schedulers import load_scheduler
from baddiffusion_tpu_torch.utils.image import batchify, save_images

MODEL_INDEX_NAME = "model_index.json"
GRAPH_CACHE_SIZE = 4  # captured chains kept by a pipeline


@dataclasses.dataclass
class PipelineOutput:
    """Images in [0, 1], NHWC; ``movie`` is the captured trajectory
    ``[frames, B, H, W, C]``; ``sample`` is the chain's result before the
    mapping to images (``output_type="pt"`` only)."""

    images: np.ndarray
    movie: Optional[np.ndarray] = None
    sample: Optional[torch.Tensor] = None


class DiffusionPipeline:
    """A (unet, scheduler) bundle on ``device`` (CUDA unless the caller asks
    otherwise; raises without a GPU)."""

    def __init__(
        self,
        unet: UNet2DModel,
        scheduler,
        clip_each_step: Optional[float] = None,
        default_inference_steps: int = 1000,
        hf_class_name: str = "DDPMPipeline",
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.scheduler = scheduler
        self.clip_each_step = clip_each_step
        self.default_inference_steps = default_inference_steps
        self.hf_class_name = hf_class_name
        # UNet compute precision for sampling; None keeps the UNet's own dtype
        self.compute_dtype = compute_dtype
        self.mesh = None  # a device mesh: each call splits its batch over the data ranks
        self.segment_steps: Optional[int] = None  # run chains as segments of at most this many steps
        self._graphs: "OrderedDict[tuple, GraphedChain]" = OrderedDict()
        self._twin = None  # (key, the UNet copy the graphs read)

    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        index = {
            "_class_name": self.hf_class_name,
            "_diffusers_version": "0.16.0.dev0",
            "unet": ["diffusers", "UNet2DModel"],
            "scheduler": ["diffusers", self.scheduler.hf_class_name],
        }
        with open(os.path.join(save_directory, MODEL_INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)
        save_unet(self.unet, os.path.join(save_directory, "unet"))
        self.scheduler.save_config(os.path.join(save_directory, "scheduler"))

    @classmethod
    def from_pretrained(cls, path: str, device: DeviceLike = None, **kwargs) -> "DiffusionPipeline":
        """Load an HF-layout pipeline dir (as the JAX package or diffusers
        write it) onto ``device`` (CUDA by default)."""
        device = resolve_device(device)
        with open(os.path.join(path, MODEL_INDEX_NAME)) as f:
            index = json.load(f)
        unet = load_unet(path, subfolder="unet", device=device)
        scheduler = load_scheduler(path, subfolder="scheduler")
        return cls(unet, scheduler, hf_class_name=index.get("_class_name", "DDPMPipeline"), device=device, **kwargs)

    # the pixel/latent surface: identity for a pixel-space pipeline
    # (LDMPipeline encodes and decodes through its VQ-VAE)
    def encode(self, image, *args, **kwargs):
        return image

    def decode(self, latents, *args, **kwargs):
        return latents

    def sample_shape(self, batch_size: int) -> Tuple[int, int, int, int]:
        cfg = self.unet.config
        size = cfg.sample_size or 32
        return (batch_size, size, size, cfg.in_channels)

    def _compute_unet(self) -> UNet2DModel:
        if self.compute_dtype is None or self.compute_dtype == self.unet.dtype:
            return self.unet
        return self.unet.compute_copy(self.compute_dtype)

    @torch.inference_mode()
    def __call__(
        self,
        batch_size: int = 1,
        generator: Optional[torch.Generator] = None,
        init=None,
        num_inference_steps: Optional[int] = None,
        save_every_step: bool = False,
        capture_every: Optional[int] = None,
        start_from: int = 0,
        noise_source: Optional[NoiseSource] = None,
        output_type: str = "np",
    ) -> PipelineOutput:
        """``init`` replaces the random initial latent (``noise + trigger``
        samples the backdoor); ``save_every_step`` captures the trajectory,
        strided by ``capture_every`` (about 50 frames by default). Random
        draws come from ``generator`` (default: one on the device seeded 0).
        ``output_type="pt"`` returns the images, the movie and the sample as
        tensors on the device, made under inference mode, without copying
        them to the host."""
        n = num_inference_steps or self.default_inference_steps
        if save_every_step and capture_every is None:
            capture_every = max(1, n // 50)
        if not save_every_step:
            capture_every = None
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if init is None:
            init = torch.randn(self.sample_shape(batch_size), generator=generator, device=self.device)
        else:
            init = torch.as_tensor(init, dtype=torch.float32, device=self.device)

        group, count, index = axis(self.mesh, DATA_AXIS)
        batch, whole = init.shape[0], init
        if count > 1:  # this rank's rows of the padded batch; every draw made whole first
            init = take_rows(pad_batch_for_mesh(init, count)[0], index, count)

        def make_draw(gen):
            draw = noise_drawer(whole, gen, noise_source)
            if count == 1:
                return draw
            return lambda k: take_rows(pad_batch_for_mesh(draw(k), count)[0], index, count)

        karras_ve = self.scheduler.hf_class_name == "KarrasVeScheduler"
        segment_steps = None
        if self.segment_steps and not karras_ve and self.segment_steps < n - start_from:
            segment_steps = int(self.segment_steps)
        if segment_steps and self.device.type == "cuda":
            sample, movie = self._run_segmented(init, whole.shape, generator, noise_source, make_draw, n, start_from,
                                                capture_every, segment_steps)
        else:  # the chain whole, or its segments eagerly one after another
            state = self.scheduler.set_timesteps(self.scheduler.create_state(), n)
            sample, movie = sample_chain(
                self.scheduler, state, self._compute_unet(), init,
                generator=generator, noise_source=make_draw(generator) if count > 1 else noise_source,
                start_from=start_from, clip_each_step=self.clip_each_step, capture_every=capture_every,
                segment_steps=segment_steps,
            )
        images = chain_images(self.scheduler, sample)
        movie = None if movie is None else chain_images(self.scheduler, movie)
        if count > 1:
            sample = all_gather_dim(sample, 0, group, count)[:batch]
            images, movie = trim_padded(all_gather_dim(images, 0, group, count),
                                        None if movie is None else all_gather_dim(movie, 1, group, count), batch)
        if output_type == "pt":
            return PipelineOutput(images=images, movie=movie, sample=sample)
        return PipelineOutput(images=images.cpu().numpy(), movie=None if movie is None else movie.cpu().numpy())

    def _run_segmented(self, init, whole_shape, generator, noise_source, make_draw, n: int, start_from: int,
                       capture_every, segment_steps: int):
        """The chain on the card in segments of ``segment_steps``, as cached
        CUDA graphs. Returns (sample, movie)."""
        if noise_source is not None:
            raise ValueError("a segmented chain on the card draws its noise inside CUDA graphs: "
                             "a noise_source cannot be captured")
        dtype = self.compute_dtype or self.unet.dtype
        twin_key = (id(self.unet), dtype)
        if self._twin is None or self._twin[0] != twin_key:
            self._graphs.clear()  # graphs read the copy they were captured with
            self._twin = (twin_key, compute_twin(self.unet, dtype))
        twin = self._twin[1]
        refresh_twin(twin, self.unet)
        # on a mesh the graphs draw at the whole (unpadded) batch and keep
        # this rank's rows: two batches that pad to the same rows draw apart
        key = (tuple(init.shape), tuple(whole_shape), n, start_from, capture_every, segment_steps, self.scheduler,
               self.clip_each_step, id(self.mesh))
        runner = self._graphs.get(key)
        if runner is None:
            state = self.scheduler.set_timesteps(self.scheduler.create_state(), n)
            chain = Chain(self.scheduler, state, self.device, start_from, self.clip_each_step, capture_every)
            runner = GraphedChain(chain, twin, init.shape, segment_steps, make_draw, self.device)
            self._graphs[key] = runner
            while len(self._graphs) > GRAPH_CACHE_SIZE:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        return runner(init, generator)


def chunk_generator(device: torch.device, seed: int, index: int) -> torch.Generator:
    """The generator of chunk ``index`` of a batched run seeded ``seed``: a
    function of the two alone, so that any split of the chunks over callers
    draws what one caller would."""
    state = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def _chunks(sample_n: int, init: Optional[np.ndarray], max_batch_n: int) -> List[Tuple[int, int, Optional[np.ndarray]]]:
    """(offset, size, init rows or None) of each chunk."""
    sizes = batchify(sample_n if init is None else init.shape[0], max_batch_n)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    return [(int(o), s, None if init is None else init[o : o + s]) for s, o in zip(sizes, offsets)]


def batch_sampling(
    sample_n: int,
    pipeline: DiffusionPipeline,
    init: Optional[np.ndarray] = None,
    max_batch_n: int = 256,
    seed: int = 0,
    **kwargs,
) -> np.ndarray:
    """Sample in chunks of at most ``max_batch_n`` and concatenate. Chunk i
    draws from ``chunk_generator(seed, i)``, as ``batch_sampling_save``'s
    chunks do, so the two give the same images."""
    outs = [
        pipeline(batch_size=s, generator=chunk_generator(pipeline.device, seed, i), init=chunk, **kwargs).images
        for i, (_, s, chunk) in enumerate(_chunks(sample_n, init, max_batch_n))
    ]
    return np.concatenate(outs)


def batch_sampling_save(
    sample_n: int,
    pipeline: DiffusionPipeline,
    path: str,
    init: Optional[np.ndarray] = None,
    max_batch_n: int = 256,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
    **kwargs,
) -> None:
    """Sample in chunks and save each image as ``{path}/{i}.png`` with a
    running index. ``shard_index``/``shard_count`` split the chunks over
    cooperating callers, round-robin by the chunk's global index, and both
    the chunk's generator and its file offset follow that global index: the
    union of all shards' files is the one caller's run, bitwise. One writer
    thread encodes a chunk's PNGs while the next chunk samples; at most two
    chunks wait on it."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = []
        for i, (offset, s, chunk) in enumerate(_chunks(sample_n, init, max_batch_n)):
            if i % shard_count != shard_index:
                continue
            images = pipeline(batch_size=s, generator=chunk_generator(pipeline.device, seed, i), init=chunk,
                              **kwargs).images
            pending.append(pool.submit(save_images, images, path, start_cnt=offset))
            while len(pending) > 2:
                pending.pop(0).result()
        for f in pending:
            f.result()
