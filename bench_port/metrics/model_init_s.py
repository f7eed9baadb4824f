"""Host seconds a UNet's construction takes (the meta build, the device
allocation, the weights' seeded init and the channels-last layout): the
program's ``unet.init`` counter, its seconds over its calls in this process.
A program without the counter gives nothing to read."""

LAYER = "UNet"
MOVES = "setup_s"


def read(ctx):
    from baddiffusion_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    calls, seconds = counters().get("unet.init", (0, 0.0))
    return seconds / calls if calls else None
