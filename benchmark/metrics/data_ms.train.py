"""Host time inside the loop's `train.data` span per traced step (ms): the
wait for the loader's next batch and its copy to the device."""

from harness.readers import range_host_ms


def read(ctx):
    return range_host_ms(ctx, "train.data")
