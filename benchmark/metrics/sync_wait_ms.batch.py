"""Host time inside the program's `sync.*` spans per batch (ms): the host's
wait on the device at its deliberate reads, 0 where the render ran without
one."""

from harness.spans import sync_wait_ms


def read(ctx):
    return sync_wait_ms(ctx)
