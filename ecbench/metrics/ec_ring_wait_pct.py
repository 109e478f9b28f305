"""ec_ring_wait_pct.<mix>: the share of the window in which the
read-ahead thread waits for a free buffer of the EC file pipeline's
stripe ring, that is, in which the shard writer and not the reader sets
the pace: the seconds of the `encode_ring_wait` stage in the window,
from the program's stage counters, over the window's seconds.  A
program without the ring has no such stage, and reads nothing."""

from ecbench import program


def read(ctx):
    secs = ctx.delta(program.stage_seconds("encode_ring_wait"))
    return None if secs is None else 100.0 * secs / ctx.window_s
