"""ec_read_GBps.<mix>: the read-ahead thread's rate while it works: the
bytes of the EC file pipeline's `encode_read` stage in the window (the
stripe arrays it fills from the `.dat`) over that stage's seconds, from
the program's stage counters; 1 GB = 1e9 bytes."""

from ecbench import program


def read(ctx):
    secs = ctx.delta(program.stage_seconds("encode_read"))
    nbytes = ctx.delta(program.stage_bytes("encode_read"))
    if not secs or not nbytes:
        return None
    return nbytes / secs / 1e9
