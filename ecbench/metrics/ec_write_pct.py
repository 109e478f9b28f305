"""ec_write_pct.<mix>: the share of the window in which the main thread
writes shard files (each shard's `tobytes` and `write`): the seconds
of the EC file pipeline's `encode_write` stage in the window, from the
program's stage counters, over the window's seconds."""

from ecbench import program


def read(ctx):
    secs = ctx.delta(program.stage_seconds("encode_write"))
    return None if secs is None else 100.0 * secs / ctx.window_s
