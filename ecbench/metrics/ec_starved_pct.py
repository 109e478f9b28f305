"""ec_starved_pct.<mix>: the share of the window in which the main thread
waits on the read-ahead for its next chunk: the seconds of the EC file
pipeline's `encode_read_wait` stage in the window, from the program's
stage counters, over the window's seconds."""

from ecbench import program


def read(ctx):
    secs = ctx.delta(program.stage_seconds("encode_read_wait"))
    return None if secs is None else 100.0 * secs / ctx.window_s
