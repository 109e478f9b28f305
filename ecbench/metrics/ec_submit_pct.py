"""ec_submit_pct.<mix>: the share of the window in which the main thread
is in the coder's encode call (the pageable upload and the launch):
the seconds of the EC file pipeline's `encode_submit` stage in the
window, from the program's stage counters, over the window's seconds."""

from ecbench import program


def read(ctx):
    secs = ctx.delta(program.stage_seconds("encode_submit"))
    return None if secs is None else 100.0 * secs / ctx.window_s
