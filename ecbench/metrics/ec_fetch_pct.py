"""ec_fetch_pct.<mix>: the share of the window in which the main thread
brings parity and CRC partials to the host (the wait for the kernel
and the copy): the seconds of the EC file pipeline's `encode_fetch`
stage in the window, from the program's stage counters, over the
window's seconds."""

from ecbench import program


def read(ctx):
    secs = ctx.delta(program.stage_seconds("encode_fetch"))
    return None if secs is None else 100.0 * secs / ctx.window_s
