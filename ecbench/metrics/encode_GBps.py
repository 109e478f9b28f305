"""encode_GBps: `.dat` bytes whose shards were written in the window
over the window's seconds, by the host clock; 1 GB = 1e9 bytes."""


def read(ctx):
    done = ctx.progress.get("encoded_bytes")
    return None if done is None else done / ctx.window_s / 1e9
