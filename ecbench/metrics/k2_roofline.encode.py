"""k2_roofline.encode: K2's share of its roofline in the file encode:
the least time the card could take for the K2 work of the window's
encodes, each run to its end (ecbench.roofline: data rows in, parity
rows out, CRC fused, over the columns of the shards the harness made),
over the device time of every K2 kernel of those encodes in the trace."""

from ecbench import program, roofline


def read(ctx):
    if ctx.trace is None:
        return None
    secs = sum(float(e["dur"]) for e in ctx.trace.kernels(
        program.K2_KERNEL, whole_passes=True)) / 1e6
    cols = ctx.work.get("k2_columns")
    if not secs or not cols:
        return None
    cfg = ctx.cell.config
    bound, _ = roofline.bound_seconds(cfg["parity_shards"],
                                      cfg["data_shards"], cols, crc=True)
    return 100.0 * bound / secs
