"""setup_s: seconds from the process's start to the window's opening
(imports, CUDA, the kernels' build on a checkout's first run, the
inputs, the warm pass), by the host clock."""


def read(ctx):
    return ctx.setup_s
