"""What every driver of a program entry shares: the volume's files in
memory, the count of passes, and the retiring of a pass's outputs.

A driver runs passes of one entry of the program over its cell's
volumes, back to back, for the window.  The harness calls, in order:
`host_bytes` (the memory the cell needs), `setup`, then for each pass
`begin` and `run_pass` and, after it, `boundary`; `progress` once, at
the window's close, from another thread (`begin`, `boundary` and
`progress` hold the window's lock); after the window `work`, `judge`
and `close`.

When a pass's outputs are replaced, their files are retired: a thread
reads SAMPLE_BLOCKS seeded blocks of them, for the judge, and closes
them at once, so the next pass writes into memory the kernel has just
freed, as a server's page cache would give it, and the window never
holds more than one pass's outputs.  (Held until the window's close
instead, each pass took memory never touched before, and on a fresh
machine the rate climbed from run to run.)  The last pass's outputs
stay and are judged whole."""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from . import memfiles, volumes

# Blocks read from each retired pass's outputs, at seeded places: few,
# as the reads share the host with the next pass.
SAMPLE_BLOCKS = 4
MIB = 1 << 20


def volume_bytes(config: dict, i: int) -> int:
    """The `.dat` size limit of volume i: the size limit times its fill."""
    fills = config["fill"]
    return int(config["volume_size_limit_mb"] * MIB * fills[i % len(fills)])


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.device = cell.device
        self.ram = memfiles.RamFiles()
        self.started = 0      # passes begun
        self.completed = 0    # bytes of passes ended
        self.error: BaseException | None = None
        self.timings: dict[str, float] = {}  # set-up's parts, seconds
        # pass -> {(file key, block): bytes} read from retired outputs
        self.samples: dict[int, dict] = {}
        self._retired: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._retire_loop,
                                        daemon=True, name="ecbench-retire")
        self._thread.start()

    def work(self) -> dict:
        """What the window's passes, each run to its end, did as the
        inputs set it (the sizes the harness made), for the readers: no
        count of the program's."""
        return {}

    def retire(self, pass_no: int | None, files: dict, block: int,
               blocks: int) -> None:
        """Hand the retired files {key: fd} of a pass (None: not one of
        the window's), each due to hold `blocks` blocks, to the thread
        that samples and closes them."""
        self._retired.put((pass_no, files, block, blocks))

    def _retire_loop(self) -> None:
        while (item := self._retired.get()) is not None:
            pass_no, files, block, blocks = item
            try:
                if pass_no is not None:
                    rng = volumes.host_rng(self.cell.seed, 9, pass_no)
                    got = self.samples.setdefault(pass_no, {})
                    keys = sorted(files)
                    for _ in range(SAMPLE_BLOCKS):
                        key = keys[int(rng.integers(len(keys)))]
                        b = int(rng.integers(blocks))
                        got[(key, b)] = memfiles.read_at(files[key], block,
                                                         b * block)
            finally:
                for fd in files.values():
                    os.close(fd)

    def drain_retired(self) -> None:
        """Wait until every retired pass is sampled and closed."""
        if self._thread.is_alive():
            self._retired.put(None)
            self._thread.join()

    def close(self) -> None:
        self.drain_retired()
        self.ram.close()


def blocks_differ(got: np.ndarray, want: np.ndarray, block: int) -> int:
    """Blocks of `want` that `got` does not hold byte for byte (a byte
    `got` lacks differs)."""
    n = -(-len(want) // block)
    have = min(len(got), len(want))
    differ = np.ones(n * block, dtype=bool)
    differ[:have] = got[:have] != want[:have]
    differ[len(want):] = False
    return int(differ.reshape(n, block).any(axis=1).sum())
