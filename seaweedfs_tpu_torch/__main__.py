"""`python -m seaweedfs_tpu_torch <command>` — the port's `weed` binary
(reference: weed/weed.go:38-80).  It has `master`, `volume`,
`server`, `shell`, `upload`, `download`, `backup`, `fix`, `compact`,
`export`, `benchmark` and `version`."""

import sys

from .command import main

if __name__ == "__main__":
    sys.exit(main())
