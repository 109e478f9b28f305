"""weed mount: FUSE filesystem over the filer.

Reference: weed/filesys/ — `WFS` root (wfs.go:54-113), dirty-page
interval buffering with upload-on-flush (dirty_page.go,
dirty_page_interval.go), the meta cache with subscription invalidation
(meta_cache/), and file/dir node ops (file.go, dir.go).

The kernel-independent core is `WFS` in vfs.py (fully testable without
/dev/fuse); fuse_ll.py binds it to libfuse via ctypes.
"""

from .dirty_pages import ContinuousIntervals  # noqa: F401
from .meta_cache import MetaCache  # noqa: F401
from .vfs import WFS, FileHandle, FuseError  # noqa: F401
