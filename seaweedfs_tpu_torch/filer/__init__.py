"""Filer: the path -> entry metadata layer over the blob store.

Reference: weed/filer/ — `Filer` (filer.go:30), the `FilerStore` plugin
interface (filerstore.go:20), the Entry+chunks file model (entry.go:32,
filechunks.go), streaming reads (stream.go), async chunk deletion
(filer_deletion.go), and the metadata event log (filer_notify.go).
"""

from .entry import Attributes, Entry, FileChunk  # noqa: F401
from .filechunks import (ChunkView, VisibleInterval,  # noqa: F401
                         compact_file_chunks, etag, non_overlapping_visible_intervals,
                         read_chunk_views, total_size)
from .filer import Filer, FilerError, MetaEvent  # noqa: F401
from .filerstore import (FilerStore, MemoryStore,  # noqa: F401
                         SqliteStore, store_for_path)
from .meta_aggregator import MetaAggregator  # noqa: F401
from .meta_log import MetaLog  # noqa: F401
