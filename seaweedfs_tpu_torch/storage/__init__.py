"""Volume engine: append-only blob storage with O(1) reads."""
