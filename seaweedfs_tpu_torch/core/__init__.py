"""On-disk formats: needle records, indexes, superblocks, CRC, TTL."""
