"""Batched multi-volume erasure coding: a (vol, col) grid of devices
(`mesh.py`), the batched K1/K2 steps (`sharded_codec.py`), the three-stage
stream pipeline (`stream_pipeline.py`), and the local halves of the
cluster encode and rebuild (`cluster_encode.py`, `cluster_rebuild.py`)."""
