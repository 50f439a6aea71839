"""Distributed execution: the mesh of shards, the hash-partition shuffle
and the distributed operators (exon_tpu/parallel/)."""
