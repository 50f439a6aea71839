"""Session configuration: a copy of exon_tpu/config.py (reference:
exon-core/src/config/mod.rs:24-78).

``SessionConfig`` carries the engine settings: ``device_batch_size`` (rows
per batch on the scan path), ``distributed`` and ``n_shards`` (aggregates,
TopK and full sorts, joins and PARTITION BY windows over a mesh of shards,
parallel/distributed.py), and ``partitioned_join``, which puts a join on
the partitioned exchange (both sides hashed to their key's owner) instead
of the broadcast of its build side. ``EXON_TPU_DISTRIBUTED`` in the
environment turns ``distributed`` on. ``set_option`` takes every key the
JAX package's does (the ``exon.``-prefixed flags, ``batch_size``,
``target_partitions`` and ``n_shards``) and ``device_batch_size``; SQL
``SET <key> = <value>`` goes through it. The parse flags
(``vcf_parse_info``, ``vcf_parse_formats``, ``bam_parse_tags``) turn the
matching ``read_vcf``/``read_bam`` option on for the session's later scans
(the options can also be given per read); ``sam_parse_tags`` and
``cram_parse_tags`` are kept for formats the port does not read, and
``batch_size`` and ``target_partitions`` have no reader in the port.

Unlike the JAX package, ``n_shards`` counts the shards of each process (a
shard is logical: several may share a card); 0 means one shard per card
the process uses, one on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

DEVICE_BATCH_SIZE = 1 << 17  # exon_tpu/config.py:20


@dataclasses.dataclass
class SessionConfig:
    batch_size: int = 8192
    device_batch_size: int = DEVICE_BATCH_SIZE
    target_partitions: int = 0
    vcf_parse_info: bool = False
    vcf_parse_formats: bool = False
    sam_parse_tags: bool = False
    bam_parse_tags: bool = False
    cram_parse_tags: bool = False
    distributed: bool = False
    n_shards: int = 0
    partitioned_join: bool = False

    def __post_init__(self):
        if self.target_partitions <= 0:
            self.target_partitions = os.cpu_count() or 1
        if os.environ.get("EXON_TPU_DISTRIBUTED"):
            self.distributed = True

    _EXON_FLAGS = ("vcf_parse_info", "vcf_parse_formats", "sam_parse_tags",
                   "bam_parse_tags", "cram_parse_tags", "distributed",
                   "partitioned_join")

    def set_option(self, key: str, value: str) -> None:
        if key.startswith("exon."):
            flag = key[len("exon."):]
            if flag not in self._EXON_FLAGS:
                raise KeyError(f"unknown exon option {key}")
            setattr(self, flag, str(value).lower() in ("true", "1", "yes"))
        elif key in ("batch_size", "target_partitions", "n_shards",
                     "device_batch_size"):
            setattr(self, key, int(value))
        else:
            raise KeyError(f"unknown option {key}")

    def scan_flags(self, fmt_name: str) -> dict:
        """The read options this config turns on for a format's scans."""
        flags = {"VCF": (("parse_info", self.vcf_parse_info),
                         ("parse_formats", self.vcf_parse_formats)),
                 "BAM": (("parse_tags", self.bam_parse_tags),)}
        return {k: True for k, on in flags.get(fmt_name, ()) if on}


def new_exon_config(**kwargs) -> SessionConfig:
    return SessionConfig(**kwargs)
