"""Session configuration: a copy of exon_tpu/config.py (reference:
exon-core/src/config/mod.rs:24-78).

``SessionConfig`` carries the engine settings the port reads:
``device_batch_size`` (rows per batch on the scan path), ``distributed``
and ``n_shards`` (aggregates and TopK over a mesh of shards,
parallel/distributed.py), and ``partitioned_join``, read only to refuse it
(the partitioned join is not ported yet). ``EXON_TPU_DISTRIBUTED`` in the
environment turns ``distributed`` on. ``set_option`` takes the
``exon.``-prefixed flags and ``n_shards`` as the JAX package's does (SQL
``SET`` is not ported yet, ROADMAP Queue 1, item 14). The JAX package's
parse flags for VCF, SAM, BAM and CRAM are ``read_*`` options in the port,
and its output ``batch_size`` and ``target_partitions`` have no reader
here, so they are not copied.

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
    device_batch_size: int = DEVICE_BATCH_SIZE
    distributed: bool = False
    n_shards: int = 0
    partitioned_join: bool = False

    def __post_init__(self):
        if os.environ.get("EXON_TPU_DISTRIBUTED"):
            self.distributed = True

    _EXON_FLAGS = ("distributed", "partitioned_join")

    def set_option(self, key: str, value: str) -> None:
        if key.startswith("exon."):
            flag = key[len("exon."):]
            if flag not in self._EXON_FLAGS:
                raise KeyError(f"unknown exon option {key}")
            setattr(self, flag, str(value).lower() in ("true", "1", "yes"))
        elif key in ("n_shards", "device_batch_size"):
            setattr(self, key, int(value))
        else:
            raise KeyError(f"unknown option {key}")


def new_exon_config(**kwargs) -> SessionConfig:
    return SessionConfig(**kwargs)
