"""ExonSession: the port's entry point.

Counterpart of exon_tpu/session.py: ``read_fasta``, ``read_fastq``,
``read_vcf``, ``read_gff``, ``read_bam`` and ``read_mzml`` (VCF through its own provider
with region pushdown, as ``_make_provider`` :121 gives it), the table registry (``register_table``,
``deregister_table``, ``table``, ``tables``; :95-105; an Arrow table
registered becomes a ``MemTable``) and ``sql`` (:213),
which runs the port's copy of the SQL frontend. Creating a session
registers the UDFs of the port's udfs.py and the SQL functions of its
ops/sqlfuncs.py. The session names the
torch device every operator runs on: ``"cuda"`` by default, which raises
when there is no card; CPU execution (the kernels' plain twins) must be
asked for with ``device="cpu"``. Its ``config`` (config.py,
``new_exon_config``) turns distributed execution on; a session in a
multi-process run (the ``EXON_TPU_*`` variables of parallel/mesh.py) starts
the process group and, without a config of its own, distributes
(exon_tpu/session.py:60-71). The other formats and object stores are not
ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import SessionConfig, new_exon_config
from .dataframe import DataFrame
from .errors import PlanError
from .plan import logical as L
from .tables import MemTable, get_format, make_provider


class ExonSession:
    def __init__(self, device="cuda", device_batch_size: Optional[int] = None,
                 config: Optional[SessionConfig] = None):
        from .parallel.mesh import init_distributed

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExonSession(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self.device = device
        multi = init_distributed(device=device)
        self.config = config or new_exon_config()
        if multi and config is None:
            self.config.distributed = True
        if device_batch_size is not None:
            self.config = dataclasses.replace(
                self.config, device_batch_size=device_batch_size)
        self.tables: dict[str, object] = {}
        # register the UDFs and the SQL functions (exon_tpu/session.py:73-74)
        from . import udfs  # noqa: F401
        from .ops import sqlfuncs  # noqa: F401

    @property
    def device_batch_size(self) -> int:
        return self.config.device_batch_size

    @staticmethod
    def new_exon(device="cuda") -> "ExonSession":
        return ExonSession(device)

    @staticmethod
    def with_config_exon(config: SessionConfig,
                         device="cuda") -> "ExonSession":
        return ExonSession(device, config=config)

    # -- registration -------------------------------------------------------

    def register_table(self, name: str, provider) -> None:
        """``provider`` is a table provider, or an Arrow table, which is
        held as a ``MemTable`` of host batches (pyarrow is imported only
        here, for that conversion)."""
        if not hasattr(provider, "scan") and hasattr(provider, "to_batches"):
            provider = MemTable.from_arrow(provider)
        self.tables[name.lower()] = provider

    def deregister_table(self, name: str) -> None:
        self.tables.pop(name.lower(), None)

    def table(self, name: str) -> DataFrame:
        provider = self.tables.get(name.lower())
        if provider is None:
            raise PlanError(f"table {name!r} not found")
        return DataFrame(self, L.Scan(provider, name))

    # -- reads --------------------------------------------------------------

    def _read(self, fmt_name: str, url: str, options=None, **kwargs) -> DataFrame:
        spec = get_format(fmt_name)
        options = options or spec.default_options()
        kwargs = {**self.config.scan_flags(fmt_name), **kwargs}
        options = dataclasses.replace(options, **kwargs,
                                      batch_size=self.device_batch_size)
        provider = make_provider(url, spec, options)
        return DataFrame(self, L.Scan(provider, f"{fmt_name.lower()}:{url}"))

    def read_fasta(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("FASTA", url, options, **kw)

    def read_fastq(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("FASTQ", url, options, **kw)

    def read_vcf(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("VCF", url, options, **kw)

    def read_gff(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("GFF", url, options, **kw)

    def read_bam(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("BAM", url, options, **kw)

    def read_mzml(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("MZML", url, options, **kw)

    # -- SQL ----------------------------------------------------------------

    def sql(self, query: str) -> DataFrame:
        from .sql.frontend import execute_sql

        return execute_sql(self, query)
