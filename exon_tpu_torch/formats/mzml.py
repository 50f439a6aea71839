"""mzML (mass-spec XML) decoder.

Copy of exon_tpu/formats/mzml.py (host decode). A List<Float64> peak array
is a ListColumn over a FixedColumn (the JAX package keeps it as a
VarColumn of float64 values, :136-143).

Parity: exon-mzml (array_builder.rs:45-110, mzml_reader/binary_conversion.rs
:21-80): schema ``id, mz{mz:List<f64>}, intensity{intensity:List<f64>},
wavelength{wavelength:List<f64>}, cv_params List<Struct{accession,name,
value}>, precursor_mz f64, precursor_charge i64``. Binary arrays are base64
(+optional zlib) little-endian f32/f64 selected by cvParam accession.

Parsing uses expat-backed ElementTree iterparse (C speed); peak decode is
numpy frombuffer.
"""

from __future__ import annotations

import base64
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .. import datatypes as dt
from ..batch import (Batch, FixedColumn, ListColumn, Schema, StructColumn,
                     utf8_column)
from .textutil import cumsum_exclusive

# cvParam accessions (PSI-MS controlled vocabulary)
ACC_F64 = "MS:1000523"
ACC_F32 = "MS:1000521"
ACC_ZLIB = "MS:1000574"
ACC_MZ = "MS:1000514"
ACC_INTENSITY = "MS:1000515"
ACC_WAVELENGTH = "MS:1000617"
ACC_SELECTED_MZ = "MS:1000744"
ACC_CHARGE = "MS:1000041"


@dataclass
class MzmlOptions:
    file_extension: str = ".mzML"
    batch_size: int = 8192
    projection: Optional[list[str]] = None


def _struct_list(name: str) -> dt.DataType:
    return dt.struct([dt.Field(name, dt.list_(dt.float64), True)])


CV_PARAM_T = dt.list_(dt.struct([
    dt.Field("accession", dt.utf8, True),
    dt.Field("name", dt.utf8, True),
    dt.Field("value", dt.utf8, True),
]))


def mzml_schema(options=None) -> Schema:
    return Schema.of(
        dt.Field("id", dt.utf8, nullable=False),
        dt.Field("mz", _struct_list("mz"), nullable=True),
        dt.Field("intensity", _struct_list("intensity"), nullable=True),
        dt.Field("wavelength", _struct_list("wavelength"), nullable=True),
        dt.Field("cv_params", CV_PARAM_T, nullable=True),
        dt.Field("precursor_mz", dt.float64, nullable=True),
        dt.Field("precursor_charge", dt.int64, nullable=True),
    )


def _decode_binary(b64_text: str, f64: bool, zlib_compressed: bool) -> np.ndarray:
    raw = base64.b64decode(b64_text)
    if zlib_compressed:
        raw = zlib.decompress(raw)
    return np.frombuffer(raw, dtype="<f8" if f64 else "<f4").astype(np.float64)


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_spectra(data: bytes, decode_peaks: bool = True) -> list[dict]:
    """Parse spectrum elements into dicts. ``decode_peaks=False`` skips the
    base64+zlib binary-array decode for projections that don't read
    mz/intensity/wavelength (COUNT(*) projects nothing) — roughly a third
    of decode time."""
    import io
    import xml.etree.ElementTree as ET

    out = []
    for _event, elem in ET.iterparse(io.BytesIO(data), events=("end",)):
        if _local(elem.tag) != "spectrum":
            continue
        spec = {"id": elem.get("id"), "cv": [], "mz": None, "intensity": None,
                "wavelength": None, "precursor_mz": None,
                "precursor_charge": None}
        for cv in elem.iter():
            if _local(cv.tag) != "cvParam":
                continue
            spec["cv"].append((cv.get("accession"), cv.get("name"),
                               cv.get("value")))
        # binary arrays
        for bda in (elem.iter() if decode_peaks else ()):
            if _local(bda.tag) != "binaryDataArray":
                continue
            accs = {cv.get("accession") for cv in bda.iter()
                    if _local(cv.tag) == "cvParam"}
            f64 = ACC_F64 in accs
            z = ACC_ZLIB in accs
            btext = None
            for b in bda.iter():
                if _local(b.tag) == "binary":
                    btext = b.text or ""
            if btext is None:
                continue
            arr = _decode_binary(btext, f64, z)
            if ACC_MZ in accs:
                spec["mz"] = arr
            elif ACC_INTENSITY in accs:
                spec["intensity"] = arr
            elif ACC_WAVELENGTH in accs:
                spec["wavelength"] = arr
        # precursor
        for si in elem.iter():
            if _local(si.tag) != "selectedIon":
                continue
            for cv in si:
                if _local(cv.tag) != "cvParam":
                    continue
                if cv.get("accession") == ACC_SELECTED_MZ:
                    spec["precursor_mz"] = float(cv.get("value"))
                elif cv.get("accession") == ACC_CHARGE:
                    spec["precursor_charge"] = int(cv.get("value"))
        out.append(spec)
        elem.clear()
    return out


def _f64_list_struct(field: str, values: list, n: int) -> StructColumn:
    lens = np.asarray([0 if v is None else len(v) for v in values], np.int64)
    offs = cumsum_exclusive(lens)
    flat = (np.concatenate([v for v in values if v is not None])
            if lens.sum() else np.zeros(0, np.float64))
    valid = np.asarray([v is not None for v in values], np.bool_)
    inner = ListColumn(FixedColumn(flat, np.ones(len(flat), np.bool_)),
                       offs.astype(np.int32), valid.copy())
    return StructColumn({field: inner}, valid)


def decode_host(data: bytes, options: MzmlOptions,
                projection: Optional[list[str]] = None) -> Iterator[Batch]:
    schema = mzml_schema(options)
    proj = projection if projection is not None else schema.names
    out_schema = schema.project(proj)
    if projection is not None and len(projection) == 0:
        # COUNT(*): spectrum-element count via memmem over the raw bytes
        # (one C-speed pass; the XML never parses). Only taken when the
        # byte count provably matches parse_spectra's local-name match:
        # no namespace-prefixed spectrum tags, no comments/CDATA that
        # could hide or fake the literal bytes.
        buf = bytes(data) if not isinstance(data, bytes) else data
        if (b":spectrum" not in buf and b"<!--" not in buf
                and b"<![CDATA[" not in buf):
            n = (buf.count(b"<spectrum ") + buf.count(b"<spectrum>")
                 + buf.count(b"<spectrum/"))
            bs = options.batch_size
            for lo in range(0, n, bs):
                yield Batch(out_schema, [], min(bs, n - lo))
            return
    need_peaks = any(c in proj for c in ("mz", "intensity", "wavelength"))
    spectra = parse_spectra(data, decode_peaks=need_peaks)
    n = len(spectra)
    if n == 0:
        return
    bs = options.batch_size
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        chunk = spectra[lo:hi]
        m = hi - lo
        cols = []
        for name in proj:
            if name == "id":
                cols.append(utf8_column([s["id"] for s in chunk]))
            elif name in ("mz", "intensity", "wavelength"):
                cols.append(_f64_list_struct(name, [s[name] for s in chunk], m))
            elif name == "cv_params":
                lens = np.asarray([len(s["cv"]) for s in chunk], np.int64)
                offs = cumsum_exclusive(lens)
                flat = [p for s in chunk for p in s["cv"]]
                kids = {
                    "accession": utf8_column([p[0] for p in flat]),
                    "name": utf8_column([p[1] for p in flat]),
                    "value": utf8_column([p[2] for p in flat]),
                }
                entry = StructColumn(kids, np.ones(len(flat), bool))
                cols.append(ListColumn(entry, offs.astype(np.int32),
                                       np.ones(m, bool)))
            elif name == "precursor_mz":
                vals = np.asarray([s["precursor_mz"] or 0.0 for s in chunk])
                valid = np.asarray([s["precursor_mz"] is not None for s in chunk])
                cols.append(FixedColumn(vals.astype(np.float64), valid))
            elif name == "precursor_charge":
                vals = np.asarray([s["precursor_charge"] or 0 for s in chunk],
                                  np.int64)
                valid = np.asarray([s["precursor_charge"] is not None
                                    for s in chunk])
                cols.append(FixedColumn(vals, valid))
        yield Batch(out_schema, cols, m)
