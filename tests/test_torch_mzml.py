"""mzML in exon_tpu_torch against exon_tpu, and the mass-spec UDFs (K11b).

(a) A seeded mzML written here: float32 and float64 arrays, zlib and
uncompressed binaries, an empty spectrum, a spectrum without arrays, a
wavelength array, precursors with and without a charge, cvParams; the
decoder of both packages in every projection and batch size, ``read_mzml``,
``mzml_scan`` and ``STORED AS MZML`` through both sessions (Arrow tables
equal), COUNT(*) on the decoder's fast path. (b) contains_peak and
bin_vectors in SQL over this file and a second one, and the list_bins twins
against the JAX functions on seeded lists. Tolerance: exact, except bin_vectors' float64 sums, relative 1e-12 (the
order of the additions). (c) F30: an m/z of NaN, both answers.
"""

import base64
import struct
import zlib

import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
from exon_tpu import udfs as judfs
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.formats import mzml as jmzml
from exon_tpu_torch.formats import mzml as tmzml
from exon_tpu_torch.kernels import list_bins as klb

BATCH = 7
BINS_RTOL = 1e-12


def _array(values: np.ndarray, f64: bool, z: bool, acc: str,
           name: str) -> str:
    raw = struct.pack(f"<{len(values)}{'d' if f64 else 'f'}", *values)
    text = base64.b64encode(zlib.compress(raw) if z else raw).decode()
    cvs = [("MS:1000523" if f64 else "MS:1000521",
            "64-bit float" if f64 else "32-bit float")]
    if z:
        cvs.append(("MS:1000574", "zlib compression"))
    cvs.append((acc, name))
    params = "".join(f'<cvParam cvRef="MS" accession="{a}" name="{n}" '
                     'value=""/>' for a, n in cvs)
    return (f'<binaryDataArray encodedLength="{len(text)}">{params}'
            f"<binary>{text}</binary></binaryDataArray>")


def _mzml_text(n=40, seed=5) -> bytes:
    rng = np.random.default_rng(seed)
    out = ['<?xml version="1.0" encoding="utf-8"?>\n'
           '<mzML xmlns="http://psi.hupo.org/ms/mzml" version="1.1.0">'
           f'<run id="t"><spectrumList count="{n}">']
    for i in range(n):
        k = 0 if i % 9 == 4 else int(rng.integers(1, 40))
        mz = np.sort(rng.uniform(100, 2000, k))
        inten = rng.uniform(0, 1e5, k)
        f64, z = i % 2 == 0, i % 3 != 0
        body = [f'<cvParam cvRef="MS" accession="MS:1000511" name="ms level" '
                f'value="{1 + i % 2}"/>']
        if i % 4 == 1:
            ions = (f'<cvParam cvRef="MS" accession="MS:1000744" name='
                    f'"selected ion m/z" value="{400 + i * 1.25}"/>')
            if i % 8 == 1:
                ions += ('<cvParam cvRef="MS" accession="MS:1000041" '
                         f'name="charge state" value="{2 + i % 3}"/>')
            body.append('<precursorList count="1"><precursor>'
                        '<selectedIonList count="1"><selectedIon>'
                        f"{ions}</selectedIon></selectedIonList></precursor>"
                        "</precursorList>")
        if i % 11 != 10:  # one spectrum in eleven holds no arrays
            arrays = [_array(mz, f64, z, "MS:1000514", "m/z array"),
                      _array(inten, not f64, z, "MS:1000515",
                             "intensity array")]
            if i % 5 == 0:
                arrays.append(_array(rng.uniform(200, 800, k), f64, not z,
                                     "MS:1000617", "wavelength array"))
            body.append(f'<binaryDataArrayList count="{len(arrays)}">'
                        + "".join(arrays) + "</binaryDataArrayList>")
        out.append(f'<spectrum index="{i}" id="scan={i}" '
                   f'defaultArrayLength="{k}">' + "".join(body)
                   + "</spectrum>")
    out.append("</spectrumList></run></mzML>\n")
    return "\n".join(out).encode()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mzml")
    out = {}
    for name, text in (("s", _mzml_text()), ("more", _mzml_text(90, 11))):
        (d / f"{name}.mzML").write_bytes(text)
        out[name] = str(d / f"{name}.mzML")
    return out


@pytest.fixture(scope="module")
def sessions(files):
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    for s in (ts, js):
        s.sql(f"CREATE EXTERNAL TABLE spectra STORED AS MZML LOCATION "
              f"'{files['s']}'")
    return ts, js


def assert_same(got: pa.Table, want: pa.Table, bins=()):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if name in bins:
            assert [x is None for x in g] == [x is None for x in w]
            for a, b in zip(g, w):
                if a is not None:
                    np.testing.assert_allclose(a, b, rtol=BINS_RTOL, atol=0)
        else:
            assert g == w, name


# ---------------------------------------------------------------------------
# (a) decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("projection", [
    None, ["id", "mz"], ["intensity", "wavelength"], ["cv_params"],
    ["precursor_mz", "precursor_charge", "id"]],
    ids=["all", "mz", "intensity", "cv", "precursor"])
@pytest.mark.parametrize("batch", [1, 6, 1000])
def test_mzml_decode_matches_jax(projection, batch):
    data = _mzml_text()
    got = list(tmzml.decode_host(data, tmzml.MzmlOptions(batch_size=batch),
                                 projection))
    want = list(jmzml.decode_host(data, jmzml.MzmlOptions(batch_size=batch),
                                  projection))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.length == int(w.length)
        assert g.to_arrow().equals(w.to_arrow())


def test_mzml_count_fast_path_matches_jax():
    data = _mzml_text()
    got = sum(b.length for b in tmzml.decode_host(
        data, tmzml.MzmlOptions(batch_size=BATCH), []))
    want = sum(int(b.length) for b in jmzml.decode_host(
        data, jmzml.MzmlOptions(batch_size=BATCH), []))
    assert got == want == 40


@pytest.mark.parametrize("sql", [
    "SELECT * FROM spectra",
    "SELECT id, mz.mz AS m, intensity['intensity'] AS i FROM spectra",
    "SELECT COUNT(*) AS n FROM spectra",
    "SELECT id, precursor_mz FROM spectra WHERE precursor_charge IS NULL "
    "AND precursor_mz IS NOT NULL",
    "SELECT id, cv_params FROM spectra ORDER BY id DESC LIMIT 5",
    "SELECT id, array_length(mz.mz) AS n, array_element(intensity.intensity,"
    " 1) AS first FROM spectra",
], ids=["star", "fields", "count", "precursor", "topk", "lengths"])
def test_mzml_sql_matches_jax(sessions, sql):
    ts, js = sessions
    assert_same(ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow())


def test_read_mzml_and_scan_match_jax(files, sessions):
    ts, js = sessions
    got = ts.read_mzml(files["s"]).select("id", "mz").collect_arrow()
    assert_same(got, js.read_mzml(files["s"]).select("id", "mz")
                .collect_arrow())
    sql = f"SELECT id, wavelength FROM mzml_scan('{files['s']}')"
    assert_same(ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow())
    assert got.num_rows == 40


# ---------------------------------------------------------------------------
# (b) the mass-spec UDFs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", ["s", "more"])
@pytest.mark.parametrize("sql", [
    "SELECT id, contains_peak(mz.mz, 500.0, 30.0) AS hit FROM {t}",
    "SELECT id FROM {t} WHERE contains_peak(mz.mz, 126.127726, 5) ORDER BY "
    "id",
    "SELECT id, bin_vectors(mz.mz, intensity.intensity, 100.0, 1900, 1.0) "
    "AS bins FROM {t}",
    "SELECT id, bin_vectors(mz.mz, intensity.intensity, 500, 7, 100) AS "
    "bins FROM {t} WHERE contains_peak(mz.mz, 900.0, 50.0)",
], ids=["peak", "peak_filter", "bins", "bins_filtered"])
def test_mass_spec_udfs_match_jax(files, sessions, table, sql):
    ts, js = sessions
    sql = sql.format(t=f"mzml_scan('{files[table]}')")
    assert_same(ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow(),
                bins=("bins",))


def _lists(rng, n):
    lens = rng.integers(0, 50, n)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    mz = rng.uniform(80, 2100, int(offs[-1]))
    mz[rng.random(len(mz)) < 0.01] = 1e300
    return offs, mz, rng.uniform(0, 1e6, len(mz)), rng.random(n) > 0.1


@pytest.mark.parametrize("seed", range(4))
def test_list_bins_twins_match_jax(seed):
    """The twins of list_bins against exon_tpu/udfs.py contains_peak and
    bin_vectors on seeded lists (empty and NULL rows, m/z past the int32
    range of the JAX cast)."""
    import jax.numpy as jnp

    offs, mz, inten, valid = _lists(np.random.default_rng(seed), 300)
    jmz = JVar(jnp.asarray(mz), jnp.asarray(offs), jnp.asarray(valid))
    jin = JVar(jnp.asarray(inten), jnp.asarray(offs), jnp.asarray(valid))
    to = (torch.from_numpy(offs), torch.from_numpy(mz),
          torch.from_numpy(inten), torch.from_numpy(valid))
    for peak, tol in ((500.0, 1.0), (126.1, 0.0), (3000.0, 5.0)):
        assert np.array_equal(
            klb.list_bins_peak_plain(to[0], to[1], to[3], peak, tol).numpy(),
            np.asarray(judfs.contains_peak(None, jmz, peak, tol)))
    for lo, nb, w in ((100.0, 1900, 1.0), (0.0, 3, 700.0), (90.5, 40, 13.7)):
        want = np.asarray(judfs.bin_vectors(None, jmz, jin, lo, nb, w).values)
        got = klb.list_bins_bins_plain(to[0], to[1], to[2], lo, w, nb)
        np.testing.assert_allclose(got.numpy(), want[:got.shape[0]],
                                   rtol=BINS_RTOL, atol=0)


def test_list_bins_reject_mismatched_lists():
    """bin_vectors reads intensity at m/z's flat positions: lists of
    another element count raise instead of reading past the end."""
    offs = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="intensity"):
        klb.list_bins_bins(offs, torch.ones(2, dtype=torch.float64),
                           torch.ones(3, dtype=torch.float64), 0.0, 1.0, 4)


def test_f30_nan_mz_is_dropped():
    """F30: an m/z of NaN. The JAX bin_vectors casts floor((mz - min) /
    width) to int32 before its range test, and XLA casts NaN to 0, so the
    intensity lands in bin 0; the port decides the bin in float64 and drops
    it, as it drops any m/z outside the bins (huge ones agree: the JAX cast
    saturates)."""
    import jax.numpy as jnp

    mz = np.array([np.nan, 1e300, 150.5, 99.5], np.float64)
    inten = np.array([1.0, 2.0, 4.0, 8.0])
    offs = np.array([0, 4], np.int32)
    want = np.asarray(judfs.bin_vectors(
        None, JVar(jnp.asarray(mz), jnp.asarray(offs), jnp.ones(1, bool)),
        JVar(jnp.asarray(inten), jnp.asarray(offs), jnp.ones(1, bool)),
        100.0, 1900, 1.0).values)[:1900]
    got = klb.list_bins_bins_plain(torch.from_numpy(offs),
                                   torch.from_numpy(mz),
                                   torch.from_numpy(inten), 100.0, 1.0,
                                   1900).numpy()
    assert {k: v for k, v in enumerate(want) if v} == {0: 1.0, 50: 4.0}
    assert {k: v for k, v in enumerate(got) if v} == {50: 4.0}
