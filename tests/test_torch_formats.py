"""The port's FASTA and GFF host decoders held to exon_tpu's on the same
bytes, compared through from_numpy_batch. Tolerance: exact."""

import dataclasses

import numpy as np
import pytest

from benchlib.gff_fixture import make_gff
from exon_tpu.formats import fasta as jfasta
from exon_tpu.formats import gff as jgff
from exon_tpu_torch import batch as tb
from exon_tpu_torch.formats import fasta as tfasta
from exon_tpu_torch.formats import gff as tgff

FASTA = (b">seq1 first sequence\nMKVL\nAC\n>seq2\nACGTACGT\n"
         b">seq3 third one\r\nMMMM\r\nKK\r\n>empty desc\n>seq5\nA\n")


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = tb.from_numpy_batch(w)
        assert g.schema == w.schema
        assert g.length == w.length
        for cg, cw in zip(g.columns, w.columns):
            assert type(cg) is type(cw)
            assert np.array_equal(cg.validity, cw.validity)
            if isinstance(cg, tb.VarColumn):
                assert np.array_equal(cg.offsets, cw.offsets)
                assert np.array_equal(cg.values, cw.values)
            elif isinstance(cg, tb.DictColumn):
                assert cg.vocab == cw.vocab
                assert np.array_equal(cg.codes, cw.codes)
            else:
                assert np.array_equal(cg.values, cw.values)


@pytest.mark.parametrize("projection", [None, ["id", "sequence"],
                                        ["description"]])
def test_fasta_decode_matches_jax(projection):
    opts = tfasta.FastaOptions(batch_size=2)
    got = list(tfasta.decode_host(FASTA, opts, projection))
    jopts = dataclasses.replace(jfasta.FastaOptions(batch_size=2),
                                projection=projection)
    want = list(jfasta.decoded_to_batches(jfasta.decode_buffer(FASTA, jopts),
                                          jopts))
    _same_batches(got, want)


GFF_COLUMNS = ["seqname", "source", "type", "start", "end", "score",
               "strand", "phase"]


@pytest.mark.parametrize("projection", [GFF_COLUMNS, ["seqname", "type",
                                                      "start", "end"]])
def test_gff_decode_matches_jax(tmp_path, projection):
    path = make_gff(3000, seed=5, path=str(tmp_path / "a.gff3"))
    data = open(path, "rb").read()
    # a score, a source of '.', and a comment line the decoder skips
    data += (b"#comment\nchr2\t.\tgene\t5\t90\t0.5\t-\t.\tID=x\n"
             b"chr2\tHAVANA\tCDS\t7\t9\t1e3\t+\t2\tID=y\n")
    got = list(tgff.decode_host(data, tgff.GffOptions(batch_size=1024),
                                projection))
    want = list(jgff.decode_host(data, jgff.GffOptions(batch_size=1024),
                                 projection))
    _same_batches(got, want)


def test_gff_attributes_not_ported(tmp_path):
    """Since item 2b + 3, attributes is a Map<Utf8, List<Utf8>> parsed as
    the JAX decoder parses it: several values, empty entries, an empty
    value, spaces, a key with no '=', batch boundaries."""
    data = (b"chr1\tx\tgene\t1\t2\t.\t+\t.\tID=a;Name=b,c\n"
            b"chr1\tx\tmRNA\t1\t2\t.\t+\t.\tID=a;;note=x y; empty=\n"
            b"chr2\tx\texon\t3\t9\t.\t-\t0\tID=e;.\n"
            b"chr2\tx\tCDS\t3\t9\t.\t-\t0\tParent=a,b,,c;tag=basic\n")
    for batch in (1, 3, 100):
        got = list(tgff.decode_host(data, tgff.GffOptions(batch_size=batch),
                                    None))
        want = list(jgff.decode_host(data, jgff.GffOptions(batch_size=batch),
                                     None))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.to_arrow().equals(w.to_arrow())


def test_f28_attributes_without_separator():
    """F28: a batch whose attribute fields hold no '=' (a '.' alone), or no
    byte at all, makes the JAX parser index an empty array (IndexError);
    the port gives the map {'.': ['']}, what the JAX parser gives for the
    same row in a batch with a separator elsewhere, and NULL maps for empty
    fields."""
    row = b"chr2\tx\texon\t3\t9\t.\t-\t0\t.\n"
    (got,) = tgff.decode_host(row, tgff.GffOptions(batch_size=1), None)
    assert got.to_arrow().column("attributes").to_pylist() == [[(".", [""])]]
    with pytest.raises(IndexError):
        list(jgff.decode_host(row, jgff.GffOptions(batch_size=1), None))
    (both,) = jgff.decode_host(b"chr2\tx\texon\t3\t9\t.\t-\t0\tID=a\n"
                               + row, jgff.GffOptions(batch_size=5), None)
    assert both.to_arrow().column("attributes").to_pylist()[1] == \
        [(".", [""])]
    # a batch of empty attribute fields: no entry at all (NULL maps)
    empty = b"chr2\tx\texon\t3\t9\t.\t-\t0\t\n" * 2
    (got,) = tgff.decode_host(empty, tgff.GffOptions(), None)
    assert got.to_arrow().column("attributes").to_pylist() == [None, None]
    with pytest.raises(IndexError):
        list(jgff.decode_host(empty, jgff.GffOptions(), None))


def test_arrow_round_trip_keeps_values_and_nulls():
    opts = tfasta.FastaOptions(batch_size=10)
    (batch,) = list(tfasta.decode_host(FASTA, opts, None))
    rb = batch.to_arrow()
    back = tb.Batch.from_arrow(rb, batch.schema)
    assert back.to_arrow().equals(rb)
    assert rb.column(1).null_count == 2  # headers without a description
    assert np.array_equal(back.column("sequence").values,
                          batch.column("sequence").values)
