"""A GENCODE-v44-shaped GFF3 of chromosome 1, with its generating arrays.

GENCODE's comprehensive annotation (gencode.v44.annotation.gff3) holds
about 3.4 M features; chromosome 1 is about a tenth of them. This fixture
writes ``n`` features of chr1 in GENCODE's hierarchy: a gene, its
transcripts, each transcript's exons, and for a protein-coding transcript
a CDS row per coding exon and its five_prime_UTR and three_prime_UTR rows.
Each row carries the attribute keys GENCODE writes for its type (``ID``,
``Parent``, ``gene_id``, ``gene_type``, ``gene_name``, ``level``, the
``transcript_*`` keys, ``exon_number``/``exon_id``, ``protein_id``) and,
on most transcripts and their children, a multi-valued ``tag``. Gene types
follow GENCODE v44's counts (protein_coding and lncRNA about a third each,
then the pseudogenes and the small RNAs); levels 1, 2 and 3 about 5 %,
85 % and 10 %. The last gene is cut where the count reaches ``n``.

``gencode_features(n, seed)`` replays the generator's arrays (per row: the
type, the gene type and the level, as codes into ``FEATURE_TYPES``,
``GENE_TYPES`` and ``LEVELS``), so a query's answer can be computed with
numpy without reading the file.
"""

from __future__ import annotations

import os

import numpy as np

FEATURES = 340_000   # chr1's ~10 % of GENCODE v44's 3.4 M features
FEATURE_TYPES = ("gene", "transcript", "exon", "CDS", "five_prime_UTR",
                 "three_prime_UTR")
# GENCODE v44 gene counts by gene_type (the largest classes)
GENE_TYPES = ("protein_coding", "lncRNA", "processed_pseudogene",
              "unprocessed_pseudogene", "misc_RNA", "snRNA", "miRNA", "TEC",
              "transcribed_unprocessed_pseudogene", "snoRNA",
              "transcribed_processed_pseudogene", "rRNA_pseudogene",
              "IG_V_pseudogene", "transcribed_unitary_pseudogene",
              "IG_V_gene", "TR_V_gene", "unitary_pseudogene", "TR_J_gene",
              "rRNA", "scaRNA")
_GENE_COUNTS = np.array([20046, 19928, 10146, 2614, 2212, 1901, 1879, 1056,
                         958, 943, 517, 497, 187, 160, 145, 106, 99, 79, 53,
                         49], np.float64)
LEVELS = ("1", "2", "3")
_LEVEL_P = np.array([0.05, 0.85, 0.10])
_TAGS = ("basic", "Ensembl_canonical", "CCDS", "MANE_Select", "appris_principal_1",
         "GENCODE_Primary", "mRNA_start_NF", "cds_end_NF")
CHR1_LENGTH = 248_956_422


def _plan(n: int, seed: int) -> list:
    """The generator's draws: per gene (type code, level code, gene start,
    transcripts [(exon count, coding, tag bits)])."""
    rng = np.random.default_rng(seed)
    p = _GENE_COUNTS / _GENE_COUNTS.sum()
    genes, rows = [], 0
    while rows < n:
        gt = int(rng.choice(len(GENE_TYPES), p=p))
        level = int(rng.choice(3, p=_LEVEL_P))
        coding_gene = gt == 0
        small = gt in (4, 5, 6, 9, 18, 19)
        n_tx = 1 if small or "pseudogene" in GENE_TYPES[gt] else \
            1 + int(rng.poisson(7 if coding_gene else 2))
        txs = []
        rows += 1
        for _ in range(n_tx):
            n_ex = 1 if small else 1 + int(rng.poisson(8 if coding_gene
                                                       else 2))
            coding = coding_gene and rng.random() < 0.6
            tags = int(rng.integers(0, 1 << len(_TAGS)))
            txs.append((n_ex, coding, tags))
            rows += 1 + n_ex + (n_ex + 2 if coding else 0)
        start = int(rng.integers(10_000, CHR1_LENGTH - 3_000_000))
        genes.append((gt, level, start, txs))
    return sorted(genes, key=lambda g: g[2])  # by position, as GENCODE


def _rows(n: int, seed: int):
    """(type, gene type, level, start, end, strand, attributes) per row."""
    out = []
    for g, (gt, level, start, txs) in enumerate(_plan(n, seed)):
        gid = f"ENSG{g:011d}.{1 + g % 9}"
        gname = f"GENE{g}"
        gtype = GENE_TYPES[gt]
        lvl = LEVELS[level]
        strand = "+-"[g % 2]
        span = 1000 + 997 * sum(t[0] for t in txs)
        common = f"gene_id={gid};gene_type={gtype};gene_name={gname}"
        out.append((0, gt, level, start, start + span, strand,
                    f"ID={gid};{common};level={lvl}"))
        for t, (n_ex, coding, tags) in enumerate(txs):
            tid = f"ENST{g:08d}{t:03d}.1"
            ttype = "protein_coding" if coding else (
                "retained_intron" if gt == 0 else gtype)
            tag = ",".join(x for k, x in enumerate(_TAGS) if tags >> k & 1)
            tx_attr = (f"{common};transcript_id={tid};transcript_type={ttype};"
                       f"transcript_name={gname}-{201 + t};level={lvl}")
            tail = f";tag={tag}" if tag else ""
            out.append((1, gt, level, start, start + span, strand,
                        f"ID={tid};Parent={gid};{tx_attr}"
                        f";transcript_support_level={1 + t % 5}{tail}"))
            for e in range(n_ex):
                es = start + 997 * e
                ee = es + 600
                ex_attr = (f"{tx_attr};exon_number={e + 1};"
                           f"exon_id=ENSE{g:08d}{t:03d}{e:03d}.1{tail}")
                out.append((2, gt, level, es, ee, strand,
                            f"ID=exon:{tid}:{e + 1};Parent={tid};{ex_attr}"))
                if coding:
                    out.append((3, gt, level, es + 50, ee - 50, strand,
                                f"ID=CDS:{tid};Parent={tid};{ex_attr};"
                                f"protein_id=ENSP{g:08d}{t:03d}.1"))
            if coding:
                for k in (4, 5):
                    us = start if k == 4 else start + 997 * (n_ex - 1) + 550
                    out.append((k, gt, level, us, us + 49, strand,
                                f"ID=UTR{k - 3}:{tid};Parent={tid};{tx_attr}"
                                f"{tail}"))
    return out[:n]


def gencode_features(n: int = FEATURES, seed: int = 44) -> dict:
    """The fixture's per-row codes: ``type``, ``gene_type``, ``level``."""
    rows = _rows(n, seed)
    return {"type": np.asarray([r[0] for r in rows], np.int8),
            "gene_type": np.asarray([r[1] for r in rows], np.int8),
            "level": np.asarray([r[2] for r in rows], np.int8)}


def make_gencode_gff(n: int = FEATURES, seed: int = 44,
                     path: str | None = None) -> str:
    """Write the fixture (once) and return its path."""
    if path is None:
        cache = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_cache")
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"gencode_chr1_{n}_{seed}.gff3")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    with open(path + ".tmp", "w") as out:
        out.write("##gff-version 3\n##sequence-region chr1 1 248956422\n")
        out.writelines(
            f"chr1\t{'HAVANA' if lvl < 2 else 'ENSEMBL'}\t{FEATURE_TYPES[t]}"
            f"\t{s}\t{e}\t.\t{strand}\t{'0' if t == 3 else '.'}\t{attr}\n"
            for t, _gt, lvl, s, e, strand, attr in _rows(n, seed))
    os.replace(path + ".tmp", path)
    return path
