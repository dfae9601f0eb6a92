"""The port's real-corpus drop-in against the reference's.

``repro_torch.traces.io`` is a copy of ``repro.traces.io`` and
``RealCorpus`` / ``resolve_corpus_dir`` of ``repro.traces.corpus``'s:

* golden end to end — the checked-in fixtures (``tests/fixtures/
  msr_tiny.csv``, ``raw_tiny.raw``) ingest into a corpus directory with
  ``tests/test_real_corpus.py``'s frozen manifest, fingerprint
  ``708ae948`` and lengths, and the port's ``sweep_scheduled`` (on the
  CPU) gives its frozen hit ratios; the CLI prints the same fingerprint;
* round trip — the synthetic quick registry exported to npz volumes and
  re-ingested through ``RealCorpus`` is the synthetic suite bit for bit,
  and sweeps of both are equal;
* validation batteries — every malformed MSR row, raw record and corpus
  directory that the reference rejects, the port rejects with the same
  ``ValueError`` message; valid inputs ingest to the same blocks;
* ``tests/test_traces_io.py``'s cases, run against the port's ``io``.

The cases of ``tests/test_real_corpus.py`` that need
``benchmarks.corpus_figures`` or ``benchmarks.compare`` stay with the
reference (the port has no benchmark layer).
"""

import json
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.traces.io as rio
from repro.traces import RealCorpus as RefRealCorpus

import repro_torch.traces.io as pio
from repro_torch.cache import SimConfig, plan_sweep, sweep_scheduled
from repro_torch.core import MithrilConfig
from repro_torch.traces import (INGESTED, RealCorpus, build_corpus,
                                corpus_fingerprint, corpus_specs, family_of,
                                ingest, ingest_msr_csv, ingest_raw,
                                ingest_to_dir, ingest_to_npz, load_traces,
                                mixed, read_manifest, resolve_corpus_dir,
                                save_traces, stack_padded, workload_stats,
                                write_corpus_dir)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MSR = os.path.join(FIXTURES, "msr_tiny.csv")
RAW = os.path.join(FIXTURES, "raw_tiny.raw")

# tests/test_real_corpus.py's small mining tables and frozen goldens
MCFG = MithrilConfig(min_support=2, max_support=8, lookahead=40,
                     rec_buckets=512, rec_ways=4, mine_rows=8,
                     pf_buckets=512, pf_ways=4, prefetch_list=3)
GOLDEN_FP = "708ae948"
GOLDEN_LENGTHS = (66, 57)
GOLDEN_HR = {
    "lru": (0.363636, 0.0),
    "mithril-lru": (0.363636, 0.245614),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture_corpus")
    ingest_to_dir({"msr_tiny": MSR, "raw_tiny": RAW}, str(d))
    return str(d)


class TestGoldenEndToEnd:
    def test_manifest_and_fingerprint(self, fixture_corpus):
        man = read_manifest(fixture_corpus)
        assert man["version"] == 1
        assert man["fingerprint"] == GOLDEN_FP
        vols = man["volumes"]
        assert [v["name"] for v in vols] == ["msr_tiny", "raw_tiny"]
        assert tuple(v["requests"] for v in vols) == GOLDEN_LENGTHS
        assert all(v["family"] == INGESTED for v in vols)
        assert vols[0]["stats"]["unique_blocks"] == 30
        assert vols[1]["stats"]["unique_blocks"] == 21
        assert not vols[0]["stats"]["degenerate"]

    def test_manifest_equals_reference(self, fixture_corpus, tmp_path):
        rio.ingest_to_dir({"msr_tiny": MSR, "raw_tiny": RAW},
                          str(tmp_path))
        assert read_manifest(fixture_corpus) == \
            rio.read_manifest(str(tmp_path))
        for name in ("msr_tiny.npz", "raw_tiny.npz"):
            got = load_traces(os.path.join(fixture_corpus, name))
            want = rio.load_traces(str(tmp_path / name))
            assert list(got) == list(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])

    def test_frozen_hit_ratios(self, fixture_corpus):
        rc = RealCorpus(fixture_corpus)
        assert rc.fingerprint() == GOLDEN_FP
        names, blocks, lengths = rc.suite()
        assert names == ("msr_tiny", "raw_tiny")
        assert tuple(int(x) for x in lengths) == GOLDEN_LENGTHS
        plan = plan_sweep(lengths)
        grid = {"lru": SimConfig(capacity=8),
                "mithril-lru": SimConfig(capacity=8, use_mithril=True,
                                         mithril=MCFG)}
        for cname, cfg in grid.items():
            res = sweep_scheduled(cfg, blocks, lengths, plan=plan,
                                  device="cpu")
            got = tuple(round(float(h), 6) for h in res.hit_ratios())
            assert got == GOLDEN_HR[cname], cname

    def test_cli_ingest_matches_api(self, tmp_path, capsys):
        fp = pio.main([str(tmp_path / "c"), MSR, RAW])
        assert fp == GOLDEN_FP
        out = capsys.readouterr().out
        assert "2 volume(s)" in out and GOLDEN_FP in out
        fp2 = pio.main([str(tmp_path / "d"), MSR, RAW, "--family", "web",
                        "--no-rebase"])
        assert read_manifest(str(tmp_path / "d"))["volumes"][0]["family"] \
            == "web"
        assert fp2 == rio.main([str(tmp_path / "e"), MSR, RAW, "--family",
                                "web", "--no-rebase"])


class TestRoundTrip:
    TLEN = 300

    @pytest.fixture(scope="class")
    def exported(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("synthetic_export")
        traces = build_corpus(corpus_specs(self.TLEN, "quick"))
        fams = {n: family_of(n) for n in traces}
        write_corpus_dir(str(d), traces, fams)
        return str(d), traces, fams

    def test_suite_is_bit_identical(self, exported):
        d, traces, fams = exported
        rc = RealCorpus(d)
        assert len(rc) == len(traces)
        names_s, blocks_s, lengths_s = stack_padded(traces)
        names_r, blocks_r, lengths_r = rc.suite("full")
        assert tuple(names_r) == tuple(names_s)
        assert np.array_equal(lengths_r, lengths_s)
        assert np.array_equal(blocks_r, blocks_s)
        assert all(rc.family(n) == fams[n] for n in names_r)
        assert rc.fingerprint("full") == corpus_fingerprint(traces)

    def test_equals_reference_real_corpus(self, exported):
        d, _, _ = exported
        rc, ref = RealCorpus(d), RefRealCorpus(d)
        for scale in ("quick", "mid", "full"):
            assert rc.subset_names(scale) == ref.subset_names(scale)
            for cap in (None, 50):
                assert rc.fingerprint(scale, cap) == \
                    ref.fingerprint(scale, cap)
                for a, b in zip(rc.suite(scale, cap), ref.suite(scale, cap)):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))

    def test_nested_scales_subset_identically(self, exported):
        d, traces, _ = exported
        rc = RealCorpus(d)
        assert rc.subset_names("quick") == tuple(traces)
        assert rc.subset_names("mid") == tuple(traces)
        with pytest.raises(ValueError, match="scale"):
            rc.subset_names("huge")

    def test_sweeps_bit_identical(self, exported):
        d, traces, _ = exported
        _, blocks_s, lengths_s = stack_padded(traces)
        _, blocks_r, lengths_r = RealCorpus(d).suite("full")
        plan_s, plan_r = plan_sweep(lengths_s), plan_sweep(lengths_r)
        assert plan_s.packer_stats() == plan_r.packer_stats()
        cfg = SimConfig(capacity=64, use_mithril=True, mithril=MCFG)
        res_s = sweep_scheduled(cfg, blocks_s, lengths_s, plan=plan_s,
                                device="cpu")
        res_r = sweep_scheduled(cfg, blocks_r, lengths_r, plan=plan_r,
                                device="cpu")
        assert np.array_equal(res_s.hit_curve, res_r.hit_curve)
        assert np.array_equal(res_s.hit_ratios(), res_r.hit_ratios())

    def test_length_cap(self, exported):
        d, _, _ = exported
        rc = RealCorpus(d)
        assert np.array_equal(rc.suite("full", self.TLEN)[1],
                              rc.suite("full")[1])
        short = rc.suite("full", 50)
        assert int(np.max(short[2])) <= 50
        assert list(rc.subset("quick", 50)) == list(rc.subset_names("quick"))


def test_resolve_corpus_dir_env_var(fixture_corpus, monkeypatch):
    monkeypatch.setenv("REPRO_CORPUS_DIR", fixture_corpus)
    assert resolve_corpus_dir(None) == fixture_corpus
    assert resolve_corpus_dir("/explicit/wins") == "/explicit/wins"
    assert RealCorpus(resolve_corpus_dir()).fingerprint() == GOLDEN_FP
    monkeypatch.delenv("REPRO_CORPUS_DIR")
    assert resolve_corpus_dir(None) is None


def test_family_of_fallback_and_degenerate_stats():
    with pytest.raises(ValueError, match="registry"):
        family_of("web2")
    assert family_of("web2", INGESTED) == INGESTED
    assert family_of("seq012", INGESTED) == "seq"
    empty = workload_stats(np.array([], np.int32))
    assert empty["degenerate"] and empty["requests"] == 0
    one = workload_stats(np.array([7], np.int32))
    assert one["degenerate"] and one["sequential_fraction"] == 0.0
    real = workload_stats(ingest_raw(RAW))
    assert not real["degenerate"] and real["requests"] == GOLDEN_LENGTHS[1]
    assert real == rio.workload_stats(rio.ingest_raw(RAW))


# ---------------------------------------------------------------------------
# validation batteries: the port raises where the reference raises, with
# the same message
# ---------------------------------------------------------------------------

def outcome(fn, *args, **kw):
    """('ok', result as a list) or (exception type name, message)."""
    try:
        out = fn(*args, **kw)
    except Exception as e:      # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    if isinstance(out, np.ndarray):
        return "ok", out.dtype.str, out.tolist()
    return "ok", out


def same_outcome(name, *args, **kw):
    got = outcome(getattr(pio, name), *args, **kw)
    want = outcome(getattr(rio, name), *args, **kw)
    assert got == want
    return got


MSR_HEADER = "Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime\n"
MSR_CASES = {
    "truncated": (["1,h,0,Read,4096,4096,1", "2,h,0,Read"], {}),
    "non_integer": (["1,h,0,Read,40x96,4096,1"], {}),
    "non_monotonic": (["5,h,0,Read,0,4096,1", "4,h,0,Read,4096,4096,1"], {}),
    "zero_length": (["1,h,0,Read,4096,0,1"], {}),
    "negative_offset": (["1,h,0,Read,-4096,4096,1"], {}),
    "int64_overflow": ([f"1,h,0,Read,{2**63 - 10},4096,1"], {}),
    "filtered_non_monotonic": (["5,h,0,Read,0,4096,1",
                                "3,h,0,Write,4096,4096,1"],
                               {"only": "Read"}),
    "type_filter": (["1,h,0,Read,0,8192,1", "2,h,0,Write,40960,4096,1",
                     "3,h,0,Read,12288,4096,1"],
                    {"only": "Read", "rebase": False}),
    "text_row_and_blank": (["note, a text row", "", "1,h,0,Read,0,4096,1"],
                           {}),
    "empty": ([], {}),
}


@pytest.mark.parametrize("case", sorted(MSR_CASES))
def test_msr_validation_equals_reference(case, tmp_path):
    rows, kw = MSR_CASES[case]
    p = tmp_path / "t.csv"
    p.write_text(MSR_HEADER + "\n".join(rows) + "\n")
    got = same_outcome("ingest_msr_csv", str(p), **kw)
    if case in ("type_filter", "text_row_and_blank", "empty"):
        assert got[0] == "ok"
    else:
        assert got[0] == "ValueError" and "t.csv" in got[1]


RAW_CASES = {
    "uint64_overflow": (np.array([2**63 + 5, 4096], "<u8").tobytes(), {}),
    "torn_record": (np.array([0, 4096], "<u8").tobytes() + b"abc", {}),
    "empty": (b"", {}),
    "chunk_boundary": ((np.arange(100, dtype="<u8") * 4096).tobytes(),
                       {"rebase": False, "chunk_bytes": 13}),
    "rebased": (np.array([40960, 8192, 12288], "<u8").tobytes(), {}),
}


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_raw_validation_equals_reference(case, tmp_path):
    data, kw = RAW_CASES[case]
    p = tmp_path / "t.raw"
    p.write_bytes(data)
    got = same_outcome("ingest_raw", str(p), **kw)
    assert (got[0] == "ok") == (case in ("empty", "chunk_boundary",
                                         "rebased"))


def _corpus_dir(d):
    write_corpus_dir(str(d), {"a": np.arange(5, dtype=np.int32),
                              "b": np.arange(3, dtype=np.int32)})


def _stale_requests(d):
    man = read_manifest(str(d))
    man["volumes"][0]["requests"] = 999
    (d / "manifest.json").write_text(json.dumps(man))


def _duplicate(d):
    man = read_manifest(str(d))
    man["volumes"].append(dict(man["volumes"][0]))
    (d / "manifest.json").write_text(json.dumps(man))


def _no_volumes(d):
    (d / "manifest.json").write_text(json.dumps({"version": 1,
                                                 "volumes": []}))


def _entry_without_file(d):
    man = read_manifest(str(d))
    del man["volumes"][1]["file"]
    (d / "manifest.json").write_text(json.dumps(man))


def _not_int32(d):
    np.savez_compressed(d / "a.npz", a=np.arange(5, dtype=np.int64))


def _negative_ids(d):
    np.savez_compressed(d / "a.npz", a=np.array([0, -1, 2, 3, 4], np.int32))


def _stale_name(d):
    np.savez_compressed(d / "a.npz", z=np.arange(5, dtype=np.int32))


def _duplicate_across_npz(d):
    os.remove(d / "manifest.json")
    np.savez_compressed(d / "c.npz", a=np.arange(2, dtype=np.int32))


DIR_CASES = {
    "stale_requests": (_stale_requests, "load_corpus_dir"),
    "missing_file": (lambda d: os.remove(d / "a.npz"), "scan_corpus_dir"),
    "duplicate_volume": (_duplicate, "scan_corpus_dir"),
    "invalid_json": (lambda d: (d / "manifest.json").write_text("{nope"),
                     "scan_corpus_dir"),
    "no_volumes": (_no_volumes, "scan_corpus_dir"),
    "entry_without_file": (_entry_without_file, "scan_corpus_dir"),
    "not_int32": (_not_int32, "load_corpus_dir"),
    "negative_ids": (_negative_ids, "load_corpus_dir"),
    "stale_name": (_stale_name, "load_corpus_dir"),
    "duplicate_across_npz": (_duplicate_across_npz, "scan_corpus_dir"),
    "manifestless": (lambda d: os.remove(d / "manifest.json"),
                     "load_corpus_dir"),
    "empty_directory": (None, "scan_corpus_dir"),
    "absent_directory": ("absent", "scan_corpus_dir"),
}


@pytest.mark.parametrize("case", sorted(DIR_CASES))
def test_corpus_dir_validation_equals_reference(case, tmp_path):
    damage, fn = DIR_CASES[case]
    d = tmp_path
    if damage == "absent":
        d = tmp_path / "absent"
    elif damage is not None:
        _corpus_dir(d)
        damage(d)
    got = outcome(getattr(pio, fn), str(d))
    want = outcome(getattr(rio, fn), str(d))
    if got[0] == "ok":
        assert want[0] == "ok" and case == "manifestless"
        traces, fams = got[1]
        ref_traces, ref_fams = want[1]
        assert fams == ref_fams == {"a": INGESTED, "b": INGESTED}
        assert list(traces) == list(ref_traces)
    else:
        assert got == want and got[0] == "ValueError"


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2**40),
                          st.integers(1, 5 * 4096)),
                min_size=1, max_size=30))
def test_valid_msr_rows_expand_as_reference(reqs):
    rows = [f"{i},h,0,Read,{off},{size},1"
            for i, (off, size) in enumerate(reqs)]
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "t.csv"
        p.write_text(MSR_HEADER + "\n".join(rows) + "\n")
        got = ingest_msr_csv(str(p), rebase=False)
        want = rio.ingest_msr_csv(str(p), rebase=False)
    np.testing.assert_array_equal(got, want)
    expect = []
    for off, size in reqs:
        expect.extend(range(off // 4096, (off + size - 1) // 4096 + 1))
    assert got.tolist() == expect


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 2**62), min_size=0, max_size=64))
def test_raw_decode_as_reference(offs):
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.raw")
        np.asarray(offs, dtype="<u8").tofile(p)
        got = ingest_raw(p, rebase=False)
        assert got.tolist() == rio.ingest_raw(p, rebase=False).tolist()
    assert got.tolist() == [o // 4096 for o in offs]


# ---------------------------------------------------------------------------
# tests/test_traces_io.py's cases, against the port's io
# ---------------------------------------------------------------------------

def _write_msr(path, records):
    with open(path, "w") as f:
        f.write(MSR_HEADER)
        for i, (typ, off, size) in enumerate(records):
            f.write(f"{128166372003061629 + i},src1,0,{typ},{off},"
                    f"{size},{1000 + i}\n")


class TestTracesIo:
    def test_save_load_bit_identical(self, tmp_path):
        traces = {f"v{i}": mixed(800, 0.3, 0.4, 0.3, seed=i)
                  for i in range(3)}
        path = os.path.join(tmp_path, "suite.npz")
        save_traces(path, traces)
        back = load_traces(path)
        assert set(back) == set(traces)
        for k in traces:
            assert back[k].dtype == np.int32
            np.testing.assert_array_equal(back[k], traces[k], err_msg=k)
        assert workload_stats(back["v0"]) == workload_stats(traces["v0"])

    def test_save_rejects_out_of_range_ids(self, tmp_path):
        path = os.path.join(tmp_path, "bad.npz")
        for bad in (np.array([0, 2 ** 31], np.int64),
                    np.array([-2], np.int64)):
            with pytest.raises(ValueError, match="int32") as e:
                save_traces(path, {"big": bad})
            with pytest.raises(ValueError) as r:
                rio.save_traces(path, {"big": bad})
            assert str(e.value) == str(r.value)
        assert not os.path.exists(path)
        save_traces(path, {"edge": np.array([0, 2 ** 31 - 1], np.int64)})
        np.testing.assert_array_equal(load_traces(path)["edge"],
                                      [0, 2 ** 31 - 1])

    def test_workload_stats_total_and_equal_reference(self):
        for tr in (np.array([], np.int32), np.array([7], np.int32),
                   np.arange(100), np.zeros(100, np.int64),
                   mixed(600, 0.5, 0.3, 0.2, seed=9)):
            with np.errstate(all="raise"):
                stats = workload_stats(tr)
            assert stats == rio.workload_stats(tr)
            for v in stats.values():
                assert np.isfinite(v)
        assert workload_stats(np.arange(100))["sequential_fraction"] == 1.0

    def test_msr_csv_block_expansion_and_chunks(self, tmp_path):
        path = os.path.join(tmp_path, "vol.csv")
        _write_msr(path, [("Read", 8192, 4096), ("Write", 20480, 8192),
                          ("Read", 12800, 4096)])
        np.testing.assert_array_equal(
            ingest_msr_csv(path, block_size=4096, rebase=False),
            [2, 5, 6, 3, 4])
        big = os.path.join(tmp_path, "big.csv")
        _write_msr(big, [("Read", int(o), 4096)
                         for o in np.arange(500) * 4096])
        one = ingest_msr_csv(big, block_size=4096, rebase=False)
        tiny = ingest_msr_csv(big, block_size=4096, rebase=False,
                              chunk_rows=7)
        np.testing.assert_array_equal(one, np.arange(500))
        np.testing.assert_array_equal(tiny, one)

    def test_msr_csv_type_filter_and_rebase(self, tmp_path):
        path = os.path.join(tmp_path, "vol.csv")
        _write_msr(path, [("Read", 40960, 4096), ("Write", 8192, 4096),
                          ("read", 45056, 4096)])
        np.testing.assert_array_equal(
            ingest_msr_csv(path, block_size=4096, only="Read"), [0, 1])

    def test_raw_round_trip_any_chunk(self, tmp_path):
        path = os.path.join(tmp_path, "vol.raw")
        blocks = np.array([5, 6, 7, 3, 5, 100], np.int64)
        (blocks.astype("<u8") * 4096).tofile(path)
        for chunk_bytes in (1 << 24, 16, 10, 7, 3):
            np.testing.assert_array_equal(
                ingest_raw(path, block_size=4096, rebase=False,
                           chunk_bytes=chunk_bytes), blocks)

    def test_ingest_dispatch(self, tmp_path):
        csv = os.path.join(tmp_path, "a.csv")
        raw = os.path.join(tmp_path, "b.raw")
        _write_msr(csv, [("Read", 4096, 4096)])
        np.array([4096], "<u8").tofile(raw)
        np.testing.assert_array_equal(ingest(csv, rebase=False), [1])
        np.testing.assert_array_equal(ingest(raw, rebase=False), [1])
        with pytest.raises(ValueError, match="format"):
            ingest(raw, fmt="vhs")

    def test_ingest_to_npz_end_to_end(self, tmp_path):
        csv = os.path.join(tmp_path, "web2.csv")
        _write_msr(csv, [("Read", 4096 * b, 4096)
                         for b in (9, 10, 11, 4, 9)])
        out = os.path.join(tmp_path, "corpus.npz")
        stats = ingest_to_npz({"web2": csv}, out)
        assert stats["web2"]["requests"] == 5
        assert stats["web2"]["unique_blocks"] == 4
        back = load_traces(out)
        np.testing.assert_array_equal(back["web2"], [5, 6, 7, 0, 5])
        assert stats == rio.ingest_to_npz([csv], os.path.join(tmp_path,
                                                              "r.npz"))
