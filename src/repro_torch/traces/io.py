"""Trace persistence, real-format ingestion, corpus directories, stats.

A copy of the reference's ``repro/traces/io.py`` (numpy only): the same
files, manifests, fingerprints and error messages.

Canonical on-disk form is one compressed ``.npz`` per suite: int32 block
ids keyed by trace/volume name (``save_traces``/``load_traces``). Real
trace formats stream through chunked ingesters into that form:

* ``ingest_msr_csv`` — MSR-Cambridge-style CSV rows
  (``Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime``):
  each record expands to the block ids its byte range covers, so
  sequentiality survives at block granularity.
* ``ingest_raw`` — flat binary little-endian uint64 byte offsets (the
  "raw block trace" interchange form), one block id per record.
* ``ingest`` — extension-dispatched convenience;
  ``ingest_to_npz`` — many volumes -> one canonical npz + per-volume
  ``workload_stats`` summaries.

Malformed real-world inputs raise a clear ``ValueError`` naming the
file (and line) instead of crashing or silently truncating: truncated
CSV rows, non-integer fields, non-monotonic timestamps, zero-length
byte ranges, negative offsets, torn trailing records and uint64
offsets overflowing the signed arithmetic are all rejected
(``tests/test_real_corpus.py`` and ``tests/test_torch_real_corpus.py``
fuzz this contract).

A *corpus directory* is the drop-in unit the benchmark layer consumes
(``traces.corpus.RealCorpus``): canonical npz volumes plus a
``manifest.json`` with per-trace name/file/family/length metadata.
``ingest_to_dir`` (or ``python -m repro_torch.traces.io OUT_DIR FILES...``)
builds one from real trace files; ``scan_corpus_dir`` discovers and
validates one (manifest entries must resolve to existing volumes with
matching request counts; without a manifest, ``*.npz`` volumes are
discovered in sorted order); ``corpus_fingerprint`` derives the
process-stable content hash that keys BENCH telemetry per corpus.

All ingesters read fixed-size chunks (``chunk_rows``/``chunk_bytes``),
so corpus-scale files never materialize as text in memory. Offsets are
rebased to the volume's minimum block by default: deltas (and therefore
sequential structure) are preserved while large-device offsets fit the
canonical int32 id space; ids that still fall outside it make
``save_traces`` raise rather than silently truncate.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Union

import numpy as np

BLOCK_SIZE = 4096
MANIFEST = "manifest.json"
_I32_MAX = np.iinfo(np.int32).max
_I64_MAX = np.iinfo(np.int64).max

# MSR-Cambridge CSV column layout
_MSR_TS, _MSR_TYPE, _MSR_OFFSET, _MSR_SIZE = 0, 3, 4, 5


def save_traces(path: str, traces: Dict[str, np.ndarray]) -> None:
    """Write the canonical npz. Ids outside int32 raise (never truncate)."""
    out = {}
    for k, v in traces.items():
        a = np.asarray(v)
        if a.size and (int(a.min()) < 0 or int(a.max()) > _I32_MAX):
            raise ValueError(
                f"trace {k!r}: block ids span [{int(a.min())}, "
                f"{int(a.max())}], outside the canonical int32 id space "
                "[0, 2**31) — rebase the ids (see ingest(..., rebase=True)) "
                "instead of letting the cast truncate them")
        out[k] = a.astype(np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **out)


def load_traces(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def workload_stats(trace: np.ndarray) -> Dict[str, float]:
    """Per-volume summary (requests, reuse, sequentiality, frequency).

    Total functions of the trace: length-0 and length-1 traces get
    well-defined zeros (``sequential_fraction`` needs two requests;
    ``np.mean`` over an empty ``np.diff`` would be NaN) plus a
    ``degenerate`` flag — downstream summary CSVs surface such traces
    through that column instead of silently dropping the rows
    (``benchmarks.corpus_figures``).
    """
    trace = np.asarray(trace).ravel()
    n = int(trace.size)
    if n == 0:
        return {"requests": 0, "unique_blocks": 0, "cold_miss_ratio": 0.0,
                "sequential_fraction": 0.0, "mean_freq": 0.0,
                "p99_freq": 0.0, "mid_freq_blocks": 0, "degenerate": True}
    uniq, counts = np.unique(trace, return_counts=True)
    diffs = np.diff(trace.astype(np.int64))
    seq_frac = float(np.mean(diffs == 1)) if diffs.size else 0.0
    return {
        "requests": n,
        "degenerate": n <= 1,
        "unique_blocks": int(len(uniq)),
        "cold_miss_ratio": len(uniq) / n,
        "sequential_fraction": seq_frac,
        "mean_freq": float(counts.mean()),
        "p99_freq": float(np.percentile(counts, 99)),
        "mid_freq_blocks": int(np.sum((counts >= 2) & (counts <= 16))),
    }


# ---------------------------------------------------------------------------
# Real-format ingestion (chunk-streamed)
# ---------------------------------------------------------------------------

def _rebase(blocks: np.ndarray, rebase: bool) -> np.ndarray:
    if rebase and blocks.size:
        blocks = blocks - blocks.min()
    return blocks


def ingest_msr_csv(path: str, block_size: int = BLOCK_SIZE,
                   only: Optional[str] = None, rebase: bool = True,
                   chunk_rows: int = 1 << 18) -> np.ndarray:
    """MSR-Cambridge-style CSV -> int64 block-id stream.

    Each record covers ``ceil`` of its byte range in blocks; multi-block
    requests expand to consecutive ids (sequentiality is a block-level
    property). ``only`` filters on the Type column (e.g. ``"Read"``,
    case-insensitive). Rows stream in ``chunk_rows`` batches.

    Malformed rows raise ``ValueError`` with file:line context — a
    truncated row, non-integer field, decreasing timestamp, negative
    offset or zero-length byte range would otherwise shift or silently
    drop requests (the fuzz battery used to surface exactly that: short
    rows were skipped and ``size=0`` was coerced to one byte).
    """
    parts = []
    last_ts = None
    lineno = 0
    with open(path) as f:
        while True:
            lines = f.readlines(chunk_rows * 64)   # ~64B/row hint
            if not lines:
                break
            offs, sizes = [], []
            for ln in lines:
                lineno += 1
                ln = ln.strip()
                if not ln or ln[0].isalpha():       # header / comment row
                    continue
                cols = ln.split(",")
                if len(cols) <= _MSR_SIZE:
                    raise ValueError(
                        f"{path}:{lineno}: truncated row ({len(cols)} of "
                        f">={_MSR_SIZE + 1} columns): {ln[:80]!r}")
                try:
                    ts = int(cols[_MSR_TS])
                    off = int(cols[_MSR_OFFSET])
                    size = int(cols[_MSR_SIZE])
                except ValueError:
                    raise ValueError(f"{path}:{lineno}: non-integer "
                                     f"field in row {ln[:80]!r}") from None
                if last_ts is not None and ts < last_ts:
                    raise ValueError(
                        f"{path}:{lineno}: non-monotonic timestamp "
                        f"{ts} after {last_ts}")
                last_ts = ts
                if off < 0:
                    raise ValueError(
                        f"{path}:{lineno}: negative byte offset {off}")
                if size <= 0:
                    raise ValueError(
                        f"{path}:{lineno}: zero-length byte range "
                        f"(size={size}) — not a real request")
                if off + size > _I64_MAX:
                    raise ValueError(
                        f"{path}:{lineno}: byte range [{off}, {off + size})"
                        " overflows int64 offset arithmetic")
                if only and cols[_MSR_TYPE].strip().lower() != only.lower():
                    continue
                offs.append(off)
                sizes.append(size)
            if not offs:
                continue
            off = np.asarray(offs, np.int64)
            size = np.asarray(sizes, np.int64)
            first = off // block_size
            nblk = (off + size - 1) // block_size - first + 1
            # expand each record to the consecutive blocks it covers
            total = int(nblk.sum())
            reps = np.repeat(first, nblk)
            within = np.arange(total) - np.repeat(
                np.cumsum(nblk) - nblk, nblk)
            parts.append(reps + within)
    blocks = (np.concatenate(parts) if parts
              else np.empty((0,), np.int64))
    return _rebase(blocks, rebase)


def ingest_raw(path: str, block_size: int = BLOCK_SIZE,
               rebase: bool = True,
               chunk_bytes: int = 1 << 24) -> np.ndarray:
    """Raw binary block trace (little-endian uint64 byte offsets).

    Offsets past ``2**63 - 1`` raise ``ValueError``: a bare
    ``astype(int64)`` would wrap them to negative block ids (another
    silent corruption the fuzz battery surfaced).
    """
    parts = []
    rest = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            # chunks rarely end on a record boundary: carry the partial
            # record into the next chunk instead of dropping it (which
            # would shift every later record out of phase)
            buf = rest + chunk
            n = len(buf) - len(buf) % 8
            rest = buf[n:]
            if n:
                raw = np.frombuffer(buf[:n], dtype="<u8")
                if int(raw.max()) > _I64_MAX:
                    raise ValueError(
                        f"{path}: byte offset {int(raw.max())} overflows "
                        "signed int64 — casting would wrap it to a "
                        "negative block id")
                off = raw.astype(np.int64)
                parts.append(off // block_size)
    if rest:
        raise ValueError(f"{path}: trailing {len(rest)} bytes are not a "
                         "whole little-endian uint64 record")
    blocks = (np.concatenate(parts) if parts
              else np.empty((0,), np.int64))
    return _rebase(blocks, rebase)


def ingest(path: str, fmt: Optional[str] = None,
           block_size: int = BLOCK_SIZE, rebase: bool = True,
           **kw) -> np.ndarray:
    """Extension-dispatched ingestion: ``.csv`` -> MSR, else raw."""
    if fmt is None:
        fmt = "msr" if path.lower().endswith(".csv") else "raw"
    if fmt == "msr":
        return ingest_msr_csv(path, block_size, rebase=rebase, **kw)
    if fmt == "raw":
        return ingest_raw(path, block_size, rebase=rebase, **kw)
    raise ValueError(f"unknown trace format {fmt!r} (expected msr|raw)")


def ingest_to_npz(sources: Union[Mapping[str, str], Iterable[str]],
                  out_path: str, fmt: Optional[str] = None,
                  block_size: int = BLOCK_SIZE,
                  rebase: bool = True) -> Dict[str, Dict[str, float]]:
    """Ingest many volumes into one canonical npz.

    ``sources`` maps volume name -> file path (or is an iterable of
    paths, named by basename). Returns per-volume ``workload_stats``
    summaries; the npz lands at ``out_path`` via :func:`save_traces`
    (so out-of-range ids raise rather than truncate).
    """
    if not isinstance(sources, Mapping):
        sources = {os.path.splitext(os.path.basename(p))[0]: p
                   for p in sources}
    traces, stats = {}, {}
    for name, path in sources.items():
        tr = ingest(path, fmt=fmt, block_size=block_size, rebase=rebase)
        traces[name] = tr
        stats[name] = workload_stats(tr)
    save_traces(out_path, traces)
    return stats


# ---------------------------------------------------------------------------
# Corpus directories: canonical npz volumes + manifest (the drop-in unit)
# ---------------------------------------------------------------------------

def corpus_fingerprint(traces: Mapping[str, np.ndarray]) -> str:
    """Process-stable crc32 chain over names, lengths and block content.

    The fingerprint keys BENCH telemetry per ingested corpus (job names
    become ``corpus_quick@<fingerprint>``), so ``benchmarks.compare``
    skips cleanly instead of cross-comparing hit ratios measured on
    different trace populations. Chained crc32 (like the registry's
    spec seeds) — never Python's randomized ``hash``.
    """
    h = 0
    for name in traces:
        a = np.ascontiguousarray(np.asarray(traces[name]).astype("<i8"))
        h = zlib.crc32(name.encode(), h)
        h = zlib.crc32(a.size.to_bytes(8, "little"), h)
        h = zlib.crc32(a.tobytes(), h)
    return f"{h & 0xFFFFFFFF:08x}"


def write_corpus_dir(out_dir: str, traces: Mapping[str, np.ndarray],
                     families: Optional[Mapping[str, str]] = None
                     ) -> List[dict]:
    """Write a corpus directory: one canonical npz per volume + manifest.

    The manifest records registry order, per-volume family (default
    ``"ingested"``), request counts, ``workload_stats`` summaries and
    the corpus fingerprint. Returns the manifest's volume entries.
    """
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for name, tr in traces.items():
        fname = f"{name}.npz"
        save_traces(os.path.join(out_dir, fname), {name: tr})
        st = workload_stats(np.asarray(tr))
        entries.append({
            "name": name, "file": fname,
            "family": (families or {}).get(name, "ingested"),
            "requests": int(st["requests"]),
            "stats": {k: (bool(v) if isinstance(v, (bool, np.bool_))
                          else float(v) if isinstance(v, float) else int(v))
                      for k, v in st.items()},
        })
    manifest = {"version": 1,
                "fingerprint": corpus_fingerprint(traces),
                "volumes": entries}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return entries


def read_manifest(directory: str) -> dict:
    path = os.path.join(directory, MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: manifest is not valid json: {e}") \
            from None


def scan_corpus_dir(directory: str) -> List[dict]:
    """Discover + validate a corpus directory's volume entries.

    With a ``manifest.json``: entries come back in manifest (registry)
    order, each checked to name a file that exists; duplicates and
    empty manifests raise. Without one, ``*.npz`` files are discovered
    in sorted order and every trace key inside them becomes an entry
    with family ``"ingested"`` — so a bare ``ingest_to_npz`` output
    dropped into a directory is already a valid corpus.
    """
    if not os.path.isdir(directory):
        raise ValueError(f"{directory}: not a corpus directory")
    entries: List[dict] = []
    seen: set = set()
    if os.path.exists(os.path.join(directory, MANIFEST)):
        man = read_manifest(directory)
        vols = man.get("volumes")
        if not isinstance(vols, list) or not vols:
            raise ValueError(f"{directory}/{MANIFEST}: manifest lists "
                             "no volumes")
        for e in vols:
            name, fname = e.get("name"), e.get("file")
            if not name or not fname:
                raise ValueError(f"{directory}/{MANIFEST}: volume entry "
                                 f"missing name/file: {e!r}")
            if name in seen:
                raise ValueError(f"{directory}/{MANIFEST}: duplicate "
                                 f"volume name {name!r}")
            seen.add(name)
            if not os.path.exists(os.path.join(directory, fname)):
                raise ValueError(
                    f"{directory}/{MANIFEST}: volume {name!r} references "
                    f"missing file {fname!r}")
            entries.append(dict(e))
        return entries
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
    if not files:
        raise ValueError(f"{directory}: no {MANIFEST} and no .npz "
                         "volumes — not a corpus directory")
    for fname in files:
        with np.load(os.path.join(directory, fname)) as z:
            for name in z.files:
                if name in seen:
                    raise ValueError(f"{directory}: duplicate trace name "
                                     f"{name!r} across npz volumes")
                seen.add(name)
                entries.append({"name": name, "file": fname,
                                "family": "ingested",
                                "requests": int(z[name].size)})
    return entries


def load_corpus_dir(directory: str):
    """Load a corpus directory -> ``(traces, families)`` dicts.

    Registry order follows :func:`scan_corpus_dir`. Each volume is
    validated against its manifest entry: the npz must hold the named
    trace as a 1-D canonical int32 array with non-negative ids whose
    length matches the manifest's ``requests`` — a stale manifest or a
    hand-edited volume raises instead of silently feeding the sweep a
    different corpus than the manifest describes.
    """
    entries = scan_corpus_dir(directory)
    cache: Dict[str, Dict[str, np.ndarray]] = {}
    traces: Dict[str, np.ndarray] = {}
    families: Dict[str, str] = {}
    for e in entries:
        fname = e["file"]
        if fname not in cache:
            cache[fname] = load_traces(os.path.join(directory, fname))
        vol = cache[fname]
        name = e["name"]
        if name not in vol:
            raise ValueError(f"{directory}/{fname}: npz holds no trace "
                             f"{name!r} (manifest is stale?)")
        tr = vol[name]
        if tr.dtype != np.int32 or tr.ndim != 1:
            raise ValueError(
                f"{directory}/{fname}: trace {name!r} is not canonical "
                f"1-D int32 (got {tr.dtype}, shape {tr.shape})")
        if tr.size and int(tr.min()) < 0:
            raise ValueError(f"{directory}/{fname}: trace {name!r} has "
                             "negative block ids")
        if "requests" in e and int(e["requests"]) != tr.size:
            raise ValueError(
                f"{directory}/{fname}: trace {name!r} length {tr.size} "
                f"!= manifest requests {e['requests']}")
        traces[name] = tr
        families[name] = str(e.get("family") or "ingested")
    return traces, families


def ingest_to_dir(sources: Union[Mapping[str, str], Iterable[str]],
                  out_dir: str, fmt: Optional[str] = None,
                  block_size: int = BLOCK_SIZE, rebase: bool = True,
                  families: Optional[Mapping[str, str]] = None
                  ) -> List[dict]:
    """Ingest real trace files into a corpus directory (npz + manifest).

    ``sources`` maps volume name -> file path (or is an iterable of
    paths, named by basename). The result is directly consumable by
    ``RealCorpus`` / every benchmark's ``--corpus-dir`` flag. Returns
    the manifest volume entries (incl. per-volume ``workload_stats``).
    """
    if not isinstance(sources, Mapping):
        sources = {os.path.splitext(os.path.basename(p))[0]: p
                   for p in sources}
    traces = {name: ingest(path, fmt=fmt, block_size=block_size,
                           rebase=rebase)
              for name, path in sources.items()}
    return write_corpus_dir(out_dir, traces, families)


def _parser():
    import argparse
    ap = argparse.ArgumentParser(
        description="Ingest real trace files into a corpus directory "
                    "(canonical npz volumes + manifest.json) consumable "
                    "by every benchmark's --corpus-dir flag.")
    ap.add_argument("out_dir", help="corpus directory to create/overwrite")
    ap.add_argument("sources", nargs="+",
                    help="trace files (.csv -> MSR rows, else raw "
                         "little-endian uint64 byte offsets)")
    ap.add_argument("--fmt", choices=("msr", "raw"), default=None,
                    help="force a format instead of extension dispatch")
    ap.add_argument("--block-size", type=int, default=BLOCK_SIZE)
    ap.add_argument("--no-rebase", action="store_true",
                    help="keep absolute block ids (default rebases each "
                         "volume to its minimum block)")
    ap.add_argument("--family", default=None,
                    help="family label recorded for every volume "
                         "(default: 'ingested')")
    return ap


def main(argv=None) -> str:
    a = _parser().parse_args(argv)
    names = [os.path.splitext(os.path.basename(p))[0] for p in a.sources]
    entries = ingest_to_dir(
        dict(zip(names, a.sources)), a.out_dir, fmt=a.fmt,
        block_size=a.block_size, rebase=not a.no_rebase,
        families={n: a.family for n in names} if a.family else None)
    for e in entries:
        st = e["stats"]
        print(f"  {e['name']:<20} requests={st['requests']:<8} "
              f"unique={st['unique_blocks']:<8} "
              f"seq={st['sequential_fraction']:.3f} "
              f"family={e['family']}")
    fp = read_manifest(a.out_dir)["fingerprint"]
    print(f"wrote {len(entries)} volume(s) + {MANIFEST} to {a.out_dir} "
          f"(fingerprint {fp})")
    return fp


if __name__ == "__main__":
    main()
