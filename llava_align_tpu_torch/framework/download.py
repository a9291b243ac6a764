"""Offline-safe dataset download layer (a copy of
llava_align_tpu/framework/download.py, the source unchanged;
tests/test_torch_copies.py holds it to the original, and every fetch takes
an `_opener`, so the tests run it with a fake one and open no URL).

Capability parity: the reference's per-dataset download scripts
(lavis/datasets/download_scripts/*.py: coco/gqa/vg/msvd/didemo archive
fetchers, nocaps/sbu per-image fetchers from annotation lists, flickr
(kaggle) and msrvtt (mediafire) manual flows, and the
DownloadConceptualCaptions TSV streamer). One MANIFEST records every
target (URL + md5 where the reference documents one + layout), and one
resumable fetcher downloads, verifies and extracts. Offline, network
failures raise `DownloadUnavailable` (callers may catch and proceed with
local data), and `dry_run=True` never touches the network.

URLs and md5s are data copied verbatim from the reference scripts: they are
the spec of where each dataset lives.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tarfile
import urllib.error
import urllib.request
import zipfile
from typing import Dict, List, Optional


class DownloadUnavailable(RuntimeError):
    """Network fetch failed (offline environment or dead mirror)."""


class ManualDownloadRequired(RuntimeError):
    """The source needs an interactive flow (kaggle login, mediafire token)."""


@dataclasses.dataclass(frozen=True)
class DownloadEntry:
    dataset: str
    name: str                 # split or component label
    url: str
    kind: str = "archive"     # archive | file | per_image_json | manual
    md5: Optional[str] = None
    storage: str = ""         # subdir under the dataset root to extract into
    note: str = ""


_E = DownloadEntry

MANIFEST: List[DownloadEntry] = [
    # download_coco.py:22-27 (md5s from the reference's inline comments)
    _E("coco", "train2014", "http://images.cocodataset.org/zips/train2014.zip",
       md5="0da8c0bd3d6becc4dcb32757491aca88", storage="images"),
    _E("coco", "val2014", "http://images.cocodataset.org/zips/val2014.zip",
       md5="a3d79f5ed8d289b7a7554ce06a5782b3", storage="images"),
    _E("coco", "test2014", "http://images.cocodataset.org/zips/test2014.zip",
       md5="04127eef689ceac55e3a572c2c92f264", storage="images"),
    _E("coco", "test2015", "http://images.cocodataset.org/zips/test2015.zip",
       storage="images"),
    # download_gqa.py:21
    _E("gqa", "images", "https://downloads.cs.stanford.edu/nlp/data/gqa/images.zip",
       storage="images"),
    # download_vg.py:21-24
    _E("vg", "train", "https://cs.stanford.edu/people/rak248/VG_100K_2/images.zip",
       storage="images"),
    _E("vg", "train2", "https://cs.stanford.edu/people/rak248/VG_100K_2/images2.zip",
       storage="images"),
    # download_msvd.py:21
    _E("msvd", "videos", "https://www.cs.utexas.edu/users/ml/clamp/videoDescription/YouTubeClips.tar",
       storage="videos"),
    # download_didemo.py:20
    _E("didemo", "videos",
       "https://storage.googleapis.com/sfr-vision-language-research/LAVIS/datasets/didemo/didemo_videos.tar.gz",
       storage="videos"),
    # download_nocaps.py: per-image fetch driven by the annotation jsons
    _E("nocaps", "val_ann",
       "https://nocaps.s3.amazonaws.com/nocaps_val_image_info.json",
       kind="per_image_json", storage="val"),
    _E("nocaps", "test_ann",
       "https://s3.amazonaws.com/nocaps/nocaps_test_image_info.json",
       kind="per_image_json", storage="test"),
    # download_sbu.py: per-image from the annotation list (the tar mirror is
    # commented out in the reference, :21)
    _E("sbu", "images",
       "https://storage.googleapis.com/sfr-vision-language-research/LAVIS/datasets/sbu/sbu.json",
       kind="per_image_json", storage="images",
       note="per-image fetch from the SBU caption url list"),
    # download_flickr.py:22-29 — kaggle API flow
    _E("flickr30k", "images",
       "https://www.kaggle.com/datasets/hsankesara/flickr-image-dataset",
       kind="manual",
       note="Needs a Kaggle account + API token "
            "(https://www.kaggle.com/docs/api): "
            "`kaggle datasets download hsankesara/flickr-image-dataset`, "
            "then extract under <root>/flickr30k/images."),
    # download_msrvtt.py:22-30 — mediafire one-time links
    _E("msrvtt", "train_val",
       "https://www.mediafire.com/file/x3rrbe4hwp04e6w/train_val_videos.zip/file",
       kind="manual",
       note="Mediafire issues per-session links: open the page, copy the "
            "Download button's address and pass it as url_override."),
    _E("msrvtt", "test",
       "https://www.mediafire.com/file/czh8sezbo9s4692/test_videos.zip/file",
       kind="manual",
       note="Same per-session-link flow as msrvtt/train_val."),
    # DownloadConceptualCaptions/: streams images from the TSV url lists
    _E("conceptual_captions", "train_tsv",
       "https://storage.googleapis.com/gcc-data/Train/GCC-training.tsv",
       kind="per_image_json", storage="images",
       note="TSV of (caption, url); images fetched row by row"),
]


def entries_for(dataset: str) -> List[DownloadEntry]:
    return [e for e in MANIFEST if e.dataset == dataset]


def datasets() -> List[str]:
    seen: Dict[str, None] = {}
    for e in MANIFEST:
        seen.setdefault(e.dataset, None)
    return list(seen)


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def fetch_file(url: str, dest: str, *, resume: bool = True,
               timeout: float = 30.0, _opener=None) -> str:
    """Resumable single-file fetch: partial downloads land in `dest.part`
    and continue with a Range request on retry (the reference restarts from
    scratch and deletes the whole download dir on failure,
    download_coco.py:52-57 — resuming is the offline-friendly upgrade)."""
    part = dest + ".part"
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    if os.path.exists(dest):
        return dest
    start = os.path.getsize(part) if (resume and os.path.exists(part)) else 0
    req = urllib.request.Request(url, headers={"User-Agent": "llava-align-tpu/1.0"})
    if start:
        req.add_header("Range", f"bytes={start}-")
    opener = _opener or urllib.request.urlopen
    try:
        with opener(req, timeout=timeout) as resp:
            mode = "ab" if start and resp.status == 206 else "wb"
            with open(part, mode) as f:
                shutil.copyfileobj(resp, f)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise DownloadUnavailable(
            f"fetch of {url} failed ({e}); partial progress kept at {part}"
        ) from e
    os.replace(part, dest)
    return dest


def _extract(archive: str, dest_dir: str) -> None:
    os.makedirs(dest_dir, exist_ok=True)
    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            z.extractall(dest_dir)
    elif tarfile.is_tarfile(archive):
        with tarfile.open(archive) as t:
            t.extractall(dest_dir, filter="data")
    else:
        raise ValueError(f"unknown archive format: {archive}")


def iter_image_list(list_path: str):
    """Yield (url, filename) from a per-image source list: a JSON of dicts
    carrying a url-ish key (nocaps `coco_url`, sbu `url`/`image_url`,
    optionally nested under 'images'), or a Conceptual-Captions-style TSV of
    `caption\\turl` rows."""
    import json

    if list_path.endswith(".tsv"):
        with open(list_path) as f:
            for i, line in enumerate(f):
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and parts[-1].startswith("http"):
                    yield parts[-1], f"{i:08d}.jpg"
        return
    with open(list_path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("images", data.get("annotations", []))
    for i, row in enumerate(data):
        if not isinstance(row, dict):
            continue
        url = next(
            (row[k] for k in ("coco_url", "url", "image_url") if row.get(k)),
            None,
        )
        if not url:
            continue
        fname = (
            row.get("file_name")
            or row.get("image")
            or os.path.basename(url.split("?")[0])
            or f"{i:08d}.jpg"
        )
        yield url, os.path.basename(fname)


def fetch_image_list(list_path: str, storage_dir: str, *,
                     max_items: Optional[int] = None,
                     _opener=None) -> Dict[str, int]:
    """Fetch every image of a per-image source list (the reference's
    nocaps/sbu download loops and the DownloadConceptualCaptions streamer).
    Per-item failures are tolerated and counted — dead links are normal in
    these corpora; existing files are skipped (resume)."""
    os.makedirs(storage_dir, exist_ok=True)
    done = failed = skipped = 0
    for n, (url, fname) in enumerate(iter_image_list(list_path)):
        if max_items is not None and n >= max_items:
            break
        dest = os.path.join(storage_dir, fname)
        if os.path.exists(dest):
            skipped += 1
            continue
        try:
            fetch_file(url, dest, _opener=_opener)
            done += 1
        except DownloadUnavailable:
            failed += 1
    return {"fetched": done, "skipped": skipped, "failed": failed}


def download_entry(entry: DownloadEntry, root: str, *,
                   url_override: Optional[str] = None,
                   dry_run: bool = False,
                   keep_archive: bool = False,
                   max_items: Optional[int] = None,
                   _opener=None) -> Optional[str]:
    """Fetch + verify + extract one manifest entry under
    `<root>/<dataset>/<storage>`. archive entries return the storage dir;
    per_image_json entries fetch the source list AND loop the per-image
    downloads into the storage dir (max_items bounds the loop), returning
    the storage dir; plain files return the downloaded path; dry runs
    return None. Manual entries raise ManualDownloadRequired with the
    recorded instructions unless url_override supplies a direct link."""
    url = url_override or entry.url
    if entry.kind == "manual" and url_override is None:
        raise ManualDownloadRequired(
            f"{entry.dataset}/{entry.name}: {entry.note or entry.url}"
        )
    storage_dir = os.path.join(root, entry.dataset, entry.storage)
    if dry_run:
        return None
    fname = os.path.basename(url.split("?")[0].rstrip("/")) or "download.bin"
    dl_dir = os.path.join(root, entry.dataset, "download")
    dest = os.path.join(dl_dir, fname)
    fetch_file(url, dest, _opener=_opener)
    if entry.md5 is not None:
        got = _md5(dest)
        if got != entry.md5:
            os.remove(dest)
            raise DownloadUnavailable(
                f"{entry.dataset}/{entry.name}: md5 mismatch "
                f"(got {got}, want {entry.md5}); corrupt file removed"
            )
    if entry.kind == "archive":
        _extract(dest, storage_dir)
        if not keep_archive:
            os.remove(dest)
        return storage_dir
    if entry.kind == "per_image_json":
        fetch_image_list(dest, storage_dir, max_items=max_items, _opener=_opener)
        return storage_dir
    return dest


def download_dataset(dataset: str, root: str, *, dry_run: bool = False,
                     skip_manual: bool = True, max_items: Optional[int] = None,
                     _opener=None) -> Dict[str, Optional[str]]:
    """Fetch every manifest entry of a dataset. With skip_manual (default),
    manual-flow entries are reported, not raised — the offline-safe
    behavior. Returns {entry_name: result_path | 'MANUAL: ...' | None}."""
    ents = entries_for(dataset)
    if not ents:
        raise KeyError(
            f"unknown dataset {dataset!r}; known: {', '.join(datasets())}"
        )
    out: Dict[str, Optional[str]] = {}
    for e in ents:
        try:
            out[e.name] = download_entry(
                e, root, dry_run=dry_run, max_items=max_items, _opener=_opener
            )
        except ManualDownloadRequired as m:
            if not skip_manual:
                raise
            out[e.name] = f"MANUAL: {m}"
    return out
