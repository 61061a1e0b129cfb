"""Checkpoint manifests and atomic file primitives (the port's own copy of
``deepspeed_tpu/runtime/checkpoint_engine/manifest.py``, standard library
only, so a manifest written by either package verifies in both and
``tools/verify_checkpoint.py`` checks a port checkpoint unchanged).

A checkpoint is only as trustworthy as the cheapest way to prove its
bytes are whole.  Every atomic save writes a ``MANIFEST.json`` into the
tag dir recording, per regular file, its size and CRC-32 — written last,
fsynced, and only then is the staging dir renamed into place, so the
manifest's presence certifies "every byte below me was durable before I
existed".  ``verify_manifest`` replays the walk at load (and offline via
``tools/verify_checkpoint.py``): a missing file, short file, or checksum
mismatch turns into a rollback instead of a mid-restore crash.

CRC-32 (zlib) rather than a cryptographic hash on purpose: the threat
model is torn writes and storage rot, not adversaries, and checkpoint
dirs reach hundreds of GB — checksum throughput matters.
"""

import json
import os
import zlib
from typing import Any, Dict, Optional, Tuple

MANIFEST_FILE = "MANIFEST.json"
MANIFEST_VERSION = 1

_CHUNK = 1 << 20


def crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def fsync_dir(path: str):
    """Durability for the directory entry itself (the rename / new file
    is only crash-safe once the parent dir is synced)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str):
    """Crash-safe small-file write: tmp sibling + fsync + ``os.replace``
    + parent-dir fsync.  A crash at any point leaves either the old
    content or the new — never a truncated pointer."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, obj: Any):
    atomic_write_text(path, json.dumps(obj, sort_keys=True))


def _walk_files(ckpt_dir: str):
    """(relpath, abspath) for every regular file, deterministic order,
    skipping the manifest itself and tmp droppings."""
    for root, dirs, names in sorted(os.walk(ckpt_dir)):
        dirs.sort()
        for name in sorted(names):
            rel = os.path.relpath(os.path.join(root, name), ckpt_dir)
            if rel == MANIFEST_FILE or rel.endswith(".tmp"):
                continue
            yield rel, os.path.join(root, name)


def write_manifest(ckpt_dir: str,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Checksum every file under ``ckpt_dir`` (fsyncing each so the data
    the checksum vouches for is actually on disk) and atomically write
    ``MANIFEST.json``.  Returns the manifest dict."""
    files = []
    total = 0
    for rel, path in _walk_files(ckpt_dir):
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass
        size = os.path.getsize(path)
        files.append({"path": rel, "bytes": size, "crc32": crc32_file(path)})
        total += size
    manifest = {
        "version": MANIFEST_VERSION,
        "file_count": len(files),
        "total_bytes": total,
        "files": files,
        "meta": dict(extra or {}),
    }
    atomic_write_json(os.path.join(ckpt_dir, MANIFEST_FILE), manifest)
    fsync_dir(ckpt_dir)
    return manifest


def verify_manifest(ckpt_dir: str, deep: bool = True) -> Dict[str, Any]:
    """Validate ``ckpt_dir`` against its manifest.

    Returns a report dict with ``status`` one of:

    * ``"verified"``    — every listed file present, sized, and (``deep``)
      checksum-matched;
    * ``"corrupt"``     — at least one mismatch (see ``errors``);
    * ``"no_manifest"`` — a pre-manifest (legacy) checkpoint: nothing to
      verify against, callers decide whether to trust it.
    """
    report: Dict[str, Any] = {"dir": ckpt_dir, "status": "verified",
                              "checked": 0, "errors": [], "extra_files": []}
    mpath = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.isfile(mpath):
        report["status"] = "no_manifest"
        return report
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        report["status"] = "corrupt"
        report["errors"].append({"path": MANIFEST_FILE,
                                 "error": f"unreadable manifest: {e}"})
        return report

    listed = set()
    for entry in manifest.get("files", []):
        rel = entry["path"]
        listed.add(rel)
        path = os.path.join(ckpt_dir, rel)
        report["checked"] += 1
        if not os.path.isfile(path):
            report["errors"].append({"path": rel, "error": "missing"})
            continue
        size = os.path.getsize(path)
        if size != entry["bytes"]:
            report["errors"].append({"path": rel, "error": "size_mismatch",
                                     "expected": entry["bytes"],
                                     "actual": size})
            continue
        if deep:
            crc = crc32_file(path)
            if crc != entry["crc32"]:
                report["errors"].append({"path": rel,
                                         "error": "checksum_mismatch",
                                         "expected": entry["crc32"],
                                         "actual": crc})
    # files on disk the manifest never promised: reported, not fatal
    report["extra_files"] = [rel for rel, _ in _walk_files(ckpt_dir)
                             if rel not in listed]
    if report["errors"]:
        report["status"] = "corrupt"
    report["manifest_meta"] = manifest.get("meta", {})
    return report


def manifest_ok(ckpt_dir: str, deep: bool = True) -> Tuple[bool, Dict[str, Any]]:
    """(ok, report) convenience: ``no_manifest`` counts as ok (legacy
    checkpoints predate verification and must stay loadable)."""
    report = verify_manifest(ckpt_dir, deep=deep)
    return report["status"] != "corrupt", report
