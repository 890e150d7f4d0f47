"""Storage helpers: local paths, hdfs:// through the hdfs CLI and gs://
through gsutil (port of efficientvlm_tpu/utils/io.py, the reference's
utils/hdfs_io.py). A path without a scheme is a local path.
"""

from __future__ import annotations

import glob as _glob
import os
import subprocess
from contextlib import contextmanager
from typing import IO, Iterator, List

HDFS_BIN = "hdfs"


def _is_hdfs(path: str) -> bool:
    return path.startswith("hdfs://")


def _is_gcs(path: str) -> bool:
    return path.startswith("gs://")


@contextmanager
def hopen(path: str, mode: str = "r") -> Iterator[IO]:
    """Streaming open for local/hdfs paths (reference hopen,
    hdfs_io.py:24-53)."""
    if _is_hdfs(path):
        if "r" in mode:
            pipe = subprocess.Popen([HDFS_BIN, "dfs", "-text", path], stdout=subprocess.PIPE)
            yield pipe.stdout  # type: ignore[misc]
            pipe.stdout.close()  # type: ignore[union-attr]
            pipe.wait()
        else:
            flag = "-appendToFile" if "a" in mode else "-put"
            pipe = subprocess.Popen([HDFS_BIN, "dfs", flag, "-", path], stdin=subprocess.PIPE)
            yield pipe.stdin  # type: ignore[misc]
            pipe.stdin.close()  # type: ignore[union-attr]
            pipe.wait()
        return
    f = open(path, mode)
    try:
        yield f
    finally:
        f.close()


def hlist_files(folders: List[str]) -> List[str]:
    """reference hlist_files (hdfs_io.py:56-80)."""
    files: List[str] = []
    for folder in folders:
        if _is_hdfs(folder):
            out = subprocess.run(
                [HDFS_BIN, "dfs", "-ls", folder], capture_output=True, text=True
            ).stdout
            files.extend(line.split()[-1] for line in out.splitlines() if line.startswith("-") or line.startswith("d"))
        elif _is_gcs(folder):
            out = subprocess.run(
                ["gsutil", "ls", folder.rstrip("/") + "/"],
                capture_output=True, text=True,
            ).stdout
            files.extend(line.strip() for line in out.splitlines() if line.strip())
        elif os.path.isdir(folder):
            files.extend(os.path.join(folder, f) for f in sorted(os.listdir(folder)))
        else:
            files.extend(sorted(_glob.glob(folder)))
    return files


def hexists(path: str) -> bool:
    if _is_hdfs(path):
        return subprocess.run([HDFS_BIN, "dfs", "-test", "-e", path]).returncode == 0
    if _is_gcs(path):
        return subprocess.run(["gsutil", "-q", "stat", path]).returncode == 0
    return os.path.exists(path)


def hmkdir(path: str) -> bool:
    if _is_hdfs(path):
        subprocess.run([HDFS_BIN, "dfs", "-mkdir", "-p", path])
        return True
    if _is_gcs(path):
        return True  # object store: no directories to create
    os.makedirs(path, exist_ok=True)
    return True


def hcopy(src: str, dst: str) -> bool:
    if _is_hdfs(dst):
        subprocess.run([HDFS_BIN, "dfs", "-put", "-f", src, dst])
    elif _is_hdfs(src):
        subprocess.run([HDFS_BIN, "dfs", "-get", src, dst])
    elif _is_gcs(src) or _is_gcs(dst):
        subprocess.run(["gsutil", "cp", src, dst])
    else:
        import shutil

        shutil.copy(src, dst)
    return True


def hremove(path: str) -> bool:
    """Delete a file on local/HDFS/GCS (checkpoint rotation)."""
    if _is_hdfs(path):
        subprocess.run([HDFS_BIN, "dfs", "-rm", path])
    elif _is_gcs(path):
        subprocess.run(["gsutil", "rm", path])
    else:
        try:
            os.remove(path)
        except FileNotFoundError:
            return False
    return True


def hcountline(path: str) -> int:
    count = 0
    with hopen(path, "r") as f:
        for _ in f:
            count += 1
    return count
