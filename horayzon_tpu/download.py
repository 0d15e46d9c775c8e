# Copyright (c) 2026
# MIT License
"""Download utilities for DEM tiles and auxiliary data.

Equivalent of reference ``horayzon/download.py`` (file download.py:15, files
:67, get_file :115): single-file download with a progress bar and parallel
multi-file download with a thread pool.  The interactive SSL-failure prompt
of the reference (download.py:34-47) is replaced by an ``ssl_verify``
argument so the function works in non-interactive (batch) jobs.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def file(file_url, path_local, ssl_verify=True):
    """Download a single file with a progress bar (download.py:15-64)."""
    import requests
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        tqdm = None
    response = requests.get(file_url, stream=True, verify=ssl_verify)
    response.raise_for_status()
    total = int(response.headers.get("content-length", 0))
    file_local = os.path.join(path_local, os.path.basename(
        file_url.split("?")[0]) or "download.bin")
    bar = tqdm(total=total, unit="iB", unit_scale=True) if tqdm else None
    with open(file_local, "wb") as f:
        for chunk in response.iter_content(chunk_size=1024 * 256):
            if bar is not None:
                bar.update(len(chunk))
            f.write(chunk)
    if bar is not None:
        bar.close()
    return file_local


def get_file(file_url, path_local, ssl_verify=True, retries=2):
    """Download one file without a progress bar (download.py:115-128);
    transient failures are retried ``retries`` times."""
    import requests
    last_exc = None
    for _ in range(retries + 1):
        try:
            response = requests.get(file_url, stream=True,
                                    verify=ssl_verify, timeout=60)
            response.raise_for_status()
            file_local = os.path.join(path_local, os.path.basename(
                file_url.split("?")[0]))
            with open(file_local, "wb") as f:
                for chunk in response.iter_content(chunk_size=1024 * 256):
                    f.write(chunk)
            return file_local
        except requests.RequestException as exc:
            last_exc = exc
    raise last_exc


def files(file_urls, path_local, mode="parallel", block_size=500,
          file_num=10, ssl_verify=True):
    """Download multiple files, optionally in parallel (download.py:67-112)."""
    if mode not in ("serial", "parallel"):
        raise ValueError("invalid value for 'mode'")
    if mode == "serial":
        for url in file_urls:
            get_file(url, path_local, ssl_verify=ssl_verify)
        return
    blocks = np.array_split(np.asarray(file_urls),
                            max(1, len(file_urls) // block_size + 1))
    for block in blocks:
        with ThreadPoolExecutor(max_workers=file_num) as executor:
            futures = [executor.submit(get_file, url, path_local,
                                       ssl_verify=ssl_verify)
                       for url in block]
            for fut in futures:
                fut.result()
