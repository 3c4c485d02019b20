"""Where a checkpoint file is found.

A copy of ``audio_metrics_tpu/utils/get_url.py`` (:21-65), with the same
environment variables and the same meaning, so that one provisioned
checkpoint serves both packages: the cache directory is
``$AM_TPU_CACHE_DIR``, else ``$XDG_CACHE_HOME/audio_metrics_tpu``, else
``~/.cache/audio_metrics_tpu``; ``$AM_TPU_CKPT_DIR`` holds provisioned
checkpoints on hosts without network access.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from urllib import request

__all__ = ["cache_dir", "download_url", "resolve_checkpoint"]

logger = logging.getLogger(__name__)


def cache_dir() -> Path:
    env = os.environ.get("AM_TPU_CACHE_DIR")
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base / "audio_metrics_tpu"


def resolve_checkpoint(src: str) -> str | None:
    """A local path for the checkpoint URL or path ``src``, searched in
    order: ``src`` itself; ``$AM_TPU_CKPT_DIR/<basename>``; the cache; a
    download into the cache.  None when none of them gives one: the caller
    decides whether that is fatal (the embedders raise unless random
    weights were asked for)."""
    name = src.rsplit("/", maxsplit=1)[-1]
    if Path(src).exists():
        return str(src)
    ckpt_dir = os.environ.get("AM_TPU_CKPT_DIR")
    if ckpt_dir and (Path(ckpt_dir) / name).exists():
        return (Path(ckpt_dir) / name).as_posix()
    if (cache_dir() / name).exists():
        return (cache_dir() / name).as_posix()
    try:
        return download_url(src)
    except Exception as exc:
        logger.warning("checkpoint %s unavailable: %s", name, exc)
        return None


def download_url(url: str) -> str:
    """A local path for ``url``, downloaded into the cache once."""
    name = url.rsplit("/", maxsplit=1)[-1]
    fp = cache_dir() / name
    if not fp.exists():
        fp.parent.mkdir(parents=True, exist_ok=True)
        logger.info("Downloading %s to %s", url, fp)
        tmp = fp.with_suffix(fp.suffix + ".part")
        try:
            request.urlretrieve(url, filename=tmp)
            tmp.replace(fp)
        except Exception as exc:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"Error downloading {url}") from exc
    return fp.as_posix()
