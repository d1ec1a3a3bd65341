"""Model manager: catalog, downloads with resume, extraction, discovery.

Port of spittle_tpu/managers/model.py.

Behavior-parity rebuild of `src-tauri/src/managers/
model.rs`: HTTP Range-resume downloads into `.partial` files with
cancellation flags and progress events throttled to 10/s (:384-576,
restart-on-200 safety :412-462), tar.gz extraction through an atomic
`.extracting` temp dir (:617-705), custom `.bin` model auto-discovery
(:265-382), interrupted-extraction cleanup (:183-192), and auto-selection
of the first downloaded model (:223-263).
"""

from __future__ import annotations

import os
import shutil
import tarfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from spittle_tpu_torch.config.catalog import ModelCatalog, ModelCatalogEntry, load_model_catalog
from spittle_tpu_torch.events import (
    EventBus,
    MODEL_DELETED,
    MODEL_DOWNLOAD_CANCELLED,
    MODEL_DOWNLOAD_COMPLETE,
    MODEL_DOWNLOAD_PROGRESS,
    MODEL_EXTRACTION_COMPLETED,
    MODEL_EXTRACTION_FAILED,
    MODEL_EXTRACTION_STARTED,
)

PROGRESS_THROTTLE_S = 0.1  # <=10 events/s (model.rs:516-518)
CHUNK_SIZE = 256 * 1024


def _download_progress(model_id, downloaded, total, final=False):
    """DownloadProgress wire shape (model.rs:50-55): model_id/downloaded/
    total/percentage, percentage in 0-100 (0 when total is unknown,
    except the final event which reports 100 like model.rs:579-588)."""
    total = int(total) if total else 0
    if total > 0:
        percentage = downloaded / total * 100.0
    else:
        percentage = 100.0 if final else 0.0
    return {
        "model_id": model_id,
        "downloaded": int(downloaded),
        "total": total,
        "percentage": percentage,
    }


@dataclass
class ModelInfo:
    id: str
    name: str
    engine_type: str
    path: str
    is_downloaded: bool
    is_custom: bool = False
    size_mb: int = 0
    description: str = ""


class ModelManager:
    def __init__(
        self,
        models_dir: str,
        catalog: Optional[ModelCatalog] = None,
        events: Optional[EventBus] = None,
        selected_model_getter: Optional[Callable[[], str]] = None,
        selected_model_setter: Optional[Callable[[str], None]] = None,
    ):
        self.models_dir = models_dir
        os.makedirs(models_dir, exist_ok=True)
        self.catalog = catalog or load_model_catalog()
        self.events = events or EventBus()
        self._cancel_flags: Dict[str, threading.Event] = {}
        self._get_selected = selected_model_getter or (lambda: "")
        self._set_selected = selected_model_setter or (lambda mid: None)
        self._cleanup_interrupted_extractions()
        self._auto_select_first_downloaded()

    # -- paths & status --------------------------------------------------

    def model_path(self, entry: ModelCatalogEntry) -> str:
        return os.path.join(self.models_dir, entry.filename)

    def is_downloaded(self, model_id: str) -> bool:
        entry = self.catalog.by_id(model_id)
        if entry is None:
            return os.path.exists(os.path.join(self.models_dir, model_id))
        return os.path.exists(self.model_path(entry))

    def get_model_path(self, model_id: str) -> Optional[str]:
        entry = self.catalog.by_id(model_id)
        if entry is not None:
            p = self.model_path(entry)
            return p if os.path.exists(p) else None
        custom = os.path.join(self.models_dir, model_id)
        return custom if os.path.exists(custom) else None

    def get_available_models(self) -> List[ModelInfo]:
        """Catalog models + custom .bin files discovered on disk
        (model.rs:265-382)."""
        out = []
        catalog_files = set()
        for entry in self.catalog.models:
            catalog_files.add(entry.filename)
            out.append(
                ModelInfo(
                    id=entry.id,
                    name=entry.name,
                    engine_type=entry.engine_type,
                    path=self.model_path(entry),
                    is_downloaded=os.path.exists(self.model_path(entry)),
                    size_mb=entry.size_mb,
                    description=entry.description,
                )
            )
        for fname in sorted(os.listdir(self.models_dir)):
            if (
                fname.endswith(".bin")
                and fname not in catalog_files
                and not fname.endswith(".partial")
            ):
                out.append(
                    ModelInfo(
                        id=fname,
                        name=os.path.splitext(fname)[0],
                        engine_type="whisper",
                        path=os.path.join(self.models_dir, fname),
                        is_downloaded=True,
                        is_custom=True,
                    )
                )
        return out

    # -- download --------------------------------------------------------

    def download_model(self, model_id: str, url: Optional[str] = None) -> str:
        """Blocking download with Range resume; returns final path."""
        entry = self.catalog.by_id(model_id)
        if entry is None:
            raise KeyError(f"unknown model {model_id}")
        url = url or entry.url
        final_path = self.model_path(entry)
        dl_target = final_path + (".tar.gz" if entry.is_directory else "")
        partial = dl_target + ".partial"
        cancel = self._cancel_flags.setdefault(model_id, threading.Event())
        cancel.clear()

        resume_from = os.path.getsize(partial) if os.path.exists(partial) else 0
        req = urllib.request.Request(url)
        if resume_from:
            req.add_header("Range", f"bytes={resume_from}-")

        try:
            resp = urllib.request.urlopen(req, timeout=30)
        except urllib.error.HTTPError as e:
            if e.code == 416:  # range beyond EOF: restart clean
                os.remove(partial)
                return self.download_model(model_id, url)
            raise

        # 200 despite a Range request means the server restarted the body
        # (model.rs:412-462): discard the partial.
        mode = "ab"
        if resume_from and resp.status == 200:
            resume_from = 0
            mode = "wb"
        total = resp.headers.get("Content-Length")
        total = (int(total) + resume_from) if total else None

        written = resume_from
        last_emit = 0.0
        # Initial event so the UI shows the bar immediately (model.rs:502-514).
        self.events.emit(
            MODEL_DOWNLOAD_PROGRESS, _download_progress(model_id, written, total)
        )
        with open(partial, mode) as f:
            while True:
                if cancel.is_set():
                    resp.close()
                    # Reference payload is the bare model_id string
                    # (model.rs:875; modelStore.ts listen<string>).
                    self.events.emit(MODEL_DOWNLOAD_CANCELLED, model_id)
                    raise InterruptedError(f"download of {model_id} cancelled")
                chunk = resp.read(CHUNK_SIZE)
                if not chunk:
                    break
                f.write(chunk)
                written += len(chunk)
                now = time.monotonic()
                if now - last_emit >= PROGRESS_THROTTLE_S:
                    last_emit = now
                    self.events.emit(
                        MODEL_DOWNLOAD_PROGRESS,
                        _download_progress(model_id, written, total),
                    )
        # Final event so 100% is always shown (model.rs:579-592).
        self.events.emit(
            MODEL_DOWNLOAD_PROGRESS,
            _download_progress(model_id, written, total, final=True),
        )
        os.replace(partial, dl_target)

        if entry.is_directory:
            self._extract_archive(model_id, dl_target, final_path)
            os.remove(dl_target)

        self.events.emit(MODEL_DOWNLOAD_COMPLETE, model_id)
        if not self._get_selected():
            self._set_selected(model_id)
        return final_path

    def cancel_download(self, model_id: str) -> None:
        flag = self._cancel_flags.get(model_id)
        if flag is not None:
            flag.set()

    # -- extraction ------------------------------------------------------

    def _extract_archive(self, model_id: str, archive: str, dest: str) -> None:
        """tar.gz -> `.extracting` temp dir -> atomic rename (:617-705)."""
        tmp = dest + ".extracting"
        self.events.emit(MODEL_EXTRACTION_STARTED, model_id)
        try:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with tarfile.open(archive, "r:gz") as tar:
                tar.extractall(tmp, filter="data")
            # If the tar holds a single top-level dir, promote its contents.
            entries = os.listdir(tmp)
            src = tmp
            if len(entries) == 1 and os.path.isdir(os.path.join(tmp, entries[0])):
                src = os.path.join(tmp, entries[0])
            if os.path.exists(dest):
                shutil.rmtree(dest)
            os.replace(src, dest)
            if src != tmp and os.path.exists(tmp):
                shutil.rmtree(tmp)
            self.events.emit(MODEL_EXTRACTION_COMPLETED, model_id)
        except Exception as e:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
            self.events.emit(
                MODEL_EXTRACTION_FAILED, {"model_id": model_id, "error": str(e)}
            )
            raise

    def _cleanup_interrupted_extractions(self) -> None:
        for fname in os.listdir(self.models_dir):
            if fname.endswith(".extracting"):
                shutil.rmtree(os.path.join(self.models_dir, fname),
                              ignore_errors=True)

    # -- delete / select -------------------------------------------------

    def delete_model(self, model_id: str) -> None:
        path = self.get_model_path(model_id)
        if path is None:
            return
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
        if self._get_selected() == model_id:
            self._set_selected("")
        self.events.emit(MODEL_DELETED, model_id)
        self._auto_select_first_downloaded()

    def _auto_select_first_downloaded(self) -> None:
        if self._get_selected():
            return
        for info in self.get_available_models():
            if info.is_downloaded:
                self._set_selected(info.id)
                return
