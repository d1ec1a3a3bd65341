"""Model catalog: available engines, sizes, language groups.

Port of spittle_tpu/config/catalog.py.

Port of the reference's catalog loader (`src-tauri/src/
managers/model_catalog.rs`) over the same embedded JSON data
(`src-tauri/resources/model_catalog.json` mirrored at data/model_catalog.json):
9 models across the whisper/parakeet/moonshine/sense_voice engines with
speed/accuracy scores and language groups.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

_DATA = os.path.join(os.path.dirname(__file__), "data", "model_catalog.json")


@dataclass
class ModelCatalogEntry:
    id: str
    name: str
    description: str
    filename: str
    url: str
    size_mb: int
    is_directory: bool
    engine_type: str  # whisper | parakeet | moonshine | sense_voice
    accuracy_score: float
    speed_score: float
    supports_translation: bool
    is_recommended: bool
    language_group: str


@dataclass
class ModelCatalog:
    language_groups: Dict[str, List[str]]
    models: List[ModelCatalogEntry]

    def by_id(self, model_id: str) -> Optional[ModelCatalogEntry]:
        for m in self.models:
            if m.id == model_id:
                return m
        return None

    def languages_for(self, entry: ModelCatalogEntry) -> List[str]:
        return self.language_groups.get(entry.language_group, [])


def load_model_catalog(path: Optional[str] = None) -> ModelCatalog:
    with open(path or _DATA, encoding="utf-8") as f:
        raw = json.load(f)
    return ModelCatalog(
        language_groups=raw["language_groups"],
        models=[ModelCatalogEntry(**m) for m in raw["models"]],
    )
