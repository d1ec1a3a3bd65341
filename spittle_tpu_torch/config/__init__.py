"""Settings and the model catalog (port of spittle_tpu/config)."""

from .settings import AppSettings, SettingsStore, get_default_settings
from .catalog import ModelCatalogEntry, load_model_catalog

__all__ = [
    "AppSettings",
    "SettingsStore",
    "get_default_settings",
    "ModelCatalogEntry",
    "load_model_catalog",
]
