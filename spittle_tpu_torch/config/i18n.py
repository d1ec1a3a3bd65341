"""App-wide localization table: 17 locales, full UI string tree.

Port of spittle_tpu/config/i18n.py.

`data/app_i18n.json` bundles the reference's per-locale translation
files (reference `src/i18n/locales/<locale>/translation.json`, loaded by
`src/i18n/index.ts`) as parity data — the strings ARE the behavioral
spec for a localized surface. Locale resolution mirrors the reference's
i18next fallback chain (`src/i18n/index.ts`: exact match, then language
code, then English) and the tray's zh-TW preservation rule
(`tray_i18n.rs:22-36`).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Any, Dict, Optional

_PATH = os.path.join(os.path.dirname(__file__), "data", "app_i18n.json")


@lru_cache(maxsize=1)
def load_app_i18n() -> Dict[str, Dict[str, Any]]:
    """The full {locale: nested-string-tree} table."""
    with open(_PATH, encoding="utf-8") as f:
        return json.load(f)


def available_locales() -> list:
    return sorted(load_app_i18n().keys())


def get_language_code(locale: str) -> str:
    for sep in ("-", "_"):
        if sep in locale:
            return locale.split(sep)[0]
    return locale


def get_locale_table(locale: Optional[str] = None) -> Dict[str, Any]:
    """Resolve a locale to its string tree: exact match (preserves
    zh-TW), then language code, then English."""
    table = load_app_i18n()
    if locale and locale in table:
        return table[locale]
    lang = get_language_code(locale) if locale else "en"
    return table.get(lang, table["en"])


def translate(key: str, locale: Optional[str] = None) -> str:
    """Dot-path lookup ("tray.settings") with English fallback; returns
    the key itself when untranslated (i18next parseMissingKeyHandler)."""
    for tree in (get_locale_table(locale), load_app_i18n()["en"]):
        node: Any = tree
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                node = None
                break
            node = node[part]
        if isinstance(node, str):
            return node
    return key
