"""Workspace-root resolution for @file expansion.

Port of spittle_tpu/app/context_providers.py.

Behavior-parity port of `src-tauri/src/context_providers.rs`:
frontmost-app detection routes to the Cursor/VS Code extension's cache file
(`cursor_context.json` with workspaceRoots) or a terminal context file
(`terminal_context.json` with cwd), falling back to the MRU
`recent_workspace_roots` from settings; `update_mru` keeps a 5-entry MRU.
Platform probes (osascript) are injectable for tests and non-macOS hosts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, List, Optional

from spittle_tpu_torch.config.settings import AppSettings

TERMINAL_MARKERS = ("iterm2", "terminal", "warp", "wezterm", "alacritty", "kitty")
MRU_LIMIT = 5


def cache_dir(home: Optional[str] = None) -> str:
    home = home or os.path.expanduser("~")
    if sys.platform == "darwin":
        return os.path.join(home, "Library", "Caches", "spittle")
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.join(home, ".cache")), "spittle"
    )


def _read_json(path: str):
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def get_cursor_workspace(home: Optional[str] = None) -> Optional[str]:
    """First workspaceRoots entry from the Cursor extension's cache file."""
    data = _read_json(os.path.join(cache_dir(home), "cursor_context.json"))
    if not data:
        return None
    roots = data.get("workspaceRoots") or []
    if roots and os.path.isdir(roots[0]):
        return roots[0]
    return None


def get_terminal_context_cwd(home: Optional[str] = None) -> Optional[str]:
    data = _read_json(os.path.join(cache_dir(home), "terminal_context.json"))
    if not data:
        return None
    cwd = data.get("cwd")
    return cwd if cwd and os.path.isdir(cwd) else None


def is_terminal_bundle_id(bundle_id: str) -> bool:
    lower = bundle_id.lower()
    return any(m in lower for m in TERMINAL_MARKERS)


def _frontmost_bundle_id_macos() -> Optional[str]:
    try:
        out = subprocess.run(
            ["osascript", "-e",
             'tell application "System Events" to get bundle identifier of '
             "first application process whose frontmost is true"],
            capture_output=True, timeout=2,
        )
        if out.returncode == 0:
            s = out.stdout.decode().strip()
            return s or None
    except Exception:
        pass
    return None


def get_workspace_root(
    settings: AppSettings,
    frontmost_bundle_id: Optional[Callable[[], Optional[str]]] = None,
    home: Optional[str] = None,
) -> Optional[str]:
    probe = frontmost_bundle_id or (
        _frontmost_bundle_id_macos if sys.platform == "darwin" else lambda: None
    )
    bundle_id = probe()
    if bundle_id:
        if "Cursor" in bundle_id or "vscode" in bundle_id.lower():
            root = get_cursor_workspace(home)
            if root:
                return root
        if is_terminal_bundle_id(bundle_id):
            cwd = get_terminal_context_cwd(home)
            if cwd:
                return cwd
    for root in settings.recent_workspace_roots:
        if os.path.isdir(root):
            return root
    return None


def update_mru(roots: List[str], workspace_root: str) -> List[str]:
    """Pure MRU update: move/insert at front, cap at 5 entries."""
    roots = [r for r in roots if r != workspace_root]
    roots.insert(0, workspace_root)
    return roots[:MRU_LIMIT]


# -- context writers (the Cursor extension / terminal hook's role) ----------
# The reference ships a VS Code/Cursor extension (extensions/cursor-context)
# that writes workspaceRoots into the cache file this module reads. These
# writers are the editor/terminal-side counterpart for environments where a
# shell hook or editor plugin integrates directly with the framework.


def write_cursor_context(workspace_roots: List[str], home: Optional[str] = None) -> str:
    path = os.path.join(cache_dir(home), "cursor_context.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"workspaceRoots": list(workspace_roots)}, f)
    os.replace(tmp, path)
    return path


def write_terminal_context(cwd: str, home: Optional[str] = None) -> str:
    path = os.path.join(cache_dir(home), "terminal_context.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"cwd": cwd}, f)
    os.replace(tmp, path)
    return path
