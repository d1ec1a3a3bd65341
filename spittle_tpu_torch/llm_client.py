"""LLM post-processing client (OpenAI-compatible chat completions).

Port of spittle_tpu/llm_client.py.

Behavior-parity port of `src-tauri/src/llm_client.rs`:
POST {base_url}/chat/completions with optional system message, Anthropic
auth special-casing (x-api-key + anthropic-version instead of Bearer), and
GET {base_url}{models_endpoint} for model listing. Uses urllib (stdlib);
transport is injectable for tests and for the desktop shell.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Callable, List, Optional

from spittle_tpu_torch.config.settings import PostProcessProvider

USER_AGENT = "SpittleTPU/1.0"


def build_headers(provider: PostProcessProvider, api_key: str) -> dict:
    headers = {
        "Content-Type": "application/json",
        "Referer": "https://github.com/tchamp1912/Spittle",
        "User-Agent": USER_AGENT,
        "X-Title": "Spittle",
    }
    if api_key:
        if provider.id == "anthropic":
            headers["x-api-key"] = api_key
            headers["anthropic-version"] = "2023-06-01"
        else:
            headers["Authorization"] = f"Bearer {api_key}"
    return headers


def _default_transport(url: str, headers: dict, body: Optional[bytes], timeout: float):
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def send_chat_completion(
    provider: PostProcessProvider,
    api_key: str,
    model: str,
    prompt: str,
    system_message: Optional[str] = None,
    timeout: float = 60.0,
    transport: Callable = _default_transport,
) -> Optional[str]:
    """Returns the first choice's content, or None if the response had none.
    Raises RuntimeError on HTTP/parse errors (callers fall back to the raw
    transcription, pipeline.rs:888-899)."""
    url = provider.base_url.rstrip("/") + "/chat/completions"
    messages = []
    if system_message:
        messages.append({"role": "system", "content": system_message})
    messages.append({"role": "user", "content": prompt})
    body = json.dumps({"model": model, "messages": messages}).encode()
    try:
        status, raw = transport(url, build_headers(provider, api_key), body, timeout)
    except urllib.error.HTTPError as e:
        raise RuntimeError(
            f"API request failed with status {e.code}: {e.read()[:500]!r}"
        ) from e
    except Exception as e:
        raise RuntimeError(f"HTTP request failed: {e}") from e
    if status // 100 != 2:
        raise RuntimeError(f"API request failed with status {status}")
    try:
        data = json.loads(raw)
        choices = data.get("choices") or []
        if not choices:
            return None
        return choices[0].get("message", {}).get("content")
    except (json.JSONDecodeError, AttributeError) as e:
        raise RuntimeError(f"Failed to parse API response: {e}") from e


def fetch_models(
    provider: PostProcessProvider,
    api_key: str,
    timeout: float = 30.0,
    transport: Callable = _default_transport,
) -> List[str]:
    if not provider.models_endpoint:
        return []
    url = provider.base_url.rstrip("/") + provider.models_endpoint
    try:
        status, raw = transport(url, build_headers(provider, api_key), None, timeout)
    except Exception as e:
        raise RuntimeError(f"HTTP request failed: {e}") from e
    if status // 100 != 2:
        raise RuntimeError(f"API request failed with status {status}")
    data = json.loads(raw)
    items = data.get("data", data if isinstance(data, list) else [])
    out = []
    for item in items:
        mid = item.get("id") if isinstance(item, dict) else None
        if mid:
            out.append(mid)
    return out
