"""Apple Intelligence FFI client: ctypes over the Swift shim dylib.

Port of spittle_tpu/shell/apple_llm.py.

The reference links a Swift shim exposing a 3-symbol C ABI
(`src-tauri/src/apple_intelligence.rs:13-20`) over Apple's
FoundationModels on-device LLM, with safe wrappers enforcing the
response-ownership contract (`apple_intelligence.rs:23-60`). This module
is the same client rebuilt on ctypes: it loads a dylib built from
``native/apple_intelligence.swift`` (see ``native/build_apple_llm.sh``)
and exposes the identical availability/process/free semantics.

ABI contract (must match the Swift ``@_cdecl`` exports):

    struct AppleLLMResponse { char *response; int success; char *error_message; };
    int  is_apple_intelligence_available(void);
    AppleLLMResponse *process_text_with_apple_llm(const char *prompt, int32_t max_tokens);
    void free_apple_llm_response(AppleLLMResponse *);

All strings inside the response are owned by the dylib (strdup'd on the
Swift side) and MUST be released through ``free_apple_llm_response`` —
never through the process allocator — so the struct fields are declared
``POINTER(c_char)`` (a bare ``c_char_p`` field would eagerly copy to a
Python bytes and lose the pointer identity the free call needs).

The JAX package's copy is tested against a from-scratch C fake dylib
compiled in-test (tests/test_apple_llm.py): argtypes/ownership bugs
surface as crashes or leak-counter failures in the test process, not on a
user's Mac.
"""
from __future__ import annotations

import ctypes
import os
import sys
from ctypes import POINTER, Structure, c_char, c_char_p, c_int, c_int32
from typing import Optional

DYLIB_ENV = "SPITTLE_APPLE_LLM_DYLIB"
_DYLIB_NAME = "libspittle_apple_llm.dylib"


class AppleLLMResponse(Structure):
    """Mirror of the Swift-side response struct (apple_intelligence.rs:5-10)."""

    _fields_ = [
        ("response", POINTER(c_char)),
        ("success", c_int),
        ("error_message", POINTER(c_char)),
    ]


class AppleLLMError(RuntimeError):
    """Raised when the on-device model reports failure (Err path of
    apple_intelligence.rs:27-60)."""


def _read_cstr(ptr) -> Optional[str]:
    if not ptr:
        return None
    raw = ctypes.cast(ptr, c_char_p).value
    return None if raw is None else raw.decode("utf-8", "replace")


def load_library(path: str) -> ctypes.CDLL:
    """Load the shim and pin the ABI (argtypes/restype on every symbol —
    the libX11 lesson: a 64-bit pointer defaulting to int is an instant
    segfault on real hardware)."""
    lib = ctypes.CDLL(path)
    lib.is_apple_intelligence_available.argtypes = []
    lib.is_apple_intelligence_available.restype = c_int
    lib.process_text_with_apple_llm.argtypes = [c_char_p, c_int32]
    lib.process_text_with_apple_llm.restype = POINTER(AppleLLMResponse)
    lib.free_apple_llm_response.argtypes = [POINTER(AppleLLMResponse)]
    lib.free_apple_llm_response.restype = None
    return lib


class AppleLLM:
    """Safe wrapper with the reference's exact result semantics
    (apple_intelligence.rs:23-60)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def available(self) -> bool:
        return self._lib.is_apple_intelligence_available() == 1

    def process_text(self, prompt: str, token_limit: int = 0) -> str:
        # CString::new rejects interior NULs (apple_intelligence.rs:28);
        # ctypes would silently truncate, so reject explicitly.
        if "\x00" in prompt:
            raise AppleLLMError("prompt contains an interior NUL byte")
        ptr = self._lib.process_text_with_apple_llm(
            prompt.encode("utf-8"), int(token_limit)
        )
        if not ptr:
            raise AppleLLMError("Null response from Apple LLM")
        try:
            resp = ptr.contents
            if resp.success == 1:
                return _read_cstr(resp.response) or ""
            raise AppleLLMError(_read_cstr(resp.error_message) or "Unknown error")
        finally:
            # Ownership returns to the dylib in every branch (:57).
            self._lib.free_apple_llm_response(ptr)


def _candidate_paths():
    env = os.environ.get(DYLIB_ENV)
    if env:
        yield env
        return  # an explicit path is authoritative; no fallback probing
    pkg_native = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
    )
    # The repo's native/, then the system and Apple-silicon Homebrew lib dirs.
    homebrew_lib = os.path.join(os.sep, "opt", "homebrew", "lib")
    for base in (pkg_native, "/usr/local/lib", homebrew_lib):
        yield os.path.join(base, _DYLIB_NAME)


_client: Optional[AppleLLM] = None
_client_resolved = False


def default_client() -> Optional[AppleLLM]:
    """The process-wide client, or None where the shim can't exist.

    Platform gate mirrors the reference's compile-time cfg
    (pipeline.rs:815-816, macOS+aarch64 only); SPITTLE_APPLE_LLM_DYLIB
    overrides it so the binding is testable against a fake dylib on any
    OS.
    """
    global _client, _client_resolved
    if _client_resolved:
        return _client
    _client_resolved = True
    if DYLIB_ENV not in os.environ and not (
        sys.platform == "darwin" and os.uname().machine == "arm64"
    ):
        return None
    for path in _candidate_paths():
        try:
            _client = AppleLLM(load_library(path))
            return _client
        except OSError:
            continue
    return None


def reset_default_client() -> None:
    """Drop the cached client (tests; dylib path changes at runtime)."""
    global _client, _client_resolved
    _client = None
    _client_resolved = False
