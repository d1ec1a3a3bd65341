"""Windows output mute: IAudioEndpointVolume over raw COM vtables.

Port of spittle_tpu/shell/windows_audio.py.

The reference mutes system output while recording via the Core Audio
COM chain — CoInitializeEx, CoCreateInstance(MMDeviceEnumerator),
GetDefaultAudioEndpoint(eRender, eMultimedia), Activate
IAudioEndpointVolume, SetMute — failing silently at every step
(src-tauri/src/managers/audio.rs:17-104, the `unwrap_or_return!`
ladder). There is no comtypes in this image, so this speaks COM
directly: a COM interface pointer is a pointer to a vtable (array of
function pointers); methods are called by index with the interface
pointer as the implicit first argument.

Vtable layouts (shipping Windows SDK order, stable ABI):
  IMMDeviceEnumerator: 0 QueryInterface, 1 AddRef, 2 Release,
    3 EnumAudioEndpoints, 4 GetDefaultAudioEndpoint, 5 GetDevice, ...
  IMMDevice: 0-2 IUnknown, 3 Activate, 4 OpenPropertyStore, ...
  IAudioEndpointVolume: 0-2 IUnknown, 3 RegisterControlChangeNotify,
    4 UnregisterControlChangeNotify, 5 GetChannelCount,
    6 SetMasterVolumeLevel, 7 SetMasterVolumeLevelScalar,
    8 GetMasterVolumeLevel, 9 GetMasterVolumeLevelScalar,
    10 SetChannelVolumeLevel, 11 SetChannelVolumeLevelScalar,
    12 GetChannelVolumeLevel, 13 GetChannelVolumeLevelScalar,
    14 SetMute, 15 GetMute, ...

The ole32 entry points are an injectable seam; tests build REAL ctypes
vtables for fake COM objects and assert the dispatch indices, argument
marshaling, and Release discipline — the binding math this module
exists for.
"""

from __future__ import annotations

import ctypes
import sys

from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("win_audio")

E_RENDER = 0  # eRender
E_MULTIMEDIA = 1  # eMultimedia role
CLSCTX_ALL = 0x17
COINIT_MULTITHREADED = 0x0


class GUID(ctypes.Structure):
    _fields_ = [
        ("Data1", ctypes.c_uint32),
        ("Data2", ctypes.c_uint16),
        ("Data3", ctypes.c_uint16),
        ("Data4", ctypes.c_ubyte * 8),
    ]

    @classmethod
    def from_str(cls, s: str) -> "GUID":
        s = s.strip("{}")
        p = s.split("-")
        d4 = bytes.fromhex(p[3] + p[4])
        return cls(
            int(p[0], 16), int(p[1], 16), int(p[2], 16),
            (ctypes.c_ubyte * 8)(*d4),
        )


CLSID_MMDeviceEnumerator = "{BCDE0395-E52F-467C-8E3D-C4579291692E}"
IID_IMMDeviceEnumerator = "{A95664D2-9614-4F35-A746-DE8DB63617E6}"
IID_IAudioEndpointVolume = "{5CDF2C82-841E-4546-9722-0CF74078229A}"


def vtbl_call(iface: int, index: int, restype, argtypes, *args):
    """Call vtable slot `index` on COM interface pointer `iface`.

    iface -> *vtable; vtable[index] is a stdcall fn whose first argument
    is the interface pointer itself. WINFUNCTYPE degrades to CFUNCTYPE
    off-win32, which is exactly right for the ctypes-built test fakes.
    """
    vtbl = ctypes.cast(
        ctypes.c_void_p(iface), ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p))
    ).contents
    fn_ptr = vtbl[index]
    factory = getattr(ctypes, "WINFUNCTYPE", ctypes.CFUNCTYPE)
    proto = factory(restype, ctypes.c_void_p, *argtypes)
    return proto(ctypes.cast(fn_ptr, ctypes.c_void_p).value)(iface, *args)


def release(iface: int) -> None:
    try:
        vtbl_call(iface, 2, ctypes.c_uint32, ())
    except Exception:  # noqa: BLE001 — mirror the silent-failure ladder
        pass


def set_mute(mute: bool, ole32=None) -> bool:
    """Mute/unmute the default render endpoint; False on any failure
    (silent, like the reference's unwrap_or_return ladder)."""
    if ole32 is None:
        if sys.platform != "win32":
            return False
        ole32 = ctypes.windll.ole32  # pragma: no cover (win32)
    try:
        # Per-thread init; S_FALSE (already initialized) is fine.
        ole32.CoInitializeEx(None, COINIT_MULTITHREADED)

        clsid = GUID.from_str(CLSID_MMDeviceEnumerator)
        iid_enum = GUID.from_str(IID_IMMDeviceEnumerator)
        enum_p = ctypes.c_void_p()
        hr = ole32.CoCreateInstance(
            ctypes.byref(clsid), None, CLSCTX_ALL,
            ctypes.byref(iid_enum), ctypes.byref(enum_p),
        )
        if hr != 0 or not enum_p.value:
            return False

        dev_p = ctypes.c_void_p()
        hr = vtbl_call(
            enum_p.value, 4, ctypes.c_int32,  # GetDefaultAudioEndpoint
            (ctypes.c_uint32, ctypes.c_uint32,
             ctypes.POINTER(ctypes.c_void_p)),
            E_RENDER, E_MULTIMEDIA, ctypes.byref(dev_p),
        )
        if hr != 0 or not dev_p.value:
            release(enum_p.value)
            return False

        iid_vol = GUID.from_str(IID_IAudioEndpointVolume)
        vol_p = ctypes.c_void_p()
        hr = vtbl_call(
            dev_p.value, 3, ctypes.c_int32,  # Activate
            (ctypes.POINTER(GUID), ctypes.c_uint32, ctypes.c_void_p,
             ctypes.POINTER(ctypes.c_void_p)),
            ctypes.byref(iid_vol), CLSCTX_ALL, None, ctypes.byref(vol_p),
        )
        if hr != 0 or not vol_p.value:
            release(dev_p.value)
            release(enum_p.value)
            return False

        hr = vtbl_call(
            vol_p.value, 14, ctypes.c_int32,  # SetMute
            (ctypes.c_int32, ctypes.c_void_p),
            1 if mute else 0, None,
        )
        release(vol_p.value)
        release(dev_p.value)
        release(enum_p.value)
        return hr == 0
    except Exception as e:  # noqa: BLE001
        _log.debug("set_mute failed: %s", e)
        return False


def apply_mute_windows() -> bool:
    return set_mute(True)


def remove_mute_windows() -> bool:
    return set_mute(False)


__all__ = [
    "GUID", "set_mute", "vtbl_call", "release",
    "apply_mute_windows", "remove_mute_windows",
    "CLSID_MMDeviceEnumerator", "IID_IMMDeviceEnumerator",
    "IID_IAudioEndpointVolume",
]
