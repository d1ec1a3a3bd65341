"""The port's Windows shell (spittle_tpu_torch/shell/{windows_audio,
windows_clipboard,windows_input,windows_keys,windows_mic,windows_overlay,
windows_tray}.py) against the JAX package's on Linux, at exact equality.

Every scenario of tests/test_windows_shell.py and
tests/test_windows_capture.py runs once per package over the same fakes,
and the two records must be equal:

- COM interfaces with real vtables in memory (windows_audio.vtbl_call's
  pointer walk runs for real): the call chain of set_mute and its releases
  on each HRESULT failure;
- Python fakes of user32, kernel32 and gdi32: the bytes of the INPUT
  arrays handed to SendInput, the clipboard's bytes in a real allocation,
  the overlay's window recipe and paint calls;
- a C fake of winmm and of user32's message loop, hotkeys and tray
  (compiled once for this module with `cc`; the JAX tests' fake with one
  message queue per thread, as Windows has, a reset and waveInStop/Reset/
  Close counts): the PCM at WinMicSource.read after the waveIn callback,
  the RegisterHotKey chords and press/release edges, and the tray's
  Shell_NotifyIcon calls and wndproc dispatch;
- with sys.platform patched to "win32", the textout, mute and overlay
  branches reach each package's own module.

`compile_fake`, `fake_windows` and the Python fakes are shared with the
tests of the win32 arms of build_app, the overlay selection and the mic
factory.
"""

import ctypes
import importlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

PKGS = ("spittle_tpu", "spittle_tpu_torch")
C = ctypes

FAKE_C = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>
#include <unistd.h>
#include <sys/types.h>
#include <sys/syscall.h>

/* ---------------- winmm (waveIn) fake ---------------- */

typedef struct {
    void *lpData;
    uint32_t dwBufferLength;
    uint32_t dwBytesRecorded;
    void *dwUser;
    uint32_t dwFlags;
    uint32_t dwLoops;
    void *lpNext;
    void *reserved;
} WAVEHDR;

typedef struct {
    uint16_t wFormatTag;
    uint16_t nChannels;
    uint32_t nSamplesPerSec;
    uint32_t nAvgBytesPerSec;
    uint16_t nBlockAlign;
    uint16_t wBitsPerSample;
    uint16_t cbSize;
} WAVEFORMATEX;

typedef void (*wavein_cb)(void *, uint32_t, void *, WAVEHDR *, void *);
static wavein_cb wi_callback = 0;
static WAVEHDR *wi_hdrs[8];
static int wi_n_hdrs = 0;
static int wi_added = 0;
static int wi_started = 0;
static int wi_stops = 0, wi_resets = 0, wi_closes = 0;
static uint32_t wi_rate = 0, wi_channels = 0, wi_bits = 0, wi_tag = 0;

uint32_t waveInOpen(void **out, uint32_t dev, WAVEFORMATEX *fmt,
                    wavein_cb cb, void *inst, uint32_t flags) {
    (void)dev; (void)inst; (void)flags;
    wi_n_hdrs = 0;  /* new stream: drop dangling prior-source headers */
    wi_added = 0;
    wi_rate = fmt->nSamplesPerSec;
    wi_channels = fmt->nChannels;
    wi_bits = fmt->wBitsPerSample;
    wi_tag = fmt->wFormatTag;
    wi_callback = cb;
    *out = (void *)0xBB;
    return 0;
}

uint32_t waveInPrepareHeader(void *h, WAVEHDR *hdr, uint32_t sz) {
    (void)h; (void)sz;
    if (wi_n_hdrs < 8) wi_hdrs[wi_n_hdrs++] = hdr;
    return 0;
}

uint32_t waveInAddBuffer(void *h, WAVEHDR *hdr, uint32_t sz) {
    (void)h; (void)hdr; (void)sz;
    wi_added++;
    return 0;
}

uint32_t waveInStart(void *h) { (void)h; wi_started = 1; return 0; }
uint32_t waveInStop(void *h) { (void)h; wi_started = 0; wi_stops++; return 0; }
uint32_t waveInReset(void *h) { (void)h; wi_resets++; return 0; }
uint32_t waveInClose(void *h) { (void)h; wi_closes++; return 0; }

uint32_t fake_wi_rate(void) { return wi_rate; }
uint32_t fake_wi_channels(void) { return wi_channels; }
uint32_t fake_wi_bits(void) { return wi_bits; }
uint32_t fake_wi_tag(void) { return wi_tag; }
int fake_wi_added(void) { return wi_added; }
int fake_wi_started(void) { return wi_started; }
int fake_wi_stops(void) { return wi_stops; }
int fake_wi_resets(void) { return wi_resets; }
int fake_wi_closes(void) { return wi_closes; }

void fake_wi_feed(const int16_t *samples, int n) {
    if (!wi_callback || wi_n_hdrs == 0) return;
    WAVEHDR *h = wi_hdrs[0];
    uint32_t nbytes = (uint32_t)(n * 2);
    if (nbytes > h->dwBufferLength) nbytes = h->dwBufferLength;
    memcpy(h->lpData, samples, nbytes);
    h->dwBytesRecorded = nbytes;
    wi_callback(0, 0x3C0 /*WIM_DATA*/, 0, h, 0);
}

/* ---------------- user32 message loops: one queue per thread -------- */

typedef struct {
    void *hwnd;
    uint32_t message;
    size_t wParam;
    ssize_t lParam;
    uint32_t time;
    long pt_x, pt_y;
} MSG;

#define QCAP 256
#define NQ 16
typedef struct { uint32_t tid; MSG q[QCAP]; int head, tail; } Queue;
static Queue queues[NQ];
static int n_queues = 0;
static pthread_mutex_t mq_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t mq_cv = PTHREAD_COND_INITIALIZER;

static uint32_t my_tid(void) { return (uint32_t)syscall(SYS_gettid); }

static Queue *queue_of(uint32_t tid) {  /* under mq_mu */
    for (int i = 0; i < n_queues; i++)
        if (queues[i].tid == tid) return &queues[i];
    Queue *q = &queues[n_queues++ % NQ];
    q->tid = tid; q->head = q->tail = 0;
    return q;
}

static void post(uint32_t tid, void *hwnd, uint32_t message, size_t w,
                 ssize_t l) {
    pthread_mutex_lock(&mq_mu);
    Queue *q = queue_of(tid);
    MSG *m = &q->q[q->tail % QCAP];
    m->hwnd = hwnd; m->message = message; m->wParam = w; m->lParam = l;
    q->tail++;
    pthread_cond_broadcast(&mq_cv);
    pthread_mutex_unlock(&mq_mu);
}

int GetMessageW(MSG *out, void *hwnd, uint32_t lo, uint32_t hi) {
    (void)hwnd; (void)lo; (void)hi;
    uint32_t tid = my_tid();
    pthread_mutex_lock(&mq_mu);
    Queue *q = queue_of(tid);
    while (q->head == q->tail) pthread_cond_wait(&mq_cv, &mq_mu);
    *out = q->q[q->head % QCAP];
    q->head++;
    pthread_mutex_unlock(&mq_mu);
    return 1;
}

int PostThreadMessageW(uint32_t tid, uint32_t message, size_t w,
                       ssize_t l) {
    post(tid, 0, message, w, l);
    return 1;
}

uint32_t GetCurrentThreadId(void) { return my_tid(); }

static struct { int id; uint32_t mods; uint32_t vk; int live; } hk[64];
static int n_hk = 0;
static uint32_t hk_tid = 0;
static int16_t key_state[512];

int RegisterHotKey(void *hwnd, int id, uint32_t mods, uint32_t vk) {
    (void)hwnd;
    hk_tid = my_tid();
    if (vk == 0xDEAD || n_hk >= 64) return 0; /* scripted failure */
    hk[n_hk].id = id; hk[n_hk].mods = mods; hk[n_hk].vk = vk;
    hk[n_hk].live = 1;
    n_hk++;
    return 1;
}

int UnregisterHotKey(void *hwnd, int id) {
    (void)hwnd;
    for (int i = 0; i < n_hk; i++)
        if (hk[i].id == id && hk[i].live) { hk[i].live = 0; return 1; }
    return 0;
}

int16_t GetAsyncKeyState(int vk) { return key_state[vk & 511]; }

/* ---------------- Shell_NotifyIcon tray fake ---------------- */

typedef ssize_t (*wndproc_t)(void *, uint32_t, size_t, ssize_t);
static wndproc_t wnd_proc = 0;

typedef struct {
    uint32_t style;
    wndproc_t lpfnWndProc;
    int cbClsExtra, cbWndExtra;
    void *hInstance, *hIcon, *hCursor, *hbrBackground;
    wchar_t *lpszMenuName, *lpszClassName;
} WNDCLASSW_;

uint16_t RegisterClassW(WNDCLASSW_ *wc) { wnd_proc = wc->lpfnWndProc; return 1; }

void *CreateWindowExW(uint32_t ex, wchar_t *cls, wchar_t *name,
                      uint32_t style, int x, int y, int w, int h,
                      ssize_t parent, void *menu, void *inst, void *p) {
    (void)ex; (void)cls; (void)name; (void)style; (void)x; (void)y;
    (void)w; (void)h; (void)parent; (void)menu; (void)inst; (void)p;
    return (void *)0x77;
}

typedef struct {
    uint32_t cbSize;
    void *hWnd;
    uint32_t uID, uFlags, uCallbackMessage;
    void *hIcon;
    wchar_t szTip[128];
} NID;

static int ni_ops[64];
static uint32_t ni_flags[64];
static size_t ni_icons[64];
static int ni_n = 0;
static uint32_t ni_cbmsg = 0, ni_size = 0;
static size_t last_icon_id = 0;
static uint32_t tray_tid = 0;
static char ni_tip[128];  /* the tip's characters, narrowed to ASCII */

int Shell_NotifyIconW(uint32_t op, NID *nid) {
    wchar_t *tip = nid->szTip;
    if (op == 0) tray_tid = my_tid();
    ni_ops[ni_n % 64] = (int)op;
    ni_flags[ni_n % 64] = nid->uFlags;
    ni_icons[ni_n % 64] = (size_t)nid->hIcon;
    ni_n++;
    ni_cbmsg = nid->uCallbackMessage;
    ni_size = nid->cbSize;
    for (int i = 0; i < 127; i++) {
        ni_tip[i] = (char)(tip[i] < 128 ? tip[i] : '?');
        if (!tip[i]) break;
    }
    return 1;
}

void *LoadIconW(void *inst, size_t id) {
    (void)inst; last_icon_id = id; return (void *)id;
}

ssize_t DefWindowProcW(void *h, uint32_t m, size_t w, ssize_t l) {
    (void)h; (void)m; (void)w; (void)l; return 0;
}

ssize_t DispatchMessageW(MSG *m) {
    if (wnd_proc) return wnd_proc(m->hwnd, m->message, m->wParam, m->lParam);
    return 0;
}

static size_t menu_ids[32];
static int menu_n = 0;
static int track_ret = 0;
static int track_called = 0;

void *CreatePopupMenu(void) { menu_n = 0; return (void *)0x88; }
int AppendMenuW(void *m, uint32_t f, size_t id, wchar_t *label) {
    (void)m; (void)f; (void)label;
    menu_ids[menu_n++ % 32] = id;
    return 1;
}
int TrackPopupMenu(void *m, uint32_t flags, int x, int y, int r,
                   void *hwnd, void *rect) {
    (void)m; (void)flags; (void)x; (void)y; (void)r; (void)hwnd;
    (void)rect;
    track_called++;
    return track_ret;
}
int DestroyMenu(void *m) { (void)m; return 1; }
int DestroyWindow(void *h) { (void)h; return 1; }
int GetCursorPos(long *pt) { pt[0] = 10; pt[1] = 20; return 1; }

int fake_ni_count(void) { return ni_n; }
int fake_ni_op(int i) { return ni_ops[i % 64]; }
uint32_t fake_ni_flags(int i) { return ni_flags[i % 64]; }
size_t fake_ni_icon(int i) { return ni_icons[i % 64]; }
uint32_t fake_ni_cbmsg(void) { return ni_cbmsg; }
uint32_t fake_ni_size(void) { return ni_size; }
const char *fake_ni_tip(void) { return ni_tip; }
size_t fake_last_icon_id(void) { return last_icon_id; }
int fake_menu_count(void) { return menu_n; }
size_t fake_menu_id(int i) { return menu_ids[i % 32]; }
int fake_track_called(void) { return track_called; }
void fake_set_track_ret(int v) { track_ret = v; }

/* A tray callback: queued for the tray's thread (hwnd 0, the direct arm)
   or through the window (hwnd set -> DispatchMessageW -> WNDPROC). */
void fake_tray_event(ssize_t event) { post(tray_tid, 0, 0x800A, 1, event); }
void fake_tray_event_hwnd(ssize_t event) {
    post(tray_tid, (void *)0x77, 0x800A, 1, event);
}

int fake_hk_count(void) {
    int c = 0;
    for (int i = 0; i < n_hk; i++) c += hk[i].live;
    return c;
}
int fake_hk_total(void) { return n_hk; }
int fake_hk_id(int i) { return hk[i].id; }
int fake_hk_live(int i) { return hk[i].live; }
uint32_t fake_hk_mods(int i) { return hk[i].mods; }
uint32_t fake_hk_vk(int i) { return hk[i].vk; }
void fake_set_key_state(int vk, int down) {
    key_state[vk & 511] = down ? (int16_t)0x8000 : 0;
}
void fake_press_hotkey(int id) { post(hk_tid, 0, 0x0312 /*WM_HOTKEY*/, id, 0); }

/* Everything a scenario reads back, to the state of a fresh process. Call
   it with no message loop running. */
void fake_reset(void) {
    pthread_mutex_lock(&mq_mu);
    n_queues = 0;
    pthread_mutex_unlock(&mq_mu);
    wi_callback = 0; wi_n_hdrs = 0; wi_added = 0; wi_started = 0;
    wi_stops = wi_resets = wi_closes = 0;
    wi_rate = wi_channels = wi_bits = wi_tag = 0;
    n_hk = 0; hk_tid = 0;
    memset(key_state, 0, sizeof(key_state));
    wnd_proc = 0; ni_n = 0; ni_cbmsg = 0; ni_size = 0; last_icon_id = 0;
    tray_tid = 0; memset(ni_tip, 0, sizeof(ni_tip));
    menu_n = 0; track_ret = 0; track_called = 0;
}
"""


def compile_fake(directory) -> ctypes.CDLL:
    """The fake built with `cc` into `directory` and loaded."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler in image")
    src = directory / "fake_win.c"
    src.write_text(FAKE_C)
    out = directory / "libfake_win.so"
    subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(out), str(src),
                    "-lpthread"], check=True)
    lib = ctypes.CDLL(str(out))
    lib.fake_wi_feed.argtypes = [ctypes.POINTER(ctypes.c_int16), ctypes.c_int]
    lib.GetAsyncKeyState.restype = ctypes.c_int16
    lib.fake_ni_tip.restype = ctypes.c_char_p
    lib.fake_last_icon_id.restype = ctypes.c_size_t
    lib.fake_ni_icon.restype = ctypes.c_size_t
    lib.fake_menu_id.restype = ctypes.c_size_t
    return lib


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return compile_fake(tmp_path_factory.mktemp("torch_windows_shell"))


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(scenario, *args, **kw):
    """The scenario's record for each package; they must be equal. Returns
    the port's."""
    got = {pkg: scenario(pkg, *args, **kw) for pkg in PKGS}
    assert got["spittle_tpu_torch"] == got["spittle_tpu"]
    return got["spittle_tpu_torch"]


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


# ---------------------------------------------------------------------------
# COM mute: fake interfaces with real vtables
# ---------------------------------------------------------------------------


class FakeComIface:
    """A COM interface pointer backed by a real in-memory vtable."""

    def __init__(self, slots):
        n = max(slots) + 1
        self._keep = list(slots.values())
        self._arr = (C.c_void_p * n)()
        for i, fn in slots.items():
            self._arr[i] = C.cast(fn, C.c_void_p)
        self._vt = C.c_void_p(C.addressof(self._arr))  # iface -> &vtable
        self.addr = C.addressof(self._vt)


def guid_str(g) -> str:
    d4 = bytes(g.Data4)
    return "{%08X-%04X-%04X-%s-%s}" % (
        g.Data1, g.Data2, g.Data3, d4[:2].hex().upper(), d4[2:].hex().upper())


def com_world(guid, calls, activate_hr=0, endpoint_hr=0, mute_hr=0):
    """An ole32 whose MMDeviceEnumerator -> IMMDevice ->
    IAudioEndpointVolume chain logs every call into `calls`."""

    def release_for(name):
        @C.CFUNCTYPE(C.c_uint32, C.c_void_p)
        def rel(this):
            calls.append(("Release", name))
            return 0
        return rel

    @C.CFUNCTYPE(C.c_int32, C.c_void_p, C.c_int32, C.c_void_p)
    def slot_set_mute(this, mute, ctx):
        calls.append(("SetMute", mute, ctx))
        return mute_hr

    vol = FakeComIface({2: release_for("vol"), 14: slot_set_mute})

    @C.CFUNCTYPE(C.c_int32, C.c_void_p, C.POINTER(guid), C.c_uint32,
                 C.c_void_p, C.POINTER(C.c_void_p))
    def slot_activate(this, iid, ctx, params, out):
        calls.append(("Activate", guid_str(iid.contents), ctx, params))
        if activate_hr == 0:
            out[0] = vol.addr
        return activate_hr

    dev = FakeComIface({2: release_for("dev"), 3: slot_activate})

    @C.CFUNCTYPE(C.c_int32, C.c_void_p, C.c_uint32, C.c_uint32,
                 C.POINTER(C.c_void_p))
    def slot_get_endpoint(this, dataflow, role, out):
        calls.append(("GetDefaultAudioEndpoint", dataflow, role))
        if endpoint_hr == 0:
            out[0] = dev.addr
        return endpoint_hr

    enum = FakeComIface({2: release_for("enum"), 4: slot_get_endpoint})

    class FakeOle32:
        def __init__(self):
            self.world = (vol, dev, enum)  # keepalive

        def CoInitializeEx(self, reserved, flags):
            calls.append(("CoInitializeEx", reserved, flags))
            return 0

        def CoCreateInstance(self, clsid_ref, outer, ctx, iid_ref, out_ref):
            calls.append(("CoCreateInstance", guid_str(clsid_ref._obj), outer,
                          ctx, guid_str(iid_ref._obj)))
            out_ref._obj.value = enum.addr
            return 0

    return FakeOle32()


def _mute(pkg, mute=True, **hr):
    wa = mod(pkg, "shell.windows_audio")
    calls = []
    ok = wa.set_mute(mute, ole32=com_world(wa.GUID, calls, **hr))
    return ok, calls, (wa.CLSID_MMDeviceEnumerator, wa.IID_IMMDeviceEnumerator,
                       wa.IID_IAudioEndpointVolume)


def _released(calls):
    return [c[1] for c in calls if c[0] == "Release"]


def test_mute_true_walks_the_chain():
    ok, calls, (clsid, iid_enum, iid_vol) = both(_mute, True)
    assert ok is True
    assert ("CoCreateInstance", clsid, None, 0x17, iid_enum) in calls
    # eRender=0, eMultimedia=1 (audio.rs GetDefaultAudioEndpoint args)
    assert ("GetDefaultAudioEndpoint", 0, 1) in calls
    assert ("Activate", iid_vol, 0x17, None) in calls
    assert ("SetMute", 1, None) in calls
    assert _released(calls) == ["vol", "dev", "enum"]


def test_unmute_sends_zero():
    ok, calls, _ = both(_mute, False)
    assert ok is True and ("SetMute", 0, None) in calls


def test_endpoint_failure_releases_enum_only():
    ok, calls, _ = both(_mute, True, endpoint_hr=-1)
    assert ok is False and _released(calls) == ["enum"]
    assert not any(c[0] == "SetMute" for c in calls)


def test_activate_failure_releases_dev_and_enum():
    ok, calls, _ = both(_mute, True, activate_hr=-1)
    assert ok is False and _released(calls) == ["dev", "enum"]


def test_setmute_hresult_failure_is_false_but_released():
    ok, calls, _ = both(_mute, True, mute_hr=-1)
    assert ok is False and _released(calls) == ["vol", "dev", "enum"]


def test_guid_roundtrip():
    def scenario(pkg):
        wa = mod(pkg, "shell.windows_audio")
        g = wa.GUID.from_str(wa.IID_IAudioEndpointVolume)
        return guid_str(g), g.Data1, bytes(g), C.sizeof(wa.GUID)
    text, data1, raw, size = both(scenario)
    assert text == "{5CDF2C82-841E-4546-9722-0CF74078229A}"
    assert data1 == 0x5CDF2C82 and size == 16


# ---------------------------------------------------------------------------
# SendInput keystrokes
# ---------------------------------------------------------------------------


class FakeUser32:
    """SendInput kept as (count, cbSize, the array's bytes, decoded
    events)."""

    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail

    def SendInput(self, n, arr, size):
        self.batches.append((n, size, C.string_at(C.addressof(arr), n * size), [
            (arr[i].type, arr[i].u.ki.wVk, arr[i].u.ki.wScan, arr[i].u.ki.dwFlags)
            for i in range(n)]))
        return 0 if self.fail else n


def _keys(pkg, drive, fail=False):
    wi = mod(pkg, "shell.windows_input")
    sleeps = []
    u32 = FakeUser32(fail=fail)
    kb = wi.SendInputKeyboard(user32=u32, sleep=sleeps.append)
    results = drive(kb, wi, mod(pkg, "shell.uinput"))
    return results, u32.batches, sleeps


def test_input_struct_matches_win64_abi():
    # Win64 INPUT is 40 bytes (4 type + 4 pad + 32 union): the union must
    # be at least MOUSEINPUT-sized or SendInput rejects the cbSize.
    def scenario(pkg):
        wi = mod(pkg, "shell.windows_input")
        return (C.sizeof(wi.INPUT), C.sizeof(wi.KEYBDINPUT), wi.INPUT.u.offset,
                [(f, C.sizeof(t)) for f, t in wi.KEYBDINPUT._fields_])
    assert both(scenario)[0] == 40


def test_unicode_text_down_up_pairs():
    results, batches, _ = both(_keys, lambda kb, wi, ui: (
        kb.type_text("hi"), wi.INPUT_KEYBOARD, wi.KEYEVENTF_UNICODE,
        wi.KEYEVENTF_KEYUP))
    ok, keyboard, uni, up = results
    ((n, size, raw, events),) = batches
    assert ok is True and (n, size, len(raw)) == (4, 40, 160)
    assert [e[2] for e in events] == [ord("h"), ord("h"), ord("i"), ord("i")]
    assert all(e[0] == keyboard and e[1] == 0 for e in events)
    assert events[0][3] == uni and events[1][3] == uni | up


def test_surrogate_pairs_ship_as_separate_units():
    def scenario(pkg):
        events = mod(pkg, "shell.windows_input").unicode_events("\U0001f600")
        return [bytes(e) for e in events], [e.u.ki.wScan for e in events]
    _, scans = both(scenario)
    assert scans == [0xD83D, 0xD83D, 0xDE00, 0xDE00]


def test_combo_holds_modifier_100ms():
    results, batches, sleeps = both(_keys, lambda kb, wi, ui: (
        kb.key("v", ui.MOD_CTRL), wi.KEYEVENTF_KEYUP, wi.SendInputKeyboard.COMBO_HOLD_S))
    ok, up, hold = results
    first, second = [b[3] for b in batches]
    assert ok is True
    assert [(e[1], e[3]) for e in first] == [(0x11, 0), (ord("V"), 0), (ord("V"), up)]
    assert sleeps == [hold] and [(e[1], e[3]) for e in second] == [(0x11, up)]


def test_multi_modifier_release_order_reversed():
    results, batches, _ = both(_keys, lambda kb, wi, ui: kb.key(
        "insert", ui.MOD_CTRL | ui.MOD_SHIFT | ui.MOD_ALT | ui.MOD_META))
    first, second = [b[3] for b in batches]
    assert results is True
    assert [e[1] for e in first][:4] == [0x11, 0x10, 0x12, 0x5B]
    assert [e[1] for e in second] == [0x5B, 0x12, 0x10, 0x11]


def test_arrow_batching_one_call():
    results, batches, sleeps = both(_keys, lambda kb, wi, ui: kb.key("left", 0, count=5))
    ((n, _, _, events),) = batches  # input.rs:120-150 batching semantics
    assert results is True and n == 10 and sleeps == []
    assert all(e[1] == 0x25 for e in events)


def test_unknown_key_refused():
    results, batches, _ = both(_keys, lambda kb, wi, ui: (kb.key("f13"), kb.key("")))
    assert results == (False, False) and batches == []


def test_failure_is_all_or_nothing():
    results, batches, _ = both(_keys, lambda kb, wi, ui: (
        kb.type_prefix("hello"), kb.type_text("hello"), kb.type_prefix("")),
        fail=True)
    assert results == (0, False, 0) and len(batches) == 2


def test_vk_names_cover_textout_parse_keys():
    names = ("left", "right", "up", "down", "backspace", "enter", "tab",
             "escape", "insert", "delete", "home", "end", "space", "pageup",
             "pagedown", "f1", "f12", "v", "z", "5", "F", "f13", "", "ctrl")
    vks = both(lambda pkg: [mod(pkg, "shell.windows_input").vk_for_name(n)
                            for n in names])
    assert all(v is not None for v in vks[:20]) and vks[-3:] == [None] * 3
    assert vks[names.index("v")] == ord("V")


# ---------------------------------------------------------------------------
# Clipboard: the fakes hand out real memory, so the module's memmove and
# decode run against genuine allocations
# ---------------------------------------------------------------------------


class FakeKernel32:
    def __init__(self):
        self.allocs = {}
        self.calls = []

    def GlobalAlloc(self, flags, size):
        buf = C.create_string_buffer(size)
        addr = C.addressof(buf)
        self.allocs[addr] = (buf, size)
        self.calls.append(("GlobalAlloc", flags, size))
        return addr

    def GlobalLock(self, h):
        self.calls.append(("GlobalLock",))
        return h

    def GlobalUnlock(self, h):
        self.calls.append(("GlobalUnlock",))
        return 1

    def GlobalSize(self, h):
        return self.allocs[h][1]

    def contents(self):
        return [buf.raw for buf, _ in self.allocs.values()]


class FakeClipUser32:
    def __init__(self):
        self.data = None
        self.calls = []

    def OpenClipboard(self, owner):
        self.calls.append(("OpenClipboard", owner))
        return 1

    def CloseClipboard(self):
        self.calls.append(("CloseClipboard",))
        return 1

    def EmptyClipboard(self):
        self.calls.append(("EmptyClipboard",))
        self.data = None
        return 1

    def SetClipboardData(self, fmt, handle):
        self.calls.append(("SetClipboardData", fmt))
        self.data = handle
        return handle

    def GetClipboardData(self, fmt):
        self.calls.append(("GetClipboardData", fmt))
        return self.data or 0


def _clip(pkg, text):
    wc = mod(pkg, "shell.windows_clipboard")
    u32, k32 = FakeClipUser32(), FakeKernel32()
    empty = wc.clipboard_read(user32=u32, kernel32=k32)
    wrote = wc.clipboard_write(text, user32=u32, kernel32=k32)
    read = wc.clipboard_read(user32=u32, kernel32=k32)
    return empty, wrote, read, k32.contents(), u32.calls, k32.calls, wc.CF_UNICODETEXT


@pytest.mark.parametrize("text", ["héllo wörld \U0001f600", ""])
def test_clipboard_roundtrip_unicode(text):
    empty, wrote, read, memory, u_calls, k_calls, cf = both(_clip, text)
    assert empty is None and wrote is True and read == text
    assert memory == [text.encode("utf-16-le") + b"\x00\x00"]
    assert ("SetClipboardData", cf) in u_calls and cf == 13
    assert ("GlobalAlloc", 0x0002, len(memory[0])) in k_calls  # GMEM_MOVEABLE
    # open/close balanced across the three operations
    assert [c[0] for c in u_calls].count("OpenClipboard") == 3
    assert [c[0] for c in u_calls].count("CloseClipboard") == 3


def test_clipboard_off_windows_default_binding_fails_silently():
    if sys.platform == "win32":
        pytest.skip("the real clipboard")
    r = both(lambda pkg: (mod(pkg, "shell.windows_clipboard").clipboard_write("x"),
                          mod(pkg, "shell.windows_clipboard").clipboard_read()))
    assert r == (False, None)


# ---------------------------------------------------------------------------
# Overlay backend and the shared controller
# ---------------------------------------------------------------------------


class FakeWinUser32:
    def __init__(self):
        self.calls = []

    def GetSystemMetrics(self, i):
        return 1920 if i == 0 else 1080

    def CreateWindowExW(self, ex, cls, name, style, x, y, w, h,
                        parent, menu, inst, param):
        self.calls.append(("create", ex, cls, name, style, x, y, w, h))
        return 111

    def ShowWindow(self, hwnd, cmd):
        self.calls.append(("show", cmd))
        return 1

    def SetWindowPos(self, hwnd, after, x, y, w, h, flags):
        self.calls.append(("pos", after, x, y, w, h, flags))
        return 1

    def GetDC(self, hwnd):
        return 222

    def ReleaseDC(self, hwnd, hdc):
        self.calls.append(("releasedc",))
        return 1

    def FillRect(self, hdc, rect_ref, brush):
        r = rect_ref._obj
        self.calls.append(("fill", r.left, r.top, r.right, r.bottom, brush))
        return 1

    def DestroyWindow(self, hwnd):
        self.calls.append(("destroy",))
        return 1


class FakeGdi32:
    def __init__(self):
        self.brushes = []
        self.deleted = []
        self.flushes = 0

    def CreateSolidBrush(self, colorref):
        self.brushes.append(colorref)
        return 333

    def DeleteObject(self, h):
        self.deleted.append(h)
        return 1

    def GdiFlush(self):
        self.flushes += 1
        return 1


def test_rgb_to_colorref_swaps_channels():
    colors = (0xE05F5F, 0xFF0000, 0xFFFFFF, 0x2563EB, 0)
    got = both(lambda pkg: [mod(pkg, "shell.windows_overlay").rgb_to_colorref(c)
                            for c in colors])
    assert got[:3] == [0x5F5FE0, 0x0000FF, 0xFFFFFF]


def _win_backend(pkg, drive):
    wo = mod(pkg, "shell.windows_overlay")
    u32, g32 = FakeWinUser32(), FakeGdi32()
    b = wo.WinBackend(user32=u32, gdi32=g32)
    out = drive(b, wo)
    return out, u32.calls, g32.brushes, g32.deleted, g32.flushes


def test_window_recipe():
    def drive(b, wo):
        opened, screen = b.open(), b.screen_size()
        b.create_window(874, 4, 172, 36, 0xE05F5F)
        b.map()
        return (opened, screen, wo.WS_EX_TOPMOST | wo.WS_EX_TOOLWINDOW
                | wo.WS_EX_NOACTIVATE, wo.WS_POPUP, wo.SW_SHOWNOACTIVATE,
                wo.SWP_NOACTIVATE)
    (opened, screen, ex_bits, popup, shownoact, noact), calls, brushes, _, _ = \
        both(_win_backend, drive)
    assert opened and screen == (1920, 1080)
    create = calls[0]
    # No focus steal, no taskbar entry, a topmost frameless popup.
    assert create[:5] == ("create", ex_bits, "STATIC", "spittle-overlay", popup)
    assert ("show", shownoact) in calls
    assert [c for c in calls if c[0] == "pos"][-1][-1] & noact
    assert brushes[-1] == 0x5F5FE0  # map repaints the recording red


def test_fill_rect_brush_discipline():
    def drive(b, wo):
        b.create_window(0, 0, 172, 36, 0)
        b.fill_rect(0xFFFFFF, 2, 4, 6, 28)
        b.set_background(0x2563EB)
        b.flush()
    _, calls, brushes, deleted, flushes = both(_win_backend, drive)
    fills = [c for c in calls if c[0] == "fill"]
    assert fills[0][1:5] == (2, 4, 8, 32)  # RECT is right/bottom-exclusive
    assert fills[1][1:5] == (0, 0, 172, 36)
    assert deleted == [333, 333] and brushes == [0xFFFFFF, 0xEB6325]
    assert calls.count(("releasedc",)) == 2 and flushes == 1


def test_move_no_activate_no_resize():
    def drive(b, wo):
        b.create_window(0, 0, 172, 36, 0)
        b.move(100, 1044)
        return wo.SWP_NOSIZE | wo.SWP_NOACTIVATE
    bits, calls, _, _, _ = both(_win_backend, drive)
    pos = [c for c in calls if c[0] == "pos"][-1]
    assert pos[2:4] == (100, 1044) and pos[-1] & bits == bits


def test_close_destroys_once():
    def drive(b, wo):
        b.create_window(0, 0, 172, 36, 0)
        b.unmap()
        b.close()
        b.close()
        return b.hwnd
    hwnd, calls, _, _, _ = both(_win_backend, drive)
    assert hwnd is None and calls.count(("destroy",)) == 1


def _services(pkg, data_dir):
    return mod(pkg, "app.services").AppServices(
        str(data_dir / pkg), use_mock_engine=True,
        **({"device": "cpu"} if pkg == "spittle_tpu_torch" else {}))


def _overlay_controller(pkg, data_dir):
    wo = mod(pkg, "shell.windows_overlay")
    events = mod(pkg, "events")
    services = _services(pkg, data_dir)
    services.update_settings(
        overlay_position=mod(pkg, "config.settings").OverlayPosition("top"))
    u32, g32 = FakeWinUser32(), FakeGdi32()
    ov = wo.attach_windows_overlay(services, backend=wo.WinBackend(user32=u32,
                                                                    gdi32=g32))
    try:
        assert ov is not None
        services.events.emit(events.SHOW_OVERLAY, "recording")
        assert _wait(lambda: ("show", wo.SW_SHOWNOACTIVATE) in u32.calls)
        services.events.emit(events.HIDE_OVERLAY, None)
        assert _wait(lambda: ("show", wo.SW_HIDE) in u32.calls)
    finally:
        if ov:
            ov.close()
            ov._thread.join(timeout=5)
        services.shutdown()
    x11 = mod(pkg, "shell.x11_overlay")
    return (type(ov).__name__, u32.calls, g32.brushes,
            (x11.OVERLAY_WIDTH, x11.OVERLAY_TOP_OFFSET))


def test_overlay_show_positions_and_paints(tmp_path):
    name, calls, _, (width, top) = both(_overlay_controller, tmp_path)
    assert name == "X11Overlay"
    pos = [c for c in calls if c[0] == "pos"][-2]
    assert pos[2:4] == ((1920 - width) // 2, top)


# ---------------------------------------------------------------------------
# Platform wiring: win32 dispatches reach each package's Windows modules
# ---------------------------------------------------------------------------


def _wiring(pkg, monkeypatch, branch):
    monkeypatch.setattr(sys, "platform", "win32")
    calls = []
    if branch == "keyboard":
        wi = mod(pkg, "shell.windows_input")
        u32 = FakeUser32()
        base = wi.SendInputKeyboard
        with monkeypatch.context() as m:
            m.setattr(wi, "SendInputKeyboard", type("SendInputKeyboard", (base,), {
                "__init__": lambda self: base.__init__(self, user32=u32,
                                                       sleep=calls.append)}))
            kb = mod(pkg, "shell.textout")._platform_keyboard()
            kb.key("v", mod(pkg, "shell.uinput").MOD_CTRL)
        return type(kb).__mro__[1].__module__.split(".", 1)[1], \
            [b[2] for b in u32.batches], calls
    if branch == "mute":
        audio, wa = mod(pkg, "managers.audio"), mod(pkg, "shell.windows_audio")
        world = com_world(wa.GUID, calls)
        set_mute = wa.set_mute
        with monkeypatch.context() as m:
            m.setattr(wa, "set_mute", lambda mute: calls.append(("set_mute", mute))
                      or set_mute(mute, ole32=world))
            m.setattr(audio, "_mute_state", {"muted": False})
            audio.apply_mute()
            audio.apply_mute()  # already muted: nothing
            audio.remove_mute()
        return calls
    if branch == "overlay":
        wo = mod(pkg, "shell.windows_overlay")
        u32, g32 = FakeWinUser32(), FakeGdi32()
        events = mod(pkg, "events").EventBus()
        settings = mod(pkg, "config.settings").AppSettings()
        services = type("Services", (), {"events": events,
                                         "get_settings": lambda self: settings})()
        base = wo.WinBackend
        with monkeypatch.context() as m:
            m.setattr(wo, "WinBackend", type("WinBackend", (base,), {
                "__init__": lambda self: base.__init__(self, user32=u32, gdi32=g32)}))
            ov = mod(pkg, "shell.overlay_select").attach_session_overlay(services)
        ov.close()
        ov._thread.join(timeout=5)
        return type(ov).__name__, type(ov.backend).__mro__[1].__module__ \
            .split(".", 1)[1], u32.calls
    u32, k32 = FakeClipUser32(), FakeKernel32()
    wc = mod(pkg, "shell.windows_clipboard")
    write, read = wc.clipboard_write, wc.clipboard_read
    with monkeypatch.context() as m:
        m.setattr(wc, "clipboard_write", lambda t: write(t, user32=u32, kernel32=k32))
        m.setattr(wc, "clipboard_read", lambda: read(user32=u32, kernel32=k32))
        out = mod(pkg, "shell.textout").SystemTextOutput(
            lambda: mod(pkg, "config.settings").AppSettings())
        return out._clipboard_write("hello"), out._clipboard_read(), u32.calls, \
            k32.contents()


def test_platform_keyboard_picks_sendinput(monkeypatch):
    module, batches, sleeps = both(_wiring, monkeypatch, "keyboard")
    assert module == "shell.windows_input" and len(batches) == 2 and len(sleeps) == 1


def test_mute_dispatches_to_com_chain(monkeypatch):
    calls = both(_wiring, monkeypatch, "mute")
    assert [c for c in calls if c[0] in ("set_mute", "SetMute")] == [
        ("set_mute", True), ("SetMute", 1, None), ("set_mute", False),
        ("SetMute", 0, None)]


def test_overlay_select_picks_windows(monkeypatch):
    name, module, calls = both(_wiring, monkeypatch, "overlay")
    assert (name, module) == ("X11Overlay", "shell.windows_overlay")


def test_clipboard_routes_win32(monkeypatch):
    wrote, read, calls, memory = both(_wiring, monkeypatch, "clipboard")
    assert wrote is True and read == "hello"
    assert memory == ["hello".encode("utf-16-le") + b"\x00\x00"]


# ---------------------------------------------------------------------------
# waveIn mic
# ---------------------------------------------------------------------------


def _wavein_lifecycle(pkg, lib):
    lib.fake_reset()
    src = mod(pkg, "shell.windows_mic").WinMicSource(winmm=lib)
    fmt = (lib.fake_wi_rate(), lib.fake_wi_channels(), lib.fake_wi_bits(),
           lib.fake_wi_tag(), lib.fake_wi_started(), lib.fake_wi_added())
    src.close()
    return fmt, (lib.fake_wi_started(), lib.fake_wi_stops(), lib.fake_wi_resets(),
                 lib.fake_wi_closes()), src.tool_name, src.sample_rate, src.read(0.01)


def test_wavein_format_and_lifecycle(fake_lib):
    fmt, after, tool, rate, read = both(_wavein_lifecycle, fake_lib)
    assert fmt == (16000, 1, 16, 1, 1, 3)  # WAVE_FORMAT_PCM, 3 buffers added
    assert after == (0, 1, 1, 1) and (tool, rate) == ("wavein", 16000)
    assert read is None


def _wavein_pcm(pkg, lib):
    lib.fake_reset()
    src = mod(pkg, "shell.windows_mic").WinMicSource(winmm=lib)
    before = lib.fake_wi_added()
    reads = []
    for seed, n in ((0, 256), (1, 2048), (2, 3000)):
        pcm = np.random.default_rng(seed).integers(-32768, 32767, n).astype(np.int16)
        lib.fake_wi_feed(pcm.ctypes.data_as(C.POINTER(C.c_int16)), len(pcm))
        got = src.read(timeout=1.0)
        reads.append((pcm.tobytes(), None if got is None else got.tobytes()))
    added = lib.fake_wi_added() - before
    src.close()
    return reads, added


def test_wavein_pcm_flows_from_driver_callback_to_read(fake_lib):
    reads, added = both(_wavein_pcm, fake_lib)
    for raw, got in reads:
        pcm = np.frombuffer(raw, "<i2")[:2048]  # one buffer holds 4096 bytes
        np.testing.assert_array_equal(np.frombuffer(got, np.float32),
                                      pcm.astype(np.float32) / 32768.0)
    assert added == 3  # each buffer re-added


# ---------------------------------------------------------------------------
# RegisterHotKey
# ---------------------------------------------------------------------------


def _hotkeys(pkg, lib, drive):
    lib.fake_reset()
    wk = mod(pkg, "shell.windows_keys")
    b = wk.WinHotkeyBackend(user32=lib, kernel32=lib, poll_interval=0.005)
    fired = []
    try:
        out = drive(b, wk, fired)
    finally:
        b.close()
    joined = b._thread is None
    table = [(lib.fake_hk_id(i), lib.fake_hk_mods(i), lib.fake_hk_vk(i),
              lib.fake_hk_live(i)) for i in range(lib.fake_hk_total())]
    return out, fired, table, joined


def test_hotkey_register_translates_chord(fake_lib):
    def drive(b, wk, fired):
        ok = b.register("ctrl+shift+space", lambda hk, p: None)
        assert _wait(lambda: fake_lib.fake_hk_count() == 1)
        return ok, wk.MOD_CONTROL | wk.MOD_SHIFT | wk.MOD_NOREPEAT
    (ok, mods), _, table, joined = both(_hotkeys, fake_lib, drive)
    assert ok and joined and table == [(1, mods, 0x20, 1)]  # VK_SPACE


def test_hotkey_press_and_release_edges(fake_lib):
    def drive(b, wk, fired):
        fake_lib.fake_set_key_state(0x20, 1)  # space held
        assert b.register("ctrl+space", lambda hk, p: fired.append((hk, p)))
        assert _wait(lambda: fake_lib.fake_hk_count() == 1)
        fake_lib.fake_press_hotkey(b._ids["ctrl+space"])
        assert _wait(lambda: ("ctrl+space", True) in fired)
        held = list(fired)
        time.sleep(0.05)
        fake_lib.fake_set_key_state(0x20, 0)  # released
        assert _wait(lambda: ("ctrl+space", False) in fired)
        fake_lib.fake_press_hotkey(99)  # not ours: nothing
        return held
    held, fired, _, _ = both(_hotkeys, fake_lib, drive)
    assert held == [("ctrl+space", True)]
    assert fired == [("ctrl+space", True), ("ctrl+space", False)]


def test_hotkey_unregister(fake_lib):
    def drive(b, wk, fired):
        assert b.register("alt+f4", lambda hk, p: None)
        assert b.register("alt+f4", lambda hk, p: None)  # once
        assert _wait(lambda: fake_lib.fake_hk_count() == 1)
        gone = b.unregister("alt+f4")
        assert _wait(lambda: fake_lib.fake_hk_count() == 0)
        return gone, b.unregister("alt+f4")
    (gone, again), _, table, _ = both(_hotkeys, fake_lib, drive)
    assert (gone, again) == (True, False)
    assert table == [(1, 0x0001 | 0x4000, 0x73, 0)]  # MOD_ALT, VK_F4


def test_hotkey_failed_registration_rolls_back(fake_lib):
    """Unknown keys are refused before anything is posted."""
    def drive(b, wk, fired):
        return b.register("ctrl+nosuchkey", lambda hk, p: None), dict(b._ids), \
            wk.hotkey_to_win("ctrl+alt+shift+super+f12")
    (ok, ids, win), _, table, _ = both(_hotkeys, fake_lib, drive)
    assert ok is False and ids == {} and table == []
    assert win == (0x0002 | 0x0001 | 0x0004 | 0x0008, 0x7B)


# ---------------------------------------------------------------------------
# Shell_NotifyIcon tray
# ---------------------------------------------------------------------------

WM_LBUTTONUP, WM_RBUTTONUP = 0x0202, 0x0205


def _ni(lib):
    return [(lib.fake_ni_op(i), lib.fake_ni_flags(i), lib.fake_ni_icon(i))
            for i in range(lib.fake_ni_count())]


def _win_tray(pkg, lib, drive):
    lib.fake_reset()
    wt = mod(pkg, "shell.windows_tray")
    activated, clicked = [], []
    tray = wt.WinTray(
        [("settings", "Settings"), ("cancel", "Cancel"), ("quit", "Quit")],
        on_activate=lambda: activated.append(1), on_menu=clicked.append,
        user32=lib, shell32=lib, kernel32=lib)
    try:
        assert _wait(lambda: lib.fake_ni_count() >= 1)
        out = drive(tray, wt, lib, activated, clicked)
    finally:
        tray.close()
    return out, activated, clicked, _ni(lib), lib.fake_ni_size(), \
        lib.fake_ni_tip(), tray._thread.is_alive()


def test_tray_icon_added_and_removed(fake_lib):
    def drive(tray, wt, lib, activated, clicked):
        return wt.WM_APP_TRAY, lib.fake_ni_cbmsg(), C.sizeof(wt.NOTIFYICONDATAW)
    (cbmsg_want, cbmsg, size), _, _, ni, ni_size, tip, alive = both(
        _win_tray, fake_lib, drive)
    assert cbmsg == cbmsg_want and ni_size == size and not alive
    assert ni[0] == (0, 0x1 | 0x2 | 0x4, 32512)  # NIM_ADD, IDI_APPLICATION
    assert ni[-1][0] == 2  # NIM_DELETE on close


def test_tray_left_click_activates(fake_lib):
    def drive(tray, wt, lib, activated, clicked):
        lib.fake_tray_event(WM_LBUTTONUP)
        assert _wait(lambda: activated == [1])
    _, activated, clicked, _, _, _, _ = both(_win_tray, fake_lib, drive)
    assert activated == [1] and clicked == []


def test_tray_right_click_menu_dispatches_through_wndproc(fake_lib):
    """The callback routed through the window (DispatchMessageW -> the
    registered WNDPROC thunk) opens the popup menu; the scripted
    TrackPopupMenu selection maps back to the item id."""
    def drive(tray, wt, lib, activated, clicked):
        lib.fake_set_track_ret(2)  # second item -> "cancel"
        lib.fake_tray_event_hwnd(WM_RBUTTONUP)
        assert _wait(lambda: clicked == ["cancel"])
        menu = [lib.fake_menu_id(i) for i in range(lib.fake_menu_count())]
        lib.fake_set_track_ret(0)  # dismissed: no dispatch
        lib.fake_tray_event_hwnd(WM_RBUTTONUP)
        assert _wait(lambda: lib.fake_track_called() >= 2)
        lib.fake_tray_event_hwnd(0x0200)  # a mouse move: DefWindowProc
        return menu
    menu, activated, clicked, _, _, _, _ = both(_win_tray, fake_lib, drive)
    assert menu == [1, 2, 3] and clicked == ["cancel"] and activated == []


def test_tray_set_state_modifies_icon(fake_lib):
    def drive(tray, wt, lib, activated, clicked):
        tray.set_state(mod(wt.__name__.split(".")[0], "app.ui_state")
                       .TrayIconState.RECORDING)
        assert _wait(lambda: lib.fake_ni_count() >= 2)
        return lib.fake_last_icon_id(), wt.IDI_EXCLAMATION, lib.fake_ni_tip()
    (icon, want, tip), _, _, ni, _, _, _ = both(_win_tray, fake_lib, drive)
    assert icon == want and ni[1] == (1, 0x2 | 0x4, want)  # NIM_MODIFY
    assert tip == "Spittle ? recording".encode()


def _one_user32(pkg, lib, wait):
    """The hotkeys, the tray and the overlay's window over one library
    object, as on Windows, where ctypes.windll.user32 is one object; up to
    `wait` seconds for the hotkey's registration."""
    lib.fake_reset()
    keys = mod(pkg, "shell.windows_keys").WinHotkeyBackend(
        user32=lib, kernel32=lib, poll_interval=0.005)
    tray = mod(pkg, "shell.windows_tray").WinTray([("quit", "Quit")], user32=lib,
                                                   shell32=lib, kernel32=lib)
    try:
        registered = keys.register("ctrl+space", lambda hk, p: None)
        _wait(lambda: lib.fake_hk_count() == 1, timeout=wait)
        b = mod(pkg, "shell.windows_overlay").WinBackend(user32=lib, gdi32=lib)
        try:
            b.create_window(874, 4, 172, 36, 0xE05F5F)
            window = b.hwnd
        except ctypes.ArgumentError as e:
            window = f"ArgumentError: {e}"
        return registered, lib.fake_hk_count(), window, keys._thread.is_alive()
    finally:
        tray.close()
        keys.close()


def test_one_user32_for_tray_hotkeys_and_overlay(fake_lib):
    """A fault of the JAX package that the port repairs: its tray declares
    user32.GetMessageW over a MSG class of its own and CreateWindowExW's
    parent as an integer, so on one user32 the hotkey thread dies at its
    first GetMessageW and the overlay's CreateWindowExW(parent=None) is
    refused. The port's tray takes the hotkeys' MSG and its overlay passes
    parent 0."""
    want = mod("spittle_tpu", "shell.windows_keys")
    jax = _one_user32("spittle_tpu", fake_lib, wait=1.0)
    port = _one_user32("spittle_tpu_torch", fake_lib, wait=30.0)
    assert jax[:2] == (True, 0) and jax[2].startswith("ArgumentError") and not jax[3]
    assert port == (True, 1, 0x77, True)
    assert mod("spittle_tpu_torch", "shell.windows_tray").MSG is \
        mod("spittle_tpu_torch", "shell.windows_keys").MSG
    assert want.MSG is not mod("spittle_tpu", "shell.windows_tray").MSG


# ---------------------------------------------------------------------------
# The win32 arms of the app, over the fakes
# ---------------------------------------------------------------------------


def fake_windows(pkg, lib, monkeypatch):
    """Patch the package's Windows shell to build over the fakes:
    WinHotkeyBackend and WinTray over the C fake, WinBackend over a
    FakeWinUser32 and a FakeGdi32 (returned). The hotkeys get a handle of
    their own on the fake, whose functions take argtypes of their own: in
    the JAX package the tray's MSG is not the hotkeys' (see
    test_one_user32_for_tray_hotkeys_and_overlay)."""
    keys_lib = ctypes.CDLL(lib._name)
    wk = mod(pkg, "shell.windows_keys")
    wt = mod(pkg, "shell.windows_tray")
    wo = mod(pkg, "shell.windows_overlay")
    hot, tray, backend = wk.WinHotkeyBackend, wt.WinTray, wo.WinBackend
    u32, g32 = FakeWinUser32(), FakeGdi32()
    monkeypatch.setattr(wk, "WinHotkeyBackend", type("WinHotkeyBackend", (hot,), {
        "__init__": lambda self: hot.__init__(self, user32=keys_lib, kernel32=keys_lib,
                                              poll_interval=0.005)}))
    monkeypatch.setattr(wt, "WinTray", type("WinTray", (tray,), {
        "__init__": lambda self, items, on_activate=None, on_menu=None, **_:
            tray.__init__(self, items, on_activate, on_menu, user32=lib,
                          shell32=lib, kernel32=lib)}))
    monkeypatch.setattr(wo, "WinBackend", type("WinBackend", (backend,), {
        "__init__": lambda self, user32=None, gdi32=None:
            backend.__init__(self, user32=u32, gdi32=g32)}))
    return u32, g32
